"""Demo input images and cameras."""
