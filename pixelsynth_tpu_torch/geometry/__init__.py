"""Camera geometry: reprojection and scene camera paths."""
