"""Networks of the view step, inference only."""
