"""The training drivers: the stage-2 (DPR) G+D step and its loop."""
