"""Checkpoints, the metrics log and the timing helpers of a training
run."""
