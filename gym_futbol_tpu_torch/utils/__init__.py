"""Checkpoints and the metrics log of a training run."""
