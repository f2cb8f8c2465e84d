"""Weights, training, datasets, checkpoints and export of the learned models."""
