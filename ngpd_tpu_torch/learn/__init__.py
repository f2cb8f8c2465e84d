"""Weights of the learned models."""
