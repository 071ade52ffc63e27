"""Sampling (the training step is not ported yet)."""
