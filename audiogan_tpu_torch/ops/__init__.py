"""Tensor ops of the port (counterparts of audiogan_tpu/ops)."""
