"""PyTorch/CUDA port of audiogan_tpu for NVIDIA Hopper.

Layouts and names follow the JAX package: activations NWC ``[B, T, C]``,
conv weights ``[K, C_in, C_out]``, dense weights ``[in, out]``. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
