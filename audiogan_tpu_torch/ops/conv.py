"""Conv-transpose seam between the models and the kernels.

Models call these and never a kernel module directly. The tensor's device
picks the implementation (kernels/conv.py): the CUDA kernel on the card,
the plain PyTorch form on the CPU. Layout: activations [B, T, C] (NWC),
weights [K, C_in, C_out].
"""

from __future__ import annotations

import torch

from audiogan_tpu_torch.kernels import conv as kconv


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor,
                     stride: int) -> torch.Tensor:
    """Fractionally-strided conv: [B,T,C_in] -> [B, T*stride, C_out].

    Input-dilated cross-correlation, filter centred at (K-1)//2.
    """
    b = torch.zeros(w.shape[2], dtype=w.dtype, device=w.device)
    return kconv.conv_transpose1d_ba(x, w, b, stride)


def conv_transpose1d_ba(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        stride: int, act: str = "none",
                        slope: float = 0.2) -> torch.Tensor:
    """Fused act(conv_transpose1d(x, w) + b); act in none|relu|leaky_relu|tanh."""
    return kconv.conv_transpose1d_ba(x, w, b, stride, act=act, slope=slope)
