"""Conv seams between the models and the kernels.

Models call these and never a kernel module directly. Each goes through
the autograd Functions of kernels/autograd.py on both devices, so a CUDA
tensor runs the hand-written kernels forward and backward, to any order,
and a CPU tensor their plain forms. Layout: activations [B, T, C] (NWC),
weights [K, C_in, C_out]. ``padding`` is "SAME" (asymmetric, as
audiogan_tpu/kernels/conv.py::_same_pads) or an explicit (lo, hi).
"""

from __future__ import annotations

import torch

from audiogan_tpu_torch.kernels import autograd as kad
from audiogan_tpu_torch.kernels.conv import conv1d_pads
from audiogan_tpu_torch.ops.sconv import mask_reflect_pad


def conv1d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           padding="SAME") -> torch.Tensor:
    """Strided cross-correlation [B,T,C_in] x [K,C_in,C_out] -> [B,T',C_out]."""
    lo, hi = conv1d_pads(x.shape[1], w.shape[0], stride, padding)
    return kad.Conv1d.apply(x, w, stride, lo, hi)


def conv1d_ba(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              stride: int = 1, padding="SAME", act: str = "none",
              slope: float = 0.2) -> torch.Tensor:
    """Fused act(conv1d(x, w) + b); act in none|relu|leaky_relu|tanh."""
    lo, hi = conv1d_pads(x.shape[1], w.shape[0], stride, padding)
    return kad.Conv1dBA.apply(x, w, b, stride, lo, hi, act, slope)


def sconv1d_ba(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               shifts: torch.Tensor, rad: int, stride: int = 1,
               padding="SAME", act: str = "none",
               slope: float = 0.2) -> torch.Tensor:
    """Fused phase_shuffle -> conv1d_ba (kernels/sconv.py::sconv1d_ba):
    act(conv1d(phase_shuffle(y, shifts, rad), w) + b), the shuffle read by
    the conv from the masked reflect pad of y; shifts [B] in [-rad, rad]."""
    offs = (rad - shifts).to(device=y.device, dtype=torch.int32)
    xp = mask_reflect_pad(y, offs, rad)
    lo, hi = conv1d_pads(y.shape[1], w.shape[0], stride, padding)
    return kad.SConv1dBA.apply(xp, w, b, offs, stride, lo, hi, rad, act,
                               slope)


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor,
                     stride: int) -> torch.Tensor:
    """Fractionally-strided conv: [B,T,C_in] -> [B, T*stride, C_out].

    Input-dilated cross-correlation, filter centred at (K-1)//2.
    """
    return kad.ConvT.apply(x, w, stride, (w.shape[0] - 1) // 2,
                           x.shape[1] * stride)


def conv_transpose1d_ba(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        stride: int, act: str = "none",
                        slope: float = 0.2) -> torch.Tensor:
    """Fused act(conv_transpose1d(x, w) + b); act in none|relu|leaky_relu|tanh."""
    return kad.ConvTBA.apply(x, w, b, stride, (w.shape[0] - 1) // 2,
                             x.shape[1] * stride, act, slope)
