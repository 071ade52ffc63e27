"""GRU cell, the port of audiogan_tpu/ops/gru.py: the dispatch point for
the fused cell. Gate convention of torch.nn.GRUCell, gates ordered
(r, z, n):

    r  = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
    z  = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
    n  = tanh   (x W_in + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) * n + z * h

Weights are stored pre-transposed for right-multiplication: w_i [in, 3H],
w_h [H, 3H], biases [3H], gate blocks concatenated in (r, z, n) order.
``impl="xla"`` is the cell in torch ops (the plain scan of kernels/gru.py
runs it); ``impl="pallas"`` is the fused cell, ``kernels/gru.py::GruCell``:
K3 (``csrc/gru_cell.cu``, the port of kernels/gru.py::_gru_fwd_impl) on
the card, its plain form on the CPU.
"""

from __future__ import annotations

import torch


def gru_gates(x: torch.Tensor, h: torch.Tensor, w_i: torch.Tensor,
              w_h: torch.Tensor, b_i: torch.Tensor, b_h: torch.Tensor):
    """(r, z, n, h_n) of one step; h_n = h W_hn + b_hn is the residual
    the backward needs."""
    gi = x @ w_i + b_i
    gh = h @ w_h + b_h
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return r, z, n, h_n


def gru_cell(x: torch.Tensor, h: torch.Tensor, w_i: torch.Tensor,
             w_h: torch.Tensor, b_i: torch.Tensor, b_h: torch.Tensor,
             impl: str = "xla") -> torch.Tensor:
    """One GRU step: x [B, in], h [B, H] -> h' [B, H]."""
    if impl == "pallas":
        from audiogan_tpu_torch.kernels.gru import GruCell
        return GruCell.apply(x, h, w_i, w_h, b_i, b_h)
    if impl != "xla":
        raise ValueError(f"impl={impl!r}: want 'xla' or 'pallas'")
    _, z, n, _ = gru_gates(x, h, w_i, w_h, b_i, b_h)
    return (1.0 - z) * n + z * h
