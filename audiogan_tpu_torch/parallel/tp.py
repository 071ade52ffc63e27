"""Tensor (channel) parallelism for conv stacks, the port of
audiogan_tpu/parallel/tp.py: the Megatron column/row pairing on the
port's conv, over the tp group of one data replica
(parallel/mesh.py::TpMesh).

``tp_conv1d_col``: this rank's 1/tp slice of the kernel's output
channels (and of the bias); the full input, the same on every rank,
gives this rank's slice of the output channels, with no exchange.
``tp_conv1d_row``: this rank's slice of the kernel's input channels
convolves the matching slice of the input, and the partial outputs are
summed over tp (one all-reduce). A column layer followed by a row layer
therefore costs one all-reduce, with the elementwise activation on the
sharded activations between them.

The communication is Megatron's f/g pair, parallel/halo.py's
``AxisVary``/``AxisSum`` over the tp group: g (the row layer's sum) passes
its gradient on in the backward, and f (identity forward, a sum over tp
in the backward) is on the input of every column layer, where each rank
holds only its slice's share of the input's gradient. Each is the
other's backward, so the gradient penalty's double backprop crosses
them to any order, and every rank builds the same graph (the slices'
offsets differ by rank, the ops do not), so every rank reaches every
collective in one order.

The convs are kernels/autograd.py's Functions on this rank's
contiguous weight slices: K1' forward (the column layer with its fused
bias and activation, the row layer with the zero bias of ``Conv1d``),
K1 for their input gradients, on a CUDA tensor; their plain forms on
the CPU. Layouts as ops/conv.py: x [B, T, C], w [K, C_in, C_out].
"""

from __future__ import annotations

import torch

from audiogan_tpu_torch.ops.conv import conv1d, conv1d_ba
from audiogan_tpu_torch.parallel.halo import axis_sum, axis_vary
from audiogan_tpu_torch.parallel.mesh import TpMesh


def tp_slice(a: torch.Tensor, dim: int, mesh: TpMesh) -> torch.Tensor:
    """This rank's 1/tp block of a along dim, contiguous. tp must divide
    the dim: the reference's dynamic_slice would clamp a ragged block
    (audiogan_tpu/parallel/tp_models.py:34-40)."""
    n = a.shape[dim]
    if n % mesh.size:
        raise ValueError(f"tp={mesh.size} must divide dim {dim} of shape "
                         f"{tuple(a.shape)}")
    blk = n // mesh.size
    return a.narrow(dim, mesh.index * blk, blk).contiguous()


def tp_conv1d_col(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  stride: int, mesh: TpMesh, act: str = "none",
                  slope: float = 0.2) -> torch.Tensor:
    """act(SAME conv1d(x, w) + b) at this rank's output channels: x
    [B, T, C_in] the same on every rank, w [K, C_in, C_out] and b
    [C_out] whole -> [B, T', C_out / tp]. No exchange forward; the
    input's gradient is summed over tp."""
    return conv1d_ba(axis_vary(x, mesh), tp_slice(w, 2, mesh),
                     tp_slice(b, 0, mesh), stride, "SAME", act, slope)


def tp_conv1d_row(x: torch.Tensor, w: torch.Tensor, stride: int,
                  mesh: TpMesh) -> torch.Tensor:
    """SAME conv1d of the channel-sharded x [B, T, C_in / tp] with this
    rank's input channels of w [K, C_in, C_out], summed over tp ->
    [B, T', C_out], the same on every rank. No bias inside: the caller
    adds it after the sum."""
    return axis_sum(conv1d(x, tp_slice(w, 1, mesh), stride, "SAME"), mesh)
