"""The non-kernel parts of the fused phase shuffle, the port of
audiogan_tpu/kernels/sconv.py's ``window_select``, ``window_place`` and
``mask_reflect_pad``.

A fused shuffle site hands its consuming conv the reflect-padded,
masked activation xp instead of the shuffled one:

    xp[b, m] = R(y)[b, m] where off_b <= m < off_b + t, else 0
    z[b, i]  = xp[b, i + off_b]          (window_select: the shuffle)

with R the reflect pad by rad on both time ends and off = rad - shift in
[0, 2 rad]. The conv reads its window of xp itself (kernels/sconv.py), so
no shuffled tensor is written. ``MRPad`` and ``MRPadT`` are the masked
pad and its exact adjoint, each the other's backward (as
ops/phase_shuffle.py's ``PShuf``/``PShufT``), so the penalty's double
backprop composes to any order. The reference lowers all of this to plain
array ops (no Pallas kernel); here they are torch gathers, scatters and
slices. Layouts: y [B, t, C], xp [B, t + 2 rad, C], offs [B] ints.
"""

from __future__ import annotations

import torch


def _window_index(offs: torch.Tensor, t: int, c: int) -> torch.Tensor:
    """[B, t, C] gather index of xp rows i + offs[b]."""
    idx = (torch.arange(t, device=offs.device)[None, :]
           + offs.to(torch.long)[:, None])
    return idx[:, :, None].expand(offs.shape[0], t, c)


def window_select(xp: torch.Tensor, offs: torch.Tensor, t: int,
                  rad: int) -> torch.Tensor:
    """[B, t + 2 rad, C] -> [B, t, C]: z[b, i] = xp[b, i + offs[b]]."""
    if xp.shape[1] != t + 2 * rad:
        raise ValueError(f"xp has {xp.shape[1]} rows, want t + 2 rad = "
                         f"{t + 2 * rad}")
    return torch.gather(xp, 1, _window_index(offs, t, xp.shape[2]))


def window_place(u: torch.Tensor, offs: torch.Tensor,
                 rad: int) -> torch.Tensor:
    """Transpose of window_select: [B, t, C] -> [B, t + 2 rad, C] with u
    at rows [offs[b], offs[b] + t) and zeros elsewhere."""
    b, t, c = u.shape
    out = u.new_zeros(b, t + 2 * rad, c)
    return out.scatter(1, _window_index(offs, t, c), u)


def _live(offs: torch.Tensor, t: int, rad: int) -> torch.Tensor:
    """[B, t + 2 rad, 1] bool: row m lies in [offs[b], offs[b] + t)."""
    pos = torch.arange(t + 2 * rad, device=offs.device)[None, :]
    o = offs.to(torch.long)[:, None]
    return ((pos >= o) & (pos < o + t))[:, :, None]


def _mrpad_fwd(y: torch.Tensor, offs: torch.Tensor, rad: int) -> torch.Tensor:
    """Reflect-pad y by rad on both time ends, zero outside each live
    window (kernels/sconv.py::_mrpad_fwd)."""
    t = y.shape[1]
    j = torch.arange(-rad, t + rad, device=y.device).abs()
    j = torch.where(j > t - 1, 2 * (t - 1) - j, j)
    xp = y[:, j]
    return torch.where(_live(offs, t, rad), xp, xp.new_zeros(()))


def _mrpad_t(ct: torch.Tensor, offs: torch.Tensor, rad: int) -> torch.Tensor:
    """dy = R^T(mask * ct): mask, then fold the reflect edges back at rad
    width, dy[1 + e] += v[rad - 1 - e], dy[t - 2 - e] += v[rad + t + e]
    (kernels/sconv.py::_mrpad_t)."""
    t = ct.shape[1] - 2 * rad
    # disjoint fold rows, as the reference asserts (all presets)
    if t < 2 * rad + 2:
        raise ValueError(f"mask_reflect_pad's adjoint needs t >= 2 rad + 2, "
                         f"got t={t}, rad={rad}")
    v = torch.where(_live(offs, t, rad), ct, ct.new_zeros(()))
    dy = v[:, rad:rad + t].clone()
    dy[:, 1:1 + rad] += v[:, :rad].flip(1)
    dy[:, t - 1 - rad:t - 1] += v[:, rad + t:].flip(1)
    return dy


class MRPad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, offs, rad):
        ctx.save_for_backward(offs)
        ctx.rad = rad
        return _mrpad_fwd(y, offs, rad)

    @staticmethod
    def backward(ctx, g):
        (offs,) = ctx.saved_tensors
        return MRPadT.apply(g, offs, ctx.rad), None, None


class MRPadT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ct, offs, rad):
        ctx.save_for_backward(offs)
        ctx.rad = rad
        return _mrpad_t(ct, offs, rad)

    @staticmethod
    def backward(ctx, g):
        (offs,) = ctx.saved_tensors
        return MRPad.apply(g, offs, ctx.rad), None, None


def mask_reflect_pad(y: torch.Tensor, offs: torch.Tensor,
                     rad: int) -> torch.Tensor:
    """The fused conv's xp operand: [B, t, C] -> [B, t + 2 rad, C]."""
    if y.shape[1] < rad + 1:
        raise ValueError(f"reflect pad of {rad} needs t > {rad}, got "
                         f"{y.shape[1]}")
    return MRPad.apply(y, offs, rad)
