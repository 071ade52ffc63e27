"""Phase shuffle (WaveGAN's critic regularizer), the port of the
``pshuf`` / ``pshuft`` pair of audiogan_tpu/ops/phase_shuffle.py.

Each example is shifted in time by n ~ U{-rad..rad}, with reflection
padding at the exposed edge:

    pshuf(x, offs)   y[b, i] = R(x)[b, i + off_b],  off = rad - n in [0, 2 rad]
    pshuft(ct, offs) dx = R^T(place(ct, offs))       (its exact adjoint)

where R reflect-pads time by rad on both sides. The two are Functions, each
the other's backward, so the penalty's double backprop composes to any
order. The reference lowers both to plain array ops (no Pallas kernel), so
these are torch ops: one gather forward; one gather (the window place) and
two rad-wide reflect folds backward.
"""

from __future__ import annotations

import torch


def _reflect_index(t: int, offs: torch.Tensor, rad: int) -> torch.Tensor:
    """[B, t] source rows of y[b, i] = R(x)[b, i + offs[b]]."""
    j = torch.arange(t, device=offs.device)[None, :] + offs[:, None] - rad
    j = torch.where(j < 0, -j, j)
    return torch.where(j > t - 1, 2 * (t - 1) - j, j)


def _pshuf(x: torch.Tensor, offs: torch.Tensor, rad: int) -> torch.Tensor:
    b, t, c = x.shape
    idx = _reflect_index(t, offs, rad)
    return torch.gather(x, 1, idx[:, :, None].expand(b, t, c))


def _pshuft(ct: torch.Tensor, offs: torch.Tensor, rad: int) -> torch.Tensor:
    """dx = R^T(W^T ct): v[b, m] = ct[b, m - off_b] for m in [0, t + 2 rad),
    then the head rows v[:rad] fold (reversed) into dx[1:1+rad] and the
    tail rows v[rad+t:] into dx[t-1-rad:t-1]."""
    b, t, c = ct.shape
    src = (torch.arange(t + 2 * rad, device=ct.device)[None, :]
           - offs[:, None])
    inside = (src >= 0) & (src < t)
    v = torch.gather(ct, 1, src.clamp(0, t - 1)[:, :, None].expand(
        b, t + 2 * rad, c))
    v = v * inside[:, :, None].to(v.dtype)
    dx = v[:, rad:rad + t].clone()
    dx[:, 1:1 + rad] += v[:, :rad].flip(1)
    dx[:, t - 1 - rad:t - 1] += v[:, rad + t:].flip(1)
    return dx


class PShuf(torch.autograd.Function):
    calls = 0       # forward passes, so a run can show a site was fused

    @staticmethod
    def forward(ctx, x, offs, rad):
        PShuf.calls += 1
        ctx.save_for_backward(offs)
        ctx.rad = rad
        return _pshuf(x, offs, rad)

    @staticmethod
    def backward(ctx, g):
        (offs,) = ctx.saved_tensors
        return PShufT.apply(g, offs, ctx.rad), None, None


class PShufT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ct, offs, rad):
        ctx.save_for_backward(offs)
        ctx.rad = rad
        return _pshuft(ct, offs, rad)

    @staticmethod
    def backward(ctx, g):
        (offs,) = ctx.saved_tensors
        return PShuf.apply(g, offs, ctx.rad), None, None


def phase_shuffle(x: torch.Tensor, shifts: torch.Tensor,
                  rad: int) -> torch.Tensor:
    """Shift [B, T, C] activations by the per-example shifts [B] in
    [-rad, rad] (drawn by the caller: the port's stream in training, the
    reference's in parity tests)."""
    if rad == 0:
        return x
    if x.shape[1] < rad + 1:
        raise ValueError(f"phase shuffle of radius {rad} needs T > {rad}, "
                         f"got {x.shape[1]}")
    offs = (rad - shifts).to(device=x.device, dtype=torch.long)
    return PShuf.apply(x, offs, rad)


def draw_shifts(gen: torch.Generator, n_sites: int, batch: int, rad: int,
                device=None) -> torch.Tensor:
    """Shifts ~ U{-rad..rad}, int64 [n_sites, batch]."""
    return torch.randint(-rad, rad + 1, (n_sites, batch), generator=gen,
                         device=device)
