"""Context-parallel (time-axis) convs by halo exchange, the port of
audiogan_tpu/parallel/halo.py.

Each rank of a cp group (parallel/mesh.py::CpMesh) holds one contiguous
time slice of the signal. A strided conv needs its neighbours' boundary
samples: ``gather_halo`` ships exactly the halo from each side, then the
conv runs locally on the extended slice through the same kernels as the
unsharded model, with explicit pads (K1' VALID, K1 with its pad_lo and
out_len) - O(k) bytes exchanged per layer against O(T / cp) compute. The
global edges receive zeros, which is SAME zero padding, so the sharded
op equals the unsharded one.

The neighbour shift. ``ShiftFromLeft`` hands each rank its left
neighbour's slab (zeros at rank 0) and ``ShiftFromRight`` its right
neighbour's (zeros at the last rank); each is the other's adjoint and
its backward, so the gradient penalty's double backprop crosses every
halo to any order. Both are ONE collective that every rank of the group
joins: an all-gather of the edge slabs, of which each rank keeps its
neighbour's. A collective that every rank calls in program order cannot
deadlock, where hand-paired sends and receives would have to agree on
an order per pair; it moves cp times the halo's bytes, which is a few
rows of each layer. For the same reason every rank builds the same
autograd graph: a select between a received and a local tensor is a
``torch.where`` on a 0-d condition, never a Python branch on the cp
index, so each rank's backward reaches every collective node, in the
same order (the autograd engine runs ready nodes by creation order).
Over gloo (the CPU tests; two ranks on one card, where NCCL refuses) a
CUDA tensor is staged through the host.

Where a deep layer's local slice is narrower than its halo (one
exchange reaches only the neighbours), the layer all-gathers the whole
signal, runs the unsharded conv and keeps its slice - the reference's
own route (halo.py:72-78, 98-106, 137-143), exact and cheap exactly
where it triggers. Its backward sums the gathered gradient over the
ranks and keeps this rank's block (a reduce-scatter, as an all-reduce
of the whole and a slice). ``ROUTES`` counts each forward's route.

Layouts: activations [B, T_loc, C]; the STFT critic's conv2d input
[B, C, F_loc, bins] (torch's NCHW), its frame axis sharded.
"""

from __future__ import annotations

import collections
import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint

from audiogan_tpu_torch.kernels import autograd as kad
from audiogan_tpu_torch.kernels.conv import conv1d_pads
from audiogan_tpu_torch.models.stft_critic import same_pads
from audiogan_tpu_torch.ops.sconv import window_select
from audiogan_tpu_torch.parallel.mesh import AxisMesh, CpMesh

# forward calls by (op, route): "conv1d/halo", "convt1d/gather", ...
ROUTES: collections.Counter = collections.Counter()


@functools.lru_cache(maxsize=None)
def _flag(value: bool, device: torch.device) -> torch.Tensor:
    """A 0-d bool on ``device``, made once (no copy to the card per
    select), outside inference mode (ops/stft.py::_basis_on)."""
    with torch.inference_mode(False):
        return torch.tensor(value, device=device)


def _staged(x: torch.Tensor, mesh: AxisMesh) -> bool:
    return x.device.type != "cpu" and dist.get_backend(mesh.group) == "gloo"


def _all_gather(x: torch.Tensor, mesh: CpMesh) -> list[torch.Tensor]:
    """Every rank's x (same shape), in cp order, on x's device."""
    src = x.detach().contiguous()
    staged = _staged(x, mesh)
    if staged:
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(out, src, group=mesh.group)
    return [o.to(x.device) for o in out] if staged else out


def _all_reduce_sum(x: torch.Tensor, mesh: AxisMesh) -> torch.Tensor:
    """The sum of x over the mesh's group, a new tensor (the same bits on
    every rank)."""
    out = x.detach().clone().contiguous()
    if not mesh.parallel:
        return out
    staged = _staged(x, mesh)
    buf = out.cpu() if staged else out
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.to(x.device) if staged else buf


def _neighbour(x: torch.Tensor, mesh: CpMesh, step: int) -> torch.Tensor:
    """Rank index - step's x (zeros where that rank does not exist).
    Every rank of the group joins the all-gather."""
    if not mesh.parallel:
        return torch.zeros_like(x)
    got = _all_gather(x, mesh)
    src = mesh.index - step
    return got[src] if 0 <= src < mesh.size else torch.zeros_like(x)


class ShiftFromLeft(torch.autograd.Function):
    """Each rank receives its left neighbour's x (zeros at rank 0)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _neighbour(x, mesh, 1)

    @staticmethod
    def backward(ctx, g):
        return ShiftFromRight.apply(g, ctx.mesh), None


class ShiftFromRight(torch.autograd.Function):
    """Each rank receives its right neighbour's x (zeros at the last)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _neighbour(x, mesh, -1)

    @staticmethod
    def backward(ctx, g):
        return ShiftFromLeft.apply(g, ctx.mesh), None


class AxisSum(torch.autograd.Function):
    """Forward: the sum over the group of ``mesh``, either inner axis (on
    the tp axis Megatron's g, parallel/tp.py). Backward: ``AxisVary`` of
    the incoming gradient, which passes it on unchanged. What is computed
    from the sum is the same on every rank, so each rank's incoming
    gradient is the whole gradient of its own term: the transpose of the
    reference's ``lax.psum`` under shard_map (an invariant value made
    varying, no exchange; parallel/mesh.py::_GlobalMean argues the
    same)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce_sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return AxisVary.apply(g, ctx.mesh), None


class AxisVary(torch.autograd.Function):
    """Forward: x unchanged, a value the same on every rank handed to
    rank-local compute (Megatron's f on the tp axis). Backward: the sum
    over the group (``AxisSum``), as the transpose of the reference's
    pvary is a psum. The penalty's double backprop takes this path: the
    conditional head's input gradient carries proj_embed(y) into every
    rank's slice, so proj_embed's gradient through the penalty sums over
    the ranks."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return AxisSum.apply(g, ctx.mesh), None


def axis_sum(x: torch.Tensor, mesh: AxisMesh) -> torch.Tensor:
    return AxisSum.apply(x, mesh) if mesh.parallel else x


def axis_vary(x: torch.Tensor, mesh: AxisMesh) -> torch.Tensor:
    return AxisVary.apply(x, mesh) if mesh.parallel else x


class GatherTime(torch.autograd.Function):
    """Every rank's slice concatenated along ``dim`` (all-gather); the
    backward is ``ScatterTime``."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        if not mesh.parallel:
            return x.clone()
        return torch.cat(_all_gather(x, mesh), dim)

    @staticmethod
    def backward(ctx, g):
        return ScatterTime.apply(g, ctx.mesh, ctx.dim), None, None


class ScatterTime(torch.autograd.Function):
    """The sum over the ranks of a whole-signal tensor, this rank's block
    along ``dim`` (reduce-scatter); the backward is ``GatherTime``."""

    @staticmethod
    def forward(ctx, g, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        n = g.shape[dim] // mesh.size
        return _all_reduce_sum(g, mesh).narrow(dim, mesh.index * n,
                                               n).contiguous()

    @staticmethod
    def backward(ctx, gg):
        return GatherTime.apply(gg, ctx.mesh, ctx.dim), None, None


def gather_halo(x: torch.Tensor, left: int, right: int, mesh: CpMesh,
                dim: int = 1) -> torch.Tensor:
    """The local slice extended along ``dim`` by ``left`` rows of the
    left neighbour and ``right`` of the right one (zeros at the global
    edges)."""
    parts = []
    if left > 0:
        parts.append(ShiftFromLeft.apply(
            x.narrow(dim, x.shape[dim] - left, left), mesh))
    parts.append(x)
    if right > 0:
        parts.append(ShiftFromRight.apply(x.narrow(dim, 0, right), mesh))
    return torch.cat(parts, dim) if len(parts) > 1 else x


def _own_block(y: torch.Tensor, mesh: CpMesh, n: int,
               dim: int = 1) -> torch.Tensor:
    return y.narrow(dim, mesh.index * n, n)


def cp_conv1d_ba(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 stride: int, mesh: CpMesh, act: str = "none",
                 slope: float = 0.2) -> torch.Tensor:
    """act(SAME conv1d(x, w) + b) of the time-sharded signal: this rank's
    slice [B, T_loc / stride, C_out]. Halo exchange, then K1' on the
    extended slice with VALID pads (audiogan_tpu/parallel/halo.py:51).
    The global SAME pad of a stride-aligned signal is k - stride in all,
    so T_loc must divide by the stride (the config's cp checks)."""
    k, t_loc = w.shape[0], x.shape[1]
    if t_loc % stride:
        raise ValueError(f"local slice {t_loc} is not a multiple of the "
                         f"stride {stride}")
    total = max(k - stride, 0)
    lo, hi = total // 2, total - total // 2
    if lo > t_loc or hi > t_loc:
        ROUTES["conv1d/gather"] += 1
        x_full = GatherTime.apply(x, mesh, 1)
        plo, phi = conv1d_pads(x_full.shape[1], k, stride, "SAME")
        y = kad.Conv1dBA.apply(x_full, w, b, stride, plo, phi, act, slope)
        return _own_block(y, mesh, t_loc // stride)
    ROUTES["conv1d/halo"] += 1
    x_ext = gather_halo(x, lo, hi, mesh)
    return kad.Conv1dBA.apply(x_ext, w, b, stride, 0, 0, act, slope)


def cp_conv_transpose1d_ba(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor, stride: int, mesh: CpMesh,
                           act: str = "none",
                           slope: float = 0.2) -> torch.Tensor:
    """act(conv_transpose1d(x, w) + b) of the time-sharded signal: this
    rank's slice [B, T_loc stride, C_out]. Input halos of ceil(pad / s)
    samples each side, then K1 on the extended slice with the global
    pad_lo = (k-1)//2 and out_len = (T_loc + lx + rx) s, then the slice
    (audiogan_tpu/parallel/halo.py:84)."""
    k, s, t_loc = w.shape[0], stride, x.shape[1]
    pad_lo = (k - 1) // 2
    lx = -(-pad_lo // s)
    rx = -(-max(k - 1 - pad_lo, 0) // s)
    if lx > t_loc or rx > t_loc:
        ROUTES["convt1d/gather"] += 1
        x_full = GatherTime.apply(x, mesh, 1)
        y = kad.ConvTBA.apply(x_full, w, b, s, pad_lo, x_full.shape[1] * s,
                              act, slope)
        return _own_block(y, mesh, t_loc * s)
    ROUTES["convt1d/halo"] += 1
    x_ext = gather_halo(x, lx, rx, mesh)
    y = kad.ConvTBA.apply(x_ext, w, b, s, pad_lo, (t_loc + lx + rx) * s,
                          act, slope)
    return y[:, lx * s:lx * s + t_loc * s]


def cp_conv2d_frames(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     stride: int, mesh: CpMesh) -> torch.Tensor:
    """SAME conv2d of h [B, C_in, F_loc, bins] with w [kf, kb, C_in,
    C_out] (flax's HWIO) and bias b, only the frame axis sharded: a frame
    halo and a VALID frame conv; the bins axis replicated with its SAME
    pad (audiogan_tpu/parallel/halo.py:117). The reference's conv is
    XLA's, not a Pallas kernel, so this is F.conv2d."""
    kf, kb = w.shape[0], w.shape[1]
    f_loc = h.shape[2]
    if f_loc % stride:
        raise ValueError(f"local frame slice {f_loc} is not a multiple of "
                         f"the stride {stride}")
    total = max(kf - stride, 0)
    lo, hi = total // 2, total - total // 2
    wl, wr = same_pads(h.shape[3], kb, stride)
    wt = w.permute(3, 2, 0, 1)
    if lo > f_loc or hi > f_loc:
        ROUTES["conv2d/gather"] += 1
        h_full = GatherTime.apply(h, mesh, 2)
        y = F.conv2d(F.pad(h_full, (wl, wr, lo, hi)), wt, b, stride=stride)
        return _own_block(y, mesh, f_loc // stride, dim=2)
    ROUTES["conv2d/halo"] += 1
    h_ext = gather_halo(h, lo, hi, mesh, dim=2)
    return F.conv2d(F.pad(h_ext, (wl, wr, 0, 0)), wt, b, stride=stride)


def _stage(step_fn, carry, length: int):
    ys = []
    for _ in range(length):
        carry, y = step_fn(carry)
        ys.append(y)
    return (*carry, torch.stack(ys))


def cp_chunked_scan(step_fn, carry0: tuple, length: int,
                    mesh: CpMesh) -> torch.Tensor:
    """A sequential scan whose time axis is sharded over the cp group
    (audiogan_tpu/parallel/halo.py:153): ``n_cp`` stages on every rank,
    each ``length`` steps of step_fn(carry) -> (carry, y) from the carry
    the rank holds; stage j is real on rank j only, whose carry the
    previous stage handed on (a select of the kept carry, then a shift
    from the left). The other ranks compute values that are dropped, so
    the wall time is the whole recurrence's; what cp buys is memory: each
    stage is recomputed in the backward (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint``), and the output [length, ...] exists
    only for this rank's slice."""
    carry, ys = tuple(carry0), None
    n = mesh.size
    for j in range(n):
        *new_carry, new_ys = torch.utils.checkpoint.checkpoint(
            _stage, step_fn, carry, length, use_reentrant=False)
        keep = _flag(mesh.index == j, new_ys.device)
        ys = new_ys if ys is None else torch.where(keep, new_ys, ys)
        if j < n - 1:       # the final carry is dropped: no handoff for it
            carry = tuple(ShiftFromLeft.apply(torch.where(keep, a, c), mesh)
                          for a, c in zip(new_carry, carry))
    return ys


def cp_phase_shuffle(x: torch.Tensor, shifts: torch.Tensor, rad: int,
                     mesh: CpMesh) -> torch.Tensor:
    """Phase shuffle of a time-sharded activation [B, T_loc, C] by the
    per-example shifts [B] (the same on every rank of the group): rad-row
    halos from the neighbours, and at the global edges the reflection the
    unsharded op pads with (its samples lie on the edge rank itself);
    then y[b, i] = x_ext[b, i + rad - shift_b]
    (audiogan_tpu/parallel/halo.py:194)."""
    if rad == 0:
        return x
    t = x.shape[1]
    if t < rad + 1:
        raise ValueError(f"phase shuffle of radius {rad} needs T_loc > "
                         f"{rad}, got {t}")
    first = _flag(mesh.index == 0, x.device)
    last = _flag(mesh.index == mesh.size - 1, x.device)
    left = torch.where(first, x[:, 1:rad + 1].flip(1),
                       ShiftFromLeft.apply(x[:, t - rad:], mesh))
    right = torch.where(last, x[:, t - rad - 1:t - 1].flip(1),
                        ShiftFromRight.apply(x[:, :rad], mesh))
    x_ext = torch.cat([left, x, right], 1)
    # a gather of distinct rows: its backward (a scatter) adds each
    # gradient row once, so it is exact and differentiable to any order
    offs = (rad - shifts).to(device=x.device, dtype=torch.long)
    return window_select(x_ext, offs, t, rad)
