"""The GRU cell and the GRU generator's frame recurrence: the CUDA
kernels, their plain forms and the autograd Functions.

Port of audiogan_tpu/kernels/gru.py. ``csrc/gru_cell.cu`` replaces
``_gru_fwd_impl`` (K3, one fused cell step: both gate products, the gates
and the blend, in f32, written in x's dtype); ``GruCell`` runs it forward
and ``_gru_bwd2``'s plain math backward, as the reference's custom_vjp
does. K3 has two paths, a pure function of dtype and shape
(``gru_cell_tensor_core``): bf16 with B <= 64 and in, H multiples of 8
runs the gate products on the tensor cores, the depth split across a
thread-block cluster as ``gru_cell_plan`` says; f32 and the rest a
CUDA-core kernel. ``csrc/gru_scan.cu`` replaces ``_gru_scan_impl`` (K4,
the whole scan, optionally emitting ``h_seq``) and ``_gru_scan_bwd`` (K5,
its reverse-sweep backward). Per frame t:

    x_t    = [feat_{t-1} @ w_ar, cond]          (feat_{-1} = 0)
    h_t    = GRUCell(x_t, h_{t-1})              (ops/gru.py, gates r, z, n)
    feat_t = tanh(h_t @ w_out + b_out)

with the TPU kernel's numerics, which in bf16 differ from a scan of the
cell in the compute dtype: the weights are widened to f32 at each use, h
and feat are carried in f32 (the autoregressive input is the f32 feat),
and feat_t and h_t are rounded to the input dtype only where they are
written out. The backward recomputes each frame from the stored, rounded
residuals (h_{t-1}, feat_{t-1}) and returns each gradient in the dtype of
its primal. ``gru_scan_plain`` and ``gru_scan_bwd_plain`` are those
numerics step by step in torch: the CPU path and the kernels' oracles.

Each scan kernel has two paths, and which one a call takes is a pure
function of dtype and shape (``gru_scan_persistent``): bf16 with B <= 64
and H, F multiples of 16 runs one persistent cooperative launch per scan
(K4) and per reverse sweep (K5), the weights resident in shared memory
across the grid and the per-frame products on the tensor cores; f32 and
every other shape the host loop of per-frame launches. The persistent
kernels do no partition arithmetic of their own: ``gru_persistent_plan``
gives each block its batch rows and its hidden-unit and feature columns.

Layouts: x [B,in], h [B,H], w_i [in,3H], w_h [H,3H], b_i [3H],
b_h [3H] -> h' [B,H] for the cell; h0 [B,H], cond [B,F], w_i [2F,3H],
w_h [H,3H], b_i [3H], b_h [3H], w_ar [F,F], w_out [H,F], b_out [F] ->
feats [B, n_frames, F], h_seq [n_frames, B, H] for the scan.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from audiogan_tpu_torch.kernels import _build, hooks
from audiogan_tpu_torch.ops.gru import gru_cell, gru_gates

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ARG_NAMES = ("h0", "cond", "w_i", "w_h", "b_i", "b_h", "w_ar", "w_out",
             "b_out")


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


CELL_ARG_NAMES = ("x", "h", "w_i", "w_h", "b_i", "b_h")


def _cell_dims(x, h, w_i, w_h, b_i, b_h) -> tuple[int, int, int]:
    """(B, in, H) after checking every shape against x and h."""
    if x.dim() != 2 or h.dim() != 2 or x.shape[0] != h.shape[0]:
        raise ValueError(f"want x [B,in] and h [B,H]; got "
                         f"{tuple(x.shape)}, {tuple(h.shape)}")
    (b, in_dim), hid = x.shape, h.shape[1]
    want = {"w_i": (in_dim, 3 * hid), "w_h": (hid, 3 * hid),
            "b_i": (3 * hid,), "b_h": (3 * hid,)}
    for name, t in zip(CELL_ARG_NAMES[2:], (w_i, w_h, b_i, b_h)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} is {tuple(t.shape)}, want {want[name]}")
    return b, in_dim, hid


def gru_cell_plain(x, h, w_i, w_h, b_i, b_h) -> torch.Tensor:
    """K3's function in plain torch with the kernel's numerics: the gates
    and the blend in f32 (float64 stays float64), h' in x.dtype."""
    acc = _acc_dtype(x)
    h32 = h.to(acc)
    _, z, n, _ = gru_gates(x.to(acc), h32, w_i.to(acc), w_h.to(acc),
                           b_i.to(acc), b_h.to(acc))
    return ((1.0 - z) * n + z * h32).to(x.dtype)


# The tensor-core path of K3 (csrc/gru_cell.cu: gru_cell_tc_kernel): a block
# owns GRU_CELL_UNITS hidden units and every batch row (one warp per m16
# tile), and the depth, in k-steps of 16 (x's, then h's), is split across
# the blocks of a cluster.
GRU_CELL_UNITS = 16
GRU_CELL_MAX_BATCH = 64
GRU_CELL_MAX_SPLIT = 8       # a portable cluster
GRU_CELL_MIN_BLOCKS = 256    # the split doubles until the grid has these
                             # (two per SM: the split the timings of every
                             # split on the card favour, PERF.md §6)


def gru_cell_tensor_core(dtype, batch: int, in_dim: int, hid: int) -> bool:
    """True iff gru_cell_fwd runs this cell on the tensor cores: bf16,
    B <= 64 (four m-tiles), in and H multiples of 8 (16-byte copies)."""
    return (dtype == torch.bfloat16 and 1 <= batch <= GRU_CELL_MAX_BATCH
            and in_dim > 0 and hid > 0 and in_dim % 8 == 0
            and hid % 8 == 0)


@functools.cache
def gru_cell_plan(batch: int, in_dim: int, hid: int,
                  split: int | None = None) -> np.ndarray:
    """The int32 array the tensor-core kernel is launched with (read-only;
    cached, the wrapper asks every call): units, split D, kx, kt,
    start[D + 1]. k-step s < kx covers x's columns (w_i's rows) [16 s,
    16 s + 16), s >= kx h's (w_h's) at 16 (s - kx); cluster rank q sums
    k-steps [start[q], start[q + 1]). Unless given, D doubles (up to 8,
    and while every rank keeps a k-step) until H / 16 unit tiles x D
    blocks reach GRU_CELL_MIN_BLOCKS: 32 x 8 at cond_gru_sc09's cell."""
    kx, kt = _cdiv(in_dim, 16), _cdiv(in_dim, 16) + _cdiv(hid, 16)
    tiles = _cdiv(hid, GRU_CELL_UNITS)
    if split is None:
        split = 1
        while (split < GRU_CELL_MAX_SPLIT
               and tiles * split < GRU_CELL_MIN_BLOCKS and 2 * split <= kt):
            split *= 2
    elif not 1 <= split <= min(GRU_CELL_MAX_SPLIT, kt):
        raise ValueError(f"split {split} for {kt} k-steps")
    plan = np.asarray([GRU_CELL_UNITS, split, kx, kt,
                       *(q * kt // split for q in range(split + 1))],
                      dtype=np.int32)
    plan.flags.writeable = False
    return plan


@functools.cache
def _cell_lib() -> ctypes.CDLL:
    """csrc/gru_cell.cu, built at first use, with its C signatures."""
    lib = _build.load("gru_cell")
    lib.gru_cell_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    lib.gru_cell_launch.restype = ctypes.c_int
    lib.gru_cell_error_string.argtypes = [ctypes.c_int]
    lib.gru_cell_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _c_cell_plan(batch: int, in_dim: int, hid: int,
                 split: int | None = None):
    """gru_cell_plan as the kernel's int32 pointer, with the array that
    keeps it alive."""
    plan = np.ascontiguousarray(gru_cell_plan(batch, in_dim, hid, split))
    return plan, ctypes.cast(plan.ctypes.data, ctypes.POINTER(ctypes.c_int))


def _gru_cell_tc(args, out, split: int | None = None) -> None:
    """One launch of K3's tensor-core kernel (gru_cell_plan's split unless
    given); not counted: the wrapper counts its own launches."""
    ptrs = [t.data_ptr() for t in args]
    if (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) % 16:
        raise ValueError("gru_cell: the tensor-core path needs 16-byte "
                         "aligned x, h, w_i and w_h")
    b, in_dim = args[0].shape
    hid = args[1].shape[1]
    lib = _cell_lib()
    err = lib.gru_cell_launch(
        *ptrs, out.data_ptr(), b, in_dim, hid, _DTYPES[torch.bfloat16],
        _c_cell_plan(b, in_dim, hid, split)[1],
        torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError("gru_cell kernel launch failed: "
                           + lib.gru_cell_error_string(err).decode())


@hooks.kernel
def gru_cell_fwd(x, h, w_i, w_h, b_i, b_h) -> torch.Tensor:
    """K3: one GRU step -> h' [B, H] in x.dtype. A CPU tensor takes the
    plain form. A CUDA tensor launches the kernel (every input f32 or
    every input bf16) or raises; it never falls back. Where
    ``gru_cell_tensor_core`` holds, the tensor-core path runs (counted in
    ``launches_tc``; its tensors must start 16-byte aligned), else the
    CUDA-core kernel (``launches_cc``); ``launches`` counts both. Records
    no autograd history (see GruCell)."""
    args = (x, h, w_i, w_h, b_i, b_h)
    b, in_dim, hid = _cell_dims(*args)
    if x.device.type == "cpu":
        return gru_cell_plain(*args)
    _check_kernel_args("gru_cell", args)
    out = torch.empty((b, hid), dtype=x.dtype, device=x.device)
    if gru_cell_tensor_core(x.dtype, b, in_dim, hid):
        _gru_cell_tc(args, out)
        gru_cell_fwd.launches_tc += 1
    else:
        lib = _cell_lib()
        err = lib.gru_cell_launch(
            *(t.data_ptr() for t in args), out.data_ptr(), b, in_dim, hid,
            _DTYPES[x.dtype], None,
            torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError("gru_cell kernel launch failed: "
                               + lib.gru_cell_error_string(err).decode())
        gru_cell_fwd.launches_cc += 1
    gru_cell_fwd.launches += 1
    return out


gru_cell_fwd.launches = gru_cell_fwd.launches_tc = 0
gru_cell_fwd.launches_cc = 0


def gru_cell_bwd(g, x, h, w_i, w_h, b_i, b_h):
    """The reference's ``_gru_bwd2`` in plain torch: the gates recomputed
    from the inputs in their own dtype (``_gru_gates``), then the six
    gradients."""
    r, z, n, h_n = gru_gates(x, h, w_i, w_h, b_i, b_h)
    dz = g * (h - n) * z * (1 - z)
    dn = g * (1 - z) * (1 - n * n)
    dr = dn * h_n * r * (1 - r)
    dgi = torch.cat([dr, dz, dn], dim=-1)
    dgh = torch.cat([dr, dz, dn * r], dim=-1)
    return (dgi @ w_i.T, dgh @ w_h.T + g * z, x.T @ dgi, h.T @ dgh,
            dgi.sum(0), dgh.sum(0))


class GruCell(torch.autograd.Function):
    """The fused cell: the primal from K3, the backward in plain torch
    (kernels/gru.py:113-139, the reference's custom_vjp)."""

    @staticmethod
    def forward(ctx, x, h, w_i, w_h, b_i, b_h):
        args = tuple(t.contiguous() for t in (x, h, w_i, w_h, b_i, b_h))
        ctx.save_for_backward(*args)
        return gru_cell_fwd(*args)

    @staticmethod
    def backward(ctx, g):
        return gru_cell_bwd(g, *ctx.saved_tensors)


def _dims(h0, cond, w_i, w_h, b_i, b_h, w_ar, w_out, b_out):
    """(B, H, F) after checking every shape against h0 and w_ar."""
    if h0.dim() != 2 or w_ar.dim() != 2:
        raise ValueError(f"want h0 [B,H] and w_ar [F,F]; got "
                         f"{tuple(h0.shape)}, {tuple(w_ar.shape)}")
    b, hid = h0.shape
    feat = w_ar.shape[0]
    want = {"h0": (b, hid), "cond": (b, feat), "w_i": (2 * feat, 3 * hid),
            "w_h": (hid, 3 * hid), "b_i": (3 * hid,), "b_h": (3 * hid,),
            "w_ar": (feat, feat), "w_out": (hid, feat), "b_out": (feat,)}
    for name, t in zip(ARG_NAMES, (h0, cond, w_i, w_h, b_i, b_h, w_ar,
                                   w_out, b_out)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} is {tuple(t.shape)}, want {want[name]}")
    return b, hid, feat


def gru_scan_plain(h0, cond, w_i, w_h, b_i, b_h, w_ar, w_out, b_out,
                   n_frames: int, with_h: bool = False):
    """The scan in plain torch with the kernel's numerics: f32 (float64
    stays float64, for gradcheck) carries and products, h0.dtype output.
    -> feats [B, n_frames, F], and h_seq [n_frames, B, H] if with_h."""
    acc = _acc_dtype(h0)
    wi, wh, bi, bh, war, wout, bout = (t.to(acc) for t in (
        w_i, w_h, b_i, b_h, w_ar, w_out, b_out))
    c = cond.to(acc)
    h = h0.to(acc)
    feat = torch.zeros(h0.shape[0], w_ar.shape[0], dtype=acc,
                       device=h0.device)
    feats, hs = [], []
    for _ in range(n_frames):
        x = torch.cat([feat @ war, c], dim=-1)
        h = gru_cell(x, h, wi, wh, bi, bh)
        feat = torch.tanh(h @ wout + bout)
        feats.append(feat.to(h0.dtype))
        hs.append(h.to(h0.dtype))
    out = torch.stack(feats, dim=1)
    return (out, torch.stack(hs)) if with_h else out


def _prev_residuals(h0, feats, h_seq):
    """(feat_{t-1}, h_{t-1}) for every frame, frame-major: zeros then
    feats[:, :-1]; h0 then h_seq[:-1] (kernels/gru.py:426-429)."""
    f_nbf = feats.transpose(0, 1)
    prev_f = torch.cat([torch.zeros_like(f_nbf[:1]), f_nbf[:-1]])
    prev_h = torch.cat([h0[None], h_seq[:-1]])
    return prev_f.contiguous(), prev_h.contiguous()


def gru_scan_bwd_plain(g, h0, cond, w_i, w_h, b_i, b_h, w_ar, w_out, b_out,
                       feats, h_seq):
    """K5's function in plain torch: the reverse sweep of
    _gru_scan_bwd_kernel frame by frame. g [B, n_frames, F] is the
    cotangent of feats; feats and h_seq are K4's outputs. -> (dh0, dcond,
    dw_i, dw_h, db_i, db_h, dw_ar, dw_out, db_out), each in its primal's
    dtype."""
    primals = (h0, cond, w_i, w_h, b_i, b_h, w_ar, w_out, b_out)
    acc = _acc_dtype(h0)
    wi, wh, bi, bh, war, wout, bout = (t.to(acc) for t in (
        w_i, w_h, b_i, b_h, w_ar, w_out, b_out))
    c = cond.to(acc)
    prev_f, prev_h = _prev_residuals(h0, feats, h_seq)
    feat_dim = w_ar.shape[0]
    dh = torch.zeros(h0.shape, dtype=acc, device=h0.device)
    dfc = torch.zeros(cond.shape, dtype=acc, device=h0.device)
    dwi, dwh, dbi, dbh, dwar, dwout, dbout, dcond = (
        torch.zeros(t.shape, dtype=acc, device=h0.device)
        for t in (w_i, w_h, b_i, b_h, w_ar, w_out, b_out, cond))
    for t in reversed(range(g.shape[1])):
        pf, ph = prev_f[t].to(acc), prev_h[t].to(acc)
        x = torch.cat([pf @ war, c], dim=-1)
        r, z, n, h_n = gru_gates(x, ph, wi, wh, bi, bh)
        h = (1.0 - z) * n + z * ph
        feat_t = torch.tanh(h @ wout + bout)
        dfeat = g[:, t].to(acc) + dfc
        dfp = dfeat * (1.0 - feat_t * feat_t)
        dwout += h.T @ dfp
        dbout += dfp.sum(0)
        dh = dh + dfp @ wout.T
        dz = dh * (ph - n) * z * (1.0 - z)
        dn = dh * (1.0 - z) * (1.0 - n * n)
        dr = dn * h_n * r * (1.0 - r)
        dgi = torch.cat([dr, dz, dn], dim=-1)
        dgh = torch.cat([dr, dz, dn * r], dim=-1)
        dx = dgi @ wi.T
        dh_prev = dgh @ wh.T + dh * z
        dwi += x.T @ dgi
        dwh += ph.T @ dgh
        dbi += dgi.sum(0)
        dbh += dgh.sum(0)
        dar = dx[:, :feat_dim]
        dcond += dx[:, feat_dim:]
        dwar += pf.T @ dar
        dfc = dar @ war.T
        dh = dh_prev
    grads = (dh, dcond, dwi, dwh, dbi, dbh, dwar, dwout, dbout)
    return tuple(d.to(p.dtype) for d, p in zip(grads, primals))


# The persistent path (csrc/gru_scan.cu: scan_fwd_persistent,
# scan_bwd_persistent). A block owns m-tiles of 16 batch rows, unit tiles of
# 8 hidden units (their r, z and n gate columns) and feature tiles of 8
# columns of F; its products keep one m16n8 accumulator per column tile,
# which bounds a block to GRU_MAX_UNIT_TILES and GRU_MAX_FEAT_TILES.
GRU_TILE = 16                # H and F: multiples of one mma depth
GRU_MAX_BATCH = 64           # four m-tiles of 16 rows
GRU_MAX_UNIT_TILES = 2
GRU_MAX_FEAT_TILES = 2
GRU_MAX_M_TILES = 4
GRU_WARPS = 8                # csrc/gru_scan.cu kPW
GRU_SMEM_LIMIT = 232448      # an H100 block's shared memory
GRU_MAX_BLOCKS = 132         # one block per SM of an H100: all resident
PLAN_HEAD = 6                # G, NG, MS, MT, UT, FT; then per block
                             # m_lo, m_hi, u_lo, u_hi, f_lo, f_hi


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gru_persistent_smem(hid: int, feat: int, mt: int, ut: int,
                        ft: int) -> tuple[int, int]:
    """Shared memory (bytes) of scan_fwd_persistent and
    scan_bwd_persistent for blocks of at most mt m-tiles, ut unit tiles
    and ft feature tiles (csrc/gru_scan.cu fwd_smem, bwd_smem): 16 bytes
    per weight fragment row of 8 columns, the warps' partial sums, and
    the f32 state the block keeps (the cond half, h w_h and h; dh, dh*z,
    the frame sums of dgi, dgh and dfp, and the next frame's epilogue
    inputs)."""
    fwd = (16 * (3 * ut * (2 * feat + hid) + ft * (hid + feat))
           + GRU_WARPS * 8 * 32 * 16 + 4 * 16 * mt * 56 * ut)
    bwd = (16 * (ut * (feat + 3 * hid) + ft * (3 * hid + feat))
           + GRU_WARPS * 2 * 32 * 16 + 4 * 16 * mt * (64 * ut + 8 * ft)
           + 4 * 16 * mt * (52 * ut + 12 * ft))
    return fwd, bwd


def gru_persistent_grid(batch: int, hid: int, feat: int) -> tuple[int, int]:
    """(column groups, row groups) of the persistent launch: the fewest
    column groups that keep every block within its tile caps, and the
    batch's m-tiles spread over as many row groups as the card holds
    (at most one per m-tile): 32 x 4 = 128 blocks at cond_gru_sc09.
    (The choice the timings of every grid on the card favour: PERF.md
    §6.)"""
    ng = max(_cdiv(hid // 8, GRU_MAX_UNIT_TILES),
             _cdiv(feat // 8, GRU_MAX_FEAT_TILES))
    n_m = _cdiv(batch, 16)
    ms = next((m for m in (4, 2, 1) if m <= n_m and ng * m <= GRU_MAX_BLOCKS),
              1)
    return ng, ms


def _split(n: int, parts: int, i: int) -> tuple[int, int]:
    return i * n // parts, (i + 1) * n // parts


@functools.cache
def gru_persistent_plan(batch: int, hid: int, feat: int,
                        grid: tuple[int, int] | None = None) -> np.ndarray:
    """The int32 array the persistent kernels are launched with (read-only;
    cached, the wrapper asks every call). Block b = cg * ms + rg takes row
    group rg's m-tiles and column group cg's unit and feature tiles, each
    range an even contiguous share, so every (row, column) of every phase
    has exactly one owner. Header: G, NG, MS and the largest m, unit and
    feature tile counts of a block (the kernels' shared memory layout)."""
    ng, ms = gru_persistent_grid(batch, hid, feat) if grid is None else grid
    n_m, n_u, n_f = _cdiv(batch, 16), hid // 8, feat // 8
    if ms > n_m or hid % 8 or feat % 8:
        raise ValueError(f"grid {ng}x{ms} for B={batch} H={hid} F={feat}")
    blocks = []
    for cg in range(ng):
        for rg in range(ms):
            blocks.append((*_split(n_m, ms, rg), *_split(n_u, ng, cg),
                           *_split(n_f, ng, cg)))
    per = np.asarray(blocks, dtype=np.int32).reshape(-1, 6)
    spans = per[:, 1::2] - per[:, 0::2]
    mt, ut, ft = (int(v) for v in spans.max(axis=0))
    if (ut > GRU_MAX_UNIT_TILES or ft > GRU_MAX_FEAT_TILES
            or mt > GRU_MAX_M_TILES):
        raise ValueError(f"grid {ng}x{ms}: a block holds {mt} m-tiles, {ut} "
                         f"unit and {ft} feature tiles")
    plan = np.concatenate([np.asarray([ng * ms, ng, ms, mt, ut, ft],
                                      dtype=np.int32), per.ravel()])
    plan.flags.writeable = False
    return plan


def gru_scan_persistent(dtype, batch: int, hid: int, feat: int) -> bool:
    """True iff gru_scan_fwd and gru_scan_bwd run this shape on the
    persistent path: bf16, 1 <= B <= GRU_MAX_BATCH, H and F multiples of
    GRU_TILE, and a grid that fits the card (one block per SM, each within
    the shared memory limit)."""
    if not (dtype == torch.bfloat16 and 1 <= batch <= GRU_MAX_BATCH
            and hid > 0 and feat > 0 and hid % GRU_TILE == 0
            and feat % GRU_TILE == 0):
        return False
    blocks, _, _, mt, ut, ft = (
        int(v) for v in gru_persistent_plan(batch, hid, feat)[:PLAN_HEAD])
    return (blocks <= GRU_MAX_BLOCKS
            and max(gru_persistent_smem(hid, feat, mt, ut, ft))
            <= GRU_SMEM_LIMIT)


@functools.cache
def _device_plan(plan_bytes: bytes, device: torch.device) -> torch.Tensor:
    return torch.frombuffer(bytearray(plan_bytes), dtype=torch.int32).to(
        device)


def _plan_ptrs(plan: np.ndarray, device: torch.device):
    """(host array, its int pointer, the device copy) of a plan; the first
    and last keep the memory alive through the call."""
    host = np.ascontiguousarray(plan, dtype=np.int32)
    dev = _device_plan(host.tobytes(), device)
    return host, ctypes.cast(host.ctypes.data,
                             ctypes.POINTER(ctypes.c_int)), dev


@functools.cache
def _lib() -> ctypes.CDLL:
    """csrc/gru_scan.cu, built at first use, with its C signatures."""
    lib = _build.load("gru_scan")
    lib.gru_scan_fwd_workspace.argtypes = [ctypes.c_int] * 3
    lib.gru_scan_fwd_workspace.restype = ctypes.c_size_t
    lib.gru_scan_bwd_workspace.argtypes = [ctypes.c_int] * 4
    lib.gru_scan_bwd_workspace.restype = ctypes.c_size_t
    plan = [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    lib.gru_scan_fwd.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                                 + plan + [ctypes.c_void_p])
    lib.gru_scan_fwd.restype = ctypes.c_int
    lib.gru_scan_bwd.argtypes = ([ctypes.c_void_p] * 22 + [ctypes.c_int] * 6
                                 + plan + [ctypes.c_void_p])
    lib.gru_scan_bwd.restype = ctypes.c_int
    lib.gru_scan_error_string.argtypes = [ctypes.c_int]
    lib.gru_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_args(name: str, tensors) -> None:
    first = tensors[0]
    if first.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {first.device}")
    if first.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got "
                        f"{first.dtype}")
    for t in tensors:
        if t.device != first.device or t.dtype != first.dtype:
            raise TypeError(f"{name}: a {t.dtype} tensor on {t.device} "
                            f"beside {first.dtype} on {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")


def _raise_if(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.gru_scan_error_string(err).decode())


def _scan_fwd(args, n_frames: int, with_h: bool, plan):
    """One K4 call on checked CUDA tensors: the persistent launch with the
    given plan, or the host loop when plan is None."""
    h0 = args[0]
    b, hid, feat = _dims(*args)
    dev, dt = h0.device, h0.dtype
    out = torch.empty((b, n_frames, feat), dtype=dt, device=dev)
    h_seq = (torch.empty((n_frames, b, hid), dtype=dt, device=dev)
             if with_h else None)
    lib = _lib()
    ws = torch.empty(lib.gru_scan_fwd_workspace(b, hid, feat),
                     dtype=torch.float32, device=dev)
    # host keeps the plan's array alive through the call
    host, ptr, plan_dev = (_plan_ptrs(plan, dev) if plan is not None
                           else (None, None, None))
    err = lib.gru_scan_fwd(
        *(t.data_ptr() for t in args), out.data_ptr(),
        h_seq.data_ptr() if with_h else None, ws.data_ptr(), b, hid, feat,
        n_frames, _DTYPES[dt], ptr,
        plan_dev.data_ptr() if plan_dev is not None else None,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_if(lib, err, "gru_scan")
    return (out, h_seq) if with_h else out


@hooks.kernel
def gru_scan_fwd(h0, cond, w_i, w_h, b_i, b_h, w_ar, w_out, b_out,
                 n_frames: int, with_h: bool = False):
    """The scan -> feats [B, n_frames, F] (and h_seq [n_frames, B, H] if
    with_h), in h0.dtype. A CPU tensor takes the plain form. A CUDA
    tensor launches K4 (every input f32 or every input bf16) or raises;
    it never falls back. Where ``gru_scan_persistent`` holds the scan is
    one persistent launch (counted in ``launches_persistent``), else the
    host loop (``launches_loop``); ``launches`` counts both. Records no
    autograd history (see gru_scan)."""
    args = (h0, cond, w_i, w_h, b_i, b_h, w_ar, w_out, b_out)
    b, hid, feat = _dims(*args)
    if n_frames < 1:
        raise ValueError(f"n_frames={n_frames}")
    if h0.device.type == "cpu":
        return gru_scan_plain(*args, n_frames, with_h)
    _check_kernel_args("gru_scan", args)
    if gru_scan_persistent(h0.dtype, b, hid, feat):
        res = _scan_fwd(args, n_frames, with_h,
                        gru_persistent_plan(b, hid, feat))
        gru_scan_fwd.launches_persistent += 1
    else:
        res = _scan_fwd(args, n_frames, with_h, None)
        gru_scan_fwd.launches_loop += 1
    gru_scan_fwd.launches += 1
    return res


gru_scan_fwd.launches = 0
gru_scan_fwd.launches_persistent = gru_scan_fwd.launches_loop = 0


@hooks.kernel
def gru_scan_bwd(g, h0, cond, w_i, w_h, b_i, b_h, w_ar, w_out, b_out,
                 feats, h_seq):
    """K5: the nine gradients of the scan from the cotangent g
    [B, n_frames, F] and K4's feats and h_seq, each in its primal's dtype.
    A CPU tensor takes the plain form; a CUDA tensor launches K5 or
    raises."""
    args = (h0, cond, w_i, w_h, b_i, b_h, w_ar, w_out, b_out)
    b, hid, feat = _dims(*args)
    n_frames = feats.shape[1]
    want = {"g": (b, n_frames, feat), "feats": (b, n_frames, feat),
            "h_seq": (n_frames, b, hid)}
    for name, t in (("g", g), ("feats", feats), ("h_seq", h_seq)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} is {tuple(t.shape)}, want {want[name]}")
    if h0.device.type == "cpu":
        return gru_scan_bwd_plain(g, *args, feats, h_seq)
    _check_kernel_args("gru_scan_bwd", (g, *args, feats, h_seq))
    persistent = gru_scan_persistent(h0.dtype, b, hid, feat)
    call = ScanBwdCall(g, args, feats, h_seq,
                       gru_persistent_plan(b, hid, feat) if persistent
                       else None)
    call.run(BWD_ALL_STAGES)
    if persistent:
        gru_scan_bwd.launches_persistent += 1
    else:
        gru_scan_bwd.launches_loop += 1
    gru_scan_bwd.launches += 1
    return call.grads


gru_scan_bwd.launches = 0
gru_scan_bwd.launches_persistent = gru_scan_bwd.launches_loop = 0

# K5's stages (csrc/gru_scan.cu gru_scan_bwd): the recompute of every
# frame's gates, the reverse sweep, the weight gradients
BWD_STAGES = {"recompute": 1, "sweep": 2, "weight_grads": 4}
BWD_ALL_STAGES = 7


class ScanBwdCall:
    """One K5 call on checked CUDA tensors, its workspace and outputs held,
    so that its stages can run as separate launches in order (to time
    them); plan None takes the host loop for the sweep."""

    def __init__(self, g, args, feats, h_seq, plan):
        h0 = args[0]
        self.b, self.hid, self.feat = _dims(*args)
        self.n_frames = feats.shape[1]
        self.g, self.args, self.feats, self.h_seq = g, args, feats, h_seq
        self.grads = tuple(torch.empty_like(t) for t in args)
        self.lib = _lib()
        self.ws = torch.empty(
            self.lib.gru_scan_bwd_workspace(self.b, self.hid, self.feat,
                                            self.n_frames),
            dtype=torch.float32, device=h0.device)
        self.plan = (_plan_ptrs(plan, h0.device) if plan is not None
                     else (None, None, None))

    def run(self, stages: int) -> None:
        h0 = self.args[0]
        _, ptr, plan_dev = self.plan
        err = self.lib.gru_scan_bwd(
            self.g.data_ptr(), self.feats.data_ptr(), self.h_seq.data_ptr(),
            *(t.data_ptr() for t in self.args),
            *(d.data_ptr() for d in self.grads), self.ws.data_ptr(), self.b,
            self.hid, self.feat, self.n_frames, _DTYPES[h0.dtype], stages,
            ptr, plan_dev.data_ptr() if plan_dev is not None else None,
            torch.cuda.current_stream(h0.device).cuda_stream)
        _raise_if(self.lib, err, "gru_scan_bwd")


class GruScan(torch.autograd.Function):
    """The scan with its K5 backward (first order: the generator is
    differentiated once, kernels/gru.py's custom_vjp)."""

    @staticmethod
    def forward(ctx, h0, cond, w_i, w_h, b_i, b_h, w_ar, w_out, b_out,
                n_frames):
        args = tuple(t.contiguous() for t in (h0, cond, w_i, w_h, b_i, b_h,
                                              w_ar, w_out, b_out))
        out, h_seq = gru_scan_fwd(*args, n_frames, with_h=True)
        ctx.save_for_backward(*args, out, h_seq)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        *args, out, h_seq = ctx.saved_tensors
        return (*gru_scan_bwd(g.contiguous(), *args, out, h_seq), None)


def gru_scan(h0, cond, w_i, w_h, b_i, b_h, w_ar, w_out, b_out,
             n_frames: int) -> torch.Tensor:
    """The model's entry: feats [B, n_frames, F]. When a gradient is
    wanted the forward emits h_seq for K5; otherwise (the critic's fakes
    under no_grad, serving) it runs K4 without it."""
    args = (h0, cond, w_i, w_h, b_i, b_h, w_ar, w_out, b_out)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return GruScan.apply(*args, n_frames)
    return gru_scan_fwd(*args, n_frames)
