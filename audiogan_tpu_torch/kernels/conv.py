"""Fused act(conv1d(x, w) + b) and act(conv_transpose1d(x, w) + b): the
CUDA kernels and their plain forms.

Port of audiogan_tpu/kernels/conv.py's row-conv paths. ``csrc/conv1d.cu``
replaces ``_conv1d_pallas`` and ``csrc/convt1d.cu`` replaces
``_convt_pallas`` (both bodies are ``_rowconv_kernel``).
``conv1d_ba_plain`` (f32 ``F.conv1d`` on explicitly padded input) and
``conv_transpose1d_ba_plain`` (the polyphase form of
``_convt_polyphase_xla``) are the kernels' oracles and the CPU path.
These wrappers record no autograd history: kernels/autograd.py wraps them
in Functions.

Each kernel has two paths, and which one a call takes is a pure function
of dtype and shape (``conv1d_tensor_core``, ``convt_tensor_core``): bf16
with Cin, Cout >= 64 runs the implicit GEMM on the tensor cores
(``csrc/igemm_tc.cuh``: TMA, an mbarrier ring, wgmma), everything else
the CUDA-core kernels (``csrc/conv_cc.cuh``: an f32-FMA implicit GEMM
with M flattened across the batch and a cp.async ring, and two kernels
for one channel in or out). Neither does tap arithmetic of its own:
``conv1d_ksteps`` / ``convt_ksteps`` list the tensor-core k-steps and
``tc_plan`` packs them with the tile shape into the int32 array the
kernel is launched with; ``cc_plan`` does the same for the CUDA cores
(kind, tile, and each phase's (tap, row shift) list).

conv1d is the strided cross-correlation of x with ``pad_lo`` zeros in
front and ``pad_hi`` behind:

    y[t] = sum_j x_pad[t*s + j] @ w[j],  t_out = (T + lo + hi - K)//s + 1

convT here is the input-dilated cross-correlation with the filter centred
at ``pad_lo``:

    y[m*s + rho] = sum_q x[m + q] @ w[pad_lo - rho + q*s]

It equals ``torch.nn.ConvTranspose1d`` only with the taps flipped and the
padding moved, so neither the plain form nor the kernel uses that layer.
Layouts: x [B, T, Cin], w [K, Cin, Cout], b [Cout], y [B, out_len, Cout].
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from audiogan_tpu_torch.kernels import _build, hooks

ACTS = {"none": 0, "relu": 1, "leaky_relu": 2, "tanh": 3}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The tensor-core kernel's tiles, largest first: (consumer warpgroups, N);
# a tile is M = 64 x warpgroups output rows by N output channels.
TC_TILES = ((2, 128), (2, 64), (1, 128), (1, 64))
TC_CHUNK = 64            # channels per k-step chunk (one 128-byte row)
TC_MAX_STEPS = 64        # k-step table entries (csrc/igemm_tc.cuh)
TC_MAX_PHASES = 16
TC_MIN_BLOCKS = 99       # 3/4 of the H100's 132 SMs: a grid below it
                         # takes the 64-row tile


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _same_pads(t_in: int, k: int, s: int) -> tuple[int, int, int]:
    """SAME padding for a stride-s conv: (t_out, lo, hi), t_out =
    ceil(t_in / s). Asymmetric: T=16384, k=25, s=4 gives lo=10, hi=11."""
    t_out = _cdiv(t_in, s)
    total = max((t_out - 1) * s + k - t_in, 0)
    lo = total // 2
    return t_out, lo, total - lo


def conv1d_pads(t_in: int, k: int, stride: int, padding) -> tuple[int, int]:
    """(pad_lo, pad_hi) from "SAME" or an explicit (lo, hi) pair."""
    if isinstance(padding, str):
        if padding != "SAME":
            raise ValueError(f"padding={padding!r}: want 'SAME' or (lo, hi)")
        _, lo, hi = _same_pads(t_in, k, stride)
        return lo, hi
    lo, hi = padding
    return int(lo), int(hi)


def conv1d_t_out(t_in: int, k: int, stride: int, pad_lo: int,
                 pad_hi: int) -> int:
    return (t_in + pad_lo + pad_hi - k) // stride + 1


def _convt_phase_range(k: int, s: int, pad_lo: int) -> tuple[int, int]:
    """(q_min, q_taps) for y[m*s+rho] = sum_q x[m+q] @ w[pad_lo-rho+q*s]."""
    q_min = -(pad_lo // s)
    q_max = (k + s - 2 - pad_lo) // s
    return q_min, q_max - q_min + 1


def _convt_phase_taps(w: torch.Tensor, s: int, pad_lo: int):
    """Polyphase tap bank V[tau, rho, c, o] = w[pad_lo - rho +
    (q_min+tau)*s, c, o], zero where the tap index leaves [0, k)."""
    k = w.shape[0]
    q_min, q_taps = _convt_phase_range(k, s, pad_lo)
    tau = np.arange(q_taps)[:, None]
    rho = np.arange(s)[None, :]
    j_idx = pad_lo - rho + (q_min + tau) * s            # [Q, s]
    valid = torch.as_tensor((j_idx >= 0) & (j_idx < k), device=w.device)
    taps = w[torch.as_tensor(np.clip(j_idx, 0, k - 1), device=w.device)]
    v = torch.where(valid[:, :, None, None], taps, torch.zeros_like(taps))
    return v, q_min, q_taps                             # [Q, s, ci, co]


def conv1d_ksteps(k: int, s: int, pad_lo: int) -> list[tuple[int, int, int]]:
    """The conv1d k-steps (tap j, row shift qq, phase pp), one per tap:
    with x viewed as [B, T/s, s, Cin], tap j of output t reads packed row
    t + qq at phase pp, where j - pad_lo = qq*s + pp, 0 <= pp < s."""
    return [(j, (j - pad_lo) // s, (j - pad_lo) % s) for j in range(k)]


def convt_ksteps(k: int, s: int, pad_lo: int
                 ) -> list[list[tuple[int, int, int]]]:
    """The convT k-steps per output phase rho: (tap j, row shift q, 0)
    with y[m*s + rho] += x[m + q] @ w[j], j = pad_lo - rho + q*s. Taps
    outside [0, K) are left out, not multiplied by zeros."""
    q_min, q_taps = _convt_phase_range(k, s, pad_lo)
    phases = []
    for rho in range(s):
        phases.append([(pad_lo - rho + q * s, q, 0)
                       for q in range(q_min, q_min + q_taps)
                       if 0 <= pad_lo - rho + q * s < k])
    return phases


def _tc_shapes_ok(dtype, cin: int, cout: int, k: int) -> bool:
    # TMA needs 16-byte strides (Cin, Cout multiples of 8 in bf16)
    return (dtype == torch.bfloat16 and cin >= 64 and cout >= 64
            and cin % 8 == 0 and cout % 8 == 0 and k <= TC_MAX_STEPS)


def conv1d_tensor_core(dtype, t_in: int, cin: int, cout: int, k: int,
                       stride: int) -> bool:
    """True iff conv1d_ba runs this geometry on the tensor cores; the
    packed view [B, T/s, s, Cin] needs T % s == 0."""
    return _tc_shapes_ok(dtype, cin, cout, k) and t_in % stride == 0


def convt_tensor_core(dtype, cin: int, cout: int, k: int,
                      stride: int) -> bool:
    """True iff conv_transpose1d_ba runs this geometry on the tensor
    cores (one phase per output phase, at most TC_MAX_PHASES)."""
    return _tc_shapes_ok(dtype, cin, cout, k) and stride <= TC_MAX_PHASES


def tc_tile_shape(batch: int, t_lim: int, n_phase: int, cout: int,
                  tile: int, stack_rows: int = 1
                  ) -> tuple[int, int, int, int]:
    """(rows, nb, n_mt, blocks) of TC_TILES[tile]: t_lim output rows per
    element and phase; rows shorter than half the tile stack nb =
    M // t_lim batch elements (each with its own zero halo) where t_lim
    is a multiple of stack_rows, else one element's rows in n_mt tiles of
    M, the ragged last one masked."""
    nwg, bn = TC_TILES[tile]
    bm = 64 * nwg
    nb = bm // t_lim if t_lim < bm and t_lim % stack_rows == 0 else 1
    if nb > 1:
        rows, n_mt, n_m = t_lim, 1, _cdiv(batch, nb)
    else:
        n_mt = _cdiv(t_lim, bm)
        rows, n_m = bm, batch * n_mt
    return rows, nb, n_mt, n_m * n_phase * _cdiv(cout, bn)


def tc_rows_per_element(batch: int, t_lim: int, cout: int, tile: int,
                        stack_rows: int = 1) -> float:
    """Tile rows one batch element occupies at TC_TILES[tile], its own
    t_lim rows and the masked rows padding them: M / nb stacked, else
    n_mt * M."""
    rows, nb, n_mt, _ = tc_tile_shape(batch, t_lim, 1, cout, tile,
                                      stack_rows)
    bm = 64 * TC_TILES[tile][0]
    return bm / nb if nb > 1 else n_mt * bm


def tc_tile(batch: int, t_lim: int, n_phase: int, cout: int,
            stack_rows: int = 1) -> int:
    """N = 128 unless Cout <= 64 (half a 128-wide tile would multiply
    zeros); M = 128 unless that grid leaves more than a quarter of the
    SMs without a block, or 64-row tiles pad an element's rows to at most
    three quarters of what 128-row tiles do (t_lim = 144: 192 rows
    against 256), then M = 64; failing both, the tile with the most
    blocks. (The choice the timings of every tile on the card favour at
    the flagship's and music_44k_dp16's geometries: PERF.md §6.)"""
    bn = 128 if cout > 64 else 64
    blocks = [tc_tile_shape(batch, t_lim, n_phase, cout, i, stack_rows)[3]
              for i in range(len(TC_TILES))]
    big, small = TC_TILES.index((2, bn)), TC_TILES.index((1, bn))
    if blocks[big] >= TC_MIN_BLOCKS and 4 * tc_rows_per_element(
            batch, t_lim, cout, small, stack_rows) > 3 * tc_rows_per_element(
            batch, t_lim, cout, big, stack_rows):
        return big
    if blocks[small] >= TC_MIN_BLOCKS:
        return small
    return max(range(len(TC_TILES)), key=lambda i: (blocks[i], -i))


def tc_plan(batch: int, t_lim: int, s_out: int, y_len: int,
            phases: list, cout: int, tile: int | None = None,
            stack_rows: int = 1) -> np.ndarray:
    """The int32 array the tensor-core kernel is launched with: tile,
    rows, nb, n_mt, t_lim, s_out, y_len, n_phase, n_steps, start[n_phase
    + 1], tap[n_steps], row[n_steps], pin[n_steps]. Output row t of phase
    p lands at y row t*s_out + p, masked against t_lim and y_len."""
    n_phase = len(phases)
    if tile is None:
        tile = tc_tile(batch, t_lim, n_phase, cout, stack_rows)
    rows, nb, n_mt, _ = tc_tile_shape(batch, t_lim, n_phase, cout, tile,
                                      stack_rows)
    steps = [st for ph in phases for st in ph]
    if n_phase > TC_MAX_PHASES or len(steps) > TC_MAX_STEPS:
        raise ValueError(f"{n_phase} phases, {len(steps)} k-steps: over "
                         f"the kernel's {TC_MAX_PHASES}, {TC_MAX_STEPS}")
    start = np.cumsum([0] + [len(ph) for ph in phases]).tolist()
    return np.asarray([tile, rows, nb, n_mt, t_lim, s_out, y_len, n_phase,
                       len(steps), *start, *(st[0] for st in steps),
                       *(st[1] for st in steps), *(st[2] for st in steps)],
                      dtype=np.int32)


@functools.cache
def conv1d_tc_plan(batch: int, t_in: int, cout: int, k: int, stride: int,
                   pad_lo: int, pad_hi: int, tile: int | None = None,
                   stack_rows: int = 1) -> np.ndarray:
    """conv1d's plan (read-only; cached, the wrapper asks every call).
    stack_rows: elements stack only where their output rows are a
    multiple of it (K6's per-element boxes: 8, one swizzle period)."""
    t_out = conv1d_t_out(t_in, k, stride, pad_lo, pad_hi)
    plan = tc_plan(batch, t_out, 1, t_out, [conv1d_ksteps(k, stride, pad_lo)],
                   cout, tile, stack_rows)
    plan.flags.writeable = False
    return plan


@functools.cache
def convt_tc_plan(batch: int, cout: int, k: int, stride: int, pad_lo: int,
                  out_len: int, tile: int | None = None) -> np.ndarray:
    """convT's plan (read-only; cached, the wrapper asks every call)."""
    plan = tc_plan(batch, _cdiv(out_len, stride), stride, out_len,
                   convt_ksteps(k, stride, pad_lo), cout, tile)
    plan.flags.writeable = False
    return plan


# The CUDA-core kernels of csrc/conv_cc.cuh: the implicit GEMM's tiles
# (TM rows x TN channels, 256 threads), thin_cout's threads per block (4
# rows m each; N = (phase, Cout) in groups of NP) and thin_cin's rows per
# block (64 channels).
CC_GEMM, CC_THIN_COUT, CC_THIN_CIN = 0, 1, 2
CC_TILES = ((128, 128), (128, 64), (64, 64), (128, 32))
CC_THIN_COUT_THREADS = (128, 256)
CC_THIN_NP = (4, 8, 16)
CC_THIN_CIN_ROWS = (256, 128)
CC_THIN_CHUNK = 8        # thin_cout's channels per chunk
CC_THIN_CIN_N = 64       # thin_cin's output channels per block
CC_MAX_PHASES = 64
CC_MAX_STEPS = 256
CC_THIN_SMEM = 200 * 1024   # a thin kernel only where it fits the SM
CC_ONE_BLOCK_SMEM = 113 * 1024   # above it one block per SM
CC_MIN_BLOCKS = 132      # thin kernels: one block per SM, else the
                         # smaller tile
CC_GEMM_MIN_BLOCKS = 220  # the gemm's wide tile (128 x 128; 128 x 64 for
                          # Cout <= 64, 128 x 32 for Cout <= 32) where its
                          # grid gives most SMs two blocks, else 64 x 64
                          # (PERF.md §6, PR 20)


def thin_cout_smem(itemsize: int, threads: int, np_: int, cin: int,
                   q_taps: int) -> int:
    """Shared bytes of thin_cout_kernel: every tap of its columns in f32,
    then two x stages of 4*threads + q_taps - 1 rows at a pitch of 48
    (f32) or 16 (bf16) bytes."""
    chunks = _cdiv(cin, CC_THIN_CHUNK)
    pitch = 12 if itemsize == 4 else 8
    return (4 * chunks * CC_THIN_CHUNK * q_taps * np_
            + 2 * (4 * threads + q_taps - 1) * pitch * itemsize)


def thin_cin_smem(rows: int, cin: int, k: int, s: int) -> int:
    """Shared bytes of thin_cin_kernel: the taps [Cin][K][64] and the x
    window [Cin][s][rows + (K-1)//s], all f32."""
    return 4 * (cin * k * CC_THIN_CIN_N + cin * s * (rows + (k - 1) // s))


def _thin_np(s: int, cout: int) -> int:
    """thin_cout's columns per block: the (phase, Cout) pairs in the
    smallest group that holds them, else groups of 16."""
    return next((n for n in CC_THIN_NP if n >= s * cout), CC_THIN_NP[-1])


def cc_kind(family: str, dtype, cin: int, cout: int, k: int, s: int,
            pad_lo: int) -> int:
    """Which CUDA-core kernel runs a geometry: thin_cout for a convT with
    Cout <= 16, thin_cin for a conv1d with Cin < 8 (each where the shared
    memory of its smaller tile fits), else the implicit GEMM."""
    if family == "convt1d" and cout <= 16:
        q_taps = _convt_phase_range(k, s, pad_lo)[1]
        if thin_cout_smem(dtype.itemsize, min(CC_THIN_COUT_THREADS),
                          _thin_np(s, cout), cin, q_taps) <= CC_THIN_SMEM:
            return CC_THIN_COUT
    if family == "conv1d" and cin < 8 and thin_cin_smem(
            min(CC_THIN_CIN_ROWS), cin, k, s) <= CC_THIN_SMEM:
        return CC_THIN_CIN
    return CC_GEMM


def cc_steps(family: str, k: int, s: int, pad_lo: int, kind: int
             ) -> list[list[tuple[int, int]]]:
    """Each output phase's k-steps (tap j, row shift): output row m of the
    phase reads x row m * s_in + shift. conv1d: one phase, every tap, shift
    j - pad_lo. convT: phase rho's taps j = pad_lo - rho + q*s at shift q,
    those outside [0, K) left out, or on thin_cout kept as -1 (multiplied
    as zeros, so every phase lists the same q_taps shifts)."""
    if family == "conv1d":
        return [[(j, j - pad_lo) for j in range(k)]]
    q_min, q_taps = _convt_phase_range(k, s, pad_lo)
    phases = []
    for rho in range(s):
        taps = [(pad_lo - rho + q * s, q) for q in range(q_min, q_min + q_taps)]
        if kind == CC_THIN_COUT:
            phases.append([(j if 0 <= j < k else -1, q) for j, q in taps])
        else:
            phases.append([(j, q) for j, q in taps if 0 <= j < k])
    return phases


def cc_blocks(kind: int, tile: int, batch: int, m_lim: int, n_phase: int,
              cout: int) -> int:
    """Blocks of a CUDA-core launch at the given tile."""
    if kind == CC_GEMM:
        tm, tn = CC_TILES[tile]
        return _cdiv(batch * m_lim, tm) * n_phase * _cdiv(cout, tn)
    if kind == CC_THIN_COUT:
        return (_cdiv(m_lim, 4 * CC_THIN_COUT_THREADS[tile]) * batch
                * _cdiv(n_phase * cout, _thin_np(n_phase, cout)))
    return (_cdiv(m_lim, CC_THIN_CIN_ROWS[tile]) * batch
            * _cdiv(cout, CC_THIN_CIN_N))


def _gemm_wide(cout: int) -> int:
    """The gemm's widest tile that Cout fills at least half of."""
    return 0 if cout > 64 else 1 if cout > 32 else 3


def cc_tiles(kind: int, cout: int) -> list[int]:
    """The candidate tiles of a kind: the gemm's 64-wide tiles and its
    widest one for Cout (kernels/conv.py::_gemm_wide)."""
    if kind == CC_GEMM:
        return sorted({1, 2, _gemm_wide(cout)})
    return list(range(len(CC_THIN_COUT_THREADS if kind == CC_THIN_COUT
                          else CC_THIN_CIN_ROWS)))


def cc_tile(kind: int, batch: int, m_lim: int, n_phase: int, cout: int,
            smem_of=None) -> int:
    """The gemm: its widest tile for Cout where that grid has
    CC_GEMM_MIN_BLOCKS blocks, else 64 x 64. (Every tile timed at every
    cp and tp geometry on the card, PERF.md §6, PR 20: 128 x 128 was the
    fastest or within 8% of it wherever its grid had 220 blocks or more,
    and 4-70% slower wherever it had 180 or fewer, where 64 x 64 was the
    fastest or within 11% of it.) The thin kernels: the first tile whose
    grid gives every SM a block (and, for thin_cout, whose shared memory
    leaves room for two blocks per SM); failing that the one with the
    most blocks."""
    if kind == CC_GEMM:
        wide = _gemm_wide(cout)
        return wide if cc_blocks(kind, wide, batch, m_lim, n_phase, cout) \
            >= CC_GEMM_MIN_BLOCKS else 2
    tiles = cc_tiles(kind, cout)
    for t in tiles:
        if cc_blocks(kind, t, batch, m_lim, n_phase, cout) >= CC_MIN_BLOCKS \
                and (smem_of is None or smem_of(t) <= CC_ONE_BLOCK_SMEM):
            return t
    return max(tiles, key=lambda t: (cc_blocks(kind, t, batch, m_lim,
                                               n_phase, cout), -t))


def cc_plan(family: str, dtype, batch: int, t_in: int, cin: int, cout: int,
            k: int, s: int, pad_lo: int, out_len: int,
            tile: int | None = None) -> np.ndarray:
    """The int32 array the CUDA-core kernels are launched with: kind, tile,
    ck (the gemm's channel chunk, thin_cout's NP, thin_cin's Cin), m_lim
    (output rows m per element and phase), s_in, s_out, out_len, n_phase,
    n_steps, start[n_phase + 1], tap[n_steps], shift[n_steps]. out_len is
    conv1d's t_out. ck keeps the first design's summation order: 8, or 16
    on a convT gemm with more than 16 rows m."""
    kind = cc_kind(family, dtype, cin, cout, k, s, pad_lo)
    phases = cc_steps(family, k, s, pad_lo, kind)
    if family == "conv1d":
        m_lim, s_in, s_out = out_len, s, 1
    else:
        m_lim, s_in, s_out = _cdiv(out_len, s), 1, s
    smem_of = None
    if kind == CC_GEMM:
        ck = 16 if family == "convt1d" and cout > 16 and m_lim > 16 else 8
    elif kind == CC_THIN_COUT:
        ck = _thin_np(s, cout)
        smem_of = lambda t: thin_cout_smem(dtype.itemsize,
                                           CC_THIN_COUT_THREADS[t], ck, cin,
                                           len(phases[0]))
    else:
        ck = cin
    if tile is None:
        tile = cc_tile(kind, batch, m_lim, len(phases), cout, smem_of)
    steps = [st for ph in phases for st in ph]
    if len(phases) > CC_MAX_PHASES or len(steps) > CC_MAX_STEPS or not steps:
        raise ValueError(f"{len(phases)} phases, {len(steps)} k-steps: "
                         f"outside the kernel's {CC_MAX_PHASES}, "
                         f"{CC_MAX_STEPS}")
    start = np.cumsum([0] + [len(ph) for ph in phases]).tolist()
    return np.asarray([kind, tile, ck, m_lim, s_in, s_out, out_len,
                       len(phases), len(steps), *start,
                       *(st[0] for st in steps), *(st[1] for st in steps)],
                      dtype=np.int32)


@functools.cache
def conv1d_cc_plan(dtype, batch: int, t_in: int, cin: int, cout: int, k: int,
                   stride: int, pad_lo: int, pad_hi: int,
                   tile: int | None = None) -> np.ndarray:
    """conv1d's CUDA-core plan (read-only; cached, the wrapper asks every
    call)."""
    plan = cc_plan("conv1d", dtype, batch, t_in, cin, cout, k, stride, pad_lo,
                   conv1d_t_out(t_in, k, stride, pad_lo, pad_hi), tile)
    plan.flags.writeable = False
    return plan


@functools.cache
def convt_cc_plan(dtype, batch: int, t_in: int, cin: int, cout: int, k: int,
                  stride: int, pad_lo: int, out_len: int,
                  tile: int | None = None) -> np.ndarray:
    """convT's CUDA-core plan (read-only; cached, the wrapper asks every
    call)."""
    plan = cc_plan("convt1d", dtype, batch, t_in, cin, cout, k, stride,
                   pad_lo, out_len, tile)
    plan.flags.writeable = False
    return plan


def _apply_act(r: torch.Tensor, act: str, slope: float) -> torch.Tensor:
    """The kernel's epilogue; leaky_relu keeps r where r >= 0."""
    if act == "relu":
        return torch.clamp_min(r, 0.0)
    if act == "leaky_relu":
        return torch.where(r >= 0, r, r * slope)
    if act == "tanh":
        return torch.tanh(r)
    if act != "none":
        raise ValueError(f"act={act!r} not in {sorted(ACTS)}")
    return r


def _check_shapes(x, w, b, stride, pad_lo, out_len) -> None:
    if x.dim() != 3 or w.dim() != 3 or b.dim() != 1:
        raise ValueError(f"want x [B,T,Cin], w [K,Cin,Cout], b [Cout]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    k, cin, cout = w.shape
    if x.shape[2] != cin or b.shape[0] != cout:
        raise ValueError(f"channel mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    if stride < 1 or not 0 <= pad_lo < k or out_len < 1:
        raise ValueError(f"bad geometry: stride={stride}, pad_lo={pad_lo} "
                         f"(k={k}), out_len={out_len}")


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _check_conv1d(x, w, b, stride, pad_lo, pad_hi) -> None:
    _check_shapes(x, w, b, stride, 0, 1)
    k = w.shape[0]
    if pad_lo < 0 or pad_hi < 0:
        raise ValueError(f"bad pads ({pad_lo}, {pad_hi})")
    if x.shape[1] + pad_lo + pad_hi < k:
        raise ValueError(f"padded length {x.shape[1] + pad_lo + pad_hi} "
                         f"is shorter than the kernel ({k})")


def conv1d_ba_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    stride: int, pad_lo: int, pad_hi: int,
                    act: str = "none", slope: float = 0.2) -> torch.Tensor:
    """Plain PyTorch form: f32 F.conv1d on the explicitly padded input,
    then the epilogue; the result is cast to x.dtype as the kernel's is
    (float64 stays float64, for gradcheck)."""
    acc = _acc_dtype(x)
    xc = F.pad(x.to(acc).transpose(1, 2), (pad_lo, pad_hi))
    y = F.conv1d(xc, w.to(acc).permute(2, 1, 0), stride=stride)
    y = _apply_act(y.transpose(1, 2) + b.to(acc), act, slope)
    return y.to(x.dtype).contiguous()


def conv_transpose1d_ba_plain(x: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor, stride: int, pad_lo: int,
                              out_len: int, act: str = "none",
                              slope: float = 0.2) -> torch.Tensor:
    """Plain PyTorch form: the phase-tap gather, one stride-1 conv over the
    output phases, then the epilogue, all in f32; the result is cast to
    x.dtype as the kernel's is (float64 stays float64, for gradcheck)."""
    bsz, t_in, cin = x.shape
    cout = w.shape[2]
    s = stride
    m_out = -(-out_len // s)
    acc = _acc_dtype(x)
    v, q_min, q_taps = _convt_phase_taps(w.to(acc), s, pad_lo)
    # [Q, s, ci, co] -> conv1d weight [s*co, ci, Q] (cross-correlation)
    v = v.permute(1, 3, 2, 0).reshape(s * cout, cin, q_taps)
    xc = F.pad(x.to(acc).transpose(1, 2),
               (-q_min, m_out + q_min + q_taps - 1 - t_in))
    y = F.conv1d(xc, v)                                 # [B, s*co, m_out]
    y = y.transpose(1, 2).reshape(bsz, m_out * s, cout)[:, :out_len]
    return _apply_act(y + b.to(acc), act, slope).to(x.dtype).contiguous()


def _check_kernel_args(name, x, w, b) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    for tname, t in (("w", w), ("b", b)):
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError(f"{tname} is {t.dtype} on {t.device}; x is "
                            f"{x.dtype} on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name} takes contiguous x, w and b")


def _check_tc_alignment(name, *tensors) -> None:
    """TMA reads from 16-byte aligned bases; a tensor at another offset
    is refused, never rerouted."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the tensor-core path needs 16-byte "
                             f"aligned tensors; one starts at "
                             f"{t.data_ptr():#x}")


def _c_plan(plan: np.ndarray):
    """The plan as the kernel's int32 array pointer (with the array that
    keeps it alive)."""
    plan = np.ascontiguousarray(plan, dtype=np.int32)
    return plan, ctypes.cast(plan.ctypes.data, ctypes.POINTER(ctypes.c_int))


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + getattr(lib, f"{name}_error_string")(err)
                           .decode())


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


@functools.cache
def _conv1d_lib() -> ctypes.CDLL:
    """csrc/conv1d.cu, built at first use, with its C signatures."""
    lib = _build.load("conv1d")
    lib.conv1d_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_float,
           ctypes.c_int, ctypes.c_void_p])
    lib.conv1d_launch.restype = ctypes.c_int
    lib.conv1d_tc_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_float,
           ctypes.c_void_p])
    lib.conv1d_tc_launch.restype = ctypes.c_int
    lib.conv1d_error_string.argtypes = [ctypes.c_int]
    lib.conv1d_error_string.restype = ctypes.c_char_p
    return lib


def _conv1d_tc(x, w, b, y, stride, plan, act, slope) -> None:
    """One launch of conv1d's tensor-core kernel with the given plan."""
    _check_tc_alignment("conv1d", x, w, b, y)
    lib = _conv1d_lib()
    bsz, t_in, cin = x.shape
    k, _, cout = w.shape
    plan, ptr = _c_plan(plan)
    err = lib.conv1d_tc_launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, t_in,
        cin, cout, k, stride, ptr, ACTS[act], slope, _stream(x))
    _raise_on(lib, err, "conv1d")


def _cc_launch(lib, name, x, w, b, y, plan, act, slope) -> None:
    """One launch of a CUDA-core kernel (conv1d's or convT's library) with
    the given plan."""
    bsz, t_in, cin = x.shape
    k, _, cout = w.shape
    plan, ptr = _c_plan(plan)
    err = getattr(lib, f"{name}_launch")(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, t_in,
        cin, cout, k, ptr, ACTS[act], slope, _DTYPES[x.dtype], _stream(x))
    _raise_on(lib, err, name)


@hooks.kernel
def conv1d_ba(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              stride: int = 1, pad_lo: int = 0, pad_hi: int = 0,
              act: str = "none", slope: float = 0.2) -> torch.Tensor:
    """Fused act(conv1d(x, w) + b) with explicit pads -> [B, t_out, Cout].

    A CPU tensor takes the plain form. A CUDA tensor launches the conv1d
    kernel (f32 or bf16 in, f32 accumulate, x.dtype out) or raises; it
    never falls back. pad_hi may be below what SAME gives (autodiff's dx
    of a convT asks for max(hi, 0)). Where ``conv1d_tensor_core`` holds,
    the tensor-core path runs (counted in ``launches_tc``), else the
    CUDA-core kernels of ``conv1d_cc_plan`` (``launches_cc``);
    ``launches`` counts both.
    """
    if act not in ACTS:
        raise ValueError(f"act={act!r} not in {sorted(ACTS)}")
    _check_conv1d(x, w, b, stride, pad_lo, pad_hi)
    if x.device.type == "cpu":
        return conv1d_ba_plain(x, w, b, stride, pad_lo, pad_hi, act, slope)
    _check_kernel_args("conv1d", x, w, b)
    bsz, t_in, cin = x.shape
    k, _, cout = w.shape
    t_out = conv1d_t_out(t_in, k, stride, pad_lo, pad_hi)
    y = torch.empty((bsz, t_out, cout), dtype=x.dtype, device=x.device)
    if conv1d_tensor_core(x.dtype, t_in, cin, cout, k, stride):
        _conv1d_tc(x, w, b, y, stride,
                   conv1d_tc_plan(bsz, t_in, cout, k, stride, pad_lo, pad_hi),
                   act, slope)
        conv1d_ba.launches_tc += 1
    else:
        _cc_launch(_conv1d_lib(), "conv1d", x, w, b, y,
                   conv1d_cc_plan(x.dtype, bsz, t_in, cin, cout, k, stride,
                                  pad_lo, pad_hi), act, slope)
        conv1d_ba.launches_cc += 1
    conv1d_ba.launches += 1
    return y


conv1d_ba.launches = conv1d_ba.launches_tc = conv1d_ba.launches_cc = 0


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    """csrc/convt1d.cu, built at first use, with its C signatures."""
    lib = _build.load("convt1d")
    lib.convt1d_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_float,
           ctypes.c_int, ctypes.c_void_p])
    lib.convt1d_launch.restype = ctypes.c_int
    lib.convt1d_tc_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_float,
           ctypes.c_void_p])
    lib.convt1d_tc_launch.restype = ctypes.c_int
    lib.convt1d_error_string.argtypes = [ctypes.c_int]
    lib.convt1d_error_string.restype = ctypes.c_char_p
    return lib


def _convt_tc(x, w, b, y, plan, act, slope) -> None:
    """One launch of convT's tensor-core kernel with the given plan."""
    _check_tc_alignment("convt1d", x, w, b, y)
    lib = _kernel_lib()
    bsz, t_in, cin = x.shape
    k, _, cout = w.shape
    plan, ptr = _c_plan(plan)
    err = lib.convt1d_tc_launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, t_in,
        cin, cout, k, ptr, ACTS[act], slope, _stream(x))
    _raise_on(lib, err, "convt1d")


@hooks.kernel
def conv_transpose1d_ba(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        stride: int, pad_lo: int | None = None,
                        out_len: int | None = None, act: str = "none",
                        slope: float = 0.2) -> torch.Tensor:
    """Fused act(conv_transpose1d(x, w) + b) -> [B, out_len, Cout].

    A CPU tensor takes the plain form. A CUDA tensor launches the
    convt1d kernel (f32 or bf16 in, f32 accumulate, x.dtype out) or
    raises; it never falls back. Defaults as in the JAX function:
    pad_lo = (K-1)//2, out_len = T*stride. Where ``convt_tensor_core``
    holds, the tensor-core path runs (counted in ``launches_tc``), else
    the CUDA-core kernels of ``convt_cc_plan`` (``launches_cc``);
    ``launches`` counts both.
    """
    k = w.shape[0]
    pad_lo = (k - 1) // 2 if pad_lo is None else pad_lo
    out_len = x.shape[1] * stride if out_len is None else out_len
    if act not in ACTS:
        raise ValueError(f"act={act!r} not in {sorted(ACTS)}")
    _check_shapes(x, w, b, stride, pad_lo, out_len)
    if x.device.type == "cpu":
        return conv_transpose1d_ba_plain(x, w, b, stride, pad_lo, out_len,
                                         act, slope)
    _check_kernel_args("convt1d", x, w, b)
    cout = w.shape[2]
    y = torch.empty((x.shape[0], out_len, cout), dtype=x.dtype,
                    device=x.device)
    if convt_tensor_core(x.dtype, x.shape[2], cout, k, stride):
        _convt_tc(x, w, b, y,
                  convt_tc_plan(x.shape[0], cout, k, stride, pad_lo, out_len),
                  act, slope)
        conv_transpose1d_ba.launches_tc += 1
    else:
        bsz, t_in, cin = x.shape
        _cc_launch(_kernel_lib(), "convt1d", x, w, b, y,
                   convt_cc_plan(x.dtype, bsz, t_in, cin, cout, k, stride,
                                 pad_lo, out_len), act, slope)
        conv_transpose1d_ba.launches_cc += 1
    conv_transpose1d_ba.launches += 1
    return y


conv_transpose1d_ba.launches = conv_transpose1d_ba.launches_tc = 0
conv_transpose1d_ba.launches_cc = 0
