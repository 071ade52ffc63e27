"""Fused ingest of int16 store rows: the CUDA kernel and its plain form.

Port of audiogan_tpu/kernels/ingest.py. The kernel (``csrc/ingest.cu``)
replaces ``ingest_fused`` / ``_kernel``: per row, crop at ``offs[b]``,
/32768, peak or RMS normalization to ``target``, mu-law. A store row
shorter than the clip is zero-padded inside the kernel, so no geometry is
routed around it. ``ingest_fused_plain`` is the kernel's oracle and the
CPU path; it follows ops/ingest.py's order (cast -> crop -> normalize ->
mu-law, SPEC I1).

The kernel runs one thread-block cluster of ``cluster`` blocks per row.
``ingest_plan`` is its partition, in the integer arithmetic the kernel
does: rank r loads the crop's samples of its output slice [lo, hi) once
(16-byte loads of the aligned vectors wholly inside the row's samples,
the unaligned head and tail one sample at a time), folds them into its
threads' partial peak or sum of squares and stages them in shared
memory; after every warp's partial reaches every rank (added by a fixed
tree over (rank, warp) slots) it writes its slice with 16-byte stores
(an unaligned head and tail one float at a time).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from audiogan_tpu_torch.kernels import _build, hooks
from audiogan_tpu_torch.ops.framing import crop_rows
from audiogan_tpu_torch.ops.mulaw import mu_law_compand
from audiogan_tpu_torch.ops.normalize import normalize_amplitude

MODES = {"none": 0, "peak": 1, "rms": 2}
INGEST_THREADS = 256     # threads per block (csrc/ingest.cu kThreads)
INGEST_VEC = 8           # int16 samples per 16-byte load
INGEST_OUT_VEC = 4       # f32 samples per 16-byte store
INGEST_CLUSTERS = (4, 8)
INGEST_CLUSTER = 4       # blocks per row: 256 blocks at B = 64 (8 was
                         # slower at B = 64 and at B = 640: PERF.md §6)
INGEST_MAX_SLICE = 98304  # samples a block stages: 192 KB of shared memory


def _round_up(a: int, m: int) -> int:
    return -(-a // m) * m


def ingest_slice(clip: int, cluster: int) -> int:
    """Output samples per rank: clip / cluster rounded up to whole 8-sample
    vectors; the last ranks' slices are short or empty."""
    return _round_up(-(-clip // cluster), INGEST_VEC)


@functools.cache
def ingest_cluster(clip: int) -> int:
    """The cluster size for a clip: INGEST_CLUSTER, or 8 where a rank of
    INGEST_CLUSTER would stage more than INGEST_MAX_SLICE samples."""
    for c in sorted({INGEST_CLUSTER, max(INGEST_CLUSTERS)}):
        if ingest_slice(clip, c) <= INGEST_MAX_SLICE:
            return c
    raise ValueError(f"clip_len={clip}: over {max(INGEST_CLUSTERS)} x "
                     f"{INGEST_MAX_SLICE} samples, more than a cluster stages")


def _split(lo: int, hi: int, vec: int) -> dict:
    """[lo, hi) of absolute indices as a head of single elements up to the
    first vec-aligned index, whole vec-wide vectors [va, vb), and a tail
    of single elements; head and tail hold fewer than vec each."""
    hi = max(hi, lo)
    h_end = min(_round_up(lo, vec), hi)
    t_beg = max(hi // vec * vec, h_end)
    return {"head": (lo, h_end), "body": (-(-h_end // vec), t_beg // vec),
            "tail": (t_beg, hi)}


def ingest_plan(store: int, clip: int, cluster: int, off: int, row: int = 0,
                base: int = 0, obase: int = 0) -> list[dict]:
    """Rank by rank, the samples of row ``row`` (crop offset ``off``) that
    csrc/ingest.cu's cluster reads and writes:

    - ``lo, hi``: the rank's output samples; the ranks partition [0, clip).
    - ``src``: the row's samples it reads, [off + lo, off + hi) clipped to
      [0, store); outputs whose sample lies outside read 0.
    - ``load``: those samples as absolute indices (``base``, the raw
      tensor's start in samples past a 16-byte boundary, + row * store +
      s) split into a head, 16-byte vectors ``body`` and a tail;
      ``v0``, the first vector touched, is where its staging starts.
    - ``store``: its outputs as absolute indices (``obase`` + row * clip +
      o) split the same way into 4-float vectors.
    """
    sl = ingest_slice(clip, cluster)
    row0, orow0 = base + row * store, obase + row * clip
    plan = []
    for rank in range(cluster):
        lo = min(rank * sl, clip)
        hi = min(lo + sl, clip)
        s_lo = min(max(off + lo, 0), store)
        s_hi = max(min(off + hi, store), s_lo)
        plan.append({"rank": rank, "lo": lo, "hi": hi, "src": (s_lo, s_hi),
                     "v0": (row0 + s_lo) // INGEST_VEC,
                     "load": _split(row0 + s_lo, row0 + s_hi, INGEST_VEC),
                     "store": _split(orow0 + lo, orow0 + hi,
                                     INGEST_OUT_VEC)})
    return plan


def ingest_fused_plain(raw: torch.Tensor, offsets: torch.Tensor,
                       clip_len: int, mode: str = "peak",
                       target: float = 0.999, mu: float = 255.0,
                       eps: float = 1e-8) -> torch.Tensor:
    """int16 [B, S] + offsets [B] -> f32 [B, clip_len] in plain PyTorch."""
    x = crop_rows(raw.float() / 32768.0, offsets, clip_len)
    x = normalize_amplitude(x, mode, target, eps)
    return mu_law_compand(x, mu) if mu else x


@functools.cache
def _ingest_lib() -> ctypes.CDLL:
    """csrc/ingest.cu, built at first use, with its C signatures."""
    lib = _build.load("ingest")
    lib.ingest_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
        + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])
    lib.ingest_launch.restype = ctypes.c_int
    lib.ingest_error_string.argtypes = [ctypes.c_int]
    lib.ingest_error_string.restype = ctypes.c_char_p
    return lib


def _ingest_launch(raw: torch.Tensor, offsets: torch.Tensor, clip_len: int,
                   mode: str, target: float, mu: float, eps: float,
                   cluster: int) -> torch.Tensor:
    """One launch of the cluster kernel with ``cluster`` blocks per row
    (ingest_fused's choice, or a measured alternative); raw int16 and
    offsets int32, contiguous on the card. Not a counted launch."""
    bsz, store = raw.shape
    out = torch.empty((bsz, clip_len), dtype=torch.float32,
                      device=raw.device)
    lib = _ingest_lib()
    err = lib.ingest_launch(
        raw.data_ptr(), offsets.data_ptr(), out.data_ptr(), bsz, store,
        clip_len, MODES[mode], float(target), float(mu), float(eps), cluster,
        torch.cuda.current_stream(raw.device).cuda_stream)
    if err != 0:
        raise RuntimeError("ingest kernel launch failed: "
                           + lib.ingest_error_string(err).decode())
    return out


@hooks.kernel
def ingest_fused(raw: torch.Tensor, offsets: torch.Tensor, clip_len: int,
                 mode: str = "peak", target: float = 0.999,
                 mu: float = 255.0, eps: float = 1e-8) -> torch.Tensor:
    """int16 [B, S] + crop offsets [B] -> companded f32 [B, clip_len].

    A CPU tensor takes the plain form. A CUDA tensor launches the ingest
    kernel (``ingest_cluster(clip_len)`` blocks per row) or raises; it
    never falls back. mu = 0 skips the companding. Offsets lie in [0,
    max(S - clip_len, 0)]; the plain form checks that, the kernel reads
    zeros outside the row.
    """
    if mode not in MODES:
        raise ValueError(f"normalize mode {mode!r} not in {sorted(MODES)}")
    if raw.dim() != 2 or offsets.shape != (raw.shape[0],):
        raise ValueError(f"want raw [B, S] and offsets [B]; got "
                         f"{tuple(raw.shape)}, {tuple(offsets.shape)}")
    if raw.dtype != torch.int16:
        raise TypeError(f"ingest takes int16 rows, got {raw.dtype}")
    if clip_len < 1:
        raise ValueError(f"clip_len={clip_len}")
    mu = float(mu) if mu else 0.0
    if raw.device.type == "cpu":
        return ingest_fused_plain(raw, offsets, clip_len, mode, target, mu,
                                  eps)
    if raw.device.type != "cuda":
        raise ValueError(f"no ingest kernel for device {raw.device}")
    if offsets.device != raw.device or offsets.dtype != torch.int32:
        raise TypeError(f"offsets are {offsets.dtype} on {offsets.device}; "
                        f"want int32 on {raw.device}")
    if not (raw.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("ingest takes contiguous raw and offsets")
    out = _ingest_launch(raw, offsets, clip_len, mode, target, mu, eps,
                         ingest_cluster(clip_len))
    ingest_fused.launches += 1
    return out


ingest_fused.launches = 0
