"""Fused ingest of int16 store rows: the CUDA kernel and its plain form.

Port of audiogan_tpu/kernels/ingest.py. The kernel (``csrc/ingest.cu``)
replaces ``ingest_fused`` / ``_kernel``: per row, crop at ``offs[b]``,
/32768, peak or RMS normalization to ``target``, mu-law. A store row
shorter than the clip is zero-padded inside the kernel, so no geometry is
routed around it. ``ingest_fused_plain`` is the kernel's oracle and the
CPU path; it follows ops/ingest.py's order (cast -> crop -> normalize ->
mu-law, SPEC I1).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from audiogan_tpu_torch.kernels import _build
from audiogan_tpu_torch.ops.framing import crop_rows
from audiogan_tpu_torch.ops.mulaw import mu_law_compand
from audiogan_tpu_torch.ops.normalize import normalize_amplitude

MODES = {"none": 0, "peak": 1, "rms": 2}


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
        + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    lib.ingest_launch.restype = ctypes.c_int
    lib.ingest_error_string.argtypes = [ctypes.c_int]
    lib.ingest_error_string.restype = ctypes.c_char_p
    return lib


def ingest_fused(raw: torch.Tensor, offsets: torch.Tensor, clip_len: int,
                 mode: str = "peak", target: float = 0.999,
                 mu: float = 255.0, eps: float = 1e-8) -> torch.Tensor:
    """int16 [B, S] + crop offsets [B] -> companded f32 [B, clip_len].

    A CPU tensor takes the plain form. A CUDA tensor launches the ingest
    kernel or raises; it never falls back. mu = 0 skips the companding.
    Offsets lie in [0, max(S - clip_len, 0)]; the plain form checks that,
    the kernel reads zeros outside the row.
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
    bsz, store = raw.shape
    out = torch.empty((bsz, clip_len), dtype=torch.float32,
                      device=raw.device)
    lib = _ingest_lib()
    err = lib.ingest_launch(
        raw.data_ptr(), offsets.data_ptr(), out.data_ptr(), bsz, store,
        clip_len, MODES[mode], float(target), mu, float(eps),
        torch.cuda.current_stream(raw.device).cuda_stream)
    if err != 0:
        raise RuntimeError("ingest kernel launch failed: "
                           + lib.ingest_error_string(err).decode())
    ingest_fused.launches += 1
    return out


ingest_fused.launches = 0
