"""Shuffled-input convs, the fused phase-shuffle sites: the CUDA kernels
and their plain forms.

Port of audiogan_tpu/kernels/sconv.py. ``csrc/sconv.cu`` replaces
``_sconv1d_pallas`` (K6, body ``_sconv_kernel``) and ``_sconvt1d_pallas``
(K7, body ``_sconvt_kernel``):

    sconv1d_ba: y = act(conv1d(window_select(xp, offs), w) + b)
    sconvt1d:   y = window_place(convT(ct, wf), offs)

conv1d and convT are those of kernels/conv.py (its docstring gives their
index maps); the conv's pads (pad_lo, pad_hi) act in z-space, on the
selected window, so the rows of xp outside it are never read as data.
The plain forms are exactly that composition (``sconv1d_ba_lowered`` and
``sconvt1d_lowered`` on the reference's XLA route): the CPU path and the
kernels' oracles. These wrappers record no autograd history:
kernels/autograd.py wraps them in Functions.

Each has two paths, and which one a call takes is a pure function of
dtype and shape (``sconv1d_tensor_core``, ``sconvt1d_tensor_core``). K6:
bf16 where conv1d takes the tensor cores on z (Cin, Cout >= 64, t %
stride == 0) and 2 rad + 1 <= 9 runs K1''s implicit GEMM with one TMA
view of xp per window offset (``csrc/igemm_tc.cuh``; its plan
``sconv1d_tc_plan`` is conv1d's on z). K7: bf16 where convT takes the
tensor cores runs K1's implicit GEMM on ct with the placed epilogue, which
stores row yr of element b at row yr + offs[b] and writes the 2 rad rows
outside the window as zeros (its plan ``sconvt1d_tc_plan`` is convT's
with the output pitch t + 2 rad). Everything else takes the CUDA-core
tiles of ``csrc/rowconv_tiles.cuh``.

Layouts as the reference's contract: xp [B, t + 2 rad, Cin] (reflect-
padded and masked, ops/sconv.py), offs [B] in [0, 2 rad], w [K, Cin,
Cout], b [Cout] -> y [B, t_out, Cout]; ct [B, T', Cout], wf [K, Cout, Cin]
-> [B, t + 2 rad, Cin], zero outside [offs[b], offs[b] + t).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from audiogan_tpu_torch.kernels import _build, hooks
from audiogan_tpu_torch.kernels.conv import (ACTS, _DTYPES, _c_plan,
                                             _check_conv1d,
                                             _check_kernel_args,
                                             _check_shapes,
                                             _check_tc_alignment,
                                             conv1d_ba_plain, conv1d_t_out,
                                             conv1d_tc_plan,
                                             conv1d_tensor_core,
                                             conv_transpose1d_ba_plain,
                                             convt_tc_plan,
                                             convt_tensor_core)
from audiogan_tpu_torch.ops.sconv import window_place, window_select


SCONV_TC_MAX_VIEWS = 9       # csrc/igemm_tc.cuh kMaxViews: 2 rad + 1
SCONV_TC_STACK_ROWS = 8      # a stacked element's box starts a 1024-byte
                             # swizzle period: rows a multiple of 8


def sconv1d_tensor_core(dtype, t: int, cin: int, cout: int, k: int,
                        stride: int, rad: int) -> bool:
    """True iff sconv1d_ba runs this geometry on the tensor cores:
    conv1d's predicate on z (t rows) and one view per window offset,
    2 rad + 1 <= SCONV_TC_MAX_VIEWS."""
    return (conv1d_tensor_core(dtype, t, cin, cout, k, stride)
            and 0 <= rad and 2 * rad + 1 <= SCONV_TC_MAX_VIEWS)


def sconv1d_tc_plan(batch: int, t: int, cout: int, k: int, stride: int,
                    pad_lo: int, pad_hi: int, tile: int | None = None
                    ) -> np.ndarray:
    """K6's plan: conv1d's on z (t rows), elements stacked only where
    their output rows are a multiple of SCONV_TC_STACK_ROWS."""
    return conv1d_tc_plan(batch, t, cout, k, stride, pad_lo, pad_hi, tile,
                          SCONV_TC_STACK_ROWS)


def sconvt1d_tensor_core(dtype, cc: int, co: int, k: int, stride: int,
                         rad: int) -> bool:
    """True iff sconvt1d runs this geometry on the tensor cores: convT's
    predicate (ct's Cc in, Co out) and rad >= 0; the zero rows are
    written with 16-byte stores, which Co % 8 == 0 (in convT's predicate)
    allows."""
    return convt_tensor_core(dtype, cc, co, k, stride) and rad >= 0


@functools.cache
def sconvt1d_tc_plan(batch: int, co: int, k: int, stride: int,
                     pad_lo_t: int, t: int, rad: int,
                     tile: int | None = None) -> np.ndarray:
    """K7's plan (read-only; cached, the wrapper asks every call): K1's
    convT plan to t rows, then the output pitch t + 2 rad, the rows per
    element of the placed output."""
    plan = np.append(convt_tc_plan(batch, co, k, stride, pad_lo_t, t, tile),
                     np.int32(t + 2 * rad))
    plan.flags.writeable = False
    return plan


def _check_offs(offs: torch.Tensor, batch: int, rad: int) -> None:
    if rad < 0 or offs.shape != (batch,) or offs.dtype.is_floating_point:
        raise ValueError(f"want integer offs [{batch}] and rad >= 0; got "
                         f"{offs.dtype} {tuple(offs.shape)}, rad={rad}")


def sconv1d_ba_plain(xp, w, b, offs, stride, pad_lo, pad_hi, rad,
                     act="none", slope=0.2):
    """Plain PyTorch form: the window select, then conv1d_ba_plain."""
    z = window_select(xp, offs, xp.shape[1] - 2 * rad, rad)
    return conv1d_ba_plain(z, w, b, stride, pad_lo, pad_hi, act, slope)


def sconvt1d_plain(ct, wf, offs, stride, pad_lo_t, t, rad):
    """Plain PyTorch form: the convT to t rows, then the window place."""
    zeros = ct.new_zeros(wf.shape[2])
    u = conv_transpose1d_ba_plain(ct, wf, zeros, stride, pad_lo_t, t)
    return window_place(u, offs, rad)


@functools.cache
def _lib() -> ctypes.CDLL:
    """csrc/sconv.cu, built at first use, with its C signatures."""
    lib = _build.load("sconv")
    lib.sconv1d_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.sconv1d_launch.restype = ctypes.c_int
    lib.sconv1d_tc_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_float,
           ctypes.c_void_p])
    lib.sconv1d_tc_launch.restype = ctypes.c_int
    lib.sconvt1d_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    lib.sconvt1d_launch.restype = ctypes.c_int
    lib.sconvt1d_tc_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    lib.sconvt1d_tc_launch.restype = ctypes.c_int
    lib.sconv_error_string.argtypes = [ctypes.c_int]
    lib.sconv_error_string.restype = ctypes.c_char_p
    return lib


def _raise_if(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.sconv_error_string(err).decode())


def _device_offs(offs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if offs.device != x.device:
        raise ValueError(f"offs on {offs.device}, x on {x.device}")
    return offs.to(torch.int32).contiguous()


def _sconv1d_tc(xp, w, b, offs, y, stride, rad, plan, act, slope) -> None:
    """One launch of K6's tensor-core kernel with the given plan; offs
    int32 on the card."""
    _check_tc_alignment("sconv1d", xp, w, b, y)
    lib = _lib()
    bsz, tp, cin = xp.shape
    k, _, cout = w.shape
    plan, ptr = _c_plan(plan)
    err = lib.sconv1d_tc_launch(
        xp.data_ptr(), w.data_ptr(), b.data_ptr(), offs.data_ptr(),
        y.data_ptr(), bsz, tp, cin, cout, k, stride, rad, ptr, ACTS[act],
        slope, torch.cuda.current_stream(xp.device).cuda_stream)
    _raise_if(lib, err, "sconv1d")


def _sconvt1d_tc(ct, wf, offs, y, rad, plan) -> None:
    """One launch of K7's tensor-core kernel with the given plan; offs
    int32 on the card."""
    _check_tc_alignment("sconvt1d", ct, wf, y)
    lib = _lib()
    bsz, t_in, cc = ct.shape
    k, _, co = wf.shape
    plan, ptr = _c_plan(plan)
    err = lib.sconvt1d_tc_launch(
        ct.data_ptr(), wf.data_ptr(), offs.data_ptr(), y.data_ptr(), bsz,
        t_in, cc, co, k, rad, ptr,
        torch.cuda.current_stream(ct.device).cuda_stream)
    _raise_if(lib, err, "sconvt1d")


@hooks.kernel
def sconv1d_ba(xp: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               offs: torch.Tensor, stride: int, pad_lo: int, pad_hi: int,
               rad: int, act: str = "none", slope: float = 0.2
               ) -> torch.Tensor:
    """K6: act(conv1d(window_select(xp, offs), w) + b) -> [B, t_out, Cout].

    A CPU tensor takes the plain form. A CUDA tensor launches the kernel
    (f32 or bf16 in, f32 accumulate, xp.dtype out) or raises; it never
    falls back. offs must lie in [0, 2 rad]; the kernel never reads
    outside xp whatever they hold. Where ``sconv1d_tensor_core`` holds,
    the tensor-core path runs (counted in ``launches_tc``), else the
    CUDA-core tiles (``launches_cc``); ``launches`` counts both.
    """
    if act not in ACTS:
        raise ValueError(f"act={act!r} not in {sorted(ACTS)}")
    if xp.dim() != 3 or xp.shape[1] <= 2 * rad:
        raise ValueError(f"want xp [B, t + 2 rad, Cin] with t >= 1; got "
                         f"{tuple(xp.shape)}, rad={rad}")
    t = xp.shape[1] - 2 * rad
    _check_conv1d(xp[:, :t], w, b, stride, pad_lo, pad_hi)
    _check_offs(offs, xp.shape[0], rad)
    if xp.device.type == "cpu":
        return sconv1d_ba_plain(xp, w, b, offs, stride, pad_lo, pad_hi, rad,
                                act, slope)
    _check_kernel_args("sconv1d", xp, w, b)
    offs = _device_offs(offs, xp)
    bsz, tp, cin = xp.shape
    k, _, cout = w.shape
    t_out = conv1d_t_out(t, k, stride, pad_lo, pad_hi)
    y = torch.empty((bsz, t_out, cout), dtype=xp.dtype, device=xp.device)
    if sconv1d_tensor_core(xp.dtype, t, cin, cout, k, stride, rad):
        _sconv1d_tc(xp, w, b, offs, y, stride, rad,
                    sconv1d_tc_plan(bsz, t, cout, k, stride, pad_lo, pad_hi),
                    act, slope)
        sconv1d_ba.launches_tc += 1
    else:
        lib = _lib()
        err = lib.sconv1d_launch(
            xp.data_ptr(), w.data_ptr(), b.data_ptr(), offs.data_ptr(),
            y.data_ptr(), bsz, tp, cin, cout, k, stride, pad_lo, pad_hi,
            rad, ACTS[act], slope, _DTYPES[xp.dtype],
            torch.cuda.current_stream(xp.device).cuda_stream)
        _raise_if(lib, err, "sconv1d")
        sconv1d_ba.launches_cc += 1
    sconv1d_ba.launches += 1
    return y


sconv1d_ba.launches = sconv1d_ba.launches_tc = sconv1d_ba.launches_cc = 0


@hooks.kernel
def sconvt1d(ct: torch.Tensor, wf: torch.Tensor, offs: torch.Tensor,
             stride: int, pad_lo_t: int, t: int, rad: int) -> torch.Tensor:
    """K7: window_place(convT(ct, wf, pad_lo_t, out_len=t), offs) ->
    [B, t + 2 rad, Cin], zero outside each window.

    A CPU tensor takes the plain form. A CUDA tensor launches the kernel
    (f32 or bf16 in, f32 accumulate, ct.dtype out) or raises; it never
    falls back. offs must lie in [0, 2 rad]; the kernel never writes
    outside the output whatever they hold. Where ``sconvt1d_tensor_core``
    holds, the tensor-core path runs (counted in ``launches_tc``), else
    the CUDA-core tiles (``launches_cc``); ``launches`` counts both.
    """
    if wf.dim() != 3:
        raise ValueError(f"want wf [K, Cout, Cin], got {tuple(wf.shape)}")
    zeros = ct.new_zeros(wf.shape[2])
    _check_shapes(ct, wf, zeros, stride, pad_lo_t, t)
    _check_offs(offs, ct.shape[0], rad)
    if ct.device.type == "cpu":
        return sconvt1d_plain(ct, wf, offs, stride, pad_lo_t, t, rad)
    _check_kernel_args("sconvt1d", ct, wf, zeros)
    offs = _device_offs(offs, ct)
    bsz, t_in, cc = ct.shape
    k, _, co = wf.shape
    y = torch.empty((bsz, t + 2 * rad, co), dtype=ct.dtype, device=ct.device)
    if sconvt1d_tensor_core(ct.dtype, cc, co, k, stride, rad):
        _sconvt1d_tc(ct, wf, offs, y, rad,
                     sconvt1d_tc_plan(bsz, co, k, stride, pad_lo_t, t, rad))
        sconvt1d.launches_tc += 1
    else:
        lib = _lib()
        err = lib.sconvt1d_launch(
            ct.data_ptr(), wf.data_ptr(), offs.data_ptr(), y.data_ptr(), bsz,
            t_in, cc, co, k, stride, pad_lo_t, t, rad, _DTYPES[ct.dtype],
            torch.cuda.current_stream(ct.device).cuda_stream)
        _raise_if(lib, err, "sconvt1d")
        sconvt1d.launches_cc += 1
    sconvt1d.launches += 1
    return y


sconvt1d.launches = sconvt1d.launches_tc = sconvt1d.launches_cc = 0
