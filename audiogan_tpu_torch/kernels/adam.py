"""Adam's step-dependent update from device scalars: the CUDA kernel and
its plain form.

train/state.py::Adam computes each update's step size and bias
correction on the host from its CPU counts. A captured CUDA graph would
freeze them into the foreach kernels' arguments, so this kernel
(``csrc/adam.cu``) reads them from a device buffer that the host writes
before each step: it runs the four ops that follow the moments' update
(square root, division by the bias correction, adding eps, addcdiv with
the step size) with torch's foreach arithmetic, to the bit (the source's
header). ``adam_update_plain`` is today's foreach ops, the kernel's oracle
and the CPU path.

``scalars`` is [2, n] f32 on the parameters' device: row 0 the step sizes
-(lr / (1 - b1^t)), row 1 sqrt(1 - b2^t), column ``cols[i]`` for tensor
i. No Pallas kernel of the reference does this (its optax.adam is XLA's,
audiogan_tpu/train/state.py:38-39); the port needs it because its step
replays as a CUDA graph.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from audiogan_tpu_torch.kernels import _build, hooks

ADAM_MAX_TENSORS = 48    # tensors per launch (csrc/adam.cu kMaxTensors)
ADAM_CHUNK = 8192        # elements per block (csrc/adam.cu kChunk)


def adam_update_plain(params: list, exp_avg: list, exp_avg_sq: list,
                      scalars: torch.Tensor, cols: list[int],
                      eps: float) -> None:
    """The four foreach ops of torch.optim.Adam's update, in place on
    ``params``. On the CPU the scalars stay tensors (the overloads that
    take them), so no step's numbers become arguments of an op; on the
    card they become the scalar lists torch's Adam passes."""
    picked = scalars[:, cols]
    den = torch._foreach_sqrt(exp_avg_sq)
    if scalars.device.type == "cpu":
        torch._foreach_div_(den, list(picked[1].unbind()))
        torch._foreach_add_(den, eps)
        torch._foreach_addcdiv_(params, exp_avg, den, picked[0])
        return
    step_size, bias2 = picked.tolist()
    torch._foreach_div_(den, bias2)
    torch._foreach_add_(den, eps)
    torch._foreach_addcdiv_(params, exp_avg, den, step_size)


class _Table(ctypes.Structure):
    """csrc/adam.cu's AdamTable."""
    _fields_ = [("p", ctypes.c_void_p * ADAM_MAX_TENSORS),
                ("exp_avg", ctypes.c_void_p * ADAM_MAX_TENSORS),
                ("exp_avg_sq", ctypes.c_void_p * ADAM_MAX_TENSORS),
                ("n", ctypes.c_longlong * ADAM_MAX_TENSORS),
                ("slot", ctypes.c_int * ADAM_MAX_TENSORS),
                ("first_block", ctypes.c_int * (ADAM_MAX_TENSORS + 1)),
                ("count", ctypes.c_int)]


@functools.cache
def _adam_lib() -> ctypes.CDLL:
    """csrc/adam.cu, built at first use, with its C signatures."""
    lib = _build.load("adam")
    lib.adam_table_bytes.restype = ctypes.c_int
    if lib.adam_table_bytes() != ctypes.sizeof(_Table):
        raise RuntimeError("csrc/adam.cu's AdamTable differs from "
                           "kernels/adam.py's")
    lib.adam_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_float,
                                ctypes.c_void_p]
    lib.adam_launch.restype = ctypes.c_int
    lib.adam_error_string.argtypes = [ctypes.c_int]
    lib.adam_error_string.restype = ctypes.c_char_p
    return lib


def _check(params, exp_avg, exp_avg_sq, scalars, cols) -> None:
    if not (len(params) == len(exp_avg) == len(exp_avg_sq) == len(cols)):
        raise ValueError("adam_update: lists of unequal length")
    if scalars.dim() != 2 or scalars.shape[0] != 2 or \
            scalars.dtype != torch.float32:
        raise ValueError(f"adam_update: scalars must be [2, n] f32, got "
                         f"{scalars.dtype} {list(scalars.shape)}")
    for p, m, v, c in zip(params, exp_avg, exp_avg_sq, cols):
        if not (p.shape == m.shape == v.shape):
            raise ValueError("adam_update: a moment's shape differs from "
                             "its parameter's")
        if not 0 <= c < scalars.shape[1]:
            raise ValueError(f"adam_update: column {c} outside the "
                             f"{scalars.shape[1]} scalars")


@hooks.kernel
def adam_update(params: list, exp_avg: list, exp_avg_sq: list,
                scalars: torch.Tensor, cols: list[int], eps: float) -> None:
    """p += step_size * exp_avg / (sqrt(exp_avg_sq) / bias2 + eps) for each
    tensor, in place, the scalars of tensor i in column cols[i] of
    ``scalars`` (the module docstring).

    CPU tensors take the plain form. CUDA tensors (contiguous f32, all on
    ``scalars``' device) launch the kernel, one launch per
    ADAM_MAX_TENSORS tensors, or raise; never a fallback."""
    _check(params, exp_avg, exp_avg_sq, scalars, cols)
    if not params:
        return
    dev = scalars.device
    if dev.type == "cpu":
        adam_update_plain(params, exp_avg, exp_avg_sq, scalars, cols, eps)
        return
    if dev.type != "cuda":
        raise ValueError(f"no Adam kernel for device {dev}")
    for t in (*params, *exp_avg, *exp_avg_sq):
        if t.device != dev or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise TypeError(f"adam_update takes contiguous f32 tensors on "
                            f"{dev}; got {t.dtype} on {t.device}")
    if not scalars.is_contiguous():
        raise ValueError("adam_update takes contiguous scalars")
    lib = _adam_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for lo in range(0, len(params), ADAM_MAX_TENSORS):
        table, blocks = _Table(), 0
        part = range(lo, min(lo + ADAM_MAX_TENSORS, len(params)))
        for k, i in enumerate(part):
            table.p[k] = params[i].data_ptr()
            table.exp_avg[k] = exp_avg[i].data_ptr()
            table.exp_avg_sq[k] = exp_avg_sq[i].data_ptr()
            table.n[k] = params[i].numel()
            table.slot[k] = cols[i]
            table.first_block[k] = blocks
            blocks += -(-params[i].numel() // ADAM_CHUNK)
        table.first_block[len(part)] = blocks
        table.count = len(part)
        if blocks == 0:
            continue
        err = lib.adam_launch(ctypes.byref(table), scalars.data_ptr(),
                              scalars.shape[1], float(eps), stream)
        if err != 0:
            raise RuntimeError("adam kernel launch failed: "
                               + lib.adam_error_string(err).decode())
        adam_update.launches += 1


adam_update.launches = 0


def adam_work(params: list) -> tuple[int, int]:
    """(flops, bytes) of one update of ``params``: per element a square
    root, two divisions, an add and an fma (6 f32 operations); p,
    exp_avg and exp_avg_sq read once, p written once."""
    n = sum(p.numel() for p in params)
    return 6 * n, 16 * n
