"""conv1d / conv_transpose1d as ``torch.autograd.Function``s of any order.

Port of audiogan_tpu/kernels/primitives.py. The WGAN-GP loss
differentiates grad_x D(x) with respect to the critic's parameters
(reverse over reverse), so every backward here is built from the same
Functions and is itself differentiable (no ``once_differentiable``):

    dx(conv1d)       = convT of _flip(w), pad_lo' = K-1-pad_lo, out_len = T
    dx(convT)        = conv1d of _flip(w), lo = K-1-pad_lo,
                       hi = max((T-1)*s + K - lo - out_len, 0)
    dw(conv1d)       = Conv1dWgrad(x, ct)   (torch ops, f32 accumulation)
    dw(convT)        = ConvTWgrad(x, ct)
    d(Conv1dWgrad)   = convT / conv1d again (primitives.py:257-290)

The shuffled-input family of the fused phase-shuffle sites (kernels/
sconv.py; primitives.py:603-690) is closed under transposition the same
way, with z = window_select(xp, offs):

    dxp(sconv1d)     = sconvT of _flip(w), pad_lo' = K-1-pad_lo, t
    dct(sconvT)      = sconv1d of _flip(w), pads as dx(convT)
    dw(sconv1d)      = Conv1dWgrad(z, ct)
    dw(sconvT)       = ConvTWgrad(ct, window_select(g, offs))

The forward passes run the kernel wrappers of kernels/conv.py, so a CUDA
tensor runs the hand-written kernels in every order of differentiation and
a CPU tensor their plain forms. The weight gradients have no Pallas kernel
in the reference (kernels/conv.py:669-676) and use torch's convolution
weight gradient here, with cuDNN's deterministic algorithms: the default
ones sum in a run-dependent order, and the step, like the reference's, is
a function of (seed, step) to the bit.

The fused bias + activation Functions recover the activation's derivative
from their OUTPUT (``_act_out_grad``, primitives.py:422-434): relu' =
(y > 0), leaky_relu'(0) = 1, tanh' = 1 - y^2; db sums over (batch, time).

A backward computes a gradient only for an input the autograd engine will
visit (``needs``): the penalty's inner grad with respect to x-hat skips the
critic's weight gradients.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from audiogan_tpu_torch.kernels import conv as kconv
from audiogan_tpu_torch.kernels import sconv as ksconv
from audiogan_tpu_torch.ops.sconv import window_select


def _flip(w: torch.Tensor) -> torch.Tensor:
    """w[::-1].swapaxes(1, 2): [K, Cin, Cout] -> [K, Cout, Cin]."""
    return w.flip(0).transpose(1, 2).contiguous()


def needs(ctx, i: int) -> bool:
    """True iff input i wants a gradient in this backward pass. A leaf
    input (an AccumulateGrad node) cannot be asked about inside
    autograd.grad and always gets its gradient; the models pass their
    parameters and inputs through a cast or a view (``as_compute``), so
    every input they hand a Function can be asked about."""
    if not ctx.needs_input_grad[i]:
        return False
    node = ctx.next_functions[i][0]
    if node is None or isinstance(node, torch._C._functions.AccumulateGrad):
        return True
    return torch._C._will_engine_execute_node(node)


def as_compute(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t in the compute dtype, never a leaf of the autograd graph (a view
    where the dtype already matches), so ``needs`` can skip its grad."""
    return t.to(dtype) if t.dtype != dtype else t.view_as(t)


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside the block; the caller's
    setting is restored after it."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def _zeros_bias(w: torch.Tensor) -> torch.Tensor:
    return torch.zeros(w.shape[2], dtype=w.dtype, device=w.device)


def _convt_dx_pads(k: int, s: int, pad_lo: int, t_in: int,
                   out_len: int) -> tuple[int, int]:
    lo = k - 1 - pad_lo
    hi = (t_in - 1) * s + k - lo - out_len
    return lo, max(hi, 0)


def _pad_time(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Zero-pads [B, T, C] by lo in front and hi behind; a negative hi
    drops rows from the end."""
    if hi < 0:
        x = x[:, :x.shape[1] + hi]
        hi = 0
    return F.pad(x, (0, 0, lo, hi))


def conv1d_wgrad(x: torch.Tensor, ct: torch.Tensor, stride: int,
                 pad_lo: int, k: int) -> torch.Tensor:
    """dW[j, c, o] = sum_{b,t} x_pad[b, t*s + j, c] * ct[b, t, o] ->
    [K, Cin, Cout] in x.dtype; torch's convolution weight gradient, whose
    bf16 products accumulate in f32, in cuDNN's deterministic algorithms
    (the caller's setting is restored)."""
    t_out = ct.shape[1]
    hi = (t_out - 1) * stride + k - x.shape[1] - pad_lo
    xp = _pad_time(x, pad_lo, hi).transpose(1, 2)
    with cudnn_deterministic():
        dw = torch.nn.grad.conv1d_weight(
            xp, (ct.shape[2], x.shape[2], k), ct.transpose(1, 2).to(x.dtype),
            stride=stride)
    return dw.permute(2, 1, 0).contiguous()


def convt1d_wgrad(x: torch.Tensor, ct: torch.Tensor, stride: int,
                  pad_lo: int, k: int) -> torch.Tensor:
    """dW[j, c, o] = sum_{b,t} x[b, t, c] * ct[b, t*s + pad_lo - j, o]:
    the conv1d weight gradient of ct against x over the reversed taps."""
    return _flip(conv1d_wgrad(ct.to(x.dtype), x, stride, k - 1 - pad_lo, k))


class Conv1d(torch.autograd.Function):
    """conv1d(x, w) with explicit pads (primitives.py conv1d_p)."""

    @staticmethod
    def forward(ctx, x, w, stride, pad_lo, pad_hi):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        ctx.geom = (stride, pad_lo, pad_hi)
        return kconv.conv1d_ba(x, w, _zeros_bias(w), stride, pad_lo, pad_hi)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, pad_lo, pad_hi = ctx.geom
        k = w.shape[0]
        dx = dw = None
        if needs(ctx, 0):
            dx = ConvT.apply(g, _flip(w), stride, k - 1 - pad_lo, x.shape[1])
        if needs(ctx, 1):
            dw = Conv1dWgrad.apply(x, g, stride, pad_lo, pad_hi, k)
        return dx, dw, None, None, None


class ConvT(torch.autograd.Function):
    """conv_transpose1d(x, w) (primitives.py convt1d_p)."""

    @staticmethod
    def forward(ctx, x, w, stride, pad_lo, out_len):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        ctx.geom = (stride, pad_lo, out_len)
        return kconv.conv_transpose1d_ba(x, w, _zeros_bias(w), stride,
                                         pad_lo, out_len)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, pad_lo, out_len = ctx.geom
        k = w.shape[0]
        dx = dw = None
        if needs(ctx, 0):
            lo, hi = _convt_dx_pads(k, stride, pad_lo, x.shape[1], out_len)
            dx = Conv1d.apply(g, _flip(w), stride, lo, hi)
        if needs(ctx, 1):
            dw = ConvTWgrad.apply(x, g, stride, pad_lo, out_len, k)
        return dx, dw, None, None, None


class Conv1dWgrad(torch.autograd.Function):
    """dW of conv1d, bilinear in (x, ct); its backward re-enters conv1d
    and convT (primitives.py:257-290)."""

    @staticmethod
    def forward(ctx, x, ct, stride, pad_lo, pad_hi, k):
        ctx.save_for_backward(x, ct)
        ctx.geom = (stride, pad_lo, pad_hi, k)
        return conv1d_wgrad(x, ct, stride, pad_lo, k)

    @staticmethod
    def backward(ctx, gg):
        x, ct = ctx.saved_tensors
        stride, pad_lo, pad_hi, k = ctx.geom
        dx = dct = None
        if needs(ctx, 0):
            dx = ConvT.apply(ct, _flip(gg.to(ct.dtype)), stride,
                             k - 1 - pad_lo, x.shape[1])
        if needs(ctx, 1):
            dct = Conv1d.apply(x, gg.to(x.dtype), stride,
                               pad_lo, pad_hi)
        return dx, dct, None, None, None, None


class ConvTWgrad(torch.autograd.Function):
    """dW of conv_transpose1d, bilinear in (x, ct)."""

    @staticmethod
    def forward(ctx, x, ct, stride, pad_lo, out_len, k):
        ctx.save_for_backward(x, ct)
        ctx.geom = (stride, pad_lo, out_len, k)
        return convt1d_wgrad(x, ct, stride, pad_lo, k)

    @staticmethod
    def backward(ctx, gg):
        x, ct = ctx.saved_tensors
        stride, pad_lo, out_len, k = ctx.geom
        dx = dct = None
        if needs(ctx, 0):
            lo, hi = _convt_dx_pads(k, stride, pad_lo, x.shape[1], out_len)
            dx = Conv1d.apply(ct, _flip(gg.to(ct.dtype)), stride, lo, hi)
        if needs(ctx, 1):
            dct = ConvT.apply(x, gg.to(x.dtype), stride,
                              pad_lo, out_len)
        return dx, dct, None, None, None, None


def _act_out_grad(y: torch.Tensor, act: str, slope: float):
    """d act / d pre as a function of the OUTPUT y; None for act none."""
    if act == "relu":
        return (y > 0).to(y.dtype)
    if act == "leaky_relu":
        return torch.where(y >= 0, 1.0, slope).to(y.dtype)
    if act == "tanh":
        return 1.0 - y * y
    if act != "none":
        raise ValueError(f"act={act!r}")
    return None


def _ba_backward(ctx, gy, dx_fn, dw_fn):
    """Shared backward of the fused bias + activation Functions: the
    pre-activation cotangent, then the linear conv's transposes."""
    x, w, b, y = ctx.saved_tensors[:4]
    gd = _act_out_grad(y, ctx.act, ctx.slope)
    gpre = gy if gd is None else gy * gd
    dx = dw = db = None
    if needs(ctx, 0):
        dx = dx_fn(gpre, w, x)
    if needs(ctx, 1):
        dw = dw_fn(x, gpre)
    if needs(ctx, 2):
        # summed in f32 at least (bf16 compute), as the kernels accumulate
        acc = torch.promote_types(gpre.dtype, torch.float32)
        db = gpre.to(acc).sum(dim=(0, 1)).to(b.dtype)
    return dx, dw, db


class BiasAct(torch.autograd.Function):
    """act(x + b) in torch ops, with the fused Functions' backward: the
    activation's derivative from the OUTPUT (``_act_out_grad``), so the
    backward is linear in its incoming gradient alone. torch's own
    activations pass a zero gradient back to their input in the double
    backward, which would run the whole forward graph below them (its
    convs and collectives) on zeros. The bias of the tp critic's row
    layers, added after the sum over tp (parallel/tp_models.py)."""

    @staticmethod
    def forward(ctx, x, b, act, slope):
        y = kconv._apply_act(x + b, act, slope)
        ctx.save_for_backward(y)
        ctx.act, ctx.slope = act, slope
        return y

    @staticmethod
    def backward(ctx, gy):
        (y,) = ctx.saved_tensors
        gd = _act_out_grad(y, ctx.act, ctx.slope)
        gpre = gy if gd is None else gy * gd
        db = None
        if ctx.needs_input_grad[1]:
            acc = torch.promote_types(gpre.dtype, torch.float32)
            db = gpre.to(acc).sum(dim=tuple(range(gpre.dim() - 1)))
        return gpre, db, None, None


class Conv1dBA(torch.autograd.Function):
    """act(conv1d(x, w) + b), one fused kernel forward
    (primitives.py conv1d_ba_p)."""

    @staticmethod
    def forward(ctx, x, w, b, stride, pad_lo, pad_hi, act, slope):
        x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
        y = kconv.conv1d_ba(x, w, b, stride, pad_lo, pad_hi, act, slope)
        ctx.save_for_backward(x, w, b, y)
        ctx.geom = (stride, pad_lo, pad_hi)
        ctx.act, ctx.slope = act, slope
        return y

    @staticmethod
    def backward(ctx, gy):
        stride, pad_lo, pad_hi = ctx.geom
        k = ctx.saved_tensors[1].shape[0]
        dx, dw, db = _ba_backward(
            ctx, gy,
            lambda g, w, x: ConvT.apply(g, _flip(w), stride, k - 1 - pad_lo,
                                        x.shape[1]),
            lambda x, g: Conv1dWgrad.apply(x, g, stride, pad_lo, pad_hi, k))
        return dx, dw, db, None, None, None, None, None


class ConvTBA(torch.autograd.Function):
    """act(conv_transpose1d(x, w) + b), one fused kernel forward
    (primitives.py convt1d_ba_p)."""

    @staticmethod
    def forward(ctx, x, w, b, stride, pad_lo, out_len, act, slope):
        x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
        y = kconv.conv_transpose1d_ba(x, w, b, stride, pad_lo, out_len, act,
                                      slope)
        ctx.save_for_backward(x, w, b, y)
        ctx.geom = (stride, pad_lo, out_len)
        ctx.act, ctx.slope = act, slope
        return y

    @staticmethod
    def backward(ctx, gy):
        stride, pad_lo, out_len = ctx.geom
        k = ctx.saved_tensors[1].shape[0]

        def dx_fn(g, w, x):
            lo, hi = _convt_dx_pads(k, stride, pad_lo, x.shape[1], out_len)
            return Conv1d.apply(g, _flip(w), stride, lo, hi)

        dx, dw, db = _ba_backward(
            ctx, gy, dx_fn,
            lambda x, g: ConvTWgrad.apply(x, g, stride, pad_lo, out_len, k))
        return dx, dw, db, None, None, None, None, None


class SConv1d(torch.autograd.Function):
    """conv1d(window_select(xp, offs), w) (primitives.py sconv1d_p)."""

    @staticmethod
    def forward(ctx, xp, w, offs, stride, pad_lo, pad_hi, rad):
        xp, w = xp.contiguous(), w.contiguous()
        ctx.save_for_backward(xp, w, offs)
        ctx.geom = (stride, pad_lo, pad_hi, rad)
        return ksconv.sconv1d_ba(xp, w, _zeros_bias(w), offs, stride, pad_lo,
                                 pad_hi, rad)

    @staticmethod
    def backward(ctx, g):
        xp, w, offs = ctx.saved_tensors
        stride, pad_lo, pad_hi, rad = ctx.geom
        k, t = w.shape[0], xp.shape[1] - 2 * rad
        dxp = dw = None
        if needs(ctx, 0):
            dxp = SConvT.apply(g, _flip(w), offs, stride, k - 1 - pad_lo, t,
                               rad)
        if needs(ctx, 1):
            dw = Conv1dWgrad.apply(window_select(xp, offs, t, rad), g,
                                   stride, pad_lo, pad_hi, k)
        return dxp, dw, None, None, None, None, None


class SConvT(torch.autograd.Function):
    """window_place(convT(ct, wf), offs), the transpose of SConv1d
    (primitives.py sconvt1d_p)."""

    @staticmethod
    def forward(ctx, ct, wf, offs, stride, pad_lo_t, t, rad):
        ct, wf = ct.contiguous(), wf.contiguous()
        ctx.save_for_backward(ct, wf, offs)
        ctx.geom = (stride, pad_lo_t, t, rad)
        return ksconv.sconvt1d(ct, wf, offs, stride, pad_lo_t, t, rad)

    @staticmethod
    def backward(ctx, g):
        ct, wf, offs = ctx.saved_tensors
        stride, pad_lo_t, t, rad = ctx.geom
        k = wf.shape[0]
        dct = dwf = None
        if needs(ctx, 0):
            lo, hi = _convt_dx_pads(k, stride, pad_lo_t, ct.shape[1], t)
            dct = SConv1d.apply(g, _flip(wf), offs, stride, lo, hi, rad)
        if needs(ctx, 1):
            dwf = ConvTWgrad.apply(ct, window_select(g, offs, t, rad),
                                   stride, pad_lo_t, t, k)
        return dct, dwf, None, None, None, None, None


class SConv1dBA(torch.autograd.Function):
    """act(conv1d(window_select(xp, offs), w) + b), one fused kernel
    forward (primitives.py sconv1d_ba_p)."""

    @staticmethod
    def forward(ctx, xp, w, b, offs, stride, pad_lo, pad_hi, rad, act,
                slope):
        xp, w, b = xp.contiguous(), w.contiguous(), b.contiguous()
        y = ksconv.sconv1d_ba(xp, w, b, offs, stride, pad_lo, pad_hi, rad,
                              act, slope)
        ctx.save_for_backward(xp, w, b, y, offs)
        ctx.geom = (stride, pad_lo, pad_hi, rad)
        ctx.act, ctx.slope = act, slope
        return y

    @staticmethod
    def backward(ctx, gy):
        stride, pad_lo, pad_hi, rad = ctx.geom
        xp, w = ctx.saved_tensors[:2]
        offs = ctx.saved_tensors[4]
        k, t = w.shape[0], xp.shape[1] - 2 * rad
        dx, dw, db = _ba_backward(
            ctx, gy,
            lambda g, w, x: SConvT.apply(g, _flip(w), offs, stride,
                                         k - 1 - pad_lo, t, rad),
            lambda x, g: Conv1dWgrad.apply(window_select(x, offs, t, rad),
                                           g, stride, pad_lo, pad_hi, k))
        return dx, dw, db, None, None, None, None, None, None, None
