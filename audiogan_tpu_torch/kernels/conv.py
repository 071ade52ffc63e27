"""Fused act(conv_transpose1d(x, w) + b): the CUDA kernel and its plain form.

Port of audiogan_tpu/kernels/conv.py's conv-transpose path. The kernel
(``csrc/convt1d.cu``) replaces ``_convt_pallas`` / ``_rowconv_kernel``;
``conv_transpose1d_ba_plain`` is the polyphase form of
``_convt_polyphase_xla`` and is the kernel's oracle.

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

from audiogan_tpu_torch.kernels import _build

ACTS = {"none": 0, "relu": 1, "leaky_relu": 2, "tanh": 3}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def conv_transpose1d_ba_plain(x: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor, stride: int, pad_lo: int,
                              out_len: int, act: str = "none",
                              slope: float = 0.2) -> torch.Tensor:
    """Plain PyTorch form: the phase-tap gather, one stride-1 conv over the
    output phases, then the epilogue, all in f32; the result is cast to
    x.dtype as the kernel's is."""
    bsz, t_in, cin = x.shape
    cout = w.shape[2]
    s = stride
    m_out = -(-out_len // s)
    v, q_min, q_taps = _convt_phase_taps(w.float(), s, pad_lo)
    # [Q, s, ci, co] -> conv1d weight [s*co, ci, Q] (cross-correlation)
    v = v.permute(1, 3, 2, 0).reshape(s * cout, cin, q_taps)
    xc = F.pad(x.float().transpose(1, 2),
               (-q_min, m_out + q_min + q_taps - 1 - t_in))
    y = F.conv1d(xc, v)                                 # [B, s*co, m_out]
    y = y.transpose(1, 2).reshape(bsz, m_out * s, cout)[:, :out_len]
    return _apply_act(y + b.float(), act, slope).to(x.dtype)


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    """csrc/convt1d.cu, built at first use, with its C signatures."""
    lib = _build.load("convt1d")
    lib.convt1d_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.convt1d_launch.restype = ctypes.c_int
    lib.convt1d_error_string.argtypes = [ctypes.c_int]
    lib.convt1d_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, w, b, y, stride, pad_lo, out_len, act, slope) -> None:
    lib = _kernel_lib()
    bsz, t_in, cin = x.shape
    k, _, cout = w.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.convt1d_launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, t_in,
        cin, cout, k, stride, pad_lo, out_len, ACTS[act], slope,
        _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError("convt1d kernel launch failed: "
                           + lib.convt1d_error_string(err).decode())


def conv_transpose1d_ba(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        stride: int, pad_lo: int | None = None,
                        out_len: int | None = None, act: str = "none",
                        slope: float = 0.2) -> torch.Tensor:
    """Fused act(conv_transpose1d(x, w) + b) -> [B, out_len, Cout].

    A CPU tensor takes the plain form. A CUDA tensor launches the
    convt1d kernel (f32 or bf16 in, f32 accumulate, x.dtype out) or
    raises; it never falls back. Defaults as in the JAX function:
    pad_lo = (K-1)//2, out_len = T*stride.
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
    if x.device.type != "cuda":
        raise ValueError(f"no convt1d kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"convt1d takes float32 or bfloat16, got {x.dtype}")
    for name, t in (("w", w), ("b", b)):
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; x is "
                            f"{x.dtype} on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("convt1d takes contiguous x, w and b")
    y = torch.empty((x.shape[0], out_len, w.shape[2]), dtype=x.dtype,
                    device=x.device)
    _launch(x, w, b, y, stride, pad_lo, out_len, act, slope)
    conv_transpose1d_ba.launches += 1
    return y


conv_transpose1d_ba.launches = 0
