"""Polyphase resampling by a rational factor, the port of
audiogan_tpu/ops/resample.py.

Rate conversion by up/down is a stride-``down`` correlation whose ``up``
output channels are the polyphase decomposition of a Kaiser-windowed sinc
lowpass:

    y[p + q*up] = sum_r x[q*down + r] * h[r*up - p*down + half_len]

so each output reads only the input samples under its filter support.
The filter is the reference's design (scipy.signal.resample_poly's
default: Kaiser beta 5.0, half-length taps_per_phase * max(up, down)),
computed in numpy float64 on the host.

The reference computes this outside any Pallas kernel on purpose (one
input channel), so the port's lowering is plain PyTorch: the padded
input's frames (``Tensor.unfold``, a strided view) times the tap matrix
[R, up], in float64. float64 keeps the product out of TF32's reach on
the card (cuDNN's convolutions and, if enabled, cuBLAS round f32 inputs
to TF32), so the card and the CPU agree to f32 rounding; the result is
cast back to x's dtype.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from audiogan_tpu_torch.config import _ratio


@functools.lru_cache(maxsize=None)
def design_polyphase_filter(up: int, down: int, taps_per_phase: int = 10,
                            beta: float = 5.0) -> np.ndarray:
    """Kaiser-windowed sinc lowpass for up/down conversion, float64.

    Cutoff 1 / max(up, down) of the upsampled Nyquist; DC gain normalized
    to exactly ``up``, so a constant signal maps to the same constant.
    """
    max_rate = max(up, down)
    half_len = taps_per_phase * max_rate
    n = np.arange(-half_len, half_len + 1, dtype=np.float64)
    fc = 1.0 / (2.0 * max_rate)  # cycles/sample at the upsampled rate
    h = 2.0 * fc * np.sinc(2.0 * fc * n)
    h *= np.kaiser(2 * half_len + 1, beta)
    h *= up / h.sum()
    return h.astype(np.float64)


def resample_output_len(in_len: int, up: int, down: int) -> int:
    return -(-in_len * up // down)  # ceil, as scipy.signal.resample_poly


@functools.lru_cache(maxsize=None)
def polyphase_taps(up: int, down: int, taps_per_phase: int = 10,
                   beta: float = 5.0) -> tuple[np.ndarray, int]:
    """(G [R, up], r_min): G[r - r_min, p] = h[r*up - p*down + half_len],
    zero where the index leaves the filter; r spans the union of the
    phases' supports, so every phase reads one window of R samples."""
    h = design_polyphase_filter(up, down, taps_per_phase, beta)
    half_len = (len(h) - 1) // 2
    r_min = -(half_len // up)
    r_max = ((up - 1) * down + half_len) // up
    r = np.arange(r_min, r_max + 1)[:, None]
    p = np.arange(up)[None, :]
    j = r * up - p * down + half_len
    valid = (j >= 0) & (j < len(h))
    g = np.where(valid, h[np.clip(j, 0, len(h) - 1)], 0.0)
    g.flags.writeable = False
    return g, r_min


@functools.lru_cache(maxsize=None)
def _taps_on(up: int, down: int, taps_per_phase: int, beta: float,
             device: torch.device) -> torch.Tensor:
    """polyphase_taps' G as a float64 tensor on ``device``, copied once,
    outside inference mode (as ops/stft.py::_basis_on)."""
    g, _ = polyphase_taps(up, down, taps_per_phase, beta)
    with torch.inference_mode(False):
        return torch.from_numpy(np.array(g)).to(device)


def resample_poly(x: torch.Tensor, target_rate: int, source_rate: int,
                  taps_per_phase: int = 10, beta: float = 5.0
                  ) -> torch.Tensor:
    """Resample [B, T] clips from source_rate to target_rate on x's device.

    Identity rates return x unchanged. Output length ceil(T * up / down),
    phase-aligned with scipy.signal.resample_poly (output[0] is the
    filter centred on x[0]).
    """
    up, down = _ratio(target_rate, source_rate)
    if up == 1 and down == 1:
        return x
    b, t = x.shape
    g, r_min = polyphase_taps(up, down, taps_per_phase, beta)
    n_taps = g.shape[0]
    out_len = resample_output_len(t, up, down)
    q_out = -(-out_len // up)                 # phase rows to produce
    pad_lo = -r_min
    pad_hi = max((q_out - 1) * down + n_taps - pad_lo - t, 0)
    xp = F.pad(x.double(), (pad_lo, pad_hi))
    frames = xp.unfold(-1, n_taps, down)[:, :q_out]       # [B, q_out, R]
    y = frames @ _taps_on(up, down, taps_per_phase, beta, x.device)
    return y.reshape(b, q_out * up)[:, :out_len].to(x.dtype)
