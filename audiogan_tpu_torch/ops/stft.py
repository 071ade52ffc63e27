"""Framed STFT magnitude, the port of audiogan_tpu/ops/stft.py.

Center=False framing (the tail that fills no frame is dropped), a periodic
Hann window folded into a real DFT basis truncated to win_len rows, and
two f32 matmuls (real and imaginary parts) against it: the reference's
DFT is a plain matmul, not a Pallas kernel, so its port is
``torch.matmul``. On the card those matmuls run in full f32 as long as
``torch.backends.cuda.matmul.allow_tf32`` stays False (PyTorch's
default).

Framing uses ``Tensor.unfold`` (a strided view). Its backward sums, for
each sample, the frames that hold it, one thread per sample and with no
atomics, so the WGAN-GP penalty, which differentiates through the
framing, stays bit-reproducible on the card; the reference's gather
(``x[..., idx]``) would backpropagate through an accumulating
``index_put_``, which adds with atomics on CUDA.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _dft_basis(n_fft: int, win_len: int) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag rfft basis, rows truncated to win_len: [win_len, bins]."""
    n = np.arange(win_len)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return (np.cos(ang).astype(np.float32),
            (-np.sin(ang)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _hann(win_len: int) -> np.ndarray:
    """Periodic Hann, as torch.hann_window(win_len, periodic=True)."""
    n = np.arange(win_len)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_len)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _windowed_basis(n_fft: int, win_len: int) -> tuple[np.ndarray, np.ndarray]:
    """The DFT basis with the Hann window folded in, rounded to f32 as the
    reference rounds it: frames @ (h * C) in place of (frames * h) @ C."""
    cos_b, sin_b = _dft_basis(n_fft, win_len)
    h = _hann(win_len)[:, None]
    return (cos_b * h).astype(np.float32), (sin_b * h).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _basis_on(n_fft: int, win_len: int, device: torch.device
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """_windowed_basis as f32 tensors on ``device``, copied there once.
    Made outside inference mode whoever asks first (``evaluate`` and
    ``sample`` run under it): an inference tensor cannot be saved for
    backward, so a basis cached there would fail every later loss."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(b).to(device)
                     for b in _windowed_basis(n_fft, win_len))


def frame_signal(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """[..., T] -> [..., n_frames, frame_len]; frames start at multiples of
    hop, the tail that fills no frame is dropped."""
    t = x.shape[-1]
    if (t - frame_len) // hop + 1 <= 0:
        raise ValueError(f"signal too short: T={t} < frame_len={frame_len}")
    return x.unfold(-1, frame_len, hop)


def stft_magnitude(x: torch.Tensor, n_fft: int, hop: int,
                   win_len: int | None = None, eps: float = 1e-7,
                   pad_tail: bool = False) -> torch.Tensor:
    """|STFT| of [..., T] -> [..., n_frames, n_fft // 2 + 1], f32.

    eps floors the magnitude so that sqrt's gradient is finite at 0 (the
    op sits on the penalty's double-backprop path). pad_tail=True appends
    win_len - hop zeros so that a frame starts at every hop: n_frames =
    T / hop (T must be a multiple of hop), the STFT critic's grid.
    """
    if win_len is None:
        win_len = n_fft
    if pad_tail:
        if x.shape[-1] % hop:
            raise ValueError("pad_tail needs T divisible by hop")
        x = F.pad(x, (0, win_len - hop))
    frames = frame_signal(x, win_len, hop).float()
    cos_b, sin_b = _basis_on(n_fft, win_len, frames.device)
    re = frames @ cos_b
    im = frames @ sin_b
    return torch.sqrt(re.square() + im.square() + eps)
