"""STFT-spectrogram critic and the dual discriminator, the port of
audiogan_tpu/models/stft_critic.py.

  STFTCritic: waveform [B, T, 1] -> log1p |STFT| on the pad_tail grid
     (T / hop frames) -> n_layers x (5x5 stride-2 SAME conv2d + bias,
     LeakyReLU(0.2)), channels min(model_dim * 2^i, 512) -> flatten in
     the reference's [B, frames, bins, C] order -> dense ``head`` -> score
     [B]; projection conditioning (score += <proj_embed(y), mean
     features>) when num_classes > 0.
  DualDiscriminator: the WaveGAN critic (``wave_critic``, which takes the
     phase-shuffle shifts) plus an STFTCritic (``stft_critic``) of half
     the width (at least 16) at the first STFT resolution; scores summed.

Parameters are f32 and named and laid out as the flax ones, so
convert.params_from_jax carries them: ``stft_critic.conv2d_{i}.kernel``
[5, 5, C_in, C_out] (flax's HWIO, permuted to torch's OIHW at the call),
``.bias``, ``stft_critic.head.kernel`` [frames * bins * C, 1], ``.bias``,
``stft_critic.proj_embed.embedding``, and the wave critic's under
``wave_critic.``. The spectrogram and log1p run in f32; the convs, the
head and the projection in ``dtype``; the score comes out in f32.

The reference's 2D convs are XLA's, not a Pallas kernel, so their port is
``F.conv2d`` (cuDNN on the card). In an f32 run on the card they use TF32
while ``torch.backends.cudnn.allow_tf32`` is True (PyTorch's default);
the training step (train/step.py) runs them under cuDNN's deterministic
algorithms.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from audiogan_tpu_torch.models.wavegan import (Dense, Embed,
                                               WaveGANDiscriminator)
from audiogan_tpu_torch.ops.stft import stft_magnitude

KERNEL, STRIDE = 5, 2


def same_pads(n: int, k: int = KERNEL, s: int = STRIDE) -> tuple[int, int]:
    """flax's SAME padding of one axis of length n: (lo, hi), the extra
    element, if any, behind."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv2d_same(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                stride: int = STRIDE) -> torch.Tensor:
    """SAME conv of h [B, C_in, H, W] with w [kh, kw, C_in, C_out] (HWIO)
    and bias b -> [B, C_out, ceil(H / s), ceil(W / s)]. F.conv2d pads
    both sides alike, and its padding="same" refuses a stride, so the
    pad comes first."""
    (ht, hb), (wl, wr) = (same_pads(h.shape[2], w.shape[0], stride),
                          same_pads(h.shape[3], w.shape[1], stride))
    return F.conv2d(F.pad(h, (wl, wr, ht, hb)), w.permute(3, 2, 0, 1), b,
                    stride=stride)


class Conv(nn.Module):
    """A 2D conv's parameters: ``kernel`` [k, k, C_in, C_out], ``bias``."""

    def __init__(self, c_in: int, c_out: int, k: int = KERNEL, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(k, k, c_in, c_out,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(c_out, device=device))


class STFTCritic(nn.Module):
    def __init__(self, clip_len: int, n_fft: int = 512, hop: int = 128,
                 win_len: int = 512, model_dim: int = 32, n_layers: int = 4,
                 num_classes: int = 0, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        if clip_len % hop:
            raise ValueError(f"clip_len={clip_len} is not a multiple of the "
                             f"STFT critic's hop {hop}")
        self.n_fft, self.hop, self.win_len = n_fft, hop, win_len
        self.num_classes = num_classes
        self.dtype = dtype
        frames, bins, c_in = clip_len // hop, n_fft // 2 + 1, 1
        for i in range(n_layers):
            c_out = min(model_dim * 2 ** i, 512)
            self.add_module(f"conv2d_{i}", Conv(c_in, c_out, device=device))
            frames, bins, c_in = -(-frames // STRIDE), -(-bins // STRIDE), c_out
        self.n_layers = n_layers
        self.head = Dense(frames * bins * c_in, 1, device=device)
        if num_classes:
            self.proj_embed = Embed(num_classes, c_in, device=device)

    def forward(self, x: torch.Tensor,
                labels: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, T, 1] -> scores [B] f32."""
        mag = stft_magnitude(x[..., 0], self.n_fft, self.hop, self.win_len,
                             pad_tail=True)
        h = torch.log1p(mag)[:, None].to(self.dtype)    # [B, 1, frames, bins]
        for i in range(self.n_layers):
            conv = getattr(self, f"conv2d_{i}")
            h = F.leaky_relu(conv2d_same(h, conv.kernel.to(self.dtype),
                                         conv.bias.to(self.dtype)), 0.2)
        # the reference flattens [B, frames, bins, C]
        score = self.head(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1))[:, 0]
        if self.num_classes:
            if labels is None:
                raise ValueError("conditional D needs labels")
            pooled = h.mean(dim=(2, 3))
            emb = self.proj_embed.embedding.to(self.dtype)[labels]
            score = score + (pooled * emb).sum(dim=-1)
        return score.float()


class DualDiscriminator(nn.Module):
    def __init__(self, clip_len: int = 16384, model_dim: int = 64,
                 kernel_size: int = 25,
                 strides: Sequence[int] = (4, 4, 4, 4, 4),
                 phase_shuffle_rad: int = 2, num_classes: int = 0,
                 max_channels: int = 1024, fused_shuffle_sites: int = 0,
                 stft_resolution: tuple[int, int, int] = (512, 128, 512),
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.wave_critic = WaveGANDiscriminator(
            clip_len=clip_len, model_dim=model_dim, kernel_size=kernel_size,
            strides=strides, phase_shuffle_rad=phase_shuffle_rad,
            num_classes=num_classes, max_channels=max_channels,
            fused_shuffle_sites=fused_shuffle_sites, dtype=dtype,
            device=device)
        n_fft, hop, win = stft_resolution
        self.stft_critic = STFTCritic(
            clip_len, n_fft=n_fft, hop=hop, win_len=win,
            model_dim=max(model_dim // 2, 16), num_classes=num_classes,
            dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, labels: torch.Tensor | None = None,
                shifts: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, T, 1], shifts int [L - 1, B] for the wave critic (None:
        no shuffle) -> scores [B] f32."""
        return self.wave_critic(x, labels, shifts) + self.stft_critic(x,
                                                                      labels)
