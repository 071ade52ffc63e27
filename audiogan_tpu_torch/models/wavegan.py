"""WaveGAN generator (Donahue et al. 2019), the port of
audiogan_tpu/models/wavegan.py::WaveGANGenerator.

  z [B, Z] (-> concat label embedding) -> dense `project` -> [B, base, c0]
  -> ReLU -> L x conv_transpose1d(k, s_i) with fused bias + ReLU, tanh on
  the last -> waveform [B, clip_len, 1], clip_len = base * prod(strides).

Parameters are f32 and named as the flax ones (``project.kernel`` [in, out],
``project.bias``, ``label_embed.embedding``, ``convt_{i}_kernel``
[K, C_in, C_out], ``convt_{i}_bias``); compute runs in ``dtype``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from audiogan_tpu_torch.ops.conv import conv_transpose1d_ba


def _gen_channels(model_dim: int, n_layers: int, max_ch: int) -> list[int]:
    """Output channels per G layer: d*2^(L-2-i) capped, final layer 1."""
    chs = [min(model_dim * 2 ** (n_layers - 2 - i), max_ch)
           for i in range(n_layers - 1)]
    return chs + [1]


def _empty(*shape: int, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device))


class Dense(nn.Module):
    def __init__(self, n_in: int, n_out: int, device=None):
        super().__init__()
        self.kernel = _empty(n_in, n_out, device=device)
        self.bias = _empty(n_out, device=device)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return h @ self.kernel.to(h.dtype) + self.bias.to(h.dtype)


class Embed(nn.Module):
    def __init__(self, num: int, dim: int, device=None):
        super().__init__()
        self.embedding = _empty(num, dim, device=device)


class WaveGANGenerator(nn.Module):
    def __init__(self, clip_len: int = 16384, latent_dim: int = 100,
                 model_dim: int = 64, kernel_size: int = 25,
                 strides: Sequence[int] = (4, 4, 4, 4, 4),
                 num_classes: int = 0, embed_dim: int = 64,
                 max_channels: int = 1024,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.strides = tuple(strides)
        self.num_classes = num_classes
        self.dtype = dtype
        n_layers = len(self.strides)
        total_stride = math.prod(self.strides)
        self.base_len = clip_len // total_stride
        if self.base_len * total_stride != clip_len:
            raise ValueError(f"clip_len={clip_len} not divisible by the "
                             f"total stride {total_stride}")
        self.c0 = min(model_dim * 2 ** (n_layers - 1), max_channels)
        n_in = latent_dim
        if num_classes:
            self.label_embed = Embed(num_classes, embed_dim, device=device)
            n_in += embed_dim
        self.project = Dense(n_in, self.base_len * self.c0, device=device)
        c_in = self.c0
        for i, c_out in enumerate(_gen_channels(model_dim, n_layers,
                                                max_channels)):
            self.register_parameter(
                f"convt_{i}_kernel",
                _empty(kernel_size, c_in, c_out, device=device))
            self.register_parameter(f"convt_{i}_bias",
                                    _empty(c_out, device=device))
            c_in = c_out

    def forward(self, z: torch.Tensor,
                labels: torch.Tensor | None = None) -> torch.Tensor:
        """z [B, latent_dim], labels int [B] (if num_classes) -> [B, T, 1] f32."""
        h = z.to(self.dtype)
        if self.num_classes:
            if labels is None:
                raise ValueError("conditional G needs labels")
            emb = self.label_embed.embedding.to(self.dtype)[labels]
            h = torch.cat([h, emb], dim=-1)
        h = torch.relu(self.project(h).reshape(h.shape[0], self.base_len,
                                               self.c0))
        n_layers = len(self.strides)
        for i, s in enumerate(self.strides):
            w = getattr(self, f"convt_{i}_kernel").to(self.dtype)
            b = getattr(self, f"convt_{i}_bias").to(self.dtype)
            h = conv_transpose1d_ba(
                h, w.contiguous(), b, stride=s,
                act="relu" if i < n_layers - 1 else "tanh")
        return h.float()
