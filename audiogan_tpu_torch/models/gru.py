"""GRU (SampleRNN-style frame-level RNN) generator, the port of
audiogan_tpu/models/gru.py.

The recurrence runs at frame rate: n_frames = clip_len / frame_size steps
(16384 / 64 = 256), each emitting a frame feature vector; the GRU input
at step t is a projection of the features emitted at t-1 concatenated
with a projection of the static (z, label) conditioning. Three
conv-transpose layers (strides ``factorize_stride(frame_size)``, ReLU,
ReLU, tanh) then upsample the frames to samples. The scan is
kernels/gru.py::gru_scan (K4, and K5 for its gradient), the upsampling the
conv Functions of kernels/autograd.py (K1).

Parameters are f32 and named as the flax ones: ``label_embed.embedding``,
``init_state.kernel``/``.bias``, ``cond_proj.kernel``/``.bias``,
``gru_w_i`` [2F, 3H], ``gru_w_h`` [H, 3H], ``gru_b_i``, ``gru_b_h``,
``ar_proj`` [F, F], ``frame_out`` [H, F], ``frame_out_bias``,
``up_{i}_kernel`` [K, C_in, C_out], ``up_{i}_bias``; compute runs in
``dtype``.
"""

from __future__ import annotations

import torch
from torch import nn

from audiogan_tpu_torch.kernels.autograd import as_compute
from audiogan_tpu_torch.kernels.gru import gru_scan
from audiogan_tpu_torch.models.wavegan import Dense, Embed, _empty
from audiogan_tpu_torch.ops.conv import conv_transpose1d_ba


def factorize_stride(n: int) -> tuple[int, ...]:
    """Factor an upsample ratio into a stride tuple (prefer 4s, then small)."""
    out = []
    for f in (4, 3, 2, 5, 7):
        while n % f == 0:
            out.append(f)
            n //= f
    if n != 1:
        out.append(n)
    return tuple(out)


class GRUGenerator(nn.Module):
    # models/init.py: the flax initializers that are not glorot-uniform
    # (gru_w_h is orthogonal, the GRU biases are zeros)
    INITS = {"gru_w_h": "orthogonal", "gru_b_i": "zeros", "gru_b_h": "zeros"}

    def __init__(self, clip_len: int = 16384, latent_dim: int = 100,
                 model_dim: int = 64, hidden: int = 512,
                 frame_size: int = 64, kernel_size: int = 25,
                 num_classes: int = 0, embed_dim: int = 64,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if clip_len % frame_size:
            raise ValueError(f"clip_len={clip_len} not divisible by "
                             f"frame_size={frame_size}")
        self.n_frames = clip_len // frame_size
        self.num_classes = num_classes
        self.dtype = dtype
        self.strides = factorize_stride(frame_size)
        feat = min(4 * model_dim, 512)
        n_in = latent_dim
        if num_classes:
            self.label_embed = Embed(num_classes, embed_dim, device=device)
            n_in += embed_dim
        self.init_state = Dense(n_in, hidden, device=device)
        self.cond_proj = Dense(n_in, feat, device=device)
        for name, shape in (("gru_w_i", (2 * feat, 3 * hidden)),
                            ("gru_w_h", (hidden, 3 * hidden)),
                            ("gru_b_i", (3 * hidden,)),
                            ("gru_b_h", (3 * hidden,)),
                            ("ar_proj", (feat, feat)),
                            ("frame_out", (hidden, feat)),
                            ("frame_out_bias", (feat,))):
            self.register_parameter(name, _empty(*shape, device=device))
        chs = [max(feat // 2 ** (i + 1), model_dim)
               for i in range(len(self.strides) - 1)] + [1]
        c_in = feat
        for i, c_out in enumerate(chs):
            self.register_parameter(
                f"up_{i}_kernel",
                _empty(kernel_size, c_in, c_out, device=device))
            self.register_parameter(f"up_{i}_bias",
                                    _empty(c_out, device=device))
            c_in = c_out

    def forward(self, z: torch.Tensor,
                labels: torch.Tensor | None = None) -> torch.Tensor:
        """z [B, latent_dim], labels int [B] (if num_classes) -> [B, T, 1] f32."""
        cond = z.to(self.dtype)
        if self.num_classes:
            if labels is None:
                raise ValueError("conditional GRU G needs labels")
            emb = self.label_embed.embedding.to(self.dtype)[labels]
            cond = torch.cat([cond, emb], dim=-1)
        h0 = torch.tanh(self.init_state(cond))
        cond_proj = self.cond_proj(cond)
        weights = [as_compute(getattr(self, n), self.dtype) for n in (
            "gru_w_i", "gru_w_h", "gru_b_i", "gru_b_h", "ar_proj",
            "frame_out", "frame_out_bias")]
        h = gru_scan(h0, cond_proj, *weights, self.n_frames)
        n_layers = len(self.strides)
        for i, s in enumerate(self.strides):
            w = as_compute(getattr(self, f"up_{i}_kernel"), self.dtype)
            b = as_compute(getattr(self, f"up_{i}_bias"), self.dtype)
            h = conv_transpose1d_ba(
                h, w, b, stride=s,
                act="relu" if i < n_layers - 1 else "tanh")
        return h.float()
