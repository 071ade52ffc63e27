"""Config -> model construction."""

from __future__ import annotations

import torch

from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.models.wavegan import WaveGANGenerator

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_generator(cfg: Config, device=None) -> WaveGANGenerator:
    """The generator with uninitialised f32 parameters on ``device``
    (fill them with models.init.init_params or load a state dict)."""
    m, d = cfg.model, cfg.data
    if m.generator == "gru":
        raise NotImplementedError(
            "the GRU generator is not ported to audiogan_tpu_torch yet; "
            "use audiogan_tpu for cond_gru_sc09")
    if m.generator != "wavegan":
        raise ValueError(f"unknown generator {m.generator!r}")
    return WaveGANGenerator(
        clip_len=d.clip_len, latent_dim=m.latent_dim,
        model_dim=m.model_dim, kernel_size=m.kernel_size,
        strides=m.strides, num_classes=d.num_classes,
        embed_dim=m.embed_dim, max_channels=m.max_channels,
        dtype=DTYPES[cfg.train.dtype], device=device)
