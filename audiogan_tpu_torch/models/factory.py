"""Config -> model construction."""

from __future__ import annotations

import torch

from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.models.gru import GRUGenerator
from audiogan_tpu_torch.models.stft_critic import DualDiscriminator
from audiogan_tpu_torch.models.wavegan import (WaveGANDiscriminator,
                                                WaveGANGenerator)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_generator(cfg: Config,
                    device=None) -> WaveGANGenerator | GRUGenerator:
    """The generator with uninitialised f32 parameters on ``device``
    (fill them with models.init.init_params or load a state dict)."""
    cfg.validate()
    m, d = cfg.model, cfg.data
    if m.generator == "gru":
        return GRUGenerator(
            clip_len=d.clip_len, latent_dim=m.latent_dim,
            model_dim=m.model_dim, hidden=m.gru_hidden,
            frame_size=m.gru_frame_size, kernel_size=m.kernel_size,
            num_classes=d.num_classes, embed_dim=m.embed_dim,
            dtype=DTYPES[cfg.train.dtype], device=device)
    return WaveGANGenerator(
        clip_len=d.clip_len, latent_dim=m.latent_dim,
        model_dim=m.model_dim, kernel_size=m.kernel_size,
        strides=m.strides, num_classes=d.num_classes,
        embed_dim=m.embed_dim, max_channels=m.max_channels,
        dtype=DTYPES[cfg.train.dtype], device=device)


def build_discriminator(cfg: Config, device=None
                        ) -> WaveGANDiscriminator | DualDiscriminator:
    """The critic with uninitialised f32 parameters on ``device``: the
    WaveGAN critic, its first ``model.fused_shuffle_sites`` shuffle sites
    (-1: all) fused into their consuming convs, or, with
    ``model.use_stft_critic``, that critic beside an STFT critic at the
    first of ``model.stft_resolutions``."""
    cfg.validate()
    m, d = cfg.model, cfg.data
    common = dict(clip_len=d.clip_len, model_dim=m.model_dim,
                  kernel_size=m.kernel_size, strides=m.strides,
                  phase_shuffle_rad=m.phase_shuffle,
                  num_classes=d.num_classes, max_channels=m.max_channels,
                  fused_shuffle_sites=m.fused_shuffle_sites,
                  dtype=DTYPES[cfg.train.dtype], device=device)
    if m.use_stft_critic:
        return DualDiscriminator(stft_resolution=m.stft_resolutions[0],
                                 **common)
    return WaveGANDiscriminator(**common)
