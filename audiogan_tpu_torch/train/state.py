"""TrainState: what a training step mutates, the port of
audiogan_tpu/train/state.py.

The generator and the critic hold f32 parameters (compute runs in
cfg.train.dtype inside the models); each has a ``torch.optim.Adam`` with
the WGAN-GP settings (lr 1e-4, betas (0.5, 0.9), eps 1e-8 outside the
square root, bias-corrected: the formula of optax.adam). The step updates
the modules and optimizers in place and advances ``step``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.device import resolve_device
from audiogan_tpu_torch.models import build_discriminator, build_generator
from audiogan_tpu_torch.models.gru import GRUGenerator
from audiogan_tpu_torch.models.init import init_params
from audiogan_tpu_torch.models.stft_critic import DualDiscriminator
from audiogan_tpu_torch.models.wavegan import (WaveGANDiscriminator,
                                               WaveGANGenerator)
from audiogan_tpu_torch.utils.prng import role_seed

ADAM_EPS = 1e-8


@dataclass
class TrainState:
    step: int
    g: WaveGANGenerator | GRUGenerator
    d: WaveGANDiscriminator | DualDiscriminator
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    seed: int


def make_optimizers(cfg: Config, g: torch.nn.Module, d: torch.nn.Module
                    ) -> tuple[torch.optim.Adam, torch.optim.Adam]:
    t = cfg.train
    betas = (t.beta1, t.beta2)
    return (torch.optim.Adam(g.parameters(), lr=t.lr_g, betas=betas,
                             eps=ADAM_EPS),
            torch.optim.Adam(d.parameters(), lr=t.lr_d, betas=betas,
                             eps=ADAM_EPS))


def create_train_state(cfg: Config, seed: int | None = None,
                       device=None) -> TrainState:
    """Both nets (seeded flax-style init) and both optimizers on
    ``device`` (the card unless the caller asks for another)."""
    dev = resolve_device(device)
    seed = cfg.train.seed if seed is None else seed
    g = init_params(build_generator(cfg, device=dev), seed)
    d = init_params(build_discriminator(cfg, device=dev),
                    role_seed(seed, 0, "init/critic"))
    opt_g, opt_d = make_optimizers(cfg, g, d)
    return TrainState(step=0, g=g, d=d, opt_g=opt_g, opt_d=opt_d, seed=seed)


def param_count(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
