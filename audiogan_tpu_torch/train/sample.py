"""Seeded, deterministic sampling: z ~ N(0, 1) -> G -> mu-law expand.

z is drawn from a ``torch.Generator`` on the sampling device seeded with
``seed``, so the same (weights, seed, num, labels) on one device give the
same bytes. Those are not JAX's draws (another generator); tests inject
JAX's z through ``z=``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.func import functional_call

from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.device import resolve_device
from audiogan_tpu_torch.models import build_generator
from audiogan_tpu_torch.ops.mulaw import mu_law_expand


def build_sample_fn(cfg: Config, device=None) -> Callable:
    """Returns fn(params_g, seed, labels=None, *, num=1, z=None) ->
    waveforms [num, clip_len] f32 on the device. params_g is a state dict
    on that device; labels default to draws from the seeded generator."""
    dev = resolve_device(device)
    g = build_generator(cfg, device="meta")
    n_cls = cfg.data.num_classes

    @torch.inference_mode()
    def sample_fn(params_g: dict[str, torch.Tensor], seed: int,
                  labels: torch.Tensor | None = None, *, num: int = 1,
                  z: torch.Tensor | None = None) -> torch.Tensor:
        gen = torch.Generator(dev).manual_seed(seed)
        if z is None:
            z = torch.randn(num, cfg.model.latent_dim, generator=gen,
                            device=dev)
        z = z.to(dev, torch.float32)
        if n_cls and labels is None:
            labels = torch.randint(0, n_cls, (z.shape[0],), generator=gen,
                                   device=dev)
        if labels is not None:
            labels = labels.to(dev, torch.long)
        y = functional_call(g, params_g, (z, labels))[..., 0]
        if cfg.data.mu_law:
            y = mu_law_expand(y, cfg.data.mu)
        return y

    return sample_fn


def generate(cfg: Config, params_g: dict[str, torch.Tensor], num: int,
             seed: int, labels: np.ndarray | None = None, device=None,
             z: np.ndarray | torch.Tensor | None = None) -> np.ndarray:
    """Host entry: seeded generation -> float32 numpy [num, clip_len]."""
    dev = resolve_device(device)
    params = {k: v.to(dev) for k, v in params_g.items()}
    lab = None if labels is None else torch.tensor(np.asarray(labels))
    if z is not None and not isinstance(z, torch.Tensor):
        z = torch.tensor(np.asarray(z, np.float32))
    y = build_sample_fn(cfg, dev)(params, seed, lab, num=num, z=z)
    return y.cpu().numpy()
