"""Seeded parameter init: glorot-uniform kernels, zero biases.

The flax initializers the JAX package uses (models/wavegan.py), drawn from
a ``torch.Generator``: the same seed gives the same weights on one device,
but not JAX's numbers (weights cross over through ``convert.py``).
"""

from __future__ import annotations

import math

import torch
from torch import nn


def glorot_uniform_(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """U(-l, l), l = sqrt(6 / (fan_in + fan_out)); the last two dims are
    (in, out) and any leading dims are the receptive field, as in flax."""
    receptive = math.prod(t.shape[:-2])
    fan_in, fan_out = t.shape[-2] * receptive, t.shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        u = torch.rand(t.shape, generator=gen, device=t.device,
                       dtype=torch.float32)
        t.copy_(u * (2 * limit) - limit)
    return t


def init_params(module: nn.Module, seed: int) -> nn.Module:
    """Fills every parameter in registration order: names ending in
    ``bias`` get zeros, all others glorot-uniform."""
    params = list(module.named_parameters())
    gen = torch.Generator(params[0][1].device).manual_seed(seed)
    for name, p in params:
        if name.endswith("bias"):
            with torch.no_grad():
                p.zero_()
        else:
            glorot_uniform_(p, gen)
    return module
