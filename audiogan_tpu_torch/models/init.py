"""Seeded parameter init: glorot-uniform kernels, zero biases, and the
other flax initializers a module names in its ``INITS``.

The flax initializers the JAX package uses (models/wavegan.py,
models/gru.py), drawn from a ``torch.Generator``: the same seed gives the
same weights on one device, but not JAX's numbers (weights cross over
through ``convert.py``).
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


def orthogonal_(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """flax's orthogonal(): QR of a standard normal [max, min] matrix,
    columns signed by diag(R), transposed when rows < cols, so a [H, 3H]
    matrix has orthonormal rows."""
    rows, cols = t.shape[0], math.prod(t.shape[1:])
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=gen,
                    device=t.device, dtype=torch.float32)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    with torch.no_grad():
        t.copy_(q.reshape(t.shape))
    return t


def init_params(module: nn.Module, seed: int) -> nn.Module:
    """Fills every parameter in registration order: the module's
    ``INITS[name]`` ("zeros" or "orthogonal") where it names one, else
    zeros for names ending in ``bias`` and glorot-uniform for the rest."""
    params = list(module.named_parameters())
    gen = torch.Generator(params[0][1].device).manual_seed(seed)
    inits = getattr(module, "INITS", {})
    for name, p in params:
        kind = inits.get(name, "zeros" if name.endswith("bias") else
                         "glorot")
        if kind == "zeros":
            with torch.no_grad():
                p.zero_()
        elif kind == "orthogonal":
            orthogonal_(p, gen)
        else:
            glorot_uniform_(p, gen)
    return module
