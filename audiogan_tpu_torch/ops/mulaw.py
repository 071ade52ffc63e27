"""Mu-law companding (ITU-T G.711 constants, mu=255)."""

from __future__ import annotations

import math

import torch


def mu_law_compand(x: torch.Tensor, mu: float = 255.0) -> torch.Tensor:
    """Compand x in [-1, 1] -> [-1, 1]: sign(x) * log1p(mu|x|) / log1p(mu)."""
    return torch.sign(x) * torch.log1p(mu * x.abs()) / math.log1p(mu)


def mu_law_expand(y: torch.Tensor, mu: float = 255.0) -> torch.Tensor:
    """Inverse compand: sign(y) * ((1+mu)^|y| - 1) / mu."""
    return torch.sign(y) * torch.expm1(y.abs() * math.log1p(mu)) / mu
