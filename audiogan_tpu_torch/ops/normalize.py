"""Per-clip amplitude normalization, port of audiogan_tpu/ops/normalize.py."""

from __future__ import annotations

import torch


def normalize_amplitude(x: torch.Tensor, mode: str = "peak",
                        target: float = 0.999,
                        eps: float = 1e-8) -> torch.Tensor:
    """Normalize each clip (last axis = time) to a target amplitude.

    mode="peak": max |x| -> target. mode="rms": rms -> target. "none":
    no-op. Silent clips pass through unchanged (eps guard).
    """
    if mode == "none":
        return x
    if mode == "peak":
        scale = x.abs().amax(dim=-1, keepdim=True)
    elif mode == "rms":
        scale = x.square().mean(dim=-1, keepdim=True).sqrt()
    else:
        raise ValueError(f"unknown normalize mode {mode!r}")
    return x * (target / torch.clamp_min(scale, eps))
