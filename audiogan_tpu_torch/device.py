"""Device choice for the port's entry points."""

from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The card unless the caller names another device; no silent
    fallback. Under torchrun (WORLD_SIZE > 1) the card is this process's,
    ``cuda:LOCAL_RANK``."""
    if device is None:
        multi = int(os.environ.get("WORLD_SIZE", "1")) > 1
        device = (f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}" if multi
                  else "cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
