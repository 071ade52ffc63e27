"""Fixed-length framing: random / center crop with zero-pad (SPEC I4).

Port of audiogan_tpu/ops/framing.py. Offsets come from a
``torch.Generator``, not from JAX's stream; tests inject JAX's offsets.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_to(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Zero-pads the last axis up to out_len (no-op when long enough)."""
    if x.shape[-1] >= out_len:
        return x
    return F.pad(x, (0, out_len - x.shape[-1]))


def crop_offsets(gen: torch.Generator, batch: int, max_off: int,
                 device=None) -> torch.Tensor:
    """Per-example crop starts ~ U{0..max_off}, int32 [batch]."""
    return torch.randint(0, max_off + 1, (batch,), generator=gen,
                         device=device, dtype=torch.int32)


def crop_rows(x: torch.Tensor, offsets: torch.Tensor,
              out_len: int) -> torch.Tensor:
    """x [B, T] -> [B, out_len], row b starting at offsets[b] (zero-pad
    first if T < out_len, as the reference's random_crop does)."""
    x = pad_to(x, out_len)
    max_off = x.shape[-1] - out_len
    offs = offsets.to(device=x.device, dtype=torch.long)
    if x.device.type == "cpu" and offs.numel() and (
            int(offs.min()) < 0 or int(offs.max()) > max_off):
        raise ValueError(f"crop offsets outside [0, {max_off}]")
    idx = offs[:, None] + torch.arange(out_len, device=x.device)
    return torch.gather(x, 1, idx)


def center_crop(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Deterministic center crop of [..., T] -> [..., out_len]."""
    x = pad_to(x, out_len)
    start = (x.shape[-1] - out_len) // 2
    return x[..., start:start + out_len]
