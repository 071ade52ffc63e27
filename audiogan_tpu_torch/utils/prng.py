"""The port's random stream: generators that are pure functions of
(seed, step, role) (SPEC L5).

As audiogan_tpu/utils/prng.py derives every key of a step from
fold_in(base_key, step) and a role, each draw here comes from a
``torch.Generator`` seeded with a hash of (seed, step, role), so a step
replays bit-identically on one device. The numbers are not JAX's (another
generator); parity tests inject the reference's draws instead.
"""

from __future__ import annotations

import hashlib

import torch


def role_seed(seed: int, step: int, role: str) -> int:
    """A 63-bit seed from (seed, step, role)."""
    h = hashlib.sha256(f"{int(seed)}/{int(step)}/{role}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, step: int, role: str,
              device: torch.device | str = "cpu") -> torch.Generator:
    """A fresh generator on ``device`` for this (seed, step, role)."""
    return torch.Generator(device).manual_seed(role_seed(seed, step, role))
