"""Seeded synthetic SC09-shaped fixture corpus, the port of
audiogan_tpu/data/synthetic.py: 10 "digit" classes, each a class-dependent
mix of harmonics, an AM envelope and noise. Deterministic in (seed, index)
and byte-identical to the reference's files.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from audiogan_tpu_torch.data.wavio import write_wav


def synth_clip(rng: np.random.Generator, label: int, n: int,
               rate: int) -> np.ndarray:
    t = np.arange(n, dtype=np.float64) / rate
    f0 = 110.0 * (2.0 ** (label / 3.0)) * (1.0 + 0.05 * rng.standard_normal())
    x = np.zeros(n)
    for k in range(1, 4 + label % 3):
        x += rng.uniform(0.3, 1.0) / k * np.sin(
            2 * np.pi * k * f0 * t + rng.uniform(0, 2 * np.pi))
    env_f = rng.uniform(2.0, 6.0)
    env = 0.5 * (1 - np.cos(2 * np.pi * np.clip(env_f * t, 0, 1)))
    x = x * env + 0.02 * rng.standard_normal(n)
    x /= np.max(np.abs(x)) + 1e-9
    return (x * 0.8).astype(np.float32)


def make_synthetic_sc09(out_dir: str | Path, n_per_class: int = 8,
                        num_classes: int = 10, rate: int = 16000,
                        clip_len: int = 16384, seed: int = 0) -> Path:
    """Write a wav-file tree out_dir/<digit>/<i>.wav, SC09 layout."""
    out_dir = Path(out_dir)
    for label in range(num_classes):
        d = out_dir / str(label)
        d.mkdir(parents=True, exist_ok=True)
        for i in range(n_per_class):
            rng = np.random.default_rng(seed * 1_000_003 + label * 1009 + i)
            write_wav(d / f"{label}_{i:04d}.wav", rate,
                      synth_clip(rng, label, clip_len, rate))
    return out_dir
