"""Sampler export: the generator's state dict plus ``meta.json``.

The JAX package bakes its weights into a StableHLO graph; PyTorch runs
eagerly, so here the artifact is the weights (``generator.pt``, written
with ``torch.save``) and the config, and ``ServedSampler`` rebuilds G from
the config on load. ``meta.json`` carries the JAX artifact's keys. The
artifact has a fixed batch ``num``: every call draws ``num`` latents, so a
request for fewer clips gets a prefix of the same bytes.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.device import resolve_device
from audiogan_tpu_torch.train.sample import build_sample_fn

_WEIGHTS = "generator.pt"
_META = "meta.json"


def export_sampler(cfg: Config, params_g: dict[str, torch.Tensor], num: int,
                   out_dir: str | Path) -> Path:
    """Write G's weights and meta.json for a serving batch of ``num``."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in params_g.items()},
               out_dir / _WEIGHTS)
    (out_dir / _META).write_text(json.dumps({
        "num": num,
        "clip_len": cfg.data.clip_len,
        "sample_rate": cfg.data.sample_rate,
        "num_classes": cfg.data.num_classes,
        "platforms": ["cuda", "cpu"],
        "model": cfg.name,
        "config": json.loads(cfg.to_json()),
    }, indent=1))
    return out_dir


class ServedSampler:
    """A loaded artifact on one device: seeded, deterministic generation."""

    def __init__(self, art_dir: str | Path, device=None):
        d = Path(art_dir)
        self.device = resolve_device(device)
        self.meta = json.loads((d / _META).read_text())
        cfg = Config.from_json(json.dumps(self.meta["config"])).validate()
        self._params = torch.load(d / _WEIGHTS, map_location=self.device,
                                  weights_only=True)
        self._sample = build_sample_fn(cfg, self.device)

    @property
    def num(self) -> int:
        return self.meta["num"]

    @property
    def sample_rate(self) -> int:
        return self.meta["sample_rate"]

    @property
    def conditional(self) -> bool:
        return self.meta["num_classes"] > 0

    def generate(self, seed: int,
                 labels: np.ndarray | None = None) -> np.ndarray:
        """float32 [num, clip_len]; same (seed, labels) -> same bytes."""
        if not -2 ** 63 <= seed < 2 ** 64:
            raise ValueError("seed must be in [-2**63, 2**64)")
        lab = None
        if self.conditional:
            if labels is None:
                labels = np.arange(self.num) % self.meta["num_classes"]
            lab = np.asarray(labels)
            if lab.shape != (self.num,):
                raise ValueError(
                    f"labels must have shape ({self.num},), got {lab.shape}")
            if not np.issubdtype(lab.dtype, np.integer):
                raise ValueError(f"labels must be integers, got {lab.dtype}")
            if lab.min() < 0 or lab.max() >= self.meta["num_classes"]:
                raise ValueError(f"labels must be in [0, "
                                 f"{self.meta['num_classes']})")
            lab = torch.as_tensor(lab.astype(np.int64))
        elif labels is not None:
            raise ValueError("labels passed to an unconditional artifact")
        y = self._sample(self._params, seed, lab, num=self.num)
        return y.cpu().numpy()


def load_sampler(art_dir: str | Path, device=None) -> ServedSampler:
    return ServedSampler(art_dir, device)
