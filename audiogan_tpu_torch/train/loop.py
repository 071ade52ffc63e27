"""Minimal training loop of the port (audiogan_tpu/train/loop.py without
checkpoints, evaluation, sample dumps or TensorBoard, which come later).

Resolves or builds the corpus (data_dir '' -> the seeded synthetic SC09
fixture in the workdir), ships its int16 clips to the device once, then
runs the resident-corpus step: the host sends only the (seed, step)-pure
clip indices per step. One JSON line of metrics every log_every steps.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.data.corpus import Corpus, batch_indices, build_corpus
from audiogan_tpu_torch.data.synthetic import make_synthetic_sc09
from audiogan_tpu_torch.device import resolve_device
from audiogan_tpu_torch.train.state import (TrainState, create_train_state,
                                            param_count)
from audiogan_tpu_torch.train.step import build_train_step, wrap_device_corpus


def resolve_corpus(cfg: Config, workdir: Path) -> Corpus:
    """data_dir: '' -> seeded synthetic fixture; wav tree -> pack once;
    packed dir (has meta.json) -> open."""
    d = cfg.data
    if not d.data_dir:
        wavs = workdir / "synthetic_wavs"
        packed = workdir / "synthetic_corpus"
        if not (packed / "meta.json").exists():
            make_synthetic_sc09(wavs, n_per_class=8,
                                num_classes=max(d.num_classes, 10),
                                rate=d.source_rate,
                                clip_len=min(d.store_len, d.source_rate),
                                seed=0)
            build_corpus(wavs, packed, store_len=d.store_len,
                         source_rate=d.source_rate)
        return Corpus(packed)
    src = Path(d.data_dir)
    if (src / "meta.json").exists():
        return Corpus(src)
    packed = workdir / "corpus"
    if not (packed / "meta.json").exists():
        build_corpus(src, packed, store_len=d.store_len)
    return Corpus(packed)


def check_corpus(cfg: Config, corpus: Corpus) -> None:
    if cfg.data.num_classes and corpus.meta.get("num_classes", 0) == 0:
        raise ValueError("conditional config but corpus has no labels")
    for field, want in (("source_rate", cfg.data.source_rate),
                        ("store_len", cfg.data.store_len)):
        got = corpus.meta.get(field)
        if got is not None and got != want:
            raise ValueError(f"corpus {field}={got} but config "
                             f"data.{field}={want}")


def train(cfg: Config, workdir: str | Path, steps: int, device=None,
          log: Callable[[str], None] = print) -> tuple[TrainState, dict]:
    """Runs ``steps`` steps from a fresh state; returns the state and the
    last step's metrics as floats."""
    dev = resolve_device(device)
    cfg.validate()
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "config.json").write_text(cfg.to_json())
    corpus = resolve_corpus(cfg, workdir)
    check_corpus(cfg, corpus)
    clips = torch.from_numpy(np.array(corpus.clips)).to(dev)
    all_labels = torch.from_numpy(
        np.array(corpus.labels)).to(dev, torch.long)
    state = create_train_state(cfg, device=dev)
    log(json.dumps({"init": {"g_params": param_count(state.g),
                             "d_params": param_count(state.d),
                             "corpus_clips": len(corpus),
                             "device": str(dev)}}))
    step_fn = wrap_device_corpus(build_train_step(cfg, dev))
    b, n_views = cfg.train.batch_size, cfg.loss.n_critic
    every = max(cfg.train.log_every, 1)
    metrics: dict = {}
    t0 = time.perf_counter()
    for i in range(steps):
        idx = torch.from_numpy(batch_indices(
            len(corpus), b, n_views, cfg.train.seed, state.step)).to(dev)
        out = step_fn(state, clips, idx, all_labels[idx])
        if (i + 1) % every == 0 or i + 1 == steps:
            metrics = {k: float(v) for k, v in out.items()}
            bad = [k for k, v in metrics.items() if not np.isfinite(v)]
            log(json.dumps({"step": state.step, **metrics,
                            "seconds": time.perf_counter() - t0}))
            if bad:
                raise FloatingPointError(f"non-finite {bad} at step "
                                         f"{state.step}")
    return state, metrics
