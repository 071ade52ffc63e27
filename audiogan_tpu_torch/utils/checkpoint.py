"""Checkpoints of the whole TrainState as torch files, the port of
audiogan_tpu/utils/checkpoint.py (orbax there; the port reads no orbax
directory).

A checkpoint is one ``torch.save`` file per step, ``<workdir>/ckpt/<step>.pt``,
holding the step, the seed, the config as JSON, both nets' and both Adam
optimizers' state dicts and the metrics it was saved with. Beside it,
``<step>.json`` holds the step's metrics alone, so that choosing the latest
or the best step never loads a state (about 440 MB at the flagship).

Each file is written under a temporary name in the same directory and moved
into place with ``os.replace``, metrics first: a kill at any instant leaves
every listed checkpoint complete, and a half-written file is never listed.

Which checkpoints survive a save, as orbax's CheckpointManager decides it:
the last ``keep``; or, with ``best_metric``, the best ``keep`` by that
metric (``best_mode`` "min" or "max") and every one saved without metrics.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass
from pathlib import Path

import torch

from audiogan_tpu_torch.config import Config

_NAME = re.compile(r"^(\d+)\.pt$")


@dataclass(frozen=True)
class CheckpointManager:
    directory: Path
    keep: int
    best_metric: str | None = None
    best_mode: str = "min"
    config: str | None = None       # the config as JSON, written into each

    def path(self, step: int) -> Path:
        return self.directory / f"{step}.pt"

    def metrics_path(self, step: int) -> Path:
        return self.directory / f"{step}.json"

    def all_steps(self) -> list[int]:
        """The steps with a complete checkpoint, ascending."""
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _NAME.match(p.name)))

    def metrics(self, step: int) -> dict | None:
        path = self.metrics_path(step)
        if not path.exists():
            return None
        return json.loads(path.read_text())["metrics"]


def make_manager(workdir: str | Path, keep: int = 3,
                 best_metric: str | None = None, best_mode: str = "min",
                 config: Config | None = None) -> CheckpointManager:
    """keep-last-k manager of ``<workdir>/ckpt``; best_metric switches to
    keep-best-k by that metric. ``config`` is stored in every checkpoint."""
    if best_mode not in ("min", "max"):
        raise ValueError(f"best_mode must be 'min' or 'max', got "
                         f"{best_mode!r}")
    path = (Path(workdir) / "ckpt").absolute()
    path.mkdir(parents=True, exist_ok=True)
    return CheckpointManager(path, keep, best_metric, best_mode,
                             None if config is None else config.to_json())


def _write_atomic(path: Path, write) -> None:
    fd, tmp = tempfile.mkstemp(prefix=f".{path.name}.", suffix=".tmp",
                               dir=path.parent)
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _sorted_by_metric(mngr: CheckpointManager, steps: list[int]
                      ) -> tuple[list[int], list[int]]:
    """(steps without metrics, steps with metrics from worst to best)."""
    scored = [(s, mngr.metrics(s)) for s in steps]
    without = [s for s, m in scored if m is None]
    ranked = sorted(((s, float(m[mngr.best_metric])) for s, m in scored
                     if m is not None), key=lambda sm: sm[1],
                    reverse=mngr.best_mode == "min")
    return without, [s for s, _ in ranked]


def _kept(mngr: CheckpointManager, steps: list[int]) -> set[int]:
    if mngr.best_metric is None:
        return set(steps[-mngr.keep:] if mngr.keep > 0 else steps)
    without, ranked = _sorted_by_metric(mngr, steps)
    return set(without) | set(ranked[-mngr.keep:] if mngr.keep > 0
                              else ranked)


def save(mngr: CheckpointManager, state, metrics: dict | None = None,
         write: bool = True) -> int:
    """Writes the checkpoint of ``state.step``, then drops the ones the
    policy no longer keeps. Returns the checkpoint's size in bytes.

    The optimizers' moments are saved whole: a ZeRO-1 state gathers them
    first, so every rank of its data axis calls ``save`` and only one,
    with ``write``, writes (the others return 0). The file is the same
    on any topology."""
    step = int(state.step)
    metrics = None if metrics is None else {k: float(v)
                                            for k, v in metrics.items()}
    opt_g = state.opt_g.full_state_dict()
    opt_d = state.opt_d.full_state_dict()
    if not write:
        return 0
    blob = {"step": step, "seed": int(state.seed), "config": mngr.config,
            "g": state.g.state_dict(), "d": state.d.state_dict(),
            "opt_g": opt_g, "opt_d": opt_d, "metrics": metrics}
    _write_atomic(mngr.metrics_path(step), lambda f: f.write(json.dumps(
        {"step": step, "metrics": metrics}).encode()))
    _write_atomic(mngr.path(step), lambda f: torch.save(blob, f))
    nbytes = mngr.path(step).stat().st_size
    steps = mngr.all_steps()
    for s in set(steps) - _kept(mngr, steps):
        mngr.path(s).unlink(missing_ok=True)
        mngr.metrics_path(s).unlink(missing_ok=True)
    return nbytes


def latest_step(mngr: CheckpointManager) -> int | None:
    steps = mngr.all_steps()
    return steps[-1] if steps else None


def best_step(mngr: CheckpointManager) -> int | None:
    """The best step by ``best_metric``; the latest without one."""
    if mngr.best_metric is None:
        return latest_step(mngr)
    _, ranked = _sorted_by_metric(mngr, mngr.all_steps())
    return ranked[-1] if ranked else None


def load(mngr: CheckpointManager, step: int | None = None) -> dict:
    """The checkpoint of ``step`` (default: latest) as saved, on the CPU."""
    step = latest_step(mngr) if step is None else step
    if step is None:
        raise FileNotFoundError("no checkpoint to restore")
    path = mngr.path(step)
    if not path.exists():
        raise FileNotFoundError(f"no checkpoint of step {step} in "
                                f"{mngr.directory}")
    return torch.load(path, map_location="cpu", weights_only=True)


def restore(mngr: CheckpointManager, state, step: int | None = None):
    """Restores ``step`` (default: latest) into ``state``, a TrainState that
    create_train_state built for the same config, and returns it.

    The tensors are loaded on the CPU and copied into the state's
    parameters; ``Optimizer.load_state_dict`` moves Adam's moments to their
    parameters' devices and leaves each ``step`` count a CPU tensor, as a
    fresh (neither capturable nor fused) Adam keeps it; a ZeRO-1 Adam
    keeps its rank's block of each whole moment. Every rank of a data
    axis restores the same file, whatever topology wrote it. The optimizers'
    hyperparameters stay those of ``state`` (the config's), as the
    reference's optax transforms take theirs from the config."""
    blob = load(mngr, step)
    state.g.load_state_dict(blob["g"])
    state.d.load_state_dict(blob["d"])
    for opt, saved in ((state.opt_g, blob["opt_g"]),
                       (state.opt_d, blob["opt_d"])):
        hyper = [{k: v for k, v in g.items() if k != "params"}
                 for g in opt.param_groups]
        opt.load_state_dict(saved)
        for group, h in zip(opt.param_groups, hyper):
            group.update(h)
    state.step, state.seed = int(blob["step"]), int(blob["seed"])
    return state
