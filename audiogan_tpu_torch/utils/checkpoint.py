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

``save`` writes on the calling thread. ``AsyncSaver`` is the training
loop's, the reference's ``_AsyncCkpt`` (audiogan_tpu/train/loop.py:40-93):
on the calling thread a copy of the state's tensors on their device,
ordered after the step on the current stream, and ZeRO-1's gather of the
moments (a collective: it never leaves the thread that runs the step's
collectives); then a worker thread fetches the copy to pinned host memory
one tensor at a time on a side stream (so a small fetch of the loop's, its
metrics, never queues behind the whole state), writes the file and prunes.
One save is in flight: the next save, and ``join``, wait for it first, and
an error of the worker is raised there.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

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


def checkpoint_blob(mngr: CheckpointManager, state,
                    metrics: dict | None = None) -> dict:
    """What ``save`` writes, its tensors the live ones (the optimizers'
    moments whole: a ZeRO-1 state gathers them, a collective that every
    rank of its data axis joins)."""
    return {"step": int(state.step), "seed": int(state.seed),
            "config": mngr.config,
            "g": state.g.state_dict(), "d": state.d.state_dict(),
            "opt_g": state.opt_g.full_state_dict(),
            "opt_d": state.opt_d.full_state_dict(),
            "metrics": None if metrics is None else {
                k: float(v) for k, v in metrics.items()}}


def write_blob(mngr: CheckpointManager, blob: dict) -> int:
    """Writes ``blob`` as the checkpoint of its step, metrics first, then
    drops the ones the policy no longer keeps; the file's bytes."""
    step = blob["step"]
    _write_atomic(mngr.metrics_path(step), lambda f: f.write(json.dumps(
        {"step": step, "metrics": blob["metrics"]}).encode()))
    _write_atomic(mngr.path(step), lambda f: torch.save(blob, f))
    nbytes = mngr.path(step).stat().st_size
    steps = mngr.all_steps()
    for s in set(steps) - _kept(mngr, steps):
        mngr.path(s).unlink(missing_ok=True)
        mngr.metrics_path(s).unlink(missing_ok=True)
    return nbytes


def save(mngr: CheckpointManager, state, metrics: dict | None = None,
         write: bool = True) -> int:
    """Writes the checkpoint of ``state.step``, then drops the ones the
    policy no longer keeps. Returns the checkpoint's size in bytes.

    The optimizers' moments are saved whole: a ZeRO-1 state gathers them
    first, so every rank of its data axis calls ``save`` and only one,
    with ``write``, writes (the others return 0). The file is the same
    on any topology."""
    blob = checkpoint_blob(mngr, state, metrics)
    return write_blob(mngr, blob) if write else 0


def _map_tensors(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


class AsyncSaver:
    """The loop's checkpoints, written by a worker thread, one in flight
    (the module docstring). ``save`` returns the seconds it blocked the
    caller: waiting for the previous save, the copy, the gather. Once a
    save's file is complete, ``on_complete`` gets its record on the
    caller's thread, at the first ``poll``, ``save`` or ``join`` after
    that (so before any later save starts writing): {"step", "bytes",
    "blocked", "parts", "write"}: ``parts`` splits ``blocked`` into
    "join" (the previous save), "state" (the state dicts and ZeRO-1's
    gather), "alloc" (the device copy's memory, "new_segments" the
    cudaMalloc calls it made), "copy" (its launches) and "event";
    ``write`` is the worker's seconds from the fetch to the file in
    place. Without ``write`` (the ranks that do not write) a
    save only joins ZeRO-1's gather."""

    def __init__(self, mngr: CheckpointManager, device: torch.device,
                 write: bool = True,
                 on_complete: Callable[[dict], None] = lambda rec: None):
        self.mngr, self.write, self.on_complete = mngr, write, on_complete
        self._thread: threading.Thread | None = None
        self._err: BaseException | None = None
        self._record: dict | None = None
        # the fetches' side stream, made here and not at the first save: a
        # process's first stream fills torch's stream pool, which blocked
        # a first save 12-257 ms on an H100
        self._stream = (torch.cuda.Stream(device)
                        if write and device.type == "cuda" else None)

    def save(self, state, metrics: dict | None = None) -> float:
        t0 = time.perf_counter()
        self.join()
        t1 = time.perf_counter()
        blob = checkpoint_blob(self.mngr, state, metrics)
        t2 = time.perf_counter()
        if not self.write:
            return t2 - t0
        dev = next((t.device for t in _leaves(blob) if t.is_cuda), None)
        segments = _segments(dev)
        # the device copy, on the current stream after the step: its
        # memory, then its launches
        snap = _map_tensors(blob, lambda t: torch.empty_like(t.detach()))
        t3 = time.perf_counter()
        new_segments = _segments(dev) - segments
        for dst, src in zip(_leaves(snap), _leaves(blob)):
            dst.copy_(src.detach())
        t4 = time.perf_counter()
        ready = None
        if dev is not None:
            if self._stream is None:
                raise ValueError("a state on the card, a saver built for "
                                 "the CPU")
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
        t5 = time.perf_counter()
        record = {"step": blob["step"], "blocked": t5 - t0, "parts": {
            "join": t1 - t0, "state": t2 - t1, "alloc": t3 - t2,
            "new_segments": new_segments, "copy": t4 - t3,
            "event": t5 - t4}}
        self._thread = threading.Thread(
            target=self._work, args=(snap, ready, record), daemon=True,
            name="audiogan-ckpt")
        self._thread.start()
        return record["blocked"]

    def _fetch(self, snap: dict, ready) -> dict:
        """Each CUDA tensor into pinned host memory, one at a time, on the
        side stream, after ``ready``."""
        if ready is None:
            return snap
        stream = self._stream
        stream.wait_event(ready)

        def fetch(t):
            if not t.is_cuda:
                return t
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            with torch.cuda.stream(stream):
                host.copy_(t, non_blocking=True)
            stream.synchronize()
            return host
        return _map_tensors(snap, fetch)

    def _work(self, snap: dict, ready, record: dict) -> None:
        t0 = time.perf_counter()
        try:
            host = self._fetch(snap, ready)
            del snap
            record["bytes"] = write_blob(self.mngr, host)
            record["write"] = time.perf_counter() - t0
            self._record = record
        except BaseException as err:      # raised at the next join
            self._err = err

    def poll(self) -> None:
        """``join`` if the save in flight is done; else nothing."""
        if self._thread is None or not self._thread.is_alive():
            self.join()

    def join(self) -> None:
        """Waits for the save in flight: raises its error, or hands its
        record to ``on_complete``."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        if self._record is not None:
            rec, self._record = self._record, None
            self.on_complete(rec)

    def close(self) -> None:
        """Lets a save in flight finish, raising nothing: the loop's error
        path, where the loop's own error goes on."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _segments(dev) -> int:
    """The device memory segments the caching allocator has taken so far
    (its cudaMalloc calls); 0 off the card."""
    if dev is None:
        return 0
    return torch.cuda.memory_stats(dev).get("segment.all.allocated", 0)


def _leaves(tree) -> list:
    out: list = []
    _map_tensors(tree, out.append)
    return out


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
