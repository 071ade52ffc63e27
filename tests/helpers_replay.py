"""Jobs of tests/test_torch_replay.py that run in one process or on every
rank of tools/dp_check.py::spawn: the loop with each step's body (the
step on its fixed buffers, train/step_graph.py::StepGraph.body) recorded
op by op, and the sharded corpus's two exchanges. Imports nothing of JAX,
so the spawned ranks stay light."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.parallel.mesh import DataMesh
from audiogan_tpu_torch.tools.dp_check import train_job
from audiogan_tpu_torch.train.step_graph import StepGraph

# non-tensor arguments kept by value; any other object by its type alone
_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.layout, torch.memory_format)


def _form(x):
    """An op argument as the record keeps it: a tensor's dtype, shape and
    device type; a plain value itself; containers element by element."""
    if isinstance(x, torch.Tensor):
        return ("tensor", str(x.dtype), tuple(x.shape), x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(_form(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _form(v)) for k, v in sorted(x.items()))
    if isinstance(x, _PLAIN):
        return x
    return type(x).__name__


class OpRecord(TorchDispatchMode):
    """Every aten op dispatched inside: its name and every argument."""

    def __init__(self):
        super().__init__()
        self.ops: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops.append((str(func), _form(args), _form(kwargs)))
        return func(*args, **kwargs)


def recorded_train(cfg: Config, workdir, steps: int, dev) -> dict:
    """loop.train of cfg up to ``steps`` (resuming from the workdir's
    latest checkpoint), each step's body recorded: {step: its ops}."""
    records: dict = {}
    body = StepGraph.body

    def recording(self, state):
        step = state.step
        with OpRecord() as rec:
            out = body(self, state)
        records[step] = rec.ops
        return out
    StepGraph.body = recording
    try:
        train_job(dev, cfg.to_json(), str(workdir), steps)
    finally:
        StepGraph.body = body
    return records


def record_job(dev, cfg_json: str, workdir: str, stop: int,
               steps: int) -> dict:
    """On each rank: ``recorded_train`` up to ``stop`` (a checkpoint
    there), then again resumed up to ``steps``; every step's record."""
    cfg = Config.from_json(cfg_json)
    records = recorded_train(cfg, workdir, stop, dev)
    records.update(recorded_train(cfg, workdir, steps, dev))
    return {"records": records}


def exchange_job(dev, clips: np.ndarray, idx_sets: list) -> dict:
    """This rank's clips of each global index set [V, B], by the planned
    exchange (uneven splits) and the fixed one, and the bytes each
    sends."""
    from audiogan_tpu_torch.parallel.sharded_corpus import (
        exchange_bytes, gather_fixed, gather_planned, local_shard,
        plan_fixed, plan_step)
    mesh = DataMesh(dist.get_world_size(), dist.get_rank())
    local = torch.from_numpy(local_shard(clips, mesh)).to(dev)
    out = []
    for idx in idx_sets:
        planned = plan_step(idx, local.shape[0], mesh, dev)
        fixed = plan_fixed(idx, local.shape[0], mesh, dev)
        out.append({"planned": gather_planned(local, planned, mesh).cpu(),
                    "fixed": gather_fixed(local, fixed, mesh).cpu(),
                    "bytes": (exchange_bytes(planned, clips.shape[1]),
                              exchange_bytes(fixed, clips.shape[1]))})
    return {"sets": out}
