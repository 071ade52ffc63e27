"""The process group, the counterpart of
audiogan_tpu/parallel/multihost.py (``maybe_initialize_distributed``,
``make_train_mesh``).

One process per card. ``torchrun`` starts them and announces the group
in the environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``); across hosts each host runs
``torchrun --nnodes H --node_rank h --nproc_per_node N``. torchrun
numbers the ranks host by host, local rank within host, which is the
reference's ('dcn', 'data') order: with DP alone the host tier is the
outer part of the data axis, and a rank's rows of the global batch
follow from its rank alone.

The backend is NCCL on ``cuda:LOCAL_RANK`` and gloo where the caller
asked for the CPU, or the one the caller names (two processes on one
card must use gloo: NCCL refuses two ranks on one device). A failed
initialization raises; nothing falls back to another backend. Init and
every collective have a finite timeout, so a rank that dies fails the
run instead of hanging it. A rank whose run raised leaves the group
without tearing it down (``exit_after_failure``): its peers may wait in
a collective it never joins, and NCCL's teardown would wait for them.
"""

from __future__ import annotations

import datetime
import os
import sys
import traceback

import torch
import torch.distributed as dist

from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.parallel.mesh import DataMesh, make_mesh

# a step's collectives wait at most this long for the slowest rank (the
# first step of a process also builds the kernels)
TIMEOUT_S = 900.0


def check_rank_order() -> None:
    """Raises unless RANK = GROUP_RANK * LOCAL_WORLD_SIZE + LOCAL_RANK
    where torchrun gives those: the (host, local rank) order."""
    env = os.environ
    if not {"GROUP_RANK", "LOCAL_WORLD_SIZE", "LOCAL_RANK"} <= set(env):
        return
    want = (int(env["GROUP_RANK"]) * int(env["LOCAL_WORLD_SIZE"])
            + int(env["LOCAL_RANK"]))
    if int(env["RANK"]) != want:
        raise ValueError(f"RANK={env['RANK']} is not host {env['GROUP_RANK']}"
                         f" x {env['LOCAL_WORLD_SIZE']} + local rank "
                         f"{env['LOCAL_RANK']}: the data axis needs ranks in "
                         "(host, local rank) order")


def maybe_initialize_distributed(device: torch.device,
                                 backend: str | None = None,
                                 timeout_s: float = TIMEOUT_S) -> bool:
    """Initializes the default group iff torchrun's environment asks for
    more than one process; returns whether running multi-process. The
    backend defaults to NCCL for a CUDA ``device`` (which becomes the
    current device) and gloo for the CPU."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    missing = [k for k in ("RANK", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE > 1 but {missing} unset: launch "
                           "with torchrun")
    check_rank_order()
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return True


def exit_after_failure() -> None:
    """Ends this rank of a group of several processes after its run
    raised: prints the error and exits with code 1 at once, without the
    group's teardown. Its peers may wait in a collective this rank never
    joins (a step that raised half way, train.dump_hlo's warm-up), and
    destroying an NCCL group waits for them: on four H100s a rank whose
    dump failed in its warm-up hung there. Under torchrun this exit ends
    the peers; else the group's timeout does."""
    traceback.print_exc()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(1)


def make_train_mesh(cfg: Config, device: torch.device) -> DataMesh:
    """The data axis train/loop.py runs on: initializes the process group
    when launched under torchrun (unless the caller already has), then
    checks it against cfg.mesh (a cp or tp group on one host) and builds
    every axis's groups (parallel/mesh.py::make_meshes)."""
    maybe_initialize_distributed(device)
    return make_mesh(cfg)
