"""The resident corpus sharded over the data axis, the counterpart of
audiogan_tpu/parallel/sharded_corpus.py.

The replicated resident corpus (train/step.py::wrap_device_corpus) holds
every clip on every card, which caps it at DEVICE_CORPUS_MAX_GB. Sharded,
rank r holds rows [r n, (r+1) n) of the packed [N, store_len] int16 clips,
zero-padded to a multiple of dp (n = N_padded / dp; padded rows are never
addressed, the index stream draws in [0, N)). A step's clips then come
from their owners:

    plan (host)   every rank draws the same global index set [V, B] from
                  (seed, step), so each knows, with no exchange, which
                  rank owns each clip of the step and which rank's rows
                  it falls in; the loop makes it before the step
                  (``plan_fixed``), its index tensors copied to the
                  device, so the step itself makes no host copy
    pack          each owner copies the clips it owns, grouped by the
                  rank that needs them, in global order within a group,
                  each group padded to cap = V b rows, the most one
                  owner can hold of a peer's clips
    all_to_all    one all_to_all_single of those dp cap rows as bytes
                  (uint8), even splits: every size is fixed, so the loop's
                  replayed CUDA graph takes it (train/step_graph.py)
    place         each rank takes its V b clips from the received rows
                  in its [V, b] order

``plan_step``/``gather_planned`` are the same exchange at the step's own
sizes (uneven splits: each rank sends and receives exactly the rows
needed); a graph would freeze one step's sizes, so the loop keeps them
only as the fixed form's reference (the same bytes arrive).

No arithmetic touches the samples: the reference reduce-scatters masked
partial sums, but NCCL has no 16-bit integer type, and a sum of int16 bit
patterns viewed as half could change NaN payloads. The exchange is a
copy, so it equals the replicated gather, and the host batcher's stream,
to the bit. Each rank sends and receives dp V b store_len 2 bytes per
step in the fixed form (the step's whole batch of clips), about V b
store_len 2 at the planned sizes. Over gloo (the CPU tests; two
ranks on one card) the exchange runs on host tensors: a CUDA buffer is
copied to the host and back. Under context or tensor parallelism the
exchange runs within each data group (the ranks of one cp or tp index):
the corpus is sharded over the data axis and replicated over cp and tp
(audiogan_tpu/parallel/sharded_corpus.py:38-45), so every rank of a
replica receives the replica's clips.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from audiogan_tpu_torch.parallel.mesh import DataMesh


def corpus_num_shards(mesh: DataMesh) -> int:
    """Corpus shards: one per rank of the data axis."""
    return mesh.dp


def shard_len(n_clips: int, n_shards: int) -> int:
    return -(-n_clips // n_shards)


def pad_clips_to_shards(clips: np.ndarray, n_shards: int) -> np.ndarray:
    """Zero-pad the clip axis to a multiple of n_shards (padded rows are
    never indexed: the index stream draws in [0, N))."""
    pad = shard_len(clips.shape[0], n_shards) * n_shards - clips.shape[0]
    if pad == 0:
        return np.ascontiguousarray(clips)
    return np.concatenate(
        [clips, np.zeros((pad,) + clips.shape[1:], clips.dtype)], axis=0)


def local_shard(clips: np.ndarray, mesh: DataMesh) -> np.ndarray:
    """This rank's rows of the padded clips, read from ``clips`` (a
    memmap is read only there)."""
    n = shard_len(clips.shape[0], mesh.dp)
    own = np.array(clips[mesh.rank * n:(mesh.rank + 1) * n])
    if own.shape[0] == n:
        return own
    out = np.zeros((n,) + clips.shape[1:], clips.dtype)
    out[:own.shape[0]] = own
    return out


def gather_plan(idx: np.ndarray, n_local: int, mesh: DataMesh
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """For the global indices idx [V, B]: (this rank's local rows to
    send, grouped by destination rank, in global order within a group;
    the rows it sends to each rank; the rows it receives from each rank;
    and for each of its positions [V, b], in order, the row of the
    received buffer that holds it)."""
    flat = np.asarray(idx, np.int64).reshape(-1)
    v, batch = idx.shape
    owner = flat // n_local
    dest = np.tile(np.arange(batch) // (batch // mesh.dp), v)
    mine = np.flatnonzero(owner == mesh.rank)
    mine = mine[np.argsort(dest[mine], kind="stable")]
    send = flat[mine] - mesh.rank * n_local
    wanted = np.flatnonzero(dest == mesh.rank)
    order = np.argsort(owner[wanted], kind="stable")
    place = np.empty_like(order)
    place[order] = np.arange(order.size)
    return (send, np.bincount(dest[mine], minlength=mesh.dp),
            np.bincount(owner[wanted], minlength=mesh.dp), place)


@dataclass(frozen=True)
class ShardPlan:
    """One step's exchange, made on the host before the step
    (``plan_step``): this rank's local rows to send (on the device), the
    rows it sends to and receives from each rank (host ints, fixed for
    the step), and for each of its positions the received row that holds
    it (on the device); ``shape`` is (V, b). With one rank, ``send`` holds
    the global indices and nothing is exchanged."""

    send: torch.Tensor
    n_send: list[int]
    n_recv: list[int]
    place: torch.Tensor | None
    shape: tuple[int, int]


def plan_step(idx, n_local: int, mesh: DataMesh,
              device: torch.device) -> ShardPlan:
    """The plan of the global step's indices idx [V, B] (host arithmetic;
    its index tensors copied to ``device``). With one rank the plan is
    the indices themselves, taken where they lie (a row of a resident
    block on the device stays there)."""
    if not mesh.parallel:
        idx = torch.as_tensor(idx)
        return ShardPlan(idx.reshape(-1).to(device, torch.long), [], [],
                         None, tuple(idx.shape))
    idx = np.asarray(idx.cpu() if isinstance(idx, torch.Tensor) else idx)
    v, batch = idx.shape
    send, n_send, n_recv, place = gather_plan(idx, n_local, mesh)
    return ShardPlan(torch.from_numpy(send).to(device), n_send.tolist(),
                     n_recv.tolist(), torch.from_numpy(place).to(device),
                     (v, batch // mesh.dp))


def gather_planned(local_clips: torch.Tensor, plan: ShardPlan,
                   mesh: DataMesh) -> torch.Tensor:
    """This rank's clips [V, b, L] of the step that ``plan`` describes,
    from its share [n_local, L] of the padded corpus: with no host copy
    and no host sync on NCCL, so a captured step takes it (the split
    sizes are fixed in the plan)."""
    length = local_clips.shape[1]
    if not mesh.parallel:
        return local_clips[plan.send].reshape(*plan.shape, length)
    out = local_clips[plan.send].view(torch.uint8)
    dev = local_clips.device
    staged = dev.type != "cpu" and dist.get_backend(mesh.group) == "gloo"
    if staged:
        out = out.cpu()
    got = out.new_empty(sum(plan.n_recv), out.shape[1])
    dist.all_to_all_single(got, out, plan.n_recv, plan.n_send,
                           group=mesh.group)
    got = got.to(dev).view(local_clips.dtype)
    return got[plan.place].reshape(*plan.shape, length)


@dataclass(frozen=True)
class FixedPlan:
    """One step's exchange at fixed sizes (``plan_fixed``), the form a
    replayed CUDA graph takes: each rank sends every peer ``cap`` = V b
    rows, the most a peer can need from one owner, and receives ``cap``
    from each. ``send`` [dp cap] holds this rank's local rows for rank d
    at [d cap, d cap + n_d), in global order, the rest row 0 (never
    read); ``place`` [V b] the row of the received [dp cap] buffer that
    holds each of its positions, in order. With one rank ``send`` holds
    the global indices [V B] and nothing is exchanged."""

    send: torch.Tensor
    place: torch.Tensor | None
    shape: tuple[int, int]


def plan_fixed(idx, n_local: int, mesh: DataMesh,
               device: torch.device) -> FixedPlan:
    """The fixed-size plan of the global step's indices idx [V, B] (host
    arithmetic, ``gather_plan``'s; its index tensors copied to
    ``device``). With one rank the indices themselves, where they lie."""
    if not mesh.parallel:
        idx = torch.as_tensor(idx)
        return FixedPlan(idx.reshape(-1).to(device, torch.long), None,
                         tuple(idx.shape))
    idx = np.asarray(idx.cpu() if isinstance(idx, torch.Tensor) else idx)
    v, batch = idx.shape
    cap = v * (batch // mesh.dp)
    send, n_send, n_recv, place = gather_plan(idx, n_local, mesh)
    fixed = np.zeros(mesh.dp * cap, np.int64)
    starts = np.concatenate([[0], np.cumsum(n_send)])
    for d in range(mesh.dp):
        fixed[d * cap:d * cap + n_send[d]] = send[starts[d]:starts[d + 1]]
    # the received rows of owner o come j-th in its group: row o cap + j
    r_starts = np.concatenate([[0], np.cumsum(n_recv)])
    owner = np.searchsorted(r_starts, place, side="right") - 1
    at = owner * cap + place - r_starts[owner]
    return FixedPlan(torch.from_numpy(fixed).to(device),
                     torch.from_numpy(at).to(device),
                     (v, batch // mesh.dp))


def gather_fixed(local_clips: torch.Tensor, plan: FixedPlan,
                 mesh: DataMesh) -> torch.Tensor:
    """This rank's clips [V, b, L] of the step that ``plan`` describes: one
    all_to_all_single of dp cap rows (as bytes) with even splits, then
    the placement; every size fixed, so a replayed CUDA graph takes it.
    A copy, so it equals ``gather_planned`` to the bit."""
    length = local_clips.shape[1]
    if not mesh.parallel:
        return local_clips[plan.send].reshape(*plan.shape, length)
    out = local_clips[plan.send].view(torch.uint8)
    dev = local_clips.device
    if dev.type != "cpu" and dist.get_backend(mesh.group) == "gloo":
        out = out.cpu()
    got = torch.empty_like(out)
    dist.all_to_all_single(got, out, group=mesh.group)
    got = got.to(dev).view(local_clips.dtype)
    return got[plan.place].reshape(*plan.shape, length)


def exchange_bytes(plan: ShardPlan | FixedPlan, length: int) -> int:
    """The bytes this rank sends in a step's exchange of int16 rows of
    ``length`` samples (0 with one rank)."""
    if isinstance(plan, ShardPlan):
        rows = sum(plan.n_send)
    else:
        rows = plan.send.numel() if plan.place is not None else 0
    return rows * length * 2


def sharded_corpus_gather(local_clips: torch.Tensor, idx,
                          mesh: DataMesh) -> torch.Tensor:
    """This rank's share [n_local, L] int16 of the padded corpus and the
    global step's indices [V, B] -> this rank's clips [V, b, L]: the plan
    and the exchange in one call."""
    plan = plan_step(idx, local_clips.shape[0], mesh, local_clips.device)
    return gather_planned(local_clips, plan, mesh)


def wrap_sharded_corpus(inner: Callable, mesh: DataMesh) -> Callable:
    """(state, local_clips [n_local, L] int16 on the device, plan the
    step's FixedPlan (``plan_fixed`` of its global indices [V, B], made by
    the caller before the step), labels [V, B], draws=None) -> metrics:
    the step's clips gathered from their owners, this rank's rows of the
    labels, as the reference's ``wrap_device_corpus(inner, mesh,
    sharded=True)``; the caller picks the row of a resident index block
    (data.index_chunk)."""
    def step_fn(state, local_clips, plan, labels, draws=None):
        raw = gather_fixed(local_clips, plan, mesh)
        return inner(state, raw, labels[:, mesh.rows(labels.shape[1])],
                     draws)

    return step_fn
