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
                  it falls in
    pack          each owner copies the clips it owns, grouped by the
                  rank that needs them, in global order within a group
    all_to_all    one all_to_all_single of those rows as bytes (uint8),
                  uneven splits: each rank receives exactly its V b clips
    place         each rank puts the received rows in its [V, b] order

No arithmetic touches the samples: the reference reduce-scatters masked
partial sums, but NCCL has no 16-bit integer type, and a sum of int16 bit
patterns viewed as half could change NaN payloads. The exchange is a
copy, so it equals the replicated gather, and the host batcher's stream,
to the bit. Each rank sends and receives about V b store_len 2 bytes per
step, a 1/dp share of the step's clips. Over gloo (the CPU tests; two
ranks on one card) the exchange runs on host tensors: a CUDA buffer is
copied to the host and back. Under context or tensor parallelism the
exchange runs within each data group (the ranks of one cp or tp index):
the corpus is sharded over the data axis and replicated over cp and tp
(audiogan_tpu/parallel/sharded_corpus.py:38-45), so every rank of a
replica receives the replica's clips.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from audiogan_tpu_torch.data.corpus import index_row
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


def sharded_corpus_gather(local_clips: torch.Tensor, idx,
                          mesh: DataMesh) -> torch.Tensor:
    """This rank's share [n_local, L] int16 of the padded corpus and the
    global step's indices [V, B] -> this rank's clips [V, b, L]. With
    more than one rank ``idx`` lies on the host (the plan is host
    arithmetic); with one it may lie on the device."""
    n_local, length = local_clips.shape
    v, batch = idx.shape
    dev = local_clips.device
    if not mesh.parallel:
        flat = torch.as_tensor(idx).reshape(-1).to(dev, torch.long)
        return local_clips[flat].reshape(v, batch, length)
    send, n_send, n_recv, place = gather_plan(np.asarray(idx), n_local,
                                              mesh)
    out = local_clips[torch.from_numpy(send).to(dev)].view(torch.uint8)
    staged = dev.type != "cpu" and dist.get_backend(mesh.group) == "gloo"
    if staged:
        out = out.cpu()
    got = out.new_empty(int(n_recv.sum()), out.shape[1])
    dist.all_to_all_single(got, out, n_recv.tolist(), n_send.tolist(),
                           group=mesh.group)
    got = got.to(dev).view(local_clips.dtype)
    return got[torch.from_numpy(place).to(dev)].reshape(
        v, batch // mesh.dp, length)


def wrap_sharded_corpus(inner: Callable, mesh: DataMesh,
                        chunk: int = 0) -> Callable:
    """(state, local_clips [n_local, L] int16 on the device, idx [V, B]
    the global step's indices, labels [V, B], draws=None) -> metrics:
    the step's clips gathered from their owners, this rank's rows of the
    labels. With chunk > 0 idx and labels are blocks [chunk, V, B] and
    the step takes its row at state.step % chunk
    (data/corpus.py::index_row), as the reference's
    ``wrap_device_corpus(inner, mesh, sharded=True, chunk)``."""
    def step_fn(state, local_clips, idx, labels, draws=None):
        if chunk:
            idx, labels = index_row(state.step, idx, labels, chunk)
        raw = sharded_corpus_gather(local_clips, idx, mesh)
        return inner(state, raw, labels[:, mesh.rows(labels.shape[1])],
                     draws)

    return step_fn
