"""The mesh the port trains over, the counterpart of
audiogan_tpu/parallel/mesh.py: one process per card, ``dp * cp * tp``
processes, the data axis (``DataMesh``), the context-parallel axis
and the tensor-parallel axis (one ``AxisMesh`` each, named ``CpMesh`` and
``TpMesh`` by role); cp and tp do not combine (config.py's validate).

The reference builds its mesh as ``devices.reshape(dp, cp)``, or
``reshape(dp, 1, tp)`` with tp (audiogan_tpu/parallel/mesh.py:29-36),
so global rank r holds data index r // n and index r % n on the inner
axis, n = cp * tp; on several hosts the outer ('dcn') tier is the outer
part of the data axis (parallel/multihost.py), and a cp or tp group is
n consecutive ranks of one host. ``make_meshes`` builds one
``torch.distributed`` group per inner group and per data group (every
rank creates every group, in one order). With no inner axis the data
group is the default group.

The reference's DP at cp = tp = 1 is ONE global step that XLA partitions
over the batch: its loop jits the plain step with a replicated state and
batch-sharded inputs (audiogan_tpu/train/loop.py:203-213), so DP over N
devices equals the step on one device for the same global batch
(tests/parallel/test_dp.py:182). The port runs that step split by rows:
rank r takes rows [r B/dp, (r+1) B/dp) of the global batch and of every
draw, and after each backward the gradients are summed over the ranks in
one flat f32 buffer and divided by dp, so every rank runs Adam on the
global mean (train/step.py). Every collective here is one call on one
flat buffer, outside any kernel.

The collectives are deterministic for one world size: every rank gets
the same bits from an all-reduce (each chunk of the ring is reduced once
and then copied to every rank), and two runs at one world size reduce in
the same order (PERF.md states how far that was checked on the card).

ZeRO-1 (``mesh.fsdp``): each rank keeps Adam's moments only for its 1/dp
slice of the leading axis of every ``fsdp_shardable`` parameter, updates
that slice of the parameter, and the slices are all-gathered
(``gather_rows``; train/state.py::Adam). Adam is elementwise, so this
equals the replicated update to the bit (``zero1_update``).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any, Sequence

import torch
import torch.distributed as dist

from audiogan_tpu_torch.config import Config


def world_size() -> int:
    """Processes in the default group; before it is initialized, what
    torchrun announces (``WORLD_SIZE``), else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def world_rank() -> int:
    """This process's rank in the default group (0 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def check_world(cfg: Config) -> None:
    """The mesh's size against the processes (ValueError), as the
    reference's "mesh needs N devices" (audiogan_tpu/parallel/mesh.py:
    30-33): the port runs one process per device, so the world size must
    equal dp * cp * tp. A cp or tp group must not straddle two hosts
    (audiogan_tpu/parallel/multihost.py:39-44): under torchrun cp and tp
    must divide the processes per host."""
    m = cfg.mesh
    need, have = m.dp * m.cp * m.tp, world_size()
    if need != have:
        raise ValueError(
            f"mesh needs {need} devices (mesh.dp={m.dp}, mesh.cp={m.cp}, "
            f"mesh.tp={m.tp}), have {have} process"
            f"{'es' if have != 1 else ''}: launch `torchrun "
            f"--nproc_per_node {need} ...` or set mesh.dp, mesh.cp and "
            f"mesh.tp to multiply to {have}")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0"))
    for axis, n in (("cp", m.cp), ("tp", m.tp)):
        if n > 1 and local and local % n:
            raise ValueError(f"mesh.{axis}={n} does not divide the {local} "
                             f"processes per host: a {axis} group must "
                             "stay on one host")


@dataclass(frozen=True)
class DataMesh:
    """The data axis: ``dp`` ranks of ``group`` (None: the default
    group; no collective at dp = 1) and this process's ``rank`` on it,
    its data replica."""

    dp: int = 1
    rank: int = 0
    group: Any = None

    @property
    def parallel(self) -> bool:
        return self.dp > 1

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch."""
        b = batch // self.dp
        return slice(self.rank * b, (self.rank + 1) * b)

    def barrier(self) -> None:
        """A barrier of every process (both axes), where rank 0 writes
        files the others read."""
        if world_size() > 1:
            dist.barrier()

    def all_reduce_mean_(self, flat: torch.Tensor) -> torch.Tensor:
        """flat <- the mean over the ranks of flat, in place."""
        if self.parallel:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
            flat.div_(self.dp)
        return flat

    def mean_grads(self, params: Sequence[torch.Tensor]) -> None:
        """Every parameter's .grad <- its mean over the ranks: one flat f32
        all-reduce per call (one per net per update)."""
        if not self.parallel:
            return
        grads = [p.grad for p in params if p.grad is not None]
        flat = self.all_reduce_mean_(torch.cat([g.reshape(-1)
                                                for g in grads]))
        _unflatten_into(flat, grads)

    def mean_metrics(self, metrics: dict[str, torch.Tensor]
                     ) -> dict[str, torch.Tensor]:
        """Each 0-d metric's mean over the ranks (one all-reduce)."""
        if not self.parallel:
            return metrics
        keys = sorted(metrics)
        flat = self.all_reduce_mean_(torch.stack(
            [metrics[k].float() for k in keys]))
        return dict(zip(keys, flat.unbind()))

    def gather_rows(self, tensors: Sequence[torch.Tensor]) -> None:
        """Each tensor's leading axis is split in dp blocks of rows; this
        rank's block is current. Fills every other rank's block from its
        owner, in place: one all-gather of one flat buffer."""
        if not self.parallel or not tensors:
            return
        own = [t[self.shard(t)] for t in tensors]
        flat = torch.cat([t.reshape(-1) for t in own])
        out = [torch.empty_like(flat) for _ in range(self.dp)]
        dist.all_gather(out, flat, group=self.group)
        for r, buf in enumerate(out):
            if r != self.rank:
                mesh_r = dataclasses.replace(self, rank=r)
                _unflatten_into(buf, [t[mesh_r.shard(t)] for t in tensors])

    def shard(self, t: torch.Tensor) -> slice:
        """This rank's block of rows of t's leading axis."""
        return self.rows(t.shape[0])


def _unflatten_into(flat: torch.Tensor, tensors: Sequence[torch.Tensor]
                    ) -> None:
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def sum_grads(grads: Sequence[torch.Tensor], group, reduce: bool,
              dp: int) -> None:
    """grads <- their sum over ``group`` (when ``reduce``; None: every
    rank) divided by dp, in one flat buffer: the cp and tp steps'
    gradient reductions (train/cp_step.py, train/tp_step.py)."""
    if not grads or (not reduce and dp == 1):
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    if reduce:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    if dp > 1:
        flat.div_(dp)
    _unflatten_into(flat, grads)


@dataclass(frozen=True)
class AxisMesh:
    """One inner axis (cp or tp) of one data replica: ``size`` ranks of
    ``group`` (None: the default group; no collective at size 1), and
    this process's ``index`` on it. Under cp each rank holds one
    contiguous time slice of every clip (parallel/halo.py); under tp it
    computes one 1/size slice of the critic's channels (parallel/tp.py).
    """

    size: int = 1
    index: int = 0
    group: Any = None

    @property
    def parallel(self) -> bool:
        return self.size > 1


# the axis by its role, where a signature names it
CpMesh = TpMesh = AxisMesh


# (default group, dp, n) -> (this rank's data group, its inner group)
_GROUPS: dict = {}


def _axis_groups(dp: int, n: int) -> tuple[Any, Any]:
    """This rank's data group and inner (cp or tp) group of the (dp, n)
    mesh over the default group (None where an axis is the whole
    world). Every rank creates every group, in one order; the groups are
    made once per process group."""
    if n == 1 or dp == 1:
        return None, None
    key = (dist.group.WORLD, dp, n)
    if key not in _GROUPS:
        rank = dist.get_rank()
        mine = [None, None]
        for d in range(dp):
            g = dist.new_group(list(range(d * n, (d + 1) * n)))
            if rank // n == d:
                mine[1] = g
        for c in range(n):
            g = dist.new_group(list(range(c, dp * n, n)))
            if rank % n == c:
                mine[0] = g
        _GROUPS[key] = tuple(mine)
    return _GROUPS[key]


def make_meshes(cfg: Config) -> tuple[DataMesh, CpMesh, TpMesh]:
    """The three axes of cfg.mesh over the initialized process group (or
    one process). Raises before any device is touched when the mesh asks
    for another number of processes (``check_world``)."""
    check_world(cfg)
    dp, cp, tp = cfg.mesh.dp, cfg.mesh.cp, cfg.mesh.tp
    n = cp * tp
    if dp * n == 1:
        return DataMesh(), CpMesh(), TpMesh()
    rank = dist.get_rank()
    data_group, inner = _axis_groups(dp, n)
    return (DataMesh(dp, rank // n, data_group),
            CpMesh(cp, rank % n, inner) if cp > 1 else CpMesh(),
            TpMesh(tp, rank % n, inner) if tp > 1 else TpMesh())


def make_mesh(cfg: Config) -> DataMesh:
    """The data axis of cfg.mesh (``make_meshes``)."""
    return make_meshes(cfg)[0]


def fsdp_shardable(x: torch.Tensor, dp: int) -> bool:
    """Leading-axis divisibility rule for ZeRO-1 optimizer-state sharding
    (audiogan_tpu/parallel/mesh.py:65-71). The port's parameters keep the
    reference's layouts, so the same leaves shard."""
    return x.dim() >= 1 and x.shape[0] >= dp and x.shape[0] % dp == 0


def zero1_rows(p: torch.Tensor, mesh: DataMesh | None) -> slice:
    """The rows of p whose Adam state this rank keeps under ZeRO-1: its
    block of a shardable parameter, else all of them."""
    if mesh is None or not mesh.parallel or not fsdp_shardable(p, mesh.dp):
        return slice(None)
    return mesh.shard(p)


def zero1_update(update, params: Sequence[torch.Tensor],
                 mesh: DataMesh | None) -> None:
    """The counterpart of audiogan_tpu/parallel/mesh.py:74-112 outside a
    shard_map: ``update(views)`` runs the optimizer on each parameter's
    ``zero1_rows`` (views into the parameters, updated in place); then
    the shardable parameters' blocks are all-gathered, so every rank ends
    with the whole updated parameters. Without a mesh it is the
    replicated update."""
    if mesh is None or not mesh.parallel:
        update(params)
        return
    update([p[zero1_rows(p, mesh)] for p in params])
    mesh.gather_rows([p for p in params if fsdp_shardable(p, mesh.dp)])


class _GlobalMean(torch.autograd.Function):
    """Forward: the mean over the ranks (each holds the mean of its rows,
    so this is the mean over the global batch). Backward: the incoming
    gradient unchanged. Whatever is computed from the result is the same
    on every rank, so each rank's incoming gradient g is the same; the
    step averages the ranks' parameter gradients afterwards, so each rank
    must contribute dp times its share g/dp of the global gradient: g.
    The Jacobian's g/dp would leave the term dp times too small."""

    @staticmethod
    def forward(ctx, x, mesh):
        out = x.detach().clone().contiguous()
        return mesh.all_reduce_mean_(out)

    @staticmethod
    def backward(ctx, g):
        return g, None


def global_mean(x: torch.Tensor, mesh: DataMesh | None) -> torch.Tensor:
    """x (a mean over this rank's rows) -> the mean over the global
    batch, differentiable (``_GlobalMean``); x itself at dp = 1."""
    if mesh is None or not mesh.parallel:
        return x
    return _GlobalMean.apply(x, mesh)
