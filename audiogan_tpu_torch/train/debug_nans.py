"""train.debug_nans: stop at the first op of a step whose output holds a
NaN, the port of ``jax_debug_nans`` (audiogan_tpu/train/loop.py:188-189).

The reference's strategy: check cheaply, then localise by running again.
JAX checks each output of the jitted step and, on a NaN, runs the step
again op by op and raises ``FloatingPointError`` at the first primitive
whose output holds one. Here:

  check     after each step one device-side test of the step's metrics
            and the updated parameters for NaN, one sync (and, on more
            than one process, one all-reduce of the flag, so every rank
            takes the same branch);
  restore   on a NaN, the snapshot taken before the step
            (train/state.py::snapshot: parameters, Adam's moments and
            CPU counts, ``state.step``); the step's draws are a pure
            function of (seed, step), so they come back too;
  localise  the step again under ``NanCheck``: a TorchDispatchMode that
            tests the output of every aten op, and the kernel hook
            (kernels/hooks.py) that tests the output of every kernel of
            the port, which a ctypes launch writes where the mode cannot
            see it. A copy, cast, view, concatenation or pad passes a NaN
            along and is never named (it cannot make one); nor is an op
            that allocates without writing. The first op whose output
            holds a NaN is named with its model part (the spans of
            utils/profiling.py, from the Python stack in the forward and
            from anomaly mode's record of the forward stack on the
            autograd node in the backward) and whether it ran forward or
            backward;
  raise     on every rank after the localising step has finished and one
            all-reduce has told each rank that some rank saw a NaN, so no
            rank leaves a collective the others wait in. Each names its
            own op.

NaN only, not inf, as jax_debug_nans. Off, the loop takes no snapshot and
the kernel wrappers pay one global read (kernels/hooks.py).
"""

from __future__ import annotations

import traceback
import weakref
from typing import Callable

import torch
import torch.distributed as dist

from audiogan_tpu_torch.kernels import hooks
from audiogan_tpu_torch.parallel.mesh import world_rank, world_size
from audiogan_tpu_torch.train.state import TrainState, restore, snapshot
from audiogan_tpu_torch.utils.profiling import span_of_stack

aten = torch.ops.aten

# ops that allocate without writing: their output is garbage nobody reads
ALLOCATE = frozenset({aten.empty, aten.empty_like, aten.empty_strided,
                      aten.new_empty, aten.new_empty_strided})
# ops that pass their inputs' values along: a NaN in their output was in
# an input
PASS_ALONG = ALLOCATE | frozenset({
    aten._to_copy, aten.copy_, aten.clone, aten.contiguous, aten.cat,
    aten.stack, aten.index, aten.index_select, aten.gather,
    aten.constant_pad_nd, aten.flip, aten.detach, aten.lift_fresh,
    aten.slice_scatter, aten.select_scatter, aten.expand_copy,
    aten.split_with_sizes_copy, aten.unbind_copy, aten._foreach_copy_})


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _has_nan(tensors) -> bool:
    return any((t.is_floating_point() or t.is_complex())
               and t.numel() and bool(torch.isnan(t).any())
               for t in tensors)


def written_by(func, args, kwargs, out) -> list:
    """The op's outputs and the arguments it writes in place."""
    written = _tensors(out)
    schema = func._schema
    for i, arg in enumerate(schema.arguments):
        if arg.alias_info is None or not arg.alias_info.is_write:
            continue
        value = args[i] if i < len(args) else kwargs.get(arg.name)
        written += _tensors(value)
    return written


def _node_span(node) -> str | None:
    """The model part of an autograd node: from anomaly mode's record of
    the stack that made it, else from the node whose backward made it."""
    while node is not None:
        meta = node.metadata
        span = span_of_stack(meta.get("traceback_", ()))
        if span is not None:
            return span
        node = meta.get("parent_")
    return None


class NanCheck(hooks.KernelMode):
    """Records the first op (aten op or kernel of the port) whose output
    holds a NaN in ``first``; raises nothing. ``names`` maps a parameter's
    storage to its name, so the record names the parameters the op read;
    a live cast of a parameter inherits its name."""

    def __init__(self, names: dict[int, str]):
        super().__init__()
        self.names = dict(names)
        self.casts: dict = {}   # storage -> (weakref to the cast, name)
        self.first: dict | None = None
        self.inside = 0         # inside a kernel wrapper: its plain form

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.first is not None or self.inside:
            return out
        if func.overloadpacket in PASS_ALONG or func.is_view:
            if func.overloadpacket is aten._to_copy:
                self._alias(args[0], out)
            return out
        if _has_nan(written_by(func, args, kwargs, out)):
            self._record(func.name(), args)
        return out

    def kernel_call(self, name, fn, args, kwargs):
        self.inside += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self.inside -= 1
        if self.first is None and not self.inside \
                and _has_nan(_tensors(out)):
            self._record(f"{name} (a kernel of the port)", args)
        return out

    def _key(self, t):
        if not isinstance(t, torch.Tensor) or t.layout != torch.strided:
            return None
        return t.untyped_storage().data_ptr()

    def _name(self, t) -> str | None:
        key = self._key(t)
        cast = self.casts.get(key)
        if cast is not None and cast[0]() is not None:
            return cast[1]
        return self.names.get(key)

    def _alias(self, src, out) -> None:
        name = self._name(src)
        if name is not None and isinstance(out, torch.Tensor):
            self.casts[self._key(out)] = (weakref.ref(out), name)

    def _record(self, op: str, args) -> None:
        node = torch._C._current_autograd_node()
        if node is None:
            phase = "forward"
            part = span_of_stack(
                (f.filename, f.lineno) for f in traceback.extract_stack())
        else:
            phase = f"backward ({node.name()})"
            part = _node_span(node)
        reads = sorted({n for n in map(self._name, _tensors(args)) if n})
        self.first = {"op": op, "phase": phase, "part": part or "no model "
                      "part", "reads": reads}


def nan_check(state: TrainState) -> NanCheck:
    """A NanCheck that names both nets' parameters."""
    names = {}
    for net, module in (("G", state.g), ("D", state.d)):
        for n, p in module.named_parameters():
            names[p.untyped_storage().data_ptr()] = f"{net}.{n}"
    return NanCheck(names)


def _flag_all(flag: bool, device: torch.device) -> bool:
    """``flag`` or'ed over every process (one all-reduce)."""
    if world_size() == 1:
        return flag
    on = device if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([float(flag)], device=on)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


class NanGuard:
    """The loop's debug_nans: ``before`` each step, ``after`` it with the
    step's metrics and a callable that runs the same step again. Under
    replay ``after`` checks the replay's outputs; on a NaN the snapshot
    is restored in place (the graph keeps its addresses) and the step runs
    again eagerly under the check, as the reference's jax_debug_nans
    re-runs its jitted step op by op (audiogan_tpu/train/loop.py:188-189)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.snap: dict | None = None

    def before(self, state: TrainState) -> None:
        self.snap = snapshot(state)

    def after(self, state: TrainState, metrics: dict,
              rerun: Callable[[], dict]) -> None:
        tensors = [*metrics.values(), *state.g.parameters(),
                   *state.d.parameters()]
        bad = torch.stack([torch.isnan(t.detach()).any()
                           for t in tensors]).any()
        if not _flag_all(bool(bad), self.device):        # the one sync
            return
        step = self.snap["step"]
        restore(state, self.snap)
        check = nan_check(state)
        with torch.autograd.set_detect_anomaly(True, check_nan=False), \
                check:
            rerun()
        _flag_all(check.first is not None, self.device)
        rank = world_rank()
        f = check.first
        if f is None:
            raise FloatingPointError(
                f"debug_nans: NaN after step {step} (rank {rank}); this "
                "rank's run of the step again under the check made none "
                "(another rank's did)")
        reads = f", reading {', '.join(f['reads'])}" if f["reads"] else ""
        raise FloatingPointError(
            f"debug_nans: first NaN of step {step} (rank {rank}) in the "
            f"output of {f['op']} in {f["part"]}, {f["phase"]}{reads}")
