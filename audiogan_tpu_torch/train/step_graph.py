"""The training step as one CUDA graph: the loop's replayed step
(``StepGraph``), the port's counterpart of the reference's one jit'd step
(audiogan_tpu/train/loop.py:203-213, 314-318), and train.dump_hlo
(``dump_step``), the counterpart of its one optimized HLO module
(audiogan_tpu/train/loop.py:247-261: "the WHOLE training step (ingest +
n_critic scan + GP double-backprop + both optimizers) is one optimized
HLO module").

``StepGraph`` holds a step's inputs in fixed buffers and runs the step
on them eagerly, or captures it once and replays it (its docstring);
train/loop.py trains every step after the first by replay, and
``dump_step`` uses the same object on a copy of the state.

``dump_step`` runs before the loop's first step, on the data path the
loop uses, and never moves the loop's state: it works on
``copy.deepcopy`` of the state (modules and optimizers together).

On the card:
  inputs    the step's inputs, its draws (utils/prng.py makes a fresh
            generator per (seed, step, role), which a capture can neither
            create nor replay) and both Adams' scalars go into fixed
            buffers first (``StepGraph.fill``, ``stage``); a host tensor
            among the inputs (the labels of the host batcher's path, the
            indices at data.index_chunk=0) through pinned memory, and
            the header says which.
  warm-up   one eager step on a side stream, from a snapshot of the copy
            (train/state.py::snapshot): it builds every cache a step
            makes at first use (the kernels' libraries, K4/K5's device
            plans, the STFT bases, cuDNN's plans), so the capture makes
            none. Its result is the eager step the replay is held to.
  capture   the copy restored to the snapshot, then one step under
            ``torch.cuda.graph`` in debug mode, on the calling thread as
            every step (train/step.py). Nothing of the step's own
            (seed, step) is baked in: the row of an index block, the
            draws and Adam's bias corrections are read from the fixed
            buffers; what the step's Python does on the host (its step
            count, Adam's CPU counts) is put back after the capture and
            done again after each replay. The tensor-core convs' TMA
            tensor maps (csrc/igemm_tc.cuh) are encoded on the host with
            the operands' addresses and frozen into their nodes'
            parameters, which is right only because a graph's addresses
            are fixed. While the capture runs, each kernel call of the
            port (kernels/hooks.py) notes the nodes its launch added to
            the graph, and the last op and kernel call are kept: a
            capture that fails raises naming them.
  replay    the copy restored to the snapshot again, the graph replayed
            once; its parameters, both Adams' moments and the metrics are
            held to the warm-up's to the bit (the header reports each
            tensor that differs).
  files     ``step_cuda_graph.dot`` (``CUDAGraph.debug_dump``) and
            ``step_graph.txt``: a header (counts by kind, by kernel name
            and by kernel of the port, the capture's seconds, the replay
            check) and one line per node in capture order (kind, kernel
            name, grid and block, the port kernel that launched it).

On the CPU there is no CUDA graph: ``step_graph.txt`` has the same header
and one line per aten op that one step dispatched (a TorchDispatchMode
over the step on the copy); the kernels' plain forms are torch ops, so it
sees everything, and each op inside a kernel call of the port names it.
A c10d collective is an op of its own ("collective" lines).

On a multi-process mesh the counterpart of the reference's one SPMD
module, whose collectives every process lowers together
(audiogan_tpu/train/loop.py:247-261), is the set of every rank's graph:
  warm-up   every rank's eager step, its collectives run for real; it
            also builds the NCCL communicators. A rank that fails here
            raises at once, naming itself: its peers wait in a
            collective it never joins, so no agreement can be reached.
            Under torchrun its exit ends them; else the group's timeout
            does (parallel/multihost.py).
  capture   every rank captures its step; NCCL's kernels are recorded,
            not run, with this thread's capture errors only (NCCL's
            watchdog thread queries its events meanwhile). Each
            collective notes its nodes as a kernel call does.
  agree     before any rank replays (a replay waits on its peers' NCCL
            kernels), an all-reduce of an ok flag over a gloo twin of
            the group, outside any capture; if any rank failed, every
            rank raises, naming each failed rank and its last op and
            kernel call.
  replay    every rank replays once, held to its own warm-up to the bit
            (ZeRO-1's moments are the rank's blocks).
  files     rank 0 writes its own graph; the header lists every rank's
            node counts by kind, NCCL kernel nodes and calls by
            collective and replay result, gathered over the gloo twin.
            Ranks whose collectives differ raise, every one; their other counts may differ under
            cp (an edge rank fills the zeros a neighbour would send).
A gloo group on CUDA tensors stages its collectives through the host,
which no capture takes: train/loop.py::check_ported raises for it before
the card is touched, naming NCCL. On the CPU the ranks agree and gather
in the same way around their op lists; a rank whose step fails raises at
once, as in the warm-up, and its peers raise at the collective it left.
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses
import gc
import json
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path
from typing import Callable

import torch
import torch.distributed as dist

from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.kernels import hooks
from audiogan_tpu_torch.parallel.mesh import world_rank, world_size
from audiogan_tpu_torch.parallel.sharded_corpus import FixedPlan
from audiogan_tpu_torch.train.state import (TrainState, restore, snapshot,
                                            state_tensors)
from audiogan_tpu_torch.train.step import step_draws

GRAPH_FILE = "step_graph.txt"
DOT_FILE = "step_cuda_graph.dot"

# CUgraphNodeType
NODE_KINDS = ("kernel", "memcpy", "memset", "host", "graph", "empty",
              "wait_event", "event_record", "ext_semas_signal",
              "ext_semas_wait", "mem_alloc", "mem_free", "batch_mem_op",
              "conditional")

class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2."""
    _fields_ = [("func", ctypes.c_void_p),
                ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_mem", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


class _Driver:
    """The few CUDA driver calls that read a graph under capture."""

    def __init__(self):
        self.lib = ctypes.CDLL("libcuda.so.1")
        ptr, out = ctypes.c_void_p, ctypes.c_void_p   # handles; out-pointers
        for name, args in (
                ("cuStreamGetCaptureInfo_v2", [ptr] + [out] * 5),
                ("cuGraphGetNodes", [ptr, out, out]),
                ("cuGraphNodeGetType", [ptr, out]),
                ("cuGraphKernelNodeGetParams_v2", [ptr, out]),
                ("cuFuncGetName", [out, ptr]),
                ("cuKernelGetName", [out, ptr])):
            fn = getattr(self.lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int

    def _call(self, name: str, *args) -> None:
        err = getattr(self.lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name} failed: CUresult {err}")

    def capturing_graph(self, stream: int) -> int:
        """The graph a stream is capturing into."""
        status, graph = ctypes.c_int(), ctypes.c_void_p()
        self._call("cuStreamGetCaptureInfo_v2", stream,
                   ctypes.byref(status), None, ctypes.byref(graph), None,
                   None)
        if status.value != 1:                 # CU_STREAM_CAPTURE_STATUS_ACTIVE
            raise RuntimeError(f"stream is not capturing (status "
                               f"{status.value})")
        return graph.value

    def nodes(self, graph: int) -> list[int]:
        n = ctypes.c_size_t()
        self._call("cuGraphGetNodes", graph, None, ctypes.byref(n))
        if n.value == 0:
            # nothing captured yet (a step whose first op is a kernel
            # call): cuGraphGetNodes refuses an array for no nodes
            return []
        out = (ctypes.c_void_p * n.value)()
        self._call("cuGraphGetNodes", graph, out, ctypes.byref(n))
        return [int(v or 0) for v in out[:n.value]]

    def describe(self, node: int) -> dict:
        kind = ctypes.c_int()
        self._call("cuGraphNodeGetType", node, ctypes.byref(kind))
        rec = {"kind": (NODE_KINDS[kind.value] if kind.value
                        < len(NODE_KINDS) else f"type {kind.value}")}
        if kind.value != 0:
            return rec
        p = _KernelNodeParams()
        self._call("cuGraphKernelNodeGetParams_v2", node, ctypes.byref(p))
        name = ctypes.c_char_p()
        if p.func:
            self._call("cuFuncGetName", ctypes.byref(name), p.func)
        else:
            self._call("cuKernelGetName", ctypes.byref(name), p.kern)
        rec.update(name=name.value.decode(), grid=tuple(p.grid),
                   block=tuple(p.block))
        return rec


def _demangle(names: list[str]) -> dict[str, str]:
    """Mangled -> readable, through c++filt where the toolchain has it."""
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout
    return dict(zip(names, out.splitlines()))


# c10d ops by the collective they issue
_C10D = (("allreduce", "all_reduce"), ("allgather", "all_gather"),
         ("alltoall", "all_to_all"), ("reduce_scatter", "reduce_scatter"),
         ("broadcast", "broadcast"), ("barrier", "barrier"))


def collective_kind(op: str) -> str | None:
    """The collective a dispatched op issues ("all_reduce", ...), or None
    for an op that is not a c10d collective."""
    if not op.startswith("c10d."):
        return None
    return next((kind for key, kind in _C10D if key in op), op)


class _Watch(hooks.KernelMode):
    """Over one step: the aten ops in order (``ops``: name and the port
    kernel whose plain form ran it, or None), every kernel call of the
    port (``calls``: name, and with ``on_call``, which lists the graph's
    nodes, the nodes the call added) and every collective (``collectives``:
    its kind and, with ``on_call``, its nodes). Keeps the last op and call
    for a failure (``failed_at``)."""

    def __init__(self, record_ops: bool,
                 on_call: Callable[[], list] | None = None):
        super().__init__()
        self.record_ops, self.on_call = record_ops, on_call
        self.ops: list = []
        self.calls: list = []
        self.collectives: list = []
        self.kernel: str | None = None
        self.last = "nothing yet"
        self.last_call: str | None = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        kind = collective_kind(name)
        self.last = (f"collective {name}" if kind else f"aten op {name}") \
            + (f" inside {self.kernel}" if self.kernel else "")
        if self.record_ops:
            self.ops.append((name, self.kernel))
        if kind is None:
            return func(*args, **(kwargs or {}))
        before = self.on_call() if self.on_call else ()
        out = func(*args, **(kwargs or {}))
        added = set(self.on_call()) - set(before) if self.on_call else set()
        self.collectives.append((kind, added))
        return out

    def kernel_call(self, name, fn, args, kwargs):
        outer, self.kernel = self.kernel, self.kernel or name
        self.last = f"the launch of {name}"
        self.last_call = name
        before = self.on_call() if self.on_call and outer is None else ()
        try:
            out = fn(*args, **kwargs)
        finally:
            self.kernel = outer
        if outer is None:
            added = (set(self.on_call()) - set(before) if self.on_call
                     else set())
            self.calls.append((name, added))
        return out

    def failed_at(self) -> str:
        """Where a run under the watch stopped: its last op or launch, and
        the last kernel call of the port it began."""
        return (f"{self.last} (the last kernel call: "
                f"{self.last_call or 'none'})")


def _static(x, dev: torch.device):
    """A fixed buffer of ``x``'s form on ``dev``: each tensor an empty one
    of its shape and dtype, each container and dataclass (a FixedPlan)
    rebuilt around them, anything else kept (it must not change)."""
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device=dev)
    if isinstance(x, dict):
        return {k: _static(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_static(v, dev) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _static(getattr(x, f.name), dev)
            for f in dataclasses.fields(x)})
    return x


def _fill(static, x, where: str) -> list[str]:
    """Copies ``x`` into ``static`` (``_static``'s form of it), on the
    current stream: from pinned memory when it lies on the host, so no
    copy waits for the card. Returns a note of each host tensor copied;
    raises if ``x``'s form differs (a captured graph's shapes and its
    other arguments are fixed)."""
    if isinstance(static, torch.Tensor):
        if not isinstance(x, torch.Tensor) or x.shape != static.shape \
                or x.dtype != static.dtype:
            raise ValueError(f"{where}: {_form(x)} where the fixed buffer "
                             f"is {_form(static)}")
        if x is static:
            return []
        host = x.device.type == "cpu" and static.device.type == "cuda"
        static.copy_(x.pin_memory() if host else x, non_blocking=True)
        return [f"{where} {x.dtype} {list(x.shape)}"] if host else []
    if isinstance(static, dict):
        if not isinstance(x, dict) or x.keys() != static.keys():
            raise ValueError(f"{where}: other keys than the step's")
        return [n for k in static for n in _fill(static[k], x[k],
                                                  f"{where}.{k}")]
    if isinstance(static, (list, tuple)):
        if not isinstance(x, (list, tuple)) or len(x) != len(static):
            raise ValueError(f"{where}: another length than the step's")
        return [n for i, (s, v) in enumerate(zip(static, x))
                for n in _fill(s, v, f"{where}[{i}]")]
    if dataclasses.is_dataclass(static):
        if type(x) is not type(static):
            raise ValueError(f"{where}: a {type(x).__name__} where the "
                             f"step has a {type(static).__name__}")
        return [n for f in dataclasses.fields(static)
                for n in _fill(getattr(static, f.name), getattr(x, f.name),
                               f"{where}.{f.name}")]
    if x != static:
        raise ValueError(f"{where}: {x!r} where the step was built with "
                         f"{static!r}")
    return []


def _form(x) -> str:
    if isinstance(x, torch.Tensor):
        return f"{x.dtype} {list(x.shape)}"
    return type(x).__name__


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().contiguous()
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(ints[t.element_size()])


def differing(got: dict, want: dict) -> list[str]:
    """Names of the tensors of two dicts that differ in any bit."""
    return [k for k in want
            if k not in got or got[k].shape != want[k].shape
            or not torch.equal(_bits(got[k]), _bits(want[k]))]


def _outcome(state: TrainState, metrics: dict) -> dict:
    return {**{k: v.detach().clone() for k, v in state_tensors(state).items()},
            **{f"metrics/{k}": v.detach().clone()
               for k, v in metrics.items()}}


def _header(title: str, summary: dict, by_name: Counter,
            what: str) -> list[str]:
    lines = [f"# {title}", f"# summary {json.dumps(summary)}",
             f"# counts by {what} name:"]
    lines += [f"#   {n:6d}  {name}" for name, n in by_name.most_common()]
    return lines


def _capture(fn: Callable, dev: torch.device, parallel: bool, what: str,
             stream: torch.cuda.Stream | None = None):
    """(graph, its node records, the kernel calls with their nodes, the
    collectives with their nodes, what ``fn()`` returned (its static
    tensors), capture seconds) of one call of ``fn`` under
    ``torch.cuda.graph`` on ``stream`` (torch's capture stream if None).
    A failure raises naming ``what`` and the last op and kernel call. On a
    mesh the capture's errors are this thread's own (``thread_local``):
    NCCL's watchdog thread queries its events meanwhile."""
    drv = _Driver()
    # keep_graph: the cudaGraph_t outlives the capture, for debug_dump
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    nodes: list = []

    def listed() -> list:
        return drv.nodes(drv.capturing_graph(
            torch.cuda.current_stream(dev).cuda_stream))

    watch = _Watch(record_ops=False, on_call=listed)
    mode = "thread_local" if parallel else "global"
    # garbage, a dead graph among it (a sampler's, a step's), is freed
    # now and not by the collector inside the capture: a graph's
    # destructor frees its pool and handles, calls that break a capture
    # they fall in
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    t0 = time.perf_counter()
    try:
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode=mode), watch:
            out = fn()
            g = drv.capturing_graph(torch.cuda.current_stream(dev).cuda_stream)
            nodes = [dict(drv.describe(n), handle=n) for n in drv.nodes(g)]
    except Exception as err:
        raise RuntimeError(f"capture of {what} failed at "
                           f"{watch.failed_at()}: {err}") from err
    finally:
        if collecting:
            gc.enable()
    torch.cuda.synchronize(dev)
    return (graph, nodes, watch.calls, watch.collectives, out,
            time.perf_counter() - t0)


def take_back_launches(before: dict) -> dict:
    """The launches the port's wrappers counted since ``before`` (of
    ``hooks.launch_counts``' form), taken back off the counters: a capture
    launches nothing, and each replay adds them again."""
    now = hooks.launch_counts()
    delta = {k: v - before.get(k, 0) for k, v in now.items()
             if v != before.get(k, 0)}
    hooks.add_launches({k: -v for k, v in delta.items()})
    return delta


def port_kernels(nodes: list, calls: list) -> dict:
    """By port kernel: its calls in a capture, its own kernel nodes and
    any other nodes its calls added (``_capture``'s nodes and calls)."""
    by_handle = {n["handle"]: n for n in nodes}
    port: dict[str, dict] = {}
    for name, added in calls:
        rec = port.setdefault(name, {"calls": 0, "kernel_nodes": 0,
                                     "other_nodes": 0})
        rec["calls"] += 1
        own = hooks.kernel_of(name).functions
        for h in added:
            n = by_handle[h]
            mine = n["kind"] == "kernel" and any(
                f in n.get("name", "") for f in own)
            rec["kernel_nodes" if mine else "other_nodes"] += 1
    return port


def check_kernel_nodes(port: dict, delta: dict, what: str) -> None:
    """Raises unless each port kernel of a capture owns one kernel node per
    launch it counted (``delta``, ``take_back_launches``' form), so the
    counts a replay adds are its kernel nodes. A launch of K4's or K5's
    host loop (``launches_loop``: f32, or B > 64) is the loop's own
    kernels, captured as they are, none of them the scan's: it owns no
    node, and its calls must have added others."""
    for name, rec in port.items():
        wrapper = name.split()[-1]
        loop = delta.get((wrapper, "launches_loop"), 0)
        counted = delta.get((wrapper, "launches"), 0) - loop
        if rec["kernel_nodes"] != counted or (loop and not
                                              rec["other_nodes"]):
            raise RuntimeError(f"{what} holds {rec['kernel_nodes']} kernel "
                               f"nodes of {name} ({rec['other_nodes']} "
                               f"others) for {counted} launches ({loop} on "
                               f"the host loop)")


# the default group's gloo twin, for the dump's own agreement (never NCCL:
# a capture that failed half way leaves NCCL's stream of work uneven)
_CONTROL: dict = {}


def _control_group():
    if dist.get_backend() == "gloo":
        return None
    key = dist.group.WORLD
    if key not in _CONTROL:
        _CONTROL[key] = dist.new_group(backend="gloo")
    return _CONTROL[key]


def _all_gather(obj) -> list:
    """Every rank's ``obj`` (itself alone on one process), eagerly over the
    control group."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj, group=_control_group())
    return out


def _agree(failure: str | None) -> None:
    """Raises on every rank when any rank failed (``failure`` its
    message): an all-reduce of an ok flag, then the failures by rank."""
    if world_size() == 1:
        if failure:
            raise RuntimeError(failure)
        return
    ok = torch.tensor([0 if failure else 1], dtype=torch.int32)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=_control_group())
    if ok.item():
        return
    bad = [f"rank {r}: {m}" for r, m in enumerate(_all_gather(failure))
           if m]
    raise RuntimeError(f"train.dump_hlo failed on {len(bad)} of "
                       f"{world_size()} ranks (rank {world_rank()} raises "
                       "with them): " + "; ".join(bad))


def _step_failed(where: str, last: str | None,
                 err: Exception) -> RuntimeError:
    """The error of a rank whose eager run of the step failed. Its peers
    may wait in a collective of the step that this rank never joins, so
    no agreement can be reached (over the default gloo group it would
    meet their collective, a mismatch that aborts the process): this rank
    raises at once, naming itself, and its peers end at that collective
    (gloo's lost connection; on NCCL torchrun's teardown or the group's
    timeout, parallel/multihost.py)."""
    at = f" at {last}" if last else ""
    return RuntimeError(f"train.dump_hlo: the step failed on rank "
                        f"{world_rank()} of {world_size()} in {where}{at}: "
                        f"{err!r}")


def _check_spmd(ranks: list[dict]) -> bool:
    """Raises unless every rank issues the same collectives (and, on the
    card, the same NCCL kernel nodes): the condition of one SPMD step.
    Returns whether the ranks' op or node counts by kind agree too; under
    cp they need not (an edge rank fills the zeros its missing neighbour
    would send, where the others take a view)."""
    for key in ("collectives", "nccl_kernel_nodes"):
        vals = [r.get(key) for r in ranks]
        if any(v != vals[0] for v in vals):
            raise RuntimeError(f"train.dump_hlo: the ranks' {key} differ: "
                               + "; ".join(f"rank {i} {v}"
                                           for i, v in enumerate(vals)))
    counts = [(r.get("ops"), r.get("by_kind")) for r in ranks]
    return all(c == counts[0] for c in counts)


def _rank_lines(ranks: list[dict]) -> list[str]:
    keep = ("nodes", "by_kind", "ops", "collectives", "nccl_kernel_nodes",
            "capture_seconds", "replay_equals_eager", "replay_differs_in")
    return [f"# rank {i} " + json.dumps({k: r[k] for k in keep if k in r})
            for i, r in enumerate(ranks)]


def _collective_counts(collectives: list, nodes_by_handle: dict | None
                       ) -> tuple[dict, dict]:
    """(calls by kind, NCCL kernel nodes by kind) of a step's
    collectives."""
    calls = dict(Counter(kind for kind, _ in collectives))
    nccl: Counter = Counter()
    for kind, added in collectives:
        for h in added:
            n = (nodes_by_handle or {}).get(h, {})
            if n.get("kind") == "kernel" and "nccl" in n.get("name", ""):
                nccl[kind] += 1
    return calls, dict(nccl)


def _count_tensors(state: TrainState) -> list[torch.Tensor]:
    """Both Adams' CPU counts, one per parameter with state."""
    return [st["step"] for opt in (state.opt_g, state.opt_d)
            for p in opt._params() if (st := opt.state.get(p))]


def _advance(state: TrainState, counts: list, delta: list) -> None:
    """Adds ``delta`` (the step's, then one per count) to the step and the
    counts, in place."""
    state.step += int(delta[0])
    for t, d in zip(counts, delta[1:]):
        if d:
            t.add_(d)


class StepGraph:
    """The training step as the loop runs it: its inputs in fixed
    buffers, run eagerly or captured once as one CUDA graph and replayed,
    the port's counterpart of the reference's one jit'd step
    (audiogan_tpu/train/loop.py:203-213, 314-318).

    ``fill(state, args)`` copies a step's inputs (the data path's
    arguments; ``resident`` names those, such as the resident corpus,
    that are the same tensor every step and are used in place) and its
    draws (train/step.py::step_draws of (seed, state.step): a capture can
    neither create nor replay utils/prng.py's fresh generators) into
    fixed buffers, on the current stream; a host tensor goes through
    pinned memory. ``stage`` writes both Adams' scalars of the step into
    their slots (train/state.py::Adam.stage). ``body`` is the step on
    the fixed buffers; ``eager`` stages, then runs it.

    ``capture`` runs ``body`` under ``torch.cuda.graph`` (``_capture``:
    each kernel call of the port notes its nodes through
    kernels/hooks.py, a failure names the last op and kernel call; on a
    mesh every rank captures, and they agree over a gloo twin of the
    group before any replays). The capture changes nothing on the device,
    so it puts back what the step's Python did on the host (state.step,
    both Adams' counts: ``host_delta``) and the port kernels' launch
    counts (``launch_delta``); ``replay`` stages, replays the graph, then
    applies both, so a replayed step leaves the state and the counts as
    the eager step does. The graph's metrics are fixed buffers: read them
    before the next replay. Every port kernel must own one kernel node
    per counted launch, so the counts a replay adds are its kernel nodes.
    A state's step must have been run once (``eager``) before a capture:
    that step builds every cache and Adam's moments (``dump_step``
    captures a step that makes them, its eager warm-up run before)."""

    def __init__(self, cfg: Config, step_fn: Callable, device,
                 resident: tuple = ()):
        self.cfg, self.step_fn = cfg, step_fn
        self.device = torch.device(device)
        self.resident = frozenset(resident)
        self.args: tuple | None = None
        self.draws = None
        self.copied: list[str] = []
        self.graph = None
        self.metrics: dict | None = None
        self.nodes: list = []
        self.calls: list = []
        self.collectives: list = []
        self.capture_seconds = 0.0
        self.host_delta: list | None = None
        self.launch_delta: dict = {}
        self.replays = 0

    def fill(self, state: TrainState, args: tuple) -> None:
        cfg = self.cfg
        draws = step_draws(cfg, state.seed, state.step, self.device,
                           world_rank() // (cfg.mesh.cp * cfg.mesh.tp))
        if self.args is None:
            self.args = tuple(a if i in self.resident
                              else _static(a, self.device)
                              for i, a in enumerate(args))
            self.draws = _static(draws, self.device)
        if len(args) != len(self.args):
            raise ValueError(f"{len(args)} inputs for a step of "
                             f"{len(self.args)}")
        copied = []
        for i, (fixed, a) in enumerate(zip(self.args, args)):
            if i not in self.resident:
                copied += _fill(fixed, a, f"input {i}")
            elif a is not fixed:
                raise ValueError(f"input {i} is resident: every step takes "
                                 "the same tensor")
        _fill(self.draws, draws, "draws")
        self.copied = copied

    def stage(self, state: TrainState) -> None:
        state.opt_d.stage(self.cfg.loss.n_critic)
        state.opt_g.stage(1)

    def body(self, state: TrainState) -> dict:
        return self.step_fn(state, *self.args, draws=self.draws)

    def eager(self, state: TrainState) -> dict:
        self.stage(state)
        return self.body(state)

    def capture(self, state: TrainState) -> None:
        self.stage(state)
        step = state.step
        held = {id(t): float(t) for t in _count_tensors(state)}
        launches = hooks.launch_counts()
        failure = None
        try:
            (self.graph, self.nodes, self.calls, self.collectives,
             self.metrics, self.capture_seconds) = _capture(
                 lambda: self.step_fn(state, *self.args, draws=self.draws),
                 self.device, world_size() > 1, "the training step")
        except Exception as err:
            failure = str(err)
        # no rank replays alone: a replay waits on its peers' NCCL kernels
        _agree(failure)
        # a state Adam made in the capture (a dump at a run's first step)
        # counts from 0
        counts = _count_tensors(state)
        self.host_delta = [state.step - step, *(float(t) - held.get(id(t), 0.0)
                                                for t in counts)]
        _advance(state, counts, [-d for d in self.host_delta])
        self.launch_delta = take_back_launches(launches)
        check_kernel_nodes(self.port_kernels(), self.launch_delta,
                           "the captured step")

    def replay(self, state: TrainState) -> dict:
        self.stage(state)
        self.graph.replay()
        state.opt_d.release()
        state.opt_g.release()
        counts = _count_tensors(state)
        if len(counts) != len(self.host_delta) - 1:
            raise RuntimeError("Adam's state changed since the capture")
        _advance(state, counts, self.host_delta)
        hooks.add_launches(self.launch_delta)
        self.replays += 1
        return self.metrics

    def port_kernels(self) -> dict:
        """By port kernel: its calls in the capture, its own kernel nodes
        and any other nodes its calls added."""
        return port_kernels(self.nodes, self.calls)

    def summary(self) -> dict:
        """The capture's nodes by kind, port kernels, collectives and
        seconds."""
        by_handle = {n["handle"]: n for n in self.nodes}
        calls, nccl = _collective_counts(self.collectives, by_handle)
        return {"kind": "CUDA graph", "nodes": len(self.nodes),
                "by_kind": dict(Counter(n["kind"] for n in self.nodes)),
                "port_kernels": self.port_kernels(), "collectives": calls,
                "nccl_kernel_nodes": nccl,
                "capture_seconds": self.capture_seconds}


def dump_step(cfg: Config, state: TrainState, step_fn: Callable,
              args: tuple, workdir: Path, device: torch.device,
              say: Callable[[str], None] = print) -> dict:
    """Dumps the step ``step_fn(state, *args, draws=...)`` would run now
    into ``workdir`` (the module docstring); returns this rank's summary
    (rank 0's heads step_graph.txt, with every rank's under "ranks").
    ``state`` does not move. On a mesh every rank calls it."""
    workdir = Path(workdir)
    rank = world_rank()
    work = copy.deepcopy(state)
    runner = StepGraph(cfg, step_fn, device)
    sharded = any(isinstance(a, FixedPlan) for a in args)
    title = (f"one training step of {cfg.name} at step {state.step}, "
             f"batch {cfg.train.batch_size}, {cfg.train.dtype}, on "
             f"{device}, mesh dp={cfg.mesh.dp} cp={cfg.mesh.cp} "
             f"tp={cfg.mesh.tp}" + (" fsdp" if cfg.mesh.fsdp else "")
             + (" (sharded corpus)" if sharded else ""))
    runner.fill(work, args)
    if device.type != "cuda":
        runner.stage(work)
        watch = _Watch(record_ops=True)
        failure = step_error = None
        try:
            with watch:
                try:
                    runner.body(work)
                except Exception as err:
                    step_error = err
        except Exception as err:
            failure = f"the step's record failed at {watch.last}: {err!r}"
        if step_error is not None:
            raise _step_failed("its step", watch.last, step_error) \
                from step_error
        _agree(failure)
        calls, _ = _collective_counts(watch.collectives, None)
        summary = {"kind": "aten ops (the CPU has no CUDA graph)",
                   "ops": len(watch.ops), "by_kernel": dict(Counter(
                       name for name, _ in watch.calls)),
                   "collectives": calls, "sharded_corpus": sharded}
        ranks = _all_gather(summary)
        summary["counts_agree_across_ranks"] = _check_spmd(ranks)
        if rank == 0:
            by_name = Counter(op for op, _ in watch.ops)
            body = []
            for i, (op, k) in enumerate(watch.ops):
                kind = collective_kind(op)
                body.append(f"{i} collective {kind} {op}" if kind else
                            f"{i} op {op}" + (f"  [{k}]" if k else ""))
            head = _header(title + ": the aten ops it dispatched, in order",
                           {**summary, "ranks": ranks}, by_name, "op")
            (workdir / GRAPH_FILE).write_text("\n".join(
                head[:2] + _rank_lines(ranks) + head[2:] + body) + "\n")
        say(f"[graph] the CPU has no CUDA graph: listed {len(watch.ops)} "
            f"aten ops ({sum(calls.values())} collectives) per rank in "
            f"{workdir / GRAPH_FILE}")
        return {**summary, "ranks": ranks}

    pre = snapshot(work)
    # every rank's warm-up runs its collectives for real: it builds the
    # communicators and every cache before any capture
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    try:
        with torch.cuda.stream(side):
            eager = _outcome(work, runner.eager(work))
    except Exception as err:
        raise _step_failed("its warm-up", None, err) from err
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    restore(work, pre)
    runner.capture(work)
    if rank == 0:
        runner.graph.debug_dump(str(workdir / DOT_FILE))
        if not (workdir / DOT_FILE).exists():
            raise RuntimeError(f"CUDAGraph.debug_dump wrote no "
                               f"{workdir / DOT_FILE}")
    restore(work, pre, drop_new=False)
    metrics = runner.replay(work)
    torch.cuda.synchronize(device)
    differ = differing(_outcome(work, metrics), eager)

    nodes = runner.nodes
    readable = _demangle(sorted({n["name"] for n in nodes if "name" in n}))
    owner: dict[int, str] = {}
    for name, added in runner.calls:
        for h in added:
            owner[h] = name
    for kind, added in runner.collectives:
        for h in added:
            owner[h] = f"c10d {kind}"
    summary = {**runner.summary(),
               "sharded_corpus": sharded,
               "replay_equals_eager": not differ,
               "replay_differs_in": differ,
               "tensors_compared": len(eager),
               "inputs_copied_to_device": runner.copied}
    ranks = _all_gather(summary)
    summary["counts_agree_across_ranks"] = _check_spmd(ranks)
    if rank == 0:
        by_name = Counter(readable[n["name"]] for n in nodes if "name" in n)
        body = []
        for i, n in enumerate(nodes):
            line = f"{i} {n['kind']}"
            if "name" in n:
                line += (f" {readable[n['name']]} grid={n['grid']} "
                         f"block={n['block']}")
            if n["handle"] in owner:
                line += f"  [{owner[n['handle']]}]"
            body.append(line)
        head = _header(title + ": cudaGraph nodes in capture order",
                       {**summary, "ranks": ranks}, by_name, "kernel")
        (workdir / GRAPH_FILE).write_text("\n".join(
            head[:2] + _rank_lines(ranks) + head[2:] + body) + "\n")
    bad = [i for i, r in enumerate(ranks) if not r["replay_equals_eager"]]
    note = "" if not bad else (f"; the replay differs from the eager "
                               f"step on ranks {bad}")
    say(f"[graph] dumped {len(nodes)} nodes per rank into "
        f"{workdir / GRAPH_FILE} and {workdir / DOT_FILE}{note}")
    del runner
    return {**summary, "ranks": ranks}


def read_summary(workdir: Path) -> dict:
    """The summary line of a step_graph.txt."""
    for line in (Path(workdir) / GRAPH_FILE).read_text().splitlines():
        if line.startswith("# summary "):
            return json.loads(line[len("# summary "):])
    raise ValueError(f"no summary in {Path(workdir) / GRAPH_FILE}")
