"""Training loop of the port, audiogan_tpu/train/loop.py.

Resolves or builds the corpus (data_dir '' -> the seeded synthetic SC09
fixture in the workdir) and feeds the step by one of the reference's
three data paths (``corpus_placement``): with data.device_corpus on, the
corpus's int16 clips go to the device once and the host sends only the
(seed, step)-pure clip indices per step, the clips replicated on every
card or, when they do not fit there but a 1/dp share does (or with
data.device_corpus_shard=shard), sharded over the data axis
(parallel/sharded_corpus.py); with it off, or when even a share exceeds
DEVICE_CORPUS_MAX_GB, the host batcher gathers each step's clips on the
host (a prefetch thread) and ``HostFeed`` ships them from pinned memory,
the next step's copy on a side stream while the current step runs. Every
path gives the step the same clips, so they train to the same bits. On
the resident paths data.index_chunk > 0 ships the indices and labels of
steps [m chunk, (m+1) chunk) as one block once per chunk steps, and the
step takes its row, step % chunk (data/corpus.py::index_row, the
reference's resident index blocks); 0 ships each step's own.

How a step runs (``step_route``), the counterpart of the reference's one
jit'd step (audiogan_tpu/train/loop.py:203-213, 314-318): on the card
the run's first step runs eagerly (it builds every cache and Adam's
moments), the next is captured as one CUDA graph and every step after
replays it (train/step_graph.py::StepGraph). Before each step, eager or
replayed, its inputs are copied into the step's fixed buffers: the data
path's arguments (the row of an index block, the host batcher's clips
from HostFeed's buffer, the sharded corpus's fixed-size exchange plan;
the resident corpus is used in place), the step's draws, and both Adams'
scalars (train/state.py::Adam.stage). The graph's metrics are fixed
buffers, read at a log step before the next replay; a checkpoint's
device copy runs on the loop's stream, so before the next replay writes
the parameters. Eager by design: the CPU, which has no graphs; a
multi-process gloo group on CUDA tensors, which no capture takes; the
steps in train.profile_dir's window, whose spans StepTrace records; and
the caller's ``replay=False`` (no Config field or CLI flag reaches it).
The run's ``init`` record says which (``steps``, and under replay the
``eager_steps``), and the capture logs one ``graph`` record (its step,
nodes by kind, each port kernel's calls and nodes, its seconds). A
failed capture or replay raises; nothing falls back to eager.

The reference's tracing options: train.dump_hlo captures the step the
loop will run, on its data path, as one CUDA graph before the first step
(train/step_graph.py; on a copy of the state; on a mesh every rank its
own, NCCL's collectives included); train.profile_dir traces
the steps [start + profile_steps[0], start + profile_steps[1]) counted
from the step the run starts at, closing at the last step if the window
runs past it (utils/profiling.py::StepTrace); train.debug_nans checks
each step for NaN and, on one, runs the step again from a snapshot to
name the first op that made it (train/debug_nans.py: a replayed step
is run again eagerly, as the reference re-runs its jitted step op by
op). None of them changes a bit of the run.

Data, context and tensor parallelism: under torchrun (one process per
card) the loop joins the process group (parallel/multihost.py); each
rank builds the same state from the seed and feeds its data replica's
rows of the global batch; at cp = tp = 1 it runs the global step's rows
(train/step.py), with mesh.cp above 1 the context-parallel step on its
time slice of those clips (train/cp_step.py), with mesh.tp above 1 the
tensor-parallel step on its channel slice of the critic
(train/tp_step.py), on each of the three corpus paths (the corpus is
sharded over the data axis only, so every cp or tp rank of a replica
gets the replica's rows). Global rank 0 alone builds the corpus and
writes config.json, the checkpoints (the whole state, replicated over
cp and tp, which restores on any topology), metrics.jsonl, TensorBoard
and the sample dumps, and logs; the others wait at a barrier where they
need its files. Every rank restores the same checkpoint. A mesh whose
size is not the number of processes raises before the device is
touched, as does train.dump_hlo on a mesh whose group is gloo on the
card (``check_ported``).

Crash-only, as the reference: a checkpoint every ckpt_every steps and at
the last one; ``resume`` picks up the latest complete checkpoint; the data
stream and every draw of a step are functions of (seed, step), so a
resumed run gives the same bits as an uninterrupted one. Every log_every
steps one JSON line of metrics (with ``seconds`` since the loop started)
goes to ``log`` and one record, with ``steps_per_sec`` and
``train_audio_sec_per_sec``, to ``<workdir>/metrics.jsonl``; every
sample_every steps four clips go to ``samples/step_%08d/``.

Checkpoints are saved asynchronously, as the reference's ``_AsyncCkpt``
(utils/checkpoint.py::AsyncSaver): the loop's thread copies the state on
the device (and joins ZeRO-1's gather), a worker thread fetches the copy
and writes the file while the next steps run, one save in flight. The
``{"ckpt": ...}`` line goes to ``log`` once the file is complete (at the
first step after that, or at the loop's end, which waits for the last
save before any rank goes on): its bytes, the seconds the save
``blocked`` the loop and the worker's ``write`` seconds. The step rate of
the window leaves out only the blocked seconds.
"""

from __future__ import annotations

import contextlib
import functools
import json
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.data.corpus import (Corpus, HostBatcher, build_corpus,
                                            index_row)
from audiogan_tpu_torch.data.synthetic import make_synthetic_sc09
from audiogan_tpu_torch.data.wavio import write_wav
from audiogan_tpu_torch.device import resolve_device
from audiogan_tpu_torch.parallel.mesh import (DataMesh, check_world,
                                              world_rank, world_size)
from audiogan_tpu_torch.parallel.multihost import make_train_mesh
from audiogan_tpu_torch.parallel.sharded_corpus import (corpus_num_shards,
                                                        local_shard,
                                                        plan_fixed,
                                                        wrap_sharded_corpus)
from audiogan_tpu_torch.train.debug_nans import NanGuard
from audiogan_tpu_torch.train.state import (TrainState, create_train_state,
                                            param_count)
from audiogan_tpu_torch.train.step_graph import StepGraph, dump_step
from audiogan_tpu_torch.train.sample import generate
from audiogan_tpu_torch.train.step import (build_train_step, num_views,
                                           wrap_device_corpus)
from audiogan_tpu_torch.utils import checkpoint as ckpt_lib
from audiogan_tpu_torch.utils.metrics import MetricsWriter
from audiogan_tpu_torch.utils.profiling import StepTrace

# Largest packed corpus held on the device (data.device_corpus); larger
# corpora fall back to the host batcher with a notice (the reference's).
DEVICE_CORPUS_MAX_GB = 8.0


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


def check_ported(cfg: Config, device=None) -> None:
    """Raises ValueError when the mesh asks for another number of
    processes than run (parallel/mesh.py::check_world), and
    NotImplementedError for train.dump_hlo on a multi-process mesh whose
    group is gloo on the card (``device`` None or CUDA): gloo on CUDA
    tensors stages each collective through the host, which no CUDA graph
    capture takes; the capture needs NCCL (train/step_graph.py). Either
    before the card is touched."""
    check_world(cfg)
    on_card = device is None or torch.device(device).type == "cuda"
    if cfg.train.dump_hlo and world_size() > 1 and on_card and \
            dist.is_initialized() and dist.get_backend() == "gloo":
        raise NotImplementedError(
            "train.dump_hlo on a multi-process mesh captures every rank's "
            "step, collectives included, and needs NCCL: this process "
            "group is gloo on CUDA tensors, which stages each collective "
            "through the host")


def corpus_placement(cfg: Config, corpus: Corpus, mesh: DataMesh,
                     say: Callable[[str], None] = print) -> str:
    """"replicate", "shard" or "host", the reference's rule
    (audiogan_tpu/train/loop.py:149-175): data.device_corpus off ->
    host; device_corpus_shard=shard -> shard; auto -> shard when the
    replicated corpus exceeds DEVICE_CORPUS_MAX_GB but a 1/dp share does
    not; over the limit even so -> the host batcher, with a notice."""
    if not cfg.data.device_corpus:
        return "host"
    gb = corpus.clips.nbytes / 2**30
    nsh = corpus_num_shards(mesh)
    mode = cfg.data.device_corpus_shard
    if mode == "shard":
        return "shard"
    if mode == "auto" and gb > DEVICE_CORPUS_MAX_GB and nsh > 1 \
            and gb / nsh <= DEVICE_CORPUS_MAX_GB:
        say(f"[data] corpus is {gb:.1f} GiB: sharding over {nsh} data "
            f"shards ({gb / nsh:.1f} GiB/device)")
        return "shard"
    if gb > DEVICE_CORPUS_MAX_GB:
        say(f"[data] corpus is {gb:.1f} GiB > {DEVICE_CORPUS_MAX_GB} GiB "
            f"even at {nsh} shards: falling back to the host batcher "
            f"(device_corpus off)")
        return "host"
    return "replicate"


def _quiet(_: str) -> None:
    pass


class HostFeed:
    """Each step's clips from the host batcher's prefetch thread to the
    device. On the card: two pinned host buffers and two device buffers,
    used in turn; step s + 1's copy runs on a side stream while step s
    runs, after step s - 1 (the last user of its buffers) is done with
    them, and the step's stream waits for it. On the CPU the batcher's
    arrays are used as they are."""

    def __init__(self, batcher: HostBatcher, first: int, last: int,
                 device: torch.device):
        self.batcher, self.device = batcher, device
        self.cuda = device.type == "cuda"
        if self.cuda:
            shape = (batcher.n_views, batcher.local_batch,
                     batcher.corpus.clips.shape[1])
            self.stream = torch.cuda.Stream(device)
            self.host = [torch.empty(shape, dtype=torch.int16,
                                     pin_memory=True) for _ in range(2)]
            self.dev = [torch.empty(shape, dtype=torch.int16, device=device)
                        for _ in range(2)]
            for buf in self.dev:
                buf.record_stream(self.stream)
            self.copied: list = [None, None]
            self.freed: list = [None, None]
        batcher.start_prefetch(first, last)
        self.staged = self._stage(first)

    def _stage(self, step: int):
        item = self.batcher.next_prefetched()
        if item is None:
            return None
        s, (clips, labels) = item
        if s != step:
            raise RuntimeError(f"batcher gave step {s}, want {step}")
        raw = torch.from_numpy(clips)
        if self.cuda:
            k = s % 2
            if self.copied[k] is not None:
                self.copied[k].synchronize()    # the host buffer is free
            self.host[k].copy_(raw)
            with torch.cuda.stream(self.stream):
                if self.freed[k] is not None:
                    self.stream.wait_event(self.freed[k])
                self.dev[k].copy_(self.host[k], non_blocking=True)
                self.copied[k] = torch.cuda.Event()
                self.copied[k].record(self.stream)
            raw = self.dev[k]
        return s, raw, torch.from_numpy(labels)

    def take(self, step: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(raw [n_views, B, store_len] int16 on the device, labels)."""
        if self.staged is None or self.staged[0] != step:
            raise RuntimeError(f"no batch staged for step {step}")
        _, raw, labels = self.staged
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_event(
                self.copied[step % 2])
        return raw, labels

    def done(self, step: int) -> None:
        """After step's work is queued: stage step + 1."""
        if self.cuda:
            self.freed[step % 2] = torch.cuda.Event()
            self.freed[step % 2].record(torch.cuda.current_stream(
                self.device))
        self.staged = self._stage(step + 1)


def step_route(device: torch.device, replay: bool = True) -> str:
    """How the loop runs its steps: "replay" (the card: the first step
    eagerly, then one captured CUDA graph replayed, train/step_graph.py),
    or "eager" and why: the CPU, which has no graphs; a multi-process
    gloo group on CUDA tensors, whose collectives stage through the host
    and which no capture takes; or the caller's ``replay=False``."""
    if device.type != "cuda":
        return "eager: the CPU has no CUDA graphs"
    if world_size() > 1 and dist.is_initialized() and \
            dist.get_backend() == "gloo":
        return ("eager: a gloo group on CUDA tensors, which no capture "
                "takes")
    if not replay:
        return "eager: asked by the caller"
    return "replay"


def train(cfg: Config, workdir: str | Path, steps: int | None = None, *,
          resume: bool = True, device=None,
          log: Callable[[str], None] = print,
          tensorboard: bool = True,
          replay: bool = True) -> tuple[TrainState, dict]:
    """Runs from the latest checkpoint (or step 0, or always from 0 without
    ``resume``) up to step ``steps`` (default cfg.train.total_steps);
    returns the state and the last logged step's metrics as floats.
    ``tensorboard=False`` skips the TensorBoard scalars. ``replay=False``
    runs every step eagerly on the card (the checks' reference run; no
    Config field or CLI flag reaches it). Under torchrun every rank calls
    it; only rank 0 logs and writes."""
    cfg.validate()
    check_ported(cfg, device)
    dev = resolve_device(device)
    mesh = make_train_mesh(cfg, dev)
    lead = world_rank() == 0
    say = functools.partial(print, flush=True) if lead else _quiet
    log = log if lead else _quiet
    total = cfg.train.total_steps if steps is None else steps
    workdir = Path(workdir)
    if lead:
        workdir.mkdir(parents=True, exist_ok=True)
        (workdir / "config.json").write_text(cfg.to_json())
        resolve_corpus(cfg, workdir)
    mesh.barrier()
    corpus = resolve_corpus(cfg, workdir)
    check_corpus(cfg, corpus)
    placement = corpus_placement(cfg, corpus, mesh, say)
    state = create_train_state(cfg, device=dev, mesh=mesh)
    t = cfg.train
    route = step_route(dev, replay)
    eager_steps = ["the run's first step"]
    if t.profile_dir:
        eager_steps.append(f"train.profile_dir's window {list(t.profile_steps)}"
                           " from the run's first step")
    log(json.dumps({"init": {"g_params": param_count(state.g),
                             "d_params": param_count(state.d),
                             "corpus_clips": len(corpus),
                             "device": str(dev), "dp": mesh.dp,
                             "cp": cfg.mesh.cp, "tp": cfg.mesh.tp,
                             "corpus": placement, "steps": route,
                             **({"eager_steps": eager_steps}
                                if route == "replay" else {})}}))
    mngr = ckpt_lib.make_manager(workdir, keep=cfg.train.keep_ckpts,
                                 config=cfg)
    if resume and ckpt_lib.latest_step(mngr) is not None:
        ckpt_lib.restore(mngr, state)
        log(json.dumps({"resume": {"step": state.step}}))
    b, n_views = t.batch_size, num_views(cfg)
    inner = build_train_step(cfg, dev, mesh)
    writer = (MetricsWriter(workdir, also_tensorboard=tensorboard)
              if lead else None)
    # the sharded corpus plans its exchange from the global indices
    batcher = HostBatcher(corpus, b, n_views, seed=t.seed,
                          indices_only=placement != "host",
                          rows=None if placement == "shard" else mesh.rows(b))
    every = max(t.log_every, 1)
    # data.index_chunk: resident index blocks (the host batcher's path
    # ignores it, as the reference's)
    chunk = cfg.data.index_chunk if placement != "host" else 0
    metrics: dict = {}
    feed = trace = None
    saver = ckpt_lib.AsyncSaver(
        mngr, dev, write=lead,
        on_complete=lambda rec: log(json.dumps({"ckpt": rec})))
    try:
        if placement == "host":
            # the dump needs the first step's batch even with no step to run
            feed = HostFeed(batcher, state.step,
                            max(total, state.step + t.dump_hlo), dev)
            step_fn, resident = inner, ()
            inputs = feed.take
        else:
            if placement == "shard":
                clips = torch.from_numpy(local_shard(corpus.clips, mesh))
                step_fn = wrap_sharded_corpus(inner, mesh)
            else:
                clips = torch.from_numpy(np.array(corpus.clips))
                step_fn = wrap_device_corpus(inner)
            clips, resident = clips.to(dev), (0,)
            # over several ranks the sharded corpus takes each step's
            # exchange plan, made here from its host indices
            # (parallel/sharded_corpus.py); one rank's plan is its indices
            idx_dev = torch.device("cpu") \
                if placement == "shard" and mesh.parallel else dev
            block: dict = {}

            def indices(step):
                if not chunk:
                    idx, labels = batcher.get(step)
                    return torch.from_numpy(idx), torch.from_numpy(labels)
                m = step // chunk
                if block.get("m") != m:
                    # steps [m chunk, (m+1) chunk), shipped once; a resume
                    # mid-chunk rebuilds the whole block (the reference's
                    # chunk_rows)
                    rows = [batcher.get(s)
                            for s in range(m * chunk, (m + 1) * chunk)]
                    block.update(m=m, idx=torch.from_numpy(
                        np.stack([r[0] for r in rows])).to(idx_dev,
                                                           torch.long),
                        labels=torch.from_numpy(
                            np.stack([r[1] for r in rows])).to(dev))
                # the step's row, copied into the step's fixed buffer
                return index_row(step, block["idx"], block["labels"], chunk)

            def inputs(step):
                idx, labels = indices(step)
                if placement == "shard":
                    idx = plan_fixed(idx, clips.shape[0], mesh, dev)
                return clips, idx, labels
        if t.dump_hlo:
            # the step the loop runs next, on its data path
            dump_step(cfg, state, step_fn, inputs(state.step), workdir, dev,
                      say)
        runner = StepGraph(cfg, step_fn, dev, resident)
        guard = NanGuard(dev) if t.debug_nans else None
        start = state.step
        prof_on, prof_off = (start + t.profile_steps[0],
                             start + t.profile_steps[1])
        t0 = t_log = time.perf_counter()
        last_logged = state.step
        for step in range(state.step, total):
            if t.profile_dir and step == prof_on and prof_off > prof_on:
                trace = StepTrace(t.profile_dir, world_rank(), dev)
            runner.fill(state, inputs(step))
            if guard is not None:
                guard.before(state)
            eager = (route != "replay" or step == start
                     or trace is not None)
            with trace.step(step) if trace else contextlib.nullcontext():
                if eager:
                    out = runner.eager(state)
                else:
                    if runner.graph is None:
                        runner.capture(state)
                        log(json.dumps({"graph": {
                            "step": step, **runner.summary()}}))
                    out = runner.replay(state)
            if guard is not None:
                guard.after(state, out, lambda: runner.eager(state))
            if feed is not None:
                feed.done(step)
            done = step + 1
            if trace is not None and done in (prof_off, total):
                trace.close()
                say(f"[profile] trace in {t.profile_dir}")
                trace = None
            if done % every == 0 or done == total:
                # the graph's metrics are fixed buffers: read before the
                # next replay
                metrics = {k: float(v) for k, v in out.items()}  # sync
                now = time.perf_counter()
                # the steps timed since the last log: a resume from a
                # step off the log grid would otherwise inflate the rate
                sps = (done - last_logged) / max(now - t_log, 1e-9)
                # the critic's views, as the reference counts them
                audio = (sps * b * cfg.loss.n_critic * cfg.data.clip_len
                         / cfg.data.sample_rate)
                log(json.dumps({"step": done, **metrics,
                                "seconds": now - t0}))
                if writer is not None:
                    writer.write(done, {**metrics, "steps_per_sec": sps,
                                        "train_audio_sec_per_sec": audio})
                bad = [k for k, v in metrics.items() if not np.isfinite(v)]
                if bad:
                    raise FloatingPointError(f"non-finite {bad} at step "
                                             f"{done}")
                last_logged, t_log = done, time.perf_counter()
            if (t.ckpt_every and done % t.ckpt_every == 0) or done == total:
                # the step rate leaves out what the save blocked; its
                # device copy runs on this stream, before the next replay
                t_log += saver.save(state, metrics if last_logged == done
                                    else None)
            saver.poll()
            if lead and t.sample_every and done % t.sample_every == 0:
                t_dump = time.perf_counter()
                dump_samples(cfg, state, workdir, done, dev)
                t_log += time.perf_counter() - t_dump
        saver.join()
        # the other ranks, or a resume, may read the files now
        mesh.barrier()
    finally:
        saver.close()
        if trace is not None:
            trace.close()
        if writer is not None:
            writer.close()
        batcher.close()
    return state, metrics


def dump_samples(cfg: Config, state: TrainState, workdir: Path, step: int,
                 device, num: int = 4) -> Path:
    """``num`` clips of G at ``step`` from seed train.seed + step, labels
    arange(num) % num_classes for a conditional G, into
    samples/step_%08d/sample_{i}[_y{label}].wav (the reference's
    ``_dump_samples``)."""
    labels = None
    if cfg.data.num_classes:
        labels = np.arange(num, dtype=np.int64) % cfg.data.num_classes
    waves = generate(cfg, state.g.state_dict(), num, cfg.train.seed + step,
                     labels, device=device)
    out = workdir / "samples" / f"step_{step:08d}"
    out.mkdir(parents=True, exist_ok=True)
    for i, w in enumerate(waves):
        tag = f"_y{labels[i]}" if labels is not None else ""
        write_wav(out / f"sample_{i}{tag}.wav", cfg.data.sample_rate, w)
    return out
