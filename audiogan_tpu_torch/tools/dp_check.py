#!/usr/bin/env python3
"""Checks of the port's data and context parallelism, run in one process
per rank.

As a library: ``spawn(world, jobs, out_dir, device, backend)`` starts
``world`` processes (``torch.multiprocessing``, spawned), joins them in a
process group (gloo on the CPU, or on one card for two ranks; NCCL under
torchrun), runs each job of ``jobs`` on every rank and returns each rank's
result. A job is {"name", "fn" (a key of JOBS), "kw"}: ``steps`` (train
steps from a given state on given global batches, optionally with
injected draws; with mesh.cp above 1 the cp step, with ``step`` the cp or
tp step at 1), ``train`` (train/loop.py::train into a workdir),
``gather`` (the sharded corpus's gather), ``halo`` (the ops of
parallel/halo.py on each rank's slices, every rank one cp rank) and
``cp_model`` (parallel/cp_models.py likewise). Each result holds the rank's
whole state (``state_blob``: both nets, both optimizers with whole
moments, the per-rank moment rows). The CPU tests (tests/test_torch_dp.py,
tests/test_torch_sharded_corpus.py) and chip_smoke.py's ``dp`` phase drive
it.

As a script, on a host with four cards:

    python3 -m audiogan_tpu_torch.tools.dp_check [--out DIR]
        [--presets P ...] [--checks_only]

runs ``torchrun --nproc_per_node 4`` of this file's ``--worker`` mode
(NCCL): for the flagship and for ``music_44k_dp16 --set mesh.dp=4``, an
f32 step at dp=4 against the dp=1 step on rank 0's card (the parity
bounds of tools/step_checks.py), a bf16 step at the preset's batch twice
to the bit and against the bf16 dp=1 step on rank 0's card from
the same warm state (no farther apart than twice the dp=1 bf16 step from
the same step in f32), ZeRO-1 and the sharded corpus against replicated to
the bit, the conv and ingest kernels' launches per rank, the all-reduce's
device time per step (torch.profiler: NCCL's kernels in one profiled
step) and the sharded corpus's exchange for one step against the
replicated gather of the same clips. Then
``cli train`` at dp=4 under torchrun for each preset (steps/s of the
timed window), and a dp=4 flagship run killed after its step-3
checkpoint and resumed, against an uninterrupted one, to the bit
(``--checks_only`` stops before ``cli train``; ``--presets`` picks the presets, among them cond_gru_sc09
(K4 and K5 per rank on the persistent path at B/dp) and
wgan_gp_b64_fused, the flagship with every shuffle site fused, K6 and K7
per rank). Prints one JSON line per check and a summary line; ``--out``
keeps them.

With ``--graph``, the loop's replayed step on a multi-process mesh
instead: for each of GRAPH_CASES (the flagship at dp=4 replicated, with
mesh.fsdp and on the sharded corpus (its fixed-size exchange), music at
dp=2 x cp=2, the flagship at dp=2 x tp=2, cond_gru_sc09 at dp=4, music
at dp=1 x cp=4 on the sharded corpus, whose one data replica takes each
step's indices where they lie, and music at tp=4), ``cli train`` under
torchrun for GRAPH_STEPS steps twice through ``--cli_worker MODE DIR``
(a worker of this file that runs cli's main with the loop's route
forced): replayed, with train.dump_hlo on, each rank capturing its step
with its NCCL kernels (train/step_graph.py): every rank's dumped replay
equal to its eager step, its NCCL kernel nodes equal to its collectives
and to tools/step_checks.py::step_collectives; and every step eager.
Every step's record and the checkpoints of steps 3 and 6 of the two
runs equal to the bit; both rates, each rank's peak memory and its last
step's NCCL and device ms, node counts and capture seconds reported.
Then GRAPH_FAULT: the flagship at dp=4 whose rank 2 fails in the dump's
warm-up (``--dump_fault RANK DIR`` as the first arguments, then cli's:
a worker of this file that runs cli's main): torchrun ends non-zero
within FAULT_RUN_S, its failure summary and the rank's own error naming
rank 2, every rank ended non-zero and no worker left.

With ``--tp``, tensor parallelism instead, on the four cards: for the
flagship the f32 parity protocol at tp=4 (B=8, shuffle off,
``parity_job``: a frozen step held to the parity bounds at six batch
seeds, two steps at the preset's lr reported, against the tp step at
tp=1 and the plain step on rank 0's card); at
dp=2 x tp=2 and at tp=4 the preset's batch (G in bf16, the critic in
f32) twice to the same bits on every rank, K1', K1 and K2 launches per
rank (``tp_step_launches``), one profiled step (the collectives' NCCL
device time and count) and each rank's peak memory; cond_gru_sc09 at
dp=2 x tp=2 twice to the same bits (K4 6 and K5 1 per rank per step);
music_44k_dp16 at tp=4 the same and a profiled step. Then ``cli train``
(steps/s of steps 11-30) for the flagship at both meshes, cond_gru_sc09
at dp=2 x tp=2 and music at tp=4, and the flagship at both meshes
killed after its step-3 checkpoint and resumed, to the bit. With
``--dryrun`` (alone, or after ``--tp``'s checks), one full-width
flagship step from the seeded init at dp=2 x cp=2 and dp=2 x tp=2, each
with and without mesh.fsdp: every metric finite and the ranks equal.

With ``--cp``, context parallelism instead, for each of ``--presets``
among CP_PRESETS (music_44k_dp16 alone by default; cond_gru_sc09 and
dual_stft; ``cp_plan``) on the four cards: two f32 steps at cp=4 (B=8,
shuffle off) against the cp step at cp=1 on rank 0's card from one warm
state (the parity bounds; beyond one, main exits non-zero after the
rest has run); at cp=4 and at dp=2 x cp=2 the preset's batch (its cp
step computes in f32) twice to the same bits on every rank, the
kernels' launches per rank (``cp_step_launches``: K1', K1, K2 one per
real view, none of K3-K7) and each conv's route, one profiled step (the
halo all-gathers' and the all-reduces' NCCL device time) and each rank's
peak memory, beside the dp=1 step's on rank 0's card in the preset's
dtype and in f32; then per preset ``cli train`` at both meshes (steps/s
of steps 11-30) and a cp=4 run killed after its step-3 checkpoint and
resumed, to the bit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
import traceback
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.parallel.mesh import DataMesh, make_mesh
from audiogan_tpu_torch.parallel.multihost import (
    exit_after_failure, maybe_initialize_distributed)
from audiogan_tpu_torch.tools.step_checks import (
    PARITY_PARAM_TOL, PARITY_REL_TOL, PARITY_SEEDS, PARITY_STEPS, bits_of,
    compare_blobs, conv_step_launches, frozen, hold_bf16_to_dp1,
    hold_launches, parity_errors, random_raw, same_bits, same_checkpoint,
    state_parts)

ROOT = Path(__file__).resolve().parents[2]

# the CPU tests' collectives: a broken rank fails the test in this time
CPU_TIMEOUT_S = 120.0
# (name, kernel module, wrapper, counter): each wrapper's launch counts
COUNTERS = (("conv1d", "conv", "conv1d_ba", "launches"),
            ("conv1d_tc", "conv", "conv1d_ba", "launches_tc"),
            ("convt1d", "conv", "conv_transpose1d_ba", "launches"),
            ("convt1d_tc", "conv", "conv_transpose1d_ba", "launches_tc"),
            ("ingest", "ingest", "ingest_fused", "launches"),
            ("sconv1d", "sconv", "sconv1d_ba", "launches"),
            ("sconvt1d", "sconv", "sconvt1d", "launches"),
            ("gru_cell", "gru", "gru_cell_fwd", "launches"),
            ("gru_scan", "gru", "gru_scan_fwd", "launches"),
            ("gru_scan_bwd", "gru", "gru_scan_bwd", "launches"),
            ("sconv1d_tc", "sconv", "sconv1d_ba", "launches_tc"),
            ("sconvt1d_tc", "sconv", "sconvt1d", "launches_tc"),
            ("gru_scan_persistent", "gru", "gru_scan_fwd",
             "launches_persistent"),
            ("gru_scan_bwd_persistent", "gru", "gru_scan_bwd",
             "launches_persistent"),
            ("adam", "adam", "adam_update", "launches"))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _counter(module: str, fn: str):
    import importlib
    return getattr(importlib.import_module(
        f"audiogan_tpu_torch.kernels.{module}"), fn)


def zero_launches() -> None:
    from audiogan_tpu_torch.parallel import halo
    for _, module, fn, attr in COUNTERS:
        setattr(_counter(module, fn), attr, 0)
    halo.ROUTES.clear()


def read_launches() -> dict[str, int]:
    """Each kernel wrapper's launches in this process since
    zero_launches (0 on the CPU: the plain forms are not counted)."""
    return {name: getattr(_counter(module, fn), attr)
            for name, module, fn, attr in COUNTERS}


def state_blob(state) -> dict:
    """A state as CPU tensors: nets, whole optimizer states (a collective
    under ZeRO-1), step, and each parameter's rows of Adam's moments on
    this rank."""
    def cpu(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().clone()
        if isinstance(x, dict):
            return {k: cpu(v) for k, v in x.items()}
        if isinstance(x, list):
            return [cpu(v) for v in x]
        return x
    rows = {}
    for tag, opt, mod in (("g", state.opt_g, state.g),
                          ("d", state.opt_d, state.d)):
        for n, p in mod.named_parameters():
            st = opt.state.get(p)
            if st:
                rows[f"{tag}.{n}"] = (int(st["exp_avg"].shape[0])
                                      if p.dim() else 0, int(p.shape[0])
                                      if p.dim() else 0)
    return {"step": state.step, "g": cpu(state.g.state_dict()),
            "d": cpu(state.d.state_dict()),
            "opt_g": cpu(state.opt_g.full_state_dict()),
            "opt_d": cpu(state.opt_d.full_state_dict()),
            "moment_rows": rows}


def load_blob(state, blob: dict) -> None:
    state.g.load_state_dict(blob["g"])
    state.d.load_state_dict(blob["d"])
    state.opt_g.load_state_dict(blob["opt_g"])
    state.opt_d.load_state_dict(blob["opt_d"])
    state.step = int(blob["step"])


def steps_job(dev, cfg_json: str, batches: list, draws: list | None = None,
              state: dict | None = None, solo: bool = False,
              step: str | None = None) -> dict | None:
    """len(batches) steps of cfg (global [V, B, L] clips and [V, B]
    labels each) from ``state`` (a state_blob) or the seeded init, each
    rank on its rows (its data replica's, with mesh.cp or mesh.tp above
    1); ``draws`` the global steps' (the cp and tp steps': one per
    replica; else the port's own). ``solo``: rank 0 alone runs the step
    at dp = 1 (the others wait and return None). ``step``: None for the
    step cfg's mesh picks (train/step.py::build_train_step), "cp" for
    the context-parallel step at cp = 1 (train/cp_step.py on whole clips,
    no exchange), "tp" for the tensor-parallel step at tp = 1."""
    from audiogan_tpu_torch.parallel import halo
    from audiogan_tpu_torch.parallel.mesh import AxisMesh
    from audiogan_tpu_torch.train.cp_step import build_cp_train_step
    from audiogan_tpu_torch.train.state import create_train_state
    from audiogan_tpu_torch.train.step import build_train_step
    from audiogan_tpu_torch.train.tp_step import build_tp_train_step
    cfg = Config.from_json(cfg_json)
    if solo:
        rank = dist.get_rank() if dist.is_initialized() else 0
        if rank:
            dist.barrier()
            return None
        mesh = DataMesh()
    else:
        mesh = make_mesh(cfg)
    st = create_train_state(cfg, device=dev, mesh=mesh)
    if state is not None:
        load_blob(st, state)
    build = {None: lambda: build_train_step(cfg, dev, mesh),
             "cp": lambda: build_cp_train_step(cfg, dev, mesh, AxisMesh()),
             "tp": lambda: build_tp_train_step(cfg, dev, mesh, AxisMesh())}
    step_fn = build[step]()
    metrics = []
    zero_launches()
    t0 = time.perf_counter()
    for i, (raw, labels) in enumerate(batches):
        rows = mesh.rows(raw.shape[1])
        m = step_fn(st, raw[:, rows], labels[:, rows],
                    draws=None if draws is None else draws[i])
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "launches": read_launches(),
           "routes": dict(halo.ROUTES),
           "seconds": time.perf_counter() - t0, **state_blob(st)}
    if solo and dist.is_initialized():
        dist.barrier()
    return out


def train_job(dev, cfg_json: str, workdir: str, steps: int,
              max_gb: float | None = None, resume: bool = True) -> dict:
    """train/loop.py::train of cfg into workdir up to ``steps``, with
    DEVICE_CORPUS_MAX_GB set to ``max_gb`` when given: its log lines
    (rank 0's) and the rank's state."""
    from audiogan_tpu_torch.train import loop
    if max_gb is not None:
        loop.DEVICE_CORPUS_MAX_GB = max_gb
    lines = []
    zero_launches()
    st, _ = loop.train(Config.from_json(cfg_json), workdir, steps,
                       device=dev, resume=resume, tensorboard=False,
                       log=lambda s: lines.append(json.loads(s)))
    return {"lines": lines, "launches": read_launches(), **state_blob(st)}


def gather_job(dev, clips: np.ndarray, idx: np.ndarray) -> dict:
    """This rank's rows of the sharded gather of clips by the global
    indices idx [V, B], over all ranks."""
    from audiogan_tpu_torch.parallel.sharded_corpus import (
        local_shard, sharded_corpus_gather)
    mesh = DataMesh(dist.get_world_size(), dist.get_rank())
    local = torch.from_numpy(local_shard(clips, mesh)).to(dev)
    got = sharded_corpus_gather(local, idx, mesh)
    return {"got": got.cpu(), "rows": mesh.rows(idx.shape[1]),
            "local_rows": local.shape[0]}


def _slice(t: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """This cp rank's block of t along dim."""
    n = t.shape[dim] // mesh.size
    return t.narrow(dim, mesh.index * n, n).contiguous()


def _total(t: torch.Tensor) -> torch.Tensor:
    """t summed over every rank (a parameter's gradient)."""
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def _halo_case(dev, mesh, case: dict) -> dict:
    """One case of ``halo_job``: the op on this rank's slices of the
    global inputs, y; dL/d(inputs) of L = sum(y r) (the time inputs'
    slices, the parameters' totals); for conv1d and convt1d also the
    gradients of sum(dL/dx q), the second order the penalty takes."""
    from audiogan_tpu_torch.parallel import halo
    op = case["op"]
    t = {k: v.to(dev) for k, v in case.items() if isinstance(v, torch.Tensor)}
    dim = 2 if op == "conv2d" else 1
    if op == "scan":
        a = t["a"].requires_grad_(True)

        def step(carry):
            h = torch.tanh(carry[0] @ a + t["c"])
            return (h,), h
        y = halo.cp_chunked_scan(step, (t["h0"],), case["length"], mesh)
        (da,) = torch.autograd.grad(
            halo.axis_sum((y * _slice(t["r"], mesh, 0)).sum(), mesh), a)
        return {"y": y.detach().cpu(), "da": _total(da).cpu()}
    x = _slice(t["x"], mesh, dim).requires_grad_(True)
    if op == "halo":
        return {"y": halo.gather_halo(x, case["left"], case["right"],
                                      mesh).detach().cpu()}
    if op == "shuffle":
        y = halo.cp_phase_shuffle(x, t["shifts"], case["rad"], mesh)
        params = []
    else:
        w, b = t["w"].requires_grad_(True), t["b"].requires_grad_(True)
        params = [w, b]
        if op == "conv1d":
            y = halo.cp_conv1d_ba(x, w, b, case["stride"], mesh, case["act"])
        elif op == "convt1d":
            y = halo.cp_conv_transpose1d_ba(x, w, b, case["stride"], mesh,
                                            case["act"])
        else:
            y = halo.cp_conv2d_frames(x, w, b, case["stride"], mesh)
    loss = halo.axis_sum((y * _slice(t["r"], mesh, dim)).sum(), mesh)
    second = op in ("conv1d", "convt1d")
    grads = torch.autograd.grad(loss, [x, *params], create_graph=second)
    out = {"y": y.detach().cpu(), "dx": grads[0].detach().cpu(),
           **{f"d{n}": _total(g).cpu() for n, g in zip("wb", grads[1:])}}
    if second:
        loss2 = halo.axis_sum((grads[0] * _slice(t["q"], mesh)).sum(), mesh)
        dx2, dw2 = torch.autograd.grad(loss2, [x, params[0]],
                                       materialize_grads=True)
        out.update(dx2=dx2.cpu(), dw2=_total(dw2).cpu())
    return out


def halo_job(dev, cases: list[dict]) -> dict:
    """Each case (a dict: "op" of conv1d, convt1d, conv2d, shuffle, scan,
    halo; its global inputs and settings) through parallel/halo.py with
    every rank one cp rank of one group: this rank's results
    (``_halo_case``) and the routes its convs took."""
    from audiogan_tpu_torch.parallel import halo
    from audiogan_tpu_torch.parallel.mesh import CpMesh
    mesh = CpMesh(dist.get_world_size(), dist.get_rank())
    halo.ROUTES.clear()
    results = [_halo_case(dev, mesh, case) for case in cases]
    return {"results": results, "routes": dict(halo.ROUTES)}


def cp_model_job(dev, cfg_json: str, state: dict, x: torch.Tensor,
                 shifts: torch.Tensor | None, z: torch.Tensor,
                 labels: torch.Tensor | None,
                 real: torch.Tensor | None = None) -> dict:
    """parallel/cp_models.py on this rank's time slice (every rank one cp
    rank of one group) with the nets of ``state`` (a state_blob): the
    critic's scores of x [B, T, 1] with the wave critic's shifts, G's
    slice for z (labels for both when conditional), and with ``real``
    the spectral matching loss of G's output against it."""
    from audiogan_tpu_torch.parallel import cp_models
    from audiogan_tpu_torch.parallel.mesh import CpMesh
    from audiogan_tpu_torch.train.state import create_train_state
    cfg = Config.from_json(cfg_json)
    mesh = CpMesh(dist.get_world_size(), dist.get_rank())
    st = create_train_state(cfg, device=dev)
    load_blob(st, state)
    lab = None if labels is None else labels.to(dev)
    with torch.no_grad():
        score = cp_models.cp_discriminator_forward(
            st.d, _slice(x.to(dev), mesh), mesh,
            None if shifts is None else shifts.to(dev), lab)
        g = (cp_models.cp_gru_generator_forward
             if cfg.model.generator == "gru"
             else cp_models.cp_generator_forward)(st.g, z.to(dev), mesh, lab)
        out = {"score": score.cpu(), "g": g.cpu()}
        if real is not None:
            out["stft"] = cp_models.cp_batch_spectral_matching_loss(
                g[..., 0], _slice(real.to(dev), mesh),
                cfg.model.stft_resolutions, mesh).cpu()
    return out


def tp_model_job(dev, cfg_json: str, state: dict, cases: list[dict]
                 ) -> dict:
    """parallel/tp.py and parallel/tp_models.py with every rank one tp
    rank of one group. Each case is {"op": "pair", x, w1, b1, w2, b2,
    stride} (a column then a row conv, the relu between, and the row
    layer's bias after the sum: y and the gradients of sum(y r)) or
    {"op": "critic", x, fake, eps, shifts, labels} with the nets of
    ``state`` (a state_blob): the critic's scores of x; the gradient of
    sum D(x-hat) at x-hat = eps x + (1 - eps) fake; and of the WGAN-GP
    loss D(fake) - D(x) + 10 GP every parameter's gradient, summed over
    the ranks where the parameter is used through a slice
    (tp_models.sliced_params), this rank's where it is used whole."""
    from audiogan_tpu_torch.losses import gradient_penalty, wgan_d_loss
    from audiogan_tpu_torch.parallel import tp as ptp
    from audiogan_tpu_torch.parallel.mesh import TpMesh
    from audiogan_tpu_torch.parallel.tp_models import (
        sliced_params, tp_discriminator_forward)
    from audiogan_tpu_torch.train.state import create_train_state
    cfg = Config.from_json(cfg_json)
    mesh = TpMesh(dist.get_world_size(), dist.get_rank())
    st = create_train_state(cfg, device=dev)
    load_blob(st, state)
    out = []
    for case in cases:
        t = {k: v.to(dev) for k, v in case.items()
             if isinstance(v, torch.Tensor)}
        if case["op"] == "pair":
            x = t["x"].requires_grad_(True)
            w1, b1, w2, b2 = (t[k].requires_grad_(True)
                              for k in ("w1", "b1", "w2", "b2"))
            h = ptp.tp_conv1d_col(x, w1, b1, case["stride"], mesh, "relu")
            y = ptp.tp_conv1d_row(h, w2, 1, mesh) + b2
            grads = torch.autograd.grad((y * t["r"]).sum(),
                                        [x, w1, b1, w2, b2])
            out.append({"y": y.detach().cpu(), "dx": grads[0].cpu(),
                        **{f"d{n}": _total(g).cpu() for n, g in zip(
                            ("w1", "b1", "w2"), grads[1:4])},
                        "db2": grads[4].cpu()})
            continue
        lab = t.get("labels")
        shifts = t.get("shifts")

        def d(v, st=st, lab=lab, shifts=shifts):
            return tp_discriminator_forward(st.d, v, mesh, shifts, lab)
        with torch.no_grad():
            score = d(t["x"])
        e = t["eps"].reshape(-1, 1, 1)
        xhat = (e * t["x"] + (1 - e) * t["fake"]).requires_grad_(True)
        (dxhat,) = torch.autograd.grad(d(xhat).sum(), xhat)
        params = dict(st.d.named_parameters())
        gp, _ = gradient_penalty([d], t["x"], t["fake"], t["eps"])
        loss = wgan_d_loss(d(t["x"]), d(t["fake"])) + 10.0 * gp
        grads = torch.autograd.grad(loss, list(params.values()))
        sliced = sliced_params(st.d)
        out.append({"score": score.cpu(), "dxhat": dxhat.cpu(),
                    "loss": loss.detach().cpu(),
                    "grads": {n: (_total(g) if n in sliced else g).cpu()
                              for n, g in zip(params, grads)}})
    return {"results": out}


def parity_job(dev, cfg_json: str, axis: str, work: str,
               seeds: tuple = PARITY_SEEDS, held_seeds: tuple = (),
               plain_held: bool = True) -> dict:
    """The f32 parity protocol of the cp or tp step (``axis``) at cfg's
    mesh (dp 1) on every rank. For each batch seed s: one plain step on
    rank 0 from the seeded init on the batch of seed s (the warm state),
    then from there, with the same draws, the step of cfg's mesh against
    the same axis's step at 1 and against the plain step, both run on
    rank 0 alone:

    - ``frozen``: one step from step_checks.frozen(warm) on the batch of
      seed s+1 (the parameters must stay as they were, to the bit), held
      to the parity bounds at every seed;
    - ``steps``: PARITY_STEPS steps from the warm state at the preset's
      lr on the batches of seeds s+1, ..., reported beside the bounds
      and held at ``held_seeds`` (step_checks.PARITY_SEEDS says why).

    The plain step's comparisons are held only with ``plain_held``.
    Every rank's state equal to the bit after each run. Each rank
    returns its launches and conv routes over its runs of the step, the
    count of those steps and its last metrics; rank 0 also the report:
    per seed both runs' comparisons (step_checks.parity_errors) and
    ``failed``, every held comparison beyond a bound."""
    from audiogan_tpu_torch.config import MeshCfg
    from audiogan_tpu_torch.train.step import draw_step, num_views
    cfg = Config.from_json(cfg_json)
    one = cfg.replace(mesh=MeshCfg())
    batch, rank = cfg.train.batch_size, dist.get_rank()
    work = Path(work)
    work.mkdir(parents=True, exist_ok=True)
    launches, routes, n_run = Counter(), Counter(), 0
    report = {"axis": axis, "seeds": {}, "held_seeds": list(held_seeds),
              "plain_held": plain_held, "failed": []}
    t0 = time.perf_counter()
    for seed in seeds:
        raws = [random_raw(one, num_views(one), batch, seed + s)
                for s in range(PARITY_STEPS + 1)]
        warm = steps_job(dev, one.to_json(), raws[:1], solo=True)
        if rank == 0:
            torch.save(warm, work / "warm.pt")
        dist.barrier()
        warm = torch.load(work / "warm.pt", weights_only=False)
        draws = [draw_step(one, one.train.seed, warm["step"] + s, batch,
                           "cpu") for s in range(PARITY_STEPS)]
        for kind, state, n, held in (
                ("frozen", frozen(warm), 1, True),
                ("steps", warm, PARITY_STEPS, seed in held_seeds)):
            got = steps_job(dev, cfg_json, raws[1:n + 1], state=state,
                            draws=[[d] for d in draws[:n]])
            if len(set(_gather(digest(got)))) != 1:
                raise AssertionError(f"{cfg.name} {axis} seed {seed} "
                                     f"{kind}: ranks differ")
            launches.update(got["launches"])
            routes.update(got["routes"])
            n_run += n
            want = steps_job(dev, one.to_json(), raws[1:n + 1], state=state,
                             draws=[[d] for d in draws[:n]], solo=True,
                             step=axis)
            plain = steps_job(dev, one.to_json(), raws[1:n + 1],
                              state=state, draws=draws[:n], solo=True)
            if rank:
                continue
            if kind == "frozen":
                same_bits({k: state[k] for k in ("g", "d")},
                          {k: got[k] for k in ("g", "d")})
            # the plain step also reports the mean of the critic's losses
            plain["metrics"] = [{k: v for k, v in m.items()
                                 if k != "d_loss_mean"}
                                for m in plain["metrics"]]
            entry = report["seeds"].setdefault(seed, {})[kind] = {
                "held": held, f"vs_{axis}1": parity_errors(got, want),
                "vs_plain": parity_errors(got, plain)}
            for name, hold in ((f"vs_{axis}1", held),
                               ("vs_plain", held and plain_held)):
                if hold and entry[name]["over"]:
                    report["failed"].append(
                        f"seed {seed} {kind} {name}: {entry[name]['over']}")
        last = got["metrics"][-1]
        del warm, got, want, plain
    report["seconds"] = time.perf_counter() - t0
    return {"launches": dict(launches), "routes": dict(routes),
            "steps": n_run, "last": last,
            "report": report if rank == 0 else None}


JOBS = {"steps": steps_job, "train": train_job, "gather": gather_job,
        "halo": halo_job, "cp_model": cp_model_job,
        "tp_model": tp_model_job, "parity": parity_job}


def run_jobs(dev, jobs: list[dict], out_dir: Path) -> None:
    rank = dist.get_rank()
    for job in jobs:
        fn = job["fn"]
        res = (JOBS[fn] if isinstance(fn, str) else fn)(dev,
                                                        **job.get("kw", {}))
        torch.save(res, out_dir / f"{job['name']}.{rank}.pt")


def worker(rank: int, world: int, port: int, device: str, backend: str,
           jobs: list[dict], out_dir: str, timeout_s: float) -> None:
    """One rank of ``spawn``: joins the group, runs the jobs, leaves. f32
    convs and matmuls stay f32 (no TF32), as in chip_smoke.py's parity
    phase, so an f32 step compares with the dp=1 step there."""
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    dev = torch.device(device)
    maybe_initialize_distributed(dev, backend, timeout_s)
    try:
        run_jobs(dev, jobs, Path(out_dir))
    except BaseException:
        (Path(out_dir) / f"error.{rank}.txt").write_text(
            traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(world: int, jobs: list[dict], out_dir: str | Path,
          device: str = "cpu", backend: str = "gloo",
          timeout_s: float = CPU_TIMEOUT_S) -> dict[str, list]:
    """Runs ``jobs`` on ``world`` spawned ranks; {job name: [result of
    rank 0, rank 1, ...]}. A job's "fn" names one of JOBS or is a
    module-level function ``fn(dev, **kw)`` that each rank imports."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    torch.multiprocessing.spawn(
        worker, args=(world, free_port(), device, backend, jobs, str(out),
                      timeout_s), nprocs=world, join=True)
    return {j["name"]: [torch.load(out / f"{j['name']}.{r}.pt",
                                   weights_only=False)
                        for r in range(world)] for j in jobs}


# -- the script: four cards --------------------------------------------------

PRESETS = ("wgan_gp_b64", "music_44k_dp16")
# names for a preset with --set overrides: the flagship with every shuffle
# site fused into its conv (K6, K7)
ALIASES = {"wgan_gp_b64_fused": ("wgan_gp_b64",
                                 ("model.fused_shuffle_sites=-1",))}
DP_PRESETS = (*PRESETS, "cond_gru_sc09", "wgan_gp_b64_fused")


def preset_sets(name: str) -> tuple[str, tuple[str, ...]]:
    """(the preset, its --set overrides) of a name of --presets."""
    return ALIASES.get(name, (name, ()))


def preset_config(name: str, *sets: str):
    """The config of a name of --presets, named so, with ``sets``."""
    from audiogan_tpu_torch.cli import apply_overrides
    from audiogan_tpu_torch.config import get_preset
    preset, own = preset_sets(name)
    cfg = apply_overrides(get_preset(preset), [*own, *sets]).validate()
    return cfg.replace(name=name)


def step_launches(cfg) -> dict:
    """Every kernel's launches per step of the preset's plain step at its
    batch on one rank, from the step's structure: K1'/K1
    (``conv_step_launches``), K2 per real view, K6/K7 with fused sites
    (``fused_step_launches``, all on the tensor cores in bf16), K4 per G
    forward and K5 once with the GRU G, on the persistent path where
    ``gru_scan_persistent`` holds at this batch."""
    from audiogan_tpu_torch.kernels.gru import gru_scan_persistent
    from audiogan_tpu_torch.tools.step_checks import (compute_dtype,
                                                      fused_step_launches)
    from audiogan_tpu_torch.train.step import num_views
    out = {**conv_step_launches(cfg), "ingest": num_views(cfg)}
    m = cfg.model
    if m.fused_shuffle_sites:
        k6, k7 = fused_step_launches(cfg)
        tc = compute_dtype(cfg) == torch.bfloat16
        out.update(sconv1d=k6, sconvt1d=k7, sconv1d_tc=k6 * tc,
                   sconvt1d_tc=k7 * tc)
    if m.generator == "gru":
        n = cfg.loss.n_critic
        b = cfg.train.batch_size // cfg.mesh.dp
        on = gru_scan_persistent(compute_dtype(cfg), b, m.gru_hidden,
                                 min(4 * m.model_dim, 512))
        out.update(gru_scan=n + 1, gru_scan_bwd=1,
                   gru_scan_persistent=(n + 1) * on,
                   gru_scan_bwd_persistent=int(on))
    return out
F32_BATCH = 8            # 2 rows per rank at dp=4
RATE_STEPS, RATE_LOG = 30, 10      # cli train: the rate of steps 11-30
RESUME_STEPS, RESUME_KILL_AT = 6, 3
RUN_TIMEOUT_S = 900
# a collective of the worker's waits at most this long for the slowest rank
WORKER_TIMEOUT_S = 300.0


def digest(blob: dict) -> str:
    """sha256 over a state's tensors, in order: equal digests, equal
    bits."""
    import hashlib
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x, key=str):
                h.update(str(k).encode())
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            h.update(bits_of(x).numpy().tobytes())
        else:
            h.update(repr(x).encode())
    walk(state_parts(blob))
    return h.hexdigest()


def _gather(obj) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _profile_step(cfg, dev, mesh, raw, labels) -> dict:
    """One step of a fresh state after a warm one under torch.profiler:
    the device time of NCCL's kernels (all, and the all-gathers and
    all-reduces apart: the cp step's halo shifts and its sums and
    gradient reductions; ZeRO-1's all-gathers), of all kernels, and the
    step's wall time; then the peak memory of one more step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from audiogan_tpu_torch.train.state import create_train_state
    from audiogan_tpu_torch.train.step import build_train_step
    st = create_train_state(cfg, device=dev, mesh=mesh)
    step = build_train_step(cfg, dev, mesh)
    rows = mesh.rows(raw.shape[1])
    raw, labels = raw[:, rows].to(dev), labels[:, rows].to(dev)
    step(st, raw, labels)                       # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(st, raw, labels)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    out = {"wall_ms": wall, **device_split(prof)}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    step(st, raw, labels)
    torch.cuda.synchronize()
    out["unprofiled_ms"] = (time.perf_counter() - t0) * 1e3
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def device_split(prof) -> dict:
    """A profile's device ms in all, NCCL's ms and kernels, and those of
    its all-gathers and all-reduces."""
    from torch.autograd import DeviceType
    out = {"device_ms": 0.0, "nccl_ms": 0.0,
           "nccl_kernels": 0, "all_gather_ms": 0.0, "all_gather_kernels": 0,
           "all_reduce_ms": 0.0, "all_reduce_kernels": 0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out["device_ms"] += us / 1e3
        key = e.key.lower()
        if "nccl" not in key:
            continue
        out["nccl_ms"] += us / 1e3
        out["nccl_kernels"] += e.count
        for kind in ("all_gather", "all_reduce"):
            if kind.replace("_", "") in key.replace("_", ""):
                out[kind + "_ms"] += us / 1e3
                out[kind + "_kernels"] += e.count
    return out


def allreduce_ms(cfg, dev, iters: int = 10) -> dict:
    """The step's all-reduces alone: each net's flat f32 bucket (one per
    update: n_critic of D's, one of G's), after a barrier so no rank
    waits for another; CUDA events, the mean of ``iters`` after one
    warm-up. Per step: n_critic D buckets, one G bucket."""
    from audiogan_tpu_torch.train.state import create_train_state
    st = create_train_state(cfg, device=dev)
    out = {}
    for name, mod in (("d", st.d), ("g", st.g)):
        n = sum(p.numel() for p in mod.parameters())
        flat = torch.ones(n, device=dev)
        dist.all_reduce(flat)
        dist.barrier()
        torch.cuda.synchronize(dev)
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(iters):
            dist.all_reduce(flat)
        t1.record()
        torch.cuda.synchronize(dev)
        out[name] = {"params": n, "bytes": 4 * n,
                     "ms": t0.elapsed_time(t1) / iters}
    out["per_step_ms"] = (cfg.loss.n_critic * out["d"]["ms"]
                          + out["g"]["ms"])
    return out


def corpus_exchange_ms(cfg, dev, iters: int = 10) -> dict:
    """The sharded corpus's exchange of one step of cfg (its views of the
    global batch, seeded indices into 4 V B random clips), planned (uneven
    splits) and at fixed sizes (the loop's; byte-equal, checked), against
    the replicated gather of the same rows from a corpus of that size held
    whole on this card: the bytes each rank sends,
    host ms per call (the plan included), the mean of ``iters`` after a
    warm-up, each after a barrier so no rank waits for another."""
    from audiogan_tpu_torch.parallel.sharded_corpus import (
        exchange_bytes, gather_fixed, plan_fixed, plan_step,
        sharded_corpus_gather)
    from audiogan_tpu_torch.train.step import num_views
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = DataMesh(world, rank)
    v, batch = num_views(cfg), cfg.train.batch_size
    n_local = 4 * v * batch // world
    idx = np.random.default_rng(0).integers(0, n_local * world, (v, batch))
    gen = torch.Generator(device=dev).manual_seed(rank)
    local = torch.randint(-32768, 32767, (n_local, cfg.data.store_len),
                          generator=gen, device=dev, dtype=torch.int16)
    whole = local.repeat(world, 1)
    mine = idx[:, mesh.rows(batch)].reshape(-1)

    def timed(fn) -> float:
        fn()
        total = 0.0
        for _ in range(iters):
            dist.barrier()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            total += time.perf_counter() - t0
        return total / iters * 1e3
    def fixed():
        return gather_fixed(local, plan_fixed(idx, n_local, mesh, dev), mesh)
    if not torch.equal(fixed(), sharded_corpus_gather(local, idx, mesh)):
        raise AssertionError("the fixed-size exchange differs from the "
                             "planned one")
    out = {"clips_per_rank": int(mine.size),
           "bytes_per_rank": int(mine.size) * cfg.data.store_len * 2,
           "sent_bytes_per_rank": {
               "planned": exchange_bytes(plan_step(idx, n_local, mesh, dev),
                                         cfg.data.store_len),
               "fixed": exchange_bytes(plan_fixed(idx, n_local, mesh, dev),
                                       cfg.data.store_len)},
           "sharded_ms": timed(lambda: sharded_corpus_gather(local, idx,
                                                             mesh)),
           "fixed_ms": timed(fixed),
           "replicated_ms": timed(lambda: whole[torch.from_numpy(mine).to(
               dev)])}
    del local, whole
    return out


def preset_checks(cfg, dev, out: Path) -> dict | None:
    """The in-process checks of one preset at dp = world size (the
    module docstring); rank 0's report, None elsewhere."""
    from audiogan_tpu_torch.config import MeshCfg
    from audiogan_tpu_torch.train.step import num_views
    rank, world = dist.get_rank(), dist.get_world_size()
    out.mkdir(parents=True, exist_ok=True)

    def on(c, dp, fsdp=False, **train):
        return c.replace(mesh=MeshCfg(dp=dp, fsdp=fsdp),
                         train=dataclasses.replace(c.train, **train))

    def batches(c, seed, n=2):
        return [random_raw(c, num_views(c), c.train.batch_size,
                                      seed + s) for s in range(n)]
    report = {"preset": cfg.name, "dp": world}
    # f32 at F32_BATCH against the dp=1 steps on rank 0's card, from one
    # warm state (the bf16 steps below start there too)
    c32 = on(cfg, 1, dtype="float32", batch_size=F32_BATCH)
    f32_batches = batches(c32, 40)
    warm = steps_job(dev, c32.to_json(), batches(c32, 30, 1), solo=True)
    if rank == 0:
        torch.save(warm, out / "warm.pt")
    dist.barrier()
    warm = torch.load(out / "warm.pt", weights_only=False)
    want = steps_job(dev, c32.to_json(), f32_batches, state=warm, solo=True)
    got = steps_job(dev, on(c32, world).to_json(), f32_batches, state=warm)
    if rank == 0:
        report["f32"] = compare_blobs(got, want, PARITY_REL_TOL,
                                      PARITY_PARAM_TOL)
        report["f32"]["batch"] = F32_BATCH
    del want
    if len(set(_gather(digest(got)))) != 1:
        raise AssertionError(f"{cfg.name} f32: ranks differ")
    # bf16 at the preset's batch: twice, and with ZeRO-1, to the bit
    bf_batches = batches(cfg, 50)
    runs = {name: steps_job(dev, on(cfg, world, fsdp).to_json(), bf_batches,
                            state=warm)
            for name, fsdp in (("a", False), ("b", False), ("fsdp", True))}
    digests = {name: _gather(digest(r)) for name, r in runs.items()}
    if len({d for ds in digests.values() for d in ds}) != 1:
        raise AssertionError(f"{cfg.name} bf16: states differ {digests}")
    launches = _gather(runs["a"]["launches"])
    hold_launches(launches, step_launches(cfg), len(bf_batches), cfg.name)
    rows = runs["fsdp"]["moment_rows"]
    if not any(kept * world == n for kept, n in rows.values()):
        raise AssertionError(f"ZeRO-1 kept whole moments: {rows}")
    want = steps_job(dev, on(cfg, 1).to_json(), bf_batches, state=warm,
                     solo=True)
    exact = steps_job(dev, on(cfg, 1, dtype="float32").to_json(),
                      bf_batches, state=warm, solo=True)
    if rank == 0:
        report["bf16"] = {
            "batch": cfg.train.batch_size, "steps": len(bf_batches),
            "ranks_runs_equal": 3 * world,
            "vs_dp1": hold_bf16_to_dp1(runs["a"], want, exact),
            "launches_per_rank_step": {k: v // len(bf_batches)
                                       for k, v in launches[0].items()},
            "seconds": runs["a"]["seconds"],
            "seconds_dp1": want["seconds"]}
    del runs, want, exact, warm
    # the all-reduces' device time in one profiled step
    prof = _profile_step(on(cfg, world), dev, make_mesh(on(cfg, world)),
                         *bf_batches[0])
    report["profile_rank0"] = prof
    report["profile_nccl_ms_by_rank"] = [p["nccl_ms"]
                                         for p in _gather(prof)]
    report["allreduce"] = allreduce_ms(cfg, dev)
    report["corpus_exchange"] = _gather(corpus_exchange_ms(cfg, dev))
    # the loop on the sharded corpus against the replicated one
    loop_runs = {}
    for mode in ("replicate", "shard"):
        c = on(cfg, world, log_every=1).replace(data=dataclasses.replace(
            cfg.data, device_corpus=True, device_corpus_shard=mode))
        loop_runs[mode] = train_job(dev, c.to_json(), str(out / mode), 2,
                                    resume=False)
    dg = {m: _gather(digest(r)) for m, r in loop_runs.items()}
    if len({d for ds in dg.values() for d in ds}) != 1:
        raise AssertionError(f"{cfg.name}: sharded corpus differs")
    if rank == 0:
        lines = [[{k: v for k, v in ln.items() if k != "seconds"}
                  for ln in r["lines"] if "step" in ln]
                 for r in loop_runs.values()]
        if lines[0] != lines[1] or len(lines[0]) != 2:
            raise AssertionError(f"{cfg.name}: sharded records {lines}")
        report["sharded_corpus"] = {"equal_records": len(lines[0]),
                                    "placements": [
            ln["init"]["corpus"] for r in loop_runs.values()
            for ln in r["lines"] if "init" in ln]}
    return report if rank == 0 else None


CP_MESHES = ((1, 4), (2, 2))
# --cp: the presets it takes (--presets), music alone by default
CP_PRESETS = ("music_44k_dp16", "cond_gru_sc09", "dual_stft")


def cp_plan(presets: list[str] | None, ranks: int) -> dict:
    """What ``--cp`` runs for ``presets`` (None: CP_PRESETS' first, music
    alone) on ``ranks`` cards: each preset's in-process checks
    (``cp_checks``), its cli train rates at cp = ranks and at dp=2 x
    cp = ranks / 2, and its cp = ranks run killed and resumed."""
    presets = list(presets or CP_PRESETS[:1])
    bad = sorted(set(presets) - set(CP_PRESETS))
    if bad:
        raise ValueError(f"--cp takes {list(CP_PRESETS)}, not {bad}")
    return {"checks": presets,
            "rates": [(p, cp) for p in presets for cp in (ranks, ranks // 2)],
            "resume": [(p, ranks) for p in presets]}


def cp_checks(cfg, dev, out: Path) -> dict | None:
    """The in-process checks of the context-parallel step of one preset
    on four ranks (the module docstring); rank 0's report, None
    elsewhere."""
    from audiogan_tpu_torch.config import MeshCfg
    from audiogan_tpu_torch.tools.step_checks import cp_step_launches
    from audiogan_tpu_torch.train.step import num_views
    rank, world = dist.get_rank(), dist.get_world_size()
    out.mkdir(parents=True, exist_ok=True)

    def on(c, dp=1, cp=1, **train):
        return c.replace(mesh=MeshCfg(dp=dp, cp=cp),
                         train=dataclasses.replace(c.train, **train))

    def batches(c, seed, n=2):
        return [random_raw(c, num_views(c), c.train.batch_size, seed + s)
                for s in range(n)]
    report = {"preset": cfg.name, "world": world}
    # f32 at F32_BATCH, shuffle off: cp=world against the cp step at cp=1
    # on rank 0's card, from one warm state (the runs below start there)
    c32 = on(cfg, dtype="float32", batch_size=F32_BATCH).replace(
        model=dataclasses.replace(cfg.model, phase_shuffle=0))
    warm = steps_job(dev, c32.to_json(), batches(c32, 30, 1), solo=True,
                     step="cp")
    if rank == 0:
        torch.save(warm, out / "warm.pt")
    dist.barrier()
    warm = torch.load(out / "warm.pt", weights_only=False)
    f32_batches = batches(c32, 40)
    want = steps_job(dev, c32.to_json(), f32_batches, state=warm, solo=True,
                     step="cp")
    got = steps_job(dev, on(c32, cp=world).to_json(), f32_batches,
                    state=warm)
    if rank == 0:
        # held to the parity bounds: an error beyond one is reported under
        # "failed", and main exits non-zero after the other checks and
        # measurements have run
        report["f32"] = parity_errors(got, want)
        report["f32"].update(batch=F32_BATCH, cp=world,
                             failed=report["f32"]["over"])
    if len(set(_gather(digest(got)))) != 1:
        raise AssertionError(f"{cfg.name} f32 cp: ranks differ")
    del want, got
    # the preset's batch and config (its cp step computes in f32) at each
    # mesh: twice to the same bits on every rank, launches, routes, the
    # exchanges' device time and the peak memory per rank
    runs = batches(cfg, 50)
    want_l = {**cp_step_launches(cfg), "ingest": num_views(cfg)}
    for dp, cp in CP_MESHES:
        c = on(cfg, dp, cp)
        a, b = (steps_job(dev, c.to_json(), runs, state=warm)
                for _ in range(2))
        digests = _gather((digest(a), digest(b)))
        if len({d for pair in digests for d in pair}) != 1:
            raise AssertionError(f"{cfg.name} dp={dp} cp={cp}: states "
                                 f"differ {digests}")
        hold_launches(_gather(a["launches"]), want_l, len(runs),
                      f"dp={dp} cp={cp}")
        prof = _gather(_profile_step(c, dev, make_mesh(c), *runs[0]))
        if rank == 0:
            report[f"dp{dp}_cp{cp}"] = {
                "batch": cfg.train.batch_size, "steps": len(runs),
                "states_equal": 2 * world,
                "launches_per_rank_step": {k: v // len(runs) for k, v in
                                           a["launches"].items()},
                "routes_per_rank_step": {k: v // len(runs) for k, v in
                                         a["routes"].items()},
                "seconds": a["seconds"], "profile_by_rank": prof,
                "last": a["metrics"][-1]}
        del a, b
    # the same batch at dp=1 on rank 0's card: the plain step in the
    # preset's dtype and in f32, its peak memory and time
    for dtype in (cfg.train.dtype, "float32"):
        if rank == 0:
            report[f"dp1_{dtype}"] = _profile_step(
                on(cfg, dtype=dtype), dev, DataMesh(), *runs[0])
        dist.barrier()
    return report if rank == 0 else None


# --tp: per preset, the meshes (dp, tp) of the in-process checks, whether
# to hold f32 at tp=4 to tp=1 and whether to profile a step per mesh
TP_PRESETS = ("wgan_gp_b64", "cond_gru_sc09", "music_44k_dp16")
TP_PLAN = {"wgan_gp_b64": (((2, 2), (1, 4)), True, True),
           "cond_gru_sc09": (((2, 2),), False, False),
           "music_44k_dp16": (((1, 4),), False, True)}


def tp_checks(cfg, dev, out: Path) -> dict | None:
    """The in-process checks of the tensor-parallel step of one preset
    on four ranks (the module docstring); rank 0's report, None
    elsewhere."""
    from audiogan_tpu_torch.config import MeshCfg
    from audiogan_tpu_torch.tools.step_checks import tp_step_launches
    from audiogan_tpu_torch.train.step import num_views
    rank, world = dist.get_rank(), dist.get_world_size()
    meshes, parity, profile = TP_PLAN[cfg.name]
    out.mkdir(parents=True, exist_ok=True)

    def on(c, dp=1, tp=1, **train):
        return c.replace(mesh=MeshCfg(dp=dp, tp=tp),
                         train=dataclasses.replace(c.train, **train))

    def batches(c, seed, n=2):
        return [random_raw(c, num_views(c), c.train.batch_size, seed + s)
                for s in range(n)]
    report = {"preset": cfg.name, "world": world}
    # one warm state for the runs below: the tp step at tp=1 on rank 0's
    # card (f32, B=8, shuffle off)
    c32 = on(cfg, dtype="float32", batch_size=F32_BATCH).replace(
        model=dataclasses.replace(cfg.model, phase_shuffle=0))
    warm = steps_job(dev, c32.to_json(), batches(c32, 30, 1), solo=True,
                     step="tp")
    if rank == 0:
        torch.save(warm, out / "warm.pt")
    dist.barrier()
    warm = torch.load(out / "warm.pt", weights_only=False)
    if parity:
        # tp=world against tp=1 and the plain step (parity_job); a held
        # comparison beyond a bound is reported, and main exits non-zero
        # after the other checks and measurements have run
        got = parity_job(dev, on(c32, tp=world).to_json(), "tp",
                         str(out / "parity"))
        if rank == 0:
            report["f32"] = dict(got["report"], batch=F32_BATCH, tp=world)
    # the preset's batch and config (G in its dtype, the critic in f32)
    # at each mesh: twice to the same bits on every rank, launches, and
    # with ``profile`` the collectives' device time and peak memory
    runs = batches(cfg, 50)
    want_l = {**tp_step_launches(cfg), "ingest": num_views(cfg)}
    for dp, tp in meshes:
        c = on(cfg, dp, tp)
        a, b = (steps_job(dev, c.to_json(), runs, state=warm)
                for _ in range(2))
        digests = _gather((digest(a), digest(b)))
        if len({d for pair in digests for d in pair}) != 1:
            raise AssertionError(f"{cfg.name} dp={dp} tp={tp}: states "
                                 f"differ {digests}")
        hold_launches(_gather(a["launches"]), want_l, len(runs),
                      f"{cfg.name} dp={dp} tp={tp}")
        entry = {"batch": cfg.train.batch_size, "steps": len(runs),
                 "states_equal": 2 * world,
                 "launches_per_rank_step": {k: v // len(runs) for k, v in
                                            a["launches"].items()},
                 "seconds": a["seconds"], "last": a["metrics"][-1]}
        del a, b
        if profile:
            entry["profile_by_rank"] = _gather(_profile_step(
                c, dev, make_mesh(c), *runs[0]))
        if rank == 0:
            report[f"dp{dp}_tp{tp}"] = entry
    return report if rank == 0 else None


# --dryrun: one full-width flagship step at each mesh, every metric finite
DRYRUN_MESHES = ((2, 2, 1, False), (2, 1, 2, False), (2, 2, 1, True),
                 (2, 1, 2, True))


def dryrun_checks(dev) -> dict | None:
    """One step of the flagship (B=64, its dtype) from the seeded init at
    each (dp, cp, tp, fsdp) of DRYRUN_MESHES on four ranks: every metric
    finite, the ranks' states equal (the counterpart of the reference's
    multi-device dry run of its cp and tp steps, __graft_entry__.py:
    211-253); rank 0's report, None elsewhere."""
    from audiogan_tpu_torch.config import MeshCfg, get_preset
    from audiogan_tpu_torch.train.step import num_views
    cfg = get_preset("wgan_gp_b64")
    report = {}
    for dp, cp, tp, fsdp in DRYRUN_MESHES:
        c = cfg.replace(mesh=MeshCfg(dp=dp, cp=cp, tp=tp,
                                     fsdp=fsdp)).validate()
        raw = random_raw(c, num_views(c), c.train.batch_size, 70)
        got = steps_job(dev, c.to_json(), [raw])
        last = got["metrics"][-1]
        bad = [k for k, v in last.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"dryrun dp={dp} cp={cp} tp={tp} "
                                 f"fsdp={fsdp}: {bad} not finite")
        if len(set(_gather(digest(got)))) != 1:
            raise AssertionError(f"dryrun dp={dp} cp={cp} tp={tp} "
                                 f"fsdp={fsdp}: ranks differ")
        report[f"dp{dp}_cp{cp}_tp{tp}" + ("_fsdp" if fsdp else "")] = {
            "metrics": last, "seconds": got["seconds"]}
    return report if dist.get_rank() == 0 else None


def worker_main(work: Path, presets: tuple[str, ...] = PRESETS,
                cp: bool = False, tp: bool = False,
                dryrun: bool = False) -> int:
    """--worker: one rank under torchrun (NCCL on cuda:LOCAL_RANK); its
    workdirs under ``work``. A rank that fails exits at once
    (multihost.exit_after_failure), and torchrun ends the others."""
    from audiogan_tpu_torch.device import resolve_device
    dev = resolve_device(None)
    maybe_initialize_distributed(dev, "nccl", WORKER_TIMEOUT_S)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = dist.get_world_size()
    try:
        for name in presets:
            cfg = preset_config(name, f"mesh.dp={world}")
            t0 = time.time()
            one = cfg.replace(mesh=dataclasses.replace(cfg.mesh, dp=1))
            if cp:
                rep = cp_checks(one, dev, work / f"{name}_cp")
            elif tp:
                rep = tp_checks(one, dev, work / f"{name}_tp")
            else:
                rep = preset_checks(cfg, dev, work / name)
            if rep is not None:
                rep["seconds"] = time.time() - t0
                print(json.dumps({"check": rep}), flush=True)
        if dryrun:
            t0 = time.time()
            rep = dryrun_checks(dev)
            if rep is not None:
                print(json.dumps({"dryrun": rep,
                                  "seconds": time.time() - t0}), flush=True)
    except Exception:
        exit_after_failure()
    dist.destroy_process_group()
    return 0


def _torchrun(ranks: int, *args) -> list[str]:
    return [sys.executable, "-m", "torch.distributed.run",
            "--nproc_per_node", str(ranks), "--master_addr", "127.0.0.1",
            "--master_port", str(free_port()), *map(str, args)]


def _cli(*args) -> list[str]:
    return ["-m", "audiogan_tpu_torch.cli", "train", *map(str, args),
            "--no_tensorboard"]


def _run(cmd: list[str], log: Path, env=None) -> tuple[list[dict], float]:
    """Runs cmd (its process tree ended after RUN_TIMEOUT_S), its output
    kept in log.out and log.err as it is written, so a run that hangs
    leaves its log; the JSON lines of its output and its seconds."""
    log.parent.mkdir(parents=True, exist_ok=True)
    out, err = (log.with_name(f"{log.name}.{k}") for k in ("out", "err"))
    t0 = time.time()
    with out.open("w") as fo, err.open("w") as fe:
        fe.write(" ".join(cmd) + "\n")
        fe.flush()
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=fo, stderr=fe,
                                text=True, env=env)
        try:
            rc = proc.wait(timeout=RUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            _kill_tree(proc)
            rc = f"timeout after {RUN_TIMEOUT_S} s"
    text = out.read_text()
    if rc:
        raise RuntimeError(f"{' '.join(cmd)} exited {rc}:\n{text[-2000:]}"
                           f"\n{err.read_text()[-4000:]}")
    return ([json.loads(ln) for ln in text.splitlines()
             if ln.startswith("{")], time.time() - t0)


def _records(workdir: Path) -> dict[int, dict]:
    return {r["step"]: r for r in map(
        json.loads, (workdir / "metrics.jsonl").read_text().splitlines())}


def _mesh_sets(ranks: int, cp: int, tp: int) -> list[str]:
    return ["--set", f"mesh.dp={ranks // (cp * tp)}", "--set",
            f"mesh.cp={cp}", "--set", f"mesh.tp={tp}"]


def rate(preset: str, ranks: int, workdir: Path, cp: int = 1,
         tp: int = 1) -> dict:
    """cli train of the preset at dp = ranks / (cp tp), cp and tp
    (torchrun; one plain process on card 0 at 1): steps/s of steps
    RATE_LOG + 1 to RATE_STEPS."""
    base, own = preset_sets(preset)
    sets = [*_mesh_sets(ranks, cp, tp),
            "--set", f"train.log_every={RATE_LOG}", "--set",
            "train.ckpt_every=0", "--set", "train.sample_every=0",
            *[a for item in own for a in ("--set", item)]]
    args = _cli("--preset", base, "--total_steps", RATE_STEPS,
                "--workdir", workdir, *sets)
    if ranks == 1:
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="0")
        _, secs = _run([sys.executable, *args], workdir / "run", env)
    else:
        _, secs = _run(_torchrun(ranks, *args), workdir / "run")
    recs = _records(workdir)
    window = [recs[s]["steps_per_sec"]
              for s in range(2 * RATE_LOG, RATE_STEPS + 1, RATE_LOG)]
    return {"preset": preset, "dp": ranks // (cp * tp), "cp": cp, "tp": tp,
            "batch_per_rank": 64 // (ranks // (cp * tp)),
            "steps_per_s": sum(window) / len(window), "windows": window,
            "seconds": secs,
            "last": {k: recs[RATE_STEPS][k] for k in
                     ("d_loss", "g_loss", "w_dist", "gp")}}


def _descendants(pid: int) -> list[int]:
    """Every live process below pid (from /proc), children first."""
    children: dict[int, list[int]] = {}
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        children.setdefault(int(fields[1]), []).append(int(stat.parent.name))
    out, todo = [], [pid]
    while todo:
        kids = children.get(todo.pop(), [])
        out += kids
        todo += kids
    return out


def _alive(pid: int) -> bool:
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1]
    except OSError:
        return False
    return state.split()[0] != "Z"


def _kill_tree(proc: subprocess.Popen) -> None:
    """SIGKILL torchrun and every worker it started (the workers run in
    sessions of their own, so the agent's process group misses them),
    then wait until none is left."""
    pids = [proc.pid, *_descendants(proc.pid)]
    for pid in pids:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    proc.wait(timeout=120)
    deadline = time.time() + 120
    while any(_alive(pid) for pid in pids):
        if time.time() > deadline:
            raise AssertionError(f"processes outlived SIGKILL: {pids}")
        time.sleep(0.1)


def kill_and_resume(ranks: int, base: Path, preset: str = "wgan_gp_b64",
                    cp: int = 1, tp: int = 1) -> dict:
    """The preset at dp = ranks / (cp tp), cp and tp: uninterrupted to
    RESUME_STEPS, and killed (the whole process group) when it logs its
    RESUME_KILL_AT checkpoint, then run again: the same last record (but
    time and rates) and checkpoint, to the bit."""
    def cmd(workdir):
        return _torchrun(ranks, *_cli(
            "--preset", preset, "--total_steps", RESUME_STEPS,
            *_mesh_sets(ranks, cp, tp),
            "--set", f"train.ckpt_every={RESUME_KILL_AT}", "--set",
            "train.log_every=1", "--workdir", workdir))
    a, b = base / "a", base / "b"
    _, a_s = _run(cmd(a), base / "a_run")
    t0 = time.time()
    proc = subprocess.Popen(cmd(b), cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    killed = False
    try:
        for raw in proc.stdout:
            if raw.startswith('{"ckpt"') and \
                    json.loads(raw)["ckpt"]["step"] == RESUME_KILL_AT:
                _kill_tree(proc)
                killed = True
                break
    finally:
        if not killed:
            _kill_tree(proc)
        proc.stdout.close()
    k_s = time.time() - t0
    if not killed:
        raise AssertionError("the run was not killed at its checkpoint")
    left = sorted(int(q.stem) for q in (b / "ckpt").glob("*.pt"))
    if left != [RESUME_KILL_AT]:
        raise AssertionError(f"the killed run left {left}")
    lines, r_s = _run(cmd(b), base / "b_run")
    restored = [ln["resume"]["step"] for ln in lines if "resume" in ln]
    if restored != [RESUME_KILL_AT]:
        raise AssertionError(f"the second run restored {restored}")
    ra, rb = _records(a)[RESUME_STEPS], _records(b)[RESUME_STEPS]
    keys = sorted(k for k in ra if k != "time" and "per_sec" not in k)
    if any(ra[k] != rb.get(k) for k in keys):
        raise AssertionError(f"step {RESUME_STEPS} differs: {ra} != {rb}")
    last = f"ckpt/{RESUME_STEPS}.pt"
    n = same_checkpoint(a / last, b / last)
    return {"preset": preset, "dp": ranks // (cp * tp), "cp": cp, "tp": tp,
            "restored_step": restored[0],
            "compared_keys": keys, "tensors_equal": n,
            "seconds": {"uninterrupted": a_s, "killed": k_s,
                        "resumed": r_s}, "w_dist": rb["w_dist"]}


# --graph: (name, dp, cp, tp, --set overrides) of each mesh whose step
# cli train captures with train.dump_hlo on four ranks
GRAPH_CASES = (
    ("wgan_gp_b64", 4, 1, 1, ()),
    ("wgan_gp_b64", 4, 1, 1, ("mesh.fsdp=true",)),
    ("wgan_gp_b64", 4, 1, 1, ("data.device_corpus_shard=shard",)),
    ("music_44k_dp16", 2, 2, 1, ()),
    ("wgan_gp_b64", 2, 1, 2, ()),
    ("cond_gru_sc09", 4, 1, 1, ()),
    # one data replica: the sharded corpus's plan is the indices
    # themselves, a row of the resident block where it lies
    ("music_44k_dp16", 1, 4, 1, ("data.device_corpus_shard=shard",)),
    ("music_44k_dp16", 1, 1, 4, ()))
GRAPH_STEPS = 6
# --graph's failing rank: (preset, dp, cp, tp, the rank whose dump's
# warm-up fails); the run must end on every rank within FAULT_RUN_S, far
# inside the group's timeout (parallel/multihost.py::TIMEOUT_S)
GRAPH_FAULT = ("wgan_gp_b64", 4, 1, 1, 2)
FAULT_RUN_S = 240


def graph_case(name: str, dp: int, cp: int, tp: int, sets: tuple,
               base: Path, eager: Path | None = None) -> dict:
    """The preset on the mesh under torchrun for GRAPH_STEPS steps, twice
    through ``--cli_worker``: replayed (the loop's route on NCCL: the
    first step eager, the second captured, the rest replayed) with
    train.dump_hlo on, and (unless ``eager`` holds one already) every step
    eager. The dump: every rank's replay equal to its eager step, its
    NCCL kernel nodes equal to its collectives and to
    ``step_collectives``, the ranks' collectives equal (dump_step raises
    otherwise). The runs: every step's record and the checkpoints of
    steps GRAPH_STEPS / 2 and GRAPH_STEPS equal to the bit (the
    checkpoint holds every rank's ZeRO-1 block; the other tensors every
    rank holds alike); both rates (steps/s of the steps after the
    capture), each rank's peak memory, its last step's NCCL and device
    ms (torch.profiler around that step or replay), its capture's nodes
    and seconds. The rates leave out the capture's step and the
    profiled last one."""
    from audiogan_tpu_torch.tools.step_checks import step_collectives
    from audiogan_tpu_torch.train.step_graph import read_summary
    ranks = dp * cp * tp
    tag = "_".join([name, f"dp{dp}", f"cp{cp}", f"tp{tp}",
                    *[x.split("=")[0].split(".")[-1] for x in sets]])

    def cmd(workdir, mode):
        extra = [*sets, f"train.dump_hlo={str(mode == 'replay').lower()}",
                 f"train.ckpt_every={GRAPH_STEPS // 2}",
                 "train.log_every=1", "train.sample_every=0"]
        return _torchrun(ranks, "-m", "audiogan_tpu_torch.tools.dp_check",
                         "--cli_worker", mode, workdir / "ranks",
                         *_cli("--preset", name, "--total_steps",
                               GRAPH_STEPS, *_mesh_sets(ranks, cp, tp),
                               *[a for item in extra
                                 for a in ("--set", item)],
                               "--workdir", workdir)[2:])
    replayed = base / f"{tag}_replay"
    _, secs = _run(cmd(replayed, "replay"), base / f"{tag}_replay_run")
    if eager is None:
        eager = base / f"{tag}_eager"
        _run(cmd(eager, "eager"), base / f"{tag}_eager_run")
    summary = read_summary(replayed)
    per_rank = summary["ranks"]
    expected = step_collectives(
        preset_config(name, *sets, f"mesh.dp={dp}", f"mesh.cp={cp}",
                      f"mesh.tp={tp}"), summary["sharded_corpus"])
    for r, rec in enumerate(per_rank):
        if not rec["replay_equals_eager"]:
            raise AssertionError(f"{tag} rank {r}: the replay differs in "
                                 f"{rec['replay_differs_in']}")
        if not (rec["nccl_kernel_nodes"] == rec["collectives"]
                == expected):
            raise AssertionError(
                f"{tag} rank {r}: NCCL nodes {rec['nccl_kernel_nodes']}, "
                f"collectives {rec['collectives']}, the structure's "
                f"{expected}")
    ra, rb = _records(replayed), _records(eager)
    keys = sorted(k for k in ra[GRAPH_STEPS] if k != "time"
                  and "per_sec" not in k)
    for step in range(1, GRAPH_STEPS + 1):
        if any(ra[step][k] != rb[step].get(k) for k in keys):
            raise AssertionError(f"{tag}: step {step} of the replayed run "
                                 f"differs from the eager run's: "
                                 f"{ra[step]} != {rb[step]}")
    tensors = {s: same_checkpoint(replayed / f"ckpt/{s}.pt",
                                  eager / f"ckpt/{s}.pt")
               for s in (GRAPH_STEPS // 2, GRAPH_STEPS)}
    worker = {mode: [json.loads((w / "ranks" / f"rank{r}.json").read_text())
                     for r in range(ranks)]
              for mode, w in (("replay", replayed), ("eager", eager))}
    if any(w["route"] != "replay" for w in worker["replay"]) or \
            any(w["graph"] is None or w["graph"]["step"] != 1
                for w in worker["replay"]):
        raise AssertionError(f"{tag}: the replayed run did not capture its "
                             f"second step on every rank: {worker}")

    def rate(recs):
        # the steps after the capture's, but the last: it runs under
        # torch.profiler (``cli_worker``)
        after = [recs[s]["steps_per_sec"] for s in range(3, GRAPH_STEPS)]
        return len(after) / sum(1 / v for v in after)
    return {"case": tag, "preset": name, "dp": dp, "cp": cp, "tp": tp,
            "sets": list(sets), "ranks": ranks,
            "steps_per_s": {"replay": rate(ra), "eager": rate(rb)},
            "per_rank": {mode: [{k: w[k] for k in
                                 ("peak_memory_gib", "last_step")}
                                for w in ws]
                         for mode, ws in worker.items()},
            "loop_graph_rank0": worker["replay"][0]["graph"],
            "dump": {"nodes": [r["nodes"] for r in per_rank],
                     "by_kind": [r["by_kind"] for r in per_rank],
                     "nccl_kernel_nodes": [r["nccl_kernel_nodes"]
                                           for r in per_rank],
                     "capture_seconds": [r["capture_seconds"]
                                         for r in per_rank],
                     "replay_equals_eager": [r["replay_equals_eager"]
                                             for r in per_rank],
                     "counts_agree_across_ranks": summary[
                         "counts_agree_across_ranks"]},
            "collectives_expected": expected,
            "port_kernels_rank0": summary["port_kernels"],
            "equal": {"record_keys": keys, "steps": GRAPH_STEPS,
                      "checkpoint_tensors": tensors},
            "replay_run_seconds": secs}


def cli_worker(mode: str, out_dir: str, argv: list[str]) -> int:
    """``--cli_worker MODE DIR``: one rank of ``cli train`` (``argv``:
    cli's arguments) under torchrun, its loop replaying (MODE "replay":
    the loop's own route) or every step eager ("eager":
    train.loop.train's ``replay=False``, which no Config field or cli flag
    reaches). The rank's last step (its replay, or its eager step) runs
    under torch.profiler; DIR/rank<R>.json gets the route the loop named,
    its capture's summary, that step's NCCL and device ms and the rank's
    peak memory."""
    from torch.profiler import ProfilerActivity, profile

    from audiogan_tpu_torch import cli
    from audiogan_tpu_torch.train import loop, step_graph
    rank = int(os.environ.get("RANK", "0"))
    rec: dict = {"graph": None, "last_step": None}
    train, capture = loop.train, step_graph.StepGraph.capture
    run = "replay" if mode == "replay" else "eager"
    timed = getattr(step_graph.StepGraph, run)
    total: dict = {}

    def routed(cfg, workdir, steps=None, **kw):
        total["steps"] = cfg.train.total_steps if steps is None else steps
        return train(cfg, workdir, steps, **kw, replay=mode == "replay")

    def captured(self, state):
        capture(self, state)
        rec["graph"] = {"step": state.step, **self.summary()}

    card = torch.cuda.is_available()

    def sync():
        if card:
            torch.cuda.synchronize()

    def last(self, state):
        if state.step != total["steps"] - 1:
            return timed(self, state)
        sync()
        with profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if card else [])) as prof:
            t0 = time.perf_counter()
            out = timed(self, state)
            sync()
            wall = (time.perf_counter() - t0) * 1e3
        rec["last_step"] = {"wall_ms": wall, **device_split(prof)}
        return out

    def route(device, replay=True):
        rec["route"] = loop_route(device, replay)
        return rec["route"]
    loop_route = loop.step_route
    loop.train, loop.step_route = routed, route
    step_graph.StepGraph.capture = captured
    setattr(step_graph.StepGraph, run, last)
    code = cli.main(argv)
    dev = torch.device(f"cuda:{os.environ.get('LOCAL_RANK', '0')}")
    rec["peak_memory_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                              if card else None)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"rank{rank}.json").write_text(json.dumps(rec))
    return code or 0


def inject_dump_fault() -> None:
    """Makes train.dump_hlo's first run of the step in this process (on
    the card its warm-up, train/step_graph.py::dump_step) raise before
    it issues a collective, so the peers of this rank wait in theirs."""
    from audiogan_tpu_torch.train import loop
    dump = loop.dump_step

    def failing(cfg, state, step_fn, *args, **kw):
        def step(*a, **k):
            raise RuntimeError("a fault injected into the dump's first run "
                               "of the step")
        return dump(cfg, state, step, *args, **kw)
    loop.dump_step = failing


def dump_fault_worker(fail_rank: int, pid_dir: str, argv: list[str]) -> int:
    """``--dump_fault RANK DIR``: one rank of ``cli train`` (``argv``:
    cli's arguments) under torchrun, with ``inject_dump_fault`` on rank
    RANK; each rank writes its pid to DIR/rank<r>.pid first, and prints
    its threads' stacks on SIGUSR1 (``graph_fault_case`` sends it to a
    run that outlives its limit)."""
    import faulthandler

    from audiogan_tpu_torch import cli
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    rank = int(os.environ["RANK"])
    (Path(pid_dir) / f"rank{rank}.pid").write_text(str(os.getpid()))
    if rank == fail_rank:
        inject_dump_fault()
    return cli.main(argv)


def graph_fault_case(name: str, dp: int, cp: int, tp: int, fail_rank: int,
                     base: Path, *extra: str) -> dict:
    """``cli train --set train.dump_hlo=true`` of the preset on the mesh
    under torchrun with rank ``fail_rank``'s dump failing in its warm-up
    (``--dump_fault``); ``extra``: more cli arguments. Holds that torchrun
    exits non-zero within FAULT_RUN_S (else its tree is killed and the
    case fails), that its failure summary names ``fail_rank`` with a
    non-zero exit code, that every other rank exited non-zero too or was
    ended by torchrun's closing signal, that no worker outlives it and
    that the failing rank's error names it (train/step_graph.py). Reports
    each rank's end and that error line."""
    import re
    ranks = dp * cp * tp
    tag = f"{name}_dp{dp}_cp{cp}_tp{tp}_fault{fail_rank}"
    extra_sets = ["train.dump_hlo=true", "train.log_every=1",
                  "train.sample_every=0"]
    pid_dir = base / f"{tag}_pids"
    pid_dir.mkdir(parents=True, exist_ok=True)
    cmd = _torchrun(ranks, "-m", "audiogan_tpu_torch.tools.dp_check",
                    "--dump_fault", fail_rank, pid_dir, *_cli(
                        "--preset", name, "--total_steps", GRAPH_STEPS,
                        *_mesh_sets(ranks, cp, tp),
                        *[a for item in extra_sets for a in ("--set", item)],
                        "--workdir", base / tag, *extra)[2:])
    log = base / f"{tag}_run"
    log.parent.mkdir(parents=True, exist_ok=True)
    out, err = (log.with_name(f"{log.name}.{k}") for k in ("out", "err"))
    t0 = time.time()
    with out.open("w") as fo, err.open("w") as fe:
        fe.write(" ".join(map(str, cmd)) + "\n")
        fe.flush()
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=fo, stderr=fe,
                                text=True)
        try:
            proc.wait(timeout=FAULT_RUN_S)
        except subprocess.TimeoutExpired:
            # where each rank waits, into the log, before the tree goes
            for f in pid_dir.glob("rank*.pid"):
                try:
                    os.kill(int(f.read_text()), signal.SIGUSR1)
                except ProcessLookupError:
                    pass
            time.sleep(5)
            _kill_tree(proc)
    secs = time.time() - t0
    text = err.read_text()
    pids = {int(f.read_text()): int(f.stem[4:])
            for f in pid_dir.glob("rank*.pid")}
    # torchrun's failure summary: each failed rank's exit code and pid
    failed = {int(r): (int(code), int(pid)) for r, code, pid in re.findall(
        r"rank\s*:\s*(\d+) \(local_rank: \d+\)\s*exitcode\s*:\s*(-?\d+) "
        r"\(pid: (\d+)\)", text)}
    closed = {int(pid) for pid in re.findall(
        r"process (\d+) (?:closing signal|via signal)", text)}
    ends = {}
    for pid, rank in sorted(pids.items(), key=lambda kv: kv[1]):
        if rank in failed:
            ends[rank] = f"exit {failed[rank][0]}"
        elif pid in closed:
            ends[rank] = "ended by torchrun's closing signal"
    alive = sorted(pid for pid in pids if _alive(pid))
    # the failing rank's own error, naming it
    named = [ln for ln in text.splitlines()
             if "Error:" in ln and f"rank {fail_rank} " in ln]
    rep = {"case": tag, "preset": name, "dp": dp, "cp": cp, "tp": tp,
           "fail_rank": fail_rank, "ranks": ranks, "seconds": secs,
           "limit_seconds": FAULT_RUN_S, "returncode": proc.returncode,
           "rank_ends": ends, "failed_ranks": sorted(failed),
           "alive_after": alive, "error": named[-1:] or None}
    problems = []
    if secs > FAULT_RUN_S or proc.returncode in (0, None):
        problems.append(f"torchrun returned {proc.returncode} after "
                        f"{secs:.1f} s (limit {FAULT_RUN_S} s)")
    if failed.get(fail_rank, (0,))[0] == 0:
        problems.append(f"the summary does not name rank {fail_rank} with "
                        f"a non-zero exit code: {sorted(failed)}")
    if sorted(ends) != list(range(ranks)) or any(
            v == "exit 0" for v in ends.values()):
        problems.append(f"not every rank ended non-zero: {ends}")
    if alive:
        problems.append(f"workers alive after torchrun: {alive}")
    if not named:
        problems.append(f"no error names rank {fail_rank}")
    if problems:
        raise AssertionError(f"{tag}: {'; '.join(problems)}: "
                             f"{json.dumps(rep)}\n{out.read_text()[-1000:]}"
                             f"\n{text[-4000:]}")
    return rep


def graph_checks(base: Path, names: list[str]) -> list[dict]:
    """``graph_case`` of each GRAPH_CASES entry whose preset is in
    ``names``, then ``graph_fault_case`` of GRAPH_FAULT if its preset is;
    the flagship's dp=4 cases share one run without the dump (ZeRO-1 and
    the sharded corpus train the replicated bits). A case that fails is
    reported and the next one runs."""
    out, plain = [], {}
    cases = [c for c in GRAPH_CASES if c[0] in names]
    if GRAPH_FAULT[0] in names:
        cases.append(GRAPH_FAULT)
    for name, dp, cp, tp, sets in cases:
        key = (name, dp, cp, tp)
        t0 = time.time()
        try:
            if isinstance(sets, int):
                rep = graph_fault_case(name, dp, cp, tp, sets, base)
            else:
                rep = graph_case(name, dp, cp, tp, sets, base,
                                 plain.get(key))
                plain.setdefault(key, base / f"{rep['case']}_eager")
        except Exception as err:           # noqa: BLE001 - reported
            rep = {"preset": name, "dp": dp, "cp": cp, "tp": tp,
                   "sets": sets, "failed": f"{type(err).__name__}: "
                                           f"{err}"[-3000:]}
        rep["seconds"] = time.time() - t0
        print(json.dumps({"graph": rep}), flush=True)
        out.append(rep)
    return out


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--dump_fault"]:
        return dump_fault_worker(int(argv[1]), argv[2], argv[3:])
    if argv[:1] == ["--cli_worker"]:
        return cli_worker(argv[1], argv[2], argv[3:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/dp_check/results",
                    help="where dp_check.jsonl goes (relative to the repo)")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--presets", nargs="+",
                    choices=sorted({*DP_PRESETS, *TP_PRESETS,
                                    *CP_PRESETS}),
                    help="the presets to check (default: the mode's)")
    ap.add_argument("--checks_only", action="store_true",
                    help="only the in-process checks: no cli train rates, "
                         "no kill-and-resume")
    ap.add_argument("--cp", action="store_true",
                    help="context parallelism instead: each of --presets "
                         f"(of {', '.join(CP_PRESETS)}; default "
                         "music_44k_dp16 alone) at cp=4 and at dp=2 x cp=2 "
                         "(the in-process checks, cli train's rates, a cp=4 "
                         "run killed and resumed)")
    ap.add_argument("--tp", action="store_true",
                    help="tensor parallelism instead: the flagship at "
                         "dp=2 x tp=2 and tp=4, cond_gru_sc09 at dp=2 x "
                         "tp=2, music_44k_dp16 at tp=4 (the in-process "
                         "checks, cli train's rates, the flagship killed "
                         "and resumed at both meshes)")
    ap.add_argument("--dryrun", action="store_true",
                    help="one full-width flagship step at dp=2 x cp=2 and "
                         "dp=2 x tp=2, each with and without mesh.fsdp: "
                         "every metric finite (alone: only this)")
    ap.add_argument("--graph", action="store_true",
                    help="only train.dump_hlo on four ranks: cli train "
                         "captures each rank's step for the flagship at "
                         "dp=4 (replicated, mesh.fsdp, sharded corpus), "
                         "music at dp=2 x cp=2, the flagship at dp=2 x "
                         "tp=2, cond_gru_sc09 at dp=4 and music at dp=1 x "
                         "cp=4 on the sharded corpus, each held to a run "
                         "without the dump; then the flagship at dp=4 "
                         "with rank 2's dump failing in its warm-up")
    ap.add_argument("--worker", action="store_true",
                    help="one rank under torchrun (internal)")
    args = ap.parse_args(argv)
    out = (ROOT / args.out).resolve()
    # workdirs and checkpoints: build/, which neither git nor the chip
    # tool's output directory takes
    work = ROOT / "build" / "dp_check"
    graph_names = args.presets or sorted({c[0] for c in GRAPH_CASES})
    if args.cp:
        plan = cp_plan(args.presets, args.ranks)
        args.presets = plan["checks"]
    elif args.presets is None:
        args.presets = (list(TP_PRESETS) if args.tp else [] if args.dryrun
                        else list(PRESETS))
    if args.worker:
        return worker_main(work / "checks", tuple(args.presets), args.cp,
                           args.tp, args.dryrun)
    import concurrent.futures

    from audiogan_tpu_torch.kernels import _build
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < args.ranks:
        print(f"dp_check: needs {args.ranks} CUDA devices",
              file=sys.stderr)
        return 1
    shutil.rmtree(work, ignore_errors=True)
    out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    results = {"cards": card}
    emit = []

    def show(key, value):
        results[key] = value
        line = json.dumps({key: value})
        emit.append(line)
        print(line, flush=True)
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(6) as pool:
        list(pool.map(_build.build, ("convt1d", "conv1d", "ingest",
                                     "gru_scan", "sconv", "gru_cell")))
    show("build_seconds", time.time() - t0)
    if args.graph:
        show("graph", graph_checks(work / "graph", graph_names))
        (out / "dp_check.jsonl").write_text("\n".join(emit) + "\n")
        failed = [g["preset"] for g in results["graph"] if "failed" in g]
        print(json.dumps({"ok": not failed, "failed": failed,
                          "cards": card}), flush=True)
        return 1 if failed else 0
    flags = [f"--{f}" for f in ("cp", "tp", "dryrun") if getattr(args, f)]
    lines, secs = _run(_torchrun(args.ranks, "-m",
                                 "audiogan_tpu_torch.tools.dp_check",
                                 "--worker", "--presets", *args.presets,
                                 *flags), out / "worker")
    show("checks", [ln["check"] for ln in lines if "check" in ln])
    if args.dryrun:
        show("dryrun", [ln for ln in lines if "dryrun" in ln])
    show("checks_seconds", secs)
    dryrun_only = args.dryrun and not (args.tp or args.cp)
    if args.checks_only or dryrun_only:
        pass
    elif args.tp:
        tp_rates = [("wgan_gp_b64", 2), ("wgan_gp_b64", args.ranks),
                    ("cond_gru_sc09", 2), ("music_44k_dp16", args.ranks)]
        show("rates", [rate(preset, args.ranks,
                            work / f"rate_{preset}_tp{tp}", tp=tp)
                       for preset, tp in tp_rates if preset in args.presets])
        if "wgan_gp_b64" in args.presets:
            show("resume", [kill_and_resume(args.ranks,
                                            work / f"resume_tp{tp}", tp=tp)
                            for tp in (2, args.ranks)])
    elif args.cp:
        show("rates", [rate(preset, args.ranks,
                            work / f"rate_{preset}_cp{cp}", cp)
                       for preset, cp in plan["rates"]])
        show("resume", [kill_and_resume(args.ranks,
                                        work / f"resume_{preset}", preset,
                                        cp)
                        for preset, cp in plan["resume"]])
    else:
        rates = []
        for preset in args.presets:
            for ranks in (args.ranks, 1):
                rates.append(rate(preset, ranks,
                                  work / f"rate_{preset}_{ranks}"))
        show("rates", rates)
        show("resume", kill_and_resume(args.ranks, work / "resume"))
    (out / "dp_check.jsonl").write_text("\n".join(emit) + "\n")
    failed = [c["preset"] for c in results["checks"]
              if c.get("f32", {}).get("failed")]
    print(json.dumps({"ok": not failed, "failed": failed, "cards": card}),
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
