"""audiogan_tpu_torch's context-parallel training step (train/cp_step.py)
against the reference's ``build_cp_train_step``
(audiogan_tpu/train/cp_step.py) on the fake CPU devices.

The port runs over gloo in spawned processes (tools/dp_check.py::spawn,
one intra-op thread each): two ranks (dp=1, cp=2) for every variant but
one, four for the single dp=2 x cp=2 case. Each variant takes two steps
from JAX's initial state (convert.py::train_state_from_jax), with the
reference's draws of each data replica injected: its step key folded
with the replica index, split 7 ways per critic micro-step (crop, z,
eps, labels, the three shuffle keys, each site's shifts from
fold_in(key, site)) and 4 ways for G (cp_step.py:120-177). Variants:
plain (no shuffle); shuffle radius 2 with fused views, also against the
port's cp step at cp=1; conditional; the conditional GRU generator;
the dual critic with G's spectral term; mesh.fsdp at dp=2 x cp=2; the
music geometry (strides 7/7/5/5/3, whose last critic layer takes the
all-gather route); and a bf16 config, which the reference's cp step
computes in f32 (so does the port's, or the bounds below fail).

Bounds: metrics at the reference's cp tolerance (rtol 5e-4, atol 1e-5,
tests/parallel/test_cp_step.py); parameters within 2.5 lr (the card
parity phase's bound); both nets' Adam moments within 1e-3 of each
tensor's largest, which a b_head or proj_embed gradient summed over cp
(cp times too large, hidden from the parameters by Adam) fails. Every
rank's state equal to the bit after the steps, and each rank's kernel
wrapper calls (counted through kernels/hooks.py) the launches
tools/step_checks.py::cp_step_launches gives the card.

Last, `cli train --preset tiny_sc09 --device cpu --set mesh.cp=2` under
torchrun's two gloo ranks, killed after its step-2 checkpoint and run
again, against an uninterrupted run: the same step-4 record and
checkpoint, to the bit.
"""

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from audiogan_tpu.config import MeshCfg, ModelCfg
from audiogan_tpu.parallel.mesh import fsdp_shardable
from audiogan_tpu.train.cp_step import build_cp_train_step as jbuild_cp
from audiogan_tpu.train.state import create_train_state as jcreate
from audiogan_tpu.utils.prng import split_for_step
from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.convert import params_from_jax
from audiogan_tpu_torch.kernels import hooks
from audiogan_tpu_torch.parallel.mesh import CpMesh, DataMesh
from audiogan_tpu_torch.tools import dp_check
from audiogan_tpu_torch.tools.step_checks import (cp_step_launches,
                                                  same_bits, state_parts)
from audiogan_tpu_torch.train.cp_step import build_cp_train_step
from audiogan_tpu_torch.train.step import num_views

from helpers_launches import counted_steps_job
from helpers_train import raw_batch, tiny_config
from test_torch_train import _port_state

torch.set_num_threads(1)

STEPS = 2
CP_RTOL, CP_ATOL = 5e-4, 1e-5          # tests/parallel/test_cp_step.py
PARAM_ATOL = 2.5e-4                    # 2.5 lr: chip_smoke's parity bound
MOMENT_REL = 1e-3
ROOT = Path(__file__).resolve().parents[1]


def _cfg(shuffle=0, fused=False, dp=1, cp=2, fsdp=False, **parts):
    base = tiny_config()
    cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model, phase_shuffle=shuffle),
        train=dataclasses.replace(base.train, batch_size=2 * dp,
                                  fused_d_views=fused),
        mesh=MeshCfg(dp=dp, cp=cp, fsdp=fsdp))
    for name, kw in parts.items():
        cfg = dataclasses.replace(cfg, **{name: dataclasses.replace(
            getattr(cfg, name), **kw)})
    return cfg.validate()


def _music():
    from helpers_golden import case_music
    music = case_music()
    return _cfg(shuffle=2, fused=True).replace(
        data=music.data, model=dataclasses.replace(
            music.model, phase_shuffle=2)).validate()


VARIANTS = {
    "plain": lambda: _cfg(),
    "shuffle": lambda: _cfg(shuffle=2, fused=True),
    "conditional": lambda: _cfg(shuffle=2, data={"num_classes": 4}),
    "gru": lambda: _cfg(shuffle=1, fused=True, data={"num_classes": 4}).replace(
        model=ModelCfg(generator="gru", model_dim=4, kernel_size=9,
                       strides=(4, 4, 4), gru_frame_size=64, gru_hidden=16,
                       max_channels=16, phase_shuffle=1)),
    "dual": lambda: _cfg(
        shuffle=1, fused=True,
        model={"use_stft_critic": True,
               "stft_resolutions": ((128, 32, 128), (256, 64, 256))},
        loss={"stft_loss_weight": 1.0}),
    "fsdp": lambda: _cfg(shuffle=1, dp=2, fsdp=True),
    "music": _music,
    "bf16": lambda: _cfg(shuffle=1, train={"dtype": "bfloat16"}),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _replica_draws(cfg, base_key, step, replica, gp_chunks=1):
    """The reference's cp draws of one data replica at one step (and its
    tp step's: with ``gp_chunks`` penalty chunks, one shift draw at a
    chunk's rows)."""
    b = cfg.train.batch_size // cfg.mesh.dp
    m, latent = cfg.model, cfg.model.latent_dim
    rad, sites = m.phase_shuffle, len(m.strides) - 1 if m.phase_shuffle else 0
    max_off = max(cfg.data.resampled_len - cfg.data.clip_len, 0)
    (step_key,) = split_for_step(jax.random.wrap_key_data(base_key), step,
                                 "step")
    step_key = jax.random.fold_in(step_key, replica)

    def shifts(key, n):
        if not sites:
            return torch.zeros(0, n, dtype=torch.long)
        return torch.stack([_t(jax.random.randint(jax.random.fold_in(key, i),
                                                  (n,), -rad, rad + 1))
                            for i in range(sites)])

    def labels(key):
        if not cfg.data.num_classes:
            return None
        return _t(jax.random.randint(key, (b,), 0,
                                     cfg.data.num_classes)).long()
    critic = []
    for i in range(cfg.loss.n_critic):
        k_crop, k_z, k_eps, k_lab, k1, k2, k3 = jax.random.split(
            jax.random.fold_in(step_key, i), 7)
        sh = ({"both": shifts(k1, 2 * b)} if cfg.train.fused_d_views
              else {"real": shifts(k1, b), "fake": shifts(k2, b)})
        sh["gp"] = shifts(k3, b // gp_chunks)
        critic.append({
            "offsets": _t(jax.random.randint(k_crop, (b,), 0, max_off + 1)),
            "z": _t(jax.random.normal(k_z, (b, latent))),
            "eps": _t(jax.random.uniform(k_eps, (b, 1, 1))).reshape(b),
            "labels": labels(k_lab), "shifts": sh})
    k_z, k_lab, k_shuf, k_crop = jax.random.split(
        jax.random.fold_in(step_key, cfg.loss.n_critic + 1), 4)
    gen = {"z": _t(jax.random.normal(k_z, (b, latent))),
           "labels": labels(k_lab), "shifts": shifts(k_shuf, b)}
    if cfg.loss.stft_loss_weight > 0:
        gen["offsets"] = _t(jax.random.randint(k_crop, (b,), 0, max_off + 1))
    return {"critic": critic, "generator": gen}


def _reference(cfg, state0):
    """STEPS reference cp steps from the initial state: (metrics per
    step, final state)."""
    dp, cp = cfg.mesh.dp, cfg.mesh.cp
    mesh = Mesh(np.asarray(jax.devices()[:dp * cp]).reshape(dp, cp),
                ("data", "cp"))
    rep = NamedSharding(mesh, P())

    def place(x):       # as the step returns it, so it compiles once
        if cfg.mesh.fsdp and fsdp_shardable(x, dp):
            return NamedSharding(mesh, P("data", *([None] * (x.ndim - 1))))
        return rep
    state = jax.device_put(state0, jax.tree.map(lambda _: rep, state0)
                           .replace(opt_g=jax.tree.map(place, state0.opt_g),
                                    opt_d=jax.tree.map(place, state0.opt_d)))
    step = jbuild_cp(cfg, mesh)(state)
    hist = []
    for s in range(STEPS):
        state, m = step(state, *raw_batch(cfg, seed=100 + s))
        hist.append({k: float(v) for k, v in jax.device_get(m).items()})
    return hist, jax.device_get(state)


def _batches(cfg):
    return [tuple(torch.from_numpy(a) for a in raw_batch(cfg, seed=100 + s))
            for s in range(STEPS)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{variant: (reference metrics, reference state, port per rank)}
    and the port's cp=1 run of the shuffle variant. The port's two
    spawns (two ranks, and four for dp=2 x cp=2) run beside the
    reference's steps, which need only the same initial states."""
    jobs = {2: [], 4: []}
    cfgs, states, cp1 = {}, {}, None
    for name, make in VARIANTS.items():
        cfg = cfgs[name] = make()
        # a host copy: the reference's step donates its state
        state0 = states[name] = jax.device_get(jcreate(cfg))
        pcfg, st = _port_state(cfg, state0)
        draws = [[_replica_draws(cfg, state0.base_key, s, d)
                  for d in range(cfg.mesh.dp)] for s in range(STEPS)]
        blob = dp_check.state_blob(st)
        jobs[cfg.mesh.dp * cfg.mesh.cp].append({
            "name": name, "fn": counted_steps_job, "kw": {
                "cfg_json": pcfg.to_json(), "batches": _batches(cfg),
                "draws": draws, "state": blob}})
        if name == "shuffle":
            one = pcfg.replace(mesh=dataclasses.replace(pcfg.mesh, cp=1))
            step = build_cp_train_step(one, "cpu", DataMesh(), CpMesh())
            cp1 = [{k: float(v) for k, v in step(st, raw, lab, draws=d)
                    .items()} for (raw, lab), d in zip(_batches(cfg), draws)]
            cp1 = {"metrics": cp1, **dp_check.state_blob(st)}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        spawns = [pool.submit(dp_check.spawn, world, js,
                              tmp_path_factory.mktemp(f"cp{world}"))
                  for world, js in jobs.items()]
        ref = {n: _reference(cfgs[n], states[n]) for n in VARIANTS}
        port = {k: v for f in spawns for k, v in f.result().items()}
    return {n: (*ref[n], port[n]) for n in VARIANTS}, cp1


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _close_metrics(got, want):
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=CP_RTOL,
                                       atol=CP_ATOL, err_msg=k)


def _close_moment(got, want, msg):
    np.testing.assert_allclose(
        got, want, rtol=0, err_msg=msg,
        atol=MOMENT_REL * float(np.abs(want).max()) + 1e-30)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cp_step_matches_the_reference(runs, variant):
    hist, final, ranks = runs[0][variant]
    got = ranks[0]
    _close_metrics(got["metrics"], hist)
    for net, jparams, jopt in (("g", final.params_g, final.opt_g),
                               ("d", final.params_d, final.opt_d)):
        want = params_from_jax(_flat(jparams))
        names = list(got[net])
        for n in names:
            np.testing.assert_allclose(got[net][n].numpy(),
                                       want[n].numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"{net}.{n}")
        adam = jopt[0]
        mu = params_from_jax(_flat(adam.mu))
        nu = params_from_jax(_flat(adam.nu))
        for i, st in got["opt_" + net]["state"].items():
            n = names[i]
            assert float(st["step"]) == int(adam.count)
            _close_moment(st["exp_avg"].numpy(), mu[n].numpy(),
                          f"{net}.{n} exp_avg")
            _close_moment(st["exp_avg_sq"].numpy(), nu[n].numpy(),
                          f"{net}.{n} exp_avg_sq")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_every_rank_holds_the_same_bits(runs, variant):
    ranks = runs[0][variant][2]
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        assert same_bits(state_parts(r), state_parts(ranks[0])) > 0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_each_rank_calls_the_kernels_cp_step_launches_gives(runs, variant):
    """Each rank's kernel wrapper calls over the steps (counted through
    kernels/hooks.py) are tools/step_checks.py::cp_step_launches per step
    and K2 once per real view: the critic's and G's convs (the GRU G's
    upsampling convTs), no K3, K4 or K5 (the cp GRU runs the torch-op
    cell), no K6 or K7 (the cp critic ignores fused_shuffle_sites)."""
    pcfg = Config.from_json(VARIANTS[variant]().to_json())
    counters = {k.counter for k in hooks.KERNELS.values()}
    want = {k: n * STEPS for k, n in {**cp_step_launches(pcfg),
                                      "ingest": num_views(pcfg)}.items()
            if k in counters}
    assert set(want) == counters
    if pcfg.model.generator == "gru":
        assert want["gru_scan"] == want["gru_cell"] == 0
        assert want["convt1d"] > 0
    for rank, r in enumerate(runs[0][variant][2]):
        assert {k: r["calls"].get(k, 0) for k in want} == want, rank
        assert set(r["calls"]) <= counters


def test_cp2_matches_the_cp_step_at_cp1(runs):
    """Shuffle on (radius 2, fused views): cp=2 against the port's cp
    step on whole clips, the same draws."""
    got, want = runs[0]["shuffle"][2][0], runs[1]
    _close_metrics(got["metrics"], want["metrics"])
    for net in ("g", "d"):
        for n, ref in want[net].items():
            np.testing.assert_allclose(got[net][n].numpy(), ref.numpy(),
                                       rtol=0, atol=PARAM_ATOL, err_msg=n)
        for i, st in want["opt_" + net]["state"].items():
            for key in ("exp_avg", "exp_avg_sq"):
                _close_moment(got["opt_" + net]["state"][i][key].numpy(),
                              st[key].numpy(), f"{net} {i} {key}")


def test_fsdp_keeps_each_replicas_rows(runs):
    """ZeRO-1 over the data axis only: each of the four ranks keeps half
    the rows of every shardable parameter's moments."""
    for r in runs[0]["fsdp"][2]:
        rows = r["moment_rows"]
        assert any(kept * 2 == n for kept, n in rows.values()), rows
        for kept, n in rows.values():
            assert kept == (n // 2 if n and n % 2 == 0 else n)


def _torchrun(workdir, steps, port, axis="cp"):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [sys.executable, "-m", "torch.distributed.run",
            "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
            "--master_port", str(port), "-m", "audiogan_tpu_torch.cli",
            "train", "--preset", "tiny_sc09", "--device", "cpu",
            "--set", f"mesh.{axis}=2", "--set", "train.ckpt_every=2",
            "--batch_size", "2", "--log_every", "1", "--total_steps",
            str(steps), "--no_tensorboard", "--workdir", str(workdir)], env


def _record(workdir, step):
    recs = [json.loads(ln) for ln in
            (workdir / "metrics.jsonl").read_text().splitlines()]
    rec = [r for r in recs if r["step"] == step][-1]
    return {k: v for k, v in rec.items() if k != "time"
            and "per_sec" not in k}


def killed_and_resumed(tmp_path, axis):
    """`cli train` at mesh.<axis>=2 under torchrun's two gloo ranks,
    killed after its step-2 checkpoint and run again, against an
    uninterrupted run: the same step-4 record and checkpoint."""
    straight, killed = tmp_path / "straight", tmp_path / "killed"
    cmd, env = _torchrun(straight, 4, dp_check.free_port(), axis)
    # the uninterrupted run goes beside the one to be killed
    done = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    cmd, env = _torchrun(killed, 4, dp_check.free_port(), axis)
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    try:
        for line in proc.stdout:
            if line.startswith('{"ckpt"') and \
                    json.loads(line)["ckpt"]["step"] == 2:
                break
    finally:
        dp_check._kill_tree(proc)
        proc.stdout.close()
    _, err = done.communicate(timeout=300)
    assert done.returncode == 0, err[-3000:]
    assert sorted(p.name for p in (killed / "ckpt").glob("*.pt")) == \
        ["2.pt"]
    cmd, env = _torchrun(killed, 4, dp_check.free_port(), axis)
    again = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=300)
    assert again.returncode == 0, again.stderr[-3000:]
    lines = [json.loads(ln) for ln in again.stdout.splitlines()
             if ln.startswith("{")]
    assert [ln["resume"]["step"] for ln in lines if "resume" in ln] == [2]
    assert [ln["init"][axis] for ln in lines if "init" in ln] == [2]
    assert _record(killed, 4) == _record(straight, 4)
    a = torch.load(straight / "ckpt/4.pt", weights_only=True)
    b = torch.load(killed / "ckpt/4.pt", weights_only=True)
    parts = ("step", "seed", "g", "d", "opt_g", "opt_d")
    assert same_bits({k: a[k] for k in parts}, {k: b[k] for k in parts}) > 0


def test_cli_train_at_cp2_killed_and_resumed_to_the_bit(tmp_path):
    killed_and_resumed(tmp_path, "cp")


def corpus_paths_agree(tmp_path, make_cfg, world=2):
    """train/loop.py on ``world`` gloo ranks, the config make_cfg(data
    fields)
    on the resident corpus, replicated and sharded, and through the host
    batcher: the same records and states, to the bit."""
    jobs = []
    for name, data in (("replicate", {"device_corpus": True,
                                      "device_corpus_shard": "replicate"}),
                       ("shard", {"device_corpus": True,
                                  "device_corpus_shard": "shard"}),
                       ("host", {"device_corpus": False})):
        pcfg = Config.from_json(make_cfg(data).to_json()).validate()
        jobs.append({"name": name, "fn": "train", "kw": {
            "cfg_json": pcfg.to_json(), "workdir": str(tmp_path / name),
            "steps": 2}})
    res = dp_check.spawn(world, jobs, tmp_path / "out")
    lines = {n: [{k: v for k, v in ln.items() if k != "seconds"}
                 for ln in r[0]["lines"] if "step" in ln]
             for n, r in res.items()}
    assert len(lines["replicate"]) == 2
    assert lines["shard"] == lines["replicate"] == lines["host"]
    assert [ln["init"]["corpus"] for n in ("replicate", "shard", "host")
            for ln in res[n][0]["lines"] if "init" in ln] == \
        ["replicate", "shard", "host"]
    for n in ("shard", "host"):
        for rank in range(world):
            assert same_bits(state_parts(res[n][rank]),
                             state_parts(res["replicate"][0])) > 0


def test_the_loop_trains_cp_on_every_corpus_path(tmp_path):
    """train/loop.py at cp=2 (two gloo ranks) on the resident corpus,
    replicated and sharded, and through the host batcher: the same
    records and states, to the bit."""
    corpus_paths_agree(tmp_path, lambda data: _cfg(
        shuffle=1, data=data, train={"log_every": 1}))
