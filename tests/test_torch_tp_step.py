"""audiogan_tpu_torch's tensor-parallel training step (train/tp_step.py)
against the reference's ``build_tp_train_step``
(audiogan_tpu/train/tp_step.py) on the fake CPU devices.

The port runs over gloo in spawned processes (tools/dp_check.py::spawn,
one intra-op thread each): two ranks (dp=1, tp=2) for every variant but
one, four for the single dp=2 x tp=2 case with mesh.fsdp. Each variant
takes two steps from JAX's initial state (convert.py::
train_state_from_jax), with the reference's draws of each data replica
injected (test_torch_cp_step.py::_replica_draws: the step key folded
with the replica index, shared over tp, split 7 ways per critic
micro-step and 4 ways for G, as the tp step splits it). Variants: plain
(no shuffle); shuffle radius 2 with fused views; conditional; the
conditional GRU generator; G's spectral term (stft_loss_weight 1, the
wave critic); loss.gp_batch_chunks=2 with the shuffle on (each chunk's
shifts one draw at the chunk's rows); mesh.fsdp at dp=2 x tp=2.

Bounds: metrics at the reference's tp tolerance (rtol 5e-4, atol 1e-5,
tests/parallel/test_tp_step.py:69); parameters within 2.5 lr (the card
parity phase's bound); both nets' Adam moments within 1e-3 of each
tensor's largest, which a G gradient or a row bias's gradient summed
over tp (tp times too large, hidden from the parameters by Adam) fails.
Every rank's state equal to the bit after the steps. With the shuffle
off, tp=2 against the port's plain step on the same draws.
"""

import concurrent.futures
import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from audiogan_tpu.config import MeshCfg, ModelCfg
from audiogan_tpu.parallel.mesh import fsdp_shardable
from audiogan_tpu.train.state import create_train_state as jcreate
from audiogan_tpu.train.tp_step import build_tp_train_step as jbuild_tp
from audiogan_tpu_torch.convert import params_from_jax
from audiogan_tpu_torch.parallel.mesh import DataMesh
from audiogan_tpu_torch.tools import dp_check
from audiogan_tpu_torch.tools.step_checks import (PARITY_STEPS, same_bits,
                                                  state_parts)
from audiogan_tpu_torch.train.step import build_train_step

from helpers_train import raw_batch, tiny_config
from test_torch_cp_step import _replica_draws
from test_torch_train import _port_state

torch.set_num_threads(1)

STEPS = 2
TP_RTOL, TP_ATOL = 5e-4, 1e-5          # tests/parallel/test_tp_step.py:69
PARAM_ATOL = 2.5e-4                    # 2.5 lr: chip_smoke's parity bound
MOMENT_REL = 1e-3


def _cfg(shuffle=0, fused=False, dp=1, tp=2, fsdp=False, batch=2, **parts):
    base = tiny_config()
    cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model, phase_shuffle=shuffle),
        train=dataclasses.replace(base.train, batch_size=batch * dp,
                                  fused_d_views=fused),
        mesh=MeshCfg(dp=dp, tp=tp, fsdp=fsdp))
    for name, kw in parts.items():
        cfg = dataclasses.replace(cfg, **{name: dataclasses.replace(
            getattr(cfg, name), **kw)})
    return cfg.validate()


VARIANTS = {
    "plain": lambda: _cfg(),
    "shuffle": lambda: _cfg(shuffle=2, fused=True),
    "conditional": lambda: _cfg(shuffle=2, data={"num_classes": 4}),
    "gru": lambda: _cfg(shuffle=1, fused=True, data={"num_classes": 4}).replace(
        model=ModelCfg(generator="gru", model_dim=4, kernel_size=9,
                       strides=(4, 4, 4), gru_frame_size=64, gru_hidden=16,
                       max_channels=16, phase_shuffle=1)),
    "stft": lambda: _cfg(
        shuffle=1, fused=True,
        model={"stft_resolutions": ((128, 32, 128), (256, 64, 256))},
        loss={"stft_loss_weight": 1.0}),
    "gp_chunks": lambda: _cfg(shuffle=2, batch=4,
                              loss={"gp_batch_chunks": 2}),
    "fsdp": lambda: _cfg(shuffle=1, dp=2, fsdp=True),
}


def _reference(cfg, state0):
    """STEPS reference tp steps from the initial state: (metrics per
    step, final state)."""
    dp, tp = cfg.mesh.dp, cfg.mesh.tp
    mesh = Mesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, 1, tp),
                ("data", "cp", "tp"))
    rep = NamedSharding(mesh, P())

    def place(x):       # as the step returns it, so it compiles once
        if cfg.mesh.fsdp and fsdp_shardable(x, dp):
            return NamedSharding(mesh, P("data", *([None] * (x.ndim - 1))))
        return rep
    state = jax.device_put(state0, jax.tree.map(lambda _: rep, state0)
                           .replace(opt_g=jax.tree.map(place, state0.opt_g),
                                    opt_d=jax.tree.map(place, state0.opt_d)))
    step = jbuild_tp(cfg, mesh)(state)
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
    and the port's plain step on the plain variant's draws. The port's
    two spawns (two ranks, and four for dp=2 x tp=2) run beside the
    reference's steps, which need only the same initial states."""
    jobs = {2: [], 4: []}
    cfgs, states, plain = {}, {}, None
    for name, make in VARIANTS.items():
        cfg = cfgs[name] = make()
        # a host copy: the reference's step donates its state
        state0 = states[name] = jax.device_get(jcreate(cfg))
        pcfg, st = _port_state(cfg, state0)
        draws = [[_replica_draws(cfg, state0.base_key, s, d,
                                 cfg.loss.gp_batch_chunks)
                  for d in range(cfg.mesh.dp)] for s in range(STEPS)]
        jobs[cfg.mesh.dp * cfg.mesh.tp].append({
            "name": name, "fn": "steps", "kw": {
                "cfg_json": pcfg.to_json(), "batches": _batches(cfg),
                "draws": draws, "state": dp_check.state_blob(st)}})
        if name == "plain":
            one = pcfg.replace(mesh=MeshCfg())
            step = build_train_step(one, "cpu", DataMesh())
            plain = [{k: float(v) for k, v in step(st, raw, lab, draws=d[0])
                      .items() if k != "d_loss_mean"}
                     for (raw, lab), d in zip(_batches(cfg), draws)]
            plain = {"metrics": plain, **dp_check.state_blob(st)}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        spawns = [pool.submit(dp_check.spawn, world, js,
                              tmp_path_factory.mktemp(f"tp{world}"))
                  for world, js in jobs.items()]
        ref = {n: _reference(cfgs[n], states[n]) for n in VARIANTS}
        port = {k: v for f in spawns for k, v in f.result().items()}
    return {n: (*ref[n], port[n]) for n in VARIANTS}, plain


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _close_metrics(got, want):
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TP_RTOL,
                                       atol=TP_ATOL, err_msg=k)


def _close_moment(got, want, msg):
    np.testing.assert_allclose(
        got, want, rtol=0, err_msg=msg,
        atol=MOMENT_REL * float(np.abs(want).max()) + 1e-30)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_tp_step_matches_the_reference(runs, variant):
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


def test_tp2_matches_the_plain_step(runs):
    """Shuffle off: tp=2 against the port's plain step on one process,
    the same draws."""
    got, want = runs[0]["plain"][2][0], runs[1]
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


@pytest.mark.parametrize("axis", ["cp", "tp"])
def test_parity_job_holds_the_frozen_step(tmp_path, axis):
    """The card's cp and tp parity protocol (dp_check.parity_job) at
    cp=2 or tp=2 on two ranks: the frozen step leaves the parameters to
    the bit and records gradients in the moments; every comparison is
    inside the bounds, the two steps held at the first seed only; the
    launches are counted over every run of the step."""
    cfg = _cfg(tp=1).replace(mesh=MeshCfg(**{axis: 2})).validate()
    res = dp_check.spawn(2, [{"name": "p", "fn": "parity", "kw": {
        "cfg_json": cfg.to_json(), "axis": axis, "work": str(tmp_path / "w"),
        "seeds": (1, 2), "held_seeds": (1,)}}],
        tmp_path / "out")["p"]
    assert res[1]["report"] is None
    assert [r["steps"] for r in res] == [2 * (1 + PARITY_STEPS)] * 2
    rep = res[0]["report"]
    assert rep["failed"] == [] and sorted(rep["seeds"]) == [1, 2]
    for seed, runs_ in rep["seeds"].items():
        assert runs_["frozen"]["held"] and runs_["steps"]["held"] == (
            seed == 1)
        for kind, run in runs_.items():
            for name in (f"vs_{axis}1", "vs_plain"):
                errs = run[name]
                assert errs["over"] == [], (seed, kind, name, errs)
                if kind == "frozen":
                    assert errs["param_max_abs_err"] == 0.0
    assert np.isfinite(list(res[0]["last"].values())).all()
