"""audiogan_tpu_torch's data parallelism on the CPU: two processes over
gloo (audiogan_tpu_torch/tools/dp_check.py::spawn, one intra-op thread
each, one spawn for many checks).

The reference's DP at cp = tp = 1 is one global step that XLA partitions
over the batch (audiogan_tpu/train/loop.py:203-213), so DP over N devices
equals the step on one device for the same global batch
(tests/parallel/test_dp.py:182). The port's DP is that step split by rows.
Checked here:

- the port at dp=2, two steps of tiny_config from JAX's initial state
  with the reference's global draws injected (each rank takes its rows),
  against JAX's auto-SPMD step at dp=2 on the fake CPU devices: metrics
  at the reference's DP tolerance (rtol 2e-4, atol 1e-5), parameters
  within the card parity phase's 2.5 lr;
- the port at dp=2 against the port at dp=1 on the same global batches
  and the port's own draws, for the plain config, the dual critic with
  G's spectral term (its batch means are global: a wrong backward scale
  of the all-reduce shows in G's Adam moments), the chunked penalty
  (gp_batch_chunks=3 at B=12: two-row chunks whose shuffle shifts follow
  the global row), every shuffle site fused (K6/K7's plain forms) and the
  conditional GRU generator: metrics and parameters as above, Adam's
  moments within 1e-3 of each tensor's largest;
- every rank's state equal to the bit after the steps;
- mesh.fsdp (ZeRO-1) equal to the replicated step to the bit, each
  rank's moments holding only its half of every shardable parameter.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import audiogan_tpu.models.wavegan as jwg
from audiogan_tpu.parallel.mesh import (batch_sharding, label_sharding,
                                        make_mesh, state_shardings)
from audiogan_tpu.train.state import create_train_state as jcreate
from audiogan_tpu.train.step import build_train_step as jbuild_step
from audiogan_tpu_torch.config import Config, MeshCfg
from audiogan_tpu_torch.convert import params_from_jax
from audiogan_tpu_torch.tools import dp_check
from audiogan_tpu_torch.tools.step_checks import same_bits, state_parts

from helpers_train import raw_batch, tiny_config
from test_torch_gru_train import _gru_train_cfg
from test_torch_train import (_flat, _port_state, _reference_draws,
                              _variant)

torch.set_num_threads(1)

STEPS = 2
DP_RTOL, DP_ATOL = 2e-4, 1e-5          # tests/parallel/test_dp.py:209
PARAM_ATOL = 2.5e-4                    # 2.5 lr: chip_smoke's parity bound
MOMENT_REL = 1e-3


def _with_dp(cfg, dp=2, fsdp=False):
    return dataclasses.replace(cfg, mesh=MeshCfg(dp=dp, fsdp=fsdp))


def _gp_chunks():
    base = tiny_config()
    return tiny_config(
        loss=dataclasses.replace(base.loss, gp_batch_chunks=3),
        train=dataclasses.replace(base.train, batch_size=12))


VARIANTS = {
    "plain": tiny_config,
    "dual": lambda: _variant("dual_fused"),
    "gp_chunks": _gp_chunks,
    "fused_sites": lambda: _variant("fused_sites"),
    "cond_gru": _gru_train_cfg,
}


def _batches(cfg):
    out = []
    for s in range(STEPS):
        clips, labels = raw_batch(cfg, seed=100 + s)
        out.append((torch.from_numpy(clips), torch.from_numpy(labels)))
    return out


def _port_json(cfg, dp=1, fsdp=False):
    return Config.from_json(_with_dp(cfg, dp, fsdp).to_json()).to_json()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of two ranks: every variant at dp=2, and the plain and
    dual configs with mesh.fsdp; beside them each variant at dp=1 in this
    process. Each from the state after one warm dp=1 step, so Adam's
    second moment is non-zero and its update smooth in the gradient (the
    first update is about lr times the gradient's sign)."""
    jobs, single = [], {}
    cpu = torch.device("cpu")
    for name, make in VARIANTS.items():
        cfg = make()
        batches = _batches(cfg)
        clips, labels = raw_batch(cfg, seed=99)
        warm = dp_check.steps_job(cpu, _port_json(cfg), [(
            torch.from_numpy(clips), torch.from_numpy(labels))])
        single[name] = dp_check.steps_job(cpu, _port_json(cfg), batches,
                                          state=warm)
        jobs.append({"name": name, "fn": "steps",
                     "kw": {"cfg_json": _port_json(cfg, 2),
                            "batches": batches, "state": warm}})
        if name in ("plain", "dual"):
            jobs.append({"name": name + "_fsdp", "fn": "steps",
                         "kw": {"cfg_json": _port_json(cfg, 2, True),
                                "batches": batches, "state": warm}})
    return single, dp_check.spawn(2, jobs, tmp_path_factory.mktemp("dp"))


def _close_states(got, want):
    for net in ("g", "d"):
        for n, ref in want[net].items():
            np.testing.assert_allclose(got[net][n].numpy(), ref.numpy(),
                                       rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{net}.{n}")
        for i, ref in want["opt_" + net]["state"].items():
            gs = got["opt_" + net]["state"][i]
            assert float(gs["step"]) == float(ref["step"])
            for key in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_allclose(
                    gs[key].numpy(), ref[key].numpy(), rtol=0,
                    atol=MOMENT_REL * float(ref[key].abs().max()) + 1e-30,
                    err_msg=f"{net} moment {i} {key}")


def _close_metrics(got, want):
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=DP_RTOL,
                                       atol=DP_ATOL, err_msg=k)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dp2_matches_dp1(runs, variant):
    single, spawned = runs
    got = spawned[variant][0]
    _close_metrics(got["metrics"], single[variant]["metrics"])
    _close_states(got, single[variant])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_every_rank_holds_the_same_bits(runs, variant):
    r0, r1 = runs[1][variant]
    assert r0["metrics"] == r1["metrics"]
    assert same_bits(state_parts(r0), state_parts(r1)) > 0


@pytest.mark.parametrize("variant", ["plain", "dual"])
def test_fsdp_equals_replicated_to_the_bit(runs, variant):
    spawned = runs[1]
    rep, sharded = spawned[variant], spawned[variant + "_fsdp"]
    for rank in (0, 1):
        assert sharded[rank]["metrics"] == rep[rank]["metrics"]
        same_bits(state_parts(sharded[rank]), state_parts(rep[rank]))
        rows = sharded[rank]["moment_rows"]
        halves = [k for k, (kept, n) in rows.items() if n and n % 2 == 0]
        assert halves, rows
        for k, (kept, n) in rows.items():
            assert kept == (n // 2 if n and n % 2 == 0 else n), (k, kept, n)
        assert all(kept == n for kept, n in
                   rep[rank]["moment_rows"].values())


def _jax_record(cfg):
    """STEPS single-device JAX steps from the initial state, recording
    each step's shuffle shifts: (initial state, [(state before step s,
    shifts of step s)])."""
    rec, seen = [], []
    orig = jwg.phase_shuffle

    def recording(h, key, rad, impl=None):
        sh = jax.random.randint(key, (h.shape[0],), -rad, rad + 1)
        jax.debug.callback(lambda v: rec.append(np.array(v)), sh,
                           ordered=True)
        return orig(h, key, rad, impl=impl)
    jwg.phase_shuffle = recording
    try:
        state0 = jcreate(cfg)
        step = jax.jit(jbuild_step(cfg))
        state = state0
        for s in range(STEPS):
            rec.clear()
            before = state
            state, _ = step(state, *raw_batch(cfg, seed=100 + s))
            jax.effects_barrier()
            seen.append((before, list(rec)))
    finally:
        jwg.phase_shuffle = orig
    return state0, seen


def _jax_spmd(cfg):
    """STEPS auto-SPMD steps at cfg.mesh.dp on the fake CPU devices, as
    tests/parallel/test_dp.py:182 runs them: (metrics per step, state)."""
    mesh = make_mesh(cfg)
    state = jcreate(cfg)
    state = jax.device_put(state, state_shardings(mesh, state))
    step = jax.jit(jbuild_step(cfg))
    hist = []
    for s in range(STEPS):
        clips, labels = raw_batch(cfg, seed=100 + s)
        state, m = step(state, jax.device_put(clips, batch_sharding(mesh)),
                        jax.device_put(labels, label_sharding(mesh)))
        hist.append({k: float(v) for k, v in jax.device_get(m).items()})
    return hist, jax.device_get(state)


def test_dp2_matches_jax_auto_spmd(tmp_path):
    cfg = _with_dp(tiny_config())
    state0, seen = _jax_record(cfg)
    want, jstate = _jax_spmd(cfg)
    draws = [_reference_draws(cfg, before, shifts)
             for before, shifts in seen]
    pcfg, st = _port_state(cfg, state0)
    blob = dp_check.state_blob(st)
    out = dp_check.spawn(2, [{"name": "jax", "fn": "steps", "kw": {
        "cfg_json": pcfg.to_json(), "batches": _batches(cfg),
        "draws": draws, "state": blob}}], tmp_path)["jax"]
    _close_metrics(out[0]["metrics"], want)
    for jtree, net in ((jstate.params_g, "g"), (jstate.params_d, "d")):
        for n, ref in params_from_jax(_flat(jtree)).items():
            np.testing.assert_allclose(out[0][net][n].numpy(), ref.numpy(),
                                       rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{net}.{n}")
    same_bits(state_parts(out[0]), state_parts(out[1]))
