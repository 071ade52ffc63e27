"""train.debug_nans of audiogan_tpu_torch against the reference's
jax_debug_nans, on the CPU (one intra-op thread per process).

With one NaN in the critic's conv_0 kernel the reference's step raises
FloatingPointError under ``jax.debug_nans(True)``; so does the port's
loop, and its message names the critic's first conv (K1', the wave
critic, forward, reading D.conv_0_kernel). With the NaN removed neither
raises, and the port's checkpoint equals a run without debug_nans to the
bit. A healthy step of every step variant under the check mode makes no
NaN in any op (train/debug_nans.py). At dp=2 over two gloo ranks with the
NaN on rank 1 alone, both ranks raise, each naming its own first op, and
neither hangs (the test's own time limit).
"""

import dataclasses
import os
import re
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from audiogan_tpu.train.state import create_train_state as jcreate
from audiogan_tpu.train.step import build_train_step as jbuild_step
from audiogan_tpu_torch.config import Config, MeshCfg
from audiogan_tpu_torch.parallel.multihost import \
    maybe_initialize_distributed
from audiogan_tpu_torch.tools.dp_check import free_port
from audiogan_tpu_torch.tools.step_checks import same_bits, state_parts
from audiogan_tpu_torch.train import loop
from audiogan_tpu_torch.train.debug_nans import nan_check
from audiogan_tpu_torch.train.state import create_train_state
from audiogan_tpu_torch.train.step import build_train_step

from helpers_train import raw_batch, tiny_config
from test_torch_gru_train import _gru_case
from test_torch_train import _port_state, _variant

torch.set_num_threads(1)

NAMED = r"K1' conv1d_ba .*in wave_critic, forward, reading .*D\.conv_0_kernel"
RANK_LIMIT_S = 180


def _cfg(**train):
    cfg = tiny_config()
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, total_steps=2, log_every=1, ckpt_every=0,
        sample_every=0, **train))


def _poisoned(jstate):
    params = jax.tree_util.tree_map(lambda x: x, jstate.params_d)
    k = params["params"]["conv_0_kernel"]
    params["params"]["conv_0_kernel"] = k.at[0, 0, 0].set(jnp.nan)
    return jstate.replace(params_d=params)


def _port_run(tmp_path, name, cfg, state, monkeypatch, steps=2):
    monkeypatch.setattr(loop, "create_train_state", lambda *a, **k: state)
    return loop.train(Config.from_json(cfg.to_json()).validate(),
                      tmp_path / name, steps, device="cpu",
                      tensorboard=False, log=lambda _: None)


def test_nan_in_the_first_conv_raises_as_the_reference(tmp_path,
                                                       monkeypatch):
    cfg = _cfg(debug_nans=True)
    j0 = jcreate(cfg)
    bad = _poisoned(j0)
    step = jax.jit(jbuild_step(cfg))
    batch = raw_batch(cfg, seed=1)
    with jax.debug_nans(True):
        with pytest.raises(FloatingPointError):
            step(bad, *batch)
        step(j0, *batch)                    # healthy: no raise
    _, st = _port_state(cfg, bad)
    with pytest.raises(FloatingPointError, match=NAMED):
        _port_run(tmp_path, "bad", cfg, st, monkeypatch)


def test_healthy_run_is_unchanged_by_debug_nans(tmp_path, monkeypatch):
    j0 = jcreate(_cfg())
    ckpts = {}
    for name, on in (("plain", False), ("debug_nans", True)):
        cfg = _cfg(debug_nans=on)
        _, st = _port_state(cfg, j0)
        _port_run(tmp_path, name, cfg, st, monkeypatch)
        ckpts[name] = state_parts(torch.load(
            tmp_path / name / "ckpt/2.pt", weights_only=True))
    assert same_bits(ckpts["plain"], ckpts["debug_nans"]) > 0


def _check_variant(name):
    if name == "gru":
        return _gru_case()
    return _variant(name)


@pytest.mark.parametrize("variant", ["unfused", "fused", "conditional_drift",
                                     "fused_sites", "dual_fused",
                                     "gp_chunks", "gru"])
def test_healthy_step_makes_no_nan(variant):
    """One step under the check mode (every aten op and every kernel
    call of the port tested): no output holds a NaN, none is thrown away
    unseen."""
    pcfg = Config.from_json(_check_variant(variant).to_json()).validate()
    st = create_train_state(pcfg, device="cpu")
    clips, labels = raw_batch(pcfg, seed=4)
    check = nan_check(st)
    with torch.autograd.set_detect_anomaly(True, check_nan=False), check:
        build_train_step(pcfg, device="cpu")(
            st, torch.from_numpy(clips), torch.from_numpy(labels))
    assert check.first is None, check.first


def _rank(rank, world, port, cfg_json, workdir, out):
    """One gloo rank of the loop with debug_nans; rank 1's critic holds a
    NaN in conv_0's kernel. Writes what it raised."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    maybe_initialize_distributed(torch.device("cpu"), "gloo", RANK_LIMIT_S)
    create = loop.create_train_state

    def poisoned(*a, **k):
        st = create(*a, **k)
        if rank == 1:
            with torch.no_grad():
                st.d.conv_0_kernel[0, 0, 0] = float("nan")
        return st
    loop.create_train_state = poisoned
    try:
        loop.train(Config.from_json(cfg_json), workdir, 1, device="cpu",
                   tensorboard=False, log=lambda _: None)
        raised = "nothing"
    except FloatingPointError as err:
        raised = f"FloatingPointError: {err}"
    finally:
        dist.destroy_process_group()
    (Path(out) / f"{rank}.txt").write_text(raised)


def test_every_rank_raises_at_dp2(tmp_path):
    cfg = dataclasses.replace(_cfg(debug_nans=True), mesh=MeshCfg(dp=2))
    cfg = Config.from_json(cfg.to_json()).validate()
    ctx = mp.start_processes(
        _rank, args=(2, free_port(), cfg.to_json(), str(tmp_path / "wd"),
                     str(tmp_path)), nprocs=2, join=False,
        start_method="spawn")
    deadline = time.time() + RANK_LIMIT_S
    try:
        while not ctx.join(timeout=1):
            assert time.time() < deadline, "a rank hangs"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    said = [(tmp_path / f"{r}.txt").read_text() for r in range(2)]
    assert all(s.startswith("FloatingPointError") for s in said), said
    assert "(rank 1)" in said[1] and "(rank 0)" in said[0]
    assert re.search(NAMED, said[1]), said[1]
    assert not re.search(NAMED, said[0]), said[0]
