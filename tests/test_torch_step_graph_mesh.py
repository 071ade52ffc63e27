"""train.dump_hlo on a multi-process mesh (train/step_graph.py), on the CPU
over two gloo ranks at one intra-op thread, and where the loop refuses it.

At dp=2 (the resident corpus replicated, with mesh.fsdp and sharded;
the host batcher), cp=2 (replicated, and sharded over its one data
replica) and tp=2 each
rank's record holds the c10d collectives in the count the step's
structure gives (tools/step_checks.py::step_collectives), as do conditional,
dual-critic, GRU, chunked-penalty, even-depth and all-gather-route
variants; rank
0's step_graph.txt lists both ranks; the run's step-2 checkpoint and
records equal a run without the dump, to the bit; a rank whose dump
fails after the step makes every rank raise, naming it, and none hangs;
a rank whose step fails raises at once, naming itself, and its peer
raises at the collective it left. The dumped dp=2
loop, from the reference's initial state with its draws injected,
writes the metrics.jsonl of the reference's dumped loop on the same
mesh within tests/test_torch_dp.py::test_dp2_matches_jax_auto_spmd's
tolerance. check_ported raises, naming NCCL, for a gloo group on CUDA
tensors (the backend faked), and for nothing else.
"""

import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

import audiogan_tpu.train.loop as jloop
from audiogan_tpu.config import ModelCfg
from audiogan_tpu.train.state import create_train_state as jcreate
from audiogan_tpu_torch.cli import main
from audiogan_tpu_torch.config import Config, MeshCfg
from audiogan_tpu_torch.tools import dp_check
from audiogan_tpu_torch.tools.step_checks import (same_checkpoint,
                                                  step_collectives)
from audiogan_tpu_torch.train import loop
from audiogan_tpu_torch.train.step_graph import GRAPH_FILE, read_summary

from helpers_dump import dump_job
from helpers_train import tiny_config
from test_torch_dp import DP_ATOL, DP_RTOL
from test_torch_index_chunk import _reference_run
from test_torch_train import _port_state, _reference_draws

torch.set_num_threads(1)

T = tiny_config()
# name -> (mesh, tiny_config overrides, corpus sharded over the data axis)
MESHES = {
    "dp2": (MeshCfg(dp=2), {}, False),
    "dp2_host_batcher": (MeshCfg(dp=2), {"device_corpus": False}, False),
    "dp2_fsdp": (MeshCfg(dp=2, fsdp=True), {}, False),
    "dp2_sharded": (MeshCfg(dp=2), {}, True),
    "cp2": (MeshCfg(cp=2), {}, False),
    # one data replica on the sharded corpus: its plan is the indices,
    # a row of the resident block taken where it lies
    "cp2_sharded": (MeshCfg(cp=2), {}, True),
    "tp2": (MeshCfg(tp=2), {}, False),
}
# more of the structure step_collectives follows, dumped with no step run
VARIANTS = {
    "cp2_conditional_fused_views": (MeshCfg(cp=2), dict(
        data=dataclasses.replace(T.data, num_classes=10),
        train=dataclasses.replace(T.train, fused_d_views=True)), False),
    "cp2_dual_spectral": (MeshCfg(cp=2), dict(
        model=dataclasses.replace(T.model, use_stft_critic=True,
                                  stft_resolutions=((128, 32, 128),)),
        loss=dataclasses.replace(T.loss, stft_loss_weight=1.0)), False),
    "cp2_gru": (MeshCfg(cp=2), dict(model=ModelCfg(
        generator="gru", model_dim=4, kernel_size=9, strides=(4, 4, 4),
        max_channels=16, phase_shuffle=1, gru_frame_size=64,
        gru_hidden=8)), False),
    "cp2_gather_route": (MeshCfg(cp=2), dict(
        model=dataclasses.replace(T.model, strides=(4, 4, 4, 4, 4),
                                  kernel_size=25),
        data=dataclasses.replace(T.data, clip_len=2048, store_len=2200)),
        False),
    "tp2_conditional": (MeshCfg(tp=2), dict(
        data=dataclasses.replace(T.data, num_classes=10)), False),
    "tp2_penalty_chunks": (MeshCfg(tp=2), dict(
        loss=dataclasses.replace(T.loss, gp_batch_chunks=2)), False),
    "tp2_even_layers": (MeshCfg(tp=2), dict(
        model=dataclasses.replace(T.model, strides=(4, 4, 4, 4)),
        data=dataclasses.replace(T.data, clip_len=4096, store_len=4400)),
        False),
    "dp2_dual_spectral": (MeshCfg(dp=2), dict(
        model=dataclasses.replace(T.model, use_stft_critic=True,
                                  stft_resolutions=((128, 32, 128),)),
        loss=dataclasses.replace(T.loss, stft_loss_weight=1.0)), False),
}
STEPS = 2


def _cfg(mesh, overrides, sharded, **train):
    """The case's config: the resident corpus (replicated, or sharded over
    the data axis) unless it says device_corpus False."""
    overrides = dict(overrides)
    device_corpus = overrides.pop("device_corpus", True)
    cfg = tiny_config(**overrides)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(
            cfg.data, device_corpus=device_corpus,
            device_corpus_shard="shard" if sharded else "auto"),
        train=dataclasses.replace(cfg.train, log_every=1, ckpt_every=STEPS,
                                  sample_every=0, **train))
    return Config.from_json(cfg.to_json()).replace(mesh=mesh).validate()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case over one pair of gloo ranks: each mesh dumped and
    plain for STEPS steps, each variant dumped with no step run, and a
    dump whose rank 1 fails."""
    base = tmp_path_factory.mktemp("mesh_dump")
    jobs = []
    for name, (mesh, over, sharded) in MESHES.items():
        cfg = _cfg(mesh, over, sharded).to_json()
        jobs += [{"name": f"{name}.dump", "fn": dump_job, "kw": {
                     "cfg_json": cfg, "workdir": str(base / name / "dump"),
                     "steps": STEPS}},
                 {"name": f"{name}.plain", "fn": "train", "kw": {
                     "cfg_json": cfg, "workdir": str(base / name / "plain"),
                     "steps": STEPS, "resume": False}}]
    for name, (mesh, over, sharded) in VARIANTS.items():
        jobs.append({"name": f"{name}.dump", "fn": dump_job, "kw": {
            "cfg_json": _cfg(mesh, over, sharded).to_json(),
            "workdir": str(base / name / "dump"), "steps": 0}})
    jobs.append({"name": "fail.dump", "fn": dump_job, "kw": {
        "cfg_json": _cfg(MeshCfg(dp=2), {}, False).to_json(),
        "workdir": str(base / "fail"), "steps": 1, "fail_rank": 1}})
    return base, dp_check.spawn(2, jobs, base / "spawn")


CASES = {**MESHES, **VARIANTS}


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_records_the_structures_collectives(runs, name):
    base, out = runs
    mesh, over, sharded = CASES[name]
    want = step_collectives(_cfg(mesh, over, sharded), sharded)
    assert want and sum(want.values()) > 0
    for rank, res in enumerate(out[f"{name}.dump"]):
        assert "error" not in res, res.get("error")
        assert res["dump"]["collectives"] == want, (name, rank)
        assert res["dump"]["sharded_corpus"] == sharded
    lines = (base / name / "dump" / GRAPH_FILE).read_text().splitlines()
    kinds = [ln.split()[2] for ln in lines
             if not ln.startswith("#") and ln.split()[1] == "collective"]
    assert {k: kinds.count(k) for k in set(kinds)} == want


@pytest.mark.parametrize("name", list(MESHES))
def test_rank0_header_lists_every_rank(runs, name):
    base, _ = runs
    summary = read_summary(base / name / "dump")
    assert len(summary["ranks"]) == 2
    assert summary["ranks"][0]["collectives"] == \
        summary["ranks"][1]["collectives"]
    head = [ln for ln in (base / name / "dump" / GRAPH_FILE).read_text()
            .splitlines() if ln.startswith("# rank ")]
    assert [ln.split()[2] for ln in head] == ["0", "1"]
    mesh = MESHES[name][0]
    assert f"mesh dp={mesh.dp} cp={mesh.cp} tp={mesh.tp}" in \
        (base / name / "dump" / GRAPH_FILE).read_text().splitlines()[0]


def _records(workdir):
    return [{k: v for k, v in json.loads(ln).items()
             if k != "time" and "per_sec" not in k}
            for ln in (workdir / "metrics.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("name", list(MESHES))
def test_the_dump_moves_no_bit_of_the_run(runs, name):
    base, out = runs
    d, p = base / name / "dump", base / name / "plain"
    assert _records(d) == _records(p)
    assert same_checkpoint(d / "ckpt" / f"{STEPS}.pt",
                           p / "ckpt" / f"{STEPS}.pt") > 0
    dumped, plain = out[f"{name}.dump"], out[f"{name}.plain"]
    for r in range(2):
        assert dumped[r]["step"] == plain[r]["step"] == STEPS


def test_a_rank_that_fails_its_dump_makes_every_rank_raise(runs):
    """Rank 1's record of the step fails after the step: both ranks
    raise, each naming rank 1 and its failure; the spawn returned, so
    neither waited in a collective."""
    _, out = runs
    errors = [res.get("error", "") for res in out["fail.dump"]]
    for err in errors:
        assert "failed on 1 of 2 ranks" in err, err
        assert "rank 1: " in err and "injected" in err, err
        assert "rank 0: " not in err, err


def test_a_rank_whose_step_fails_raises_at_once_naming_itself(tmp_path):
    """Rank 1's step fails before its first collective, while rank 0
    waits in the step's gradient all-reduce: rank 1 raises at once,
    naming itself and its failure (an agreement over the default gloo
    group would meet rank 0's all-reduce, a collective mismatch that
    aborts the process and loses the error), and rank 0 raises at that
    all-reduce when rank 1 is gone; the spawn returned, so neither hung
    or aborted."""
    out = dp_check.spawn(2, [{"name": "fail", "fn": dump_job, "kw": {
        "cfg_json": _cfg(MeshCfg(dp=2), {}, False).to_json(),
        "workdir": str(tmp_path / "fail"), "steps": 1, "fail_rank": 1,
        "fail_in_step": True}}], tmp_path / "spawn")["fail"]
    errors = [res.get("error", "") for res in out]
    assert "the step failed on rank 1 of 2 in its step" in errors[1]
    assert "a fault injected into the dump's first run" in errors[1]
    assert "the step failed on rank 0 of 2 in its step at collective" \
        in errors[0]


def test_dumped_dp2_loop_matches_the_reference_dumped_loop(tmp_path):
    """The reference's loop at dp=2 with dump_hlo on the fake devices
    (its one SPMD module written) and the port's dumped dp=2 loop over
    two gloo ranks from the reference's initial state with its draws
    (recorded at dp=1: its DP step is the global step): the same
    metrics.jsonl within test_dp2_matches_jax_auto_spmd's tolerance."""
    cfg = tiny_config()
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, device_corpus=True),
        train=dataclasses.replace(cfg.train, total_steps=3, log_every=1,
                                  ckpt_every=0, sample_every=0))
    _, shifts = _reference_run(cfg, tmp_path / "record")
    dp2 = dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh, dp=2),
                              train=dataclasses.replace(cfg.train,
                                                        dump_hlo=True))
    jloop.train(dp2, tmp_path / "jax", resume=False)
    assert (tmp_path / "jax" / "step_optimized_hlo.txt").exists()
    want = _records(tmp_path / "jax")
    j0 = jcreate(cfg)
    draws = {s: _reference_draws(cfg, SimpleNamespace(
        base_key=j0.base_key, step=s), sh) for s, sh in enumerate(shifts)}
    pcfg, st0 = _port_state(dp2, j0)
    out = dp_check.spawn(2, [{"name": "port", "fn": dump_job, "kw": {
        "cfg_json": pcfg.to_json(), "workdir": str(tmp_path / "torch"),
        "steps": 3, "state": dp_check.state_blob(st0),
        "draws": draws}}], tmp_path / "spawn")["port"]
    assert all("error" not in r for r in out)
    assert out[0]["dump"]["collectives"] == step_collectives(pcfg)
    got = _records(tmp_path / "torch")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=DP_RTOL,
                                       atol=DP_ATOL,
                                       err_msg=f"step {w['step']} {k}")


# --- check_ported: NCCL, or the raise before the card ---------------------

def _faked_group(monkeypatch, backend: str):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)


def _dump_cfg():
    return _cfg(MeshCfg(dp=2), {}, False, dump_hlo=True)


@pytest.mark.parametrize("entry", ["loop", "cli"])
def test_dump_hlo_on_a_gloo_group_on_the_card_raises(tmp_path, monkeypatch,
                                                    entry):
    """dump_hlo at dp=2 whose group is gloo and whose device is the card
    (the backend faked): NotImplementedError naming NCCL, before any
    file is written and before the card is touched."""
    _faked_group(monkeypatch, "gloo")
    with pytest.raises(NotImplementedError, match="needs NCCL"):
        if entry == "loop":
            loop.train(_dump_cfg(), tmp_path, 1)
        else:
            main(["train", "--preset", "tiny_sc09", "--set",
                  "train.dump_hlo=true", "--set", "mesh.dp=2",
                  "--workdir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("backend,device,dump", [
    ("nccl", None, True), ("nccl", "cuda", True), ("gloo", "cpu", True),
    ("gloo", None, False)],
    ids=["nccl", "nccl_cuda", "gloo_cpu", "no_dump"])
def test_check_ported_refuses_only_gloo_on_the_card(monkeypatch, backend,
                                                    device, dump):
    _faked_group(monkeypatch, backend)
    cfg = _dump_cfg()
    if not dump:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                    dump_hlo=False))
    loop.check_ported(cfg, device)


@pytest.mark.parametrize("world", [2, 1])
def test_a_rank_whose_cli_train_raised_leaves_without_the_teardown(
        tmp_path, monkeypatch, world):
    """`cli train` whose run raised: in a group of several processes
    (faked) the rank exits with code 1 at once, before any teardown of
    the group (an NCCL group's waits for peers that sit in a collective
    this rank never joins); alone, the error propagates as it is."""
    from audiogan_tpu_torch.parallel import multihost
    _faked_group(monkeypatch, "nccl")
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: world)
    events = []

    def failing_train(*a, **k):
        raise RuntimeError("a fault in the run")

    def exit_now(code):
        events.append(("exit", code))
        raise SystemExit(code)
    monkeypatch.setattr(loop, "check_ported", lambda *a: None)
    monkeypatch.setattr(loop, "train", failing_train)
    monkeypatch.setattr(multihost.os, "_exit", exit_now)
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda *a: events.append("destroy"))
    args = ["train", "--preset", "tiny_sc09", "--workdir", str(tmp_path),
            "--device", "cpu"]
    if world > 1:
        with pytest.raises(SystemExit):
            main(args)
        assert events[0] == ("exit", 1)
    else:
        with pytest.raises(RuntimeError, match="a fault in the run"):
            main(args)
        assert events == ["destroy"]
