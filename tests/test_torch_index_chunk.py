"""The resident index blocks (data.index_chunk) of audiogan_tpu_torch's
loop against the reference's and against themselves.

With the corpus on the device the loop ships the indices and labels of
steps [m chunk, (m+1) chunk) once per chunk steps and the step takes its
row at state.step % chunk (data/corpus.py::index_row), as
audiogan_tpu/train/step.py::wrap_device_corpus(..., chunk) does. The
reference's loop (device corpus, index_chunk=3, 4 steps: two blocks, the
second used in part) and the port's, from the reference's initial state
with the reference's draws injected (tests/test_torch_train.py's
recording of the shuffle shifts), write the same metrics.jsonl within
tests/train/test_device_corpus.py's tolerance. The port at index_chunk
0, 3 and 512, and resumed mid-chunk, ends in the same checkpoint bits;
so does the sharded corpus at dp=2 over two gloo ranks. One intra-op
thread per process.
"""

import dataclasses
import json
from types import SimpleNamespace

import jax
import numpy as np
import torch

import audiogan_tpu.models.wavegan as jwg
import audiogan_tpu.train.loop as jloop
from audiogan_tpu.train.state import create_train_state as jcreate
from audiogan_tpu_torch.config import Config, MeshCfg
from audiogan_tpu_torch.tools import dp_check
from audiogan_tpu_torch.tools.step_checks import same_bits, state_parts
from audiogan_tpu_torch.train import loop
from audiogan_tpu_torch.train import step as tstep

from helpers_train import tiny_config
from test_torch_train import _port_state, _reference_draws

torch.set_num_threads(1)

KEYS = ("d_loss", "g_loss", "gp", "w_dist", "gp_grad_norm", "d_loss_mean")


def _cfg(**data):
    cfg = tiny_config()
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, device_corpus=True, **data),
        train=dataclasses.replace(cfg.train, total_steps=4, log_every=1,
                                  ckpt_every=0, sample_every=0))


def _metrics(workdir):
    return [json.loads(ln) for ln in
            (workdir / "metrics.jsonl").read_text().splitlines()]


def _reference_run(cfg, workdir):
    """The reference loop's metrics and, per step, the shuffle shifts its
    step drew (in site order; the critic's init draws too, unrecorded)."""
    rec = []
    orig, create = jwg.phase_shuffle, jloop.create_train_state

    def recording(h, key, rad, impl=None):
        sh = jax.random.randint(key, (h.shape[0],), -rad, rad + 1)
        jax.debug.callback(lambda v: rec.append(np.array(v)), sh,
                           ordered=True)
        return orig(h, key, rad, impl=impl)

    def unrecorded(*a, **k):
        jwg.phase_shuffle = orig
        try:
            return create(*a, **k)
        finally:
            jwg.phase_shuffle = recording
    jwg.phase_shuffle, jloop.create_train_state = recording, unrecorded
    try:
        jloop.train(cfg, workdir, resume=False)
        jax.effects_barrier()
    finally:
        jwg.phase_shuffle, jloop.create_train_state = orig, create
    sites = len(cfg.model.strides) - 1
    views = 1 if cfg.train.fused_d_views else 2
    per = sites * (cfg.loss.n_critic * (views + 1) + 1)
    assert len(rec) == per * cfg.train.total_steps
    return _metrics(workdir), [rec[s * per:(s + 1) * per]
                               for s in range(cfg.train.total_steps)]


def test_loop_matches_the_reference_loop(tmp_path, monkeypatch):
    cfg = _cfg(index_chunk=3)
    want, shifts = _reference_run(cfg, tmp_path / "jax")
    j0 = jcreate(cfg)
    draws = {s: _reference_draws(cfg, SimpleNamespace(
        base_key=j0.base_key, step=s), sh) for s, sh in enumerate(shifts)}
    pcfg, st0 = _port_state(cfg, j0)
    monkeypatch.setattr(loop, "create_train_state",
                        lambda *a, **k: st0)
    monkeypatch.setattr(tstep, "draw_step",
                        lambda c, seed, step, *a, **k: draws[step])
    loop.train(pcfg, tmp_path / "torch", device="cpu", tensorboard=False,
               log=lambda _: None)
    got = _metrics(tmp_path / "torch")
    assert [r["step"] for r in got] == [r["step"] for r in want] \
        == [1, 2, 3, 4]
    for a, b in zip(want, got):
        for k in KEYS:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {a['step']} {k}")


def _port_cfg(**data):
    return Config.from_json(_cfg(**data).to_json()).validate()


def _last_ckpt(workdir, step):
    return state_parts(torch.load(workdir / f"ckpt/{step}.pt",
                                  weights_only=True))


def test_chunks_train_the_same_bits(tmp_path):
    """index_chunk 0, 3 and 512 over 5 steps (blocks 0-2 and 3-5 at 3,
    one block at 512), and 3 resumed at step 2 (mid-block: the block is
    rebuilt whole): the same step-5 checkpoint to the bit."""
    runs = {}
    for name, chunk in (("c0", 0), ("c3", 3), ("c512", 512)):
        loop.train(_port_cfg(index_chunk=chunk), tmp_path / name, 5,
                   device="cpu", tensorboard=False, log=lambda _: None)
        runs[name] = _last_ckpt(tmp_path / name, 5)
    resumed = tmp_path / "c3_resumed"
    lines = []
    for steps in (2, 5):
        loop.train(_port_cfg(index_chunk=3), resumed, steps, device="cpu",
                   tensorboard=False, log=lines.append)
    assert '{"resume": {"step": 2}}' in lines
    runs["resumed"] = _last_ckpt(resumed, 5)
    for name in ("c3", "c512", "resumed"):
        assert same_bits(runs["c0"], runs[name], name) > 0


def test_sharded_chunks_train_the_same_bits_dp2(tmp_path):
    """The sharded corpus at dp=2 over two gloo ranks: index_chunk 3
    (the block on the host, where the exchange plans) against 0, both
    ranks' states to the bit after 4 steps."""
    def job(name, chunk):
        cfg = dataclasses.replace(
            _port_cfg(index_chunk=chunk, device_corpus_shard="shard"),
            mesh=MeshCfg(dp=2))
        return {"name": name, "fn": "train",
                "kw": {"cfg_json": cfg.to_json(),
                       "workdir": str(tmp_path / name), "steps": 4}}
    res = dp_check.spawn(2, [job("c0", 0), job("c3", 3)], tmp_path / "out")
    for rank in range(2):
        assert same_bits(state_parts(res["c0"][rank]),
                         state_parts(res["c3"][rank])) > 0
    assert same_bits(state_parts(res["c3"][0]), state_parts(res["c3"][1]))
