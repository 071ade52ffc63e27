"""The reference loop's tracing options in audiogan_tpu_torch's loop, on
the CPU (one intra-op thread): train.profile_dir with
train.profile_steps and train.dump_hlo.

profile_dir: the trace (trace_rank0.json) holds the ranges of the
window's steps only, counted from the step the run starts at, with the
model parts' spans of those steps; a window past the last step closes
there; the checkpoint equals an unprofiled run's to the bit.

dump_hlo: on the CPU step_graph.txt lists the aten ops of one step, the
counterpart of the reference's step_optimized_hlo.txt
(tests/train/test_device_corpus.py::test_loop_end_to_end_device_corpus):
every conv of the step (K1' and K1 calls at the counts the step's
structure gives, one aten convolution each in their plain forms) and
Adam's foreach update; metrics.jsonl and the checkpoints equal a run
without the dump. On a multi-process mesh: tests/test_torch_step_graph_mesh.py.
"""

import dataclasses
import json

import pytest
import torch

from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.tools.step_checks import (conv_step_launches,
                                                  same_bits, state_parts)
from audiogan_tpu_torch.train import loop
from audiogan_tpu_torch.train.step_graph import GRAPH_FILE, read_summary

from helpers_train import tiny_config

torch.set_num_threads(1)


def _cfg(**train):
    cfg = tiny_config()
    train = {"log_every": 1, "ckpt_every": 0, "sample_every": 0, **train}
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             **train))
    return Config.from_json(cfg.to_json()).validate()


def _run(tmp_path, name, steps, **train):
    loop.train(_cfg(**train), tmp_path / name, steps, device="cpu",
               tensorboard=False, log=lambda _: None)
    return tmp_path / name


def _ckpt(workdir, step):
    return state_parts(torch.load(workdir / f"ckpt/{step}.pt",
                                  weights_only=True))


def _records(workdir):
    return [{k: v for k, v in json.loads(ln).items()
             if k != "time" and "per_sec" not in k}
            for ln in (workdir / "metrics.jsonl").read_text().splitlines()]


def _trace(path):
    events = json.loads(path.read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    return (sorted(n for n in names if n.startswith("train_step ")),
            {k: names.count(k) for k in ("wave_critic", "generator")})


def _per_step(cfg):
    views = 1 if cfg.train.fused_d_views else 2
    n = cfg.loss.n_critic
    return {"wave_critic": n * (views + 1) + 1, "generator": n + 1}


@pytest.mark.parametrize("start,window,want", [
    (0, (1, 3), [1, 2]), (2, (1, 2), [3]), (0, (3, 10), [3, 4])],
    ids=["window", "after_resume", "past_the_end"])
def test_profile_window(tmp_path, start, window, want):
    plain = _run(tmp_path, "plain", 5)
    wd = tmp_path / "profiled"
    trace_dir = tmp_path / "trace"
    sets = dict(profile_dir=str(trace_dir), profile_steps=window)
    if start:
        _run(tmp_path, "profiled", start)
    lines = []
    loop.train(_cfg(**sets), wd, 5, device="cpu", tensorboard=False,
               log=lines.append)
    steps, spans = _trace(trace_dir / "trace_rank0.json")
    assert steps == [f"train_step {s}" for s in want]
    per = _per_step(_cfg())
    assert spans == {k: v * len(want) for k, v in per.items()}
    assert same_bits(_ckpt(plain, 5), _ckpt(wd, 5)) > 0


def test_dump_hlo_lists_the_step_on_the_cpu(tmp_path):
    plain = _run(tmp_path, "plain", 3, ckpt_every=1)
    dumped = _run(tmp_path, "dumped", 3, ckpt_every=1, dump_hlo=True)
    assert _records(plain) == _records(dumped)
    for step in (1, 2, 3):
        assert same_bits(_ckpt(plain, step), _ckpt(dumped, step)) > 0
    summary = read_summary(dumped)
    want = conv_step_launches(_cfg())
    assert summary["by_kernel"]["K1' conv1d_ba"] == want["conv1d"]
    assert summary["by_kernel"]["K1 conv_transpose1d_ba"] == want["convt1d"]
    lines = (dumped / GRAPH_FILE).read_text().splitlines()
    ops = [ln.split()[2] for ln in lines if not ln.startswith("#")]
    assert len(ops) == summary["ops"]
    convs = [ln for ln in lines if " op aten.convolution.default" in ln]
    assert len(convs) == want["conv1d"] + want["convt1d"]
    assert all("[K1" in ln for ln in convs)
    n_adam = _cfg().loss.n_critic + 1
    # the step sizes as a tensor (kernels/adam.py's plain form)
    assert ops.count("aten._foreach_addcdiv_.Tensor") == n_adam
    assert ops.count("aten._foreach_lerp_.Scalar") == n_adam
