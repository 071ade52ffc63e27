"""audiogan_tpu_torch's data-parallel launch and checkpoints on the CPU
(gloo, one intra-op thread per process):

- ``cli train`` under ``python -m torch.distributed.run --nproc_per_node
  2 ... --device cpu --set mesh.dp=2``: one set of JSON lines (rank 0's),
  one ``metrics.jsonl``, one checkpoint; and the same run launched as two
  one-process "hosts" (``--nnodes 2 --node_rank h``, static rendezvous),
  whose ranks torchrun orders (host, local rank), writing the same
  checkpoint to the bit;
- checkpoints across topologies (the counterparts of
  tests/train/test_cross_topology_restore.py:46,76): a dp=2 ZeRO-1 run's
  step-2 checkpoint (whole moments) continued at dp=1, and a dp=1 run's
  continued at dp=2 with ZeRO-1, each against the uninterrupted runs at
  the reference's DP tolerance (rtol 2e-4, atol 1e-5).
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from audiogan_tpu_torch.config import Config, MeshCfg
from audiogan_tpu_torch.tools import dp_check
from audiogan_tpu_torch.tools.step_checks import same_bits, state_parts
from audiogan_tpu_torch.train import loop

from helpers_train import tiny_config

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LAUNCH_TIMEOUT_S = 240
KEYS = ("d_loss", "d_loss_mean", "g_loss", "gp", "gp_grad_norm", "w_dist")


def _cfg(dp=1, fsdp=False, **train):
    cfg = tiny_config()
    cfg = dataclasses.replace(
        cfg, mesh=MeshCfg(dp=dp, fsdp=fsdp),
        train=dataclasses.replace(cfg.train, log_every=1, ckpt_every=2,
                                  **train))
    return Config.from_json(cfg.to_json()).validate()


def _records(workdir):
    return {r["step"]: r for r in map(
        json.loads, (Path(workdir) / "metrics.jsonl").read_text()
        .splitlines())}


def _torchrun(*args, workdir, config):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [sys.executable, "-m", "torch.distributed.run", *args,
            "-m", "audiogan_tpu_torch.cli", "train", "--config",
            str(config), "--device", "cpu", "--total_steps", "2",
            "--no_tensorboard", "--workdir", str(workdir)], env


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_cli_train_under_torchrun_and_as_two_hosts(tmp_path):
    config = tmp_path / "config.json"
    config.write_text(_cfg(dp=2).to_json())
    cmd, env = _torchrun("--nproc_per_node", "2", "--master_addr",
                         "127.0.0.1", "--master_port",
                         str(dp_check.free_port()),
                         workdir=tmp_path / "flat", config=config)
    flat = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=LAUNCH_TIMEOUT_S)
    assert flat.returncode == 0, flat.stderr[-3000:]
    lines = _json_lines(flat.stdout)
    assert [ln["step"] for ln in lines if "step" in ln] == [1, 2]
    assert [ln["ckpt"]["step"] for ln in lines if "ckpt" in ln] == [2]
    assert [ln["init"]["dp"] for ln in lines if "init" in ln] == [2]
    assert sorted(_records(tmp_path / "flat")) == [1, 2]
    assert sorted(p.name for p in (tmp_path / "flat/ckpt").iterdir()) == \
        ["2.json", "2.pt"]

    port = str(dp_check.free_port())
    procs = []
    for host in (0, 1):
        cmd, env = _torchrun("--nnodes", "2", "--node_rank", str(host),
                             "--nproc_per_node", "1", "--master_addr",
                             "127.0.0.1", "--master_port", port,
                             workdir=tmp_path / "hosts", config=config)
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=LAUNCH_TIMEOUT_S) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert [ln["step"] for ln in _json_lines(outs[0][0]) if "step" in ln] \
        == [1, 2]
    assert not _json_lines(outs[1][0])      # host 1 holds rank 1: silent
    a = torch.load(tmp_path / "flat/ckpt/2.pt", weights_only=True)
    b = torch.load(tmp_path / "hosts/ckpt/2.pt", weights_only=True)
    parts = ("g", "d", "opt_g", "opt_d", "step")
    assert same_bits({k: a[k] for k in parts},
                     {k: b[k] for k in parts}) > 0


def _seed_from(src, dst, step):
    """A workdir holding src's config, corpus and step checkpoint only."""
    (dst / "ckpt").mkdir(parents=True)
    for name in (f"{step}.pt", f"{step}.json"):
        shutil.copy(src / "ckpt" / name, dst / "ckpt" / name)


def _close(got, want, steps):
    for s in steps:
        for k in KEYS:
            np.testing.assert_allclose(got[s][k], want[s][k], rtol=2e-4,
                                       atol=1e-5, err_msg=f"{s} {k}")


def test_checkpoints_cross_topologies(tmp_path):
    one = tmp_path / "dp1"
    loop.train(_cfg(), one, 4, device="cpu", log=lambda _: None,
               tensorboard=False)
    _seed_from(one, tmp_path / "dp1_to_dp2", 2)
    two = _cfg(dp=2, fsdp=True).to_json()
    res = dp_check.spawn(2, [
        {"name": "uninterrupted", "fn": "train",
         "kw": {"cfg_json": two, "workdir": str(tmp_path / "dp2"),
                "steps": 4}},
        {"name": "continued", "fn": "train",
         "kw": {"cfg_json": two, "workdir": str(tmp_path / "dp1_to_dp2"),
                "steps": 4}}], tmp_path / "out")
    saved = torch.load(tmp_path / "dp2/ckpt/2.pt", weights_only=True)
    d = {n: p.shape for n, p in saved["d"].items()}
    for i, st in saved["opt_d"]["state"].items():
        assert st["exp_avg"].shape == list(d.values())[i]     # whole
    _seed_from(tmp_path / "dp2", tmp_path / "dp2_to_dp1", 2)
    lines = []
    loop.train(_cfg(), tmp_path / "dp2_to_dp1", 4, device="cpu",
               log=lambda s: lines.append(json.loads(s)),
               tensorboard=False)
    assert [ln["resume"]["step"] for ln in lines if "resume" in ln] == [2]
    resumed = [ln["resume"]["step"] for ln in
               res["continued"][0]["lines"] if "resume" in ln]
    assert resumed == [2]
    r1, r2 = _records(one), _records(tmp_path / "dp2")
    _close(r2, r1, (1, 2, 3, 4))
    _close(_records(tmp_path / "dp2_to_dp1"), r2, (3, 4))
    _close(_records(tmp_path / "dp1_to_dp2"), r1, (3, 4))
    same_bits(state_parts(res["continued"][0]),
              state_parts(res["continued"][1]))
