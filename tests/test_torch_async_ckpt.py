"""The training loop's asynchronous checkpoint save
(audiogan_tpu_torch/utils/checkpoint.py::AsyncSaver, the counterpart of
audiogan_tpu/train/loop.py::_AsyncCkpt), on the CPU at one intra-op
thread.

A writer slowed by a patched torch.save lets steps 4 and 5 run while the
step-3 file is written, logs the step-3 line only once the file is in
place, and the file holds step 3's state to the bit (a run of 3 steps
writes the same); a writer's error is raised at the next join, and no
file of that step is listed; ``cli train`` sent SIGKILL in the middle of
a write leaves a temporary file that no listing shows and resumes from
the last complete checkpoint to the bits of an uninterrupted run; at
dp=2 over two gloo ranks with mesh.fsdp the file holds the whole state,
equal to what a dp=1 process writes of it and to the replicated run's.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from audiogan_tpu_torch.config import Config, MeshCfg
from audiogan_tpu_torch.tools import dp_check
from audiogan_tpu_torch.tools.step_checks import same_bits, state_parts
from audiogan_tpu_torch.train import loop
from audiogan_tpu_torch.train.state import create_train_state
from audiogan_tpu_torch.utils import checkpoint as ckpt

from helpers_train import tiny_config

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def _cfg(**train):
    cfg = tiny_config()
    train = {"log_every": 1, "ckpt_every": 3, "sample_every": 0, **train}
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             **train))
    return Config.from_json(cfg.to_json()).validate()


def _train(cfg, workdir, steps, lines):
    return loop.train(cfg, workdir, steps, device="cpu", tensorboard=False,
                      log=lambda s: lines.append(json.loads(s)))


def _ckpt(workdir, step):
    return state_parts(torch.load(workdir / f"ckpt/{step}.pt",
                                  weights_only=True))


def _slowed_save(monkeypatch, step: int, before_write):
    """torch.save, but the file of ``step`` waits for before_write()."""
    orig = torch.save

    def save(obj, f, *a, **k):
        if isinstance(obj, dict) and obj.get("step") == step:
            before_write()
        return orig(obj, f, *a, **k)
    monkeypatch.setattr(torch, "save", save)


def test_steps_run_while_the_file_is_written(tmp_path, monkeypatch):
    lines: list = []
    step5 = threading.Event()
    seen = {}

    def wait_for_step5():
        seen["step5_in_time"] = step5.wait(timeout=120)
        seen["lines_before_write"] = list(lines)

    def log(s):
        lines.append(json.loads(s))
        if lines[-1].get("step") == 5:
            step5.set()
    _slowed_save(monkeypatch, 3, wait_for_step5)
    loop.train(_cfg(), tmp_path / "async", 6, device="cpu",
               tensorboard=False, log=log)
    assert seen["step5_in_time"]
    assert not any("ckpt" in ln for ln in seen["lines_before_write"])
    order = [ln.get("step") or f"ckpt {ln['ckpt']['step']}" for ln in lines
             if "step" in ln or "ckpt" in ln]
    assert order.index("ckpt 3") > order.index(5)
    assert order[-1] == "ckpt 6"
    for ln in lines:
        if "ckpt" in ln:
            rec = ln["ckpt"]
            assert set(rec) == {"step", "bytes", "blocked", "parts",
                                "write"}
            parts = rec["parts"]
            assert set(parts) == {"join", "state", "alloc", "copy",
                                  "event", "new_segments"}
            assert parts["new_segments"] == 0          # no card here
            assert sum(v for k, v in parts.items()
                       if k != "new_segments") <= rec["blocked"]
            assert rec["bytes"] == (tmp_path / "async" / "ckpt" /
                                    f"{rec['step']}.pt").stat().st_size
    monkeypatch.undo()
    _train(_cfg(), tmp_path / "sync", 3, [])
    assert same_bits(_ckpt(tmp_path / "async", 3),
                     _ckpt(tmp_path / "sync", 3)) > 0


def test_a_writer_error_surfaces_at_the_next_join(tmp_path, monkeypatch):
    def fail():
        raise OSError("no space left on the test's device")
    _slowed_save(monkeypatch, 3, fail)
    lines: list = []
    with pytest.raises(OSError, match="no space left"):
        _train(_cfg(), tmp_path, 6, lines)
    assert not any("ckpt" in ln for ln in lines)
    assert ckpt.make_manager(tmp_path).all_steps() == []
    assert not list((tmp_path / "ckpt").glob("*.tmp"))


def test_the_saver_raises_its_error_at_join(tmp_path, monkeypatch):
    mngr = ckpt.make_manager(tmp_path)
    state = create_train_state(_cfg(), device="cpu")
    got = []
    saver = ckpt.AsyncSaver(mngr, torch.device("cpu"),
                            on_complete=got.append)
    saver.save(state)
    saver.join()
    assert [r["step"] for r in got] == [0] and mngr.all_steps() == [0]
    _slowed_save(monkeypatch, 1, lambda: (_ for _ in ()).throw(
        RuntimeError("writer failed")))
    state.step = 1
    saver.save(state)
    with pytest.raises(RuntimeError, match="writer failed"):
        saver.join()
    saver.join()                 # raised once
    assert mngr.all_steps() == [0] and len(got) == 1


# A cli train whose step-6 torch.save writes a part of the file, says so
# and waits to be killed.
KILLED_IN_WRITE = """
import sys, time, torch
orig = torch.save
def save(obj, f, *a, **k):
    if isinstance(obj, dict) and obj.get("step") == 6:
        f.write(b"part of a checkpoint")
        f.flush()
        print("WRITING 6", flush=True)
        time.sleep(600)
    return orig(obj, f, *a, **k)
torch.save = save
from audiogan_tpu_torch.cli import main
sys.exit(main(sys.argv[1:]))
"""


def _cli_train(workdir, script=None):
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    head = ["-c", script] if script else ["-m", "audiogan_tpu_torch.cli"]
    return subprocess.Popen(
        [sys.executable, *head, "train", "--preset", "tiny_sc09",
         "--device", "cpu", "--batch_size", "2", "--total_steps", "9",
         "--set", "train.ckpt_every=3", "--set", "train.log_every=1",
         "--no_tensorboard", "--workdir", str(workdir)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _finish(proc) -> list[dict]:
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-2000:]
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_a_kill_in_the_middle_of_a_write_resumes_from_the_last_file(
        tmp_path):
    clean = _cli_train(tmp_path / "clean")
    crashy = _cli_train(tmp_path / "crashy", KILLED_IN_WRITE)
    out = []
    for line in crashy.stdout:
        out.append(line)
        if line.startswith("WRITING 6"):
            crashy.send_signal(signal.SIGKILL)
            break
    crashy.wait(timeout=60)
    assert crashy.returncode == -signal.SIGKILL, "".join(out)[-2000:]
    assert '{"ckpt": {"step": 3' in "".join(out)
    assert '{"ckpt": {"step": 6' not in "".join(out)
    ckpt_dir = tmp_path / "crashy" / "ckpt"
    assert [p.name for p in ckpt_dir.glob("*.tmp")] != []
    assert ckpt.make_manager(tmp_path / "crashy").all_steps() == [3]
    _finish(clean)
    resumed = _finish(_cli_train(tmp_path / "crashy"))
    assert {"resume": {"step": 3}} in resumed
    assert same_bits(_ckpt(tmp_path / "clean", 9),
                     _ckpt(tmp_path / "crashy", 9)) > 0


def test_dp2_fsdp_writes_the_file_dp1_writes(tmp_path):
    """Two gloo ranks with mesh.fsdp: rank 0's file holds whole moments;
    restored into a dp=1 state and saved there, the same file, tensor
    for tensor; and the replicated dp=2 run's file is the same bits."""
    jobs = []
    for name, fsdp in (("fsdp", True), ("replicated", False)):
        cfg = dataclasses.replace(_cfg(ckpt_every=2),
                                  mesh=MeshCfg(dp=2, fsdp=fsdp))
        jobs.append({"name": name, "fn": "train", "kw": {
            "cfg_json": cfg.to_json(), "workdir": str(tmp_path / name),
            "steps": 2}})
    out = dp_check.spawn(2, jobs, tmp_path / "spawn")
    assert [ln["ckpt"]["step"] for ln in out["fsdp"][0]["lines"]
            if "ckpt" in ln] == [2]
    written = _ckpt(tmp_path / "fsdp", 2)
    assert same_bits(written, _ckpt(tmp_path / "replicated", 2)) > 0
    one = create_train_state(_cfg(), device="cpu")
    ckpt.restore(ckpt.make_manager(tmp_path / "fsdp"), one)
    ckpt.save(ckpt.make_manager(tmp_path / "dp1"), one)
    assert same_bits(written, _ckpt(tmp_path / "dp1", 2)) > 0
    blob = torch.load(tmp_path / "fsdp" / "ckpt" / "2.pt", weights_only=True)
    for part in ("opt_g", "opt_d"):
        for st in blob[part]["state"].values():
            assert st["exp_avg"].shape == st["exp_avg_sq"].shape
    d = dict(one.d.named_parameters())
    for i, (name, p) in enumerate(d.items()):
        assert blob["opt_d"]["state"][i]["exp_avg"].shape == p.shape, name
