"""audiogan_tpu_torch's checkpoints, resume, metrics and sample dumps
against the JAX package's (utils/checkpoint.py, utils/metrics.py,
train/loop.py, cli.py), at ``tiny_config`` sizes on the CPU.

Resume is held to the bit: the port's step is a function of (seed, step),
so 2 steps, a restart and 2 more give the same metrics, parameters and
Adam moments as 4 straight steps, through ``loop.train`` and through a
SIGKILL of ``cli train`` (the counterpart of
tests/train/test_fault_injection.py). Which checkpoints survive is held to
orbax's CheckpointManager on the same saves and metrics.
"""

import base64
import dataclasses
import importlib.util
import io
import json
import os
import signal
import subprocess
import sys
import threading
import types
import urllib.request
import wave
from collections import namedtuple
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from audiogan_tpu.train.loop import _dump_samples as jdump_samples
from audiogan_tpu.train.state import create_train_state as jcreate
from audiogan_tpu.train.step import build_train_step as jbuild_step
from audiogan_tpu.utils import checkpoint as jckpt
from audiogan_tpu.utils.metrics import MetricsWriter as JMetricsWriter
from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.convert import params_from_jax, train_state_from_jax
from audiogan_tpu_torch.train import loop
from audiogan_tpu_torch.train.sample import generate
from audiogan_tpu_torch.train.state import create_train_state
from audiogan_tpu_torch.train.step import build_train_step
from audiogan_tpu_torch.utils import checkpoint as ckpt
from audiogan_tpu_torch.utils import metrics as tmetrics

from helpers_train import raw_batch, tiny_config
from test_torch_train import _adam_leaves, _flat

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test: parallel workers share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg(**train) -> Config:
    base = tiny_config()
    jcfg = tiny_config(train=dataclasses.replace(base.train, **train))
    return Config.from_json(jcfg.to_json()).validate()


def _stepped_state(cfg, steps=1, seed=0):
    st = create_train_state(cfg, seed=seed, device="cpu")
    fn = build_train_step(cfg, device="cpu")
    for s in range(steps):
        clips, labels = raw_batch(tiny_config(), seed=100 + s)
        fn(st, torch.from_numpy(clips), torch.from_numpy(labels))
    return st


def _tensors(state) -> dict[str, torch.Tensor]:
    """Every tensor of a port TrainState by name, Adam's step included."""
    out = {}
    for net, mod, opt in (("g", state.g, state.opt_g),
                          ("d", state.d, state.opt_d)):
        for name, p in mod.named_parameters():
            out[f"{net}/{name}"] = p.detach()
            for k, v in opt.state[p].items():
                out[f"{net}/{name}/{k}"] = v
    return out


def _assert_same_bits(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].device == b[k].device, k
        assert torch.equal(a[k], b[k]), k


def test_save_restore_is_exact(tmp_path):
    cfg = _cfg()
    st = _stepped_state(cfg)
    mngr = ckpt.make_manager(tmp_path, keep=2, config=cfg)
    nbytes = ckpt.save(mngr, st, {"w_dist": 1.5})
    assert nbytes == (tmp_path / "ckpt" / "1.pt").stat().st_size
    fresh = create_train_state(cfg, seed=7, device="cpu")
    restored = ckpt.restore(mngr, fresh)
    assert restored is fresh and fresh.step == 1 and fresh.seed == 0
    _assert_same_bits(_tensors(st), _tensors(fresh))
    for opt in (fresh.opt_g, fresh.opt_d):
        for s in opt.state.values():
            # as a fresh Adam keeps it: a CPU f32 count, read without a
            # device sync in each step
            assert s["step"].device.type == "cpu"
            assert s["step"].dtype == torch.float32
    blob = ckpt.load(mngr)
    assert Config.from_json(blob["config"]) == cfg
    assert blob["metrics"] == {"w_dist": 1.5}
    assert mngr.metrics(1) == {"w_dist": 1.5}


def test_restore_keeps_the_configs_hyperparameters(tmp_path):
    cfg = _cfg()
    mngr = ckpt.make_manager(tmp_path)
    ckpt.save(mngr, _stepped_state(cfg))
    other = _cfg(lr_d=3e-4)
    st = ckpt.restore(mngr, create_train_state(other, device="cpu"))
    assert st.opt_d.param_groups[0]["lr"] == 3e-4
    assert st.opt_g.param_groups[0]["lr"] == cfg.train.lr_g


def _records(workdir) -> dict[int, dict]:
    lines = (Path(workdir) / "metrics.jsonl").read_text().splitlines()
    return {r["step"]: r for r in map(json.loads, lines)}


def _same_record(a: dict, b: dict) -> None:
    keys = [k for k in a if k != "time" and "per_sec" not in k]
    assert sorted(keys) == sorted(k for k in b if k != "time"
                                  and "per_sec" not in k)
    for k in keys:
        assert a[k] == b[k], (k, a[k], b[k])


def test_restart_replays_the_run(tmp_path):
    """4 straight steps == 2 steps, a restart and 2 more, through
    loop.train (tests/train/test_checkpoint.py:27 for the JAX step)."""
    cfg = _cfg(log_every=1, ckpt_every=2)
    lines = []
    sa, ma = loop.train(cfg, tmp_path / "a", 4, device="cpu",
                        log=lines.append, tensorboard=False)
    loop.train(cfg, tmp_path / "b", 2, device="cpu", log=lines.append,
               tensorboard=False)
    resumed = []
    sb, mb = loop.train(cfg, tmp_path / "b", 4, device="cpu",
                        log=resumed.append, tensorboard=False)
    assert json.loads(resumed[1]) == {"resume": {"step": 2}}
    assert [ln["step"] for ln in map(json.loads, resumed)
            if "d_loss" in ln] == [3, 4]
    assert sa.step == sb.step == 4 and ma == mb
    _assert_same_bits(_tensors(sa), _tensors(sb))
    ra, rb = _records(tmp_path / "a"), _records(tmp_path / "b")
    assert sorted(ra) == sorted(rb) == [1, 2, 3, 4]
    for s in ra:
        _same_record(ra[s], rb[s])
    # the loop's throughput fields, as audiogan_tpu/train/loop.py:329-331
    per_step_audio = (cfg.train.batch_size * cfg.loss.n_critic
                      * cfg.data.clip_len / cfg.data.sample_rate)
    for r in ra.values():
        assert r["steps_per_sec"] > 0
        assert abs(r["train_audio_sec_per_sec"] - r["steps_per_sec"]
                   * per_step_audio) <= 1e-6 * (1 + per_step_audio)
    assert ckpt.latest_step(ckpt.make_manager(tmp_path / "b")) == 4
    # a run to a step already reached takes no step
    st, m = loop.train(cfg, tmp_path / "b", 4, device="cpu",
                       log=lambda s: None, tensorboard=False)
    assert st.step == 4 and m == {}


def test_no_resume_starts_from_zero(tmp_path):
    cfg = _cfg(log_every=1)
    loop.train(cfg, tmp_path, 1, device="cpu", log=lambda s: None,
               tensorboard=False)
    lines = []
    st, _ = loop.train(cfg, tmp_path, 1, resume=False, device="cpu",
                       log=lines.append, tensorboard=False)
    assert st.step == 1 and not any("resume" in ln for ln in lines)


JState = namedtuple("JState", ["step", "x"])


def _policy_runs(tmp_path, keep, best_metric, best_mode, saves):
    """The same saves through orbax's manager and the port's: (latest,
    best, surviving steps) of each."""
    jm = jckpt.make_manager(tmp_path / "jax", keep=keep,
                            best_metric=best_metric, best_mode=best_mode)
    cfg = _cfg()
    tm = ckpt.make_manager(tmp_path / "torch", keep=keep,
                           best_metric=best_metric, best_mode=best_mode)
    st = create_train_state(cfg, device="cpu")
    for step, metrics in saves:
        jckpt.save(jm, JState(np.int32(step), np.zeros(2, np.float32)),
                   wait=True, metrics=metrics)
        st.step = step
        ckpt.save(tm, st, metrics)
    return ((jckpt.latest_step(jm), jm.best_step(), list(jm.all_steps())),
            (ckpt.latest_step(tm), ckpt.best_step(tm), tm.all_steps()))


@pytest.mark.parametrize("keep,best_metric,best_mode,saves", [
    # tests/train/test_checkpoint.py:54: w_dist 1, 5, 2 under max, keep 1
    (1, "w_dist", "max", [(1, {"w_dist": 1.0}), (2, {"w_dist": 5.0}),
                          (3, {"w_dist": 2.0})]),
    (2, "w_dist", "min", [(1, {"w_dist": 3.0}), (2, {"w_dist": 1.0}),
                          (3, None), (4, {"w_dist": 2.0}),
                          (5, {"w_dist": 4.0})]),
    (2, None, "min", [(s, {"w_dist": float(s)}) for s in (1, 2, 3, 4)]),
], ids=["best_max", "best_min_without_metrics", "keep_last"])
def test_which_checkpoints_survive(tmp_path, keep, best_metric, best_mode,
                                   saves):
    want, got = _policy_runs(tmp_path, keep, best_metric, best_mode, saves)
    assert got == want
    if best_metric == "w_dist" and best_mode == "max":
        assert got[1] == 2


def test_leftover_temporary_files_are_ignored(tmp_path):
    cfg = _cfg()
    mngr = ckpt.make_manager(tmp_path)
    st = _stepped_state(cfg)
    ckpt.save(mngr, st)
    d = tmp_path / "ckpt"
    (d / ".5.pt.k3j2.tmp").write_bytes(b"half a checkpoint")
    (d / "6.pt.tmp").write_bytes(b"")
    (d / "7.json").write_text(json.dumps({"step": 7, "metrics": None}))
    assert mngr.all_steps() == [1] and ckpt.latest_step(mngr) == 1
    fresh = ckpt.restore(mngr, create_train_state(cfg, device="cpu"))
    _assert_same_bits(_tensors(st), _tensors(fresh))
    # a save leaves no temporary file of its own
    assert sorted(p.name for p in d.iterdir()) == [
        ".5.pt.k3j2.tmp", "1.json", "1.pt", "6.pt.tmp", "7.json"]


def test_restore_with_nothing_to_restore_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        jckpt.restore(jckpt.make_manager(tmp_path / "jax"), None)
    mngr = ckpt.make_manager(tmp_path / "torch")
    assert ckpt.latest_step(mngr) is None and ckpt.best_step(mngr) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(mngr, create_train_state(_cfg(), device="cpu"))
    ckpt.save(mngr, create_train_state(_cfg(), device="cpu"))
    with pytest.raises(FileNotFoundError):
        ckpt.load(mngr, step=3)


def test_jax_state_carried_across_survives_save_and_restore(tmp_path):
    jcfg = tiny_config()
    js = jcreate(jcfg)
    step = jax.jit(jbuild_step(jcfg))
    for s in range(2):
        js, _ = step(js, *raw_batch(jcfg, seed=s))
    js = jax.device_get(js)
    cfg = Config.from_json(jcfg.to_json()).validate()
    st = train_state_from_jax(cfg, _flat(js.params_g), _flat(js.params_d),
                              _adam_leaves(js.opt_g), _adam_leaves(js.opt_d),
                              int(js.step), seed=3, device="cpu")
    mngr = ckpt.make_manager(tmp_path, config=cfg)
    ckpt.save(mngr, st)
    back = ckpt.restore(mngr, create_train_state(cfg, device="cpu"))
    assert back.step == int(js.step) == 2 and back.seed == 3
    for mod, opt, params, ost in ((back.g, back.opt_g, js.params_g,
                                   js.opt_g),
                                  (back.d, back.opt_d, js.params_d,
                                   js.opt_d)):
        ref = params_from_jax(_flat(params))
        adam = _adam_leaves(ost)
        mu, nu = params_from_jax(adam["mu"]), params_from_jax(adam["nu"])
        assert set(ref) == {n for n, _ in mod.named_parameters()}
        for n, p in mod.named_parameters():
            assert torch.equal(p.detach(), ref[n]), n
            s = opt.state[p]
            assert torch.equal(s["exp_avg"], mu[n]), n
            assert torch.equal(s["exp_avg_sq"], nu[n]), n
            # G one update per step, the critic n_critic
            assert float(s["step"]) == adam["count"] > 0


def test_metrics_records_match_the_jax_writer(tmp_path, capsys):
    metrics = {"d_loss": np.float32(-1.23456789), "w_dist": 3.000000049,
               "gp": 1e-9, "steps_per_sec": 8.123456789}
    jw = JMetricsWriter(tmp_path / "jax", also_tensorboard=False)
    for step in (50, 100):
        jw.write(step, metrics)
    jw.close()
    capsys.readouterr()
    tw = tmetrics.MetricsWriter(tmp_path / "torch", also_tensorboard=False)
    for step in (50, 100):
        rec = tw.write(step, metrics)
    tw.close()
    assert capsys.readouterr().out == ""   # the loop prints its own line
    ja, ta = _records(tmp_path / "jax"), _records(tmp_path / "torch")
    assert ta[100] == rec
    for s in (50, 100):
        assert list(ja[s]) == list(ta[s])
        _same_record({**ja[s], "time": 0}, {**ta[s], "time": 0})
        assert ja[s]["steps_per_sec"] == ta[s]["steps_per_sec"]


def test_metrics_writer_writes_tensorboard_where_it_imports(tmp_path,
                                                            monkeypatch):
    seen = []

    class Writer:
        def __init__(self, logdir):
            seen.append(("dir", logdir))

        def add_scalar(self, tag, value, step):
            seen.append((tag, value, step))

        def close(self):
            seen.append("closed")
    fake = types.ModuleType("torch.utils.tensorboard")
    fake.SummaryWriter = Writer
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    w = tmetrics.MetricsWriter(tmp_path)
    w.write(3, {"gp": 2.5})
    w.close()
    assert seen == [("dir", str(tmp_path / "tb")), ("gp", 2.5, 3), "closed"]
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert tmetrics._tensorboard_writer(tmp_path / "tb") is None


@pytest.mark.parametrize("num_classes", [0, 4], ids=["uncond", "cond"])
def test_sample_dumps_are_named_as_the_reference_names_them(tmp_path,
                                                            num_classes):
    jcfg = tiny_config(data=dataclasses.replace(tiny_config().data,
                                                num_classes=num_classes))
    cfg = Config.from_json(jcfg.to_json()).validate()
    seen = {}

    def jsample(params, key, labels, num):
        seen["labels"] = labels
        return np.zeros((num, jcfg.data.clip_len), np.float32)
    jdump_samples(jcfg, types.SimpleNamespace(params_g=None), jsample,
                  tmp_path / "jax", 20)
    st = create_train_state(cfg, device="cpu")
    out = loop.dump_samples(cfg, st, tmp_path / "torch", 20, "cpu")
    assert out == tmp_path / "torch" / "samples" / "step_00000020"
    names = sorted(p.name for p in out.iterdir())
    assert names == sorted(
        p.name for p in (tmp_path / "jax" / "samples" / "step_00000020")
        .iterdir())
    assert len(names) == 4
    labels = seen["labels"]
    if num_classes:
        assert names[1] == "sample_1_y1.wav"
        np.testing.assert_array_equal(labels, np.arange(4) % num_classes)
    want = generate(cfg, st.g.state_dict(), 4, cfg.train.seed + 20, labels,
                    device="cpu")
    for i, name in enumerate(names):
        with wave.open(str(out / name)) as f:
            assert f.getframerate() == cfg.data.sample_rate
            pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
        np.testing.assert_array_equal(
            pcm, np.round(np.clip(want[i], -1, 1) * 32767).astype(np.int16))


def test_loop_dumps_samples_every_sample_every(tmp_path):
    cfg = _cfg(sample_every=2, log_every=2)
    loop.train(cfg, tmp_path, 3, device="cpu", log=lambda s: None,
               tensorboard=False)
    assert [p.name for p in (tmp_path / "samples").iterdir()] == \
        ["step_00000002"]


# --- the CLI ---------------------------------------------------------------

def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


CLI_TRAIN = ["train", "--preset", "tiny_sc09", "--device", "cpu",
             "--batch_size", "2", "--log_every", "1", "--no_tensorboard",
             "--set", "train.ckpt_every=2"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """`cli train --total_steps 2`, then `--total_steps 4`; each run's
    stdout lines."""
    from audiogan_tpu_torch.cli import main
    w = tmp_path_factory.mktemp("cli")
    runs = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for n in (2, 4):
        buf = io.StringIO()
        saved, sys.stdout = sys.stdout, buf
        try:
            assert main(CLI_TRAIN + ["--total_steps", str(n),
                                     "--workdir", str(w)]) == 0
        finally:
            sys.stdout = saved
        runs.append(_json_lines(buf.getvalue()))
    torch.set_num_threads(threads)
    return w, runs


def test_cli_train_resumes(trained):
    w, (first, second) = trained
    assert [ln["step"] for ln in first if "d_loss" in ln] == [1, 2]
    assert {"resume": {"step": 2}} in second
    assert [ln["step"] for ln in second if "d_loss" in ln] == [3, 4]
    assert [ln["ckpt"]["step"] for ln in first + second if "ckpt" in ln] \
        == [2, 4]
    assert sorted(_records(w)) == [1, 2, 3, 4]
    assert json.loads((w / "config.json").read_text())["train"][
        "total_steps"] == 4
    assert ckpt.make_manager(w).all_steps() == [2, 4]


def test_cli_no_resume_starts_at_zero(tmp_path, capsys):
    from audiogan_tpu_torch.cli import main
    args = CLI_TRAIN + ["--steps", "1", "--workdir", str(tmp_path)]
    assert main(args) == 0
    assert main(args + ["--no_resume"]) == 0
    lines = _json_lines(capsys.readouterr().out)
    assert not any("resume" in ln for ln in lines)
    assert [ln["step"] for ln in lines if "d_loss" in ln] == [1, 1]


def _wav(path):
    with wave.open(str(path)) as f:
        return f.getframerate(), np.frombuffer(
            f.readframes(f.getnframes()), "<i2")


def test_cli_sample_and_export_read_the_checkpoint(trained, tmp_path,
                                                   capsys):
    from audiogan_tpu_torch.cli import main
    from audiogan_tpu_torch.serve import load_sampler
    w, _ = trained
    cfg = Config.from_json((w / "config.json").read_text())
    mngr = ckpt.make_manager(w)
    g2, g4 = ckpt.load(mngr, 2)["g"], ckpt.load(mngr, 4)["g"]
    assert main(["sample", "--workdir", str(w), "--device", "cpu",
                 "--num", "2", "--seed", "5"]) == 0
    assert main(["sample", "--workdir", str(w), "--device", "cpu",
                 "--num", "2", "--seed", "5", "--step", "2",
                 "--out_dir", str(tmp_path / "s2")]) == 0
    for d, g in ((w / "generated", g4), (tmp_path / "s2", g2)):
        want = generate(cfg, g, 2, 5, device="cpu")
        rate, pcm = _wav(d / "gen_seed5_1.wav")
        assert rate == cfg.data.sample_rate
        np.testing.assert_array_equal(
            pcm, np.round(np.clip(want[1], -1, 1) * 32767).astype(np.int16))
    assert main(["export", "--workdir", str(w), "--device", "cpu", "--num",
                 "2", "--step", "2"]) == 0
    s = load_sampler(w / "export", device="cpu")
    assert s.num == 2 and s.meta["model"] == "tiny_sc09"
    for k, v in g2.items():
        assert torch.equal(s._params[k], v), k
    with pytest.raises(SystemExit):
        main(["sample", "--workdir", str(w), "--preset", "tiny_sc09",
              "--device", "cpu"])
    with pytest.raises(SystemExit):
        main(["sample", "--init-seed", "0", "--step", "2", "--device",
              "cpu", "--out_dir", str(tmp_path)])
    with pytest.raises(SystemExit):
        main(["sample", "--init-seed", "0", "--device", "cpu"])


def test_cli_serve_reads_the_checkpoint(trained, monkeypatch):
    import audiogan_tpu_torch.serve as serve_pkg
    from audiogan_tpu_torch.cli import main
    w, _ = trained
    real, made = serve_pkg.make_server, []

    def capture(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]
    monkeypatch.setattr(serve_pkg, "make_server", capture)
    cfg = Config.from_json((w / "config.json").read_text())
    want = generate(cfg, ckpt.load(ckpt.make_manager(w), 2)["g"], 2, 9,
                    device="cpu")
    rc = []
    t = threading.Thread(target=lambda: rc.append(main([
        "serve", "--workdir", str(w), "--step", "2", "--device", "cpu",
        "--num", "2", "--port", "0"])), daemon=True)
    t.start()
    try:
        for _ in range(600):
            if made or not t.is_alive():
                break
            t.join(0.05)
        assert made, "the server did not start"
        host, port = made[0].server_address[:2]
        req = urllib.request.Request(
            f"http://{host}:{port}/generate",
            data=json.dumps({"seed": 9, "num": 2}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
    finally:
        if made:
            made[0].shutdown()
        t.join(timeout=60)
    assert rc == [0] and out["num"] == 2
    pcm = np.frombuffer(base64.b64decode(out["wavs"][1])[44:], "<i2")
    np.testing.assert_array_equal(
        pcm, np.round(np.clip(want[1], -1, 1) * 32767).astype(np.int16))
    with pytest.raises(SystemExit):
        main(["serve", "--workdir", str(w), "--artifact", str(w),
              "--device", "cpu"])


# --- SIGKILL, then resume (tests/train/test_fault_injection.py:57, dp=1) ---

def _reference_args():
    spec = importlib.util.spec_from_file_location(
        "jax_fault_injection", REPO / "tests" / "train" /
        "test_fault_injection.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ARGS


def _cli(workdir):
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(
        [sys.executable, "-m", "audiogan_tpu_torch.cli", *_reference_args(),
         "--device", "cpu", "--no_tensorboard", "--workdir", str(workdir)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _finish(proc) -> list[dict]:
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-2000:]
    return _json_lines(out)


def test_sigkill_then_resume_matches_uninterrupted(tmp_path):
    clean = _cli(tmp_path / "clean")
    crashy = _cli(tmp_path / "crashy")
    # SIGKILL as soon as the step-2 checkpoint is in place: the loop
    # prints its line after the rename, before step 3 starts
    killed_after = None
    for line in crashy.stdout:
        if line.startswith('{"ckpt"'):
            killed_after = json.loads(line)["ckpt"]["step"]
            assert (tmp_path / "crashy" / "ckpt" / "2.pt").exists()
            crashy.send_signal(signal.SIGKILL)
            break
    crashy.wait(timeout=60)
    assert killed_after == 2 and crashy.returncode == -signal.SIGKILL
    assert ckpt.make_manager(tmp_path / "crashy").all_steps() == [2]
    _finish(clean)
    want = _records(tmp_path / "clean")
    resumed = _finish(_cli(tmp_path / "crashy"))
    assert {"resume": {"step": 2}} in resumed
    got = _records(tmp_path / "crashy")
    _same_record(got[4], want[4])
    a = ckpt.load(ckpt.make_manager(tmp_path / "clean"), 4)
    b = ckpt.load(ckpt.make_manager(tmp_path / "crashy"), 4)
    for part in ("g", "d"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    for part in ("opt_g", "opt_d"):
        for i, s in a[part]["state"].items():
            for k, v in s.items():
                assert torch.equal(v, b[part]["state"][i][k]), (part, i, k)
