"""The GRU generator's slice beyond the scan: the conditional WGAN-GP step
against the JAX package's, the cond_gru_sc09 preset, Config.validate
against the reference's, and the CLI (train, sample, export, serve) on
the CPU.

The steps start from a carried non-initial JAX state (weights and both
Adam states) and take the reference's draws, as tests/test_torch_train.py
does; tolerances are its own (f32, the same sums in another order):
metrics 1e-5 relative, parameters 1e-6 absolute, Adam moments 1e-4 of
each tensor's largest.
"""

import base64
import dataclasses
import io
import json
import threading
import urllib.request
import wave

import jax
import numpy as np
import pytest
import torch

import audiogan_tpu.models.wavegan as jwg
from audiogan_tpu.config import ModelCfg
from audiogan_tpu.config import get_preset as jax_get_preset
from audiogan_tpu.train.state import create_train_state as jcreate
from audiogan_tpu.train.step import build_train_step as jbuild_step
from audiogan_tpu_torch import config as tconfig
from audiogan_tpu_torch.config import Config, get_preset
from audiogan_tpu_torch.convert import params_from_jax
from audiogan_tpu_torch.train.step import build_train_step

from helpers_train import raw_batch, tiny_config
from test_torch_train import _flat, _port_state, _reference_draws


def _gru_train_cfg():
    """case_gru's generator (16 frames, hidden 16), conditional, with the
    fused critic views of the GRU preset."""
    base = tiny_config()
    return tiny_config(
        data=dataclasses.replace(base.data, num_classes=4),
        model=ModelCfg(generator="gru", model_dim=4, kernel_size=9,
                       gru_frame_size=64, gru_hidden=16, max_channels=16,
                       phase_shuffle=1),
        train=dataclasses.replace(base.train, fused_d_views=True))


def _jax_steps(cfg, n_steps):
    """n_steps + 1 JAX steps from a fresh state: returns the states after
    each (state[0] after the first), and for every later step its
    recorded shifts, its batch and its metrics."""
    rec = []
    orig = jwg.phase_shuffle

    def recording(h, key, rad, impl=None):
        sh = jax.random.randint(key, (h.shape[0],), -rad, rad + 1)
        jax.debug.callback(lambda v: rec.append(np.array(v)), sh,
                           ordered=True)
        return orig(h, key, rad, impl=impl)
    jwg.phase_shuffle = recording
    try:
        step = jax.jit(jbuild_step(cfg))
        state, _ = step(jcreate(cfg), *raw_batch(cfg, seed=1))
        jax.effects_barrier()
        states, runs = [state], []
        for i in range(n_steps):
            rec.clear()
            batch = raw_batch(cfg, seed=2 + i)
            state, metrics = step(state, *batch)
            jax.effects_barrier()
            states.append(state)
            runs.append((list(rec), batch, metrics))
    finally:
        jwg.phase_shuffle = orig
    return states, runs


@pytest.mark.parametrize("n_steps", [1, 2])
def test_gru_step_matches_jax(n_steps):
    cfg = _gru_train_cfg()
    states, runs = _jax_steps(cfg, n_steps)
    pcfg, st = _port_state(cfg, states[0])
    step = build_train_step(pcfg, device="cpu")
    for i, (shifts, (clips, labels), want) in enumerate(runs):
        draws = _reference_draws(cfg, states[i], shifts)
        got = step(st, torch.from_numpy(clips), torch.from_numpy(labels),
                   draws=draws)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i}: {k}")
    last = states[-1]
    assert st.step == int(last.step) == n_steps + 1
    for jtree, mod in ((last.params_g, st.g), (last.params_d, st.d)):
        ref, sd = params_from_jax(_flat(jtree)), mod.state_dict()
        assert set(ref) == set(sd)
        for n in ref:
            np.testing.assert_allclose(sd[n].numpy(), ref[n].numpy(),
                                       atol=1e-6, rtol=0, err_msg=n)
    for opt, mod, ost in ((st.opt_g, st.g, last.opt_g),
                          (st.opt_d, st.d, last.opt_d)):
        adam = ost[0]
        mu, nu = params_from_jax(_flat(adam.mu)), params_from_jax(
            _flat(adam.nu))
        for n, p in mod.named_parameters():
            s = opt.state[p]
            for got_m, ref_m in ((s["exp_avg"], mu[n]),
                                 (s["exp_avg_sq"], nu[n])):
                np.testing.assert_allclose(
                    got_m.numpy(), ref_m.numpy(), rtol=0,
                    atol=1e-4 * float(ref_m.abs().max()) + 1e-30,
                    err_msg=n)


def test_gru_preset_matches_jax():
    want = json.loads(jax_get_preset("cond_gru_sc09").to_json())
    assert json.loads(get_preset("cond_gru_sc09").to_json()) == want


def _replace(cfg, **parts):
    """cfg with fields of its sub-configs replaced, not validated:
    _replace(cfg, data={"store_len": 8000})."""
    return dataclasses.replace(cfg, **{
        part: dataclasses.replace(getattr(cfg, part), **fields)
        for part, fields in parts.items()})


def _gru_case():
    return tiny_config(model=ModelCfg(
        generator="gru", model_dim=4, kernel_size=9, gru_frame_size=64,
        gru_hidden=16, max_channels=16, phase_shuffle=1))


# every config the reference's validate rejects (audiogan_tpu/config.py
# Config.validate), each from a valid base
REJECTED = {
    "store_len_below_clip": lambda: _replace(
        jax_get_preset("tiny_sc09"), data={"store_len": 8000}),
    "shuffle_impl": lambda: _replace(jax_get_preset("tiny_sc09"),
                                     model={"shuffle_impl": "bogus"}),
    "fused_shuffle_sites": lambda: _replace(
        jax_get_preset("tiny_sc09"), model={"fused_shuffle_sites": -2}),
    "gru_clip_len": lambda: _replace(_gru_case(), data={"clip_len": 1000}),
    "wavegan_clip_len": lambda: _replace(tiny_config(),
                                         data={"clip_len": 1000}),
    "kernels": lambda: _replace(tiny_config(), train={"kernels": ""}),
    "kernels_g": lambda: _replace(tiny_config(), train={"kernels_g": "x"}),
    "kernels_d": lambda: _replace(tiny_config(), train={"kernels_d": "x"}),
    "kernels_ingest": lambda: _replace(tiny_config(),
                                       train={"kernels_ingest": "x"}),
    "device_corpus_shard": lambda: _replace(
        tiny_config(), data={"device_corpus_shard": "bogus"}),
    "index_chunk": lambda: _replace(tiny_config(), data={"index_chunk": -1}),
    "wgrad_form": lambda: _replace(tiny_config(),
                                   train={"wgrad_form": "bogus"}),
    "batch_dp": lambda: _replace(tiny_config(), mesh={"dp": 3}),
    "clip_cp": lambda: _replace(tiny_config(), mesh={"cp": 3}),
    "tp_with_cp": lambda: _replace(tiny_config(), mesh={"tp": 2, "cp": 2}),
    "tp_stft": lambda: _replace(tiny_config(), mesh={"tp": 2},
                                model={"use_stft_critic": True}),
    "tp_channels": lambda: _replace(tiny_config(), mesh={"tp": 3}),
    "cp_stft_frames": lambda: _replace(tiny_config(), mesh={"cp": 2},
                                       model={"use_stft_critic": True}),
    "cp_stft_loss_halo": lambda: _replace(tiny_config(), mesh={"cp": 2},
                                          loss={"stft_loss_weight": 1.0}),
    "cp_wavegan_base": lambda: _replace(jax_get_preset("tiny_sc09"),
                                        mesh={"cp": 32}),
    "cp_gru_frames": lambda: _replace(_gru_case(), mesh={"cp": 32}),
}


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_validate_rejects_what_the_reference_rejects(case):
    jcfg = REJECTED[case]()
    with pytest.raises(ValueError):
        jcfg.validate()
    with pytest.raises(ValueError):
        Config.from_json(jcfg.to_json()).validate()


def test_validate_runs_before_what_is_not_ported():
    """fused_shuffle_sites=-2 is a bad config (ValueError), not an
    unported feature (NotImplementedError), in the factory too; the STFT
    critic builds, as the dual discriminator; fused sites build."""
    from audiogan_tpu_torch.models import build_discriminator
    from audiogan_tpu_torch.models.stft_critic import DualDiscriminator
    cfg = Config.from_json(REJECTED["fused_shuffle_sites"]().to_json())
    with pytest.raises(ValueError, match="fused_shuffle_sites"):
        build_discriminator(cfg, device="cpu")
    d = build_discriminator(_replace(cfg, model={"fused_shuffle_sites": 0,
                                                 "use_stft_critic": True}),
                            device="cpu")
    assert isinstance(d, DualDiscriminator)
    for sites, n_fused in ((1, 1), (-1, len(cfg.model.strides) - 1)):
        d = build_discriminator(_replace(cfg, model={
            "fused_shuffle_sites": sites}), device="cpu")
        assert d.n_fused == n_fused


@pytest.fixture
def tiny_gru_preset(monkeypatch):
    """A CPU-sized conditional GRU preset for the CLI (10 classes, as the
    synthetic corpus has)."""
    jcfg = _replace(_gru_case(), data={"num_classes": 10})
    cfg = dataclasses.replace(Config.from_json(jcfg.to_json()),
                              name="tiny_gru").validate()
    monkeypatch.setitem(tconfig.PRESETS, "tiny_gru", lambda: cfg)
    return cfg


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


def test_cli_trains_the_gru_on_the_cpu(tmp_path, capsys, tiny_gru_preset):
    from audiogan_tpu_torch.cli import main
    assert main(["train", "--preset", "tiny_gru", "--device", "cpu",
                 "--steps", "2", "--batch_size", "2", "--log_every", "1",
                 "--workdir", str(tmp_path)]) == 0
    lines = _json_lines(capsys.readouterr().out)
    steps = [ln for ln in lines if "step" in ln]
    assert [ln["step"] for ln in steps] == [1, 2]
    for ln in steps:
        for k in ("d_loss", "w_dist", "gp", "gp_grad_norm", "g_loss"):
            assert np.isfinite(ln[k]), k
    init = [ln for ln in lines if "init" in ln][0]["init"]
    jax_g = jcreate(_replace(_gru_case(), data={"num_classes": 10})).params_g
    assert init["g_params"] == sum(
        x.size for x in jax.tree_util.tree_leaves(jax_g))


def test_cli_samples_the_gru_with_labels(tmp_path, capsys, tiny_gru_preset):
    from audiogan_tpu_torch.cli import main
    args = ["sample", "--preset", "tiny_gru", "--device", "cpu",
            "--init-seed", "0", "--seed", "4", "--labels", "1,7"]
    assert main(args + ["--out_dir", str(tmp_path / "a")]) == 0
    assert main(args + ["--out_dir", str(tmp_path / "b")]) == 0
    paths = capsys.readouterr().out.split()
    assert [p.rsplit("/", 1)[1] for p in paths[:2]] == \
        ["gen_seed4_0_y1.wav", "gen_seed4_1_y7.wav"]
    for name in ("gen_seed4_0_y1.wav", "gen_seed4_1_y7.wav"):
        a = (tmp_path / "a" / name).read_bytes()
        assert a == (tmp_path / "b" / name).read_bytes()
        with wave.open(io.BytesIO(a)) as f:
            assert f.getnframes() == tiny_gru_preset.data.clip_len


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_cli_exports_a_gru_artifact_that_serves_labels(tmp_path, capsys,
                                                        tiny_gru_preset):
    from audiogan_tpu_torch.cli import main
    from audiogan_tpu_torch.serve import load_sampler, make_server
    art = tmp_path / "art"
    assert main(["export", "--preset", "tiny_gru", "--device", "cpu",
                 "--init-seed", "0", "--num", "3",
                 "--out_dir", str(art)]) == 0
    meta = json.loads((art / "meta.json").read_text())
    assert meta["model"] == "tiny_gru" and meta["num_classes"] == 10
    sampler = load_sampler(art, device="cpu")
    srv = make_server(sampler, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d/generate" % srv.server_address[:2]
    try:
        a = _post(url, {"seed": 5, "num": 2, "labels": [3, 9]})
        b = _post(url, {"seed": 5, "num": 2, "labels": [3, 9]})
        c = _post(url, {"seed": 5, "num": 2, "labels": [4, 9]})
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    assert a == b and a["num"] == 2 and len(a["wavs"]) == 2
    assert a["wavs"][0] != c["wavs"][0]
    want = sampler.generate(5, np.array([3, 9, 0]))[:2]
    for b64, w in zip(a["wavs"], want):
        with wave.open(io.BytesIO(base64.b64decode(b64))) as f:
            pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
        np.testing.assert_array_equal(
            pcm, np.round(np.clip(w, -1, 1) * 32767).astype(np.int16))


def test_cli_serves_a_preset_with_labels(tmp_path):
    """`cli serve --preset cond_gru_sc09 --init-seed 0` exports in memory
    and answers a /generate that carries labels (full width, on the CPU,
    batch 2)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root, "TMPDIR": str(tmp_path)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "audiogan_tpu_torch.cli", "serve", "--preset",
         "cond_gru_sc09", "--init-seed", "0", "--num", "2", "--device",
         "cpu", "--port", "0"], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("[serve] cond_gru_sc09 on http://"), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        url = line.split(" on ", 1)[1].split()[0]
        a = _post(f"{url}/generate", {"seed": 3, "num": 2, "labels": [1, 8]})
        b = _post(f"{url}/generate", {"seed": 3, "num": 2, "labels": [1, 8]})
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    assert a == b and a["num"] == 2 and a["sample_rate"] == 16000
    for b64 in a["wavs"]:
        with wave.open(io.BytesIO(base64.b64decode(b64))) as f:
            assert f.getnframes() == 16384
    assert not list(tmp_path.iterdir())   # the in-memory export is gone
