"""The port's `info`, `--config` and `build-corpus` against the JAX CLI's
(audiogan_tpu/cli.py): the same printed config for every preset the port
has, and the same packed corpus files from one wav tree."""

import json

import numpy as np
import pytest

from audiogan_tpu.cli import main as jmain
from audiogan_tpu.data.synthetic import make_synthetic_sc09 as jsynth
from audiogan_tpu_torch.cli import main
from audiogan_tpu_torch.config import PRESETS, Config

from helpers_train import tiny_config


@pytest.fixture(autouse=True)
def _no_xla_cache(monkeypatch):
    """The JAX CLI links its compile cache at start-up; not here."""
    monkeypatch.setenv("AUDIOGAN_XLA_CACHE", "")


def _printed(fn, argv, capsys) -> str:
    assert fn(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_info_prints_the_reference_config(preset, capsys):
    want = _printed(jmain, ["info", "--preset", preset], capsys)
    assert _printed(main, ["info", "--preset", preset], capsys) == want
    assert json.loads(want)["name"] == preset


def test_info_takes_a_config_file_and_sets(tmp_path, capsys):
    path = tmp_path / "config.json"
    path.write_text(tiny_config().to_json())
    argv = ["info", "--preset", "wgan_gp_b64", "--config", str(path),
            "--set", "train.batch_size=2", "--set",
            "model.stft_resolutions=[[128, 32, 128]]"]
    want = _printed(jmain, argv, capsys)
    assert _printed(main, argv, capsys) == want
    cfg = Config.from_json(want)
    assert cfg.name == "test_tiny" and cfg.train.batch_size == 2
    assert cfg.model.stft_resolutions == ((128, 32, 128),)


def test_train_takes_a_config_file(tmp_path, capsys):
    path = tmp_path / "config.json"
    path.write_text(tiny_config().to_json())
    work = tmp_path / "run"
    assert main(["train", "--config", str(path), "--device", "cpu",
                 "--total_steps", "1", "--batch_size", "2",
                 "--no_tensorboard", "--workdir", str(work)]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"step"')]
    assert [ln["step"] for ln in lines] == [1]
    saved = Config.from_json((work / "config.json").read_text())
    assert saved.name == "test_tiny" and saved.train.batch_size == 2


def test_build_corpus_writes_the_reference_files(tmp_path, capsys):
    jsynth(tmp_path / "wavs", n_per_class=2, num_classes=3, clip_len=1200)
    outs = {}
    for name, fn in (("jax", jmain), ("torch", main)):
        out = tmp_path / name
        printed = _printed(fn, ["build-corpus", "--wav_dir",
                                str(tmp_path / "wavs"), "--out_dir",
                                str(out), "--store_len", "1280"], capsys)
        assert printed.strip() == str(out)
        outs[name] = out
    for f in ("clips.npy", "labels.npy", "meta.json"):
        assert (outs["torch"] / f).read_bytes() == \
            (outs["jax"] / f).read_bytes(), f
    assert np.load(outs["torch"] / "clips.npy").shape == (6, 1280)


def test_sample_and_export_take_the_dual_preset(tmp_path, capsys):
    """dual_stft's G is the flagship's WaveGAN G: `sample` and `export`
    build it from the preset at full width."""
    assert main(["sample", "--preset", "dual_stft", "--init-seed", "0",
                 "--num", "1", "--seed", "0", "--device", "cpu",
                 "--out_dir", str(tmp_path / "wavs")]) == 0
    assert [p.name for p in (tmp_path / "wavs").glob("*.wav")] == \
        ["gen_seed0_0.wav"]
    assert main(["export", "--preset", "dual_stft", "--init-seed", "0",
                 "--num", "1", "--device", "cpu",
                 "--out_dir", str(tmp_path / "art")]) == 0
    meta = json.loads((tmp_path / "art" / "meta.json").read_text())
    assert meta["model"] == "dual_stft"
    assert meta["config"]["model"]["use_stft_critic"]
