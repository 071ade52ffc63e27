"""`cli bench` (audiogan_tpu_torch/bench.py), the port's counterpart of the
reference's headline harness (the root bench.py behind audiogan_tpu/cli.py's
``bench``), on the CPU at tests/helpers_train.py's tiny sizes and one
intra-op thread:

* ``default_sample_num`` against the root bench.py's for every preset;
* ``timed_rounds`` against the reference's own protocol: its bench_train
  run with its step stubbed out and a scripted clock, on round sequences
  that agree at once, agree late and never agree (the cap of 8);
* the CLI prints exactly one JSON line with exactly the reference's keys
  but the proxy fields, and ``device``; ``--kernels`` raises;
* the bench's staged step leaves the bits build_train_step leaves on the
  same batch, and its sampler gives build_sample_fn's batch for the same
  seed (its z) and labels;
* the preset as the bench runs it: ``train.dtype`` forced, the mesh cut
  to one device, nothing else changed.
The replayed step and sampler themselves run on the card (chip_smoke.py's
``bench`` phase, tests/test_torch_cuda.py -k "8192 or 4096")."""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import audiogan_tpu.train.step as jax_step
from audiogan_tpu.config import ModelCfg
from audiogan_tpu.config import get_preset as jax_get_preset
from audiogan_tpu_torch import bench
from audiogan_tpu_torch.cli import main as cli_main
from audiogan_tpu_torch.config import Config, get_preset
from audiogan_tpu_torch.models import build_generator
from audiogan_tpu_torch.models.init import init_params
from audiogan_tpu_torch.train.sample import build_sample_fn
from audiogan_tpu_torch.train.state import create_train_state, state_tensors
from audiogan_tpu_torch.train.step import build_train_step
from audiogan_tpu_torch.train.step_graph import differing

from helpers_train import raw_batch, tiny_config

ROOT = Path(__file__).resolve().parents[1]

# bench.py:208-233 without its proxy fields, and the port's device
LINE_KEYS = {"metric", "value", "unit", "rounds_steps_per_sec",
             "stabilize_rounds", "rounds_spread_pct", "audio_sec_per_sec",
             "sample_batch", "preset", "batch", "n_critic", "kernels",
             "kernels_g", "kernels_d", "dtype", "device"}


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def ref_bench():
    """The root bench.py, loaded from its file (it imports JAX only
    inside its functions)."""
    spec = importlib.util.spec_from_file_location("root_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiny_jax(conditional: bool = False):
    """The tiny WaveGAN, or a tiny class-conditional GRU generator."""
    if not conditional:
        return tiny_config()
    jcfg = tiny_config(model=ModelCfg(
        generator="gru", model_dim=4, kernel_size=9, gru_frame_size=64,
        gru_hidden=16, max_channels=16, phase_shuffle=1))
    return dataclasses.replace(jcfg, data=dataclasses.replace(
        jcfg.data, num_classes=4)).validate()


def _tiny(conditional: bool = False) -> Config:
    return Config.from_json(_tiny_jax(conditional).to_json()).validate()


@pytest.mark.parametrize("preset", bench.PRESETS)
def test_default_sample_num_is_the_references(ref_bench, preset):
    want = {"tiny_sc09": 16384, "resample_22k": 16384,
            "music_44k_dp16": 380}.get(preset, 4096)
    got = bench.default_sample_num(get_preset(preset))
    assert got == ref_bench.default_sample_num(jax_get_preset(preset)) \
        == want


def test_the_presets_are_the_references(ref_bench):
    assert bench.PRESETS == tuple(ref_bench.PRESETS)


class _Clock:
    """time's perf_counter and sleep for the reference's rounds: a round
    is two reads, the second ``next(durations)`` after the first."""

    def __init__(self, durations):
        self.t, self.durations, self.open = 0.0, iter(durations), False

    def perf_counter(self) -> float:
        if self.open:
            self.t += next(self.durations)
        self.open = not self.open
        return self.t

    def sleep(self, _s) -> None:
        pass


# round durations, dyadic so that every difference of clock readings is
# exact and a round's rate is 1 / duration in both protocols; the rounds
# each run, then the rounds left out
ROUNDS = {
    "agree_at_once": ([0.125] * 12, 4, 0),
    "agree_late": ([0.25, 0.125, 0.1875, 0.125, 0.126953125] + [0.125] * 7,
                   7, 3),
    "never_agree": ([0.125, 0.25] * 6, 10, 6),
}


@pytest.mark.parametrize("case", ROUNDS)
def test_timed_rounds_keep_the_references_rounds(ref_bench, monkeypatch,
                                                 case):
    """The reference's bench_train (its step stubbed, one step a round)
    on a scripted clock against ``timed_rounds`` on the same rates: the
    same rounds, kept rounds, median and spread."""
    import jax.numpy as jnp
    durations, n_rounds, left_out = ROUNDS[case]

    def stub(cfg):
        return lambda state, clips, labels: (state,
                                             {"d_loss": jnp.zeros(())})

    monkeypatch.setattr(jax_step, "build_train_step", stub)
    monkeypatch.setattr(ref_bench, "time", _Clock(durations))
    want = ref_bench.bench_train(tiny_config(), n_steps=1)
    rates = iter([1.0 / d for d in durations])
    got = bench.timed_rounds(lambda: next(rates), pause_s=0.0)
    assert got == want
    assert len(got[1]["rounds_steps_per_sec"]) == n_rounds
    assert got[1]["stabilize_rounds"] == left_out


def test_cli_bench_prints_one_line_with_the_references_keys(monkeypatch,
                                                            capsys):
    cfg = _tiny()
    monkeypatch.setattr(bench, "get_preset", lambda name: cfg)
    assert cli_main(["bench", "--preset", "wgan_gp_b64", "--steps", "1",
                     "--sample_batch", "2", "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == LINE_KEYS
    assert line["metric"] == "train_steps_per_sec" and line["value"] > 0
    assert line["audio_sec_per_sec"] > 0 and line["sample_batch"] == 2
    assert line["device"] == "cpu" and line["dtype"] == "bfloat16"
    assert line["kernels"] == line["kernels_g"] == line["kernels_d"] == \
        "plain"
    assert (line["preset"], line["batch"], line["n_critic"]) == \
        (cfg.name, cfg.train.batch_size, cfg.loss.n_critic)
    kept = line["rounds_steps_per_sec"][line["stabilize_rounds"]:]
    assert len(kept) >= 4
    summary = json.loads(err.splitlines()[-1])
    assert summary["train"]["route"] == summary["sample"]["route"] == "eager"


@pytest.mark.parametrize("kernels", ["xla", "pallas", "auto", "mixed"])
def test_cli_bench_kernels_raises(kernels):
    """The port has one route: a tier raises before anything runs, with or
    without a card."""
    for device in ([], ["--device", "cpu"]):
        with pytest.raises(ValueError, match="one route"):
            cli_main(["bench", "--kernels", kernels, *device])
    with pytest.raises(ValueError, match="one route"):
        bench.main(["--kernels", kernels, "--device", "cpu"])


def test_staged_steps_leave_build_train_steps_bits():
    """Three steps of the bench's staged step (eager on the CPU) against
    build_train_step called directly on the same staged batch from the
    same fresh state: parameters, Adam's moments and the last metrics to
    the bit."""
    cfg = _tiny()
    staged = bench.StagedStep(cfg, "cpu")
    for _ in range(3):
        got_m = {k: v.clone() for k, v in staged().items()}
    state = create_train_state(cfg, device="cpu")
    step_fn = build_train_step(cfg, "cpu")
    clips, labels = bench.staged_batch(cfg, "cpu")
    for _ in range(3):
        want_m = step_fn(state, clips, labels)
    assert staged.state.step == state.step == 3
    assert staged.route == "eager"
    assert not differing(state_tensors(staged.state), state_tensors(state))
    assert not differing(got_m, want_m)


def test_staged_batch_is_the_references():
    """The bench's staged clips and labels are the reference's draw
    (helpers_train.raw_batch is bench.py:71-80's) for a conditional
    config."""
    clips, labels = bench.staged_batch(_tiny(conditional=True), "cpu")
    want_clips, want_labels = raw_batch(_tiny_jax(conditional=True), seed=0)
    assert clips.dtype == torch.int16 and labels.dtype == torch.int32
    np.testing.assert_array_equal(clips.numpy(), want_clips)
    np.testing.assert_array_equal(labels.numpy(), want_labels)
    assert labels.numpy().max() > 0


@pytest.mark.parametrize("conditional", [False, True])
def test_bench_sampler_equals_build_sample_fn(conditional):
    """The bench's sampler (SampleGraph's body, eager on the CPU) against
    build_sample_fn for the same weights, seed (so z) and labels, over
    two seeds: the labels stay in their buffer after the first batch."""
    cfg = _tiny(conditional)
    num = 6
    params = bench.generator_params(cfg, "cpu")
    want_params = init_params(build_generator(cfg, device="cpu"),
                              cfg.train.seed).state_dict()
    assert not differing(params, want_params)
    labels = bench.sample_labels(cfg, num)
    if conditional:
        np.testing.assert_array_equal(labels, np.arange(num) % 4)
    else:
        assert labels is None
    sampler = bench.BenchSampler(cfg, params, num, "cpu", labels)
    fn = build_sample_fn(cfg, "cpu")
    for seed in (100, 101):
        got = sampler(seed)
        want = fn(params, seed, None if labels is None
                  else torch.from_numpy(labels), num=num)
        assert got.shape == (num, cfg.data.clip_len)
        assert torch.equal(got, want)
    assert sampler.summary()["route"] == "eager"


@pytest.mark.parametrize("preset", bench.PRESETS)
def test_bench_config_forces_the_dtype_and_one_device(preset):
    base = get_preset(preset)
    for dtype in ("bfloat16", "float32"):
        cfg = bench.bench_config(preset, dtype)
        assert cfg.train.dtype == dtype
        assert (cfg.mesh.dp, cfg.mesh.cp, cfg.mesh.tp) == (1, 1, 1)
        rest = dataclasses.replace(cfg, train=base.train, mesh=base.mesh)
        assert rest == base
        assert dataclasses.replace(cfg.train, dtype=base.train.dtype) == \
            base.train
    if preset == "resample_22k":
        assert base.train.dtype == "float32"
        assert bench.bench_config(preset).train.dtype == "bfloat16"
    if preset == "music_44k_dp16":
        assert base.mesh.dp == 16
