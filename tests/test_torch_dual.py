"""audiogan_tpu_torch's STFT critic, dual discriminator, dual_stft training
step, evaluation and `cli eval` against the JAX package's.

Weights cross over with convert.params_from_jax; the wave critic's
phase-shuffle shifts are recorded from the flax critic (a test-only
wrapper around audiogan_tpu.models.wavegan.phase_shuffle, as in
test_torch_critic.py) and injected into the port. Geometries: T=1024
with the resolution (128, 32, 128) gives 32 frames and 65 bins, even and
odd at every layer (32 -> 2, 65 -> 5); T=960 with (130, 64, 128) gives
15 frames and 66 bins, which turn odd and even (15 -> 8 -> 4 -> 2 -> 1,
66 -> 33 -> 17 -> 9 -> 5). Tolerances: f32 values and gradients 1e-5
relative to the largest (the same sums in another order); bf16 scores
5e-2 of the largest (the two frameworks round at other places, four conv
layers and the head each round once); evaluate 1e-4 relative.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import audiogan_tpu.models.wavegan as jwg
from audiogan_tpu.config import LossCfg, ModelCfg
from audiogan_tpu.data.corpus import Corpus as JCorpus
from audiogan_tpu.data.corpus import HostBatcher
from audiogan_tpu.data.corpus import build_corpus as jbuild_corpus
from audiogan_tpu.data.synthetic import make_synthetic_sc09 as jsynth
from audiogan_tpu.losses import gradient_penalty as jgp
from audiogan_tpu.models import build_discriminator as jbuild_d
from audiogan_tpu.models import build_generator as jbuild_g
from audiogan_tpu.models.stft_critic import STFTCritic as JSTFTCritic
from audiogan_tpu.train.evaluate import evaluate as jevaluate
from audiogan_tpu.train.step import num_views as jnum_views
from audiogan_tpu_torch import config as tconfig
from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.convert import params_from_jax
from audiogan_tpu_torch.data.corpus import Corpus, batch_indices
from audiogan_tpu_torch.losses import gradient_penalty
from audiogan_tpu_torch.models import build_discriminator
from audiogan_tpu_torch.models.stft_critic import (DualDiscriminator,
                                                   STFTCritic, same_pads)
from audiogan_tpu_torch.train.evaluate import evaluate
from audiogan_tpu_torch.train.step import num_views

from helpers_train import tiny_config

REL, BF16_REL, EVAL_REL = 1e-5, 5e-2, 1e-4
GEOMETRIES = {"even": (1024, (128, 32, 128)), "odd": (960, (130, 64, 128))}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_dict(params,
                                                      sep="/").items()}


@pytest.fixture
def recorded_shifts(monkeypatch):
    rec = []
    orig = jwg.phase_shuffle

    def recording(h, key, rad, impl=None):
        sh = jax.random.randint(key, (h.shape[0],), -rad, rad + 1)
        jax.debug.callback(lambda v: rec.append(np.array(v)), sh,
                           ordered=True)
        return orig(h, key, rad, impl=impl)
    monkeypatch.setattr(jwg, "phase_shuffle", recording)
    return rec


def _dual_cfg(clip_len=1024, res=(128, 32, 128), num_classes=0,
              dtype="float32", stft_w=1.0, fused_views=False):
    base = tiny_config()
    return tiny_config(
        data=dataclasses.replace(base.data, clip_len=clip_len,
                                 store_len=clip_len + 256,
                                 num_classes=num_classes),
        model=dataclasses.replace(base.model, use_stft_critic=True,
                                  stft_resolutions=(res,)),
        loss=LossCfg(n_critic=2, stft_loss_weight=stft_w),
        train=dataclasses.replace(base.train, dtype=dtype,
                                  fused_d_views=fused_views))


def _waves(b, t, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (b, t, 1)).astype(np.float32)


def _stft_pair(geometry, num_classes, dtype):
    t, (n_fft, hop, win) = GEOMETRIES[geometry]
    jd = JSTFTCritic(n_fft=n_fft, hop=hop, win_len=win, model_dim=16,
                     num_classes=num_classes,
                     dtype=jnp.bfloat16 if dtype == "bfloat16"
                     else jnp.float32)
    x = jnp.zeros((2, t, 1))
    args = (x, jnp.zeros((2,), jnp.int32)) if num_classes else (x,)
    params = jd.init(jax.random.key(3), *args)
    td = STFTCritic(t, n_fft, hop, win, model_dim=16,
                    num_classes=num_classes,
                    dtype=getattr(torch, dtype))
    td.load_state_dict(params_from_jax(_flat(params)))
    return jd, params, td, t


@pytest.mark.parametrize("n", [32, 16, 8, 4, 2, 15, 65, 33, 17, 9, 66, 1])
def test_same_pads_match_flax(n):
    """lax's SAME rule, as flax's nn.Conv applies it at stride 2."""
    want = jax.lax.padtype_to_pads((n,), (5,), (2,), "SAME")[0]
    assert same_pads(n) == tuple(want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_classes", [0, 4])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_stft_critic_matches_flax(geometry, num_classes, dtype):
    jd, params, td, t = _stft_pair(geometry, num_classes, dtype)
    names = {k.removeprefix("params/").replace("/", ".")
             for k in _flat(params)}
    assert names == set(td.state_dict())
    for k, v in _flat(params).items():
        assert tuple(td.state_dict()[k.removeprefix("params/").replace(
            "/", ".")].shape) == v.shape
    x = _waves(3, t, seed=1)
    lab = np.array([0, 3, 1], np.int32)
    jargs = (jnp.asarray(x), jnp.asarray(lab)) if num_classes else (
        jnp.asarray(x),)
    want = jd.apply(params, *jargs)
    got = td(torch.from_numpy(x),
             torch.from_numpy(lab).long() if num_classes else None)
    assert got.dtype == torch.float32 and got.shape == (3,)
    _close(got, want, REL if dtype == "float32" else BF16_REL)


def test_stft_critic_rejects_a_clip_off_the_hop():
    with pytest.raises(ValueError, match="hop"):
        STFTCritic(1000, 128, 32, 128)


def _dual_pair(cfg, seed=0):
    jd = jbuild_d(cfg)
    x = jnp.zeros((2, cfg.data.clip_len, 1))
    lab = jnp.zeros((2,), jnp.int32) if cfg.data.num_classes else None
    args = (x, lab) if cfg.data.num_classes else (x,)
    params = jd.init({"params": jax.random.key(seed),
                      "phase_shuffle": jax.random.key(1)}, *args)
    td = build_discriminator(Config.from_json(cfg.to_json()), device="cpu")
    assert isinstance(td, DualDiscriminator)
    td.load_state_dict(params_from_jax(_flat(params)))
    return jd, params, td


@pytest.mark.parametrize("num_classes", [0, 4])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_dual_discriminator_matches_flax(geometry, num_classes,
                                         recorded_shifts):
    t, res = GEOMETRIES[geometry]
    cfg = _dual_cfg(t, res, num_classes)
    jd, params, td = _dual_pair(cfg)
    assert {k.removeprefix("params/").replace("/", ".")
            for k in _flat(params)} == set(td.state_dict())
    recorded_shifts.clear()
    x = _waves(3, t, seed=2)
    lab = np.array([0, 3, 1], np.int32)
    jargs = (jnp.asarray(x), jnp.asarray(lab)) if num_classes else (
        jnp.asarray(x),)
    want = jd.apply(params, *jargs, train=True,
                    rngs={"phase_shuffle": jax.random.key(5)})
    jax.effects_barrier()
    shifts = torch.from_numpy(np.stack(recorded_shifts))
    lab_t = torch.from_numpy(lab).long() if num_classes else None
    _close(td(torch.from_numpy(x), lab_t, shifts), want)
    _close(td(torch.from_numpy(x), lab_t),
           jd.apply(params, *jargs, train=False))


def test_bf16_dual_discriminator_close_to_flax(recorded_shifts):
    cfg = _dual_cfg(dtype="bfloat16")
    jd, params, td = _dual_pair(cfg)
    recorded_shifts.clear()
    x = _waves(3, cfg.data.clip_len, seed=2)
    want = jd.apply(params, jnp.asarray(x), train=True,
                    rngs={"phase_shuffle": jax.random.key(5)})
    jax.effects_barrier()
    got = td(torch.from_numpy(x), None,
             torch.from_numpy(np.stack(recorded_shifts)))
    _close(got, want, BF16_REL)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_dual_penalty_and_its_gradient_match_jax(geometry, recorded_shifts):
    """The penalty differentiates the dual score (through the framing,
    sqrt(power + eps), log1p and the conv2d stack) with respect to x-hat,
    then its norm with respect to every parameter."""
    t, res = GEOMETRIES[geometry]
    cfg = _dual_cfg(t, res)
    jd, params, td = _dual_pair(cfg, seed=3)
    recorded_shifts.clear()
    real, fake = _waves(4, t, seed=4), _waves(4, t, seed=5) * 0.5
    key_eps, key_shuf = jax.random.key(8), jax.random.key(9)

    def jloss(p):
        return jgp(lambda v: jd.apply(p, v, train=True,
                                      rngs={"phase_shuffle": key_shuf}),
                   jnp.asarray(real), jnp.asarray(fake), key_eps)

    (jval, jnorm), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    jax.effects_barrier()
    eps = np.array(jax.random.uniform(key_eps, (4, 1, 1))).reshape(4)
    shifts = torch.from_numpy(np.stack(recorded_shifts[:2]))
    gp, gnorm = gradient_penalty([lambda v: td(v, None, shifts)],
                                 torch.from_numpy(real),
                                 torch.from_numpy(fake),
                                 torch.from_numpy(eps))
    _close(gp, jval)
    _close(gnorm, jnorm)
    names = [n for n, _ in td.named_parameters()]
    # the biases reach the input gradient only through the activation
    # pattern, so their gradient is zero (unused in the graph)
    grads = torch.autograd.grad(gp, list(td.parameters()), allow_unused=True,
                                materialize_grads=True)
    want = params_from_jax(_flat(jgrads))
    for n, g in zip(names, grads):
        _close(g, want[n].numpy())
        if n.startswith("stft_critic.conv2d_") and n.endswith("kernel"):
            assert float(g.abs().sum()) > 0, n


def test_num_views_and_index_stream_match_jax(tmp_path):
    cfg = _dual_cfg()
    pcfg = Config.from_json(cfg.to_json())
    assert num_views(pcfg) == jnum_views(cfg) == cfg.loss.n_critic + 1
    assert num_views(pcfg.replace(loss=dataclasses.replace(
        pcfg.loss, stft_loss_weight=0.0))) == cfg.loss.n_critic
    jsynth(tmp_path / "w", n_per_class=2, num_classes=3, clip_len=1200)
    jbuild_corpus(tmp_path / "w", tmp_path / "c", store_len=1280)
    hb = HostBatcher(JCorpus(tmp_path / "c"), batch_size=4,
                     n_views=jnum_views(cfg), seed=7)
    for step in (0, 3):
        clips, _ = hb.get(step)
        idx = batch_indices(len(Corpus(tmp_path / "c")), 4, num_views(pcfg),
                            7, step)
        assert idx.shape == (3, 4)
        assert np.array_equal(hb._indices(step), idx)
        assert np.array_equal(clips, Corpus(tmp_path / "c").clips[idx])


def test_dual_stft_preset_matches_the_reference():
    from audiogan_tpu.config import get_preset as jget_preset
    want = jget_preset("dual_stft")
    got = tconfig.get_preset("dual_stft")
    assert got.to_json() == want.to_json()
    d = build_discriminator(got, device="meta")
    assert isinstance(d, DualDiscriminator)
    assert d.stft_critic.head.kernel.shape == (8 * 17 * 256, 1)


@pytest.mark.parametrize("num_classes", [0, 10])
def test_evaluate_matches_jax(tmp_path, num_classes):
    cfg = tiny_config(
        data=dataclasses.replace(tiny_config().data,
                                 num_classes=num_classes),
        model=ModelCfg(generator="wavegan", model_dim=4, kernel_size=9,
                       strides=(4, 4, 4), max_channels=16, phase_shuffle=1,
                       stft_resolutions=((128, 32, 128), (256, 64, 256))))
    jsynth(tmp_path / "w", n_per_class=2, num_classes=10, clip_len=1200)
    jbuild_corpus(tmp_path / "w", tmp_path / "c", store_len=1280)
    jg = jbuild_g(cfg)
    z0 = jnp.zeros((1, cfg.model.latent_dim))
    params = jg.init(jax.random.key(0), z0, jnp.zeros((1,), jnp.int32)) \
        if num_classes else jg.init(jax.random.key(0), z0)
    num, seed = 6, 3
    want = jevaluate(cfg, params, JCorpus(tmp_path / "c"), num=num,
                     seed=seed)
    key = jax.random.key(seed)
    z = np.asarray(jax.random.normal(key, (num, cfg.model.latent_dim)))
    labels = (np.asarray(jax.random.randint(jax.random.fold_in(key, 1),
                                            (num,), 0, num_classes))
              if num_classes else None)
    got = evaluate(Config.from_json(cfg.to_json()),
                   params_from_jax(_flat(params)), Corpus(tmp_path / "c"),
                   num=num, seed=seed, z=z, labels=labels, device="cpu")
    assert list(got) == list(want)
    for k in want:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=EVAL_REL,
                                   atol=1e-6, err_msg=k)


@pytest.fixture
def tiny_dual_preset(monkeypatch):
    """A CPU-sized dual preset for the CLI."""
    cfg = dataclasses.replace(Config.from_json(_dual_cfg().to_json()),
                              name="tiny_dual").validate()
    monkeypatch.setitem(tconfig.PRESETS, "tiny_dual", lambda: cfg)
    return cfg


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_cli_train_then_eval_on_the_cpu(tmp_path, capsys, tiny_dual_preset):
    from audiogan_tpu_torch.cli import main
    assert main(["train", "--preset", "tiny_dual", "--device", "cpu",
                 "--total_steps", "2", "--batch_size", "2",
                 "--log_every", "1", "--no_tensorboard",
                 "--workdir", str(tmp_path)]) == 0
    steps = [ln for ln in _json_lines(capsys.readouterr().out)
             if "step" in ln]
    assert [ln["step"] for ln in steps] == [1, 2]
    for ln in steps:
        assert np.isfinite(ln["stft_loss"]) and ln["stft_loss"] > 0
    evals = []
    for _ in range(2):
        assert main(["eval", "--workdir", str(tmp_path), "--device", "cpu",
                     "--num", "4", "--seed", "1"]) == 0
        evals.append(_json_lines(capsys.readouterr().out))
    assert evals[0] == evals[1] and len(evals[0]) == 1
    out = evals[0][0]
    assert out["step"] == 2
    assert set(out) == {"spectral_distance", "rms", "zcr", "peak",
                        "rms_real", "zcr_real", "peak_real", "step"}
    assert all(np.isfinite(v) for v in out.values())
    assert main(["eval", "--workdir", str(tmp_path), "--device", "cpu",
                 "--num", "4", "--step", "2"]) == 0
    assert _json_lines(capsys.readouterr().out)[0]["step"] == 2


def test_dual_entry_points_raise_without_a_card(tmp_path):
    """dual_stft's entry points, evaluate and `cli eval` resolve the card
    and raise without one: no silent CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from audiogan_tpu_torch.cli import main
    from audiogan_tpu_torch.train.state import create_train_state
    from audiogan_tpu_torch.train.step import build_train_step
    cfg = tconfig.get_preset("dual_stft")
    for call in (lambda: build_train_step(cfg),
                 lambda: create_train_state(cfg),
                 lambda: evaluate(cfg, {}, None),
                 lambda: main(["eval", "--workdir", str(tmp_path)]),
                 lambda: main(["train", "--preset", "dual_stft", "--steps",
                               "1", "--workdir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
