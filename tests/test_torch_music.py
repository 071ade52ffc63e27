"""audiogan_tpu_torch at the music geometry (music_44k_dp16's strides
7/7/5/5/3, k=25, scaled tiny as helpers_golden.case_music: 14700-sample
clips at 44.1 kHz) against the JAX package: the generator on carried
weights and against the golden ``tests/golden/data/music.npy``, and the
critic against flax with the flax-drawn shuffle shifts injected. The
training step at this geometry is test_torch_train.py's ``music``
variant.

Tolerances (f32, the same sums in another order): 1e-5 absolute and 1e-4
relative against the golden (test_golden.py's own), 1e-5 of the largest
score against flax; bf16 5e-2 of the largest score (the two frameworks
round at other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import audiogan_tpu.models.wavegan as jwg
from audiogan_tpu.models import build_discriminator as jbuild_d
from audiogan_tpu.models import build_generator as jbuild_g
from audiogan_tpu.train.state import create_train_state
from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.convert import params_from_jax
from audiogan_tpu_torch.models import build_discriminator, build_generator
from audiogan_tpu_torch.train.sample import generate

from helpers_golden import case_music

torch.set_num_threads(1)

GOLDEN = __import__("pathlib").Path(__file__).parent / "golden" / "data"


def _port(cfg) -> Config:
    return Config.from_json(cfg.to_json()).validate()


def _carried_g(cfg):
    params_g = create_train_state(cfg, seed=0).params_g
    flat = {k: np.asarray(v) for k, v in flatten_dict(params_g,
                                                      sep="/").items()}
    return params_g, params_from_jax(flat)


def test_generate_matches_the_music_golden():
    """The port's sampler on JAX's weights and z draw reproduces
    music.npy (test_golden.py's case_music)."""
    cfg = case_music()
    _, sd = _carried_g(cfg)
    z = np.asarray(jax.random.normal(jax.random.key(123),
                                     (2, cfg.model.latent_dim)))
    got = generate(_port(cfg), sd, num=2, seed=123, device="cpu", z=z)
    assert got.shape == (2, 14700)
    np.testing.assert_allclose(got, np.load(GOLDEN / "music.npy"),
                               atol=1e-5, rtol=1e-4)


def test_generator_matches_jax_at_the_music_geometry():
    cfg = case_music()
    params_g, sd = _carried_g(cfg)
    z = np.random.default_rng(1).standard_normal(
        (3, cfg.model.latent_dim)).astype(np.float32)
    want = np.asarray(jbuild_g(cfg).apply(params_g, jnp.asarray(z)))
    g = build_generator(_port(cfg), device="cpu")
    g.load_state_dict(sd)
    with torch.no_grad():
        got = g(torch.from_numpy(z))
    assert got.shape == want.shape == (3, 14700, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)


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


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5),
                                       ("bfloat16", 5e-2)])
def test_critic_matches_flax_at_the_music_geometry(recorded_shifts, dtype,
                                                   rel):
    """Scores of 3 clips with the shifts flax drew (sites at T = 2100,
    300, 60, 12: rad 2 against strides 7, 5, 5, 3), and the eval form."""
    import dataclasses
    cfg = case_music()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             dtype=dtype))
    jd = jbuild_d(cfg)
    x0 = jnp.zeros((2, cfg.data.clip_len, 1))
    params = jd.init({"params": jax.random.key(3),
                      "phase_shuffle": jax.random.key(1)}, x0)
    td = build_discriminator(_port(cfg), device="cpu")
    td.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}))
    recorded_shifts.clear()
    x = np.random.default_rng(2).uniform(
        -1, 1, (3, cfg.data.clip_len, 1)).astype(np.float32)
    want = np.asarray(jd.apply(params, jnp.asarray(x), train=True,
                               rngs={"phase_shuffle": jax.random.key(5)}))
    jax.effects_barrier()
    shifts = torch.from_numpy(np.stack(recorded_shifts))
    assert shifts.shape == (4, 3)
    with torch.no_grad():
        got = td(torch.from_numpy(x), None, shifts).numpy()
        got_eval = td(torch.from_numpy(x)).numpy()
    want_eval = np.asarray(jd.apply(params, jnp.asarray(x), train=False))
    for g, w in ((got, want), (got_eval, want_eval)):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rel * np.abs(w).max())
