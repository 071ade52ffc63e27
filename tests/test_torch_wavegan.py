"""audiogan_tpu_torch's WaveGAN generator against the JAX package's.

Weights cross over with convert.params_from_jax from
create_train_state(...).params_g; z comes from numpy or from JAX's own draw,
so both packages see the same inputs. The goldens are read, never written.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from audiogan_tpu.config import PRESETS as JAX_PRESETS
from audiogan_tpu.models import build_generator as jax_build_generator
from audiogan_tpu.ops.mulaw import mu_law_compand as jax_compand
from audiogan_tpu.ops.mulaw import mu_law_expand as jax_expand
from audiogan_tpu.train.state import create_train_state
from audiogan_tpu_torch.config import Config, get_preset
from audiogan_tpu_torch.convert import params_from_jax
from audiogan_tpu_torch.models import build_generator
from audiogan_tpu_torch.models.init import init_params
from audiogan_tpu_torch.ops.mulaw import mu_law_compand, mu_law_expand
from audiogan_tpu_torch.train.sample import build_sample_fn, generate

from helpers_golden import case_conditional, case_wavegan
from helpers_train import tiny_config

GOLDEN_DIR = Path(__file__).parent / "golden" / "data"


def port_config(jax_cfg) -> Config:
    return Config.from_json(jax_cfg.to_json()).validate()


def converted_params(jax_cfg, seed=0):
    params_g = create_train_state(jax_cfg, seed=seed).params_g
    flat = {k: np.asarray(v)
            for k, v in flatten_dict(params_g, sep="/").items()}
    return params_g, params_from_jax(flat)


@pytest.mark.parametrize("num_classes", [0, 4])
def test_generator_matches_jax(num_classes):
    cfg = tiny_config()
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, num_classes=num_classes))
    params_g, sd = converted_params(cfg)
    rng = np.random.default_rng(0)
    z = rng.standard_normal((3, cfg.model.latent_dim)).astype(np.float32)
    labels = np.array([0, 3, 1], np.int32) if num_classes else None

    jg = jax_build_generator(cfg)
    args = (jnp.asarray(z),) + ((jnp.asarray(labels),) if num_classes else ())
    want = np.asarray(jg.apply(params_g, *args))

    g = build_generator(port_config(cfg), device="cpu")
    g.load_state_dict(sd)             # strict: every name must line up
    with torch.no_grad():
        got = g(torch.from_numpy(z),
                None if labels is None else torch.from_numpy(labels).long())
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("name,case", [("wavegan", case_wavegan),
                                       ("conditional", case_conditional)])
def test_generate_matches_golden(name, case):
    """The port's sampler on JAX's z draw reproduces the JAX goldens."""
    cfg = case()
    _, sd = converted_params(cfg, seed=0)
    labels = np.array([0, 7], np.int32) if cfg.data.num_classes else None
    z = np.asarray(jax.random.normal(jax.random.key(123),
                                     (2, cfg.model.latent_dim)))
    got = generate(port_config(cfg), sd, num=2, seed=123, labels=labels,
                   device="cpu", z=z)
    golden = np.load(GOLDEN_DIR / f"{name}.npy")
    np.testing.assert_allclose(got, golden, atol=1e-5, rtol=1e-4)


def test_sample_deterministic_and_seed_sensitive():
    cfg = port_config(tiny_config())
    g = init_params(build_generator(cfg, device="cpu"), seed=0)
    sd = g.state_dict()
    fn = build_sample_fn(cfg, "cpu")
    a, b, c = (fn(sd, s, num=2) for s in (5, 5, 6))
    assert a.shape == (2, cfg.data.clip_len)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_conditional_sample_draws_labels_from_seed():
    cfg = port_config(case_conditional())
    g = init_params(build_generator(cfg, device="cpu"), seed=0)
    sd = g.state_dict()
    fn = build_sample_fn(cfg, "cpu")
    assert torch.equal(fn(sd, 9, num=3), fn(sd, 9, num=3))


def test_init_is_seeded_glorot_with_zero_bias():
    cfg = port_config(tiny_config())
    a = init_params(build_generator(cfg, device="cpu"), seed=0).state_dict()
    b = init_params(build_generator(cfg, device="cpu"), seed=0).state_dict()
    c = init_params(build_generator(cfg, device="cpu"), seed=1).state_dict()
    for name, t in a.items():
        assert torch.equal(t, b[name]), name
        if name.endswith("bias"):
            assert not t.any(), name
            continue
        assert not torch.equal(t, c[name]), name
        rf = int(np.prod(t.shape[:-2]))
        limit = np.sqrt(6.0 / (rf * (t.shape[-2] + t.shape[-1])))
        assert float(t.abs().max()) <= limit
        assert float(t.abs().max()) > 0.5 * limit
    # same names and shapes as the flax params
    _, sd = converted_params(tiny_config())
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in a.items()}


def test_factory_rejects_gru():
    """The factory builds the GRU generator and rejects, as the reference's
    validate does, a GRU whose clip is not a whole number of frames."""
    from audiogan_tpu_torch.models.gru import GRUGenerator
    cfg = port_config(tiny_config())
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, generator="gru"))
    assert isinstance(build_generator(cfg, device="cpu"), GRUGenerator)
    bad = cfg.replace(model=dataclasses.replace(cfg.model,
                                                gru_frame_size=100))
    with pytest.raises(ValueError, match="gru_frame_size"):
        build_generator(bad, device="cpu")


def test_mulaw_matches_jax():
    x = np.linspace(-1, 1, 1001, dtype=np.float32)
    np.testing.assert_allclose(
        mu_law_compand(torch.from_numpy(x)).numpy(),
        np.asarray(jax_compand(jnp.asarray(x))), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        mu_law_expand(torch.from_numpy(x)).numpy(),
        np.asarray(jax_expand(jnp.asarray(x))), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", sorted(JAX_PRESETS))
def test_presets_match_jax(name):
    """Every preset of the reference, in JSON (a preset the port lacks
    fails here)."""
    from audiogan_tpu.config import get_preset as jax_get_preset
    want = json.loads(jax_get_preset(name).to_json())
    assert json.loads(get_preset(name).to_json()) == want
    assert json.loads(Config.from_json(json.dumps(want)).to_json()) == want


def test_validate_rejects_bad_config():
    cfg = get_preset("tiny_sc09")
    with pytest.raises(ValueError, match="divisible"):
        cfg.replace(data=dataclasses.replace(cfg.data,
                                             clip_len=1000)).validate()
    with pytest.raises(ValueError, match="dtype"):
        cfg.replace(train=dataclasses.replace(cfg.train,
                                              dtype="float16")).validate()
