"""audiogan_tpu_torch's WaveGAN critic and gradient penalty against the JAX
package's.

Weights cross over with convert.params_from_jax; the phase-shuffle shifts
the flax critic draws are recorded (a test-only wrapper around
audiogan_tpu.models.wavegan.phase_shuffle that reports its
jax.random.randint draw through an ordered jax.debug.callback, then calls
the original) and injected into the port. The penalty is compared with
its first-order (the per-example input-gradient norms) and second-order
(its gradient with respect to the critic's parameters) derivatives.
Tolerance in f32: 1e-5 relative to the largest value (the same sums in
another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import audiogan_tpu.models.wavegan as jwg
from audiogan_tpu.losses import gradient_penalty as jgp
from audiogan_tpu.models import build_discriminator as jbuild_d
from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.convert import params_from_jax
from audiogan_tpu_torch.losses import gradient_penalty
from audiogan_tpu_torch.models import build_discriminator
from audiogan_tpu_torch.models.init import init_params

from helpers_train import tiny_config

REL = 1e-5


def _close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


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


def _cfg(num_classes=0, dtype="float32"):
    cfg = tiny_config()
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, num_classes=num_classes),
        train=dataclasses.replace(cfg.train, dtype=dtype))


def _pair(cfg, seed=0):
    """(flax critic, its params, the port's critic with the same weights)."""
    jd = jbuild_d(cfg)
    x = jnp.zeros((2, cfg.data.clip_len, 1))
    lab = jnp.zeros((2,), jnp.int32) if cfg.data.num_classes else None
    args = (x, lab) if cfg.data.num_classes else (x,)
    params = jd.init({"params": jax.random.key(seed),
                      "phase_shuffle": jax.random.key(1)}, *args)
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    td = build_discriminator(Config.from_json(cfg.to_json()), device="cpu")
    td.load_state_dict(params_from_jax(flat))
    return jd, params, td


def _waves(cfg, b=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (b, cfg.data.clip_len, 1)).astype(np.float32)


@pytest.mark.parametrize("num_classes", [0, 4])
def test_critic_matches_jax_with_injected_shifts(num_classes,
                                                 recorded_shifts):
    cfg = _cfg(num_classes)
    jd, params, td = _pair(cfg)
    recorded_shifts.clear()          # the init's own draws
    x = _waves(cfg)
    lab = np.array([0, 3, 1], np.int32)
    jargs = (jnp.asarray(x), jnp.asarray(lab)) if num_classes else (
        jnp.asarray(x),)
    want = jd.apply(params, *jargs, train=True,
                    rngs={"phase_shuffle": jax.random.key(5)})
    jax.effects_barrier()
    shifts = torch.from_numpy(np.stack(recorded_shifts))
    assert shifts.shape == (len(cfg.model.strides) - 1, 3)
    got = td(torch.from_numpy(x),
             torch.from_numpy(lab).long() if num_classes else None, shifts)
    assert got.dtype == torch.float32 and got.shape == (3,)
    _close(got, want)
    # eval form: no shuffle
    _close(td(torch.from_numpy(x),
              torch.from_numpy(lab).long() if num_classes else None),
           jd.apply(params, *jargs, train=False))


def test_param_names_match_flax():
    cfg = _cfg(num_classes=4)
    jd, params, td = _pair(cfg)
    names = {k.removeprefix("params/").replace("/", ".")
             for k in flatten_dict(params, sep="/")}
    assert names == set(td.state_dict())
    for k, v in flatten_dict(params, sep="/").items():
        name = k.removeprefix("params/").replace("/", ".")
        assert tuple(td.state_dict()[name].shape) == v.shape


def test_bf16_critic_close_to_jax(recorded_shifts):
    cfg = _cfg(dtype="bfloat16")
    jd, params, td = _pair(cfg)
    recorded_shifts.clear()
    x = _waves(cfg)
    want = np.asarray(jd.apply(params, jnp.asarray(x), train=True,
                               rngs={"phase_shuffle": jax.random.key(5)}))
    jax.effects_barrier()
    got = td(torch.from_numpy(x), None,
             torch.from_numpy(np.stack(recorded_shifts)))
    # bf16 rounds at other places in the two frameworks: 5% of the peak
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=5e-2 * np.abs(want).max())


def test_gp_first_and_second_order_match_jax(recorded_shifts):
    cfg = _cfg()
    jd, params, td = _pair(cfg, seed=3)
    recorded_shifts.clear()
    real, fake = _waves(cfg, 4, seed=1), _waves(cfg, 4, seed=2) * 0.5
    key_eps, key_shuf = jax.random.key(8), jax.random.key(9)

    def jloss(p):
        gp, gnorm = jgp(lambda v: jd.apply(p, v, train=True,
                                           rngs={"phase_shuffle": key_shuf}),
                        jnp.asarray(real), jnp.asarray(fake), key_eps)
        return gp, gnorm

    (jgp_val, jnorm), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        params)
    jax.effects_barrier()
    eps = np.array(jax.random.uniform(key_eps, (4, 1, 1))).reshape(4)
    shifts = torch.from_numpy(np.stack(recorded_shifts[:2]))
    gp, gnorm = gradient_penalty([lambda v: td(v, None, shifts)],
                                 torch.from_numpy(real),
                                 torch.from_numpy(fake),
                                 torch.from_numpy(eps))
    _close(gp, jgp_val)
    _close(gnorm, jnorm)
    names = [n for n, _ in td.named_parameters()]
    grads = torch.autograd.grad(gp, list(td.parameters()), allow_unused=True,
                                materialize_grads=True)
    assert all(torch.isfinite(g).all() for g in grads)
    assert sum(float(g.abs().sum()) for g in grads) > 0
    want = params_from_jax({k: np.asarray(v) for k, v in
                            flatten_dict(jgrads, sep="/").items()})
    for n, g in zip(names, grads):
        _close(g, want[n].numpy())


def test_gp_rejects_batch_chunks():
    """gp_batch_chunks that do not divide the batch raise ValueError, as
    the reference's do; so does a chunked penalty without D's parameters,
    which it returns the gradients of."""
    cfg = _cfg()
    td = init_params(build_discriminator(Config.from_json(cfg.to_json()),
                                         device="cpu"), 0)
    x = torch.zeros(4, cfg.data.clip_len, 1)
    with pytest.raises(ValueError, match="divisible"):
        gradient_penalty([lambda v: td(v)] * 3, x, x, torch.zeros(4),
                         params=list(td.parameters()))
    with pytest.raises(ValueError, match="params"):
        gradient_penalty([lambda v: td(v)] * 2, x, x, torch.zeros(4))


@pytest.mark.parametrize("chunks", [2, 4])
def test_chunked_gp_matches_jax_and_the_unchunked(chunks):
    """The chunked penalty (each chunk's graph recomputed in the backward)
    against the reference's lax.map(jax.checkpoint(...)) at the same
    chunking, and against the port's unchunked penalty: the penalty, the
    mean norm and the gradient with respect to every critic parameter,
    within REL (the eval-form critic: no shuffle, so every chunking draws
    alike)."""
    cfg = _cfg()
    jd, params, td = _pair(cfg, seed=3)
    real, fake = _waves(cfg, 4, seed=1), _waves(cfg, 4, seed=2) * 0.5
    key_eps = jax.random.key(8)

    def jloss(p):
        return jgp(lambda v: jd.apply(p, v, train=False), jnp.asarray(real),
                   jnp.asarray(fake), key_eps, batch_chunks=chunks)

    (jgp_val, jnorm), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        params)
    eps = torch.from_numpy(np.array(jax.random.uniform(
        key_eps, (4, 1, 1))).reshape(4))
    want = params_from_jax({k: np.asarray(v) for k, v in
                            flatten_dict(jgrads, sep="/").items()})
    names = [n for n, _ in td.named_parameters()]
    for c in (chunks, 1):
        gp, gnorm = gradient_penalty([lambda v: td(v)] * c,
                                     torch.from_numpy(real),
                                     torch.from_numpy(fake), eps,
                                     params=list(td.parameters()))
        _close(gp, jgp_val)
        _close(gnorm, jnorm)
        grads = torch.autograd.grad(gp, list(td.parameters()),
                                    allow_unused=True,
                                    materialize_grads=True)
        for n, g in zip(names, grads):
            _close(g, want[n].numpy())
