"""audiogan_tpu_torch's context-parallel models (parallel/cp_models.py)
against the reference's (audiogan_tpu/parallel/cp_models.py) inside
``jax.shard_map`` on two fake CPU devices, and against the port's own
unsharded modules, on the JAX initial weights (convert.params_from_jax).

The port runs in two processes over gloo, one cp group of two ranks
(tools/dp_check.py::spawn, one spawn for every case, one intra-op thread
each). Checked, at tiny sizes (helpers_train.tiny_config), f32:

- the critic's score: the wave critic with phase shuffle (radius 2, the
  reference's shifts: fold_in(key, layer)), conditional (projection),
  the dual wave + STFT critic, conditional too;
- the generator's slices put back together: the WaveGAN G, conditional,
  and the conditional GRU G (its recurrence handed across the ranks);
- cp_batch_spectral_matching_loss against the reference's and the
  unsharded batch_spectral_matching_loss (two resolutions, masked tail
  frames);
- the reference's cp functions compute in f32 for a bf16 configuration:
  its score and G output for the bf16 config equal the f32 config's to
  the bit, and the port's follow (the cp functions read no dtype).

Tolerance: 1e-5 relative to the largest value (the same sums in another
order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from audiogan_tpu.config import ModelCfg
from audiogan_tpu.losses.stft_loss import \
    batch_spectral_matching_loss as jspectral
from audiogan_tpu.parallel import cp_models as jcp
from audiogan_tpu.train.state import create_train_state as jcreate
from audiogan_tpu_torch.losses import batch_spectral_matching_loss
from audiogan_tpu_torch.tools import dp_check

from helpers_train import tiny_config
from test_torch_train import _port_state

torch.set_num_threads(1)

CP, B = 2, 3
REL = 1e-5
RESOLUTIONS = ((128, 32, 128), (256, 64, 256))


def _dual(base, **data):
    return dataclasses.replace(
        base, data=dataclasses.replace(base.data, **data),
        model=dataclasses.replace(base.model, use_stft_critic=True,
                                  stft_resolutions=RESOLUTIONS))


def _variants():
    base = tiny_config()
    wave = dataclasses.replace(base, model=dataclasses.replace(
        base.model, phase_shuffle=2))
    cond = dataclasses.replace(wave, data=dataclasses.replace(
        wave.data, num_classes=4))
    gru = tiny_config(
        data=dataclasses.replace(base.data, num_classes=4),
        model=ModelCfg(generator="gru", model_dim=4, kernel_size=9,
                       strides=(4, 4, 4), gru_frame_size=64, gru_hidden=16,
                       max_channels=16, phase_shuffle=1))
    return {"wave": wave, "cond": cond, "dual": _dual(wave),
            "dual_cond": _dual(wave, num_classes=4), "gru": gru,
            "bf16": dataclasses.replace(wave, train=dataclasses.replace(
                wave.train, dtype="bfloat16"))}


VARIANTS = _variants()


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    t = cfg.data.clip_len
    x = rng.uniform(-1, 1, (B, t, 1)).astype(np.float32)
    real = rng.uniform(-1, 1, (B, t)).astype(np.float32)
    z = rng.standard_normal((B, cfg.model.latent_dim)).astype(np.float32)
    labels = (rng.integers(0, cfg.data.num_classes, B).astype(np.int32)
              if cfg.data.num_classes else None)
    key = jax.random.PRNGKey(seed + 7)
    rad, sites = cfg.model.phase_shuffle, len(cfg.model.strides) - 1
    shifts = np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(key, i), (B,), -rad, rad + 1))
        for i in range(sites)])
    return dict(x=x, real=real, z=z, labels=labels, key=key, shifts=shifts)


def _reference(cfg, state, inp):
    """The reference's cp critic score, G output and spectral loss (of
    its G output against ``real``), in shard_map over two devices."""
    mesh = Mesh(np.asarray(jax.devices()[:CP]), ("cp",))
    t_spec = P(None, "cp", None)
    lab = None if inp["labels"] is None else jnp.asarray(inp["labels"])
    cond = lab is not None

    def critic(params, x, key, *labels):
        return jcp.cp_discriminator_forward(params, x, cfg, "cp", key,
                                            labels[0] if cond else None)

    def gen(params, z, *labels):
        fwd = (jcp.cp_gru_generator_forward
               if cfg.model.generator == "gru" else jcp.cp_generator_forward)
        return fwd(params, z, cfg, "cp", labels[0] if cond else None)

    def spectral(fake, real):
        return jcp.cp_batch_spectral_matching_loss(fake, real, RESOLUTIONS,
                                                   "cp")
    extra = (lab,) if cond else ()
    ex_spec = (P(),) if cond else ()
    score = jax.jit(shard_map(critic, mesh=mesh,
                              in_specs=(P(), t_spec, P(), *ex_spec),
                              out_specs=P()))(
        state.params_d, jnp.asarray(inp["x"]), inp["key"], *extra)
    g = jax.jit(shard_map(gen, mesh=mesh, in_specs=(P(), P(), *ex_spec),
                          out_specs=t_spec))(
        state.params_g, jnp.asarray(inp["z"]), *extra)
    out = {"score": np.asarray(score), "g": np.asarray(g)}
    if cfg.model.use_stft_critic:
        out["stft"] = float(jax.jit(shard_map(
            spectral, mesh=mesh, in_specs=(P(None, "cp"), P(None, "cp")),
            out_specs=P()))(g[..., 0], jnp.asarray(inp["real"])))
        out["stft_unsharded"] = float(jspectral(
            g[..., 0], jnp.asarray(inp["real"]), RESOLUTIONS))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{variant: (reference, port per rank, port unsharded, inputs)}."""
    jobs, ref, whole, inputs = [], {}, {}, {}
    for name, cfg in VARIANTS.items():
        state = jcreate(cfg)
        inp = inputs[name] = _inputs(cfg)
        ref[name] = _reference(cfg, state, inp)
        pcfg, st = _port_state(cfg, state)
        t = {k: None if v is None else torch.from_numpy(np.asarray(v))
             for k, v in inp.items() if k != "key"}
        lab = None if t["labels"] is None else t["labels"].long()
        with torch.no_grad():
            whole[name] = {"score": st.d(t["x"], lab, t["shifts"]),
                           "g": st.g(t["z"], lab)}
            if cfg.model.use_stft_critic:
                whole[name]["stft"] = batch_spectral_matching_loss(
                    whole[name]["g"][..., 0], t["real"], RESOLUTIONS)
        jobs.append({"name": name, "fn": "cp_model", "kw": {
            "cfg_json": pcfg.to_json(), "state": dp_check.state_blob(st),
            "x": t["x"], "shifts": t["shifts"], "z": t["z"], "labels": lab,
            "real": t["real"] if cfg.model.use_stft_critic else None}})
    port = dp_check.spawn(CP, jobs, tmp_path_factory.mktemp("cp_model"))
    return {n: (ref[n], port[n], whole[n], inputs[n]) for n in VARIANTS}


def _close(got, want, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(got, want, rtol=0, err_msg=err_msg,
                               atol=REL * max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("variant", [v for v in VARIANTS if v != "bf16"])
def test_cp_critic_matches_reference_and_unsharded(runs, variant):
    ref, ranks, whole, _ = runs[variant]
    for r in ranks:                 # the score is the same on every rank
        assert torch.equal(r["score"], ranks[0]["score"])
        _close(r["score"], ref["score"], "vs reference")
        _close(r["score"], whole["score"], "vs unsharded")


@pytest.mark.parametrize("variant", ["wave", "cond", "gru"])
def test_cp_generator_matches_reference_and_unsharded(runs, variant):
    ref, ranks, whole, _ = runs[variant]
    got = torch.cat([r["g"] for r in ranks], 1)
    _close(got, ref["g"], "vs reference")
    _close(got, whole["g"], "vs unsharded")


@pytest.mark.parametrize("variant", ["dual", "dual_cond"])
def test_cp_spectral_matching_loss_matches(runs, variant):
    ref, ranks, whole, _ = runs[variant]
    for r in ranks:
        assert torch.equal(r["stft"], ranks[0]["stft"])
        np.testing.assert_allclose(float(r["stft"]), ref["stft"], rtol=REL)
        np.testing.assert_allclose(float(r["stft"]), ref["stft_unsharded"],
                                   rtol=REL)
        np.testing.assert_allclose(float(r["stft"]), float(whole["stft"]),
                                   rtol=REL)


def test_cp_computes_in_f32_for_a_bf16_config(runs):
    """The reference's cp critic and G cast nothing: the bf16 config's
    outputs are f32 and equal the f32 config's to the bit (same weights,
    same inputs); the port's cp outputs for it match them, where the
    port's unsharded bf16 modules round to bf16."""
    ref16, ranks16, whole16, _ = runs["bf16"]
    ref32 = runs["wave"][0]
    for key in ("score", "g"):
        assert ref16[key].dtype == np.float32
        np.testing.assert_array_equal(ref16[key], ref32[key])
    for r in ranks16:
        _close(r["score"], ref16["score"])
    _close(torch.cat([r["g"] for r in ranks16], 1), ref16["g"])
    assert not np.allclose(whole16["g"].numpy(), ref16["g"], rtol=0,
                           atol=REL * np.abs(ref16["g"]).max())
