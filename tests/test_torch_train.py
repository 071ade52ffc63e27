"""audiogan_tpu_torch's WGAN-GP training step, state, data and loop against
the JAX package's.

One whole ``tiny_config`` step (n_critic=2), unfused and fused critic
views, a conditional one (projection critic, labels) with the drift
term, the music geometry (helpers_golden.case_music: strides 7/7/5/5/3
at 44.1 kHz), a resampled corpus (22050 -> 16000 Hz in the ingest, its
crop offsets drawn over the resampled row's slack), the chunked
penalty (gp_batch_chunks=2, shuffle off as tests/train/test_step.py
compares it: each chunk draws its shifts at chunk size), and the dual
critic (wave + STFT critic) with G's spectral term
(one more real view, its crop offsets from the fourth key of
``jax.random.split(fold_in(step_key, n_critic + 1), 4)``, step.py:264),
unfused and fused, from a carried non-initial state (the JAX state after one step:
weights and both Adam states) and the reference's draws: z, eps, crop
offsets, labels from ``jax.random.split(fold_in(step_key, idx), 7)``
(train/step.py:210-211) and the flax-drawn shuffle shifts, recorded by
test-only wrappers around audiogan_tpu.models.wavegan.phase_shuffle and,
for fused shuffle sites, wavegan.sconv1d_ba, which draws its shift from
its key (kernels/sconv.py:741), both in site order (ordered
jax.debug.callback). Compared: the metrics, both nets' parameters
and the Adam moments. Tolerances (f32, the same sums in another order):
metrics 1e-5 relative, parameters 1e-6 absolute (a hundredth of one Adam
step), moments 1e-4 relative to each tensor's largest.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

import audiogan_tpu.models.wavegan as jwg
from audiogan_tpu.data.corpus import Corpus as JCorpus
from audiogan_tpu.data.corpus import HostBatcher
from audiogan_tpu.data.corpus import build_corpus as jbuild_corpus
from audiogan_tpu.data.synthetic import make_synthetic_sc09 as jsynth
from audiogan_tpu.data.wavio import read_wav as jread_wav
from audiogan_tpu.train.state import create_train_state as jcreate
from audiogan_tpu.train.step import build_train_step as jbuild_step
from audiogan_tpu.utils.prng import split_for_step
from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.convert import params_from_jax, train_state_from_jax
from audiogan_tpu_torch.data.corpus import Corpus, batch_indices, build_corpus
from audiogan_tpu_torch.data.synthetic import make_synthetic_sc09
from audiogan_tpu_torch.data.wavio import read_wav
from audiogan_tpu_torch.train.state import create_train_state
from audiogan_tpu_torch.train.step import (build_train_step, draw_step,
                                           wrap_device_corpus)

from helpers_train import raw_batch, tiny_config


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _jax_run(cfg):
    """Two JAX steps; the shifts of the second are recorded. Returns
    (state after step 1, state after step 2, step-2 metrics, shifts,
    step-2 batch)."""
    rec = []
    orig, orig_fused = jwg.phase_shuffle, jwg.sconv1d_ba

    def record(key, b, rad):
        sh = jax.random.randint(key, (b,), -rad, rad + 1)
        jax.debug.callback(lambda v: rec.append(np.array(v)), sh,
                           ordered=True)

    def recording(h, key, rad, impl=None):
        record(key, h.shape[0], rad)
        return orig(h, key, rad, impl=impl)

    def recording_fused(y, w, b, key, rad, **kw):
        record(key, y.shape[0], rad)
        return orig_fused(y, w, b, key, rad, **kw)
    jwg.phase_shuffle = recording
    jwg.sconv1d_ba = recording_fused
    try:
        state0 = jcreate(cfg)
        step = jax.jit(jbuild_step(cfg))
        state1, _ = step(state0, *raw_batch(cfg, seed=1))
        jax.effects_barrier()
        rec.clear()
        batch = raw_batch(cfg, seed=2)
        state2, metrics = step(state1, *batch)
        jax.effects_barrier()
    finally:
        jwg.phase_shuffle, jwg.sconv1d_ba = orig, orig_fused
    return state1, state2, metrics, rec, batch


def _reference_draws(cfg, state1, shifts):
    """The reference's draws of the step that starts from state1."""
    b, n_critic = cfg.train.batch_size, cfg.loss.n_critic
    n_cls = cfg.data.num_classes

    def labels(key):
        if not n_cls:
            return None
        return torch.from_numpy(np.array(
            jax.random.randint(key, (b,), 0, n_cls))).long()

    sites = len(cfg.model.strides) - 1 if cfg.model.phase_shuffle else 0
    latent = cfg.model.latent_dim
    (step_key,) = split_for_step(jax.random.wrap_key_data(state1.base_key),
                                 state1.step, "step")
    it = iter(shifts)

    def take():
        if not sites:
            return torch.zeros(0, b, dtype=torch.long)
        return torch.from_numpy(np.stack([next(it) for _ in range(sites)]))

    max_off = max(cfg.data.resampled_len - cfg.data.clip_len, 0)
    critic = []
    for i in range(n_critic):
        k = jax.random.fold_in(step_key, i)
        k_crop, k_z, k_eps, k_lab, _, _, _ = jax.random.split(k, 7)
        dr = {"offsets": torch.from_numpy(np.array(
                  jax.random.randint(k_crop, (b,), 0, max_off + 1))),
              "z": torch.from_numpy(np.array(
                  jax.random.normal(k_z, (b, latent)))),
              "eps": torch.from_numpy(np.array(
                  jax.random.uniform(k_eps, (b, 1, 1))).reshape(b)),
              "labels": labels(k_lab)}
        dr["shifts"] = ({"both": take()} if cfg.train.fused_d_views
                        else {"real": take(), "fake": take()})
        dr["shifts"]["gp"] = take()
        critic.append(dr)
    k_z, k_lab, _, k_crop = jax.random.split(
        jax.random.fold_in(step_key, n_critic + 1), 4)
    gen = {"z": torch.from_numpy(np.array(jax.random.normal(k_z,
                                                            (b, latent)))),
           "labels": labels(k_lab), "shifts": take()}
    if cfg.loss.stft_loss_weight > 0:
        gen["offsets"] = torch.from_numpy(np.array(jax.random.randint(
            k_crop, (b,), 0, max_off + 1)))
    assert next(it, None) is None, "unused recorded shifts"
    return {"critic": critic, "generator": gen}


def _adam_leaves(opt_state):
    adam = opt_state[0]
    return {"count": int(adam.count), "mu": _flat(adam.mu),
            "nu": _flat(adam.nu)}


def _port_state(cfg, jstate):
    pcfg = Config.from_json(cfg.to_json()).validate()
    st = train_state_from_jax(
        pcfg, _flat(jstate.params_g), _flat(jstate.params_d),
        _adam_leaves(jstate.opt_g), _adam_leaves(jstate.opt_d),
        int(jstate.step), pcfg.train.seed, device="cpu")
    return pcfg, st


def _variant(name):
    base = tiny_config()
    cfg = tiny_config(train=dataclasses.replace(
        base.train, fused_d_views=name != "unfused"))
    if name.startswith("conditional"):
        cfg = tiny_config(
            data=dataclasses.replace(base.data, num_classes=4),
            loss=dataclasses.replace(base.loss, drift_epsilon=1e-3),
            train=cfg.train)
    if "sites" in name:
        # every phase-shuffle site fused into its consuming conv (K6/K7)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, fused_shuffle_sites=-1))
    if name == "music":
        from helpers_golden import case_music
        music = case_music()
        cfg = dataclasses.replace(cfg, data=music.data, model=music.model)
    if name == "resample":
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, source_rate=22050, store_len=1600))
    if name == "gp_chunks":
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, phase_shuffle=0),
            loss=dataclasses.replace(cfg.loss, gp_batch_chunks=2))
    if name.startswith("dual"):
        # the dual critic and G's spectral term (tests/train/test_step.py)
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(
                cfg.model, use_stft_critic=True,
                stft_resolutions=((128, 32, 128),)),
            loss=dataclasses.replace(cfg.loss, stft_loss_weight=1.0))
    return cfg


@pytest.mark.parametrize("variant", ["unfused", "fused",
                                     "conditional_drift", "fused_sites",
                                     "conditional_fused_sites",
                                     "dual_unfused", "dual_fused", "music",
                                     "resample", "gp_chunks"])
def test_step_matches_jax(variant):
    cfg = _variant(variant)
    state1, state2, want, shifts, (clips, labels) = _jax_run(cfg)
    draws = _reference_draws(cfg, state1, shifts)
    pcfg, st = _port_state(cfg, state1)
    got = build_train_step(pcfg, device="cpu")(
        st, torch.from_numpy(clips), torch.from_numpy(labels), draws=draws)
    assert st.step == int(state2.step) == 2
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for jtree, mod in ((state2.params_g, st.g), (state2.params_d, st.d)):
        ref, sd = params_from_jax(_flat(jtree)), mod.state_dict()
        for n in ref:
            np.testing.assert_allclose(sd[n].numpy(), ref[n].numpy(),
                                       atol=1e-6, rtol=0, err_msg=n)
    for opt, mod, ost in ((st.opt_g, st.g, state2.opt_g),
                          (st.opt_d, st.d, state2.opt_d)):
        adam = ost[0]
        mu, nu = params_from_jax(_flat(adam.mu)), params_from_jax(
            _flat(adam.nu))
        for n, p in mod.named_parameters():
            s = opt.state[p]
            assert float(s["step"]) == int(adam.count)
            for got_m, ref_m in ((s["exp_avg"], mu[n]),
                                 (s["exp_avg_sq"], nu[n])):
                np.testing.assert_allclose(
                    got_m.numpy(), ref_m.numpy(), rtol=0,
                    atol=1e-4 * float(ref_m.abs().max()) + 1e-30,
                    err_msg=n)


def test_adam_matches_optax():
    """torch.optim.Adam as the state builds it == optax.adam: eps outside
    the square root, both moments bias-corrected."""
    cfg = Config.from_json(tiny_config().to_json())
    st = create_train_state(cfg, device="cpu")
    p = next(st.d.parameters())
    p0 = p.detach().clone()
    opt = optax.adam(cfg.train.lr_d, b1=cfg.train.beta1, b2=cfg.train.beta2)
    jp = jnp.asarray(p0.numpy())
    jst = opt.init(jp)
    rng = np.random.default_rng(0)
    for _ in range(3):
        g = rng.standard_normal(p.shape).astype(np.float32)
        upd, jst = opt.update(jnp.asarray(g), jst, jp)
        jp = jp + upd
        st.opt_d.zero_grad()
        for q in st.d.parameters():
            q.grad = torch.zeros_like(q)
        p.grad = torch.from_numpy(g)
        st.opt_d.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                               rtol=0, atol=1e-7)
    assert st.opt_d.defaults["eps"] == 1e-8
    assert st.opt_d.defaults["betas"] == (0.5, 0.9)


def _tiny_port_cfg(fused=False):
    cfg = tiny_config(train=dataclasses.replace(tiny_config().train,
                                                fused_d_views=fused))
    return Config.from_json(cfg.to_json()).validate()


def _run_own(pcfg, seed, steps=2):
    st = create_train_state(pcfg, seed=seed, device="cpu")
    fn = build_train_step(pcfg, device="cpu")
    out = []
    for s in range(steps):
        clips, labels = raw_batch(tiny_config(), seed=100 + s)
        m = fn(st, torch.from_numpy(clips), torch.from_numpy(labels))
        out.append({k: float(v) for k, v in m.items()})
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_own_stream_is_deterministic(fused):
    pcfg = _tiny_port_cfg(fused)
    a, b, c = _run_own(pcfg, 0), _run_own(pcfg, 0), _run_own(pcfg, 1)
    assert a == b
    assert a != c
    assert all(np.isfinite(v) for m in a for v in m.values())


def test_draws_follow_the_views():
    pcfg = _tiny_port_cfg(True)
    d1 = draw_step(pcfg, 0, 3, 4, "cpu")
    d2 = draw_step(pcfg, 0, 3, 4, "cpu")
    d3 = draw_step(pcfg, 0, 4, 4, "cpu")
    assert torch.equal(d1["critic"][1]["z"], d2["critic"][1]["z"])
    assert not torch.equal(d1["critic"][1]["z"], d3["critic"][1]["z"])
    assert d1["critic"][0]["shifts"]["both"].shape == (2, 8)
    assert d1["critic"][0]["shifts"]["gp"].shape == (2, 4)
    sh = torch.stack([d["shifts"]["both"] for d in d1["critic"]])
    assert int(sh.min()) >= -1 and int(sh.max()) <= 1
    off = d1["critic"][0]["offsets"]
    assert off.dtype == torch.int32 and int(off.max()) <= 256
    unfused = draw_step(_tiny_port_cfg(False), 0, 3, 4, "cpu")
    assert set(unfused["critic"][0]["shifts"]) == {"real", "fake", "gp"}


def test_device_corpus_gathers_by_index():
    pcfg = _tiny_port_cfg()
    clips, labels = raw_batch(tiny_config(), seed=5)
    corpus = torch.from_numpy(clips.reshape(-1, clips.shape[-1]))
    idx = torch.arange(corpus.shape[0]).reshape(clips.shape[:2])
    seen = {}

    def inner(state, raw, lab, draws=None):
        seen["raw"], seen["lab"] = raw, lab
        return {}
    wrap_device_corpus(inner)(None, corpus, idx, torch.from_numpy(labels))
    assert torch.equal(seen["raw"], torch.from_numpy(clips))


def test_step_rejects_what_is_not_ported():
    """tp=2, dp=2 or cp=2 in one process raises ValueError (the mesh
    needs two processes); fsdp at dp=1 builds a step. A conditional
    critic with gp_batch_chunks > 1 raises ValueError, where the
    reference's penalty fails (each chunk gets the whole batch's
    labels)."""
    from audiogan_tpu_torch.config import MeshCfg
    pcfg = _tiny_port_cfg()
    for mesh in (MeshCfg(tp=2), MeshCfg(cp=2), MeshCfg(dp=2)):
        with pytest.raises(ValueError, match="mesh needs 2 devices"):
            build_train_step(pcfg.replace(mesh=mesh), device="cpu")
    build_train_step(pcfg.replace(mesh=MeshCfg(fsdp=True)), device="cpu")
    cond = pcfg.replace(
        data=dataclasses.replace(pcfg.data, num_classes=4),
        loss=dataclasses.replace(pcfg.loss, gp_batch_chunks=2))
    with pytest.raises(ValueError, match="conditional"):
        build_train_step(cond, device="cpu")
    build_train_step(pcfg.replace(loss=dataclasses.replace(
        pcfg.loss, gp_batch_chunks=2)), device="cpu")


def test_corpus_and_index_stream_match_jax(tmp_path):
    jsynth(tmp_path / "jw", n_per_class=2, num_classes=3, clip_len=1200)
    make_synthetic_sc09(tmp_path / "tw", n_per_class=2, num_classes=3,
                        clip_len=1200)
    for p in sorted((tmp_path / "jw").rglob("*.wav")):
        q = tmp_path / "tw" / p.relative_to(tmp_path / "jw")
        assert p.read_bytes() == q.read_bytes()
        r1, x1 = jread_wav(p)
        r2, x2 = read_wav(q)
        assert r1 == r2 and np.array_equal(x1, x2)
    jbuild_corpus(tmp_path / "jw", tmp_path / "jc", store_len=1280)
    build_corpus(tmp_path / "tw", tmp_path / "tc", store_len=1280)
    jc, tc = JCorpus(tmp_path / "jc"), Corpus(tmp_path / "tc")
    assert np.array_equal(jc.clips, tc.clips)
    assert np.array_equal(jc.labels, tc.labels)
    assert jc.meta == tc.meta
    hb = HostBatcher(jc, batch_size=4, n_views=2, seed=7)
    for step in (0, 1, 9):
        assert np.array_equal(hb._indices(step),
                              batch_indices(len(tc), 4, 2, 7, step))


def test_cli_train_runs_on_the_cpu(tmp_path, capsys):
    from audiogan_tpu_torch.cli import main
    assert main(["train", "--preset", "tiny_sc09", "--device", "cpu",
                 "--steps", "2", "--batch_size", "2", "--log_every", "1",
                 "--workdir", str(tmp_path)]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    steps = [ln for ln in lines if "step" in ln]
    assert [ln["step"] for ln in steps] == [1, 2]
    for ln in steps:
        for k in ("d_loss", "w_dist", "gp", "gp_grad_norm", "d_loss_mean",
                  "g_loss"):
            assert np.isfinite(ln[k]), k
    assert (tmp_path / "synthetic_corpus" / "meta.json").exists()
    assert json.loads((tmp_path / "config.json").read_text())["name"] == \
        "tiny_sc09"


def test_step_runs_every_backward_on_the_calling_thread(monkeypatch):
    """The step turns off the autograd engine's worker threads: every
    backward of it (the penalty's inner grad, the critic's and the
    generator's updates) runs on the thread that called the step, so the
    nodes the penalty's create_graph backward makes are numbered by the
    same counter as the forward's, and the engine's order, which sets the
    order of every gradient sum, is the same in every run and process."""
    import audiogan_tpu_torch.kernels.autograd as kad
    seen = []
    real = kad.conv1d_wgrad

    def spy(*a):
        seen.append(torch._C._is_multithreading_enabled())
        return real(*a)
    monkeypatch.setattr(kad, "conv1d_wgrad", spy)
    pcfg = _tiny_port_cfg(True)
    _run_own(pcfg, 0, steps=1)
    assert seen and not any(seen)
    assert torch._C._is_multithreading_enabled()
