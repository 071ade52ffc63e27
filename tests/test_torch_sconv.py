"""audiogan_tpu_torch's fused phase-shuffle sites against the JAX package's.

The plain forms of K6 (``kernels/sconv.py::sconv1d_ba``) and K7
(``sconvt1d``), what a CPU tensor runs and the CUDA kernels' oracles, are
held against ``audiogan_tpu.kernels.sconv``'s XLA route and its Pallas
kernels in interpret mode (as tests/pallas/conftest.py runs them), at the
reference's PALLAS_GEOS with a batch of 2 rad + 2 so that every offset
occurs. Then the masked reflect pad and its adjoint, first- and
second-order gradients of the fused site, the critic with fused sites
(against the port's unfused critic and against JAX's fused critic), the
launches a fused training step makes, and the CLI's ``--set``.

Tolerances: f32 1e-5 absolute and relative (the same sums in another
order, as tests/test_torch_convt.py); bf16 inputs: the port rounds its f32
sum once to bf16 while XLA's bf16 conv on the CPU rounds its own way, so
2e-2 of the output's peak (about five bf16 ulps near the peak); gradients
and the critic at the reference's own tolerances
(tests/pallas/test_sconv.py:58-90, 139-155).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import audiogan_tpu.cli as jcli
import audiogan_tpu.kernels.conv as jconv
import audiogan_tpu.models.wavegan as jwg
from audiogan_tpu.config import get_preset as jax_get_preset
from audiogan_tpu.kernels import sconv as jsconv
from audiogan_tpu.kernels.conv import _same_pads
from audiogan_tpu.losses import gradient_penalty as jgp
from audiogan_tpu.models import build_discriminator as jbuild_d
from audiogan_tpu_torch.cli import apply_overrides
from audiogan_tpu_torch.config import Config, get_preset
from audiogan_tpu_torch.convert import params_from_jax
from audiogan_tpu_torch.kernels import sconv as tsconv
from audiogan_tpu_torch.losses import gradient_penalty
from audiogan_tpu_torch.models import build_discriminator
from audiogan_tpu_torch.models.init import init_params
from audiogan_tpu_torch.ops import sconv as tops
from audiogan_tpu_torch.ops.conv import sconv1d_ba
from audiogan_tpu_torch.ops.phase_shuffle import PShuf

from helpers_train import raw_batch, tiny_config

# the reference's PALLAS_GEOS (tests/pallas/test_sconv.py:181-189)
PALLAS_GEOS = [
    # k, s, rad, cin, cout, t
    (25, 4, 2, 32, 64, 128),
    (9, 4, 2, 64, 32, 64),
    (25, 2, 2, 32, 32, 64),
    (7, 7, 3, 32, 32, 49),
    (25, 3, 2, 32, 32, 66),
    (9, 1, 2, 32, 32, 48),
]
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}
BF16_PEAK_REL = 2e-2


def _geo_id(g):
    return "k{}_s{}_rad{}_{}x{}_t{}".format(*g)


def _offs(b, rad):
    return (np.arange(b) % (2 * rad + 1)).astype(np.int32)


def _round_bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _check(got, want, dname):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dname == "f32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(
            got, want, rtol=0, atol=BF16_PEAK_REL * np.abs(want).max())


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jconv, "_INTERPRET", True)


@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("geo", PALLAS_GEOS, ids=_geo_id)
def test_sconv1d_plain_matches_jax(geo, dname, interpret):
    k, s, rad, cin, cout, t = geo
    b = 2 * rad + 2
    rng = np.random.default_rng(0)
    xp = rng.standard_normal((b, t + 2 * rad, cin)).astype(np.float32)
    w = (rng.standard_normal((k, cin, cout)) / np.sqrt(k * cin / 4)
         ).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32) * 0.5
    if dname == "bf16":
        xp, w, bias = (_round_bf16(a) for a in (xp, w, bias))
    offs = _offs(b, rad)
    _, lo, hi = _same_pads(t, k, s)
    _, jdt, tdt = DTYPES[dname]
    jx, jw, jb = (jnp.asarray(a, jdt) for a in (xp, w, bias))
    want_xla = jsconv.sconv1d_ba_lowered(jx, jw, jb, jnp.asarray(offs), s,
                                         lo, hi, rad, "leaky_relu", 0.2,
                                         impl="xla")
    want_pallas = jsconv._sconv1d_pallas(jx, jw, jnp.asarray(offs), s, lo,
                                         hi, rad, bias=jb, act="leaky_relu",
                                         slope=0.2)
    before = tsconv.sconv1d_ba.launches
    got = tsconv.sconv1d_ba(
        *(torch.from_numpy(a).to(tdt) for a in (xp, w, bias)),
        torch.from_numpy(offs), s, lo, hi, rad, "leaky_relu", 0.2)
    assert got.dtype == tdt
    assert tsconv.sconv1d_ba.launches == before    # the CPU takes the plain form
    _check(got, want_xla, dname)
    _check(got, want_pallas, dname)


@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("geo", PALLAS_GEOS, ids=_geo_id)
def test_sconvt1d_plain_matches_jax(geo, dname, interpret):
    """K7 at the transpose of each K6 geometry: ct [B, t_out, cout],
    wf [K, cout, cin] -> [B, t + 2 rad, cin], pad_lo_t = K-1-lo."""
    k, s, rad, cin, cout, t = geo
    b = 2 * rad + 2
    _, lo, hi = _same_pads(t, k, s)
    t_out = (t + lo + hi - k) // s + 1
    rng = np.random.default_rng(1)
    ct = rng.standard_normal((b, t_out, cout)).astype(np.float32)
    wf = (rng.standard_normal((k, cout, cin)) / np.sqrt(k * cout / 4)
          ).astype(np.float32)
    if dname == "bf16":
        ct, wf = _round_bf16(ct), _round_bf16(wf)
    offs = _offs(b, rad)
    _, jdt, tdt = DTYPES[dname]
    jct, jwf = jnp.asarray(ct, jdt), jnp.asarray(wf, jdt)
    want_xla = jsconv.sconvt1d_lowered(jct, jwf, jnp.asarray(offs), s,
                                       k - 1 - lo, t, rad, impl="xla")
    want_pallas = jsconv._sconvt1d_pallas(jct, jwf, jnp.asarray(offs), s,
                                          k - 1 - lo, t, rad)
    before = tsconv.sconvt1d.launches
    got = tsconv.sconvt1d(torch.from_numpy(ct).to(tdt),
                          torch.from_numpy(wf).to(tdt),
                          torch.from_numpy(offs), s, k - 1 - lo, t, rad)
    assert got.dtype == tdt and tsconv.sconvt1d.launches == before
    _check(got, want_xla, dname)
    _check(got, want_pallas, dname)
    # zero outside each window [off, off + t)
    live = tops._live(torch.from_numpy(offs), t, rad)
    assert not torch.where(live, 0.0, got.float()).any()


def test_wrappers_reject_bad_arguments():
    xp = torch.zeros(3, 20, 4)
    w, b = torch.zeros(5, 4, 6), torch.zeros(6)
    offs = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):                 # offs not [B]
        tsconv.sconv1d_ba(xp, w, b, offs[:2], 2, 2, 2, 2)
    with pytest.raises(ValueError):                 # float offs
        tsconv.sconv1d_ba(xp, w, b, offs.float(), 2, 2, 2, 2)
    with pytest.raises(ValueError):                 # nothing left of xp
        tsconv.sconv1d_ba(xp, w, b, offs, 2, 2, 2, 10)
    with pytest.raises(ValueError):
        tsconv.sconv1d_ba(xp, w, b, offs, 2, 2, 2, 2, act="gelu")
    with pytest.raises(ValueError):                 # channel mismatch
        tsconv.sconvt1d(torch.zeros(3, 8, 5), w.transpose(1, 2), offs, 2, 2,
                        16, 2)


@pytest.mark.parametrize("rad", [1, 2, 3])
def test_window_select_and_place_match_jax(rad):
    b, t, c = 2 * rad + 1, 4 * rad + 9, 3
    rng = np.random.default_rng(rad)
    xp = rng.standard_normal((b, t + 2 * rad, c)).astype(np.float32)
    u = rng.standard_normal((b, t, c)).astype(np.float32)
    offs = np.arange(b, dtype=np.int32)
    jo = jnp.asarray(offs)
    to = torch.from_numpy(offs)
    np.testing.assert_array_equal(
        tops.window_select(torch.from_numpy(xp), to, t, rad).numpy(),
        np.asarray(jsconv.window_select(jnp.asarray(xp), jo, t, rad)))
    np.testing.assert_array_equal(
        tops.window_place(torch.from_numpy(u), to, rad).numpy(),
        np.asarray(jsconv.window_place(jnp.asarray(u), jo, rad)))


@pytest.mark.parametrize("rad", [1, 2, 3])
def test_mrpad_pair_matches_jax(rad):
    """MRPad == _mrpad_fwd and MRPadT == _mrpad_t, every offset 0..2 rad,
    bit for bit (the same elementwise sums)."""
    b, t, c = 2 * rad + 1, 4 * rad + 7, 3
    rng = np.random.default_rng(10 + rad)
    y = rng.standard_normal((b, t, c)).astype(np.float32)
    v = rng.standard_normal((b, t + 2 * rad, c)).astype(np.float32)
    offs = np.arange(b, dtype=np.int32)
    to = torch.from_numpy(offs)
    np.testing.assert_array_equal(
        tops.MRPad.apply(torch.from_numpy(y), to, rad).numpy(),
        np.asarray(jsconv._mrpad_fwd(jnp.asarray(y), jnp.asarray(offs), rad)))
    np.testing.assert_array_equal(
        tops.MRPadT.apply(torch.from_numpy(v), to, rad).numpy(),
        np.asarray(jsconv._mrpad_t(jnp.asarray(v), jnp.asarray(offs), rad)))


@pytest.mark.parametrize("rad", [1, 2, 3])
def test_mrpadt_is_the_adjoint(rad):
    """<MRPad(y), v> == <y, MRPadT(v)> (f64), and each is the other's
    backward, to second order."""
    b, t, c = 2 * rad + 1, 4 * rad + 9, 2
    gen = torch.Generator().manual_seed(rad)
    y = torch.randn(b, t, c, generator=gen, dtype=torch.float64)
    v = torch.randn(b, t + 2 * rad, c, generator=gen, dtype=torch.float64)
    offs = torch.arange(b)
    lhs = (tops.MRPad.apply(y, offs, rad) * v).sum()
    rhs = (y * tops.MRPadT.apply(v, offs, rad)).sum()
    assert abs(lhs.item() - rhs.item()) <= 1e-13 * abs(lhs.item()) + 1e-13
    yr = y.clone().requires_grad_(True)
    assert torch.autograd.gradcheck(lambda a: tops.MRPad.apply(a, offs, rad),
                                    (yr,))
    assert torch.autograd.gradgradcheck(
        lambda a: tops.MRPad.apply(a, offs, rad) ** 2, (yr,))
    vr = v.clone().requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a: tops.MRPadT.apply(a, offs, rad), (vr,))


def test_mrpadt_needs_disjoint_folds():
    with pytest.raises(ValueError, match="2 rad"):
        tops.MRPadT.apply(torch.zeros(1, 5 + 4, 1), torch.zeros(1), 2)


@pytest.mark.parametrize("k,s,rad", [(9, 4, 2), (25, 4, 2)])
def test_sconv_grads_match_jax(k, s, rad):
    """MRPad -> SConv1dBA against JAX's sconv.sconv1d_ba (same shifts,
    drawn as sconv.py:741 draws them): value, first-order gradients, and
    the penalty-style gradient of the squared input gradient."""
    b, t, cin, cout = 2, 8 * s, 6, 10
    rng = np.random.default_rng(k)
    y = rng.standard_normal((b, t, cin)).astype(np.float32)
    w = rng.standard_normal((k, cin, cout)).astype(np.float32)
    bb = rng.standard_normal(cout).astype(np.float32)
    key = jax.random.key(3)
    shifts = torch.from_numpy(np.array(
        jax.random.randint(key, (b,), -rad, rad + 1)))

    def f_jax(y, w):
        return jnp.sum(jsconv.sconv1d_ba(y, w, jnp.asarray(bb), key, rad,
                                         stride=s, act="leaky_relu",
                                         impl="xla"))

    def f_port(y, w):
        return sconv1d_ba(y, w, torch.from_numpy(bb), shifts, rad, stride=s,
                          act="leaky_relu").sum()

    jy, jw = jnp.asarray(y), jnp.asarray(w)
    ty = torch.from_numpy(y).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    val = f_port(ty, tw)
    np.testing.assert_allclose(val.item(), float(f_jax(jy, jw)), rtol=1e-6)
    gy, gw = torch.autograd.grad(val, (ty, tw))
    for got, want in zip((gy, gw), jax.grad(f_jax, (0, 1))(jy, jw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    def gp_jax(w):
        g = jax.grad(lambda v: f_jax(v, w))(jy)
        return jnp.sum(jnp.square(g))

    (g1,) = torch.autograd.grad(f_port(ty, tw), ty, create_graph=True)
    gp = g1.square().sum()
    np.testing.assert_allclose(gp.item(), float(gp_jax(jw)), rtol=1e-6)
    (ggw,) = torch.autograd.grad(gp, tw)
    np.testing.assert_allclose(ggw.numpy(), np.asarray(jax.grad(gp_jax)(jw)),
                               atol=2e-4, rtol=2e-5)


def test_sconv_family_gradcheck():
    """SConv1d/SConvT/SConv1dBA in float64 (the plain forms keep float64):
    first- and second-order gradients against finite differences."""
    from audiogan_tpu_torch.kernels import autograd as kad
    gen = torch.Generator().manual_seed(0)
    b, t, cin, cout, k, s, rad = 3, 12, 3, 4, 5, 2, 1
    f64 = dict(generator=gen, dtype=torch.float64)
    xp = torch.randn(b, t + 2 * rad, cin, **f64).requires_grad_(True)
    w = torch.randn(k, cin, cout, **f64).requires_grad_(True)
    bias = torch.randn(cout, **f64).requires_grad_(True)
    offs = torch.tensor([0, 1, 2])
    lo, hi = 2, 2
    t_out = (t + lo + hi - k) // s + 1
    ct = torch.randn(b, t_out, cout, **f64).requires_grad_(True)
    wf = torch.randn(k, cout, cin, **f64).requires_grad_(True)
    for fn, args in (
            (lambda x, w_: kad.SConv1d.apply(x, w_, offs, s, lo, hi, rad),
             (xp, w)),
            (lambda c, w_: kad.SConvT.apply(c, w_, offs, s, k - 1 - lo, t,
                                            rad), (ct, wf)),
            (lambda x, w_, b_: kad.SConv1dBA.apply(x, w_, b_, offs, s, lo,
                                                   hi, rad, "tanh", 0.2),
             (xp, w, bias))):
        assert torch.autograd.gradcheck(fn, args)
        assert torch.autograd.gradgradcheck(fn, args)


def _cfg(num_classes=0, fused=0):
    cfg = tiny_config()
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, num_classes=num_classes),
        model=dataclasses.replace(cfg.model, fused_shuffle_sites=fused))


def _port(cfg) -> Config:
    return Config.from_json(cfg.to_json())


def _scores_and_gp(d, x, lab, shifts, eps):
    d.zero_grad()
    score = d(x, lab, shifts)
    gp, _ = gradient_penalty([lambda v: d(v, lab, shifts)], x,
                             x.flip(0) * 0.5, eps)
    (score.sum() + gp).backward()
    return score.detach(), gp.detach(), {
        n: p.grad.clone() for n, p in d.named_parameters()}


@pytest.mark.parametrize("num_classes", [0, 4])
@pytest.mark.parametrize("fused", [-1, 1])
def test_fused_critic_matches_unfused_port(fused, num_classes):
    """Score, penalty and parameter gradients of the fused critic equal
    the unfused one on the same parameters and shifts."""
    d0 = init_params(build_discriminator(_port(_cfg(num_classes)),
                                         device="cpu"), seed=0)
    d1 = build_discriminator(_port(_cfg(num_classes, fused)), device="cpu")
    d1.load_state_dict(d0.state_dict())
    assert d1.n_fused == (2 if fused < 0 else fused)
    gen = torch.Generator().manual_seed(4)
    x = torch.rand(3, 1024, 1, generator=gen) * 2 - 1
    lab = torch.tensor([0, 3, 1]) if num_classes else None
    shifts = torch.randint(-1, 2, (2, 3), generator=gen)
    eps = torch.rand(3, generator=gen)
    s0, gp0, g0 = _scores_and_gp(d0, x, lab, shifts, eps)
    s1, gp1, g1 = _scores_and_gp(d1, x, lab, shifts, eps)
    np.testing.assert_allclose(s1.numpy(), s0.numpy(), atol=1e-5)
    np.testing.assert_allclose(gp1.item(), gp0.item(), rtol=1e-5)
    for n in g0:
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), atol=2e-4,
                                   rtol=1e-4, err_msg=n)
    # eval form: no shuffle, so no site to fuse
    np.testing.assert_array_equal(d1(x, lab).detach().numpy(),
                                  d0(x, lab).detach().numpy())


@pytest.fixture
def recorded_shifts(monkeypatch):
    """The shifts JAX's critic draws, in site order: unfused sites through
    phase_shuffle, fused ones through sconv1d_ba (which draws its shift
    from its key, sconv.py:741)."""
    rec = []

    def record(key, b, rad):
        sh = jax.random.randint(key, (b,), -rad, rad + 1)
        jax.debug.callback(lambda v: rec.append(np.array(v)), sh,
                           ordered=True)

    orig_ps, orig_sc = jwg.phase_shuffle, jwg.sconv1d_ba

    def ps(h, key, rad, impl=None):
        record(key, h.shape[0], rad)
        return orig_ps(h, key, rad, impl=impl)

    def sc(y, w, b, key, rad, **kw):
        record(key, y.shape[0], rad)
        return orig_sc(y, w, b, key, rad, **kw)
    monkeypatch.setattr(jwg, "phase_shuffle", ps)
    monkeypatch.setattr(jwg, "sconv1d_ba", sc)
    return rec


def _close(got, want, rel=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("num_classes", [0, 4])
@pytest.mark.parametrize("fused", [-1, 1])
def test_fused_critic_matches_jax(fused, num_classes, recorded_shifts):
    """The port's fused critic against JAX's fused critic, weights through
    convert.params_from_jax, JAX's shifts injected: the score, the penalty
    and its gradient with respect to every parameter (1e-5 of the peak,
    as tests/test_torch_critic.py)."""
    cfg = _cfg(num_classes, fused)
    jd = jbuild_d(cfg)
    x = np.random.default_rng(0).uniform(-1, 1, (4, 1024, 1)).astype(
        np.float32)
    lab = np.array([0, 3, 1, 2], np.int32)
    jlab = (jnp.asarray(lab),) if num_classes else ()
    params = jd.init({"params": jax.random.key(2),
                      "phase_shuffle": jax.random.key(1)}, jnp.asarray(x),
                     *jlab)
    flat = {k: np.asarray(v) for k, v in flatten_dict(params,
                                                      sep="/").items()}
    td = build_discriminator(_port(cfg), device="cpu")
    td.load_state_dict(params_from_jax(flat))
    tlab = torch.from_numpy(lab).long() if num_classes else None
    jax.effects_barrier()
    recorded_shifts.clear()
    key = jax.random.key(5)
    want = jd.apply(params, jnp.asarray(x), *jlab, train=True,
                    rngs={"phase_shuffle": key})
    jax.effects_barrier()
    shifts = torch.from_numpy(np.stack(recorded_shifts))
    assert shifts.shape == (2, 4)
    _close(td(torch.from_numpy(x), tlab, shifts), want)

    real, fake = x, x[::-1] * 0.5
    key_eps = jax.random.key(8)

    def jloss(p):
        return jgp(lambda v: jd.apply(p, v, *jlab, train=True,
                                      rngs={"phase_shuffle": key}),
                   jnp.asarray(real), jnp.asarray(fake), key_eps)

    (jval, _), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    eps = torch.from_numpy(np.array(jax.random.uniform(
        key_eps, (4, 1, 1))).reshape(4))
    td.zero_grad()
    gp, _ = gradient_penalty([lambda v: td(v, tlab, shifts)],
                             torch.from_numpy(real),
                             torch.from_numpy(fake.copy()), eps)
    gp.backward()
    _close(gp, jval)
    ref = params_from_jax({k: np.asarray(v) for k, v in flatten_dict(
        jgrads, sep="/").items()})
    for n, p in td.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        _close(got, ref[n].numpy())


def _counting(monkeypatch, module, name):
    calls = [0]
    orig = getattr(module, name)

    def wrapped(*a, **kw):
        calls[0] += 1
        return orig(*a, **kw)
    monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("fused_views", [False, True],
                         ids=["two_views", "fused_views"])
def test_fused_step_calls_per_step(fused_views, monkeypatch):
    """One fused training step calls K6 and K7's wrappers the number of
    times chip_smoke.py holds the card to, and never the phase shuffle.
    Per critic micro-step, with V critic calls on the views (1 when the
    real and fake views go in as one 2B call, else 2): K6 (V + 2) x sites
    (the views' forwards, x-hat's forward, the penalty's double backprop)
    and K7 (V + 1) x sites (the penalty's input gradient, the loss's
    backward through the views); the G update one of each per site."""
    from audiogan_tpu_torch.train.state import create_train_state
    from audiogan_tpu_torch.train.step import build_train_step
    k6 = _counting(monkeypatch, tsconv, "sconv1d_ba")
    k7 = _counting(monkeypatch, tsconv, "sconvt1d")
    cfg = _cfg(fused=-1)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, fused_d_views=fused_views))
    pcfg = _port(cfg).validate()
    st = create_train_state(pcfg, seed=0, device="cpu")
    clips, labels = raw_batch(tiny_config(), seed=3)
    shuffles = PShuf.calls
    m = build_train_step(pcfg, device="cpu")(st, torch.from_numpy(clips),
                                             torch.from_numpy(labels))
    assert all(np.isfinite(float(v)) for v in m.values())
    sites, n_critic = len(pcfg.model.strides) - 1, pcfg.loss.n_critic
    views = 1 if fused_views else 2
    assert k6[0] == n_critic * (views + 2) * sites + sites
    assert k7[0] == n_critic * (views + 1) * sites + sites
    assert PShuf.calls == shuffles


def test_set_overrides_match_the_jax_cli():
    sets = ["model.fused_shuffle_sites=-1", "train.batch_size=16",
            "loss.gp_lambda=5.5", "model.strides=[4, 4, 2]",
            "train.fused_d_views=false", "name=custom"]
    got = apply_overrides(get_preset("tiny_sc09"), sets)
    want = jcli.apply_overrides(jax_get_preset("tiny_sc09"), sets)
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    assert got.model.fused_shuffle_sites == -1


@pytest.mark.parametrize("item", ["model.fused_shuffle_sites",
                                  "model.no_such_field=1",
                                  "nothing.here=1",
                                  "model.fused_shuffle_sites=all",
                                  "model=3"])
def test_set_rejects_bad_items(item):
    with pytest.raises(SystemExit):
        apply_overrides(get_preset("tiny_sc09"), [item])


def test_cli_trains_the_fused_critic(tmp_path, capsys):
    from audiogan_tpu_torch.cli import main
    shuffles = PShuf.calls
    assert main(["train", "--preset", "tiny_sc09", "--device", "cpu",
                 "--set", "model.fused_shuffle_sites=-1", "--steps", "2",
                 "--batch_size", "2", "--log_every", "1",
                 "--workdir", str(tmp_path)]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    steps = [ln for ln in lines if "step" in ln]
    assert [ln["step"] for ln in steps] == [1, 2]
    assert all(np.isfinite(v) for ln in steps for v in ln.values())
    # every site fused: the critic never ran the unfused shuffle
    assert PShuf.calls == shuffles
    saved = json.loads((tmp_path / "config.json").read_text())
    assert saved["model"]["fused_shuffle_sites"] == -1
