"""audiogan_tpu_torch's conv-transpose against the JAX package's.

The port's plain form (the CUDA kernel's oracle, and what a CPU tensor
runs) is held against the JAX function on the same numpy inputs, through
both JAX tiers: impl="xla" and impl="pallas" in interpret mode (as
tests/pallas/conftest.py runs it). Every geometry has min(Cin, Cout) >= 32
so the Pallas body really runs (conv.py MIN_CH).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiogan_tpu.kernels.conv as jconv
import audiogan_tpu.ops.conv as jops
from audiogan_tpu_torch.kernels import conv as tconv
from audiogan_tpu_torch.ops import conv as tops

# name -> (k, stride, t_in, cin, cout)
GEOMS = {
    "k25_s4": (25, 4, 6, 32, 48),
    # pad_lo=4: the geometry the TPU's lhs_dilation lowering miscompiled
    "k9_s4": (9, 4, 7, 40, 32),
    "k25_s7": (25, 7, 5, 32, 33),
    "k25_s5": (25, 5, 4, 33, 32),
    "k9_s3": (9, 3, 6, 32, 40),
}
ACTS = ["none", "relu", "leaky_relu", "tanh"]


def _inputs(k, t_in, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, t_in, cin)).astype(np.float32)
    w = (rng.standard_normal((k, cin, cout)) / np.sqrt(k * cin / 4)
         ).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32) * 0.5
    return x, w, b


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_convt_ba_matches_jax(geom, act, impl, monkeypatch):
    monkeypatch.setattr(jconv, "_INTERPRET", True)
    k, s, t_in, cin, cout = GEOMS[geom]
    x, w, b = _inputs(k, t_in, cin, cout)
    want = np.asarray(jconv.conv_transpose1d_ba(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=s, act=act,
        slope=0.2, impl=impl))
    before = tconv.conv_transpose1d_ba.launches
    got = tconv.conv_transpose1d_ba(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        stride=s, act=act, slope=0.2)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (2, t_in * s, cout)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # a CPU tensor takes the plain form: no kernel launch is counted
    assert tconv.conv_transpose1d_ba.launches == before


@pytest.mark.parametrize("pad_lo,out_len", [(0, 20), (3, 23), (8, 26)])
def test_convt_explicit_geometry_matches_jax(pad_lo, out_len):
    """pad_lo / out_len other than the defaults, incl. out_len % s != 0."""
    x, w, b = _inputs(9, 6, 8, 5, seed=1)
    want = np.asarray(jconv.conv_transpose1d_ba(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=4,
        pad_lo=pad_lo, out_len=out_len, act="leaky_relu", slope=0.3,
        impl="xla"))
    got = tconv.conv_transpose1d_ba(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        stride=4, pad_lo=pad_lo, out_len=out_len, act="leaky_relu",
        slope=0.3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_ops_seam_matches_jax():
    x, w, b = _inputs(25, 5, 6, 7, seed=2)
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    want = np.asarray(jops.conv_transpose1d(jnp.asarray(x), jnp.asarray(w),
                                            stride=4))
    np.testing.assert_allclose(tops.conv_transpose1d(xt, wt, 4).numpy(),
                               want, atol=1e-5, rtol=1e-5)
    want = np.asarray(jops.conv_transpose1d_ba(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=4,
        act="tanh"))
    np.testing.assert_allclose(
        tops.conv_transpose1d_ba(xt, wt, bt, 4, act="tanh").numpy(),
        want, atol=1e-5, rtol=1e-5)


def test_leaky_relu_keeps_zero():
    """_apply_act's convention: where(r >= 0, r, slope*r)."""
    r = torch.tensor([-2.0, -0.0, 0.0, 3.0])
    got = tconv._apply_act(r, "leaky_relu", 0.5)
    assert got.tolist() == [-1.0, 0.0, 0.0, 3.0]


def test_phase_taps_match_jax():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((25, 3, 2)).astype(np.float32)
    for s, pad_lo in [(4, 12), (4, 4), (7, 12), (3, 0)]:
        want, jq_min, jq = jconv._convt_phase_taps(jnp.asarray(w), s, pad_lo)
        got, q_min, q = tconv._convt_phase_taps(torch.from_numpy(w), s,
                                                pad_lo)
        assert (q_min, q) == (jq_min, jq)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bf16_input_gives_bf16_output():
    x, w, b = _inputs(25, 4, 8, 4)
    got = tconv.conv_transpose1d_ba(
        *(torch.from_numpy(a).bfloat16() for a in (x, w, b)), stride=4,
        act="relu")
    assert got.dtype == torch.bfloat16
    ref = tconv.conv_transpose1d_ba(
        *(torch.from_numpy(a).bfloat16().float() for a in (x, w, b)),
        stride=4, act="relu")
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(),
                               atol=2e-2 * float(ref.abs().max()))


@pytest.mark.parametrize("bad", ["x_rank", "channels", "bias", "pad_lo",
                                 "stride", "act"])
def test_wrapper_rejects_bad_arguments(bad):
    x = torch.zeros(1, 4, 3)
    w = torch.zeros(5, 3, 2)
    b = torch.zeros(2)
    kw = dict(stride=2)
    if bad == "x_rank":
        x = torch.zeros(4, 3)
    elif bad == "channels":
        w = torch.zeros(5, 4, 2)
    elif bad == "bias":
        b = torch.zeros(3)
    elif bad == "pad_lo":
        kw["pad_lo"] = 5
    elif bad == "stride":
        kw["stride"] = 0
    elif bad == "act":
        kw["act"] = "gelu"
    with pytest.raises(ValueError):
        tconv.conv_transpose1d_ba(x, w, b, **kw)
