"""audiogan_tpu_torch's conv1d (K1') against the JAX package's.

The plain form (the conv1d kernel's oracle, and what a CPU tensor runs) is
held against the JAX function on the same numpy inputs through both JAX
tiers: impl="xla" and impl="pallas" in interpret mode (as
tests/pallas/conftest.py runs it), for SAME and explicit pads, strides 2
and 4, every activation. Geometries of the Pallas tier keep
min(Cin, Cout) >= 32 so the Pallas body really runs (conv.py MIN_CH).
Tolerance: 1e-5 absolute and relative in f32 (the same sums in another
order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiogan_tpu.kernels.conv as jconv
from audiogan_tpu_torch.kernels import conv as tconv
from audiogan_tpu_torch.ops import conv as tops

# name -> (k, stride, t_in, cin, cout, padding)
GEOMS = {
    "k25_s4_same": (25, 4, 64, 32, 40, "SAME"),
    "k25_s4_dx_pads": (25, 4, 44, 32, 33, (12, 9)),
    "k9_s2_same": (9, 2, 30, 33, 32, "SAME"),
    "k9_s4_hi0": (9, 4, 37, 32, 32, (4, 0)),
    "k25_s4_short": (25, 4, 16, 48, 64, "SAME"),   # t_out 4: collapse tier
}
ACTS = ["none", "relu", "leaky_relu", "tanh"]
TOL = dict(atol=1e-5, rtol=1e-5)


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
def test_conv1d_ba_matches_jax(geom, act, impl, monkeypatch):
    monkeypatch.setattr(jconv, "_INTERPRET", True)
    k, s, t_in, cin, cout, padding = GEOMS[geom]
    x, w, b = _inputs(k, t_in, cin, cout)
    want = np.asarray(jconv.conv1d_ba(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=s,
        padding=padding, act=act, slope=0.2, impl=impl))
    lo, hi = tconv.conv1d_pads(t_in, k, s, padding)
    before = tconv.conv1d_ba.launches
    got = tconv.conv1d_ba(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), s, lo, hi, act, 0.2)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # a CPU tensor takes the plain form: no kernel launch is counted
    assert tconv.conv1d_ba.launches == before


@pytest.mark.parametrize("t_in,k,s", [(16384, 25, 4), (4096, 25, 4),
                                      (64, 25, 4), (37, 9, 2), (5, 9, 4),
                                      (30, 3, 1)])
def test_same_pads_match_jax(t_in, k, s):
    assert tconv._same_pads(t_in, k, s) == jconv._same_pads(t_in, k, s)
    if (t_in, k, s) == (16384, 25, 4):
        # asymmetric: not torch's padding=12
        assert tconv._same_pads(t_in, k, s) == (4096, 10, 11)


@pytest.mark.parametrize("padding", ["SAME", (3, 5), (0, 0)])
def test_ops_seams_match_jax(padding):
    import audiogan_tpu.ops.conv as jops
    x, w, b = _inputs(9, 33, 6, 7, seed=2)
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    want = np.asarray(jconv.conv1d(jnp.asarray(x), jnp.asarray(w), stride=4,
                                   padding=padding, impl="xla"))
    np.testing.assert_allclose(
        tops.conv1d(xt, wt, 4, padding).numpy(), want, **TOL)
    want = np.asarray(jconv.conv1d_ba(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=4,
        padding=padding, act="leaky_relu", slope=0.2, impl="xla"))
    got = tops.conv1d_ba(xt, wt, bt, 4, padding, act="leaky_relu")
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    if padding == "SAME":
        want = np.asarray(jops.conv1d(jnp.asarray(x), jnp.asarray(w),
                                      stride=4))
        np.testing.assert_allclose(tops.conv1d(xt, wt, 4).numpy(), want,
                                   **TOL)


def test_bf16_input_gives_bf16_output():
    x, w, b = _inputs(25, 40, 8, 4)
    args = (4, 10, 11, "leaky_relu", 0.2)
    got = tconv.conv1d_ba(*(torch.from_numpy(a).bfloat16()
                            for a in (x, w, b)), *args)
    assert got.dtype == torch.bfloat16
    ref = tconv.conv1d_ba(*(torch.from_numpy(a).bfloat16().float()
                            for a in (x, w, b)), *args)
    # one rounding of the output to 8 bits
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(),
                               atol=2e-2 * float(ref.abs().max()))


@pytest.mark.parametrize("bad", ["x_rank", "channels", "bias", "pads",
                                 "too_short", "stride", "act", "padding"])
def test_wrapper_rejects_bad_arguments(bad):
    x, w, b = torch.zeros(1, 8, 3), torch.zeros(5, 3, 2), torch.zeros(2)
    kw = dict(stride=2, pad_lo=1, pad_hi=1)
    if bad == "x_rank":
        x = torch.zeros(8, 3)
    elif bad == "channels":
        w = torch.zeros(5, 4, 2)
    elif bad == "bias":
        b = torch.zeros(3)
    elif bad == "pads":
        kw["pad_lo"] = -1
    elif bad == "too_short":
        x = torch.zeros(1, 2, 3)
        kw.update(pad_lo=0, pad_hi=0)
    elif bad == "stride":
        kw["stride"] = 0
    elif bad == "act":
        kw["act"] = "gelu"
    if bad == "padding":
        with pytest.raises(ValueError):
            tops.conv1d(x, w, 2, "VALID")
        return
    with pytest.raises(ValueError):
        tconv.conv1d_ba(x, w, b, **kw)
