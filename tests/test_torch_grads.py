"""First- and second-order gradients of the port's autograd Functions
(kernels/autograd.py, ops/phase_shuffle.py) against jax.grad of the JAX
package's primitives (kernels/primitives.py, the pshuf pair), and
torch.autograd.gradcheck / gradgradcheck in float64.

On the CPU every Function runs its kernels' plain forms; the same
Functions launch the kernels on the card (tests/test_torch_cuda.py).
Tolerance against JAX: 1e-5 relative to the largest gradient (f32, the
same sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiogan_tpu.kernels.conv as jconv
from audiogan_tpu.ops.phase_shuffle import pshuf_prim
from audiogan_tpu_torch.kernels import autograd as kad
from audiogan_tpu_torch.ops.phase_shuffle import PShuf, PShufT, phase_shuffle

REL = 1e-5


def _close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def _arrays(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# name -> (k, stride, t_in, cin, cout, padding)
CONV_GEOMS = {"k5_s2_same": (5, 2, 12, 3, 4, "SAME"),
              "k9_s4_dx": (9, 4, 21, 2, 3, (4, 0)),
              "k25_s4_same": (25, 4, 32, 2, 3, "SAME")}


def _jax_and_torch_conv(geom, act):
    k, s, t_in, cin, cout, padding = CONV_GEOMS[geom]
    from audiogan_tpu_torch.kernels.conv import conv1d_pads
    lo, hi = conv1d_pads(t_in, k, s, padding)

    def jf(x, w, b):
        return jconv.conv1d_ba(x, w, b, stride=s, padding=padding, act=act,
                               slope=0.2, impl="xla")

    def tf(x, w, b):
        return kad.Conv1dBA.apply(x, w, b, s, lo, hi, act, 0.2)
    return (k, cin, cout, t_in), jf, tf


def _jax_and_torch_convt(geom, act):
    k, s, t_in, cin, cout, _ = CONV_GEOMS[geom]
    pad_lo, out_len = (k - 1) // 2, t_in * s

    def jf(x, w, b):
        return jconv.conv_transpose1d_ba(x, w, b, stride=s, act=act,
                                         slope=0.2, impl="xla")

    def tf(x, w, b):
        return kad.ConvTBA.apply(x, w, b, s, pad_lo, out_len, act, 0.2)
    return (k, cin, cout, t_in), jf, tf


@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu", "tanh"])
@pytest.mark.parametrize("geom", sorted(CONV_GEOMS))
@pytest.mark.parametrize("kind", ["conv1d", "convt"])
def test_first_and_second_order_match_jax(kind, geom, act):
    make = _jax_and_torch_conv if kind == "conv1d" else _jax_and_torch_convt
    (k, cin, cout, t_in), jf, tf = make(geom, act)
    x, w, b = _arrays([(2, t_in, cin), (k, cin, cout), (cout,)])
    w = w / np.sqrt(k * cin)
    r = _arrays([jf(x, w, b).shape], seed=1)[0]

    def jloss(x, w, b):
        return jnp.sum(jf(x, w, b) * r)

    def jloss2(x, w, b):
        gx = jax.grad(jloss)(x, w, b)
        return jnp.sum(jnp.square(gx)) + jnp.sum(jnp.tanh(gx) * x)

    j1 = jax.grad(jloss, argnums=(0, 1, 2))(x, w, b)
    j2 = jax.grad(jloss2, argnums=(0, 1, 2))(x, w, b)

    xt, wt, bt = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    loss = (tf(xt, wt, bt) * torch.from_numpy(r)).sum()
    t1 = torch.autograd.grad(loss, (xt, wt, bt), create_graph=True)
    loss2 = t1[0].square().sum() + (torch.tanh(t1[0]) * xt).sum()
    t2 = torch.autograd.grad(loss2, (xt, wt, bt), allow_unused=True,
                             materialize_grads=True)
    for got, want in zip(t1 + t2, j1 + j2):
        _close(got, want)


@pytest.mark.parametrize("rad", [1, 2])
def test_pshuf_grads_match_jax(rad):
    x, r = _arrays([(3, 9, 2), (3, 9, 2)])
    shifts = np.array([-rad, 0, rad])
    offs = rad - shifts

    def jloss(x):
        y = pshuf_prim(x, jnp.asarray(offs, jnp.int32), rad=rad)
        return jnp.sum(jnp.sin(y) * r)

    def jloss2(x):
        return jnp.sum(jnp.square(jax.grad(jloss)(x)) * r)

    xt = torch.tensor(x, requires_grad=True)
    y = phase_shuffle(xt, torch.from_numpy(shifts), rad)
    _close(y, pshuf_prim(jnp.asarray(x), jnp.asarray(offs, jnp.int32),
                         rad=rad))
    (g1,) = torch.autograd.grad((torch.sin(y) * torch.from_numpy(r)).sum(),
                                xt, create_graph=True)
    _close(g1, jax.grad(jloss)(x))
    (g2,) = torch.autograd.grad((g1.square() * torch.from_numpy(r)).sum(),
                                xt)
    _close(g2, jax.grad(jloss2)(x))


def test_pshuft_is_the_adjoint():
    x, ct = _arrays([(4, 7, 3), (4, 7, 3)])
    offs = torch.tensor([0, 1, 3, 4])
    xt, ctt = torch.from_numpy(x).double(), torch.from_numpy(ct).double()
    lhs = (PShuf.apply(xt, offs, 2) * ctt).sum()
    rhs = (xt * PShufT.apply(ctt, offs, 2)).sum()
    assert abs(float(lhs - rhs)) < 1e-12


# --- gradcheck / gradgradcheck in float64 -------------------------------------

def _f64(*shapes, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g, dtype=torch.float64,
                        requires_grad=True) for s in shapes]


CASES = {
    "conv1d": lambda: (kad.Conv1d.apply, _f64((2, 11, 2), (5, 2, 3)),
                       (2, 2, 1)),
    "convt": lambda: (kad.ConvT.apply, _f64((2, 5, 2), (5, 2, 3)),
                      (2, 2, 10)),
    "convt_ragged": lambda: (kad.ConvT.apply, _f64((2, 4, 2), (5, 2, 3)),
                             (3, 1, 11)),
    "conv1d_ba_tanh": lambda: (kad.Conv1dBA.apply,
                               _f64((2, 11, 2), (5, 2, 3), (3,)),
                               (2, 2, 2, "tanh", 0.2)),
    "conv1d_ba_leaky": lambda: (kad.Conv1dBA.apply,
                                _f64((2, 11, 2), (5, 2, 3), (3,)),
                                (2, 2, 2, "leaky_relu", 0.2)),
    "convt_ba_tanh": lambda: (kad.ConvTBA.apply,
                              _f64((2, 5, 2), (5, 2, 3), (3,)),
                              (2, 2, 10, "tanh", 0.2)),
    "conv1d_wgrad": lambda: (kad.Conv1dWgrad.apply,
                             _f64((2, 11, 2), (2, 5, 3)), (2, 2, 1, 5)),
    "convt_wgrad": lambda: (kad.ConvTWgrad.apply,
                            _f64((2, 5, 2), (2, 10, 3)), (2, 2, 10, 5)),
    "pshuf": lambda: (PShuf.apply, _f64((3, 6, 2)),
                      (torch.tensor([0, 2, 4]), 2)),
    "pshuft": lambda: (PShufT.apply, _f64((3, 6, 2)),
                       (torch.tensor([1, 3, 0]), 2)),
}


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gradcheck_float64(case, order):
    fn, tensors, static = CASES[case]()

    def f(*ts):
        return fn(*ts, *static)
    check = (torch.autograd.gradcheck if order == 1
             else torch.autograd.gradgradcheck)
    assert check(f, tuple(tensors), eps=1e-6, atol=1e-5, rtol=1e-4)


def test_inner_grad_skips_unrequested_weight_grads(monkeypatch):
    """autograd.grad with respect to x alone computes no weight gradient
    (the penalty's inner grad); .backward over every input still does."""
    calls = []
    real = kad.conv1d_wgrad
    monkeypatch.setattr(kad, "conv1d_wgrad",
                        lambda *a: calls.append(1) or real(*a))
    x = torch.randn(2, 12, 2, requires_grad=True)
    w = torch.randn(5, 2, 3, requires_grad=True)
    b = torch.zeros(3, requires_grad=True)
    y = kad.Conv1dBA.apply(kad.as_compute(x, torch.float32),
                           kad.as_compute(w, torch.float32),
                           kad.as_compute(b, torch.float32), 2, 2, 1,
                           "leaky_relu", 0.2)
    torch.autograd.grad(y.sum(), x, retain_graph=True)
    assert calls == []
    y.sum().backward()
    assert calls == [1] and w.grad is not None


@pytest.mark.parametrize("callers", [False, True])
def test_wgrad_asks_cudnn_for_deterministic_algorithms(monkeypatch, callers):
    """The weight gradient runs with cuDNN's deterministic algorithms (the
    default ones sum in a run-dependent order on the card) and gives the
    caller's setting back."""
    seen = []
    real = torch.nn.grad.conv1d_weight

    def spy(*a, **k):
        seen.append(torch.backends.cudnn.deterministic)
        return real(*a, **k)
    monkeypatch.setattr(torch.nn.grad, "conv1d_weight", spy)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = callers
    try:
        x, ct = _f64((2, 11, 2), (2, 5, 3))
        kad.conv1d_wgrad(x, ct, 2, 2, 5)
        assert torch.backends.cudnn.deterministic is callers
    finally:
        torch.backends.cudnn.deterministic = saved
    assert seen == [True]
