"""audiogan_tpu_torch's fused GRU cell (K3) against the JAX package's.

``ops/gru.py::gru_cell(impl="pallas")`` runs ``kernels/gru.py::GruCell``:
on a CPU tensor the plain form of K3 forward and the reference's
``_gru_bwd2`` backward. Both are held against
``audiogan_tpu.kernels.gru_cell`` (the Pallas cell in interpret mode, as
tests/pallas/conftest.py runs it) and the XLA cell, at the shapes and
tolerances of tests/pallas/test_gru_kernel.py (forward 1e-5 absolute,
gradients 1e-4 absolute and relative), plus one case at cond_gru_sc09's
cell width (x [64, 512], h [64, 512], w_i and w_h [512, 1536]) in f32.
bf16 inputs: the kernel and its plain form widen to f32 and round h'
once, so the two agree within one bf16 ulp of the peak.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiogan_tpu.kernels.gru as jkgru
from audiogan_tpu.kernels import gru_cell as jax_pallas_cell
from audiogan_tpu.ops.gru import gru_cell as jax_xla_cell
from audiogan_tpu_torch.kernels import gru as tgru
from audiogan_tpu_torch.ops.gru import gru_cell


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setattr(jkgru, "_INTERPRET", True)


def _params(seed, b=8, in_dim=32, hid=64, w_scale=0.2):
    """tests/pallas/test_gru_kernel.py's _params, as numpy arrays."""
    rng = np.random.default_rng(seed)

    def r(*s):
        return rng.standard_normal(s).astype(np.float32)
    return (r(b, in_dim), r(b, hid), r(in_dim, 3 * hid) * w_scale,
            r(hid, 3 * hid) * w_scale, r(3 * hid) * 0.1, r(3 * hid) * 0.1)


# (b, in, H, weight scale): the reference's forward and gradient shapes,
# and cond_gru_sc09's cell (glorot-sized weights at that width)
SHAPES = {"ref_fwd": (8, 32, 64, 0.2), "ref_grad": (4, 16, 32, 0.2),
          "cond_gru_sc09": (64, 512, 512, 0.05)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cell_matches_jax(shape):
    b, in_dim, hid, scale = SHAPES[shape]
    args = _params(0, b, in_dim, hid, scale)
    jargs = [jnp.asarray(a) for a in args]
    before = tgru.gru_cell_fwd.launches
    got = gru_cell(*(torch.from_numpy(a) for a in args), impl="pallas")
    assert tgru.gru_cell_fwd.launches == before   # CPU: the plain form
    assert got.dtype == torch.float32 and got.shape == (b, hid)
    for want in (jax_pallas_cell(*jargs), jax_xla_cell(*jargs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cell_grads_match_jax(shape):
    """GruCell's six gradients (the reference's _gru_bwd2 in torch)
    against jax.grad of the Pallas cell's custom_vjp and of the XLA cell,
    with a non-trivial cotangent."""
    b, in_dim, hid, scale = SHAPES[shape]
    args = _params(1, b, in_dim, hid, scale)
    ct = np.random.default_rng(2).standard_normal((b, hid)).astype(
        np.float32)
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = gru_cell(*targs, impl="pallas")
    got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), targs)
    for cell in (jax_pallas_cell, jax_xla_cell):
        want = jax.grad(lambda *a: jnp.sum(cell(*a) * jnp.asarray(ct)),
                        argnums=tuple(range(6)))(*jargs)
        for name, g, w in zip(tgru.CELL_ARG_NAMES, got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                       rtol=1e-4, err_msg=name)


def test_cell_bf16_matches_jax_pallas():
    """bf16 inputs: K3 widens to f32 and rounds h' once, as the Pallas
    kernel does, so the two agree within one bf16 ulp of the peak."""
    args = _params(3)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args]
    want = np.asarray(jax_pallas_cell(*jargs), np.float32)
    got = gru_cell(*(torch.from_numpy(a).bfloat16() for a in args),
                   impl="pallas")
    assert got.dtype == torch.bfloat16
    peak = np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(peak)) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=ulp)


def test_cell_gradcheck_float64():
    """GruCell's backward against finite differences (the plain forms keep
    float64), to second order: the backward is plain torch ops."""
    gen = torch.Generator().manual_seed(0)
    b, in_dim, hid = 3, 4, 5
    shapes = [(b, in_dim), (b, hid), (in_dim, 3 * hid), (hid, 3 * hid),
              (3 * hid,), (3 * hid,)]
    args = [torch.randn(*s, generator=gen, dtype=torch.float64) * 0.5
            for s in shapes]
    args = [a.requires_grad_(True) for a in args]
    fn = tgru.GruCell.apply
    assert torch.autograd.gradcheck(fn, args)
    assert torch.autograd.gradgradcheck(fn, args)


def test_xla_impl_is_the_plain_cell_and_others_raise():
    args = [torch.from_numpy(a) for a in _params(4)]
    np.testing.assert_allclose(gru_cell(*args).numpy(),
                               gru_cell(*args, impl="pallas").numpy(),
                               atol=1e-6)
    with pytest.raises(ValueError, match="impl"):
        gru_cell(*args, impl="cudnn")
    with pytest.raises(ValueError, match="w_h"):
        tgru.gru_cell_fwd(*args[:3], args[3][:, :-1], *args[4:])


def test_recurrence_matches_jax():
    """A short recurrence through the fused cell (what chip_smoke.py runs
    at full width), forward and backward, against a lax.scan of the Pallas
    cell."""
    b, in_dim, hid, n = 4, 16, 32, 6
    x0, h0, w_i, w_h, b_i, b_h = _params(5, b, in_dim, hid)
    xs = np.random.default_rng(6).standard_normal((n, b, in_dim)).astype(
        np.float32)

    def jrun(xs, h, w_i, w_h):
        def body(h, x):
            h = jax_pallas_cell(x, h, w_i, w_h, jnp.asarray(b_i),
                                jnp.asarray(b_h))
            return h, None
        h, _ = jax.lax.scan(body, h, xs)
        return jnp.sum(h * h)

    jval, jgrads = jax.value_and_grad(jrun, argnums=(0, 1, 2, 3))(
        jnp.asarray(xs), jnp.asarray(h0), jnp.asarray(w_i), jnp.asarray(w_h))
    targs = [torch.from_numpy(a).requires_grad_(True)
             for a in (xs, h0, w_i, w_h)]
    h = targs[1]
    for t in range(n):
        h = gru_cell(targs[0][t], h, targs[2], targs[3],
                     torch.from_numpy(b_i), torch.from_numpy(b_h),
                     impl="pallas")
    val = (h * h).sum()
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    for g, w in zip(torch.autograd.grad(val, targs), jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)
