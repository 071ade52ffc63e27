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


def _emulate_tensor_core_cell(x, h, w_i, w_h, b_i, b_h):
    """The order of K3's tensor-core path (csrc/gru_cell.cu,
    gru_cell_tc_kernel) in torch, from the plan the kernel is launched
    with: per unit tile of GRU_CELL_UNITS columns, each cluster rank's
    f32 sums over its k-steps of 16 (x's against w_i, then h's against
    w_h; r and z over both, i_n over x's, h_n over h's), the ranks'
    partials added in rank order, the biases and gates in f32, one
    rounding of h'. Columns no unit tile owns stay NaN."""
    b, in_dim = x.shape
    hid = h.shape[1]
    units, split, kx, kt, *start = tgru.gru_cell_plan(b, in_dim, hid).tolist()
    assert units == tgru.GRU_CELL_UNITS and len(start) == split + 1
    f = [t.float() for t in (x, h, w_i, w_h, b_i, b_h)]
    x32, h32, wi, wh, bi, bh = f
    out = torch.full((b, hid), float("nan"))
    for j0 in range(0, hid, units):
        j = torch.arange(j0, min(j0 + units, hid))
        parts = []
        for q in range(split):
            acc = torch.zeros(4, b, len(j))
            for s in range(start[q], start[q + 1]):
                part, k0 = (0, 16 * s) if s < kx else (1, 16 * (s - kx))
                a, w = (x32, wi) if part == 0 else (h32, wh)
                a, w = a[:, k0:k0 + 16], w[k0:k0 + 16]
                acc[0] += a @ w[:, j]
                acc[1] += a @ w[:, hid + j]
                acc[2 + part] += a @ w[:, 2 * hid + j]
            parts.append(acc)
        tot = parts[0]
        for p in parts[1:]:
            tot = tot + p
        r = torch.sigmoid(tot[0] + bi[j] + bh[j])
        z = torch.sigmoid(tot[1] + bi[hid + j] + bh[hid + j])
        n = torch.tanh(tot[2] + bi[2 * hid + j]
                       + r * (tot[3] + bh[2 * hid + j]))
        out[:, j] = (1 - z) * n + z * h32[:, j]
    return out.to(x.dtype)


def test_tensor_core_plan_emulation_matches_plain_and_jax():
    """cond_gru_sc09's cell (B 64, in = H = 512), bf16: the tensor-core
    path's order, emulated from its plan, against the plain form and the
    Pallas cell (interpret mode) and the XLA cell in bf16, each within one
    bf16 ulp of the peak (the same f32 values, summed in another order,
    before the one rounding of h'). And a ragged cell (B 7, in 24, H 40:
    part-filled k-steps and unit tiles) against the plain form."""
    args = _params(7, 64, 512, 512, 0.05)
    targs = [torch.from_numpy(a).bfloat16() for a in args]
    got = _emulate_tensor_core_cell(*targs)
    assert got.dtype == torch.bfloat16 and not got.float().isnan().any()
    plain = tgru.gru_cell_plain(*targs)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args]
    for want in (plain.float().numpy(),
                 np.asarray(jax_pallas_cell(*jargs), np.float32)):
        peak = np.abs(want).max()
        ulp = 2.0 ** (np.floor(np.log2(peak)) - 7)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=ulp)
    xla = np.asarray(jax_xla_cell(*jargs), np.float32)
    # the XLA cell rounds its gate products to bf16: a few ulps
    np.testing.assert_allclose(got.float().numpy(), xla, rtol=0,
                               atol=2e-2 * np.abs(xla).max())
    ragged = [torch.from_numpy(a).bfloat16() for a in _params(8, 7, 24, 40)]
    want = tgru.gru_cell_plain(*ragged).float()
    ulp = 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)
    torch.testing.assert_close(_emulate_tensor_core_cell(*ragged).float(),
                               want, rtol=0, atol=ulp)


@pytest.mark.parametrize("shape", [(64, 512, 512), (7, 24, 40), (1, 512, 512),
                                   (33, 520, 264), (130, 48, 16),
                                   (17, 1, 7)], ids=str)
def test_tensor_core_plan_covers_the_depth_once(shape):
    """Every k-step of x || h belongs to exactly one cluster rank, every
    rank has one, the split is a cluster's (at most 8) and the grid fills
    the card where the width allows: 32 unit tiles x 8 ranks at
    cond_gru_sc09's cell."""
    b, in_dim, hid = shape
    units, split, kx, kt, *start = tgru.gru_cell_plan(b, in_dim, hid).tolist()
    assert (units, kx, kt) == (16, -(-in_dim // 16),
                               -(-in_dim // 16) + -(-hid // 16))
    assert 1 <= split <= tgru.GRU_CELL_MAX_SPLIT and len(start) == split + 1
    assert start[0] == 0 and start[-1] == kt
    assert all(a < b_ for a, b_ in zip(start, start[1:]))
    tiles = -(-hid // 16)
    assert (tiles * split >= tgru.GRU_CELL_MIN_BLOCKS
            or split == tgru.GRU_CELL_MAX_SPLIT or 2 * split > kt)
    if shape == (64, 512, 512):
        assert (tiles, split) == (32, 8)


@pytest.mark.parametrize("dtype,b,in_dim,hid,want", [
    (torch.bfloat16, 64, 512, 512, True),    # cond_gru_sc09's cell
    (torch.bfloat16, 1, 512, 512, True),
    (torch.bfloat16, 7, 24, 40, True),       # ragged tiles
    (torch.bfloat16, 65, 512, 512, False),   # five m-tiles
    (torch.bfloat16, 64, 20, 512, False),    # in % 8
    (torch.bfloat16, 64, 512, 33, False),    # H % 8
    (torch.float32, 64, 512, 512, False),    # f32: the CUDA cores
    (torch.float16, 64, 512, 512, False),
], ids=str)
def test_tensor_core_predicate(dtype, b, in_dim, hid, want):
    assert tgru.gru_cell_tensor_core(dtype, b, in_dim, hid) is want
