"""audiogan_tpu_torch's GRU scan (K4, K5), cell and generator against the
JAX package's.

The scan's plain forms are held against ``gru_scan`` run as the Pallas
kernel in interpret mode (``_INTERPRET`` set as tests/pallas/conftest.py
sets it), not against the XLA scan: in bf16 the kernel carries h and feat
in f32 and rounds only what it writes out, the XLA scan carries bf16.
Tolerances: f32 1e-5 of the peak (the same sums in another order); bf16
one bf16 ulp of the peak (the same f32 values before the one rounding of
the output); gradients 1e-5 relative to each tensor's largest in f32, and
one bf16 ulp of it in bf16. The generator is held against the flax
GRUGenerator on carried weights (f32, 1e-5) and against the golden
``gru.npy``.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import audiogan_tpu.kernels.gru as jgru
from audiogan_tpu.models import build_generator as jax_build_generator
from audiogan_tpu.models.gru import factorize_stride as jax_factorize_stride
from audiogan_tpu.ops.gru import gru_cell as jax_gru_cell
from audiogan_tpu.train.state import create_train_state
from audiogan_tpu_torch.config import Config, get_preset
from audiogan_tpu_torch.convert import params_from_jax
from audiogan_tpu_torch.kernels import gru as tgru
from audiogan_tpu_torch.models import build_generator
from audiogan_tpu_torch.models.gru import GRUGenerator, factorize_stride
from audiogan_tpu_torch.models.init import init_params
from audiogan_tpu_torch.ops.gru import gru_cell
from audiogan_tpu_torch.train.sample import generate

from helpers_golden import case_gru

GOLDEN_DIR = Path(__file__).parent / "golden" / "data"
BF16_ULP = 2.0 ** -7          # spacing of bf16 in [1, 2)

# (B, H, F, n_frames): the small scans, and case_gru's (H 16, F 16, 16
# frames)
SCANS = [(3, 16, 8, 8), (3, 16, 8, 40), (2, 16, 16, 16)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jgru, "_INTERPRET", True)


def _ulp(peak: float) -> float:
    """One bf16 ulp at |peak|."""
    return BF16_ULP * 2.0 ** np.floor(np.log2(max(peak, 1e-30)))


def _scan_inputs(b, hid, feat, seed=0):
    """numpy f32 inputs at the model's scales: h0 = tanh(.), glorot-sized
    weights, small biases."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return [np.tanh(r(b, hid)), r(b, feat), r(2 * feat, 3 * hid, scale=0.3),
            r(hid, 3 * hid, scale=0.3), r(3 * hid, scale=0.1),
            r(3 * hid, scale=0.1), r(feat, feat, scale=0.3),
            r(hid, feat, scale=0.3), r(feat, scale=0.1)]


def _both(args, dname):
    """The same values for both packages, rounded to the dtype once."""
    jdt, tdt = DTYPES[dname]
    ja = [jnp.asarray(a).astype(jdt) for a in args]
    ta = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
          for a in ja]
    return ja, ta


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tol(want: np.ndarray, dname: str, f32_rel: float = 1e-5) -> float:
    peak = float(np.abs(want).max())
    return f32_rel * peak if dname == "f32" else _ulp(peak)


@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("shape", SCANS, ids=str)
def test_scan_plain_matches_jax_kernel(shape, dname):
    b, hid, feat, n = shape
    ja, ta = _both(_scan_inputs(b, hid, feat), dname)
    want = _f32(jgru.gru_scan(*ja, n))
    got = tgru.gru_scan_fwd(*ta, n)
    assert got.dtype == ta[0].dtype and got.shape == (b, n, feat)
    err = np.abs(_f32(got) - want).max()
    assert err <= _tol(want, dname), err


@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_scan_with_h_matches_jax_kernel(dname):
    b, hid, feat, n = SCANS[1]
    ja, ta = _both(_scan_inputs(b, hid, feat, seed=1), dname)
    want_out, want_nbf, want_h = jgru._gru_scan_impl(*ja, n, with_h=True)
    out, h_seq = tgru.gru_scan_fwd(*ta, n, with_h=True)
    assert h_seq.shape == (n, b, hid) and h_seq.dtype == ta[0].dtype
    for got, want in ((out, _f32(want_out)), (h_seq, _f32(want_h)),
                      (out.transpose(0, 1), _f32(want_nbf))):
        err = np.abs(_f32(got) - want).max()
        assert err <= _tol(want, dname), err
    plain = tgru.gru_scan_fwd(*ta, n)
    assert torch.equal(plain, out)


def _jax_grads(ja, n, ct):
    ct = jnp.asarray(ct)
    return jax.grad(
        lambda *a: jnp.sum(jgru.gru_scan(*a, n).astype(jnp.float32) * ct),
        argnums=tuple(range(9)))(*ja)


@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("shape", SCANS, ids=str)
def test_scan_backward_matches_jax_grad(shape, dname):
    """K5's plain form and GruScan.backward against jax.grad through the
    interpret-mode kernel (its custom_vjp runs _gru_scan_bwd_kernel),
    all nine gradients."""
    b, hid, feat, n = shape
    ja, ta = _both(_scan_inputs(b, hid, feat, seed=2), dname)
    ct = np.random.default_rng(3).standard_normal((b, n, feat)).astype(
        np.float32)
    want = [_f32(g) for g in _jax_grads(ja, n, ct)]
    leaves = [t.clone().requires_grad_() for t in ta]
    out = tgru.gru_scan(*leaves, n)
    assert out.grad_fn is not None
    (out.float() * torch.from_numpy(ct)).sum().backward()
    out_h, h_seq = tgru.gru_scan_fwd(*ta, n, with_h=True)
    g_ct = torch.from_numpy(ct).to(ta[0].dtype)
    plain = tgru.gru_scan_bwd_plain(g_ct, *ta, out_h, h_seq)
    assert len(plain) == 9
    for i, (name, w) in enumerate(zip(tgru.ARG_NAMES, want)):
        for got in (leaves[i].grad, plain[i]):
            assert got.dtype == ta[i].dtype and got.shape == ta[i].shape
            err = np.abs(_f32(got) - w).max()
            assert err <= _tol(w, dname), (name, err)


def test_scan_gradcheck_f64():
    """GruScan's backward (K5's plain form) against finite differences of
    its forward, float64."""
    b, hid, feat, n = 2, 4, 3, 5
    args = [torch.from_numpy(a).double().requires_grad_()
            for a in _scan_inputs(b, hid, feat, seed=4)]
    assert torch.autograd.gradcheck(
        lambda *a: tgru.GruScan.apply(*a, n), args, eps=1e-6, atol=1e-6)


def test_scan_without_grad_records_no_history():
    _, ta = _both(_scan_inputs(2, 8, 4), "f32")
    leaves = [t.requires_grad_() for t in ta]
    with torch.no_grad():
        assert tgru.gru_scan(*leaves, 3).grad_fn is None
    assert tgru.gru_scan(*leaves, 3).grad_fn is not None


def test_scan_rejects_bad_shapes():
    _, ta = _both(_scan_inputs(2, 8, 4), "f32")
    with pytest.raises(ValueError, match="w_i"):
        tgru.gru_scan_fwd(ta[0], ta[1], ta[2][:-1], *ta[3:], 3)
    with pytest.raises(ValueError, match="n_frames"):
        tgru.gru_scan_fwd(*ta, 0)
    meta = [t.to("meta") for t in ta]
    with pytest.raises(ValueError, match="no gru_scan kernel"):
        tgru.gru_scan_fwd(*meta, 3)


def test_cell_matches_jax():
    rng = np.random.default_rng(5)
    b, d_in, hid = 4, 12, 8
    x, h = (rng.standard_normal(s).astype(np.float32)
            for s in ((b, d_in), (b, hid)))
    w_i = (rng.standard_normal((d_in, 3 * hid)) * 0.3).astype(np.float32)
    w_h = (rng.standard_normal((hid, 3 * hid)) * 0.3).astype(np.float32)
    b_i, b_h = (rng.standard_normal(3 * hid).astype(np.float32) * 0.1
                for _ in range(2))
    want = np.asarray(jax_gru_cell(*(jnp.asarray(a) for a in (
        x, h, w_i, w_h, b_i, b_h))))
    got = gru_cell(*(torch.from_numpy(a) for a in (x, h, w_i, w_h, b_i,
                                                   b_h)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_factorize_stride():
    for n in (64, 48, 7, 100, 11):
        assert factorize_stride(n) == jax_factorize_stride(n)


def _gru_cfg(num_classes=0):
    cfg = case_gru()
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, num_classes=num_classes))


def _port(cfg) -> Config:
    return Config.from_json(cfg.to_json()).validate()


def _carried(cfg, seed=0):
    params_g = create_train_state(cfg, seed=seed).params_g
    flat = {k: np.asarray(v)
            for k, v in flatten_dict(params_g, sep="/").items()}
    return params_g, flat, params_from_jax(flat)


@pytest.mark.parametrize("num_classes", [0, 4])
def test_generator_matches_jax(num_classes):
    cfg = _gru_cfg(num_classes)
    params_g, _, sd = _carried(cfg)
    rng = np.random.default_rng(6)
    z = rng.standard_normal((3, cfg.model.latent_dim)).astype(np.float32)
    labels = np.array([0, 3, 1], np.int32) if num_classes else None
    args = (jnp.asarray(z),) + ((jnp.asarray(labels),) if num_classes
                                else ())
    want = np.asarray(jax_build_generator(cfg).apply(params_g, *args))
    g = build_generator(_port(cfg), device="cpu")
    assert isinstance(g, GRUGenerator)
    g.load_state_dict(sd)             # strict: every name must line up
    with torch.no_grad():
        got = g(torch.from_numpy(z),
                None if labels is None else torch.from_numpy(labels).long())
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_generate_matches_golden():
    """The port's sampler on JAX's weights and z draw reproduces
    tests/golden/data/gru.npy (test_golden.py's case)."""
    cfg = case_gru()
    _, _, sd = _carried(cfg)
    z = np.asarray(jax.random.normal(jax.random.key(123),
                                     (2, cfg.model.latent_dim)))
    got = generate(_port(cfg), sd, num=2, seed=123, device="cpu", z=z)
    golden = np.load(GOLDEN_DIR / "gru.npy")
    np.testing.assert_allclose(got, golden, atol=1e-5, rtol=1e-4)


def test_convert_round_trips_the_flax_tree():
    """params_from_jax carries every flax GRUGenerator param, by name and
    value, into the port's state dict."""
    cfg = _gru_cfg(num_classes=4)
    _, flat, sd = _carried(cfg)
    g = build_generator(_port(cfg), device="cpu")
    assert {k: tuple(v.shape) for k, v in g.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    def name(k):
        return k.removeprefix("params/").replace("/", ".")
    assert set(sd) == {name(k) for k in flat}
    for k, v in flat.items():
        assert np.array_equal(sd[name(k)].numpy(), v), k
    bare = params_from_jax({k.removeprefix("params/"): v
                            for k, v in flat.items()})
    assert all(torch.equal(bare[k], sd[k]) for k in sd)


def test_init_is_orthogonal_gru_w_h_and_zero_gru_biases():
    cfg = _port(_gru_cfg(num_classes=4))
    a = init_params(build_generator(cfg, device="cpu"), seed=0)
    b = init_params(build_generator(cfg, device="cpu"), seed=0)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    w = a.gru_w_h.detach()
    hid = w.shape[0]
    assert w.shape == (hid, 3 * hid)
    torch.testing.assert_close(w @ w.T, torch.eye(hid), atol=1e-5, rtol=0)
    for name in ("gru_b_i", "gru_b_h", "frame_out_bias", "init_state.bias",
                 "cond_proj.bias", "up_0_bias"):
        assert not a.get_parameter(name).any(), name
    for name in ("gru_w_i", "ar_proj", "frame_out", "up_0_kernel",
                 "label_embed.embedding"):
        t = a.get_parameter(name).detach()
        rf = int(np.prod(t.shape[:-2]))
        limit = np.sqrt(6.0 / (rf * (t.shape[-2] + t.shape[-1])))
        assert 0.5 * limit < float(t.abs().max()) <= limit, name


def test_full_width_generator_geometry():
    """cond_gru_sc09: 256 frames of F=256, upsampled 4-4-4 through
    128 and 64 channels to one."""
    g = build_generator(get_preset("cond_gru_sc09"), device="meta")
    assert g.n_frames == 256 and g.strides == (4, 4, 4)
    assert g.gru_w_i.shape == (512, 1536) and g.gru_w_h.shape == (512, 1536)
    assert [tuple(getattr(g, f"up_{i}_kernel").shape) for i in range(3)] == \
        [(25, 256, 128), (25, 128, 64), (25, 64, 1)]
    assert g.dtype == torch.bfloat16 and g.num_classes == 10
