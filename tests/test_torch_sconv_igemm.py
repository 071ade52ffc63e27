"""The index arithmetic of K6's tensor-core path (the implicit GEMM of
audiogan_tpu_torch/csrc/igemm_tc.cuh with one TMA view of xp per window
offset, csrc/sconv.cu::sconv1d_tc_launch), on the CPU.

The kernel runs conv1d's plan on z (``kernels/sconv.py::sconv1d_tc_plan``)
with one A view per offset o in [0, 2 rad]: xp from row o, viewed as [B,
T/s, s, Cin] with xp's batch stride. Element b's box comes through view
offs[b] (clamped into [0, 2 rad]), so it reads exactly z[b] = xp[b,
offs[b] : offs[b] + T], and the zero fill outside [0, T/s) is the conv's
padding in z-space. Where the plan stacks short rows, each element is its
own box, through its own view, at the place the stacked box would put it;
elements past the batch are not loaded (their rows hold NaN here, as
stale shared memory, and feed only outputs the epilogue masks).

Here that plan is decoded and executed in torch, tile by tile, and held
against ``sconv1d_ba_plain`` (which tests/test_torch_sconv.py holds
against JAX's sconv1d_ba), and at one site directly against JAX's
``sconv1d_ba``; at D1-D4's widths and lengths with a small batch, at
every tile, with every offset and mixed offsets inside stacked tiles.
And the predicate sends every fused site of the flagship to the tensor
cores in bf16, none in f32.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogan_tpu.kernels import sconv as jsconv
from audiogan_tpu_torch.kernels import conv as tconv
from audiogan_tpu_torch.kernels import sconv as tsconv
from test_torch_conv_igemm import _box, _decode, _w_box

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    """Each emulation is many small products: one intra-op thread per test
    process keeps parallel test workers from oversubscribing the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_sconv",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _views(xp: torch.Tensor, rad: int, s: int) -> list[torch.Tensor]:
    """The A views: view o is xp from row o, T = tp - 2 rad rows per
    element, as [B, T/s, s, Cin]."""
    bsz, tp, cin = xp.shape
    t = tp - 2 * rad
    return [xp[:, o:o + t].reshape(bsz, t // s, s, cin)
            for o in range(2 * rad + 1)]


def _emulate_shifted(xp, offs, rad, s, w, b, plan, act, slope):
    """The kernel's grid over the plan, each element's A box read through
    its own view; returns y and how many times each output row was
    written."""
    p = _decode(plan)
    assert p["n_phase"] == 1 and p["s_out"] == 1
    nwg, _ = tconv.TC_TILES[p["tile"]]
    bm = 64 * nwg
    views = _views(xp, rad, s)
    bsz, cin, cout = xp.shape[0], xp.shape[2], w.shape[2]
    rows, nb = p["rows"], p["nb"]
    assert rows * nb <= bm and (nb == 1 or rows == p["t_lim"])
    assert nb == 1 or rows % tsconv.SCONV_TC_STACK_ROWS == 0
    n_m = -(-bsz // nb) if nb > 1 else bsz * p["n_mt"]
    y = torch.full((bsz, p["y_len"], cout), float("nan"), dtype=xp.dtype)
    writes = torch.zeros(bsz, p["y_len"], dtype=torch.long)
    steps = range(p["start"][0], p["start"][1])
    for by in range(n_m):
        if nb > 1:
            b0, t0 = by * nb, 0
        else:
            b0, t0 = by // p["n_mt"], (by % p["n_mt"]) * bm
        n_el = min(nb, bsz - b0)
        d = torch.zeros(bm, cout, dtype=xp.dtype)
        d[rows * n_el:] = float("nan")      # not loaded: stale memory
        for e in steps:
            for c0 in range(0, cin, tconv.TC_CHUNK):
                a = torch.cat([
                    _box(views[min(max(int(offs[b0 + seg]), 0), 2 * rad)],
                         b0 + seg, 1, t0 + p["row"][e], rows, p["pin"][e],
                         c0)
                    for seg in range(n_el)]).reshape(rows * n_el, -1)
                d[:rows * n_el] += a @ _w_box(w, p["tap"][e], c0)
        for r in range(bm):
            seg = r // rows
            bb, t = b0 + seg, t0 + r - seg * rows
            if seg >= nb or bb >= bsz or t >= p["t_lim"]:
                continue
            y[bb, t] = tconv._apply_act(d[r] + b, act, slope)
            writes[bb, t] += 1
    return y, writes


def _inputs(bsz, t, cin, cout, k, rad, seed):
    rng = np.random.default_rng(seed)
    xp = torch.from_numpy(rng.standard_normal((bsz, t + 2 * rad, cin)))
    w = torch.from_numpy(rng.standard_normal((k, cin, cout))
                         / np.sqrt(k * cin / 4))
    b = torch.from_numpy(rng.standard_normal(cout) * 0.5)
    return xp, w, b


def _check(bsz, t, cin, cout, k, s, rad, lo, hi, offs, tile=None,
           act="leaky_relu", seed=0):
    xp, w, b = _inputs(bsz, t, cin, cout, k, rad, seed)
    offs = torch.as_tensor(offs, dtype=torch.int32)
    plan = tsconv.sconv1d_tc_plan(bsz, t, cout, k, s, lo, hi, tile)
    y, writes = _emulate_shifted(xp, offs, rad, s, w, b, plan, act, 0.2)
    want = tsconv.sconv1d_ba_plain(xp, w, b, offs, s, lo, hi, rad, act, 0.2)
    assert y.shape == want.shape
    assert (writes == 1).all()
    # float64 on both sides: only the order of the sums differs
    torch.testing.assert_close(y, want, rtol=1e-10, atol=1e-10)
    return _decode(plan), (xp, w, b, offs, y)


def _sites(batch):
    from audiogan_tpu_torch.config import get_preset
    return _smoke().fused_site_layers(get_preset("wgan_gp_b64"), batch)


# D1-D4 at their widths and lengths with a small batch: 3 elements (D3's
# and D4's stacked tiles ragged in the batch), offsets mixed in a tile
@pytest.mark.parametrize("tile", range(len(tconv.TC_TILES)))
@pytest.mark.parametrize("site", range(4))
def test_site_plan_matches_plain(site, tile):
    L = _sites(3)[site]
    rad = L["rad"]
    offs = [(2 * i + site) % (2 * rad + 1) for i in range(3)]
    _check(3, L["t_in"], L["cin"], L["cout"], L["k"], L["s"], rad, L["lo"],
           L["hi"], offs, tile)


@pytest.mark.parametrize("off", range(5))
def test_every_offset_at_the_stacked_site(off):
    """D4 (t_out 16: stacked elements), every element at
    one offset, and a batch of 9 elements mixing all of them."""
    L = _sites(1)[3]
    _check(2, L["t_in"], L["cin"], L["cout"], L["k"], L["s"], L["rad"],
           L["lo"], L["hi"], [off, off])
    if off == 0:
        p, _ = _check(9, L["t_in"], L["cin"], L["cout"], L["k"], L["s"],
                      L["rad"], L["lo"], L["hi"], np.arange(9) % 5)
        assert p["nb"] > 1


def test_offsets_are_clamped_into_the_window():
    """offs outside [0, 2 rad] read view 0 or view 2 rad, never outside
    xp: the emulation equals the plain form at the clamped offsets."""
    L = _sites(1)[2]
    rad = L["rad"]
    xp, w, b = _inputs(3, L["t_in"], L["cin"], L["cout"], L["k"], rad, 1)
    plan = tsconv.sconv1d_tc_plan(3, L["t_in"], L["cout"], L["k"], L["s"],
                                  L["lo"], L["hi"])
    y, _ = _emulate_shifted(xp, torch.tensor([-3, 7, 2]), rad, L["s"], w, b,
                            plan, "none", 0.2)
    want = tsconv.sconv1d_ba_plain(xp, w, b, torch.tensor([0, 4, 2]),
                                   L["s"], L["lo"], L["hi"], rad)
    torch.testing.assert_close(y, want, rtol=1e-10, atol=1e-10)


def test_stacking_needs_rows_a_multiple_of_eight():
    """Short rows stack only where each element's box starts a 1024-byte
    swizzle period: t_out 12 takes one element a tile, t_out 16 eight."""
    p12 = _decode(tsconv.sconv1d_tc_plan(4, 48, 128, 25, 4, 10, 11))
    p16 = _decode(tsconv.sconv1d_tc_plan(4, 64, 128, 25, 4, 10, 11))
    assert (p12["t_lim"], p12["nb"]) == (12, 1)
    assert (p16["t_lim"], p16["nb"]) == (16, 8)
    # conv1d's own plan still stacks 12-row elements
    assert _decode(tconv.conv1d_tc_plan(4, 48, 128, 25, 4, 10, 11))["nb"] > 1
    _check(3, 48, 64, 64, 25, 4, 2, 10, 11, [4, 0, 3], tile=3)


def test_site_matches_jax():
    """D3's geometry (stacked) at a batch of 3: the emulated plan against
    JAX's sconv1d_ba on its XLA route, f32."""
    L = _sites(3)[2]
    rad = L["rad"]
    _, (xp, w, b, offs, y) = _check(3, L["t_in"], L["cin"], L["cout"],
                                    L["k"], L["s"], rad, L["lo"], L["hi"],
                                    [0, 3, 4])
    want = jsconv.sconv1d_ba_lowered(
        *(jnp.asarray(a.numpy(), jnp.float32) for a in (xp, w, b)),
        jnp.asarray(offs.numpy()), L["s"], L["lo"], L["hi"], rad,
        "leaky_relu", 0.2, impl="xla")
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_fused_sites_take_the_tensor_cores_in_bf16_only():
    """All four fused sites of the flagship, at 2B and at B, run K6 on the
    tensor cores in bf16, and none does in f32."""
    for batch in (128, 64):
        for L in _sites(batch):
            args = (L["t_in"], L["cin"], L["cout"], L["k"], L["s"],
                    L["rad"])
            assert tsconv.sconv1d_tensor_core(torch.bfloat16, *args)
            assert not tsconv.sconv1d_tensor_core(torch.float32, *args)


@pytest.mark.parametrize("dtype,t,cin,cout,k,s,rad,want", [
    (torch.bfloat16, 64, 64, 64, 25, 4, 4, True),     # nine views
    (torch.bfloat16, 64, 64, 64, 25, 4, 5, False),    # eleven views
    (torch.bfloat16, 66, 64, 64, 25, 4, 2, False),    # t % s
    (torch.bfloat16, 64, 32, 64, 25, 4, 2, False),    # Cin < 64
    (torch.bfloat16, 64, 64, 60, 25, 4, 2, False),    # Cout < 64
    (torch.float16, 64, 64, 64, 25, 4, 2, False),
], ids=str)
def test_dispatch_predicate(dtype, t, cin, cout, k, s, rad, want):
    assert tsconv.sconv1d_tensor_core(dtype, t, cin, cout, k, s, rad) is want
