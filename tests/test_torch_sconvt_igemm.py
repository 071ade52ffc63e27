"""The index arithmetic of K7's tensor-core path (the implicit GEMM of
audiogan_tpu_torch/csrc/igemm_tc.cuh with the placed epilogue,
csrc/sconv.cu::sconvt1d_tc_launch), on the CPU.

The kernel runs K1's convT plan on ct itself (K1's view [B, T', 1, Cc]);
``kernels/sconv.py::sconvt1d_tc_plan`` appends the output pitch t + 2 rad.
Its epilogue stores output row yr of element b at row yr + off_b, off_b =
offs[b] clamped into [0, 2 rad], with no bias and no activation; the block
of phase 0 and m-tile 0 writes the 2 rad rows outside each window as zeros,
for every element of a stacked tile and its own N columns.

Here that plan is decoded and executed in torch, block by block as the
kernel's grid runs it, on an output filled with NaN, with a map that
counts the writes of every output element: each must be written exactly
once, and no write may fall outside the output. The result is held
against ``sconvt1d_plain`` (float64 on both sides: only the order of the
sums differs, 1e-10), and at one site against JAX's ``sconvt1d_lowered``
on its XLA route (float32, 1e-4). D1-D4's dx widths and lengths at a
small batch, every tile, every offset, mixed offsets inside the stacked
tiles and wild offsets. And the predicate sends every fused site of the
flagship to the tensor cores in bf16, none in f32.
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
    spec = importlib.util.spec_from_file_location("chip_smoke_for_sconvt",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _emulate_placed(ct, offs, rad, wf, plan):
    """The kernel's grid over the placed plan; returns the output (NaN
    where nothing was written) and how many times each element was
    written."""
    p = _decode(plan)
    n_ph, n = p["n_phase"], p["n_steps"]
    assert len(plan) == 9 + n_ph + 1 + 3 * n + 1
    pitch = int(plan[-1])
    assert pitch == p["y_len"] + 2 * rad
    nwg, bn = tconv.TC_TILES[p["tile"]]
    bm = 64 * nwg
    bsz, t_in, cc = ct.shape
    co = wf.shape[2]
    a4 = ct.view(bsz, t_in, 1, cc)
    rows, nb = p["rows"], p["nb"]
    assert rows * nb <= bm and (nb == 1 or rows == p["t_lim"])
    n_m = -(-bsz // nb) if nb > 1 else bsz * p["n_mt"]
    n_ot = -(-co // bn)
    y = torch.full((bsz, pitch, co), float("nan"), dtype=ct.dtype)
    writes = torch.zeros(bsz, pitch, co, dtype=torch.long)

    def store(b, row, o0, vals):
        o1 = min(o0 + bn, co)
        assert 0 <= b < bsz and 0 <= row < pitch and 0 <= o0 < co
        y[b, row, o0:o1] = vals[:o1 - o0]
        writes[b, row, o0:o1] += 1

    def off_of(b):
        return min(max(int(offs[b]), 0), 2 * rad)

    for phase in range(n_ph):
        steps = range(p["start"][phase], p["start"][phase + 1])
        for by in range(n_m):
            if nb > 1:
                b0, t0 = by * nb, 0
            else:
                b0, t0 = by // p["n_mt"], (by % p["n_mt"]) * bm
            n_el = min(nb, bsz - b0)
            if phase == 0 and t0 == 0:
                # the zero rows, each block its own columns
                zeros = ct.new_zeros(bn)
                for ot in range(n_ot):
                    for seg in range(n_el):
                        off = off_of(b0 + seg)
                        for zr in range(2 * rad):
                            row = zr if zr < off else p["y_len"] + zr
                            store(b0 + seg, row, ot * bn, zeros)
            d = torch.zeros(bm, co, dtype=ct.dtype)
            d[rows * nb:] = float("nan")      # stale shared memory
            for e in steps:
                for c0 in range(0, cc, tconv.TC_CHUNK):
                    a = _box(a4, b0, nb, t0 + p["row"][e], rows, p["pin"][e],
                             c0).reshape(rows * nb, -1)
                    d[:rows * nb] += a @ _w_box(wf, p["tap"][e], c0)
            for r in range(bm):
                seg = r // rows
                b, t = b0 + seg, t0 + r - seg * rows
                yr = t * p["s_out"] + phase
                if (seg >= nb or b >= bsz or t >= p["t_lim"]
                        or yr >= p["y_len"]):
                    continue
                for ot in range(n_ot):
                    store(b, yr + off_of(b), ot * bn, d[r, ot * bn:])
    return y, writes


def _inputs(bsz, t_in, cc, co, k, seed):
    rng = np.random.default_rng(seed)
    ct = torch.from_numpy(rng.standard_normal((bsz, t_in, cc)))
    wf = torch.from_numpy(rng.standard_normal((k, cc, co))
                          / np.sqrt(k * cc / 4))
    return ct, wf


def _check(L, bsz, offs, tile=None, seed=0, want_offs=None):
    """Emulates K7 at dx geometry L; every element written once, equal to
    the plain form at want_offs (the clamped offsets; offs by default)."""
    rad = L["rad"]
    ct, wf = _inputs(bsz, L["t_in"], L["cin"], L["cout"], L["k"], seed)
    offs = torch.as_tensor(offs, dtype=torch.int32)
    plan = tsconv.sconvt1d_tc_plan(bsz, L["cout"], L["k"], L["s"],
                                   L["pad_lo"], L["out_len"], rad, tile)
    y, writes = _emulate_placed(ct, offs, rad, wf, plan)
    want = tsconv.sconvt1d_plain(
        ct, wf, offs if want_offs is None else torch.as_tensor(want_offs),
        L["s"], L["pad_lo"], L["out_len"], rad)
    assert y.shape == want.shape
    assert (writes == 1).all(), (writes == 0).sum().item()
    torch.testing.assert_close(y, want, rtol=1e-10, atol=1e-10)
    return _decode(plan), (ct, wf, offs, y)


def _sites(batch):
    from audiogan_tpu_torch.config import get_preset
    return _smoke().fused_site_dx_layers(get_preset("wgan_gp_b64"), batch)


# D1-D4's x-gradients at their widths and lengths with a small batch: 3
# elements (D3's and D4's stacked tiles ragged in the batch), offsets
# mixed in a tile
@pytest.mark.parametrize("tile", range(len(tconv.TC_TILES)))
@pytest.mark.parametrize("site", range(4))
def test_site_plan_matches_plain(site, tile):
    L = _sites(3)[site]
    offs = [(2 * i + site) % (2 * L["rad"] + 1) for i in range(3)]
    _check(L, 3, offs, tile)


@pytest.mark.parametrize("off", range(5))
def test_every_offset_at_the_stacked_site(off):
    """D4 (16 rows per phase: stacked elements), every element at one
    offset, and a batch of 9 elements mixing all of them in one tile."""
    L = _sites(1)[3]
    _check(L, 2, [off, off])
    if off == 0:
        p, _ = _check(L, 9, np.arange(9) % 5)
        assert p["nb"] > 1


def test_wild_offsets_are_clamped_and_stay_inside_the_output():
    """offs outside [0, 2 rad] place the window at 0 or 2 rad: every write
    lands inside the output (the emulation asserts it), once, and the
    result equals the plain form at the clamped offsets; in a stacked
    tile (D4) and an unstacked one (D2)."""
    for site, bsz in ((3, 4), (1, 3)):
        L = _sites(1)[site]
        wild = [-3, 9, 2, 0][:bsz]
        _check(L, bsz, wild, seed=1,
               want_offs=np.clip(wild, 0, 2 * L["rad"]).astype(np.int32))


def test_site_matches_jax():
    """D4's geometry (stacked) at a batch of 3: the emulated plan against
    JAX's sconvt1d on its XLA route, f32."""
    L = _sites(3)[3]
    _, (ct, wf, offs, y) = _check(L, 3, [0, 3, 4], seed=2)
    want = jsconv.sconvt1d_lowered(
        jnp.asarray(ct.numpy(), jnp.float32),
        jnp.asarray(wf.numpy(), jnp.float32), jnp.asarray(offs.numpy()),
        L["s"], L["pad_lo"], L["out_len"], L["rad"], impl="xla")
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_plan_is_convt_plan_with_the_pitch():
    """K7's plan is K1's for the same convT, then t + 2 rad; cached and
    read-only as conv1d's and convT's are."""
    plan = tsconv.sconvt1d_tc_plan(128, 512, 25, 4, 13, 64, 2)
    base = tconv.convt_tc_plan(128, 512, 25, 4, 13, 64)
    np.testing.assert_array_equal(plan[:-1], base)
    assert plan[-1] == 68 and not plan.flags.writeable
    assert tsconv.sconvt1d_tc_plan(128, 512, 25, 4, 13, 64, 2) is plan


def test_fused_sites_take_the_tensor_cores_in_bf16_only():
    """All four fused sites' x-gradients of the flagship, at 2B and at B,
    run K7 on the tensor cores in bf16, and none does in f32."""
    for batch in (128, 64):
        for L in _sites(batch):
            args = (L["cin"], L["cout"], L["k"], L["s"], L["rad"])
            assert tsconv.sconvt1d_tensor_core(torch.bfloat16, *args)
            assert not tsconv.sconvt1d_tensor_core(torch.float32, *args)


@pytest.mark.parametrize("dtype,cc,co,k,s,rad,want", [
    (torch.bfloat16, 128, 64, 25, 4, 2, True),
    (torch.bfloat16, 128, 64, 25, 4, 0, True),       # no zero rows
    (torch.bfloat16, 128, 64, 25, 4, -1, False),
    (torch.bfloat16, 32, 64, 25, 4, 2, False),       # Cc < 64
    (torch.bfloat16, 128, 60, 25, 4, 2, False),      # Co < 64
    (torch.bfloat16, 128, 68, 25, 4, 2, False),      # Co % 8
    (torch.bfloat16, 128, 64, 25, 17, 2, False),     # over 16 phases
    (torch.float16, 128, 64, 25, 4, 2, False),
], ids=str)
def test_dispatch_predicate(dtype, cc, co, k, s, rad, want):
    assert tsconv.sconvt1d_tensor_core(dtype, cc, co, k, s, rad) is want
