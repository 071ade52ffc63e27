"""The index arithmetic of the tensor-core path of K1' and K1 (the
implicit GEMM of audiogan_tpu_torch/csrc/igemm_tc.cuh), on the CPU.

The kernel does no tap arithmetic of its own: it runs the int32 plan that
kernels/conv.py builds (``conv1d_tc_plan``, ``convt_tc_plan``). Here that
very plan is decoded and executed in torch, tile by tile as the kernel's
grid runs it: a TMA box read with zero fill outside the tensor, a product
per k-step and 64-channel chunk, the sum over k-steps, the epilogue's
masks and (for convT) the phase scatter. Rows of a tile that hold no
batch element's data are filled with NaN, so an output that reads them
shows. The result is held against the plain forms, which the other
tests hold against JAX. And the dispatch predicate sends the flagship's
and music_44k_dp16's (strides 7/7/5/5/3) main-path geometries where they
belong, with k-step tables inside the kernel's limits.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from audiogan_tpu_torch.kernels import conv as tconv

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _decode(plan: np.ndarray) -> dict:
    """The fields of tc_plan's array, in the order csrc/igemm_tc.cuh reads
    them."""
    head = ("tile", "rows", "nb", "n_mt", "t_lim", "s_out", "y_len",
            "n_phase", "n_steps")
    p = dict(zip(head, plan[:len(head)].tolist()))
    n_ph, n = p["n_phase"], p["n_steps"]
    rest = plan[len(head):].tolist()
    p["start"] = rest[:n_ph + 1]
    p["tap"] = rest[n_ph + 1:n_ph + 1 + n]
    p["row"] = rest[n_ph + 1 + n:n_ph + 1 + 2 * n]
    p["pin"] = rest[n_ph + 1 + 2 * n:n_ph + 1 + 3 * n]
    return p


def _box(a4: torch.Tensor, b0: int, nb: int, r0: int, rows: int, pin: int,
         c0: int) -> torch.Tensor:
    """TMA's box {64 ch, 1 phase, rows, nb} at (c0, pin, r0, b0) of the view
    a4 [B, a_rows, a_phases, Cin], zero outside it -> [nb, rows, 64]."""
    bsz, a_rows, _, cin = a4.shape
    out = a4.new_zeros(nb, rows, tconv.TC_CHUNK)
    bs = slice(b0, min(b0 + nb, bsz))
    lo, hi = max(r0, 0), min(r0 + rows, a_rows)
    c1 = min(c0 + tconv.TC_CHUNK, cin)
    if bs.stop > bs.start and hi > lo:
        out[:bs.stop - b0, lo - r0:hi - r0, :c1 - c0] = \
            a4[bs, lo:hi, pin, c0:c1]
    return out


def _w_box(w: torch.Tensor, tap: int, c0: int) -> torch.Tensor:
    """The B box: w[tap, c0:c0+64, :], zero past Cin -> [64, Cout]."""
    out = w.new_zeros(tconv.TC_CHUNK, w.shape[2])
    c1 = min(c0 + tconv.TC_CHUNK, w.shape[1])
    out[:c1 - c0] = w[tap, c0:c1]
    return out


def _emulate(a4, w, b, plan, act, slope):
    """The kernel's grid over the plan; returns y and how many times each
    output row was written."""
    p = _decode(plan)
    nwg, _ = tconv.TC_TILES[p["tile"]]
    bm = 64 * nwg
    bsz, cin, cout = a4.shape[0], a4.shape[3], w.shape[2]
    rows, nb = p["rows"], p["nb"]
    assert rows * nb <= bm and (nb == 1 or rows == p["t_lim"])
    n_m = -(-bsz // nb) if nb > 1 else bsz * p["n_mt"]
    y = torch.full((bsz, p["y_len"], cout), float("nan"), dtype=a4.dtype)
    writes = torch.zeros(bsz, p["y_len"], dtype=torch.long)
    for phase in range(p["n_phase"]):
        steps = range(p["start"][phase], p["start"][phase + 1])
        for by in range(n_m):
            if nb > 1:
                b0, t0 = by * nb, 0
            else:
                b0, t0 = by // p["n_mt"], (by % p["n_mt"]) * bm
            d = torch.zeros(bm, cout, dtype=a4.dtype)
            d[rows * nb:] = float("nan")      # stale shared memory
            for e in steps:
                for c0 in range(0, cin, tconv.TC_CHUNK):
                    a = _box(a4, b0, nb, t0 + p["row"][e], rows, p["pin"][e],
                             c0).reshape(rows * nb, -1)
                    d[:rows * nb] += a @ _w_box(w, p["tap"][e], c0)
            for r in range(bm):
                seg = r // rows
                bb, t = b0 + seg, t0 + r - seg * rows
                yr = t * p["s_out"] + phase
                if (seg >= nb or bb >= bsz or t >= p["t_lim"]
                        or yr >= p["y_len"]):
                    continue
                y[bb, yr] = tconv._apply_act(d[r] + b, act, slope)
                writes[bb, yr] += 1
    return y, writes


def _inputs(bsz, t_in, cin, cout, k, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((bsz, t_in, cin)))
    w = torch.from_numpy(rng.standard_normal((k, cin, cout))
                         / np.sqrt(k * cin / 4))
    b = torch.from_numpy(rng.standard_normal(cout) * 0.5)
    return x, w, b


def _check_conv1d(bsz, t_in, cin, cout, k, s, lo, hi, act="leaky_relu",
                  tile=None, seed=0):
    x, w, b = _inputs(bsz, t_in, cin, cout, k, seed)
    plan = tconv.conv1d_tc_plan(bsz, t_in, cout, k, s, lo, hi, tile)
    y, writes = _emulate(x.view(bsz, t_in // s, s, cin), w, b, plan, act,
                         0.3)
    want = tconv.conv1d_ba_plain(x, w, b, s, lo, hi, act, 0.3)
    assert y.shape == want.shape
    assert (writes == 1).all()
    # float64 on both sides: only the order of the sums differs
    torch.testing.assert_close(y, want, rtol=1e-10, atol=1e-10)
    return _decode(plan)


def _check_convt(bsz, t_in, cin, cout, k, s, pad_lo, out_len, act="relu",
                 tile=None, seed=0):
    x, w, b = _inputs(bsz, t_in, cin, cout, k, seed)
    plan = tconv.convt_tc_plan(bsz, cout, k, s, pad_lo, out_len, tile)
    y, writes = _emulate(x.view(bsz, t_in, 1, cin), w, b, plan, act, 0.3)
    want = tconv.conv_transpose1d_ba_plain(x, w, b, s, pad_lo, out_len, act,
                                           0.3)
    assert y.shape == want.shape
    assert (writes == 1).all()
    torch.testing.assert_close(y, want, rtol=1e-10, atol=1e-10)
    return _decode(plan)


def _flagship(preset: str = "wgan_gp_b64"):
    smoke = _load("chip_smoke_for_tests", ROOT / "chip_smoke.py")
    from audiogan_tpu_torch.config import get_preset
    cfg = get_preset(preset)
    b = smoke.BATCH
    return {"convt1d": smoke.generator_layers(cfg, b)
            + smoke.critic_dx_layers(cfg, 2 * b),
            "conv1d": smoke.critic_layers(cfg, 2 * b)
            + smoke.generator_dx_layers(cfg, b)}


def _tc(family: str, L: dict) -> bool:
    if family == "conv1d":
        return tconv.conv1d_tensor_core(torch.bfloat16, L["t_in"], L["cin"],
                                        L["cout"], L["k"], L["s"])
    return tconv.convt_tensor_core(torch.bfloat16, L["cin"], L["cout"],
                                   L["k"], L["s"])


def test_flagship_dispatch_takes_the_tensor_cores_at_sixteen_of_twenty():
    """wgan_gp_b64, bf16: every layer with Cin, Cout >= 64 on the tensor
    cores; D0 fwd, G4 dx (one channel in), G4 fwd and D0 dx (one out) on
    the CUDA-core kernels. f32 never takes the tensor cores."""
    layers = _flagship()
    got = {L["name"]: _tc(fam, L) for fam, ls in layers.items() for L in ls}
    assert len(got) == 20
    assert sorted(n for n, tc in got.items() if not tc) == \
        ["D0 dx", "D0 fwd", "G4 dx", "G4 fwd"]
    for L in layers["conv1d"]:
        assert not tconv.conv1d_tensor_core(torch.float32, L["t_in"],
                                            L["cin"], L["cout"], L["k"],
                                            L["s"])
    for L in layers["convt1d"]:
        assert not tconv.convt_tensor_core(torch.float32, L["cin"],
                                           L["cout"], L["k"], L["s"])


def test_music_dispatch_and_k_step_tables():
    """music_44k_dp16 (strides 7, 7, 5, 5, 3; T = 176400 down to 48), bf16:
    the same 16 of 20 geometries on the tensor cores as the flagship's,
    every conv1d with T % s == 0, every convT with at most 7 phases, and
    every plan's k-step table (25 steps, one per tap) inside TC_MAX_STEPS
    and TC_MAX_PHASES, its grid filling the card, and its tile M = 128
    but at t_lim = 144 (tc_tile's padded-rows clause)."""
    layers = _flagship("music_44k_dp16")
    got = {L["name"]: _tc(fam, L) for fam, ls in layers.items() for L in ls}
    assert len(got) == 20
    assert sorted(n for n, tc in got.items() if not tc) == \
        ["D0 dx", "D0 fwd", "G4 dx", "G4 fwd"]
    assert all(L["t_in"] % L["s"] == 0 for L in layers["conv1d"])
    assert sorted({L["s"] for ls in layers.values() for L in ls}) == [3, 5, 7]
    for fam, ls in layers.items():
        for L in ls:
            if not _tc(fam, L):
                continue
            if fam == "conv1d":
                plan = tconv.conv1d_tc_plan(L["b"], L["t_in"], L["cout"],
                                            L["k"], L["s"], L["lo"], L["hi"])
            else:
                plan = tconv.convt_tc_plan(L["b"], L["cout"], L["k"], L["s"],
                                           L["pad_lo"], L["out_len"])
            p = _decode(plan)
            assert p["n_steps"] == 25 <= tconv.TC_MAX_STEPS, L["name"]
            assert p["n_phase"] == (1 if fam == "conv1d" else L["s"])
            assert p["n_phase"] <= tconv.TC_MAX_PHASES
            assert sorted(p["tap"]) == list(range(25))
            blocks = tconv.tc_tile_shape(L["b"], p["t_lim"], p["n_phase"],
                                         L["cout"], p["tile"])[3]
            assert blocks >= tconv.TC_MIN_BLOCKS, (L["name"], p, blocks)
            # 64-row tiles only where 128-row ones would pad 144 rows to
            # 256 (D3 fwd and D3 dx)
            assert tconv.TC_TILES[p["tile"]][0] == (
                1 if p["t_lim"] == 144 else 2), L["name"]


@pytest.mark.parametrize("dtype,cin,cout,t_in,k,s,conv1d,convt", [
    (torch.bfloat16, 72, 136, 64, 25, 4, True, True),  # ragged chunks
    (torch.bfloat16, 32, 128, 64, 25, 4, False, False),    # Cin < 64
    (torch.bfloat16, 128, 32, 64, 25, 4, False, False),    # Cout < 64
    (torch.bfloat16, 100, 128, 64, 25, 4, False, False),   # Cin % 8
    (torch.bfloat16, 128, 130, 64, 25, 4, False, False),   # Cout % 8
    (torch.bfloat16, 128, 128, 66, 25, 4, False, True),    # T % s
    (torch.bfloat16, 128, 128, 64, 65, 1, False, False),   # K > 64 steps
    (torch.bfloat16, 128, 128, 68, 25, 17, True, False),   # s > 16 phases
    (torch.float16, 128, 128, 64, 25, 4, False, False),
    (torch.float32, 128, 128, 64, 25, 4, False, False),
], ids=str)
def test_dispatch_predicate(dtype, cin, cout, t_in, k, s, conv1d, convt):
    assert tconv.conv1d_tensor_core(dtype, t_in, cin, cout, k, s) is conv1d
    assert tconv.convt_tensor_core(dtype, cin, cout, k, s) is convt


def test_ksteps_tables():
    """conv1d: one k-step per tap, j - pad_lo = qq*s + pp. convT at k=25,
    s=4, pad 12: 25 of the 28 (tau, rho) pairs are real taps, each tap in
    exactly one phase."""
    steps = tconv.conv1d_ksteps(25, 4, 10)
    assert [j for j, _, _ in steps] == list(range(25))
    assert all(qq * 4 + pp == j - 10 and 0 <= pp < 4 for j, qq, pp in steps)
    phases = tconv.convt_ksteps(25, 4, 12)
    q_min, q_taps = tconv._convt_phase_range(25, 4, 12)
    assert q_taps * 4 == 28
    assert sum(len(ph) for ph in phases) == 25
    assert sorted(j for ph in phases for j, _, _ in ph) == list(range(25))
    for rho, ph in enumerate(phases):
        for j, q, pin in ph:
            assert j == 12 - rho + q * 4 and pin == 0
    # a stride above K: phases without a tap
    assert [len(ph) for ph in tconv.convt_ksteps(9, 16, 4)].count(0) == 7


def test_plans_of_the_flagship_fill_the_card():
    """Each main-path tensor-core geometry at full batch: the plan's tile,
    its stacking of short rows, and a grid that leaves at most a quarter
    of the SMs idle."""
    for fam, ls in _flagship().items():
        for L in ls:
            if not _tc(fam, L):
                continue
            if fam == "conv1d":
                plan = tconv.conv1d_tc_plan(L["b"], L["t_in"], L["cout"],
                                            L["k"], L["s"], L["lo"], L["hi"])
            else:
                plan = tconv.convt_tc_plan(L["b"], L["cout"], L["k"], L["s"],
                                           L["pad_lo"], L["out_len"])
            p = _decode(plan)
            rows, nb, n_mt, blocks = tconv.tc_tile_shape(
                L["b"], p["t_lim"], p["n_phase"], L["cout"], p["tile"])
            assert (rows, nb, n_mt) == (p["rows"], p["nb"], p["n_mt"])
            assert blocks >= tconv.TC_MIN_BLOCKS, (L["name"], p, blocks)
            # N = 64 where Cout is 64 (G3 fwd, D1 dx), else 128
            assert tconv.TC_TILES[p["tile"]][1] == (64 if L["cout"] <= 64
                                                    else 128)
            if p["t_lim"] == 16:
                assert nb == 64 * tconv.TC_TILES[p["tile"]][0] // 16
            assert p["n_steps"] == 25


# The flagship's main-path tensor-core geometries, at batch 2 (3 for the
# short rows, so a stacked tile is ragged in the batch): G0-G3 fwd and
# D1-D4 dx (convT), D1-D4 fwd and G0-G3 dx (conv1d, pads below SAME)
def _flagship_tc_small():
    out = []
    for fam, ls in _flagship().items():
        for L in ls:
            if _tc(fam, L):
                out.append((fam, dict(L, b=3 if L["t_in"] <= 64 else 2)))
    return out


@pytest.mark.parametrize("fam,L", _flagship_tc_small(),
                         ids=lambda v: v["name"] if isinstance(v, dict)
                         else v)
def test_flagship_geometry_plan_matches_plain(fam, L):
    if fam == "conv1d":
        _check_conv1d(L["b"], L["t_in"], L["cin"], L["cout"], L["k"],
                      L["s"], L["lo"], L["hi"], L["act"])
    else:
        _check_convt(L["b"], L["t_in"], L["cin"], L["cout"], L["k"], L["s"],
                     L["pad_lo"], L["out_len"], L["act"])


# narrow cases of each class: short rows stacked (nb > 1) with a ragged
# batch, ragged m / Cout / channel chunk, pads below SAME, out_len % s,
# convT phases that skip taps or have none, and every tile
@pytest.mark.parametrize("tile", range(len(tconv.TC_TILES)))
@pytest.mark.parametrize("geom", [
    (5, 64, 64, 72, 25, 4, 10, 11),     # t_out 16: stacked, ragged Cout
    (3, 80, 72, 64, 25, 4, 10, 11),     # t_out 20: 3 (or 6) per tile
    (2, 600, 64, 64, 25, 4, 12, 9),     # ragged m tiles, hi below SAME
    (2, 70, 64, 64, 9, 2, 4, 0),        # stride 2, no right pad
    (2, 40, 64, 64, 5, 1, 2, 2),        # stride 1
    (2, 336, 64, 64, 25, 7, 12, 12),    # music strides: 7, 5 and 3
    (3, 240, 64, 64, 25, 5, 12, 12),
    (2, 144, 64, 64, 25, 3, 11, 12),
], ids=str)
def test_conv1d_plan_matches_plain(geom, tile):
    p = _check_conv1d(*geom, tile=tile, act="tanh")
    if geom[1] == 64:
        assert p["nb"] > 1


@pytest.mark.parametrize("tile", range(len(tconv.TC_TILES)))
@pytest.mark.parametrize("geom", [
    (5, 16, 64, 72, 25, 4, 12, 64),     # m_out 16: stacked, ragged Cout
    (2, 70, 72, 64, 25, 4, 12, 280),    # ragged m and channel chunk
    (2, 10, 64, 64, 9, 4, 3, 38),       # out_len % s != 0
    (2, 21, 64, 80, 25, 7, 12, 147),    # stride 7
    (2, 5, 64, 64, 9, 16, 4, 80),       # phases with no tap: bias only
    (2, 48, 64, 64, 25, 7, 12, 336),    # music strides: 7, 5 and 3
    (3, 16, 64, 64, 25, 5, 12, 80),
    (2, 48, 64, 64, 25, 3, 12, 144),
], ids=str)
def test_convt_plan_matches_plain(geom, tile):
    _check_convt(*geom, tile=tile, act="leaky_relu")


def _card_tests():
    return _load("test_torch_cuda_geoms", ROOT / "tests" / "test_torch_cuda.py")


def _card_conv1d_tc():
    return [g for g in _card_tests().CONV1D_GEOMS
            if tconv.conv1d_tensor_core(torch.bfloat16, g[2], g[3], g[4],
                                        g[0], g[1])]


def _card_convt_tc():
    return [g for g in _card_tests().GEOMS
            if tconv.convt_tensor_core(torch.bfloat16, g[3], g[4], g[0],
                                       g[1])]


@pytest.mark.parametrize("geom", _card_conv1d_tc(), ids=str)
def test_card_conv1d_geometry_plan_matches_plain(geom):
    """Each CONV1D_GEOMS entry of the card tests that the dispatch sends
    to the tensor cores, at the card tests' batch of 3."""
    k, s, t_in, cin, cout, lo, hi = geom
    _check_conv1d(3, t_in, cin, cout, k, s, lo, hi)


@pytest.mark.parametrize("geom", _card_convt_tc(), ids=str)
def test_card_convt_geometry_plan_matches_plain(geom):
    k, s, t_in, cin, cout, pad_lo, out_len = geom
    _check_convt(3, t_in, cin, cout, k, s,
                 (k - 1) // 2 if pad_lo is None else pad_lo,
                 t_in * s if out_len is None else out_len)


def test_card_tests_cover_both_paths():
    assert len(_card_conv1d_tc()) >= 4 and len(_card_convt_tc()) >= 4
