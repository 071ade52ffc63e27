"""The index arithmetic of the CUDA-core path of K1' and K1 (the kernels
of audiogan_tpu_torch/csrc/conv_cc.cuh), on the CPU.

The kernels do no tap arithmetic of their own: they run the int32 plan
that kernels/conv.py builds (``conv1d_cc_plan``, ``convt_cc_plan``). Here
that very plan is decoded and executed in torch, block by block as each
kernel's grid runs it:

* gemm: M tiles over (batch element, row m of one phase) flattened
  across the batch, each k-step's rows gathered with zeros outside x,
  the channels in chunks of ck (a ragged last chunk reads zeros), the
  epilogue's masks and the phase's output rows;
* thin_cout: one block per (element, 4 * threads rows m, NP columns of
  (phase, Cout)), every phase's q_taps shifts from rows staged once, taps
  outside [0, K) as zeros;
* thin_cin: one block per (element, rows, 64 channels), every tap of
  every channel.

The output starts as NaN and a count of writes must be 1 everywhere, so a
missed or doubled output shows. Against the plain forms in float64
(the same sums in another order: 1e-12 of the peak) at hand-made
geometries that cross element boundaries inside a tile, ragged channel
chunks and Cout tiles, pad_lo >= K, t_in % s != 0, and at every
CUDA-core geometry of music's cp=4 ranks, the flagship's tp=2 ranks, the
one-channel bf16 layers and resample_22k at a small batch; against JAX's
``conv1d_ba`` / ``conv_transpose1d_ba`` (impl="pallas" in interpret
mode) in float32 at tiny geometries (1e-5, as the other conv tests). And
the routing: the tensor-core predicates send the same geometries to the
tensor cores as before, and every other geometry gets a plan.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiogan_tpu.kernels.conv as jconv
from audiogan_tpu_torch.cli import apply_overrides
from audiogan_tpu_torch.config import get_preset
from audiogan_tpu_torch.kernels import conv as tconv
from audiogan_tpu_torch.tools.step_checks import (
    cp_rank_layers, critic_dx_layers, critic_layers, generator_dx_layers,
    generator_layers, tensor_core, tp_rank_layers)

F64_TOL = 1e-12
JAX_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def one_thread():
    """Each emulation is many small products: one intra-op thread per test
    process keeps parallel test workers from oversubscribing the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _decode(plan: np.ndarray) -> dict:
    """The fields of cc_plan's array, in the order csrc/conv_cc.cuh reads
    them."""
    head = ("kind", "tile", "ck", "m_lim", "s_in", "s_out", "out_len",
            "n_phase", "n_steps")
    p = dict(zip(head, plan[:len(head)].tolist()))
    n_ph, n = p["n_phase"], p["n_steps"]
    rest = plan[len(head):].tolist()
    assert len(rest) == n_ph + 1 + 2 * n
    p["start"] = rest[:n_ph + 1]
    p["tap"] = rest[n_ph + 1:n_ph + 1 + n]
    p["shift"] = rest[n_ph + 1 + n:]
    return p


def _rows(x: torch.Tensor, b, src) -> torch.Tensor:
    """x[b, src, :] per row, zero where src leaves [0, t_in) or b < 0."""
    ok = (src >= 0) & (src < x.shape[1]) & (b >= 0)
    out = x.new_zeros(len(src), x.shape[2])
    out[ok] = x[b[ok], src[ok]]
    return out


def _store(y, writes, b, t, cols, vals, keep) -> None:
    bb, tt = b[keep], t[keep]
    y[bb[:, None], tt[:, None], cols[None, :]] = vals[keep]
    writes[bb[:, None], tt[:, None], cols[None, :]] += 1


def _emulate(x, w, bias, plan, act, slope):
    """Each kernel's grid over the plan; returns y and how many times each
    output was written."""
    p = _decode(plan)
    bsz, t_in, cin = x.shape
    k, _, cout = w.shape
    out_len, m_lim = p["out_len"], p["m_lim"]
    y = torch.full((bsz, out_len, cout), float("nan"), dtype=x.dtype)
    writes = torch.zeros(y.shape, dtype=torch.int64)
    start, tap, shift = p["start"], p["tap"], p["shift"]

    def epilogue(acc, cols):
        return tconv._apply_act(acc + bias[cols], act, slope)

    if p["kind"] == tconv.CC_GEMM:
        tm, tn = tconv.CC_TILES[p["tile"]]
        ck = p["ck"]
        assert ck in (8, 16)
        pad = -cin % ck            # the ragged last chunk reads zeros
        xp = torch.nn.functional.pad(x, (0, pad))
        wp = torch.nn.functional.pad(w, (0, 0, 0, pad))
        total = bsz * m_lim
        for phase in range(p["n_phase"]):
            for o0 in range(0, cout, tn):
                cols = torch.arange(o0, min(o0 + tn, cout))
                for m0 in range(0, total, tm):
                    r = torch.arange(m0, m0 + tm)
                    valid = r < total
                    b = torch.where(valid, r // m_lim, -1)
                    m = r % m_lim
                    acc = x.new_zeros(tm, len(cols))
                    for e in range(start[phase], start[phase + 1]):
                        acc += _rows(xp, b, m * p["s_in"] + shift[e]) \
                            @ wp[tap[e]][:, cols]
                    t = m * p["s_out"] + phase
                    _store(y, writes, b, t, cols, epilogue(acc, cols),
                           valid & (t < out_len))
    elif p["kind"] == tconv.CC_THIN_COUT:
        np_, n_ph = p["ck"], p["n_phase"]
        tm = 4 * tconv.CC_THIN_COUT_THREADS[p["tile"]]
        q_taps = start[1]
        for rho in range(n_ph):
            assert start[rho + 1] - start[rho] == q_taps
            assert shift[start[rho]:start[rho + 1]] == list(
                range(shift[0], shift[0] + q_taps))
        for n0 in range(0, n_ph * cout, np_):
            n = torch.arange(n0, n0 + np_)
            rho, o = n // cout, n % cout
            live = rho < n_ph
            for b0 in range(bsz):
                for m0 in range(0, m_lim, tm):
                    m = torch.arange(m0, m0 + tm)
                    b = torch.full_like(m, b0)
                    acc = x.new_zeros(tm, np_)
                    for tau in range(q_taps):
                        wt = x.new_zeros(cin, np_)
                        for nn in range(np_):
                            if live[nn]:
                                j = tap[start[int(rho[nn])] + tau]
                                if j >= 0:
                                    wt[:, nn] = w[j, :, o[nn]]
                        acc += _rows(x, b, m + shift[0] + tau) @ wt
                    for nn in range(np_):
                        if not live[nn]:
                            continue
                        t = m * p["s_out"] + rho[nn]
                        cols = o[nn:nn + 1]
                        _store(y, writes, b, t, cols,
                               epilogue(acc[:, nn:nn + 1], cols),
                               (m < m_lim) & (t < out_len))
    else:
        assert p["kind"] == tconv.CC_THIN_CIN and p["n_phase"] == 1
        assert p["ck"] == cin and m_lim == out_len
        tm = tconv.CC_THIN_CIN_ROWS[p["tile"]]
        for o0 in range(0, cout, tconv.CC_THIN_CIN_N):
            cols = torch.arange(o0, min(o0 + tconv.CC_THIN_CIN_N, cout))
            for b0 in range(bsz):
                for t0 in range(0, m_lim, tm):
                    t = torch.arange(t0, t0 + tm)
                    b = torch.full_like(t, b0)
                    acc = x.new_zeros(tm, len(cols))
                    for e in range(start[1]):
                        acc += _rows(x, b, t * p["s_in"] + shift[e]) \
                            @ w[tap[e]][:, cols]
                    _store(y, writes, b, t, cols, epilogue(acc, cols),
                           t < m_lim)
    return y, writes


def _inputs(b, t_in, cin, cout, k, dtype=torch.float64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t_in, cin))
    w = rng.standard_normal((k, cin, cout)) / np.sqrt(k * cin / 4)
    bias = rng.standard_normal(cout) * 0.5
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype),
            torch.from_numpy(bias).to(dtype))


def _check(family, L, dtype=torch.float32, tile=None, act=None):
    """The plan of geometry L (in the path's dtype) emulated in float64
    against the plain form: every output written once, within 1e-12 of
    the peak."""
    act = L["act"] if act is None else act
    x, w, b = _inputs(L["b"], L["t_in"], L["cin"], L["cout"], L["k"])
    if family == "conv1d":
        plan = tconv.conv1d_cc_plan(dtype, L["b"], L["t_in"], L["cin"],
                                    L["cout"], L["k"], L["s"], L["lo"],
                                    L["hi"], tile)
        want = tconv.conv1d_ba_plain(x, w, b, L["s"], L["lo"], L["hi"], act,
                                     0.3)
    else:
        plan = tconv.convt_cc_plan(dtype, L["b"], L["t_in"], L["cin"],
                                   L["cout"], L["k"], L["s"], L["pad_lo"],
                                   L["out_len"], tile)
        want = tconv.conv_transpose1d_ba_plain(x, w, b, L["s"], L["pad_lo"],
                                               L["out_len"], act, 0.3)
    got, writes = _emulate(x, w, b, plan, act, 0.3)
    assert int(writes.min()) == 1 and int(writes.max()) == 1
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= F64_TOL * want.abs().max().item(), err
    return _decode(plan)


def _t(name, b, t_in, cin, cout, k, s, pad_lo, out_len, act="leaky_relu"):
    return dict(name=name, b=b, t_in=t_in, cin=cin, cout=cout, k=k, s=s,
                pad_lo=pad_lo, out_len=out_len, act=act)


def _c(name, b, t_in, cin, cout, k, s, lo, hi, act="leaky_relu"):
    return dict(name=name, b=b, t_in=t_in, cin=cin, cout=cout, k=k, s=s,
                lo=lo, hi=hi, act=act)


# hand-made geometries: (family, geometry, kind the plan must pick)
CASES = [
    # 12 rows of 5 elements in one 64- or 128-row tile: tiles cross
    # element boundaries; Cin 20 in chunks of 8 and 16 (ragged); Cout 72
    # against 64- and 128-wide tiles
    ("convt1d", _t("stacked short rows", 5, 12, 20, 72, 25, 3, 24, 58),
     tconv.CC_GEMM),
    ("convt1d", _t("m <= 16, ck 8", 7, 4, 33, 40, 9, 4, 4, 16), tconv.CC_GEMM),
    # out_len % s != 0, a phase with no tap (s > K)
    ("convt1d", _t("phase without a tap", 3, 6, 24, 20, 5, 7, 2, 40),
     tconv.CC_GEMM),
    ("convt1d", _t("thin all-phase s=7", 3, 300, 24, 1, 25, 7, 15, 2097,
                   "tanh"), tconv.CC_THIN_COUT),
    ("convt1d", _t("thin Cout 3, s=4", 2, 70, 9, 3, 25, 4, 12, 277),
     tconv.CC_THIN_COUT),
    ("convt1d", _t("thin Cout 16: N in groups", 2, 40, 32, 16, 25, 4, 14,
                   160), tconv.CC_THIN_COUT),
    # conv1d: t_in % s != 0, VALID on a halo slice; pad_lo >= K
    ("conv1d", _c("t_in % s != 0", 3, 61, 24, 40, 25, 7, 0, 0),
     tconv.CC_GEMM),
    ("conv1d", _c("pad_lo >= K", 2, 30, 16, 9, 5, 2, 7, 3), tconv.CC_GEMM),
    ("conv1d", _c("short rows across elements", 9, 40, 40, 130, 25, 5, 12,
                  8), tconv.CC_GEMM),
    ("conv1d", _c("one channel in", 3, 777, 1, 70, 25, 4, 10, 11),
     tconv.CC_THIN_CIN),
    ("conv1d", _c("three channels in, s=7", 2, 300, 3, 33, 25, 7, 9, 9),
     tconv.CC_THIN_CIN),
    ("conv1d", _c("one channel in, pad_lo >= K", 2, 50, 1, 8, 5, 3, 6, 2),
     tconv.CC_THIN_CIN),
]


@pytest.mark.parametrize("family,L,kind", CASES, ids=lambda v: v["name"]
                         if isinstance(v, dict) else str(v))
def test_plan_matches_plain_at_every_tile(family, L, kind):
    p = _check(family, L)
    assert p["kind"] == kind
    for tile in tconv.cc_tiles(kind, L["cout"]):
        _check(family, L, tile=tile, act="relu")


def _music_cp():
    mcfg = apply_overrides(get_preset("music_44k_dp16"),
                           ["mesh.dp=1", "mesh.cp=4"]).validate()
    return cp_rank_layers(mcfg, 1, 4)


def _flagship_tp():
    return tp_rank_layers(get_preset("wgan_gp_b64"), 1, 2)


def _thin_bf16():
    """The bf16 layers off the tensor cores: one channel in or out."""
    convt, conv = [], []
    mcfg = apply_overrides(get_preset("music_44k_dp16"),
                           ["mesh.dp=1"]).validate()
    for cfg in (get_preset("wgan_gp_b64"), mcfg,
                get_preset("cond_gru_sc09")):
        for L in generator_layers(cfg, 1) + critic_dx_layers(cfg, 1):
            if not tensor_core("convt1d", L):
                convt.append(dict(L, name=f"{cfg.name} {L['name']}"))
        for L in critic_layers(cfg, 1) + generator_dx_layers(cfg, 1):
            if not tensor_core("conv1d", L):
                conv.append(dict(L, name=f"{cfg.name} {L['name']}"))
    return convt, conv


def _resample():
    cfg = get_preset("resample_22k")
    return (generator_layers(cfg, 1) + critic_dx_layers(cfg, 2),
            critic_layers(cfg, 2) + generator_dx_layers(cfg, 1))


SETS = {"cp": (_music_cp, torch.float32), "tp": (_flagship_tp, torch.float32),
        "thin": (_thin_bf16, torch.bfloat16),
        "resample": (_resample, torch.float32)}
MAIN_PATH = [(name, fam, i) for name, (fn, _) in SETS.items()
             for fam, layers in zip(("convt1d", "conv1d"), fn())
             for i in range(len(layers))]


@pytest.mark.parametrize("name,family,i", MAIN_PATH, ids=str)
def test_main_path_geometry_plan_matches_plain(name, family, i):
    """Every CUDA-core geometry of the cp, tp, thin and resample paths at a
    small batch (the critic's at 2, G's at 1), in the path's dtype."""
    fn, dtype = SETS[name]
    L = fn()[family == "conv1d"][i]
    assert not tensor_core(family, L, dtype)
    p = _check(family, L, dtype)
    if name == "thin":
        assert p["kind"] == (tconv.CC_THIN_COUT if family == "convt1d"
                             else tconv.CC_THIN_CIN)


def test_main_path_geometry_count():
    """10 + 10 cp, 5 + 5 tp, 6 + 6 thin (three presets), 10 + 10
    resample."""
    counts = {name: tuple(len(v) for v in fn())
              for name, (fn, _) in SETS.items()}
    assert counts == {"cp": (10, 10), "tp": (5, 5), "thin": (6, 6),
                      "resample": (10, 10)}


JAX_CASES = [
    ("conv1d", (25, 4, 64, 32, 40, "SAME")),
    ("conv1d", (25, 7, 61, 32, 33, (0, 0))),        # t_in % s != 0
    ("conv1d", (25, 4, 150, 1, 32, "SAME")),        # thin_cin
    ("convt1d", (25, 7, 5, 32, 33, 12, 35)),
    ("convt1d", (25, 3, 12, 40, 32, 24, 58)),        # a cp D4 dx's pads
    ("convt1d", (25, 4, 30, 32, 1, 14, 120)),       # thin_cout
]


@pytest.mark.parametrize("act", ["none", "leaky_relu", "tanh"])
@pytest.mark.parametrize("family,geom", JAX_CASES, ids=str)
def test_plan_matches_jax(family, geom, act, monkeypatch):
    """The plan in float32 against the reference's Pallas kernels in
    interpret mode (its plain XLA route where a channel count is under its
    MIN_CH)."""
    monkeypatch.setattr(jconv, "_INTERPRET", True)
    x, w, b = _inputs(2, geom[2], geom[3], geom[4], geom[0], torch.float32,
                      seed=3)
    k, s, t_in, cin, cout = geom[:5]
    args = (jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
            jnp.asarray(b.numpy()))
    if family == "conv1d":
        want = jconv.conv1d_ba(*args, stride=s, padding=geom[5], act=act,
                               slope=0.3, impl="pallas")
        lo, hi = tconv.conv1d_pads(t_in, k, s, geom[5])
        plan = tconv.conv1d_cc_plan(torch.float32, 2, t_in, cin, cout, k, s,
                                    lo, hi)
    else:
        want = jconv.conv_transpose1d_ba(*args, stride=s, pad_lo=geom[5],
                                         out_len=geom[6], act=act, slope=0.3,
                                         impl="pallas")
        plan = tconv.convt_cc_plan(torch.float32, 2, t_in, cin, cout, k, s,
                                   geom[5], geom[6])
    got, writes = _emulate(x, w, b, plan, act, 0.3)
    assert int(writes.min()) == 1 and int(writes.max()) == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)


def _tc_before(family, L, dtype):
    """The tensor-core predicates as they stood before the CUDA-core
    redesign: bf16, Cin and Cout >= 64 and multiples of 8, K <= 64; conv1d
    T % s == 0, convT s <= 16."""
    ok = (dtype == torch.bfloat16 and L["cin"] >= 64 and L["cout"] >= 64
          and L["cin"] % 8 == 0 and L["cout"] % 8 == 0 and L["k"] <= 64)
    if family == "conv1d":
        return ok and L["t_in"] % L["s"] == 0
    return ok and L["s"] <= 16


def test_routing_to_the_tensor_cores_is_unchanged():
    """Every geometry of every preset, per-rank batch, cp and tp slice goes
    where it went before: 16 of the flagship's 20 bf16 geometries and 16
    of music's on the tensor cores, none in f32; the rest get a CUDA-core
    plan, one channel in or out on a thin kernel."""
    mcfg = apply_overrides(get_preset("music_44k_dp16"),
                           ["mesh.dp=1"]).validate()
    every = []
    for cfg in (get_preset("wgan_gp_b64"), mcfg, get_preset("cond_gru_sc09"),
                get_preset("resample_22k")):
        for b in (4, 64):
            every += [("convt1d", L) for L in generator_layers(cfg, b)
                      + critic_dx_layers(cfg, 2 * b)]
            every += [("conv1d", L) for L in critic_layers(cfg, 2 * b)
                      + generator_dx_layers(cfg, b)]
    for fn in (_music_cp, _flagship_tp):
        convt, conv = fn()
        every += [("convt1d", L) for L in convt] + [("conv1d", L)
                                                    for L in conv]
    for dtype in (torch.float32, torch.bfloat16):
        for family, L in every:
            tc = tensor_core(family, L, dtype)
            assert tc == _tc_before(family, L, dtype), L["name"]
            if tc:
                continue
            kind = tconv.cc_kind(family, dtype, L["cin"], L["cout"], L["k"],
                                 L["s"], L.get("pad_lo", 0))
            thin = (L["cout"] <= 16 if family == "convt1d"
                    else L["cin"] < 8)
            assert (kind != tconv.CC_GEMM) == thin, L["name"]
    for cfg in (get_preset("wgan_gp_b64"), mcfg):
        geoms = ([("convt1d", L) for L in generator_layers(cfg, 64)
                  + critic_dx_layers(cfg, 128)]
                 + [("conv1d", L) for L in critic_layers(cfg, 128)
                    + generator_dx_layers(cfg, 64)])
        assert sum(tensor_core(f, L) for f, L in geoms) == 16
        assert not any(tensor_core(f, L, torch.float32) for f, L in geoms)


def test_kernel_tile_tables_match_the_plan():
    """csrc/conv_cc.cuh dispatches a plan's tile index to the tile that
    kernels/conv.py names for it (CC_TILES, CC_THIN_COUT_THREADS,
    CC_THIN_CIN_ROWS): the emulation above runs the Python table, the card
    the C one."""
    src = (Path(tconv.__file__).resolve().parent.parent / "csrc"
           / "conv_cc.cuh").read_text()
    gemm = {int(i): (int(m), int(n)) for i, m, n in re.findall(
        r"case (\d+):\s*return launch_gemm_ck<T, (\d+), (\d+), kAsync>",
        src)}
    assert gemm == dict(enumerate(tconv.CC_TILES))
    thin_cout = {int(i): int(nt) for i, nt in re.findall(
        r"tile == (\d+)\)(?:\s*//[^\n]*)?\s*return launch_thin_cout<T, NP, "
        r"(\d+), kAsync>", src)}
    assert thin_cout == dict(enumerate(tconv.CC_THIN_COUT_THREADS))
    thin_cin = {int(i): int(tm) for i, tm in re.findall(
        r"tile == (\d+)\)(?:\s*//[^\n]*)?\s*return launch_thin_cin<T, "
        r"(\d+)>", src)}
    assert thin_cin == dict(enumerate(tconv.CC_THIN_CIN_ROWS))
    np_cases = {int(n) for n in re.findall(
        r"case (\d+): return launch_thin_cout_tile<T, \d+, kAsync>", src)}
    assert np_cases == set(tconv.CC_THIN_NP)


@pytest.mark.parametrize("family,wrapper,kinds", [
    ("convt1d", "conv_transpose1d_ba", ("gemm", "thin_cout")),
    ("conv1d", "conv1d_ba", ("gemm", "thin_cin"))])
def test_hooks_name_every_kernel_of_the_wrapper(family, wrapper, kinds):
    """A captured step attributes a launch's graph node to its wrapper by
    the __global__ function's name (kernels/hooks.py, train/step_graph.py):
    every kernel conv_cc.cuh defines for the wrapper's kinds is named
    there, and so is the tensor-core kernel."""
    from audiogan_tpu_torch.kernels import hooks
    csrc = Path(tconv.__file__).resolve().parent.parent / "csrc"
    defined = set(re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?"
                             r"\s*(\w+)\(", (csrc / "conv_cc.cuh").read_text()))
    assert defined == {f"{k}_kernel" for k in ("gemm", "thin_cout",
                                                "thin_cin")}
    names = hooks.KERNELS[wrapper].functions
    for kind in kinds:
        assert f"{kind}_kernel" in names, (family, kind)
    assert "igemm_kernel" in names
