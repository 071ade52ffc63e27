"""The persistent path of the GRU scan (K4) and its reverse sweep (K5) on
the CPU: the plan the kernels run, and their arithmetic.

``csrc/gru_scan.cu``'s scan_fwd_persistent and scan_bwd_persistent do no
partition arithmetic of their own: each block reads its batch rows, hidden
units and feature columns from the int32 plan that
``kernels/gru.py::gru_persistent_plan`` builds. Here that plan is checked
to give every (row, column) of every phase exactly one owner, and a torch
emulation of the kernels' arithmetic runs with it: the cond half of the
gate product hoisted out of the frame loop, every product of an f32
carried activation x taken as bf16(x) and bf16(x - bf16(x)) against the
bf16 weights with f32 sums, bf16 operands (h0, cond) in one pass, and the
phases in the kernels' order (gates, head, autoregressive product; in the
backward the cell, the carry, the autoregressive product); K5's products
over all frames before and after its sweep (the tensor-core GEMM) with
each f32 operand split the same way. Columns the plan gives to no block
stay NaN. The emulation is held, at
cond_gru_sc09's full width, to the tolerances chip_smoke.py holds the
kernels to on the card (K4: one bf16 ulp of the peak; K5: 1e-3 relative
L2 per gradient) against the plain forms, which tests/test_torch_gru.py
holds against JAX; and at a small width against the JAX kernel itself.
The dispatch predicate sends cond_gru_sc09's bf16 scans to the path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiogan_tpu.kernels.gru as jgru
from audiogan_tpu_torch.config import get_preset
from audiogan_tpu_torch.kernels import gru as tgru

BF16 = torch.bfloat16
GRU_BWD_REL_L2 = 1e-3         # chip_smoke.py: every gradient of K5
# cond_gru_sc09's scan at the training batch
FULL = (64, 512, 256, 256)
# the grid the rule picks at FULL, and two of the other grids timed on the
# card (fewer row groups; twice the column groups)
GRIDS = [None, (32, 2), (64, 1)]


def _bf16_ulp(peak: float) -> float:
    return float(2.0 ** (np.floor(np.log2(max(peak, 1e-30))) - 7))


def _inputs(b, hid, feat, seed=0):
    """The scan's nine inputs at the model's scales (numpy, then bf16):
    h0 = tanh(.), glorot-sized weights, w_h ~ 1/sqrt(H), small biases."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))

    def glorot(n_in, n_out):
        return r(n_in, n_out, scale=(2.0 / (n_in + n_out)) ** 0.5)
    args = [torch.tanh(r(b, hid)), r(b, feat) * 0.5,
            glorot(2 * feat, 3 * hid), r(hid, 3 * hid, scale=hid ** -0.5),
            r(3 * hid, scale=0.1), r(3 * hid, scale=0.1), glorot(feat, feat),
            glorot(hid, feat), r(feat, scale=0.1)]
    return [a.to(BF16) for a in args]


def _owners(plan: np.ndarray, batch: int, hid: int, feat: int):
    """How many blocks store each (row, unit) and each (row, feature)
    column: counts [16 * m-tiles, H] and [16 * m-tiles, F]."""
    n_rows = 16 * -(-batch // 16)
    units = torch.zeros(n_rows, hid, dtype=torch.int32)
    feats = torch.zeros(n_rows, feat, dtype=torch.int32)
    per = plan[tgru.PLAN_HEAD:].reshape(-1, 6)
    assert len(per) == plan[0] == plan[1] * plan[2]
    for m_lo, m_hi, u_lo, u_hi, f_lo, f_hi in per.tolist():
        units[16 * m_lo:16 * m_hi, 8 * u_lo:8 * u_hi] += 1
        feats[16 * m_lo:16 * m_hi, 8 * f_lo:8 * f_hi] += 1
    return units, feats


def _own_masks(plan, batch, hid, feat):
    units, feats = _owners(plan, batch, hid, feat)
    return units[:batch] == 1, feats[:batch] == 1


def _halves(x: torch.Tensor):
    """An operand as the kernels feed it to the tensor cores: a bf16
    tensor as itself; an f32 one as hi = bf16(x) and lo = bf16(x - hi)."""
    if x.dtype == BF16:
        return x.float(), None
    hi = x.to(BF16).float()
    return hi, (x - hi).to(BF16).float()


def _tc_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A product on the tensor cores with f32 sums: A_hi B_hi, plus A_lo
    B_hi where A is f32 and A_hi B_lo where B is f32."""
    a_hi, a_lo = _halves(a)
    b_hi, b_lo = _halves(b)
    out = a_hi @ b_hi
    if a_lo is not None:
        out = out + a_lo @ b_hi
    if b_lo is not None:
        out = out + a_hi @ b_lo
    return out


def _split_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """An f32 activation against bf16 weights: two bf16 passes."""
    return _tc_mm(a.float(), w)


def emulate_fwd(args, n_frames: int, plan: np.ndarray):
    """scan_fwd_persistent's arithmetic, phase by phase -> feats
    [B, n, F], h_seq [n, B, H] (bf16)."""
    h0, cond, w_i, w_h, b_i, b_h, w_ar, w_out, b_out = args
    b, hid = h0.shape
    feat = w_ar.shape[0]
    own_u, own_f = _own_masks(plan, b, hid, feat)
    nan = torch.tensor(float("nan"))
    own_g = own_u.repeat(1, 3)
    # once per scan: c = cond w_i[F:] + b_i (cond is bf16: one pass)
    c = torch.where(own_g, cond.float() @ w_i[feat:].float() + b_i.float(),
                    nan)
    h, a = h0.float(), None
    feats, hs = [], []
    for t in range(n_frames):
        gi = c if t == 0 else _split_mm(a, w_i[:feat]) + c
        gh = (h0.float() @ w_h.float() if t == 0 else _split_mm(h, w_h))
        gh = gh + b_h.float()
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h = torch.where(own_u, (1.0 - z) * n + z * h, nan)
        f = torch.where(own_f, torch.tanh(_split_mm(h, w_out)
                                          + b_out.float()), nan)
        if t + 1 < n_frames:
            a = torch.where(own_f, _split_mm(f, w_ar), nan)
        feats.append(f.to(BF16))
        hs.append(h.to(BF16))
    return torch.stack(feats, dim=1), torch.stack(hs)


def emulate_bwd(g, args, feats, h_seq, plan: np.ndarray):
    """gru_scan_bwd on the persistent path: the recompute and the weight
    gradients as tc_gemm_kernel multiplies them, the sweep as
    scan_bwd_persistent does, both with f32 operands split -> the nine
    gradients in bf16."""
    h0, cond, w_i, w_h, b_i, b_h, w_ar, w_out, b_out = args
    b, hid = h0.shape
    feat = w_ar.shape[0]
    n_frames = feats.shape[1]
    own_u, own_f = _own_masks(plan, b, hid, feat)
    own_g = own_u.repeat(1, 3)
    nan = torch.tensor(float("nan"))
    bi, bh, bout = (t.float() for t in (b_i, b_h, b_out))
    prev_f, prev_h = (t.float() for t in tgru._prev_residuals(h0, feats,
                                                              h_seq))
    prev_fb, prev_hb = (t.to(BF16) for t in (prev_f, prev_h))
    # 1. the recompute, every frame at once
    x = torch.cat([_tc_mm(prev_fb, w_ar),
                   cond.float().expand(n_frames, b, feat)], -1)
    ga, gb = _tc_mm(x, w_i), _tc_mm(prev_hb, w_h)
    i_r, i_z, i_n = (ga + bi).chunk(3, dim=-1)
    h_r, h_z, h_n = (gb + bh).chunk(3, dim=-1)
    r, z = torch.sigmoid(i_r + h_r), torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    hcur = (1.0 - z) * n + z * prev_h
    fcur = torch.tanh(_tc_mm(hcur, w_out) + bout)
    # 2. the sweep
    gt = g.float().transpose(0, 1)
    dfp = torch.empty_like(fcur)
    dar = torch.empty_like(fcur)
    dgi_all, dgh_all = torch.empty_like(ga), torch.empty_like(gb)
    dfp[-1] = torch.where(own_f, gt[-1] * (1.0 - fcur[-1] ** 2), nan)
    dh = torch.zeros(b, hid)
    for t in reversed(range(n_frames)):
        dh = torch.where(own_u, dh + _split_mm(dfp[t], w_out.T), nan)
        dz = dh * (prev_h[t] - n[t]) * z[t] * (1.0 - z[t])
        dn = dh * (1.0 - z[t]) * (1.0 - n[t] ** 2)
        dr = dn * h_n[t] * r[t] * (1.0 - r[t])
        dgi_all[t] = torch.where(own_g, torch.cat([dr, dz, dn], -1), nan)
        dgh_all[t] = torch.where(own_g, torch.cat([dr, dz, dn * r[t]], -1),
                                 nan)
        dhz = dh * z[t]
        dh = torch.where(own_u, _split_mm(dgh_all[t], w_h.T) + dhz, nan)
        dar[t] = torch.where(own_f, _split_mm(dgi_all[t], w_i[:feat].T), nan)
        if t > 0:
            dfc = _split_mm(dar[t], w_ar.T)
            dfp[t - 1] = torch.where(
                own_f, (gt[t - 1] + dfc) * (1.0 - fcur[t - 1] ** 2), nan)
    # 3. the weight gradients over all n*B rows
    flat = lambda v: v.reshape(n_frames * b, -1)  # noqa: E731
    grads = (dh, _tc_mm(dgi_all.sum(0), w_i[feat:].T),
             _tc_mm(flat(x).T, flat(dgi_all)),
             _tc_mm(flat(prev_hb).T, flat(dgh_all)), flat(dgi_all).sum(0),
             flat(dgh_all).sum(0), _tc_mm(flat(prev_fb).T, flat(dar)),
             _tc_mm(flat(hcur).T, flat(dfp)), flat(dfp).sum(0))
    return tuple(d.to(BF16) for d in grads)


@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_plan_owns_every_column_once(grid):
    b, hid, feat, _ = FULL
    plan = tgru.gru_persistent_plan(b, hid, feat, grid)
    ng, ms = grid or tgru.gru_persistent_grid(b, hid, feat)
    assert plan[:3].tolist() == [ng * ms, ng, ms]
    units, feats = _owners(plan, b, hid, feat)
    # every row of the batch (a whole number of m-tiles here) and every
    # unit and feature column has one owner; the tiles stop at H and F, so
    # no padding column exists to be stored
    assert torch.all(units == 1) and torch.all(feats == 1)
    per = plan[tgru.PLAN_HEAD:].reshape(-1, 6)
    assert per[:, 1].max() * 16 == b
    assert per[:, 3].max() * 8 == hid and per[:, 5].max() * 8 == feat
    spans = per[:, 1::2] - per[:, 0::2]
    assert spans.max(axis=0).tolist() == plan[3:6].tolist()
    assert plan[4] <= tgru.GRU_MAX_UNIT_TILES
    assert plan[5] <= tgru.GRU_MAX_FEAT_TILES
    smem = tgru.gru_persistent_smem(hid, feat, *(int(v) for v in plan[3:6]))
    assert max(smem) <= tgru.GRU_SMEM_LIMIT


@pytest.mark.parametrize("shape", [(7, 64, 32), (1, 16, 16), (33, 48, 80)],
                         ids=str)
def test_plan_masks_ragged_batches(shape):
    """Batches that are no multiple of 16: the last m-tile's rows past B
    belong to one block too (the kernels mask them at every store)."""
    b, hid, feat = shape
    plan = tgru.gru_persistent_plan(b, hid, feat)
    units, feats = _owners(plan, b, hid, feat)
    assert torch.all(units == 1) and torch.all(feats == 1)
    assert plan[tgru.PLAN_HEAD:].reshape(-1, 6)[:, 1].max() == -(-b // 16)


def test_grid_rule_at_cond_gru_sc09():
    b, hid, feat, _ = FULL
    assert tgru.gru_persistent_grid(b, hid, feat) == (32, 4)
    assert tgru.gru_persistent_plan(b, hid, feat)[0] <= tgru.GRU_MAX_BLOCKS
    with pytest.raises(ValueError):
        tgru.gru_persistent_plan(b, hid, feat, (16, 4))   # 4 unit tiles


def test_dispatch_sends_cond_gru_sc09_to_the_persistent_path():
    cfg = get_preset("cond_gru_sc09")
    hid = cfg.model.gru_hidden
    feat = min(4 * cfg.model.model_dim, 512)
    assert (hid, feat) == FULL[1:3]
    # the training step's scans (B = batch_size) and the served batch
    for batch in (cfg.train.batch_size, 64):
        assert tgru.gru_scan_persistent(BF16, batch, hid, feat)
        assert not tgru.gru_scan_persistent(torch.float32, batch, hid, feat)
    assert not tgru.gru_scan_persistent(BF16, 65, hid, feat)
    assert not tgru.gru_scan_persistent(BF16, 64, 520, feat)
    assert not tgru.gru_scan_persistent(BF16, 64, hid, 264)


def test_emulated_fwd_matches_plain_at_full_width():
    """K4 over 256 frames at B=64, H=512, F=256, bf16: within one bf16 ulp
    of the peak of the plain form (chip_smoke.py's check on the card)."""
    b, hid, feat, n = FULL
    args = _inputs(b, hid, feat)
    plan = tgru.gru_persistent_plan(b, hid, feat)
    got = emulate_fwd(args, n, plan)
    want = tgru.gru_scan_plain(*args, n, with_h=True)
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs().max().item()
        peak = w.float().abs().max().item()
        assert err <= _bf16_ulp(peak), (err, peak)


def test_emulated_bwd_matches_plain_at_full_width():
    """K5 with the persistent sweep at B=64, H=512, F=256 over 16 frames,
    bf16: every gradient within GRU_BWD_REL_L2 relative L2 of the plain
    form."""
    b, hid, feat, _ = FULL
    n = 16
    args = _inputs(b, hid, feat, seed=1)
    plan = tgru.gru_persistent_plan(b, hid, feat)
    feats, h_seq = tgru.gru_scan_plain(*args, n, with_h=True)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (b, n, feat)).astype(np.float32)).to(BF16)
    got = emulate_bwd(g, args, feats, h_seq, plan)
    want = tgru.gru_scan_bwd_plain(g, *args, feats, h_seq)
    for name, a, gk, w in zip(tgru.ARG_NAMES, args, got, want):
        assert gk.shape == a.shape, name
        err = (gk.float() - w.float()).norm().item()
        assert err <= GRU_BWD_REL_L2 * w.float().norm().item(), name


def test_emulated_fwd_matches_jax_kernel():
    """At a small persistent shape (two m-tiles, the last ragged), the
    emulation against the JAX package's Pallas scan in interpret mode,
    bf16: one bf16 ulp of the peak."""
    b, hid, feat, n = 19, 32, 16, 12
    args = _inputs(b, hid, feat, seed=3)
    assert tgru.gru_scan_persistent(BF16, b, hid, feat)
    jargs = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
             for a in args]
    old = jgru._INTERPRET
    jgru._INTERPRET = True
    try:
        want = np.asarray(jgru.gru_scan(*jargs, n).astype(jnp.float32))
    finally:
        jgru._INTERPRET = old
    got = emulate_fwd(args, n, tgru.gru_persistent_plan(b, hid, feat))[0]
    err = np.abs(got.float().numpy() - want).max()
    assert err <= _bf16_ulp(np.abs(want).max()), err
