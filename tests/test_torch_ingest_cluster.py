"""The partition and the reduction order of K2's cluster kernel
(audiogan_tpu_torch/csrc/ingest.cu), on the CPU.

``kernels/ingest.py::ingest_plan`` is the kernel's partition of a row
over its cluster: each rank's output slice, the row samples it stages in
shared memory (a head and a tail one sample at a time, 16-byte vectors
between them) and its outputs (a head and a tail one float at a time,
16-byte vectors between them). Here the plan is checked to cover every
output of every row exactly once, and every sample it stages exactly
once, wholly inside the row, for store = clip, for store = 20000 at an
offset of every residue mod 8 (and tensors that start off a 16-byte
boundary), and for a store row shorter than the clip.

Then a torch emulation of the kernel loads each rank's samples through
the plan, folds them into each thread's partial peak or sum of squares
in the kernel's order (a thread's body vectors in order, then its head
or tail sample), reduces each warp by its xor tree, adds the warp
partials by the kernel's fixed tree over (rank, warp) slots, and writes
the companded outputs from the staging. It is held against
``ingest_fused_plain`` and against JAX's ``ingest_fused`` in interpret
mode (as tests/test_torch_ingest.py runs it), 1e-6 absolute on outputs
in [-1, 1]: only the order of the sums differs.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiogan_tpu.kernels.ingest as jking
from audiogan_tpu_torch.kernels import ingest as tking

ATOL = 1e-6
THREADS = tking.INGEST_THREADS


def _spans(split: dict, vec: int) -> list[int]:
    """The absolute indices a split touches, in order: head, each body
    vector's vec elements, tail."""
    (h0, h1), (va, vb), (t0, t1) = (split["head"], split["body"],
                                    split["tail"])
    assert 0 <= h1 - h0 < vec and 0 <= t1 - t0 < vec
    if vb > va:
        assert h1 == va * vec and t0 == vb * vec
    return [*range(h0, h1), *range(va * vec, max(vb, va) * vec),
            *range(t0, t1)]


def _check_plan(store, clip, cluster, off, row, base, obase):
    plan = tking.ingest_plan(store, clip, cluster, off, row, base, obase)
    assert len(plan) == cluster
    slice_ = tking.ingest_slice(clip, cluster)
    out_cover = np.zeros(clip, np.int64)
    row0, orow0 = base + row * store, obase + row * clip
    for r, p in enumerate(plan):
        assert p["rank"] == r and p["hi"] - p["lo"] <= slice_
        out_cover[p["lo"]:p["hi"]] += 1
        # the staged samples: each once, wholly inside the row's samples
        # that the slice's crop reaches
        s_lo, s_hi = p["src"]
        staged = _spans(p["load"], tking.INGEST_VEC)
        assert staged == list(range(row0 + s_lo, row0 + s_hi))
        assert all(row0 <= a < row0 + store for a in staged)
        if staged:
            assert staged[-1] - tking.INGEST_VEC * p["v0"] < slice_ + 8
            assert p["v0"] * tking.INGEST_VEC <= staged[0]
        # a crop sample read by output o is staged by o's own rank
        for o in (p["lo"], p["hi"] - 1):
            if p["lo"] <= o < p["hi"] and 0 <= off + o < store:
                assert s_lo <= off + o < s_hi
        # the outputs: each once, in the rank's slice
        written = _spans(p["store"], tking.INGEST_OUT_VEC)
        assert written == list(range(orow0 + p["lo"], orow0 + p["hi"]))
    assert (out_cover == 1).all()


@pytest.mark.parametrize("cluster", tking.INGEST_CLUSTERS)
def test_plan_covers_every_sample_once_store_is_clip(cluster):
    for row in range(3):
        _check_plan(16384, 16384, cluster, 0, row, 0, 0)


@pytest.mark.parametrize("cluster", tking.INGEST_CLUSTERS)
@pytest.mark.parametrize("residue", range(8))
def test_plan_covers_every_sample_once_with_slack(cluster, residue):
    """store 20000: offsets of every residue mod 8, rows whose start moves
    (20000 % 8 == 0, so the tensor's own start offset too)."""
    for off in (residue, 3608 - 8 + residue, 1000 + residue):
        for row, base, obase in ((0, 0, 0), (1, 3, 0), (5, 7, 2)):
            _check_plan(20000, 16384, cluster, off, row, base, obase)


@pytest.mark.parametrize("cluster", tking.INGEST_CLUSTERS)
def test_plan_covers_every_sample_once_store_shorter_than_clip(cluster):
    for store, clip in ((1000, 1280), (13, 1024), (16000, 16384)):
        for row, base in ((0, 0), (2, 5)):
            _check_plan(store, clip, cluster, 0, row, base, 1)


def test_plan_of_short_clips_leaves_ranks_empty():
    plan = tking.ingest_plan(40, 24, 8, 3)
    assert [p["hi"] - p["lo"] for p in plan] == [8, 8, 8, 0, 0, 0, 0, 0]
    _check_plan(40, 24, 8, 3, 1, 6, 3)


def test_cluster_choice():
    assert tking.ingest_cluster(16384) == tking.INGEST_CLUSTER
    assert tking.ingest_cluster(176400) in tking.INGEST_CLUSTERS
    with pytest.raises(ValueError, match="cluster"):
        tking.ingest_cluster(8 * tking.INGEST_MAX_SLICE + 8)


def _xor_tree(v: torch.Tensor, peak: bool) -> torch.Tensor:
    """__shfl_xor_sync's butterfly over the last axis (32 lanes): every
    lane ends with the same value."""
    lanes = torch.arange(32)
    for d in (16, 8, 4, 2, 1):
        other = v[..., lanes ^ d]
        v = torch.maximum(v, other) if peak else v + other
    return v[..., 0]


def _emulate(raw, offs, clip, mode, target, mu, eps, cluster, base=0):
    """The cluster kernel in torch, f32: raw int16 [B, S] as if its data
    started `base` samples past a 16-byte boundary."""
    bsz, store = raw.shape
    flat = torch.cat([torch.zeros(base, dtype=torch.int16), raw.reshape(-1)])
    out = torch.full((bsz, clip), float("nan"))
    peak = mode == "peak"

    def fold(acc, x):
        return torch.maximum(acc, x.abs()) if peak else acc + x * x

    for b in range(bsz):
        off = int(offs[b])
        plan = tking.ingest_plan(store, clip, cluster, off, b, base)
        row0 = base + b * store
        parts, samples = [], []
        for p in plan:
            # the loads: thread t takes body vectors va + t + THREADS k, in
            # k order, each sample in order, then (t < 16) one head or tail
            # sample; each lands at staging slot a - 8 v0
            stage = torch.zeros(tking.ingest_slice(clip, cluster) + 8,
                                dtype=torch.int16)
            red = torch.zeros(THREADS)
            (h0, h1), (va, vb), (t0, t1) = (p["load"]["head"],
                                            p["load"]["body"],
                                            p["load"]["tail"])
            vecs = torch.arange(va, max(vb, va))
            for k in range(0, len(vecs), THREADS):
                v = vecs[k:k + THREADS]
                idx = v[:, None] * tking.INGEST_VEC + torch.arange(8)
                x = flat[idx]
                stage[idx - tking.INGEST_VEC * p["v0"]] = x
                for e in range(8):
                    red[:len(v)] = fold(red[:len(v)], x[:, e].float() / 32768)
            for t, a in [*((t, h0 + t) for t in range(8) if h0 + t < h1),
                         *((8 + t, t0 + t) for t in range(8) if t0 + t < t1)]:
                stage[a - tking.INGEST_VEC * p["v0"]] = flat[a]
                red[t] = fold(red[t], flat[a].float() / 32768)
            o = torch.arange(p["lo"], p["hi"])
            s = off + o
            live = (s >= p["src"][0]) & (s < p["src"][1])
            slot = (row0 + s - tking.INGEST_VEC * p["v0"]).clamp(
                0, stage.numel() - 1)
            x = torch.where(live, stage[slot].float() / 32768.0,
                            torch.zeros(()))
            samples.append((o, x))
            # each warp's xor tree; its partial reaches every rank
            parts.extend(_xor_tree(red.view(THREADS // 32, 32), peak))
        factor = torch.ones(())
        if mode != "none":
            # slots l and l + 32 in lane l, then the xor tree
            slots = torch.zeros(64)
            slots[:len(parts)] = torch.stack(parts)
            lanes = (torch.maximum(slots[:32], slots[32:]) if peak
                     else slots[:32] + slots[32:])
            total = _xor_tree(lanes, peak)
            scale = total if peak else torch.sqrt(total / clip)
            factor = target / torch.clamp_min(scale, eps)
        for o, x in samples:
            v = x * factor if mode != "none" else x
            if mu:
                v = torch.sign(v) * torch.log1p(mu * v.abs()) / math.log1p(mu)
            out[b, o] = v
    return out


def _raw(b, store, seed=0, scale=8000):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, store)) * scale).clip(
        -32768, 32767).astype(np.int16)


@pytest.mark.parametrize("cluster", tking.INGEST_CLUSTERS)
@pytest.mark.parametrize("mode", ["peak", "rms", "none"])
@pytest.mark.parametrize("store,clip", [(16384, 16384), (20000, 16384),
                                        (1000, 1280)])
def test_emulation_matches_plain(store, clip, mode, cluster):
    """Each row's offset at another residue mod 8 (the slack case); the
    short store row reads zeros past its end."""
    bsz = 4
    raw = torch.from_numpy(_raw(bsz, store, seed=store))
    max_off = max(store - clip, 0)
    offs = torch.tensor([min(8 * i + 3 * i, max_off) for i in range(bsz)],
                        dtype=torch.int32)
    got = _emulate(raw, offs, clip, mode, 0.999, 255.0, 1e-8, cluster,
                   base=3)
    want = tking.ingest_fused_plain(raw, offs, clip, mode, 0.999, 255.0)
    assert not got.isnan().any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("mu", [255.0, 0.0])
@pytest.mark.parametrize("mode", ["peak", "rms"])
@pytest.mark.parametrize("store,clip", [(1280, 1024), (1024, 1024)])
def test_emulation_matches_pallas_interpret(store, clip, mode, mu,
                                            monkeypatch):
    monkeypatch.setattr(jking, "_INTERPRET", True)
    raw = _raw(4, store, seed=5)
    offs = np.random.default_rng(6).integers(0, store - clip + 1, 4
                                             ).astype(np.int32)
    want = np.asarray(jking.ingest_fused(jnp.asarray(raw), jnp.asarray(offs),
                                         clip, mode, 0.999, mu))
    got = _emulate(torch.from_numpy(raw), torch.from_numpy(offs), clip, mode,
                   0.999, mu, 1e-8, tking.INGEST_CLUSTER)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
