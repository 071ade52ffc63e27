"""audiogan_tpu_torch's resident corpus sharded over the data axis
(parallel/sharded_corpus.py), the counterpart of
tests/train/test_sharded_corpus.py, on the CPU over gloo (one intra-op
thread per process): each rank holds its padded share of the clips and a
step's clips come from their owners through one all-gather of bytes, so
the gather must equal the replicated gather (and the host batcher's
stream) to the bit, at dp=2 and dp=4, with a clip count the shards do not
divide; the loop must train the same bits sharded as replicated; and the
``auto`` rule must shard when the replicated corpus exceeds
DEVICE_CORPUS_MAX_GB but a 1/dp share does not, else fall back to the
host batcher.
"""

import dataclasses

import numpy as np
import pytest
import torch

from audiogan_tpu_torch.config import Config, MeshCfg
from audiogan_tpu_torch.parallel.sharded_corpus import (local_shard,
                                                        pad_clips_to_shards,
                                                        plan_step)
from audiogan_tpu_torch.parallel.mesh import DataMesh
from audiogan_tpu_torch.tools import dp_check
from audiogan_tpu_torch.tools.step_checks import same_bits, state_parts
from audiogan_tpu_torch.train import loop

from helpers_train import tiny_config

torch.set_num_threads(1)


def _gather_case(n_clips=37, length=64, n_views=3, batch=16, seed=0):
    rng = np.random.default_rng(seed)
    clips = rng.integers(-32768, 32767, (n_clips, length)).astype(np.int16)
    idx = rng.integers(0, n_clips, (n_views, batch))
    return clips, idx


def _cfg(data_dir, dp, **data):
    cfg = tiny_config()
    cfg = dataclasses.replace(
        cfg, mesh=MeshCfg(dp=dp),
        data=dataclasses.replace(cfg.data, data_dir=str(data_dir),
                                 device_corpus=True, **data),
        train=dataclasses.replace(cfg.train, log_every=1, ckpt_every=0,
                                  batch_size=4))
    return Config.from_json(cfg.to_json()).validate()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A packed synthetic corpus and its size in GiB."""
    base = tmp_path_factory.mktemp("corpus")
    c = loop.resolve_corpus(_cfg("", 1), base)
    return base / "synthetic_corpus", c.clips.nbytes / 2**30


def _train(name, data_dir, dp, workdir, steps=2, max_gb=None, **data):
    kw = {"cfg_json": _cfg(data_dir, dp, **data).to_json(),
          "workdir": str(workdir), "steps": steps}
    if max_gb is not None:
        kw["max_gb"] = max_gb
    return {"name": name, "fn": "train", "kw": kw}


@pytest.fixture(scope="module")
def four(tmp_path_factory, corpus):
    """One spawn of four ranks: the gathers and the auto rule."""
    tmp = tmp_path_factory.mktemp("four")
    packed, gb = corpus
    even, uneven = _gather_case(), _gather_case(n_clips=41, batch=8)
    jobs = [{"name": "even", "fn": "gather",
             "kw": {"clips": even[0], "idx": even[1]}},
            {"name": "uneven", "fn": "gather",
             "kw": {"clips": uneven[0], "idx": uneven[1]}},
            _train("auto_shard", packed, 4, tmp / "a", 1, gb * 0.5),
            _train("auto_host", packed, 4, tmp / "h", 1, 1e-12)]
    return {"even": even, "uneven": uneven}, dp_check.spawn(4, jobs, tmp)


@pytest.fixture(scope="module")
def two(tmp_path_factory, corpus):
    """One spawn of two ranks: a gather, and the loop replicated and
    sharded."""
    tmp = tmp_path_factory.mktemp("two")
    packed, _ = corpus
    case = _gather_case(n_clips=37, batch=6, n_views=2, seed=3)
    jobs = [{"name": "gather", "fn": "gather",
             "kw": {"clips": case[0], "idx": case[1]}},
            _train("replicate", packed, 2, tmp / "r",
                   device_corpus_shard="replicate"),
            _train("shard", packed, 2, tmp / "s",
                   device_corpus_shard="shard")]
    return case, dp_check.spawn(2, jobs, tmp)


def _assert_gathered(case, results, world):
    clips, idx = case
    want = clips[idx]
    n_local = -(-clips.shape[0] // world)
    for rank, res in enumerate(results):
        assert res["local_rows"] == n_local
        got = res["got"].numpy()
        assert got.dtype == np.int16
        np.testing.assert_array_equal(got, want[:, res["rows"]])


def test_sharded_gather_dp4(four):
    _assert_gathered(four[0]["even"], four[1]["even"], 4)


def test_sharded_gather_uneven_pad(four):
    """41 clips over 4 shards: zero-padded to 44; the padded rows are
    never addressed."""
    _assert_gathered(four[0]["uneven"], four[1]["uneven"], 4)


def test_sharded_gather_dp2(two):
    _assert_gathered(two[0], two[1]["gather"], 2)


def test_local_shard_pads_the_last_share():
    clips = np.arange(1, 31, dtype=np.int16).reshape(10, 3)
    shares = [local_shard(clips, DataMesh(4, r)) for r in range(4)]
    np.testing.assert_array_equal(np.concatenate(shares),
                                  pad_clips_to_shards(clips, 4))
    assert not shares[3][1:].any()


def test_pad_clips_noop_when_divisible():
    clips = np.arange(12, dtype=np.int16).reshape(4, 3)
    out = pad_clips_to_shards(clips, 4)
    np.testing.assert_array_equal(out, clips)
    out2 = pad_clips_to_shards(clips, 8)
    assert out2.shape == (8, 3)
    np.testing.assert_array_equal(out2[:4], clips)
    assert not out2[4:].any()


def test_device_corpus_shard_validation():
    cfg = Config.from_json(tiny_config().to_json())
    bad = cfg.replace(data=dataclasses.replace(cfg.data,
                                               device_corpus_shard="maybe"))
    with pytest.raises(ValueError, match="device_corpus_shard"):
        bad.validate()


def test_loop_sharded_equals_replicated_dp2(two):
    rep, sh = two[1]["replicate"], two[1]["shard"]
    assert [ln["init"]["corpus"] for ln in rep[0]["lines"]
            if "init" in ln] == ["replicate"]
    assert [ln["init"]["corpus"] for ln in sh[0]["lines"]
            if "init" in ln] == ["shard"]
    steps = [[ln for ln in r[0]["lines"] if "step" in ln] for r in (rep, sh)]
    assert len(steps[0]) == 2
    for a, b in zip(*steps):
        assert {k: v for k, v in a.items() if k != "seconds"} == \
            {k: v for k, v in b.items() if k != "seconds"}
    for rank in (0, 1):
        same_bits(state_parts(rep[rank]), state_parts(sh[rank]))


def test_loop_sharded_dp1_equals_replicated(tmp_path, corpus):
    """One shard (dp=1): the exchange is a local gather."""
    packed, _ = corpus
    states = [loop.train(_cfg(packed, 1, device_corpus_shard=mode),
                         tmp_path / mode, 1, device="cpu",
                         log=lambda _: None, tensorboard=False)[0]
              for mode in ("replicate", "shard")]
    for a, b in zip(states[0].d.parameters(), states[1].d.parameters()):
        assert torch.equal(a, b)


def test_one_rank_plan_is_the_row_of_the_resident_block():
    """At dp=1 the plan of a step is its row of the index block, taken
    where the block lies (on the card, no host copy); host indices are
    copied to the device as before."""
    block = torch.arange(3 * 2 * 4).reshape(3, 2, 4)
    plan = plan_step(block[1], 24, DataMesh(1, 0), torch.device("cpu"))
    assert plan.send.data_ptr() == block[1].data_ptr()
    assert (plan.n_send, plan.n_recv, plan.place, plan.shape) == \
        ([], [], None, (2, 4))
    host = plan_step(block[1].numpy().astype(np.int32), 24, DataMesh(1, 0),
                     torch.device("cpu"))
    assert host.send.dtype == torch.long
    assert torch.equal(host.send, block[1].reshape(-1))


def test_auto_shards_when_replicated_does_not_fit(four):
    """A cap between the corpus's size and a quarter of it: sharded over
    the four ranks, not the host batcher."""
    lines = four[1]["auto_shard"][0]["lines"]
    assert [ln["init"]["corpus"] for ln in lines if "init" in ln] == \
        ["shard"]
    assert all(np.isfinite(v) for ln in lines if "step" in ln
               for v in ln.values())


def test_auto_falls_back_when_even_sharded_too_big(four):
    lines = four[1]["auto_host"][0]["lines"]
    assert [ln["init"]["corpus"] for ln in lines if "init" in ln] == \
        ["host"]
