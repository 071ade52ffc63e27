"""audiogan_tpu_torch's polyphase resampler and the resampling ingest
against the JAX package's (audiogan_tpu/ops/resample.py, ops/ingest.py).

Inputs come from numpy seeds. Tolerances: the filter design is the same
float64 arithmetic, so equal to the bit; resampled signals 1e-5 absolute
(the port's float64 product against the reference's f32 conv); ingested
clips 1e-5 absolute against the reference and the golden
``tests/golden/data/resample_ingest.npy`` (test_golden.py's own
tolerance), through mu-law.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogan_tpu.ops.framing import crop_offsets as jcrop_offsets
from audiogan_tpu.ops.ingest import ingest_batch as jingest
from audiogan_tpu.ops.resample import design_polyphase_filter as jdesign
from audiogan_tpu.ops.resample import resample_output_len as jout_len
from audiogan_tpu.ops.resample import resample_poly as jresample
from audiogan_tpu_torch.config import DataCfg, _ratio
from audiogan_tpu_torch.kernels import ingest as tking
from audiogan_tpu_torch.ops.ingest import crop_slack, ingest_batch
from audiogan_tpu_torch.ops.resample import (design_polyphase_filter,
                                             resample_output_len,
                                             resample_poly)

from helpers_golden import resample_data_cfg, resample_raw_fixture

torch.set_num_threads(1)

RATES = [(16000, 48000), (16000, 22050), (44100, 48000), (16000, 8000),
         (16000, 16000)]
ATOL = 1e-5


def _port(jcfg) -> DataCfg:
    return DataCfg(**{f.name: getattr(jcfg, f.name)
                      for f in dataclasses.fields(DataCfg)})


@pytest.mark.parametrize("up,down,taps,beta", [
    (320, 441, 10, 5.0), (1, 3, 10, 5.0), (3, 2, 10, 5.0),
    (147, 160, 10, 5.0), (320, 441, 6, 8.0)], ids=str)
def test_filter_design_equals_the_reference(up, down, taps, beta):
    got = design_polyphase_filter(up, down, taps, beta)
    want = jdesign(up, down, taps, beta)
    assert got.dtype == np.float64 and np.array_equal(got, want)


@pytest.mark.parametrize("target,source", RATES, ids=str)
def test_resample_matches_the_reference(target, source):
    rng = np.random.default_rng(target + source)
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    got = resample_poly(torch.from_numpy(x), target, source)
    want = np.asarray(jresample(jnp.asarray(x), target, source))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_identity_rates_return_the_input():
    x = torch.randn(3, 100)
    assert resample_poly(x, 16000, 16000) is x


def test_output_len_matches_the_reference():
    for in_len in (100, 1001, 16384, 24000):
        for up, down in [(1, 3), (2, 3), (160, 441), (441, 160)]:
            assert resample_output_len(in_len, up, down) == \
                jout_len(in_len, up, down)
    d = DataCfg(sample_rate=16000, source_rate=22050, store_len=24000)
    assert d.resampled_len == resample_output_len(24000, *_ratio(16000,
                                                                 22050))


def test_resampling_ingest_matches_the_reference_and_the_golden():
    """resample_22k's ingest (22050 -> 16000, store 24000 -> 17415, clip
    16384): training with the reference's crop offsets injected, and
    eval's center crop; both against the reference's ingest_batch and the
    golden stack [train (key 7), eval]."""
    jcfg = resample_data_cfg()
    cfg = _port(jcfg)
    raw = resample_raw_fixture()
    key = jax.random.key(7)
    assert crop_slack(cfg) == jcfg.resampled_len - jcfg.clip_len
    offs = np.array(jcrop_offsets(key, 2, crop_slack(cfg)))
    before = tking.ingest_fused.launches
    train = ingest_batch(torch.from_numpy(raw), cfg,
                         offsets=torch.from_numpy(offs))
    evl = ingest_batch(torch.from_numpy(raw), cfg)
    assert tking.ingest_fused.launches == before   # K2 is not this route
    for got, want in ((train, jingest(raw, jcfg, key)),
                      (evl, jingest(raw, jcfg, None))):
        assert got.dtype == torch.float32 and got.shape == (2, 16384)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
    golden = np.load(__import__("pathlib").Path(__file__).parent
                     / "golden" / "data" / "resample_ingest.npy")
    np.testing.assert_allclose(np.stack([train.numpy(), evl.numpy()]),
                               golden, atol=ATOL, rtol=1e-4)


def test_resampling_ingest_draws_its_own_offsets_over_the_slack():
    """With a generator the offsets are drawn over the resampled row's
    slack (17415 - 16384), not the store's (24000 - 16384)."""
    cfg = _port(resample_data_cfg())
    raw = torch.from_numpy(resample_raw_fixture(4))
    a = ingest_batch(raw, cfg, torch.Generator().manual_seed(0))
    b = ingest_batch(raw, cfg, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and a.shape == (4, 16384)
    offs = torch.randint(0, crop_slack(cfg) + 1, (4,),
                         generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32)
    assert torch.equal(a, ingest_batch(raw, cfg, offsets=offs))
