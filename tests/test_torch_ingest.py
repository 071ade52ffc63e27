"""audiogan_tpu_torch's ingest (K2's plain form, framing, normalization)
against the JAX package's.

The plain form of the fused ingest kernel is held against the JAX
``ingest_fused`` in interpret mode (as tests/pallas/conftest.py runs it)
and against the XLA ``ingest_batch``, on the same crop offsets. Tolerance:
1e-6 absolute on outputs in [-1, 1] (one division and one log1p in another
library).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiogan_tpu.kernels.ingest as jking
from audiogan_tpu.config import DataCfg as JDataCfg
from audiogan_tpu.ops.framing import center_crop as jcenter
from audiogan_tpu.ops.framing import crop_offsets as jcrop_offsets
from audiogan_tpu.ops.ingest import ingest_batch as jingest
from audiogan_tpu_torch.config import DataCfg
from audiogan_tpu_torch.kernels import ingest as tking
from audiogan_tpu_torch.ops import framing as tframing
from audiogan_tpu_torch.ops.ingest import ingest_batch
from audiogan_tpu_torch.ops.normalize import normalize_amplitude

ATOL = 1e-6


def _raw(b, store, seed=0, scale=8000):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, store)) * scale).clip(
        -32768, 32767).astype(np.int16)


def _port_cfg(jcfg: JDataCfg) -> DataCfg:
    fields = {f.name for f in dataclasses.fields(DataCfg)}
    return DataCfg(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                      if k in fields})


@pytest.mark.parametrize("mu", [255.0, 0.0])
@pytest.mark.parametrize("mode", ["peak", "rms"])
@pytest.mark.parametrize("store,clip", [(1280, 1024), (1024, 1024),
                                        (1000, 640)])
def test_plain_matches_pallas_interpret(store, clip, mode, mu, monkeypatch):
    monkeypatch.setattr(jking, "_INTERPRET", True)
    raw = _raw(4, store)
    offs = np.random.default_rng(1).integers(0, store - clip + 1, 4
                                             ).astype(np.int32)
    want = np.asarray(jking.ingest_fused(jnp.asarray(raw), jnp.asarray(offs),
                                         clip, mode, 0.999, mu))
    before = tking.ingest_fused.launches
    got = tking.ingest_fused(torch.from_numpy(raw), torch.from_numpy(offs),
                             clip, mode, 0.999, mu)
    assert tking.ingest_fused.launches == before      # CPU: plain form
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("normalize", ["peak", "rms", "none"])
@pytest.mark.parametrize("store,clip", [(1280, 1024), (1024, 1024),
                                        (900, 1024)])
def test_ingest_batch_matches_xla(store, clip, normalize):
    """Training path on the XLA tier (incl. a store row shorter than the
    clip, which both zero-pad), fed the offsets JAX drew."""
    jcfg = JDataCfg(clip_len=clip, store_len=store, normalize=normalize)
    raw = _raw(3, store, seed=2)
    key = jax.random.key(7)
    want = np.asarray(jingest(jnp.asarray(raw), jcfg, key, kernels="xla"))
    offs = np.array(jcrop_offsets(key, 3, max(store - clip, 0)))
    got = ingest_batch(torch.from_numpy(raw), _port_cfg(jcfg),
                       offsets=torch.from_numpy(offs))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("store", [1280, 900])
def test_eval_center_crop_matches_xla(store):
    jcfg = JDataCfg(clip_len=1024, store_len=store, mu_law=False)
    raw = _raw(2, store, seed=3)
    want = np.asarray(jingest(jnp.asarray(raw), jcfg, None))
    got = ingest_batch(torch.from_numpy(raw), _port_cfg(jcfg))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    x = np.random.default_rng(0).standard_normal((2, store)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tframing.center_crop(torch.from_numpy(x), 1024).numpy(),
        np.asarray(jcenter(jnp.asarray(x), 1024)))


def test_own_offsets_are_seeded_and_in_range():
    cfg = DataCfg(clip_len=1024, store_len=1280)
    raw = torch.from_numpy(_raw(8, 1280))
    a = ingest_batch(raw, cfg, torch.Generator().manual_seed(3))
    b = ingest_batch(raw, cfg, torch.Generator().manual_seed(3))
    c = ingest_batch(raw, cfg, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    offs = tframing.crop_offsets(torch.Generator().manual_seed(0), 1000, 256)
    assert offs.dtype == torch.int32
    assert int(offs.min()) == 0 and int(offs.max()) == 256


def test_silent_clip_passes_through():
    x = torch.zeros(2, 16)
    assert torch.equal(normalize_amplitude(x, "peak"), x)
    assert torch.equal(normalize_amplitude(x, "rms"), x)
    raw = torch.zeros(2, 16, dtype=torch.int16)
    out = tking.ingest_fused(raw, torch.zeros(2, dtype=torch.int32), 16)
    assert torch.equal(out, torch.zeros(2, 16))


def test_rejects_what_is_not_ported_or_wrong():
    """A resampled batch (ported since the resampler) takes the plain
    route and gives the reference's output on the same offsets, within
    1e-5 (a float64 polyphase product against the reference's f32 conv,
    through mu-law); an offset past the resampled row's slack (929 - 800)
    is refused, as K2's are."""
    raw = torch.from_numpy(_raw(2, 1280))
    jcfg = JDataCfg(clip_len=800, store_len=1280, source_rate=22050)
    offs = np.array([0, 129], np.int32)
    got = ingest_batch(raw, _port_cfg(jcfg), offsets=torch.from_numpy(offs))
    x = jnp.asarray(raw.numpy(), jnp.float32) / 32768.0
    from audiogan_tpu.ops.mulaw import mu_law_compand
    from audiogan_tpu.ops.normalize import normalize_amplitude as jnorm
    from audiogan_tpu.ops.resample import resample_poly as jresample
    x = jresample(x, 16000, 22050)
    x = jnp.stack([x[i, o:o + 800] for i, o in enumerate(offs)])
    ref = np.asarray(mu_law_compand(jnorm(x, "peak", 0.999)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="outside"):
        ingest_batch(raw, _port_cfg(jcfg),
                     offsets=torch.tensor([0, 130], dtype=torch.int32))
    with pytest.raises(ValueError, match="outside"):
        tking.ingest_fused(raw, torch.tensor([0, 257], dtype=torch.int32),
                           1024)
    with pytest.raises(TypeError):
        tking.ingest_fused(raw.float(), torch.zeros(2, dtype=torch.int32),
                           1024)
    with pytest.raises(ValueError):
        tking.ingest_fused(raw, torch.zeros(2, dtype=torch.int32), 1024,
                           mode="loud")
