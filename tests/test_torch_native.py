"""The port's native host tier (audiogan_tpu_torch/data/native.py over
csrc/host/wavio.cpp and csrc/host/batcher.cpp, built with g++ at first
use) against the reference on the same bytes, on the CPU.

The decoder against the port's numpy codec and the JAX package's
(audiogan_tpu.data.wavio.read_wav, scaled as its build_corpus scales it)
for PCM 8/16/32-bit, float32 and WAVE_FORMAT_EXTENSIBLE, mono and several
channels, padded and center-cropped: the same int16 bytes. A format the
decoder does not support (24-bit PCM) goes to the numpy codec per file.
build_corpus on the synthetic SC09 tree byte for byte against the JAX
build_corpus on its numpy path. The row gather against clips[idx] and the
JAX HostBatcher.get for [V, B] indices; an index out of range raises
ValueError. A source that does not build raises.
"""

import struct

import numpy as np
import pytest

from audiogan_tpu.data import build_corpus as jbuild_corpus
from audiogan_tpu.data import native as jnative
from audiogan_tpu.data.corpus import Corpus as JCorpus
from audiogan_tpu.data.corpus import HostBatcher as JHostBatcher
from audiogan_tpu.data.synthetic import make_synthetic_sc09 as jsynth
from audiogan_tpu.data.wavio import read_wav as jread_wav
from audiogan_tpu_torch.data import native
from audiogan_tpu_torch.data.corpus import Corpus, HostBatcher, build_corpus
from audiogan_tpu_torch.kernels import _build

PCM, FLOAT, EXTENSIBLE = 1, 3, 0xFFFE


def _wav(samples: np.ndarray, fmt: int, bits: int, rate: int = 16000,
         sub: int | None = None) -> bytes:
    """RIFF bytes of samples [T, C] (raw values of the sample type), an
    EXTENSIBLE fmt chunk carrying ``sub`` as its SubFormat code, a LIST
    chunk of odd size before the data."""
    n_ch = samples.shape[1]
    if bits == 24:
        v = samples.astype(np.int32).reshape(-1)
        raw = np.stack([v & 255, (v >> 8) & 255, (v >> 16) & 255],
                       1).astype(np.uint8).tobytes()
    else:
        raw = samples.tobytes()
    block = n_ch * bits // 8
    body = struct.pack("<HHIIHH", fmt, n_ch, rate, rate * block, block, bits)
    if fmt == EXTENSIBLE:
        guid = struct.pack("<H", sub) + b"\x00\x00\x00\x00\x10\x00\x80\x00" \
            b"\x00\xaa\x00\x38\x9b\x71"
        body += struct.pack("<HHI", 22, bits, 0) + guid
    chunks = (b"fmt " + struct.pack("<I", len(body)) + body
              + b"LIST" + struct.pack("<I", 3) + b"abc\x00"
              + b"data" + struct.pack("<I", len(raw)) + raw)
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def _samples(kind: str, frames: int, n_ch: int, rng) -> np.ndarray:
    shape = (frames, n_ch)
    if kind == "pcm8":
        return rng.integers(0, 256, shape).astype(np.uint8)
    if kind == "pcm16":
        return rng.integers(-32768, 32768, shape).astype("<i2")
    if kind == "pcm24":
        return rng.integers(-2**23, 2**23, shape).astype(np.int32)
    if kind == "pcm32":
        return rng.integers(-2**31, 2**31, shape).astype("<i4")
    x = rng.uniform(-1.0, 1.0, shape) * rng.choice([1e-3, 0.5, 1.0], shape)
    x[0, 0], x[1 % frames, 0] = 1.0, -1.0      # the clip edges
    return x.astype("<f4")


FORMATS = {"pcm8": (PCM, 8), "pcm16": (PCM, 16), "pcm32": (PCM, 32),
           "float32": (FLOAT, 32), "ext_float32": (EXTENSIBLE, 32),
           "ext_pcm16": (EXTENSIBLE, 16)}


def _jax_store(path, store_len: int) -> np.ndarray:
    """The reference build_corpus's numpy route for one file."""
    _, x = jread_wav(path)
    out = np.zeros(store_len, np.int16)
    n = min(len(x), store_len)
    off = max((len(x) - store_len) // 2, 0)
    out[:n] = np.clip(np.rint(x[off:off + n] * 32768.0), -32768,
                      32767).astype(np.int16)
    return out


@pytest.mark.parametrize("n_ch", [1, 2, 3, 9])
@pytest.mark.parametrize("store_len", [1500, 4096], ids=["crop", "pad"])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_decode_matches_the_numpy_codecs(tmp_path, fmt, store_len, n_ch):
    rng = np.random.default_rng([len(fmt), store_len, n_ch])
    code, bits = FORMATS[fmt]
    kind = fmt.removeprefix("ext_")
    sub = {"float32": FLOAT, "pcm16": PCM}[kind] if code == EXTENSIBLE \
        else None
    frames = 3001
    path = tmp_path / "a.wav"
    path.write_bytes(_wav(_samples(kind, frames, n_ch, rng), code, bits,
                          sub=sub))
    got = native.decode_to_store(path.read_bytes(), store_len)
    assert got is not None
    plain = native.decode_to_store_plain(path.read_bytes(), store_len)
    assert got[0] == plain[0] == 16000
    np.testing.assert_array_equal(got[1], plain[1])
    np.testing.assert_array_equal(got[1], _jax_store(path, store_len))
    if store_len > frames:
        assert not got[1][frames:].any()


def test_pcm16_mono_passes_through(tmp_path):
    x = np.random.default_rng(3).integers(-32768, 32768, (5000, 1)).astype(
        "<i2")
    rate, got = native.decode_to_store(_wav(x, PCM, 16, 8000), 2000)
    off = (5000 - 2000) // 2
    assert rate == 8000
    np.testing.assert_array_equal(got, x[off:off + 2000, 0])


@pytest.mark.parametrize("data", [
    b"not a wav at all",
    _wav(np.zeros((10, 1), np.int32), PCM, 24),
    _wav(np.zeros((10, 1), "<i2"), PCM, 16)[:-10]],
    ids=["garbage", "pcm24", "cut_short"])
def test_unsupported_files_return_none(data):
    assert native.decode_to_store(data, 128) is None


def test_build_corpus_matches_the_jax_numpy_path(tmp_path, monkeypatch):
    wavs = jsynth(tmp_path / "w", n_per_class=3, num_classes=4,
                  clip_len=1500)
    lines = []
    port = build_corpus(wavs, tmp_path / "port", store_len=2048,
                        say=lines.append)
    assert lines == ["[corpus] 12 files decoded: native 12, numpy 0"]
    monkeypatch.setattr(jnative, "available", lambda: False)
    ref = jbuild_corpus(wavs, tmp_path / "ref", store_len=2048)
    for f in ("clips.npy", "labels.npy", "meta.json"):
        assert (port / f).read_bytes() == (ref / f).read_bytes(), f


def test_build_corpus_sends_what_the_decoder_lacks_to_numpy(tmp_path,
                                                           monkeypatch):
    """A 24-bit file among 16-bit ones: the numpy codec decodes it, and
    the corpus equals the reference's numpy path."""
    rng = np.random.default_rng(5)
    (tmp_path / "w" / "1").mkdir(parents=True)
    for i, (kind, bits) in enumerate([("pcm16", 16), ("pcm24", 24),
                                      ("pcm16", 16)]):
        (tmp_path / "w" / "1" / f"{i}.wav").write_bytes(
            _wav(_samples(kind, 700, 2, rng), PCM, bits))
    lines = []
    port = build_corpus(tmp_path / "w", tmp_path / "port", store_len=512,
                        say=lines.append)
    assert lines == ["[corpus] 3 files decoded: native 2, numpy 1"]
    monkeypatch.setattr(jnative, "available", lambda: False)
    ref = jbuild_corpus(tmp_path / "w", tmp_path / "ref", store_len=512)
    assert (port / "clips.npy").read_bytes() == \
        (ref / "clips.npy").read_bytes()


@pytest.mark.parametrize("threads", [0, 1, 4])
def test_gather_rows_matches_the_fancy_index(threads):
    rng = np.random.default_rng(threads)
    clips = rng.integers(-32768, 32768, (37, 513)).astype(np.int16)
    idx = rng.integers(0, 37, (5, 11))
    got = native.gather_rows(clips, idx, n_threads=threads)
    assert got.shape == (5, 11, 513)
    np.testing.assert_array_equal(got, clips[idx])
    np.testing.assert_array_equal(native.gather_rows_plain(clips, idx),
                                  clips[idx])


@pytest.mark.parametrize("gather", [native.gather_rows,
                                    native.gather_rows_plain],
                         ids=["native", "plain"])
def test_gather_rows_out_of_range_raises(gather):
    clips = np.zeros((4, 8), np.int16)
    for bad in ([0, 4], [-1], [[1, 2], [3, 7]]):
        with pytest.raises(ValueError, match="out of range"):
            gather(clips, np.array(bad))


def test_host_batcher_matches_the_reference(tmp_path, monkeypatch):
    """The port's HostBatcher (the native gather) against the JAX
    HostBatcher on its numpy gather, for [V, B] indices of several
    steps, on one corpus."""
    wavs = jsynth(tmp_path / "w", n_per_class=3, num_classes=4, clip_len=900)
    path = build_corpus(wavs, tmp_path / "c", store_len=1024)
    monkeypatch.setattr(jnative, "gather_rows", lambda *a, **k: None)
    port = HostBatcher(Corpus(path), batch_size=6, n_views=3, seed=7)
    ref = JHostBatcher(JCorpus(path), batch_size=6, n_views=3, seed=7)
    for step in range(4):
        (clips, labels), (jclips, jlabels) = port.get(step), ref.get(step)
        assert clips.shape == (3, 6, 1024) and clips.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(clips, jclips)
        np.testing.assert_array_equal(labels, jlabels)


def test_a_source_that_does_not_build_raises(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "HOST_SRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on"):
        _build.load_host("broken")
    assert not list((tmp_path / "build").rglob("*.so*"))


def test_the_host_library_builds_from_the_port_s_sources():
    port = _build.CSRC.parent
    for name in ("wavio", "batcher"):
        path = _build.host_library_path(name)
        assert path.parent.parent == _build.BUILD_ROOT
        assert (_build.HOST_SRC / f"{name}.cpp").is_relative_to(port)
        _build.load_host(name)
        assert path.exists()


def test_a_gather_error_reaches_the_prefetching_caller(tmp_path,
                                                      monkeypatch):
    """An error in the host batcher's prefetch thread (a gather that
    fails) is raised by next_prefetched, not left as a wait."""
    wavs = jsynth(tmp_path / "w", n_per_class=1, num_classes=2, clip_len=300)
    batcher = HostBatcher(Corpus(build_corpus(wavs, tmp_path / "c",
                                              store_len=512)), 2, 1)

    def failing(*a, **k):
        raise ValueError("index out of range for a test's corpus")
    monkeypatch.setattr(native, "gather_rows", failing)
    batcher.start_prefetch(0, 3)
    with pytest.raises(ValueError, match="out of range"):
        batcher.next_prefetched()
    batcher.close()
