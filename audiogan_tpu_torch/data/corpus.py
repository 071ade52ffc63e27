"""Packed int16 corpus and the deterministic index stream, the port of
audiogan_tpu/data/corpus.py (numpy path only).

``build_corpus`` decodes every wav once into ``clips.npy`` (int16
[N, store_len]), ``labels.npy`` (int32 [N]) and ``meta.json``, in the
same format as the JAX package, so either package reads the other's
corpus. ``batch_indices`` is ``HostBatcher._indices``: the same
numpy generator seeded with (seed, step), so the index stream is
bit-identical to the reference's.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from audiogan_tpu_torch.data.wavio import read_wav


def build_corpus(wav_dir: str | Path, out_dir: str | Path, store_len: int,
                 source_rate: int | None = None) -> Path:
    """Pack a directory tree of wavs; labels from an integer parent
    directory name (SC09 layout), else -1. Clips are center-cropped or
    zero-padded to store_len at their native rate; one rate per corpus."""
    wav_dir, out_dir = Path(wav_dir), Path(out_dir)
    paths = sorted(wav_dir.rglob("*.wav"))
    if not paths:
        raise FileNotFoundError(f"no .wav files under {wav_dir}")
    clips = np.zeros((len(paths), store_len), dtype=np.int16)
    labels = np.full((len(paths),), -1, dtype=np.int32)
    rate = source_rate
    for i, p in enumerate(paths):
        r, x = read_wav(p)
        n = min(len(x), store_len)
        off = max((len(x) - store_len) // 2, 0)
        # scale by 32768 so int16 sources pass through bit-exactly
        clips[i, :n] = np.clip(np.rint(x[off:off + n] * 32768.0),
                               -32768, 32767).astype(np.int16)
        if rate is None:
            rate = r
        elif r != rate:
            raise ValueError(f"{p}: rate {r} != corpus rate {rate}")
        if p.parent.name.lstrip("-").isdigit():
            labels[i] = int(p.parent.name)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.save(out_dir / "clips.npy", clips)
    np.save(out_dir / "labels.npy", labels)
    (out_dir / "meta.json").write_text(json.dumps({
        "num_clips": len(paths), "store_len": store_len,
        "source_rate": rate,
        "num_classes": int(labels.max() + 1) if labels.max() >= 0 else 0,
    }))
    return out_dir


class Corpus:
    """Memmap view over a packed corpus directory."""

    def __init__(self, corpus_dir: str | Path):
        d = Path(corpus_dir)
        self.clips = np.load(d / "clips.npy", mmap_mode="r")
        self.labels = np.load(d / "labels.npy", mmap_mode="r")
        self.meta = json.loads((d / "meta.json").read_text())

    def __len__(self) -> int:
        return self.clips.shape[0]


def batch_indices(n_clips: int, batch_size: int, n_views: int, seed: int,
                  step: int) -> np.ndarray:
    """Clip indices [n_views, batch_size] of one step, sampled with
    replacement from a (seed, step)-pure stream."""
    rng = np.random.default_rng((seed, step))
    return rng.integers(0, n_clips, size=(n_views, batch_size))
