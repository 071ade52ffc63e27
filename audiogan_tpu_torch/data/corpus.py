"""Packed int16 corpus, the deterministic index stream and the host
batcher, the port of audiogan_tpu/data/corpus.py.

``build_corpus`` decodes every wav once into ``clips.npy`` (int16
[N, store_len]), ``labels.npy`` (int32 [N]) and ``meta.json``, in the
same format as the JAX package, so either package reads the other's
corpus. It decodes through the native decoder (data/native.py), and a
file the decoder does not support through the numpy codec, which gives
the same bytes where both read a file. ``batch_indices`` is the
reference's ``HostBatcher._indices``: the same numpy generator seeded
with (seed, step), so the index stream is bit-identical to the
reference's. ``HostBatcher`` gathers a step's clips on the host from that
stream with the native threaded row gather (data/native.py::gather_rows,
numpy's ``clips[idx]`` byte for byte), with a prefetch thread.
"""

from __future__ import annotations

import json
import queue
import threading
from collections import Counter
from pathlib import Path
from typing import Callable

import numpy as np

from audiogan_tpu_torch.data import native

PREFETCH = 2             # batches the prefetch thread samples ahead


def _quiet(_: str) -> None:
    pass


def build_corpus(wav_dir: str | Path, out_dir: str | Path, store_len: int,
                 source_rate: int | None = None,
                 say: Callable[[str], None] = _quiet) -> Path:
    """Pack a directory tree of wavs; labels from an integer parent
    directory name (SC09 layout), else -1. Clips are center-cropped or
    zero-padded to store_len at their native rate; one rate per corpus.
    ``say`` gets one line: how many files each codec decoded."""
    wav_dir, out_dir = Path(wav_dir), Path(out_dir)
    paths = sorted(wav_dir.rglob("*.wav"))
    if not paths:
        raise FileNotFoundError(f"no .wav files under {wav_dir}")
    clips = np.zeros((len(paths), store_len), dtype=np.int16)
    labels = np.full((len(paths),), -1, dtype=np.int32)
    rate = source_rate
    codecs: Counter = Counter()
    for i, p in enumerate(paths):
        data = p.read_bytes()
        decoded = native.decode_to_store(data, store_len)
        codecs["native" if decoded is not None else "numpy"] += 1
        # a format the native decoder does not support: the numpy codec
        r, clips[i] = (decoded if decoded is not None else
                       native.decode_to_store_plain(data, store_len, p))
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
    say(f"[corpus] {len(paths)} files decoded: native {codecs['native']}, "
        f"numpy {codecs['numpy']}")
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


def index_row(step: int, idx, labels, chunk: int):
    """Step ``step``'s row of the resident blocks idx and labels [chunk,
    num_views, B] of the steps [m chunk, (m+1) chunk) (data.index_chunk
    > 0): the row at step % chunk, a view, no copy."""
    k = step % chunk
    return idx[k], labels[k]


class HostBatcher:
    """Deterministic (seed, step) -> batch sampler with optional prefetch.

    ``get(step)`` returns (clips int16 [n_views, B, store_len], gathered
    by the native row gather, labels int32 [n_views, B]), or with
    ``indices_only`` (idx int32 [n_views,
    B], labels): the resident-corpus step gathers on the device from the
    same index stream, so both modes train to the same bits. ``rows``
    (a data-parallel rank's slice of the batch axis) keeps only those
    columns of the global step's indices, so a rank gathers only its
    clips.
    """

    def __init__(self, corpus: Corpus, batch_size: int, n_views: int,
                 seed: int = 0, indices_only: bool = False,
                 rows: slice | None = None):
        self.corpus = corpus
        self.batch_size = batch_size
        self.n_views = n_views
        self.seed = seed
        self.indices_only = indices_only
        self.rows = slice(0, batch_size) if rows is None else rows
        self.local_batch = self.rows.stop - self.rows.start
        self._q: queue.Queue | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def _indices(self, step: int) -> np.ndarray:
        return batch_indices(len(self.corpus), self.batch_size,
                             self.n_views, self.seed, step)

    def get(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        idx = self._indices(step)[:, self.rows]
        labels = np.ascontiguousarray(self.corpus.labels[idx])
        if self.indices_only:
            return idx.astype(np.int32), labels
        return native.gather_rows(self.corpus.clips, idx), labels

    def start_prefetch(self, first_step: int, last_step: int) -> None:
        """A thread samples steps [first_step, last_step) ahead into a
        queue of PREFETCH batches, then None; an error of the thread's
        (a gather's) is raised by ``next_prefetched``."""
        self._q = queue.Queue(maxsize=PREFETCH)
        self._stop.clear()

        def worker():
            try:
                for s in range(first_step, last_step):
                    if self._stop.is_set():
                        return
                    self._q.put((s, self.get(s)))
            except BaseException as err:
                self._q.put(err)
                return
            self._q.put(None)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next_prefetched(self) -> tuple[int, tuple[np.ndarray, np.ndarray]] | None:
        if self._q is None:
            raise RuntimeError("call start_prefetch first")
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self) -> None:
        """Stops the prefetch thread (it may be blocked on a full queue)."""
        self._stop.set()
        while self._thread is not None and self._thread.is_alive():
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
        self._thread = None
