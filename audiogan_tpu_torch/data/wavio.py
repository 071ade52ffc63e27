"""16-bit PCM RIFF/WAVE writer (numpy only), as audiogan_tpu/data/wavio.py."""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_PCM = 1


def wav_bytes(rate: int, x: np.ndarray) -> bytes:
    """Encode float [-1,1] (or int16) samples as 16-bit PCM wav bytes."""
    x = np.asarray(x)
    if x.dtype != np.int16:
        x = np.clip(x, -1.0, 1.0)
        x = (x * 32767.0).round().astype(np.int16)
    n_ch = 1 if x.ndim == 1 else x.shape[1]
    raw = x.astype("<i2").tobytes()
    byte_rate = rate * n_ch * 2
    hdr = b"RIFF" + struct.pack("<I", 36 + len(raw)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, _PCM, n_ch, rate,
                                 byte_rate, n_ch * 2, 16)
    hdr += b"data" + struct.pack("<I", len(raw))
    return hdr + raw


def write_wav(path: str | Path, rate: int, x: np.ndarray) -> None:
    """Write float [-1,1] (or int16) samples as a 16-bit PCM wav file."""
    Path(path).write_bytes(wav_bytes(rate, x))
