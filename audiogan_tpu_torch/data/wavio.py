"""RIFF/WAVE reader and 16-bit PCM writer (numpy only), as
audiogan_tpu/data/wavio.py: PCM 8/16/24/32-bit and IEEE float32 in, mono
by channel mean; 16-bit PCM out."""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_PCM = 1
_IEEE_FLOAT = 3
_EXTENSIBLE = 0xFFFE


def read_wav(path: str | Path, mono: bool = True) -> tuple[int, np.ndarray]:
    """Read a RIFF wav file -> (sample_rate, float32 samples in [-1, 1]),
    shape [T] if mono else [T, C]."""
    return decode_wav(Path(path).read_bytes(), path, mono)


def decode_wav(data: bytes, path: str | Path = "<bytes>",
               mono: bool = True) -> tuple[int, np.ndarray]:
    """``read_wav`` of the file's bytes (``path`` names it in errors)."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos, fmt, fmt_body, raw = 12, None, b"", None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8: pos + 8 + size]
        if cid == b"fmt ":
            fmt, fmt_body = struct.unpack_from("<HHIIHH", body, 0), body
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_fmt, n_ch, rate, _, _, bits = fmt
    if audio_fmt == _EXTENSIBLE:
        # the format code is the first 2 bytes of the SubFormat GUID
        if len(fmt_body) < 26:
            raise ValueError(f"{path}: EXTENSIBLE wav without SubFormat")
        audio_fmt = struct.unpack_from("<H", fmt_body, 24)[0]
    if audio_fmt == _IEEE_FLOAT and bits == 32:
        x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    elif audio_fmt == _PCM and bits == 16:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif audio_fmt == _PCM and bits == 32:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif audio_fmt == _PCM and bits == 8:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
             - 128.0) / 128.0
    elif audio_fmt == _PCM and bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        i32 = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        x = ((i32 << 8) >> 8).astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"{path}: unsupported wav format={audio_fmt} "
                         f"bits={bits}")
    if n_ch > 1:
        x = x[: (len(x) // n_ch) * n_ch].reshape(-1, n_ch)
        if mono:
            x = x.mean(axis=1)
    return rate, x


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
