"""The native host tier: the wav decoder of ``build_corpus`` and the host
batcher's row gather, the port's counterpart of audiogan_tpu/data/native.py.

Both are the port's own C++ (csrc/host/wavio.cpp, csrc/host/batcher.cpp),
built with g++ at first use into build/torch_kernels/ and loaded with
ctypes (kernels/_build.py::load_host). A failed build or load raises:
nothing falls back to numpy for want of the library. Each has a numpy
plain form here, which gives the same bytes: ``decode_to_store_plain``
(the numpy codec, data/wavio.py, scaled as the reference's build_corpus
scales it) and ``gather_rows_plain`` (numpy's fancy index).

The decoder covers PCM 8/16/32-bit and IEEE float32 at any channel count
(the reference decoder's coverage); it reports any other file as
unsupported, and ``decode_to_store`` then returns None, so the caller
decodes that file with the numpy codec, as the reference does.
"""

from __future__ import annotations

import ctypes

import numpy as np

from audiogan_tpu_torch.data.wavio import decode_wav
from audiogan_tpu_torch.kernels._build import load_host

ABI_VERSION = 1
_I16P = ctypes.POINTER(ctypes.c_int16)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _lib(name: str, abi: str) -> ctypes.CDLL:
    lib = load_host(name)
    getattr(lib, abi).restype = ctypes.c_int32
    if getattr(lib, abi)() != ABI_VERSION:
        raise RuntimeError(f"csrc/host/{name}.cpp: ABI {getattr(lib, abi)()}"
                           f", want {ABI_VERSION}")
    return lib


def _decoder() -> ctypes.CDLL:
    lib = _lib("wavio", "ag_abi_version")
    fn = lib.ag_decode_wav_to_store
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, _I16P, ctypes.c_int64,
                   ctypes.POINTER(ctypes.c_int32)]
    return lib


def _gatherer() -> ctypes.CDLL:
    lib = _lib("batcher", "ag_batcher_abi_version")
    fn = lib.ag_gather_rows
    fn.restype = ctypes.c_int64
    fn.argtypes = [_I16P, ctypes.c_int64, ctypes.c_int64, _I64P,
                   ctypes.c_int64, _I16P, ctypes.c_int32]
    return lib


def decode_to_store(data: bytes, store_len: int
                    ) -> tuple[int, np.ndarray] | None:
    """The wav bytes -> (rate, int16 [store_len]): mono, center-cropped
    or zero-padded; None when the decoder does not support the file."""
    out = np.zeros(store_len, dtype=np.int16)
    rate = ctypes.c_int32(0)
    n = _decoder().ag_decode_wav_to_store(
        data, len(data), out.ctypes.data_as(_I16P), store_len,
        ctypes.byref(rate))
    return None if n < 0 else (int(rate.value), out)


def decode_to_store_plain(data: bytes, store_len: int, path="<bytes>"
                          ) -> tuple[int, np.ndarray]:
    """``decode_to_store`` with the numpy codec; raises ValueError for a
    file it cannot read."""
    rate, x = decode_wav(data, path)
    out = np.zeros(store_len, dtype=np.int16)
    n = min(len(x), store_len)
    off = max((len(x) - store_len) // 2, 0)
    # scale by 32768 so int16 sources pass through bit-exactly
    out[:n] = np.clip(np.rint(x[off:off + n] * 32768.0), -32768,
                      32767).astype(np.int16)
    return rate, out


def _check(clips: np.ndarray) -> None:
    if clips.dtype != np.int16 or clips.ndim != 2 or \
            not clips.flags["C_CONTIGUOUS"]:
        raise ValueError(f"clips must be C-contiguous int16 [N, L], got "
                         f"{clips.dtype} {clips.shape}")


def gather_rows(clips: np.ndarray, idx: np.ndarray,
                n_threads: int = 0) -> np.ndarray:
    """clips[idx] (shape idx.shape + (store_len,)) gathered by the native
    library over ``n_threads`` threads (0: one per core); ValueError for
    an index out of range."""
    _check(clips)
    flat = np.ascontiguousarray(idx, dtype=np.int64).reshape(-1)
    out = np.empty((flat.size, clips.shape[1]), dtype=np.int16)
    n = _gatherer().ag_gather_rows(
        clips.ctypes.data_as(_I16P), clips.shape[0], clips.shape[1],
        flat.ctypes.data_as(_I64P), flat.size, out.ctypes.data_as(_I16P),
        n_threads)
    if n != flat.size:
        raise ValueError(f"native gather failed (rc={n}): index out of "
                         f"range for corpus of {clips.shape[0]} clips")
    return out.reshape(*np.shape(idx), clips.shape[1])


def gather_rows_plain(clips: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``gather_rows`` with numpy's fancy index."""
    _check(clips)
    idx = np.asarray(idx)
    if idx.size and (idx.min() < 0 or idx.max() >= clips.shape[0]):
        raise ValueError(f"index out of range for corpus of "
                         f"{clips.shape[0]} clips")
    return np.ascontiguousarray(clips[idx])
