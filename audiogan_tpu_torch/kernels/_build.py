"""Builds the port's CUDA sources with plain ``nvcc``, and its host C++
sources with ``g++``, and loads them.

Each ``csrc/<name>.cu`` becomes a shared library with a C interface,
loaded with ``ctypes``: no PyTorch headers, no ``ninja``, no lock file.
The library lands in ``build/torch_kernels/<sha256>/lib<name>.so`` at the
repository root, keyed by the source, the headers beside it and the nvcc
flags, so an edited source builds anew and an unchanged one is reused.
It is written under a temporary name and moved into place whole, so a
build cut off half way is never loaded. The tensor-core convs
(``csrc/igemm_tc.cuh``) look up libcuda's ``cuTensorMapEncodeTiled``
through the CUDA runtime, so nothing links ``-lcuda``.

The host route does the same for ``csrc/host/<name>.cpp`` (the wav decoder
and the host batcher's gather, data/native.py): ``g++ -O3 -fPIC -shared
-std=c++17 -pthread`` into ``build/torch_kernels/<sha256>/lib<name>.so``,
keyed by the source, the flags and the compiler's version. A failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
HOST_SRC = CSRC / "host"
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-pthread"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "audiogan_tpu_torch build on a machine with the "
                       "CUDA toolkit")


def source_hash(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_ROOT / source_hash(name) / f"lib{name}.so"


def _compile(cmd: list[str], source: Path, out: Path) -> Path:
    """Runs ``cmd + ["-o", tmp, source]`` unless ``out`` exists, then moves
    tmp into place whole; the compiler's output goes to a log beside it."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.part", dir=out.parent)
    os.close(fd)
    rel = (source.relative_to(CSRC.parent)
           if source.is_relative_to(CSRC.parent) else source)
    try:
        proc = subprocess.run([*cmd, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        (out.parent / f"{source.stem}.log").write_text(proc.stdout
                                                       + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(cmd[0]).name} failed on {rel}:\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build(name: str) -> Path:
    """Compiles csrc/<name>.cu unless its library is already built."""
    return _compile([nvcc_path(), *NVCC_FLAGS], CSRC / f"{name}.cu",
                    library_path(name))


def gxx_path() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the host library of "
                           "audiogan_tpu_torch builds with g++")
    return found


def _gxx_version() -> str:
    return subprocess.run([gxx_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout


def host_library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_gxx_version().encode())
    h.update((HOST_SRC / f"{name}.cpp").read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/host/<name>.cpp, built with g++ at first
    use."""
    key = f"host/{name}"
    lib = _LIBS.get(key)
    if lib is None:
        path = _compile([gxx_path(), *GXX_FLAGS], HOST_SRC / f"{name}.cpp",
                        host_library_path(name))
        lib = _LIBS[key] = ctypes.CDLL(str(path))
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
    return lib
