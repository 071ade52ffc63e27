"""One hook around every kernel wrapper, for the loop's tools that must
see the port's own kernels.

A kernel wrapper launches through ctypes into a tensor that
``torch.empty`` made, so a ``TorchDispatchMode`` never sees an op that
produced the kernel's output. ``train/debug_nans.py`` checks each
kernel's output for NaN here, and ``train/step_graph.py`` ties each
kernel call to the CUDA graph nodes its launch adds and names the last
launch when a capture fails.

``ACTIVE`` is None except while one of those tools runs (a
``KernelMode``); then every wrapper call goes through
``ACTIVE.kernel_call(name, fn, args, kwargs)``, which must call
``fn(*args, **kwargs)`` and return its result. Off, a wrapper pays one
global read and one call frame.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

from torch.utils._python_dispatch import TorchDispatchMode

# the tool watching the kernels, or None
ACTIVE = None


class Kernel(NamedTuple):
    ref: str              # the reference's name for it (PERF.md §6)
    functions: tuple      # its __global__ functions (csrc/): a launch's nodes
    counter: str          # chip_smoke.py's launch counter


# the port's kernels by their wrappers' names
KERNELS = {
    "conv_transpose1d_ba": Kernel(
        "K1", ("igemm_kernel", "gemm_kernel", "thin_cout_kernel"), "convt1d"),
    "conv1d_ba": Kernel(
        "K1'", ("igemm_kernel", "gemm_kernel", "thin_cin_kernel"), "conv1d"),
    "ingest_fused": Kernel("K2", ("ingest_cluster_kernel",), "ingest"),
    "gru_cell_fwd": Kernel(
        "K3", ("gru_cell_kernel", "gru_cell_tc_kernel"), "gru_cell"),
    "gru_scan_fwd": Kernel("K4", ("scan_fwd_persistent",), "gru_scan"),
    "gru_scan_bwd": Kernel("K5", ("scan_bwd_persistent",), "gru_scan_bwd"),
    "sconv1d_ba": Kernel(
        "K6", ("igemm_kernel", "conv1d_tile_kernel"), "sconv1d"),
    "sconvt1d": Kernel(
        "K7", ("igemm_kernel", "convt1d_tile_kernel"), "sconvt1d"),
    # no Pallas kernel's port: Adam's update from device scalars
    "adam_update": Kernel("Adam", ("adam_update_kernel",), "adam")}

# the decorated wrappers by name, for the counts of their launches
WRAPPERS: dict = {}


def label(wrapper: str) -> str:
    """The name a kernel call goes by: "K1 conv_transpose1d_ba"."""
    return f"{KERNELS[wrapper].ref} {wrapper}"


def kernel_of(name: str) -> Kernel:
    """The row of the kernel a call's ``label`` names."""
    return KERNELS[name.split()[-1]]


def kernel(fn: Callable) -> Callable:
    """Decorates a kernel wrapper (named in KERNELS) with the hook."""
    name = label(fn.__name__)

    @functools.wraps(fn)
    def call(*args, **kwargs):
        tool = ACTIVE
        if tool is None:
            return fn(*args, **kwargs)
        return tool.kernel_call(name, fn, args, kwargs)

    WRAPPERS[fn.__name__] = call
    return call


def launch_counts() -> dict:
    """Every launch counter of every wrapper (``launches`` and its
    per-path ``launches_*``), by (wrapper, attribute): a replayed CUDA
    graph launches what its capture counted (train/step_graph.py)."""
    return {(name, attr): value for name, w in WRAPPERS.items()
            for attr, value in vars(w).items()
            if attr.startswith("launches")}


def add_launches(delta: dict) -> None:
    """Adds ``delta`` (of ``launch_counts``' form) to the counters."""
    for (name, attr), n in delta.items():
        w = WRAPPERS[name]
        setattr(w, attr, getattr(w, attr) + n)


class KernelMode(TorchDispatchMode):
    """A dispatch mode that also watches the port's kernels: entered, it
    is ``ACTIVE`` (the tool before it comes back on exit). Subclasses
    define ``__torch_dispatch__`` and ``kernel_call``."""

    def __enter__(self):
        global ACTIVE
        self._saved, ACTIVE = ACTIVE, self
        return super().__enter__()

    def __exit__(self, *exc):
        global ACTIVE
        ACTIVE = self._saved
        return super().__exit__(*exc)

    def kernel_call(self, name: str, fn: Callable, args, kwargs):
        raise NotImplementedError
