"""The model parts of a training step, for a trace and for debug_nans.

``SPANS`` names the methods and module functions that make up the
models' parts: the port's counterpart of the flax module scopes that
name the ops in the reference's trace. ``profiler_spans`` wraps each in
``torch.profiler.record_function`` while a profiling window is open
(train/loop.py with train.profile_dir; chip_smoke.py's profiled step),
and puts the originals back after, so a step outside a window pays no
host time for them. ``span_device_ms`` splits a profile's device time by
span. ``StepTrace`` is the loop's profiling window. ``span_of_stack``
finds the innermost span in a Python stack (the op that
train/debug_nans.py names, or the forward traceback that anomaly mode
keeps on an autograd node).
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import inspect
import re
from pathlib import Path

import torch

# profiler ranges around the models' parts (innermost wins): the method
# or module function each wraps while a step is profiled
SPANS = (("generator", "audiogan_tpu_torch.models.wavegan",
          "WaveGANGenerator.forward"),
         ("generator", "audiogan_tpu_torch.models.gru",
          "GRUGenerator.forward"),
         ("wave_critic", "audiogan_tpu_torch.models.wavegan",
          "WaveGANDiscriminator.forward"),
         ("stft_critic", "audiogan_tpu_torch.models.stft_critic",
          "STFTCritic.forward"),
         ("stft_critic.spectrogram", "audiogan_tpu_torch.models.stft_critic",
          "stft_magnitude"),
         ("stft_critic.conv2d", "audiogan_tpu_torch.models.stft_critic",
          "conv2d_same"),
         ("stft_loss.spectrogram", "audiogan_tpu_torch.losses.stft_loss",
          "stft_magnitude"))
SPAN_NAMES = frozenset(name for name, _, _ in SPANS)
GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm")
BACKWARD_NODE = "autograd::engine::evaluate_function: "


def _owner(module: str, attr: str):
    """(the object holding attr's leaf, the leaf's name)."""
    owner = importlib.import_module(module)
    *path, leaf = attr.split(".")
    for part in path:
        owner = getattr(owner, part)
    return owner, leaf


@contextlib.contextmanager
def profiler_spans():
    """Each of SPANS wrapped in torch.profiler.record_function; the
    originals are put back after."""
    from torch.profiler import record_function

    def wrap(name, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return spanned
    saved = []
    for name, module, attr in SPANS:
        owner, leaf = _owner(module, attr)
        saved.append((owner, leaf, getattr(owner, leaf)))
        setattr(owner, leaf, wrap(name, getattr(owner, leaf)))
    try:
        yield
    finally:
        for owner, leaf, fn in reversed(saved):
            setattr(owner, leaf, fn)


def span_device_ms(prof) -> dict:
    """Device ms of the profiled kernels by span. A kernel counts to the
    innermost span around the op that launched it; an op the autograd
    engine runs in backward counts to the span of the forward op that
    made its node (the same sequence number), and what that backward
    records for a double backward inherits the span. Also the part of
    each span that cuBLAS GEMMs (aten::mm, bmm, addmm) took: in the STFT
    spans, the DFT matmuls."""
    from torch.autograd import DeviceType
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CPU),
                    key=lambda e: (e.time_range.start, -e.time_range.end))
    span_of, seq_span = {}, {}
    total, gemm = {}, {}
    for e in events:
        parent = span_of.get(id(e.cpu_parent))
        backward = e.name.startswith(BACKWARD_NODE)
        if e.name in SPAN_NAMES:
            span = e.name
        elif backward:
            span = seq_span.get(e.sequence_nr, parent)
        else:
            span = parent
        span_of[id(e)] = span
        if span is not None and not backward and e.sequence_nr >= 0:
            seq_span.setdefault(e.sequence_nr, span)
        ms = sum(k.duration for k in e.kernels) / 1e3
        if ms:
            key = span or "rest"
            total[key] = total.get(key, 0.0) + ms
            if e.name in GEMM_OPS:
                gemm[key] = gemm.get(key, 0.0) + ms
    return {k: {"ms": v, "gemm_ms": gemm.get(k, 0.0)}
            for k, v in sorted(total.items(), key=lambda kv: -kv[1])}


@functools.cache
def _span_lines() -> tuple:
    """(file, first line, last line, span) of each of SPANS' sources."""
    out = []
    for name, module, attr in SPANS:
        owner, leaf = _owner(module, attr)
        fn = inspect.unwrap(getattr(owner, leaf))
        lines, first = inspect.getsourcelines(fn)
        out.append((inspect.getsourcefile(fn), first,
                    first + len(lines) - 1, name))
    return tuple(out)


_FRAME = re.compile(r'File "([^"]+)", line (\d+)')


def span_of_stack(frames) -> str | None:
    """The innermost span in a stack: ``frames`` are (file, line) pairs,
    outermost first, or the strings of ``traceback.format_stack``."""
    found = None
    for fr in frames:
        if isinstance(fr, str):
            m = _FRAME.search(fr)
            if m is None:
                continue
            fr = (m.group(1), int(m.group(2)))
        path, line = fr
        for src, lo, hi, name in _span_lines():
            if path == src and lo <= line <= hi:
                found = name
    return found


class StepTrace:
    """The loop's train.profile_dir window: a torch.profiler trace (CPU
    activity, and the card's kernels on the card) with the model parts'
    spans and one range per step ("train_step N"), written on ``close``
    as a Chrome/Perfetto trace, one file per process with its global
    rank in the name. ``close`` waits for the window's work to finish
    first."""

    def __init__(self, out_dir, rank: int, device: torch.device):
        from torch.profiler import ProfilerActivity, profile
        self.path = Path(out_dir) / f"trace_rank{rank}.json"
        self.device = device
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._open = contextlib.ExitStack()
        self._open.enter_context(profiler_spans())
        self.prof = self._open.enter_context(profile(activities=acts))

    def step(self, step: int):
        from torch.profiler import record_function
        return record_function(f"train_step {step}")

    def close(self) -> Path:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._open.close()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        return self.path
