"""A job for tools/dp_check.py::spawn: ``steps_job`` with every call of a
kernel wrapper of the port counted through kernels/hooks.py, which sees
the calls on the CPU too (where a wrapper runs its plain form and counts
no launch). Imports nothing of JAX, so the spawned ranks stay light."""

from collections import Counter

from audiogan_tpu_torch.kernels import hooks
from audiogan_tpu_torch.tools.dp_check import steps_job


class _Calls(hooks.KernelMode):
    """Each kernel wrapper's calls by its launch counter's name."""

    def __init__(self):
        super().__init__()
        self.calls: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))

    def kernel_call(self, name, fn, args, kwargs):
        self.calls[hooks.kernel_of(name).counter] += 1
        return fn(*args, **kwargs)


def counted_steps_job(dev, **kw) -> dict:
    """``steps_job(dev, **kw)`` and ``calls``: each wrapper's calls on
    this rank over the steps."""
    watch = _Calls()
    with watch:
        out = steps_job(dev, **kw)
    return {**out, "calls": dict(watch.calls)}
