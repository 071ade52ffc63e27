"""Metrics writer, the port of audiogan_tpu/utils/metrics.py: one JSON line
per log step in ``<workdir>/metrics.jsonl``, and TensorBoard scalars in
``<workdir>/tb`` where ``torch.utils.tensorboard`` imports (the reference
writes them where ``clu`` imports).

Each record is ``{"step", "time", ...}``: ``time`` the seconds since the
writer opened, rounded to 3 places, every metric a float rounded to 6, as
the reference rounds them. The training loop prints its own line per log
step, so this writer prints nothing.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Mapping


def _tensorboard_writer(logdir: Path):
    """A SummaryWriter, or None where torch.utils.tensorboard (and the
    tensorboard package under it) does not import."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(str(logdir))


class MetricsWriter:
    def __init__(self, workdir: str | Path, also_tensorboard: bool = True):
        self.dir = Path(workdir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.dir / "metrics.jsonl", "a", buffering=1)
        self._tb = _tensorboard_writer(self.dir / "tb") \
            if also_tensorboard else None
        self._t0 = time.time()

    def write(self, step: int, metrics: Mapping[str, Any]) -> dict:
        """Appends one record and returns it."""
        scalars = {k: float(v) for k, v in metrics.items()}
        rec = {"step": step, "time": round(time.time() - self._t0, 3),
               **{k: round(v, 6) for k, v in scalars.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        return rec

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
