#!/usr/bin/env python3
"""Times a training step with its backward on the calling thread (what
train/step.py runs) and on the autograd engine's worker thread (torch's
default), in turns in one process on one card.

    python3 audiogan_tpu_torch/tools/step_threads_ab.py

For wgan_gp_b64 and cond_gru_sc09 (B=64, bf16): 2 warm-up steps, then 10
timed (host clock around steps that end in a device sync), in the order
calling, worker, worker, calling, repeated twice; prints one JSON line per
preset with each variant's runs and their median.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

CALLING = torch.autograd.set_multithreading_enabled


def _worker_thread(mode):
    """Stands in for set_multithreading_enabled: leaves torch's default."""
    return contextlib.nullcontext()


def main() -> int:
    from audiogan_tpu_torch.config import get_preset
    from audiogan_tpu_torch.train.state import create_train_state
    from audiogan_tpu_torch.train.step import build_train_step
    if not torch.cuda.is_available():
        raise SystemExit("step_threads_ab: no CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    for name in ("wgan_gp_b64", "cond_gru_sc09"):
        cfg = get_preset(name)
        b = cfg.train.batch_size
        state = create_train_state(cfg, device=dev)
        step = build_train_step(cfg, dev)
        gen = torch.Generator().manual_seed(0)
        raw = (torch.randn(cfg.loss.n_critic, b, cfg.data.store_len,
                           generator=gen) * 6000).clamp(-32768, 32767)
        raw = raw.to(torch.int16).to(dev)
        labels = torch.zeros(cfg.loss.n_critic, b, dtype=torch.long,
                             device=dev)
        runs = {"calling": [], "worker": []}
        try:
            for variant in ("calling", "worker", "worker", "calling") * 2:
                torch.autograd.set_multithreading_enabled = (
                    CALLING if variant == "calling" else _worker_thread)
                for _ in range(2):
                    step(state, raw, labels)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(10):
                    step(state, raw, labels)
                torch.cuda.synchronize()
                runs[variant].append((time.perf_counter() - t0) * 100)
        finally:
            torch.autograd.set_multithreading_enabled = CALLING
        print(json.dumps({"preset": name, "ms_per_step": runs, "median": {
            k: statistics.median(v) for k, v in runs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
