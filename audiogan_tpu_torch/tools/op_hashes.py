"""Finds the first op of a CPU training run whose output differs between
processes (ROADMAP Queue 3, "CPU only: at 8 intra-op threads...").

    python -m audiogan_tpu_torch.tools.op_hashes --threads 8 --runs 16 \\
        --jobs 8 --out /tmp/op_hashes

``--runs`` fresh child processes (``--jobs`` at once, which loads the
cores), at ``--threads`` intra-op threads (OMP_NUM_THREADS, as ``cli
train --device cpu`` runs), each run ``cli train --preset tiny_sc09
--batch_size 2 --total_steps 6 --set train.ckpt_every=3`` in a new
workdir (its synthetic corpus built there); the odd ones under a
TorchDispatchMode that hashes every output (and every argument written
in place) of every aten op, in order, the even ones plain. The parent
prints one JSON line: which runs' checkpoints (steps 3 and 6) differ
from the first run's (plain and hashed apart), and the first op at
which the hashed runs disagree (its index, name and the runs holding
each hash), or none.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from audiogan_tpu_torch.train.debug_nans import ALLOCATE, written_by

# the fault's command (ROADMAP Queue 3): 6 steps, a checkpoint every 3
STEPS, CKPT_EVERY = 6, 3


class OpHashes(TorchDispatchMode):
    """(op name, sha1 of the bytes each output and in-place argument
    holds) of every aten op, in order; a view, or an op that allocates
    without writing, hashes nothing (its bytes are another op's, or
    garbage)."""

    def __init__(self):
        super().__init__()
        self.ops: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        h = hashlib.sha1()
        written = ([] if func.overloadpacket in ALLOCATE or func.is_view
                   else written_by(func, args, kwargs, out))
        for t in written:
            if t.layout == torch.strided and t.numel():
                h.update(t.detach().reshape(-1).contiguous()
                         .view(torch.uint8).numpy().tobytes())
        self.ops.append((func.name(), h.hexdigest()[:16]))
        return out


def child(args) -> None:
    """One fresh process: ``cli train`` of a new workdir (its corpus
    built there), hashed or plain; the hashes (none when plain) into
    ``args.out``."""
    from audiogan_tpu_torch.cli import main
    mode = OpHashes()
    with mode if args.hashed else contextlib.nullcontext():
        main(["train", "--preset", "tiny_sc09", "--device", "cpu",
              "--batch_size", "2", "--total_steps", str(STEPS),
              "--set", f"train.ckpt_every={CKPT_EVERY}",
              "--workdir", str(Path(args.out).with_suffix(""))])
    Path(args.out).write_text(json.dumps(mode.ops))


def _first_difference(hashed: dict) -> dict | None:
    """The first op index at which the hashed runs disagree."""
    n = min(map(len, hashed.values()), default=0)
    first = next(iter(hashed.values()), [])
    for i in range(n):
        seen: dict = {}
        for r, ops in hashed.items():
            seen.setdefault(ops[i][1], []).append(r)
        if len(seen) > 1:
            return {"index": i, "op": first[i][0],
                    "previous_ops": [op for op, _ in first[max(i - 3, 0):i]],
                    "runs_by_hash": list(seen.values())}
    return None


def parent(args) -> dict:
    from audiogan_tpu_torch.tools.step_checks import same_checkpoint
    out = Path(args.out)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)

    def run(r: int) -> None:
        subprocess.run([sys.executable, "-m",
                        "audiogan_tpu_torch.tools.op_hashes", "--child",
                        "--threads", str(args.threads),
                        "--out", str(out / f"run_{r}.json")]
                       + (["--hashed"] if r % 2 else []), check=True,
                       capture_output=True,
                       env={**os.environ,
                            "OMP_NUM_THREADS": str(args.threads)})
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        list(pool.map(run, range(args.runs)))
    hashed = {r: json.loads((out / f"run_{r}.json").read_text())
              for r in range(1, args.runs, 2)}

    def differs(r: int) -> list[int]:
        """The checkpoints of run r that differ from run 0's."""
        apart = []
        for step in range(CKPT_EVERY, STEPS + 1, CKPT_EVERY):
            name = f"ckpt/{step}.pt"
            try:
                same_checkpoint(out / "run_0" / name,
                                out / f"run_{r}" / name)
            except AssertionError:
                apart.append(step)
        return apart
    return {"threads": args.threads, "runs": args.runs, "at_once": args.jobs,
            "differ_from_run_0": {
                "plain": {r: d for r in range(2, args.runs, 2)
                          if (d := differs(r))},
                "hashed": {r: d for r in hashed if (d := differs(r))}},
            "ops_hashed": max(map(len, hashed.values()), default=0),
            "first_difference": _first_difference(hashed)}


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--runs", type=int, default=16)
    ap.add_argument("--out", required=True)
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--hashed", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="children run at once (load on the cores)")
    args = ap.parse_args(argv)
    if args.child:
        child(args)
        return 0
    print(json.dumps(parent(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
