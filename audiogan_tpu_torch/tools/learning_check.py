#!/usr/bin/env python3
"""The port's learning check: the bf16 flagship trained through `cli train`
in two processes, the second resuming the first's checkpoint, beside the
reference's bf16 soak on the same synthetic corpus.

    python3 audiogan_tpu_torch/tools/learning_check.py [--workdir build/learn]

Runs ``cli train --preset wgan_gp_b64 --total_steps 500 --set
train.ckpt_every=500`` and then the same with ``--total_steps 1000`` (which
resumes at 500), as scripts/r5_queue.sh ran the reference's soak
(``--data_dir ''``, bf16, ckpt_every 500; log_every 50). Prints a markdown
table, per 50 steps, of the port's w_dist, gp, gp_grad_norm and g_loss
beside the first 20 rows of bench/soak_r5_metrics.jsonl, then one JSON line
with the trends the check reads (w_dist's mean over the first 250 steps
and over the last 500; gp's range), the median steps_per_sec of the
50-step windows after the first of each process, the step-500 save's
seconds and bytes, and the card (nvidia-smi). The random streams differ
(torch cannot replay JAX's threefry), so only ranges and trends compare.
With --out DIR it also writes the table, the JSON and the port's
metrics.jsonl there.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SOAK = ROOT / "bench" / "soak_r5_metrics.jsonl"
KEYS = ("w_dist", "gp", "gp_grad_norm", "g_loss")
SEGMENTS = (500, 1000)
GP_RANGE = (0.5, 6.0)


def train_segment(workdir: Path, total: int) -> dict:
    cmd = [sys.executable, "-m", "audiogan_tpu_torch.cli", "train",
           "--preset", "wgan_gp_b64", "--total_steps", str(total),
           "--set", "train.ckpt_every=500", "--no_tensorboard",
           "--workdir", str(workdir)]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr[-4000:]}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    resume = [ln["resume"]["step"] for ln in lines if "resume" in ln]
    return {"total_steps": total, "seconds": time.time() - t0,
            "resumed_from": resume[0] if resume else None,
            "ckpts": [ln["ckpt"] for ln in lines if "ckpt" in ln]}


def table(port: dict[int, dict], soak: dict[int, dict]) -> str:
    head = ("| step | " + " | ".join(f"port {k}" for k in KEYS) + " | "
            + " | ".join(f"soak {k}" for k in KEYS) + " |")
    rows = [head, "|" + " --- |" * (1 + 2 * len(KEYS))]
    for step in sorted(port):
        p, s = port[step], soak.get(step, {})
        rows.append(f"| {step} | " + " | ".join(
            f"{p[k]:.4g}" for k in KEYS) + " | " + " | ".join(
            f"{s[k]:.4g}" if k in s else "—" for k in KEYS) + " |")
    return "\n".join(rows)


def trends(recs: dict[int, dict]) -> dict:
    first = [recs[s]["w_dist"] for s in recs if s <= 250]
    last = [recs[s]["w_dist"] for s in recs if s > 500]
    gp = [r["gp"] for r in recs.values()]
    return {"w_dist_first_250_mean": statistics.fmean(first),
            "w_dist_last_500_mean": statistics.fmean(last),
            "w_dist_falls": statistics.fmean(last) < statistics.fmean(first),
            "gp_min": min(gp), "gp_max": max(gp),
            "gp_inside": GP_RANGE[0] <= min(gp) and max(gp) <= GP_RANGE[1]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=str(ROOT / "build" / "learn"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    workdir = Path(args.workdir)
    shutil.rmtree(workdir, ignore_errors=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    segments = [train_segment(workdir, n) for n in SEGMENTS]
    if segments[1]["resumed_from"] != SEGMENTS[0]:
        raise AssertionError(f"the second process resumed from "
                             f"{segments[1]['resumed_from']}, not "
                             f"{SEGMENTS[0]}")
    recs = {r["step"]: r for r in map(
        json.loads, (workdir / "metrics.jsonl").read_text().splitlines())}
    soak = {r["step"]: r for r in map(json.loads,
                                      SOAK.read_text().splitlines()[:20])}
    # the first window of each process holds its warm-up
    windows = [r["steps_per_sec"] for s, r in sorted(recs.items())
               if s not in (50, SEGMENTS[0] + 50)]
    save = [c for c in segments[0]["ckpts"] if c["step"] == SEGMENTS[0]][0]
    summary = {"card": card, "segments": segments,
               "port": trends(recs), "soak": trends(soak),
               "steps_per_sec_median": statistics.median(windows),
               "steps_per_sec_range": [min(windows), max(windows)],
               "save_500": save}
    md = table(recs, soak)
    print(md)
    print(json.dumps(summary), flush=True)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "learning_check.md").write_text(md + "\n")
        (out / "learning_check.json").write_text(json.dumps(summary,
                                                            indent=1))
        shutil.copy(workdir / "metrics.jsonl",
                    out / "learning_check_metrics.jsonl")
    return 0


if __name__ == "__main__":
    sys.exit(main())
