#!/usr/bin/env python3
"""Steps/s of the loop's replayed route against its eager route, each
preset on one card, every run a fresh process.

    python3 -m audiogan_tpu_torch.tools.replay_rates [--out DIR]
        [--presets P ...] [--steps N]

For each preset (music_44k_dp16 as ``--set mesh.dp=1``; the flagship
also with every shuffle site fused), ``cli train`` for N steps (default
23: 2 warm-up, 20 timed, the last under torch.profiler and left out of
the rate) through tools/dp_check.py's ``--cli_worker``,
once replayed (the loop's route on the card) and once with every step
eager (train.loop.train's ``replay=False``), one after the other in
fresh processes, so neither runs after a torch.profiler session in its
process (chip_smoke.py's phases profile before they train). Prints one
JSON line per preset: both rates over the timed steps (the host clock
of the loop's log lines), the replay over eager, both runs' last-step
device and wall ms (torch.profiler around that step or replay), peak
memory, the capture's nodes and seconds, and whether the two runs' last
checkpoints are equal to the bit; then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PRESETS = {"wgan_gp_b64": (), "wgan_gp_b64_fused":
           ("model.fused_shuffle_sites=-1",), "cond_gru_sc09": (),
           "dual_stft": (), "music_44k_dp16": ("mesh.dp=1",),
           "resample_22k": ()}
WARMUP = 2


def run(preset: str, sets: tuple, mode: str, steps: int, base: Path,
        device: str = "cuda") -> dict:
    """One ``cli train`` of the preset through ``--cli_worker MODE``: its
    timed rate, the worker's record of rank 0 and the workdir."""
    workdir = base / f"{preset}_{mode}"
    shutil.rmtree(workdir, ignore_errors=True)
    name = preset.removesuffix("_fused")
    cmd = [sys.executable, "-m", "audiogan_tpu_torch.tools.dp_check",
           "--cli_worker", mode, str(workdir / "ranks"), "train",
           "--preset", name, "--total_steps", str(steps), "--workdir",
           str(workdir), "--no_tensorboard", "--device", device,
           "--set", "train.log_every=1",
           "--set", "train.sample_every=0"]
    for item in sets:
        cmd += ["--set", item]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{preset} {mode}: exit {proc.returncode}\n"
                           f"{proc.stderr[-3000:]}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    secs = [ln["seconds"] for ln in lines if "step" in ln and "d_loss" in ln]
    # the last step runs under torch.profiler (``--cli_worker``): left out
    timed = steps - WARMUP - 1
    rec = json.loads((workdir / "ranks" / "rank0.json").read_text())
    return {"steps_per_s": timed / (secs[-2] - secs[WARMUP - 1]),
            "route": rec["route"], "graph": rec["graph"],
            "last_step": rec["last_step"],
            "peak_memory_gib": rec["peak_memory_gib"], "workdir": workdir}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/replay_rates",
                    help="the runs' workdirs (relative to the repo)")
    ap.add_argument("--presets", nargs="+", choices=sorted(PRESETS),
                    default=list(PRESETS))
    ap.add_argument("--steps", type=int, default=WARMUP + 20 + 1)
    ap.add_argument("--device", default="cuda",
                    help="cpu runs both routes eagerly (a dry run)")
    args = ap.parse_args(argv)
    from audiogan_tpu_torch.tools.step_checks import same_checkpoint
    base = ROOT / args.out
    for preset in args.presets:
        runs = {mode: run(preset, PRESETS[preset], mode, args.steps, base,
                          args.device)
                for mode in ("replay", "eager")}
        last = f"ckpt/{args.steps}.pt"
        equal = same_checkpoint(runs["replay"]["workdir"] / last,
                                runs["eager"]["workdir"] / last)
        graph = runs["replay"]["graph"] or {}
        print(json.dumps({
            "preset": preset, "steps": args.steps,
            "timed_steps": args.steps - WARMUP - 1,
            "steps_per_s": {m: r["steps_per_s"] for m, r in runs.items()},
            "replay_over_eager": (runs["replay"]["steps_per_s"]
                                  / runs["eager"]["steps_per_s"]),
            "routes": {m: r["route"] for m, r in runs.items()},
            "last_step": {m: {k: (r["last_step"] or {}).get(k) for k in
                              ("wall_ms", "device_ms")}
                          for m, r in runs.items()},
            "peak_memory_gib": {m: r["peak_memory_gib"]
                                for m, r in runs.items()},
            "capture": {k: graph.get(k) for k in
                        ("step", "nodes", "capture_seconds")},
            "checkpoint_tensors_equal": equal}), flush=True)
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True)
        print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
