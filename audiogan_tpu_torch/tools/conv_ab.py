#!/usr/bin/env python3
"""Times the row-conv kernels of one checkout of the port, for A/B runs of
two checkouts on one card.

    python3 audiogan_tpu_torch/tools/conv_ab.py --tree DIR --label NAME \\
        --out OUT/ab_NAME_1.json
    python3 audiogan_tpu_torch/tools/conv_ab.py --summarize OUT/ab_*.json

The first form imports audiogan_tpu_torch and chip_smoke.py from DIR (the
checkout under test; its kernels build into DIR/build) and times, with
CUDA events (20 launches after 3 warm-up, as chip_smoke.py's timing
phase): K6 and K7 at the four fused sites (bf16, 2B = 128), K1' and K1 in
f32 at every flagship geometry, and K1' and K1 in bf16 at every flagship
geometry (the one-channel ones on the CUDA-core tiles in any checkout);
for each bf16 geometry also the device time (torch.profiler's kernel
time per call, which the host's time per call cannot pace);
K2 at chip_smoke.py's two ingest geometries ([64, 16384] store = clip,
and store 20000 with random offsets; peak mode): its protocol time (20
back-to-back wrapper calls) and its device time (torch.profiler's kernel
time per call, and events around one call queued behind a sleep);
then the flagship with every shuffle site fused (`--set
model.fused_shuffle_sites=-1`), ms per training step through
train.loop.train (chip_smoke.py's train phase: 2 warm-up steps, then 20
timed). Run the two checkouts in turns (A, B, B, A) in one call. The second form
averages each label's runs and prints, per timed call, the times and the
ratio of the second label to the first (in the order the files are
given).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

BATCH = 64


def _load_tree(tree: Path):
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("tree_chip_smoke",
                                                  tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def measure(tree: Path) -> dict:
    smoke = _load_tree(tree)
    import torch
    from audiogan_tpu_torch.config import get_preset
    from audiogan_tpu_torch.kernels import conv as kconv
    from audiogan_tpu_torch.kernels import sconv as ksconv
    if not torch.cuda.is_available():
        raise SystemExit("conv_ab: no CUDA device")
    dev = torch.device("cuda")
    cfg = get_preset("wgan_gp_b64")
    fam = {"convt1d": smoke.generator_layers(cfg, BATCH)
           + smoke.critic_dx_layers(cfg, 2 * BATCH),
           "conv1d": smoke.critic_layers(cfg, 2 * BATCH)
           + smoke.generator_dx_layers(cfg, BATCH)}
    calls = {"convt1d": (kconv.conv_transpose1d_ba, smoke.convt_args),
             "conv1d": (kconv.conv1d_ba, smoke.conv1d_args)}
    times = {}
    for family, layers in fam.items():
        kernel, args_of = calls[family]
        for dtype, dname in ((torch.float32, "f32"),
                             (torch.bfloat16, "bf16")):
            for i, L in enumerate(layers):
                x, w, b = smoke.conv_inputs(L, dtype, dev, seed=i)
                args = args_of(L)
                call = lambda: kernel(x, w, b, *args)
                times[f"{family} {dname} {L['name']}"] = smoke.cuda_ms(call)
                if dtype == torch.bfloat16:
                    times[f"{family} {dname} {L['name']} device"] = (
                        smoke.profiled_device_ms(call))
    for transpose, layers in ((False, smoke.fused_site_layers(cfg, 2 * BATCH)),
                              (True, smoke.fused_site_dx_layers(
                                  cfg, 2 * BATCH))):
        name = "sconvt1d" if transpose else "sconv1d"
        kernel = ksconv.sconvt1d if transpose else ksconv.sconv1d_ba
        args_of = smoke.sconvt_args if transpose else smoke.sconv_args
        for i, L in enumerate(layers):
            *tensors, offs = smoke.sconv_inputs(L, torch.bfloat16, dev, i,
                                                transpose)
            args = args_of(L)
            call = lambda: kernel(*tensors, offs, *args)
            times[f"{name} bf16 {L['name']}"] = smoke.cuda_ms(call)
            times[f"{name} bf16 {L['name']} device"] = (
                smoke.profiled_device_ms(call))
    from audiogan_tpu_torch.kernels import ingest as king
    for c in smoke.ingest_cases(dev):
        args = (c["raw"], c["offs"], c["clip"], "peak")
        call = lambda: king.ingest_fused(*args)
        times[f"ingest protocol {c['name']}"] = smoke.cuda_ms(call)
        times[f"ingest device (profiler) {c['name']}"] = (
            smoke.profiled_device_ms(call))
        times[f"ingest device (queued) {c['name']}"] = (
            smoke.queued_device_ms(call))
    from audiogan_tpu_torch.cli import apply_overrides
    fcfg = apply_overrides(cfg, ["model.fused_shuffle_sites=-1"]).validate()
    times["wgan_gp_b64 fused_shuffle_sites=-1 ms per step"] = (
        1e3 / smoke.train_phase(fcfg, dev, {}, {})["steps_per_s"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return {"tree": str(tree), "card": card, "ms": times}


def summarize(paths: list[Path]) -> list[dict]:
    runs: dict[str, list[dict]] = {}
    for p in paths:
        r = json.loads(p.read_text())
        runs.setdefault(r["label"], []).append(r["ms"])
    labels = list(runs)
    if len(labels) != 2:
        raise SystemExit(f"want runs of two labels, got {labels}")
    mean = {lab: {k: sum(r[k] for r in rs) / len(rs) for k in rs[0]}
            for lab, rs in runs.items()}
    a, b = labels
    return [{"call": k, a: mean[a][k], b: mean[b][k],
             f"{b}/{a}": mean[b][k] / mean[a][k],
             "runs": {lab: [r[k] for r in runs[lab]] for lab in labels}}
            for k in mean[a]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path)
    ap.add_argument("--label")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--summarize", nargs="+", type=Path)
    args = ap.parse_args()
    if args.summarize:
        for row in summarize(args.summarize):
            print(json.dumps(row))
        return 0
    result = {"label": args.label, **measure(args.tree.resolve())}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
