#!/usr/bin/env python3
"""Times the GRU kernels and the two presets' step rates and samplers of
one checkout of the port, for A/B runs of two checkouts on one card.

    python3 audiogan_tpu_torch/tools/gru_ab.py --tree DIR --label NAME \\
        --out OUT/gru_ab_NAME_1.json
    python3 audiogan_tpu_torch/tools/conv_ab.py --summarize OUT/gru_ab_*.json

The first form imports audiogan_tpu_torch and chip_smoke.py from DIR (the
checkout under test; its kernels build into DIR/build) and measures, bf16:
K4 (without h_seq) and K5 through their wrappers at cond_gru_sc09's scan
(B=64, H=512, F=256, 256 frames; CUDA events, 5 calls after 1 warm-up, as
chip_smoke.py's timing phase), K3 at cond_gru_sc09's cell (x and h [64,
512]; back-to-back launches, 50 after 3 warm-up, and one launch's device
time, events around it queued behind a sleep kernel, median of 50) beside
torch.nn.GRUCell's, the training steps/s of cond_gru_sc09 and
of wgan_gp_b64 through train.loop.train (chip_smoke.py's train phase: 2
warm-up steps, then 20 timed), and each preset's sampler, ms per batch of
64 (chip_smoke.py's sampler_rate). Run the two checkouts in turns (A, B,
B, A) in one call; conv_ab.py's --summarize averages each label's runs.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import subprocess
import sys
from pathlib import Path

SOURCES = ("convt1d", "conv1d", "ingest", "gru_scan", "sconv", "gru_cell")


def _queued_ms(fn, reps: int = 50) -> float:
    """One call's device time: CUDA events around it, queued behind a
    sleep kernel so the host's enqueue time is hidden; the median."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def measure(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    from audiogan_tpu_torch.tools.conv_ab import _load_tree
    smoke = _load_tree(tree)
    import torch
    from audiogan_tpu_torch.config import get_preset
    from audiogan_tpu_torch.kernels import _build
    from audiogan_tpu_torch.kernels import gru as kgru
    from audiogan_tpu_torch.models import build_generator
    from audiogan_tpu_torch.models.init import init_params
    from audiogan_tpu_torch.serve import export_sampler, load_sampler
    if not torch.cuda.is_available():
        raise SystemExit("gru_ab: no CUDA device")
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_build.build, SOURCES))
    dev = torch.device("cuda")
    gcfg = get_preset("cond_gru_sc09")
    b, hid, feat, n = smoke.gru_dims(gcfg)
    args = smoke.gru_inputs(gcfg, torch.bfloat16, dev)
    out, h_seq = kgru.gru_scan_fwd(*args, n, with_h=True)
    gen = torch.Generator(dev).manual_seed(1)
    ct = torch.randn(b, n, feat, generator=gen, device=dev).bfloat16()
    ms = {"gru_scan bf16": smoke.cuda_ms(
              lambda: kgru.gru_scan_fwd(*args, n), iters=5, warmup=1),
          "gru_scan_bwd bf16": smoke.cuda_ms(
              lambda: kgru.gru_scan_bwd(ct, *args, out, h_seq), iters=5,
              warmup=1)}
    cell = smoke.gru_cell_inputs(gcfg, torch.bfloat16, dev)
    lib = torch.nn.GRUCell(cell[0].shape[1], cell[1].shape[1], device=dev,
                           dtype=torch.bfloat16)
    with torch.no_grad():
        for p, v in ((lib.weight_ih, cell[2].T), (lib.weight_hh, cell[3].T),
                     (lib.bias_ih, cell[4]), (lib.bias_hh, cell[5])):
            p.copy_(v)
        for name, fn in (("gru_cell bf16", lambda: kgru.gru_cell_fwd(*cell)),
                         ("torch.nn.GRUCell bf16",
                          lambda: lib(cell[0], cell[1]))):
            ms[name] = smoke.cuda_ms(fn, iters=50)
            ms[name + " device"] = _queued_ms(fn)
    for cfg in (gcfg, get_preset("wgan_gp_b64")):
        trained = smoke.train_phase(cfg, dev, {}, {})
        ms[f"{cfg.name} ms per step"] = 1e3 / trained["steps_per_s"]
        art = tree / "build" / f"gru_ab_artifact_{cfg.name}"
        g = init_params(build_generator(cfg, device=dev), seed=0)
        export_sampler(cfg, g.state_dict(), num=smoke.BATCH, out_dir=art)
        ms[f"{cfg.name} sampler ms"] = smoke.sampler_rate(
            load_sampler(art), cfg)["ms"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return {"tree": str(tree), "card": card, "ms": ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", type=Path, required=True)
    args = ap.parse_args()
    result = {"label": args.label, **measure(args.tree.resolve())}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
