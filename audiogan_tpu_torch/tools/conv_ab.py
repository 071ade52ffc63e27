#!/usr/bin/env python3
"""Times the row-conv kernels of one checkout of the port, for A/B runs of
two checkouts on one card.

    python3 audiogan_tpu_torch/tools/conv_ab.py --tree DIR --label NAME \\
        --out OUT/ab_NAME_1.json
    python3 audiogan_tpu_torch/tools/conv_ab.py --cc [--steps] --tree DIR \\
        --label NAME --out OUT/cc_NAME_1.json
    python3 audiogan_tpu_torch/tools/conv_ab.py --rates --tree DIR \\
        --label NAME --out OUT/rates_NAME_1.json
    python3 audiogan_tpu_torch/tools/conv_ab.py --summarize OUT/ab_*.json

The first form imports audiogan_tpu_torch and chip_smoke.py from DIR (the
checkout under test; its kernels build into DIR/build) and times, with
CUDA events (20 launches after 3 warm-up, as chip_smoke.py's timing
phase): K6 and K7 at the four fused sites (bf16, 2B = 128), K1' and K1 in
f32 at every flagship geometry, and K1' and K1 in bf16 at every flagship
geometry (the one-channel ones on the CUDA-core path in any checkout);
for each bf16 geometry also the device time (torch.profiler's kernel
time per call, which the host's time per call cannot pace);
K2 at chip_smoke.py's two ingest geometries ([64, 16384] store = clip,
and store 20000 with random offsets; peak mode): its protocol time (20
back-to-back wrapper calls) and its device time (torch.profiler's kernel
time per call, and events around one call queued behind a sleep);
then the flagship with every shuffle site fused (`--set
model.fused_shuffle_sites=-1`), ms per training step through
train.loop.train (chip_smoke.py's train phase: 2 warm-up steps, then 20
timed). With ``--cc`` it times instead K1' and K1 at every geometry of
their CUDA-core path on the main paths (music's cp=4 ranks and the
flagship's tp=2 ranks in f32 at B = 64, the one-channel bf16 layers of
the flagship and music, resample_22k in f32 at B = 8): the wrapper (and
its device time, torch.profiler's), the plain form, the library call
(cuDNN, no TF32) and, where the checkout has CUDA-core plans, each
candidate tile; with ``--steps`` also the f32 step of the flagship at
cp=2 and tp=2 and of music at cp=2 (B = 8, two gloo ranks on the card,
as chip_smoke.py's cp and tp phases): ms per step over 3 steps after
one, and the card side of chip_smoke.py's parity phase (each preset's
f32 step at batch 2: metrics and a digest of the parameters after it). With ``--rates`` (four cards) it runs instead ``cli train`` under
torchrun for music at cp=4 and the flagship at dp=2 x tp=2 and reports
steps/s (tools/dp_check.py::rate). Run the two checkouts in turns (A, B,
B, A) in one call. The second form averages each label's runs and
prints, per timed call, the times and the ratio of the second label to
the first (in the order the files are given); with --cc runs also
whether every run's output had the same bits.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import shutil
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


def cc_geometries(smoke) -> dict:
    """{set: (dtype, [(family, L)])} of the CUDA-core geometries timed
    with --cc."""
    import torch
    from audiogan_tpu_torch.cli import apply_overrides
    from audiogan_tpu_torch.config import get_preset
    from audiogan_tpu_torch.tools import step_checks as sc
    cfg = get_preset("wgan_gp_b64")
    mcfg = apply_overrides(get_preset("music_44k_dp16"),
                           ["mesh.dp=1"]).validate()
    rcfg = get_preset("resample_22k")

    def both(convt, conv):
        return [("convt1d", L) for L in convt] + [("conv1d", L) for L in conv]
    thin = []
    for c in (cfg, mcfg):
        for family, L in both(sc.generator_layers(c, BATCH)
                              + sc.critic_dx_layers(c, 2 * BATCH),
                              sc.critic_layers(c, 2 * BATCH)
                              + sc.generator_dx_layers(c, BATCH)):
            if not sc.tensor_core(family, L):
                thin.append((family, dict(L, name=f"{c.name} {L['name']}")))
    b = rcfg.train.batch_size
    return {"cp": (torch.float32, both(*sc.cp_rank_layers(apply_overrides(
                mcfg, ["mesh.cp=4"]).validate(), BATCH, 4))),
            "tp": (torch.float32, both(*sc.tp_rank_layers(cfg, BATCH, 2))),
            "thin": (torch.bfloat16, thin),
            "resample": (torch.float32, both(
                sc.generator_layers(rcfg, b) + sc.critic_dx_layers(rcfg, 2 * b),
                sc.critic_layers(rcfg, 2 * b)
                + sc.generator_dx_layers(rcfg, b)))}


def axis_step_ms(tree: Path) -> dict:
    """ms per f32 step (3 after 1) of the flagship at cp=2 and tp=2 and of
    music at cp=2, B = 8, two gloo ranks on this card."""
    import dataclasses
    from audiogan_tpu_torch.cli import apply_overrides
    from audiogan_tpu_torch.config import MeshCfg, get_preset
    from audiogan_tpu_torch.tools import dp_check
    from audiogan_tpu_torch.tools.step_checks import random_raw
    from audiogan_tpu_torch.train.step import num_views
    mcfg = apply_overrides(get_preset("music_44k_dp16"),
                           ["mesh.dp=1"]).validate()
    jobs = []
    for c, axis in ((get_preset("wgan_gp_b64"), "cp"),
                    (get_preset("wgan_gp_b64"), "tp"), (mcfg, "cp")):
        c = c.replace(mesh=MeshCfg(**{axis: 2}),
                      model=dataclasses.replace(c.model, phase_shuffle=0),
                      train=dataclasses.replace(c.train, dtype="float32",
                                                batch_size=8))
        raws = [random_raw(c, num_views(c), 8, 60 + i) for i in range(4)]
        for tag, batches in (("warm", raws[:1]), ("timed", raws[1:])):
            jobs.append({"name": f"{c.name} {axis}=2 {tag}", "fn": "steps",
                         "kw": {"cfg_json": c.to_json(), "batches": batches}})
    res = dp_check.spawn(2, jobs, tree / "build" / "conv_ab_steps",
                         device="cuda", backend="gloo", timeout_s=600)
    return {name[:-len(" timed")]: 1e3 * r[0]["seconds"] / 3
            for name, r in res.items() if name.endswith(" timed")}


def measure_cc(tree: Path, steps: bool) -> dict:
    smoke = _load_tree(tree)
    import torch
    from audiogan_tpu_torch.kernels import conv as kconv
    if not torch.cuda.is_available():
        raise SystemExit("conv_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    times, rows, digests = {}, [], {}
    for name, (dtype, geoms) in cc_geometries(smoke).items():
        for i, (family, L) in enumerate(geoms):
            kname, pname, args_of, work, library = smoke.FAMILIES[family]
            kernel, plain = getattr(kconv, kname), getattr(kconv, pname)
            x, w, b = smoke.conv_inputs(L, dtype, dev, seed=i)
            args = args_of(L)
            key = f"{name} {family} {L['name']}"
            call = lambda: kernel(x, w, b, *args)
            times[key] = smoke.cuda_ms(call)
            times[key + " device"] = smoke.profiled_device_ms(call, 20)
            y = kernel(x, w, b, *args)
            digests[key] = hashlib.sha256(
                y.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
                .cpu().numpy().tobytes()).hexdigest()[:16]
            f32 = dtype == torch.float32
            flops, nbytes = work(L, 4 if f32 else 2)
            bound_ms, bound_by = smoke.bound(
                flops, nbytes, smoke.PEAK_F32_FLOPS if f32
                else smoke.PEAK_BF16_FLOPS)
            row = {"set": name, "family": family, "geometry": L["name"],
                   "ms": times[key], "device_ms": times[key + " device"],
                   "bound_ms": bound_ms,
                   "bound_by": bound_by, "flops": flops,
                   "plain_ms": smoke.cuda_ms(lambda: plain(x, w, b, *args)),
                   "library_ms": smoke.cuda_ms(library(L, x, w, b))}
            if hasattr(smoke, "cc_tile_times"):
                row["tile"] = smoke.cc_tile_name(
                    smoke.cc_plan_of(family, L, dtype))
                row["tile_ms"] = smoke.cc_tile_times(family, L, x, w, b)
            rows.append(row)
            print(json.dumps(row), flush=True)
    if steps:
        for name, ms in axis_step_ms(tree).items():
            times[f"step ms {name}"] = ms
        for name, d in parity_digests(smoke).items():
            digests[f"parity step {name}"] = json.dumps(d, sort_keys=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return {"tree": str(tree), "card": card, "ms": times, "rows": rows,
            "digests": digests}


def parity_digests(smoke) -> dict:
    """The card side of chip_smoke.py's parity phase: each preset's f32
    step at batch 2 from one warm step, with the same draws; its metrics
    and a digest of both nets' parameters after it."""
    import dataclasses

    import torch
    from audiogan_tpu_torch.cli import apply_overrides
    from audiogan_tpu_torch.config import get_preset
    from audiogan_tpu_torch.train.state import create_train_state
    from audiogan_tpu_torch.train.step import (build_train_step, draw_step,
                                               num_views)
    dev = torch.device("cuda")
    flag = get_preset("wgan_gp_b64")
    cases = {"wgan_gp_b64": flag,
             "wgan_gp_b64 fused": apply_overrides(
                 flag, ["model.fused_shuffle_sites=-1"]).validate(),
             **{n: get_preset(n) for n in ("cond_gru_sc09", "dual_stft",
                                           "resample_22k")},
             "music_44k_dp16": apply_overrides(
                 get_preset("music_44k_dp16"), ["mesh.dp=1"]).validate()}
    out = {}
    for name, c in cases.items():
        cfg = c.replace(train=dataclasses.replace(
            c.train, dtype="float32", batch_size=2))
        st = create_train_state(cfg, device=dev)
        step = build_train_step(cfg, dev)
        step(st, *smoke.random_raw(cfg, num_views(cfg), 2, seed=10))
        draws = draw_step(cfg, st.seed, st.step, 2, torch.device("cpu"))
        m = step(st, *smoke.random_raw(cfg, num_views(cfg), 2, seed=11),
                 draws=draws)
        h = hashlib.sha256()
        for net in (st.g, st.d):
            for t in net.state_dict().values():
                h.update(t.detach().cpu().numpy().tobytes())
        out[name] = {"metrics": {k: float(v) for k, v in m.items()},
                     "params": h.hexdigest()[:16]}
    return out


def measure_rates(tree: Path) -> dict:
    """On four cards: cli train's steps/s of music at cp=4 and of the
    flagship at dp=2 x tp=2 (tools/dp_check.py::rate, steps 11-30)."""
    _load_tree(tree)
    import concurrent.futures
    from audiogan_tpu_torch.kernels import _build
    from audiogan_tpu_torch.tools import dp_check
    with concurrent.futures.ThreadPoolExecutor(6) as pool:
        list(pool.map(_build.build, ("convt1d", "conv1d", "ingest",
                                     "gru_scan", "sconv", "gru_cell")))
    # a fresh workdir: a run that found the last one's final checkpoint
    # would train nothing
    work = tree / "build" / "conv_ab_rates"
    shutil.rmtree(work, ignore_errors=True)
    runs = {"music_44k_dp16 cp=4": dp_check.rate(
                "music_44k_dp16", 4, work / "cp4", cp=4),
            "wgan_gp_b64 dp=2 tp=2": dp_check.rate(
                "wgan_gp_b64", 4, work / "tp2", tp=2)}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return {"tree": str(tree), "card": card, "runs": runs,
            "ms": {f"steps/s {k}": r["steps_per_s"] for k, r in runs.items()}}


def summarize(paths: list[Path]) -> list[dict]:
    runs: dict[str, list[dict]] = {}
    for p in paths:
        r = json.loads(p.read_text())
        runs.setdefault(r["label"], []).append(r["ms"])
    labels = list(runs)
    if len(labels) != 2:
        raise SystemExit(f"want runs of two labels, got {labels}")
    keys = [k for k in next(iter(runs.values()))[0]
            if all(r.get(k) is not None for rs in runs.values() for r in rs)]
    mean = {lab: {k: sum(r[k] for r in rs) / len(rs) for k in keys}
            for lab, rs in runs.items()}
    a, b = labels
    digests = {}
    for p in paths:
        r = json.loads(p.read_text())
        for k, d in r.get("digests", {}).items():
            digests.setdefault(k, set()).add(d)
    return [{"call": k, a: mean[a][k], b: mean[b][k],
             f"{b}/{a}": mean[b][k] / mean[a][k],
             **({"same_bits": len(digests[k]) == 1} if k in digests else {}),
             "runs": {lab: [r[k] for r in runs[lab]] for lab in labels}}
            for k in mean[a]] + [
        {"call": k, "same_bits": len(d) == 1} for k, d in digests.items()
        if k not in mean[a]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path)
    ap.add_argument("--label")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--summarize", nargs="+", type=Path)
    ap.add_argument("--cc", action="store_true",
                    help="time the CUDA-core path and the cp/tp steps")
    ap.add_argument("--steps", action="store_true",
                    help="with --cc: the f32 cp=2 and tp=2 steps too")
    ap.add_argument("--rates", action="store_true",
                    help="on four cards: cli train's steps/s at cp=4 "
                         "(music) and dp=2 x tp=2 (flagship)")
    args = ap.parse_args()
    if args.summarize:
        for row in summarize(args.summarize):
            print(json.dumps(row))
        return 0
    tree = args.tree.resolve()
    if args.cc:
        result = measure_cc(tree, args.steps)
    else:
        result = measure_rates(tree) if args.rates else measure(tree)
    result = {"label": args.label, **result}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
