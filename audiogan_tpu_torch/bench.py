"""The headline harness, the port's counterpart of the reference's ``cli
bench`` (audiogan_tpu/cli.py:144-153, 257-266), which runs the root
bench.py: train steps per second of the one compiled step on staged
clips, and the audio-seconds per second of the compiled sampler at an
HBM-sized batch, one JSON line per preset.

    python -m audiogan_tpu_torch.cli bench --preset wgan_gp_b64
    python -m audiogan_tpu_torch.bench --preset all --steps 2
    python -m audiogan_tpu_torch.cli bench --preset tiny_sc09 --device cpu

The port's compiled routes take the place of the reference's jit'd ones:

  train    bench.py:49-127. The reference's synthetic int16 clips and
           labels (numpy ``default_rng(0)``, ``standard_normal * 8000``,
           clipped, [num_views, B, store_len]) are staged on the device
           once and reach train/step_graph.py::StepGraph as resident
           inputs. Two warm-up steps: the first eager, the second
           captured as one CUDA graph and replayed; every timed step is a
           replay (``StagedStep``). A round of ``--steps`` steps ends in
           the host fetch of ``d_loss`` from the graph's metric buffer, as
           the reference's; ``timed_rounds`` is its protocol.
  sample   bench.py:148-172. serve/sample_graph.py::SampleGraph at
           ``default_sample_num`` (or ``--sample_batch``), labels
           ``arange(num) % num_classes`` for a conditional preset; two
           warm-up batches and ten timed ones, each z drawn for its seed
           into the graph's buffer then a replay, and one host fetch of
           one element at the end. No batch is copied to the host; the
           reference copies none either.
  preset   bench.py:187-233: ``train.dtype`` forced (bfloat16 by default,
           so tiny_sc09 and resample_22k train and sample in bf16), and
           a preset's mesh cut to one device (dp = cp = tp = 1).

On the CPU (``--device cpu``, the tests) the same objects run eagerly
through the kernels' plain forms. The line keeps the reference's keys
but its proxy fields, whose denominators are measurements of the
reference's own benchmark folder; ``kernels``, ``kernels_g`` and
``kernels_d`` name the route the port ran ("cuda": the hand-written CUDA
kernels, replayed as CUDA graphs; "plain" on the CPU): the port has one
route and no tier switch, so ``--kernels`` raises. ``device`` names the
card and its power limit (nvidia-smi), or "cpu". The capture, its graph
pool and the peak memory of each part go to stderr as one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import statistics
import subprocess
import sys
import time
from typing import Callable

import numpy as np
import torch

from audiogan_tpu_torch.cli import apply_overrides
from audiogan_tpu_torch.config import Config, MeshCfg, get_preset
from audiogan_tpu_torch.device import resolve_device
from audiogan_tpu_torch.kernels import hooks
from audiogan_tpu_torch.models import build_generator
from audiogan_tpu_torch.models.init import init_params
from audiogan_tpu_torch.serve.sample_graph import SampleGraph
from audiogan_tpu_torch.train.state import create_train_state
from audiogan_tpu_torch.train.step import build_train_step, num_views
from audiogan_tpu_torch.train.step_graph import StepGraph

# bench.py:175-176
PRESETS = ("tiny_sc09", "wgan_gp_b64", "cond_gru_sc09", "dual_stft",
           "resample_22k", "music_44k_dp16")


def default_sample_num(cfg: Config) -> int:
    """The sampler's batch for the audio-seconds metric (bench.py:133-145):
    num * clip_len * model_dim held at the reference's flagship ceiling of
    4096 * 16384 * 64, within [64, 16384] clips. 4096 for the flagship,
    cond_gru_sc09 and dual_stft, 16384 for tiny_sc09 and resample_22k
    (dim 16), 380 for music_44k_dp16."""
    budget = 4096 * 16384 * 64
    return max(64, min(16384, budget // (cfg.data.clip_len
                                         * cfg.model.model_dim)))


def timed_rounds(one_round: Callable[[], float], min_rounds: int = 4,
                 max_stab: int = 8, agree_pct: float = 0.02,
                 pause_s: float = 0.3) -> tuple[float, dict]:
    """The reference's timing protocol (bench.py:98-127) around
    ``one_round`` (a rate): rounds until two in a row agree within
    ``agree_pct``, at most ``max_stab``; the agreeing pair kept, then
    rounds ``pause_s`` apart until ``min_rounds`` are kept. Returns the
    median of the kept rounds and the reference's record: every round
    (``rounds_steps_per_sec``), the rounds left out
    (``stabilize_rounds``) and the kept rounds' spread in percent of the
    median (``rounds_spread_pct``)."""
    rounds = [one_round()]
    while len(rounds) < max_stab:
        rounds.append(one_round())
        if (abs(rounds[-1] - rounds[-2])
                / max(rounds[-1], rounds[-2]) <= agree_pct):
            break
    stable_at = max(0, len(rounds) - 2)
    while len(rounds) - stable_at < min_rounds:
        time.sleep(pause_s)
        rounds.append(one_round())
    measured = rounds[stable_at:]
    med = statistics.median(measured)
    return med, {
        "rounds_steps_per_sec": [round(x, 4) for x in rounds],
        "stabilize_rounds": stable_at,
        "rounds_spread_pct": round(
            100.0 * (max(measured) - min(measured)) / med, 2)}


def bench_config(preset: str, dtype: str = "bfloat16") -> Config:
    """The preset as the reference's bench_one runs it (bench.py:191-201):
    ``train.dtype`` set through the CLI's ``--set`` path, and a mesh of
    more than one device cut to one."""
    cfg = apply_overrides(get_preset(preset), [f"train.dtype={dtype}"])
    m = cfg.mesh
    if m.dp * m.cp * m.tp > 1:
        cfg = cfg.replace(mesh=MeshCfg())
    return cfg.validate()


def staged_batch(cfg: Config, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's synthetic batch (bench.py:71-80), staged once on
    ``device``: int16 clips [num_views, B, store_len] and int32 labels
    [num_views, B]."""
    rng = np.random.default_rng(0)
    n, b = num_views(cfg), cfg.train.batch_size
    clips = (rng.standard_normal((n, b, cfg.data.store_len)) * 8000
             ).clip(-32768, 32767).astype(np.int16)
    labels = rng.integers(0, max(cfg.data.num_classes, 1),
                          size=(n, b)).astype(np.int32)
    return (torch.from_numpy(clips).to(device),
            torch.from_numpy(labels).to(device))


class StagedStep:
    """The training step on the staged batch from a fresh train state of
    the config's seed: each call runs one step and returns its metrics.
    On the card the first call runs eagerly, the
    second captures the step as one CUDA graph and replays it, every
    later call replays it (the loop's route, train/loop.py); the metrics
    of a replay are the graph's fixed buffers, to be read before the next
    call. On the CPU every call runs eagerly (``route``)."""

    def __init__(self, cfg: Config, device):
        self.device = torch.device(device)
        self.state = create_train_state(cfg, device=self.device)
        self.inputs = staged_batch(cfg, self.device)
        self.graph = StepGraph(cfg, build_train_step(cfg, self.device),
                               self.device, resident=(0, 1))
        self.route = "replay" if self.device.type == "cuda" else "eager"
        self.calls = 0

    def __call__(self) -> dict:
        g, state = self.graph, self.state
        g.fill(state, self.inputs)
        if self.route == "eager" or self.calls == 0:
            out = g.eager(state)
        else:
            if g.graph is None:
                g.capture(state)
            out = g.replay(state)
        self.calls += 1
        return out

    def summary(self) -> dict:
        """The route; under replay the capture's nodes, seconds, pool and
        each port kernel's launches per step."""
        if self.graph.graph is None:
            return {"route": self.route}
        s = self.graph.summary()
        return {"route": self.route, "nodes": s["nodes"],
                "capture_seconds": s["capture_seconds"],
                "pool_bytes": graph_pool_bytes(self.graph.graph),
                "launches_per_step": _launches(self.graph.launch_delta)}


class BenchSampler:
    """G at batch ``num`` on SampleGraph's fixed buffers (the served
    sampler's body): replayed as one CUDA graph on the card, eager on the
    CPU. ``labels`` (int64 [num]) are copied in once; each call draws z
    for its seed into the graph's buffer and returns the batch
    [num, clip_len] f32 on the device, the graph's own output buffer
    under replay (read it before the next call)."""

    def __init__(self, cfg: Config, params: dict, num: int, device,
                 labels: np.ndarray | None = None):
        self.graph = SampleGraph(cfg, params, num, torch.device(device))
        self.labels = labels

    def __call__(self, seed: int) -> torch.Tensor:
        g = self.graph
        with torch.inference_mode():
            g.fill(seed, self.labels)
            self.labels = None     # the buffer keeps them
            return g.replay() if g.route == "replay" else g.body()

    def summary(self) -> dict:
        s = self.graph.summary()
        if s["route"] == "replay":
            s = {**s, "pool_bytes": graph_pool_bytes(self.graph.graph)}
        return s


def sample_labels(cfg: Config, num: int) -> np.ndarray | None:
    """``arange(num) % num_classes`` for a conditional preset
    (bench.py:157-159), else None."""
    n_cls = cfg.data.num_classes
    return np.arange(num, dtype=np.int64) % n_cls if n_cls else None


def generator_params(cfg: Config, device) -> dict:
    """G's weights as create_train_state makes them from the config's
    seed (bench.py:154 samples a fresh train state's G)."""
    g = init_params(build_generator(cfg, device=device), cfg.train.seed)
    return g.state_dict()


def _launches(delta: dict) -> dict:
    """Launches by kernel label from a (wrapper, attribute) count delta."""
    return {hooks.label(w): n for (w, attr), n in sorted(delta.items())
            if attr == "launches" and n}


def _stream_of(stream):
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def _peak_bytes(device: torch.device) -> int | None:
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device)


def _reset_peak(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def graph_pool_bytes(graph) -> int | None:
    """The bytes of the segments a captured graph's private memory pool
    holds (the allocator's snapshot), or None where the snapshot does not
    name its segments' pools."""
    snap = torch.cuda.memory_snapshot()
    if any("segment_pool_id" not in seg for seg in snap):
        return None
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in snap
               if tuple(seg["segment_pool_id"]) == pool)


def bench_train(cfg: Config, device, n_steps: int = 10, n_warmup: int = 2,
                **rounds) -> tuple[float, dict, dict]:
    """Steps per second of ``StagedStep`` under ``timed_rounds`` (keyword
    arguments ``rounds``): (median, the reference's round record, the
    step's summary with the part's peak memory)."""
    device = torch.device(device)
    _reset_peak(device)
    step = StagedStep(cfg, device)
    for _ in range(n_warmup):
        metrics = step()
    float(metrics["d_loss"])

    def one_round() -> float:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            metrics = step()
        float(metrics["d_loss"])          # a host fetch: waits for the card
        return n_steps / (time.perf_counter() - t0)

    med, info = timed_rounds(one_round, **rounds)
    summary = {**step.summary(), "steps": step.calls,
               "peak_memory_bytes": _peak_bytes(device)}
    return med, info, summary


def bench_sample(cfg: Config, device, num: int, n_warmup: int = 2,
                 n_iters: int = 10) -> tuple[float, dict]:
    """Audio-seconds per second of ``BenchSampler`` at batch ``num``
    (bench.py:148-172): n_warmup batches, then n_iters timed ones, one
    host fetch after each run of batches. Returns (rate, the sampler's
    summary with the part's peak memory)."""
    device = torch.device(device)
    _reset_peak(device)
    sampler = BenchSampler(cfg, generator_params(cfg, device), num, device,
                           sample_labels(cfg, num))
    # the fetch is queued on the sampler's stream, behind its batches
    with _stream_of(sampler.graph.stream):
        for i in range(n_warmup):
            out = sampler(i)
        float(out[0, 0])
        t0 = time.perf_counter()
        for i in range(n_iters):
            out = sampler(100 + i)
        float(out[0, 0])
        dt = time.perf_counter() - t0
    audio_sec = n_iters * num * cfg.data.clip_len / cfg.data.sample_rate
    summary = {**sampler.summary(),
               "peak_memory_bytes": _peak_bytes(device)}
    return audio_sec / dt, summary


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them
    ("NVIDIA H100 80GB HBM3, 700.00 W"), or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[device.index or 0].strip()


def bench_one(preset: str, dtype: str = "bfloat16",
              kernels: str | None = None, steps: int = 10,
              sample_batch: int | None = None, device=None,
              say: Callable[[str], None] | None = None) -> dict:
    """One preset's line (bench.py:187-233, without its proxy fields);
    ``say`` gets the parts' summaries as one JSON line. ``kernels`` picks
    the reference's kernel tier; the port has one route and no tier
    switch, so any value raises, before the card is touched."""
    if kernels is not None:
        raise ValueError(f"--kernels {kernels}: the port runs one route, its "
                         "hand-written CUDA kernels, and has no kernel "
                         "tiers to choose")
    device = resolve_device(device)
    cfg = bench_config(preset, dtype)
    num = sample_batch or default_sample_num(cfg)
    steps_per_sec, train_info, train_summary = bench_train(cfg, device,
                                                           n_steps=steps)
    audio_sec_per_sec, sample_summary = bench_sample(cfg, device, num)
    route = "cuda" if device.type == "cuda" else "plain"
    if say is not None:
        say(json.dumps({"bench": cfg.name, "train": train_summary,
                        "sample": sample_summary}))
    return {
        "metric": "train_steps_per_sec",
        "value": round(steps_per_sec, 4),
        "unit": "steps/s",
        **train_info,
        "audio_sec_per_sec": round(audio_sec_per_sec, 2),
        "sample_batch": num,
        "preset": cfg.name,
        "batch": cfg.train.batch_size,
        "n_critic": cfg.loss.n_critic,
        "kernels": route,
        "kernels_g": route,
        "kernels_d": route,
        "dtype": cfg.train.dtype,
        "device": card_name(device),
    }


def add_flags(p: argparse.ArgumentParser) -> None:
    """The reference's five flags and defaults (audiogan_tpu/cli.py:144-153
    with bench.py's), and the port's ``--device``."""
    p.add_argument("--preset", default="wgan_gp_b64",
                   choices=[*PRESETS, "all"],
                   help="a preset, or 'all' for one line per preset")
    p.add_argument("--steps", type=int, default=10,
                   help="training steps per timed round")
    p.add_argument("--kernels", default=None,
                   help="the reference's kernel tier: the port has one "
                        "route, so any value raises")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="train.dtype (compute dtype; parameters stay f32)")
    p.add_argument("--sample_batch", type=int, default=None,
                   help="sampler batch (default: default_sample_num)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu only if asked)")


def run(args: argparse.Namespace) -> int:
    """One JSON line per preset on stdout; the summaries on stderr."""
    for preset in (PRESETS if args.preset == "all" else [args.preset]):
        line = bench_one(preset, args.dtype, args.kernels, args.steps,
                         args.sample_batch, args.device,
                         say=lambda s: print(s, file=sys.stderr, flush=True))
        print(json.dumps(line), flush=True)
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="audiogan_tpu_torch.bench")
    add_flags(p)
    return run(p.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
