#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (audiogan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Eight paths, each driven through the user's entry points: the flagship
WaveGAN (wgan_gp_b64), the same preset trained with every phase-shuffle
site fused into its consuming conv (`cli train --set
model.fused_shuffle_sites=-1`), the class-conditional GRU generator
(cond_gru_sc09), the flagship's G against the dual wave + STFT critic
with G's spectral term (dual_stft), 4 s music clips at 44.1 kHz with
strides 7/7/5/5/3 (music_44k_dp16 as `--set mesh.dp=1`, its published
widths) and a 22050 Hz corpus resampled to the 16 kHz model in the
ingest (resample_22k), the flagship and dual_stft with each clip's
time axis split over two ranks (context parallelism, `--set
mesh.cp=2`), and the flagship and cond_gru_sc09 with the critic's
channels split over two ranks (tensor parallelism, `--set mesh.tp=2`);
beside them the fused GRU cell
(`ops/gru.py::gru_cell`, impl="pallas") as a 256-frame recurrence, and
`cli bench`, the reference's headline harness, over every preset.
Phases, each printing one JSON
line with its own ``seconds``; any failure raises and the script exits
non-zero:

1. env      the card's name and power limit (nvidia-smi).
2. build    the seven sources (convt1d, conv1d, ingest, gru_scan, sconv,
            gru_cell, adam) from a clean build directory, one plain nvcc
            each, all started together; ptxas registers and spills.
3. compare  each kernel against its plain PyTorch form, f32 and bf16:
            convt1d at the five wgan_gp_b64 generator layers (batch 64) and
            at the critic's backward geometries (the dx of every critic
            conv, batch 2B = 128); conv1d at the five critic layers (2B)
            and at the generator's backward geometries (batch 64); ingest
            at [64, 16384] with store = clip and with store 20000 and
            random offsets; the GRU scan (K4, with and without h_seq) and
            its backward (K5) at cond_gru_sc09's widths, batch 64 (the GRU
            G's three convT layers and the critic are flagship geometries;
            in bf16 K4 and K5 must take the persistent path, in f32 the
            host loop);
            sconv1d (K6) at the four fused sites' convs (2B and B) and
            sconvt1d (K7) at their x-gradients (2B and B), every offset in
            the batch and mixed offsets inside each stacked tile (K7 also
            wild offsets, which must act as their clamped values, into
            memory that held NaN just before); the GRU cell
            (K3) at cond_gru_sc09's cell, x and h [64, 512], and at a
            ragged cell (B 7, in 24, H 40), forward, and its Function's
            gradients. In bf16, 16 of the 20 convt1d and conv1d
            geometries, every K6 and K7 geometry and both K3 cells run the
            tensor-core path (each line names its path), two launches to
            the same bits; f32 and the one-channel layers K1/K1''s
            CUDA-core kernels (csrc/conv_cc.cuh), K6/K7's CUDA-core
            tiles. Ingest (K2) two launches to the same bits too. The
            same for music_44k_dp16's 20 conv geometries (G forward B=64,
            critic forward and dx 2B=128, G's dx B=64) and its ingest
            ([64, 220500] -> 176400, random offsets); the resampler
            (ops/resample.py) at 22050 -> 16000 on the card against
            scipy.signal.resample_poly in float64 and against its CPU
            form. Then the per-rank geometries of data parallelism, where
            the tensor-core tiles are chosen again: the flagship's convs
            and dx at dp=2 and dp=4 (G at B/dp, the critic at 2B/dp),
            music's at dp=4, and K6/K7 at the fused sites at B/2 and B/4;
            and music's per-rank geometries at cp=4, each conv on its
            halo-extended slice with explicit pads (K1' VALID, K1 with
            pad_lo and out_len), which the cp step runs in f32; and the
            flagship critic's per-rank geometries at tp=2 (2B=128: the
            column layers D0, D2, D4 at C_out / 2, the row layers D1,
            D3 at C_in / 2 with no bias) and their dx, which the tp
            step runs in f32. Adam's kernel (csrc/adam.cu: the update's
            step-dependent tail from device scalars) against torch's
            foreach ops, to the bit, at every parameter shape of every
            preset's G and D and the flagship's ZeRO-1 row blocks at
            dp=4, counts 1 ... 400 (tools/step_checks.py::hold_adam).
4. serve    each generator at full width (random weights from init seed 0,
            bf16; dual_stft's G is the flagship's) exported, loaded and
            served over HTTP on 127.0.0.1; a few requests (with labels for
            the GRU), each kernel's launches per request, the served audio
            against a CPU reference. The sampler answers by replaying one
            CUDA graph captured at load (serve/sample_graph.py): each
            kernel's launches per request equal its kernel nodes in the
            graph, and the replayed batch equals the eager route's
            (replay=False) and build_sample_fn's to the bit; the
            capture's seconds, nodes by kind, port kernel nodes and pool
            bytes.
5. parity   one f32 training step of each preset (and of the fused
            flagship) at full width, batch 2, on the card (kernels; the
            STFT critic's conv2d in cuDNN, its DFT in cuBLAS, both without
            TF32) and on the CPU (plain forms), from one state and the
            same draws: metrics (dual_stft's stft_loss too), parameters,
            Adam moments. Then one f32 music step at B=64 with
            loss.gp_batch_chunks=2 against one with 1, on the card, under
            the same bounds, with the peak memory of each and of the
            penalty alone.
6. train    each preset, and the fused flagship, through train.loop.train
            (what `cli train` runs): B=64, bf16, n_critic 5, fused views,
            resident synthetic corpus; the loop trains by replay (its
            first step eager, the second captured as one CUDA graph,
            train/step_graph.py), 2 warm-up steps then 20 timed ones,
            finite losses, steps/s, the replay's device ms (CUDA events
            around each replay) and the window's idle share, the
            capture's seconds and nodes, launches per step of each
            kernel (counts zeroed just before each path, read just
            after: the eager step's calls plus each port kernel's kernel
            nodes times the replays; Adam's kernel n_critic + 1; K1', K1, their
            tensor-core launches (zero is a failure), K6 and K7 held to
            the counts the step's structure gives, every K6 and K7 launch
            on the tensor cores, the unfused shuffle to none, K4 6 and K5 1
            per
            GRU step, all persistent; dual_stft's K1' and K1 as the
            flagship's and K2 6: five critic views and G's real view;
            music_44k_dp16 at dp=1 as its structure gives K1' and K1, K2
            5; resample_22k K2 0, every view resampled in plain torch
            ops, as the reference routes it),
            peak device memory; one more step under torch.profiler for the
            device time by kernel and by span (the generator, the wave
            critic, the STFT critic's spectrogram, its DFT matmuls and its
            conv2d, the spectral loss; a backward op counts to the span
            whose forward made it). Then the
            GRU cell's 256-frame recurrence, f32 forward and backward
            against the same recurrence through the plain cell, and bf16
            forward (every launch on the tensor cores) against the plain
            form's recurrence. The loop checkpoints its last step after
            that step's line, outside the timed window (checked). One more
            music step from that checkpoint through the loop, on the
            resident corpus and with data.device_corpus off (the host
            batcher): the same record and checkpoint, to the bit; and
            that step's [V, 64] clips gathered by the host batcher's
            native row gather (data/native.py) and by numpy's fancy
            index: the same bytes, each one's seconds.
6r. replay  after each train run, the same run again from the same start
            with every step eager (train.loop.train(..., replay=False)):
            every step's record and the last checkpoint equal to the
            replayed run's, to the bit; both rates, the replay's device
            ms, idle share, capture and both runs' peak memory.
6b. resume  `cli train --total_steps 6 --set train.ckpt_every=3` in
            subprocesses for the flagship, the fused flagship,
            cond_gru_sc09, dual_stft, music_44k_dp16 (mesh.dp=1; B=64,
            bf16) and resample_22k (its own B=8, f32): once uninterrupted,
            once sent SIGKILL when it logs its step-3 checkpoint and run
            again; the second run must restore step 3, and its step-6
            metrics.jsonl record (but time and rates) and step-6
            checkpoint must equal the uninterrupted run's to the bit;
            every run replays (its init record says so).
            Then, on every workdir but the fused flagship's, `cli sample
            --workdir --seed 0` twice (the same bytes, WAVs at the
            preset's rate and length) and `cli serve --workdir` (one
            /generate); on dual_stft's and music_44k_dp16's, `cli eval
            --workdir` twice: the same JSON line, every value finite.
            Each run's seconds, each save's bytes and seconds: the loop
            saves asynchronously (utils/checkpoint.py::AsyncSaver) and
            logs the checkpoint once its file is complete, so the kill
            comes after a complete step-3 file; the seconds each save
            blocked the loop, by part (utils/checkpoint.py's record:
            the state dicts, the device copy's memory with the
            cudaMalloc calls it made, its launches), and the worker's
            write.
6c. dp      data parallelism on this card: two processes over gloo
            (NCCL refuses two ranks on one device) through
            audiogan_tpu_torch/tools/dp_check.py, each on its half of
            the global batch: the flagship in f32 at B=8 (4 per rank) and
            dual_stft's G spectral term at B=8, two steps each, against
            the dp=1 steps on this card under the parity bounds; the bf16
            flagship at B=64 (32 per rank) twice to the bit, ranks equal
            to the bit, with mesh.fsdp (ZeRO-1) equal to replicated to the
            bit and against the bf16 dp=1 steps on the same batches from
            the same warm state (metrics and Adam moments no farther
            apart than twice the dp=1 bf16 steps from the same steps in
            f32), and K1',
            K1 and K2 launches per rank held to the step's structure
            (counts zeroed in each rank just before, read just after);
            then train.loop.train at dp=2 on the sharded corpus
            against the replicated one, the same records and states to
            the bit.
6d. cp      context parallelism on this card: two gloo ranks, each one
            half of every clip's time axis (train/cp_step.py: halo
            exchanges per conv, one sum over cp per head), f32 at B=8,
            shuffle off, through dp_check.parity_job: for each batch
            seed one warm plain step, then from there, with the same
            draws, cp=2 against the cp step at cp=1 and against the
            plain step on this card: a frozen step (lr 0, Adam's moments
            zeroed, so the moments hold the step's gradients before Adam
            divides them) held to the parity bounds, and two steps at
            the preset's lr, reported beside the bounds. The flagship at
            six seeds (PARITY_SEEDS), its two steps held at seed 60;
            dual_stft (its STFT critic and G's spectral term) at seed 60,
            held against cp=1 and reported against the plain step;
            cond_gru_sc09 (its conditional GRU G's frame recurrence over
            the ranks by parallel/halo.py::cp_chunked_scan, the torch-op
            cell; the conditional cp critic) at seed 80 as in the tp
            phase, the frozen step held against cp=1 and the plain step.
            Ranks equal to the bit after every run, the kernels'
            launches per rank held to the step's structure
            (cp_step_launches: K1' and K1, no K3-K7; K2 one per real
            view, num_views), each conv's route.
6e. tp      tensor parallelism on this card: two gloo ranks, each half
            of the critic's channels (train/tp_step.py: column/row conv
            pairs, one sum over tp per row layer and per head), f32 at
            B=8, shuffle off, the cp phase's protocol: the flagship at
            the six seeds and cond_gru_sc09 (its GRU G replicated on both
            ranks) at seed 80, the frozen step held against tp=1 and the
            plain step, the two steps at the preset's lr reported; ranks
            equal to the bit, K1', K1, K2 (and K4, K5) launches per rank
            held to the step's structure (tp_step_launches, num_views).
6f. graph   train.dump_hlo (train/step_graph.py) through train.loop.train
            with no step to run, for each preset at full width, the fused
            flagship and music_44k_dp16 at dp=1, on the resident corpus
            with data.index_chunk at its default: the loop's first step
            captured as one CUDA graph (the draws made before, one
            warm-up step on a side stream), replayed once from the
            pre-step state and held to the eager step from the same state
            and draws, to the bit (parameters, both Adams' moments,
            metrics). Each port kernel's kernel nodes, attributed to its
            calls during the capture, equal its calls and the launches
            the step's structure gives (K1' and K1 by conv_step_launches,
            K6 and K7 by fused_step_launches, K4 6 and K5 1, K2 one per
            real view, none for resample_22k); the node counts by kind
            and the capture's seconds.
6g. trace   the flagship's `cli train --total_steps 6` three ways at once:
            plain, with train.profile_dir and train.profile_steps=[2,4],
            and with train.debug_nans; the trace holds the ranges of
            steps 2 and 3 only, the wave critic's and the generator's
            spans of those two steps and their K1'/K1 kernel events, and
            the three runs end in the same step-6 checkpoint to the bit.
            Beside them a fresh state's checkpoint with one NaN in the
            critic's conv_0 kernel, resumed for one step with debug_nans:
            it must raise FloatingPointError naming K1' in the wave
            critic, forward, reading D.conv_0_kernel. Then one healthy
            flagship step under the check mode (every aten op and kernel
            call tested): no NaN.
6h. bench   `cli bench`, the reference's headline harness
            (audiogan_tpu_torch/bench.py): with its defaults (the
            flagship, 10 steps a round, bf16), one JSON line with exactly
            the reference's keys but its proxy fields, and the card's name
            and power limit, steps/s and audio-seconds/s above 0, batch
            4096; then `--preset all --steps 2`, one such line per preset
            in the reference's order. In this process, the launch counts
            zeroed just before: three bench steps of the flagship on its
            staged clips (eager, captured and replayed, replayed) equal
            to three eager steps from a fresh state of the same seed, to
            the bit; each preset's replayed sampler at its
            default_sample_num (4096, 16384 for tiny_sc09 and
            resample_22k in bf16, 380 for music_44k_dp16), its first and
            last 8 clips against the port on the CPU on the same z and
            labels (the serve phase's tolerances), its capture, graph
            pool and peak memory; K1, K1', K2, Adam's kernel and K4 (the
            GRU sampler's host loop) launched.
7. timing   per geometry: kernel (its path; on the tensor cores its tile
            and the time of each other tile), plain form and, where one
            exists, one library call (F.conv_transpose1d / F.conv1d,
            torch.nn.GRUCell for K3: yardsticks the port never calls)
            beside the card's
            bound; for K6 and K7, which no single PyTorch call computes,
            the unfused pair they replace (shuffle + conv1d kernel, convT
            kernel + shuffle's transpose), their CUDA-core tiles and (K7)
            the convT kernel alone and each tensor-core tile; K2's and
            K3's device time (torch.profiler, and events around one launch
            queued behind a sleep) beside their protocol time (K2 at both
            cluster sizes; K3 beside torch.nn.GRUCell's); the GRU scan's
            CUDA launches per
            call, its path, K5's three stages (recompute, sweep, weight
            gradients), the persistent kernels at each grid of gru_grids
            and the host loop on the same inputs; each sampler at batch
            64 and 8 (the CLI's default): replay and eager ms per batch,
            and the route before the replayed graph (build_sample_fn,
            then a pageable copy), in alternating rounds (host clock,
            each batch ending in its copy to the host), a replay's device
            ms (CUDA events) and the idle share, and the median wall time
            of one HTTP /generate at num = batch on both routes.
            K1's and K1''s rows at music_44k_dp16's geometries (each
            tile of the tensor-core path) and K2's at its ingest go into
            the kernels line's "music" entries; their rows at music's
            cp=4 geometries, f32 (the CUDA-core kernels of
            csrc/conv_cc.cuh, the bound at the f32 rate), into its "cp"
            entries; at the flagship's tp=2 geometries, f32, into its
            "tp" entries. A row on the CUDA-core path names its kernel
            and tile (gemm TM x TN and channel chunk, thin_cout's rows
            and NP, thin_cin's rows) and times every candidate tile of
            its kind (tile_ms).

It prints the kernels line, then, last, {"ok": true, "device": {...}}.
Without a CUDA device, or without the audiogan_tpu_torch package beside it,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import base64
import concurrent.futures
import dataclasses
import gc
import io
import json
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import wave
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# the step checks this script shares with tools/dp_check.py (parity bounds,
# random batches, conv geometries and launch counts, states to the bit);
# without the package beside it the script stops here
from audiogan_tpu_torch.bench import graph_pool_bytes
from audiogan_tpu_torch.kernels import hooks
from audiogan_tpu_torch.tools.step_checks import (
    PARITY_PARAM_FINE, PARITY_PARAM_TOL, PARITY_REL_TOL, PARITY_SEEDS,
    adam_step_launches, compare_blobs, compute_dtype, conv_step_launches, cp_rank_layers,
    cp_step_launches, critic_dx_layers, critic_layers, fused_step_launches,
    generator_dx_layers, generator_layers, hold_bf16_to_dp1, hold_launches, random_raw, same_bits,
    same_checkpoint, state_parts, tensor_core, tp_rank_layers,
    tp_step_launches)
from audiogan_tpu_torch.utils.profiling import (SPAN_NAMES, profiler_spans,
                                                span_device_ms)

ROOT = Path(__file__).resolve().parent
BATCH = 64
SMALL = 8                     # a request for a prefix of the batch; the
                              # CLI's default artifact batch
# the samplers' timing: alternating rounds (replay, eager, parent, parent,
# eager, replay) of this many batches each, and this many HTTP requests
# per route
SAMPLER_ITERS, SAMPLER_HTTP = 10, 5
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor rate
PEAK_F32_FLOPS = 67e12        # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 rate
F32_REL_TOL = 1e-4            # same sums in another order
BF16_REL_TOL = 2e-2           # bf16 keeps 8 bits: one rounding of the output
INGEST_ABS_TOL = 1e-5         # log1pf / division on the card vs torch, |y|<=1
RESAMPLE_CPU_TOL = 1e-5       # the float64 polyphase product, card vs CPU
# the served GRU G on the card vs the CPU in bf16: the scan carries f32
# and rounds only what it writes, but h0 and cond_proj come from bf16
# dense layers (cuBLAS vs the CPU), and three convT layers each round
SERVE_BF16_REL_TOL = 5e-2
GRU_BWD_REL_L2 = 1e-3         # K5: every gradient sums over 16384 rows
BUILD_LIMIT_S = 180.0
SOURCES = ("convt1d", "conv1d", "ingest", "gru_scan", "sconv", "gru_cell",
           "adam")
# K3 against torch.nn.GRUCell: alternating rounds of launches, medians
K3_ROUNDS, K3_LAUNCHES = 5, 50
# a cell ragged against K3's tensor-core tiles: B 7, in 24, H 40
GRU_CELL_RAGGED = (7, 24, 40)
SLEEP_CYCLES = 200_000        # about 0.1 ms of device time ahead of a call
# a flagship step takes about 0.13 s on the tensor-core convs: 20 timed
# steps keep the rate's window near 3 s; a music step is several times
# longer
TRAIN_WARMUP, TRAIN_TIMED = 2, 20
# the resume phase: `cli train --total_steps 6`, a checkpoint every 3 steps;
# one run uninterrupted, one killed after its step-3 checkpoint and resumed
RESUME_STEPS, RESUME_KILL_AT = 6, 3
RESUME_RUNS = (("wgan_gp_b64", ()),
               ("wgan_gp_b64", ("model.fused_shuffle_sites=-1",)),
               ("cond_gru_sc09", ()), ("dual_stft", ()),
               ("music_44k_dp16", ("mesh.dp=1",)), ("resample_22k", ()))
# `cli sample` and `cli serve` on the resumed workdirs of these runs (the
# fused flagship serves the flagship's G), `cli eval` twice on these
# presets'
SERVE_RUNS = ("wgan_gp_b64", "cond_gru_sc09", "dual_stft", "music_44k_dp16",
              "resample_22k")
EVAL_PRESETS = ("dual_stft", "music_44k_dp16")
CLI_TIMEOUT_S = 600
# the dp phase: two ranks on this card; its f32 steps at this batch
DP_RANKS, DP_F32_BATCH, DP_STEPS = 2, 8, 2
DP_TIMEOUT_S = 600
# the bench phase: `cli bench`'s runs (the flagship with the defaults,
# then every preset at 2 steps a round) and the clips of each preset's
# replayed sampler held against the port on the CPU: this many first and
# last; three bench steps of the flagship against three eager ones
BENCH_TIMEOUT_S = 600
BENCH_CLIPS, BENCH_STEPS = 8, 3
BENCH_LINE_KEYS = {"metric", "value", "unit", "rounds_steps_per_sec",
                   "stabilize_rounds", "rounds_spread_pct",
                   "audio_sec_per_sec", "sample_batch", "preset", "batch",
                   "n_critic", "kernels", "kernels_g", "kernels_d", "dtype",
                   "device"}
# the cp and tp phases: two ranks on this card, f32 at this batch; the
# per-rank conv geometries of music_44k_dp16 at cp=4 and of the
# flagship's critic at tp=2 (compare, timing)
AXIS_RANKS, AXIS_BATCH, CP_MUSIC, TP_RANKS = 2, 8, 4, 2


def phase(name: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": name, "seconds": round(time.time() - t0, 3),
                      **fields}), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# -- geometries ---------------------------------------------------------------

def fused_site_layers(cfg, batch: int) -> list[dict]:
    """The fused critic's shuffled-input convs (K6): conv i+1 reading the
    window of site i's masked reflect pad, xp [B, t + 2 rad, Cin]."""
    rad = cfg.model.phase_shuffle
    return [dict(L, name=f"site {i} -> D{i + 1} fwd", rad=rad)
            for i, L in enumerate(critic_layers(cfg, batch)[1:])]


def fused_site_dx_layers(cfg, batch: int) -> list[dict]:
    """Their x-gradients (K7): ct [B, t_out, Cout] and the flipped taps
    -> [B, t + 2 rad, Cin], pad_lo = K-1-lo, out_len = t."""
    out = []
    for L in fused_site_layers(cfg, batch):
        t_out = (L["t_in"] + L["lo"] + L["hi"] - L["k"]) // L["s"] + 1
        out.append(dict(name=L["name"].replace("fwd", "dx"), b=batch,
                        t_in=t_out, cin=L["cout"], cout=L["cin"], k=L["k"],
                        s=L["s"], pad_lo=L["k"] - 1 - L["lo"],
                        out_len=L["t_in"], rad=L["rad"], act="none"))
    return out


def per_rank_layers(cfg, batch: int, dps: tuple, tag: str = ""
                    ) -> tuple[list[dict], list[dict]]:
    """(K1, K1') geometries of a step at each dp of ``dps`` on a global
    batch: G and its dx at batch / dp, the critic and its dx at
    2 batch / dp (the fused views), named with their dp."""
    convt, conv = [], []
    for dp in dps:
        def named(layers):
            return [dict(L, name=f"{tag}{L['name']} (dp={dp})")
                    for L in layers]
        b = batch // dp
        convt += named(generator_layers(cfg, b) + critic_dx_layers(cfg, 2 * b))
        conv += named(critic_layers(cfg, 2 * b) + generator_dx_layers(cfg, b))
    return convt, conv


class PathCounter:
    """One path's launch count on a conv wrapper (``launches_tc``), read
    and zeroed like a kernel's own ``launches``."""

    def __init__(self, fn, attr: str):
        self.fn, self.attr = fn, attr

    @property
    def launches(self) -> int:
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, n: int) -> None:
        setattr(self.fn, self.attr, n)


def convt_work(L: dict, itemsize: int) -> tuple[int, int]:
    """(flops, bytes) a convT needs: multiply-adds over the taps that land
    inside the input, each input read and output written once."""
    from audiogan_tpu_torch.kernels.conv import _convt_phase_range
    q_min, q_taps = _convt_phase_range(L["k"], L["s"], L["pad_lo"])
    m_out = -(-L["out_len"] // L["s"])
    m = np.arange(m_out)
    pairs = 0
    for rho in range(L["s"]):
        rows = m[m * L["s"] + rho < L["out_len"]]
        for tau in range(q_taps):
            j = L["pad_lo"] - rho + (q_min + tau) * L["s"]
            if 0 <= j < L["k"]:
                src = rows + q_min + tau
                pairs += int(((src >= 0) & (src < L["t_in"])).sum())
    flops = 2 * L["b"] * pairs * L["cin"] * L["cout"]
    nbytes = itemsize * (L["b"] * L["t_in"] * L["cin"]
                         + L["k"] * L["cin"] * L["cout"] + L["cout"]
                         + L["b"] * L["out_len"] * L["cout"])
    return flops, nbytes


def conv1d_work(L: dict, itemsize: int) -> tuple[int, int]:
    """(flops, bytes) a conv1d needs, taps in the padding excluded."""
    t_out = (L["t_in"] + L["lo"] + L["hi"] - L["k"]) // L["s"] + 1
    src = (np.arange(t_out)[:, None] * L["s"] + np.arange(L["k"])[None, :]
           - L["lo"])
    pairs = int(((src >= 0) & (src < L["t_in"])).sum())
    flops = 2 * L["b"] * pairs * L["cin"] * L["cout"]
    nbytes = itemsize * (L["b"] * L["t_in"] * L["cin"]
                         + L["k"] * L["cin"] * L["cout"] + L["cout"]
                         + L["b"] * t_out * L["cout"])
    return flops, nbytes


def sconv_work(L: dict, itemsize: int) -> tuple[int, int]:
    """K6: the conv1d's flops over the z-space window (taps in the pads
    excluded); bytes: xp with its 2 rad rows, the taps, bias, offs, y."""
    flops, nbytes = conv1d_work(L, itemsize)
    return flops, nbytes + itemsize * L["b"] * 2 * L["rad"] * L["cin"] \
        + 4 * L["b"]


def sconvt_work(L: dict, itemsize: int) -> tuple[int, int]:
    """K7: the convT's flops; bytes: ct, the taps, offs and the output
    with its 2 rad zero rows (no bias)."""
    flops, nbytes = convt_work(L, itemsize)
    return flops, nbytes + itemsize * (L["b"] * 2 * L["rad"] * L["cout"]
                                       - L["cout"]) + 4 * L["b"]


def bound(flops: int, nbytes: int,
          peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def conv_inputs(L: dict, dtype, dev, seed: int):
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(L["b"], L["t_in"], L["cin"], generator=gen, device=dev)
    if L["act"] == "relu":
        x = torch.relu(x)
    lim = (6.0 / (L["k"] * (L["cin"] + L["cout"]))) ** 0.5
    w = (torch.rand(L["k"], L["cin"], L["cout"], generator=gen, device=dev)
         * 2 - 1) * lim * 4
    b = torch.randn(L["cout"], generator=gen, device=dev) * 0.1
    if L["act"] == "none":
        b = torch.zeros_like(b)
    return x.to(dtype), w.to(dtype), b.to(dtype)


def convt_args(L):
    return (L["s"], L["pad_lo"], L["out_len"], L["act"], 0.2)


def conv1d_args(L):
    return (L["s"], L["lo"], L["hi"], L["act"], 0.2)


def convt_library(L: dict, x, w, b):
    """F.conv_transpose1d computing the same convT: taps flipped, padding
    moved (plus a view that drops a surplus last row), NCW layout
    prepared outside the timed call."""
    p = L["k"] - 1 - L["pad_lo"]
    full = (L["t_in"] - 1) * L["s"] - 2 * p + L["k"]
    out_pad = max(L["out_len"] - full, 0)
    xn = x.transpose(1, 2).contiguous()
    wt = w.flip(0).permute(1, 2, 0).contiguous()      # [Cin, Cout, K]
    return lambda: F.conv_transpose1d(
        xn, wt, b, stride=L["s"], padding=p,
        output_padding=out_pad)[..., :L["out_len"]]


def conv1d_library(L: dict, x, w, b):
    """F.conv1d on the explicitly padded NCW input (padding outside the
    timed call)."""
    xn = F.pad(x.transpose(1, 2), (L["lo"], L["hi"])).contiguous()
    wt = w.permute(2, 1, 0).contiguous()                # [Cout, Cin, K]
    return lambda: F.conv1d(xn, wt, b, stride=L["s"])


FAMILIES = {
    # name -> (kernel, plain, args, work, library)
    "convt1d": ("conv_transpose1d_ba", "conv_transpose1d_ba_plain",
                convt_args, convt_work, convt_library),
    "conv1d": ("conv1d_ba", "conv1d_ba_plain", conv1d_args, conv1d_work,
               conv1d_library),
}


def compare_conv(family: str, layers: list[dict], dev) -> dict:
    """Kernel vs plain form (and the library form vs plain, f32) at each
    geometry, f32 and bf16; returns {(name, dtype): max abs err}."""
    from audiogan_tpu_torch.kernels import conv as kconv
    kname, pname, args_of, _, library = FAMILIES[family]
    kernel, plain = getattr(kconv, kname), getattr(kconv, pname)
    errs = {}
    for dtype, dname, tol in ((torch.float32, "f32", F32_REL_TOL),
                              (torch.bfloat16, "bf16", BF16_REL_TOL)):
        for i, L in enumerate(layers):
            x, w, b = conv_inputs(L, dtype, dev, seed=i)
            got = kernel(x, w, b, *args_of(L))
            want = plain(x.float(), w.float(), b.float(), *args_of(L))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != want.shape:
                raise AssertionError(f"{family} {L['name']} {dname}: "
                                     f"{got.dtype} {tuple(got.shape)}")
            err = (got.float() - want).abs().max().item()
            peak = want.abs().max().item()
            errs[(L["name"], dname)] = err
            path = ("tensor_core" if dtype == torch.bfloat16
                    and tensor_core(family, L) else "cuda_core")
            print(json.dumps({"compare": family, "dtype": dname,
                              "geometry": L["name"], "path": path,
                              "x": list(x.shape),
                              "cout": L["cout"], "max_abs_err": err,
                              "max_rel_err": err / peak, "max_abs_y": peak,
                              "tol_rel": tol}), flush=True)
            if not err <= tol * peak:
                raise AssertionError(f"{family} {L['name']} {dname}: max err "
                                     f"{err} > {tol} * {peak}")
            if dtype == torch.float32:
                lib = library(L, x, w, b)().transpose(1, 2)
                lib = kconv._apply_act(lib, L["act"], 0.2)
                lib_err = (lib - want).abs().max().item()
                if not lib_err <= F32_REL_TOL * peak:
                    raise AssertionError(f"library form of {family} "
                                         f"disagrees at {L['name']}: "
                                         f"{lib_err}")
    return errs


def ingest_cases(dev) -> list[dict]:
    """The flagship's ingest (store = clip, every offset 0), a slack
    geometry with random offsets, and music_44k_dp16's (store 220500,
    clip 176400, random offsets)."""
    cases = []
    for name, store, clip, seed in (
            ("flagship store=clip", 16384, 16384, 0),
            ("slack store=20000", 20000, 16384, 1),
            ("music store=220500", 220500, 176400, 2)):
        gen = torch.Generator(dev).manual_seed(seed)
        raw = (torch.randn(BATCH, store, generator=gen, device=dev) * 6000
               ).clamp(-32768, 32767).to(torch.int16)
        offs = torch.randint(0, store - clip + 1, (BATCH,), generator=gen,
                             device=dev, dtype=torch.int32)
        cases.append(dict(name=name, raw=raw, offs=offs, clip=clip))
    return cases


def compare_resample(dev) -> dict:
    """ops/resample.py on the card at resample_22k's rates (22050 ->
    16000, [64, 24000]) against scipy.signal.resample_poly in float64
    (tests/ops/test_resample.py's bounds: 64 samples in from each edge
    2e-4 + 1e-3 relative, everywhere 5e-2) and against the port's CPU
    form (RESAMPLE_CPU_TOL)."""
    import scipy.signal
    from audiogan_tpu_torch.config import _ratio
    from audiogan_tpu_torch.ops.resample import resample_poly
    rng = np.random.default_rng(3)
    x = rng.standard_normal((BATCH, 24000)).astype(np.float32) * 0.3
    y = resample_poly(torch.from_numpy(x).to(dev), 16000, 22050)
    torch.cuda.synchronize()
    y = y.cpu().numpy()
    up, down = _ratio(16000, 22050)
    ref = scipy.signal.resample_poly(x.astype(np.float64), up, down, axis=-1)
    cpu = resample_poly(torch.from_numpy(x), 16000, 22050).numpy()
    m = 64
    inner = np.abs(y[:, m:-m] - ref[:, m:-m])
    out = {"shape": list(y.shape), "scipy_shape": list(ref.shape),
           "interior_max_abs_err": float(inner.max()),
           "interior_bound_ok": bool(np.all(
               inner <= 2e-4 + 1e-3 * np.abs(ref[:, m:-m]))),
           "max_abs_err": float(np.abs(y - ref).max()),
           "cpu_max_abs_err": float(np.abs(y - cpu).max()),
           "tol_cpu_abs": RESAMPLE_CPU_TOL}
    print(json.dumps({"compare": "resample", **out}), flush=True)
    if y.shape != ref.shape or not out["interior_bound_ok"] or \
            out["max_abs_err"] > 5e-2 or \
            out["cpu_max_abs_err"] > RESAMPLE_CPU_TOL:
        raise AssertionError(f"resample on the card: {out}")
    return out


def compare_ingest(cases: list[dict], dev) -> dict:
    from audiogan_tpu_torch.kernels import ingest as king
    errs = {}
    for c in cases:
        for mode in ("peak", "rms"):
            got = king.ingest_fused(c["raw"], c["offs"], c["clip"], mode)
            again = king.ingest_fused(c["raw"], c["offs"], c["clip"], mode)
            want = king.ingest_fused_plain(c["raw"], c["offs"], c["clip"],
                                           mode)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"ingest {c['name']} {mode}: two "
                                     f"launches differ")
            err = (got - want).abs().max().item()
            errs[(c["name"], mode)] = err
            print(json.dumps({"compare": "ingest", "geometry": c["name"],
                              "mode": mode, "raw": list(c["raw"].shape),
                              "cluster": king.ingest_cluster(c["clip"]),
                              "max_abs_err": err, "tol_abs": INGEST_ABS_TOL,
                              "repeat_bits_equal": True}), flush=True)
            if got.dtype != torch.float32 or not err <= INGEST_ABS_TOL:
                raise AssertionError(f"ingest {c['name']} {mode}: {err}")
    return errs


# -- the GRU scan ---------------------------------------------------------------

def gru_dims(cfg) -> tuple[int, int, int, int]:
    """(B, H, F, n_frames) of the GRU generator's scan at batch BATCH."""
    m = cfg.model
    return (BATCH, m.gru_hidden, min(4 * m.model_dim, 512),
            cfg.data.clip_len // m.gru_frame_size)


def gru_inputs(cfg, dtype, dev, seed: int = 0) -> list:
    """The scan's nine inputs at the model's scales: h0 = tanh(.),
    glorot-uniform weights, an orthogonal w_h, small random biases."""
    b, hid, feat, _ = gru_dims(cfg)
    gen = torch.Generator(dev).manual_seed(seed)

    def glorot(n_in, n_out):
        lim = (6.0 / (n_in + n_out)) ** 0.5
        return (torch.rand(n_in, n_out, generator=gen, device=dev) * 2
                - 1) * lim

    def small(n):
        return torch.randn(n, generator=gen, device=dev) * 0.1
    w_h = torch.linalg.qr(torch.randn(3 * hid, hid, generator=gen,
                                      device=dev))[0].T
    args = [torch.tanh(torch.randn(b, hid, generator=gen, device=dev)),
            torch.randn(b, feat, generator=gen, device=dev) * 0.5,
            glorot(2 * feat, 3 * hid), w_h, small(3 * hid), small(3 * hid),
            glorot(feat, feat), glorot(hid, feat), small(feat)]
    return [a.to(dtype).contiguous() for a in args]


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    return float(2.0 ** (np.floor(np.log2(max(x, 1e-30))) - 7))


def gru_path(dtype, b: int, hid: int, feat: int) -> str:
    """The path kernels/gru.py's dispatch gives a scan of this shape."""
    from audiogan_tpu_torch.kernels import gru as kgru
    return ("persistent" if kgru.gru_scan_persistent(dtype, b, hid, feat)
            else "loop")


def compare_gru(cfg, dev) -> dict:
    """K4 (without and with h_seq) and K5 against their plain forms on the
    same inputs, f32 and bf16. K4: f32 within F32_REL_TOL of the peak,
    bf16 within one bf16 ulp of it (the same f32 values before the one
    rounding of the output); K5: every gradient within GRU_BWD_REL_L2
    relative L2."""
    from audiogan_tpu_torch.kernels import gru as kgru
    b, hid, feat, n = gru_dims(cfg)
    errs = {}
    for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        args = gru_inputs(cfg, dtype, dev)
        path = gru_path(dtype, b, hid, feat)
        for with_h in (False, True):
            before = kgru.gru_scan_fwd.launches_persistent
            got = kgru.gru_scan_fwd(*args, n, with_h=with_h)
            want = kgru.gru_scan_plain(*args, n, with_h=with_h)
            torch.cuda.synchronize()
            took = ("persistent" if kgru.gru_scan_fwd.launches_persistent
                    > before else "loop")
            if took != path:
                raise AssertionError(f"gru_scan {dname} took the {took} "
                                     f"path, want {path}")
            outs = (zip(("feats", "h_seq"), got, want) if with_h
                    else [("feats", got, want)])
            for out, g, w in outs:
                err = (g.float() - w.float()).abs().max().item()
                peak = w.float().abs().max().item()
                tol = (F32_REL_TOL * peak if dtype == torch.float32
                       else bf16_ulp(peak))
                print(json.dumps({"compare": "gru_scan", "dtype": dname,
                                  "path": path, "with_h_seq": with_h,
                                  "output": out,
                                  "shape": list(g.shape),
                                  "max_abs_err": err, "max_abs_y": peak,
                                  "tol_abs": tol}), flush=True)
                if g.dtype != dtype or not err <= tol:
                    raise AssertionError(f"gru_scan {dname} {out}: {err} > "
                                         f"{tol}")
                key = ("gru_scan", dname)
                errs[key] = max(errs.get(key, 0.0), err)
        out, h_seq = kgru.gru_scan_fwd(*args, n, with_h=True)
        gen = torch.Generator(dev).manual_seed(1)
        ct = torch.randn(b, n, feat, generator=gen, device=dev).to(dtype)
        before = kgru.gru_scan_bwd.launches_persistent
        got = kgru.gru_scan_bwd(ct, *args, out, h_seq)
        want = kgru.gru_scan_bwd_plain(ct, *args, out, h_seq)
        torch.cuda.synchronize()
        took = ("persistent" if kgru.gru_scan_bwd.launches_persistent
                > before else "loop")
        if took != path:
            raise AssertionError(f"gru_scan_bwd {dname} took the {took} "
                                 f"path, want {path}")
        rel, abs_err = {}, 0.0
        for name, a, g, w in zip(kgru.ARG_NAMES, args, got, want):
            if g.dtype != a.dtype or g.shape != a.shape:
                raise AssertionError(f"gru_scan_bwd d{name}: {g.dtype} "
                                     f"{tuple(g.shape)}")
            d = (g.float() - w.float())
            rel[name] = (d.norm() / w.float().norm().clamp_min(1e-30)).item()
            abs_err = max(abs_err, d.abs().max().item())
        print(json.dumps({"compare": "gru_scan_bwd", "dtype": dname,
                          "path": path, "rel_l2": rel, "max_abs_err": abs_err,
                          "tol_rel_l2": GRU_BWD_REL_L2}), flush=True)
        bad = {k: v for k, v in rel.items() if not v <= GRU_BWD_REL_L2}
        if bad:
            raise AssertionError(f"gru_scan_bwd {dname}: {bad}")
        errs[("gru_scan_bwd", dname)] = abs_err
        errs[("gru_scan_bwd_rel_l2", dname)] = max(rel.values())
    return errs


def gru_work(cfg, itemsize: int, backward: bool) -> tuple[int, int]:
    """(flops, bytes) of one scan without h_seq (K4) or of its backward
    (K5): the flops of audiogan_tpu/kernels/gru.py's CostEstimate; each
    input read once and each output written once."""
    b, hid, feat, n = gru_dims(cfg)
    per_frame = b * (feat * feat + 3 * hid * (2 * feat + hid) + hid * feat)
    inputs = (b * hid + b * feat + 2 * feat * 3 * hid + hid * 3 * hid
              + 2 * 3 * hid + feat * feat + hid * feat + feat)
    feats, h_seq = b * n * feat, n * b * hid
    if not backward:
        return 2 * n * per_frame, itemsize * (inputs + feats)
    # in: g, feats, h_seq and the inputs; out: a gradient per input
    return 6 * n * per_frame, itemsize * (2 * feats + h_seq + 2 * inputs)


def device_launches(fn) -> int:
    """The CUDA kernels and memsets one call of fn puts on the device, as
    torch.profiler records them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def bwd_stage_ms(call, iters: int = 5) -> dict:
    """K5's three stages (kernels/gru.py BWD_STAGES) of one call, each run
    as its own launch in order and timed with CUDA events around it; means
    over iters after one warm-up call."""
    from audiogan_tpu_torch.kernels import gru as kgru
    call.run(kgru.BWD_ALL_STAGES)
    torch.cuda.synchronize()
    evs = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
           for _ in range(iters)]
    for ev in evs:
        ev[0].record()
        for i, bit in enumerate(kgru.BWD_STAGES.values()):
            call.run(bit)
            ev[i + 1].record()
    torch.cuda.synchronize()
    return {name: sum(ev[i].elapsed_time(ev[i + 1]) for ev in evs) / iters
            for i, name in enumerate(kgru.BWD_STAGES)}


def gru_grids(b: int, hid: int, feat: int) -> list:
    """The persistent grids timed beside the rule's: (column groups, row
    groups) with the rule's column groups or twice as many, and one, two
    or four row groups; each resident on the card (one block per SM)."""
    from audiogan_tpu_torch.kernels import gru as kgru
    ng, _ = kgru.gru_persistent_grid(b, hid, feat)
    n_m = -(-b // 16)
    return [(c, m) for c in (ng, 2 * ng) for m in (4, 2, 1)
            if m <= n_m and c * m <= kgru.GRU_MAX_BLOCKS
            and c <= hid // 8]


def gru_launch_counts(cfg, dev) -> dict:
    """CUDA launches (device_launches) of one K4 call without h_seq and one
    K5 call at B=64, bf16, through the wrappers; K5's stage by stage (the
    stages run in order); and the host loop's on the same inputs. Taken
    before the training phase: after its step profiles, the profiler
    recorded neither the cooperative launches nor some of the others."""
    from audiogan_tpu_torch.kernels import gru as kgru
    b, hid, feat, n = gru_dims(cfg)
    args = gru_inputs(cfg, torch.bfloat16, dev)
    out, h_seq = kgru.gru_scan_fwd(*args, n, with_h=True)
    ct = torch.randn(b, n, feat, generator=torch.Generator(dev).manual_seed(1),
                     device=dev).bfloat16()
    persistent = gru_path(torch.bfloat16, b, hid, feat) == "persistent"
    plan = kgru.gru_persistent_plan(b, hid, feat) if persistent else None
    counts = {"gru_scan": device_launches(lambda: kgru.gru_scan_fwd(*args,
                                                                    n)),
              "gru_scan_bwd": device_launches(
                  lambda: kgru.gru_scan_bwd(ct, *args, out, h_seq))}
    call = kgru.ScanBwdCall(ct, args, out, h_seq, plan)
    counts["gru_scan_bwd_per_stage"] = {
        name: device_launches(lambda: call.run(bit))
        for name, bit in kgru.BWD_STAGES.items()}
    loop = kgru.ScanBwdCall(ct, args, out, h_seq, None)
    counts["gru_scan_loop"] = device_launches(
        lambda: kgru._scan_fwd(args, n, False, None))
    counts["gru_scan_bwd_loop"] = device_launches(
        lambda: loop.run(kgru.BWD_ALL_STAGES))
    return counts


def time_gru(cfg, dev, errs: dict, launches: dict) -> dict:
    """K4 (without h_seq; with it beside) and K5 at B=64, bf16: the path
    the wrapper takes, K5's three stages, the persistent kernels at each
    grid of gru_grids, and the host loop of PR 8's design on the same
    inputs (both launched through kernels/gru.py's internal calls, not
    counted)."""
    from audiogan_tpu_torch.kernels import gru as kgru
    b, hid, feat, n = gru_dims(cfg)
    args = gru_inputs(cfg, torch.bfloat16, dev)
    out, h_seq = kgru.gru_scan_fwd(*args, n, with_h=True)
    gen = torch.Generator(dev).manual_seed(1)
    ct = torch.randn(b, n, feat, generator=gen, device=dev).bfloat16()
    path = gru_path(torch.bfloat16, b, hid, feat)
    calls = {
        "gru_scan": (lambda: kgru.gru_scan_fwd(*args, n),
                     lambda: kgru.gru_scan_plain(*args, n), False),
        "gru_scan_bwd": (lambda: kgru.gru_scan_bwd(ct, *args, out, h_seq),
                         lambda: kgru.gru_scan_bwd_plain(ct, *args, out,
                                                         h_seq), True),
    }
    rows = {}
    for name, (kernel, plain, backward) in calls.items():
        flops, nbytes = gru_work(cfg, 2, backward)
        bound_ms, bound_by = bound(flops, nbytes)
        ms = cuda_ms(kernel, iters=5, warmup=1)
        rows[name] = {
            "geometry": f"B={b} H={hid} F={feat} frames={n}", "path": path,
            "ms": ms, "tflops_per_s": flops / ms / 1e9,
            "plain_ms": cuda_ms(plain, iters=2, warmup=1),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "flops": flops, "bytes": nbytes,
            "max_abs_err": errs[(name, "bf16")],
            "cuda_launches_per_call": launches[name]}
    rows["gru_scan"]["ms_with_h_seq"] = cuda_ms(
        lambda: kgru.gru_scan_fwd(*args, n, with_h=True), iters=5, warmup=1)
    rows["gru_scan_bwd"]["max_rel_l2_bf16"] = errs[("gru_scan_bwd_rel_l2",
                                                     "bf16")]
    rule = (kgru.gru_persistent_grid(b, hid, feat) if path == "persistent"
            else None)
    plan = kgru.gru_persistent_plan(b, hid, feat) if rule else None
    bwd = kgru.ScanBwdCall(ct, args, out, h_seq, plan)
    rows["gru_scan_bwd"]["stages_ms"] = bwd_stage_ms(bwd)
    rows["gru_scan_bwd"]["cuda_launches_per_stage"] = launches[
        "gru_scan_bwd_per_stage"]
    if rule:
        grids = {}
        for grid in gru_grids(b, hid, feat):
            gplan = kgru.gru_persistent_plan(b, hid, feat, grid)
            gbwd = kgru.ScanBwdCall(ct, args, out, h_seq, gplan)
            grids[f"{grid[0]}x{grid[1]}"] = {
                "blocks": int(gplan[0]),
                "fwd_ms": cuda_ms(lambda: kgru._scan_fwd(args, n, False,
                                                         gplan),
                                  iters=5, warmup=1),
                "bwd_sweep_ms": bwd_stage_ms(gbwd, iters=3)["sweep"]}
        for name in rows:
            rows[name]["grid"] = f"{rule[0]}x{rule[1]}"
            rows[name]["blocks"] = int(plan[0])
            rows[name]["grids"] = grids
        # the host loop (PR 8's design) on the same inputs, for the A/B
        def loop_fwd():
            return kgru._scan_fwd(args, n, False, None)
        rows["gru_scan"]["loop_ms"] = cuda_ms(loop_fwd, iters=3, warmup=1)
        rows["gru_scan"]["loop_cuda_launches"] = launches["gru_scan_loop"]
        loop = kgru.ScanBwdCall(ct, args, out, h_seq, None)
        rows["gru_scan_bwd"]["loop_stages_ms"] = bwd_stage_ms(loop, iters=3)
        rows["gru_scan_bwd"]["loop_ms"] = sum(
            rows["gru_scan_bwd"]["loop_stages_ms"].values())
        rows["gru_scan_bwd"]["loop_cuda_launches"] = launches[
            "gru_scan_bwd_loop"]
    for name, row in rows.items():
        print(json.dumps({"timing": name, **row}), flush=True)
    return rows


# -- the fused shuffle sites (K6, K7) and the GRU cell (K3) ---------------------

def sconv_inputs(L: dict, dtype, dev, seed: int, transpose: bool):
    """K6: (xp, w, b, offs) with xp the masked reflect pad of a random
    activation; K7: (ct, wf, offs). offs run through 0..2 rad."""
    from audiogan_tpu_torch.ops.sconv import mask_reflect_pad
    offs = (torch.arange(L["b"], device=dev) % (2 * L["rad"] + 1)).int()
    if transpose:
        ct, wf, _ = conv_inputs(L, dtype, dev, seed)
        return ct, wf, offs
    y, w, b = conv_inputs(L, torch.float32, dev, seed)
    xp = mask_reflect_pad(y, offs, L["rad"])
    return xp.to(dtype), w.to(dtype), b.to(dtype), offs


def sconv_args(L):
    return (L["s"], L["lo"], L["hi"], L["rad"], L["act"], 0.2)


def sconvt_args(L):
    return (L["s"], L["pad_lo"], L["out_len"], L["rad"])


def sconv_tensor_core(L: dict, dtype=torch.bfloat16) -> bool:
    """Whether K6 runs geometry L on the tensor cores."""
    from audiogan_tpu_torch.kernels import sconv as ksconv
    return ksconv.sconv1d_tensor_core(dtype, L["t_in"], L["cin"], L["cout"],
                                      L["k"], L["s"], L["rad"])


def sconvt_tensor_core(L: dict, dtype=torch.bfloat16) -> bool:
    """Whether K7 runs geometry L (a dx layer) on the tensor cores."""
    from audiogan_tpu_torch.kernels import sconv as ksconv
    return ksconv.sconvt1d_tensor_core(dtype, L["cin"], L["cout"], L["k"],
                                       L["s"], L["rad"])


def compare_sconv(transpose: bool, layers: list[dict], dev) -> dict:
    """K6 (or K7) against its plain form at each geometry, f32 and bf16,
    within F32_REL_TOL / BF16_REL_TOL of the peak; offs run through 0..2
    rad along the batch, so every stacked tile mixes them. Each must take
    the path its predicate names (the tensor cores in bf16 at every fused
    site), and a second launch must give the same bits. K7 writes into
    memory that held NaN just before (a zero row it forgot shows) and must
    leave zeros outside each window; on the tensor cores it takes offsets
    outside [0, 2 rad] as their clamped values (the CUDA-core tiles only
    keep their stores inside the output). Returns {(name, dtype): max abs
    err}."""
    from audiogan_tpu_torch.kernels import sconv as ksconv
    from audiogan_tpu_torch.ops.sconv import _live
    name = "sconvt1d" if transpose else "sconv1d"
    kernel, plain, args_of = (
        (ksconv.sconvt1d, ksconv.sconvt1d_plain, sconvt_args) if transpose
        else (ksconv.sconv1d_ba, ksconv.sconv1d_ba_plain, sconv_args))
    errs = {}
    for dtype, dname, tol in ((torch.float32, "f32", F32_REL_TOL),
                              (torch.bfloat16, "bf16", BF16_REL_TOL)):
        for i, L in enumerate(layers):
            *tensors, offs = sconv_inputs(L, dtype, dev, i, transpose)
            tc = (sconvt_tensor_core if transpose else sconv_tensor_core)(
                L, dtype)
            before = kernel.launches_tc
            if transpose:
                poison = torch.full((L["b"], L["out_len"] + 2 * L["rad"],
                                     L["cout"]), float("nan"), dtype=dtype,
                                    device=dev)
                del poison
            got = kernel(*tensors, offs, *args_of(L))
            again = kernel(*tensors, offs, *args_of(L))
            want = plain(*(t.float() for t in tensors), offs, *args_of(L))
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != want.shape:
                raise AssertionError(f"{name} {L['name']} {dname}: "
                                     f"{got.dtype} {tuple(got.shape)}")
            if kernel.launches_tc - before != 2 * tc:
                raise AssertionError(f"{name} {L['name']} {dname}: not on "
                                     f"the path its predicate names")
            if not torch.equal(got, again):
                raise AssertionError(f"{name} {L['name']} {dname}: two "
                                     f"launches differ")
            if transpose:
                live = _live(offs, L["out_len"], L["rad"])
                if torch.where(live, 0.0, got.float()).any() or \
                        not torch.isfinite(got.float()).all():
                    raise AssertionError(f"{name} {L['name']} {dname}: a "
                                         f"row outside a window not zero")
            if transpose and tc:
                wild = offs.clone()
                wild[0], wild[-1] = -3, 2 * L["rad"] + 5
                if not torch.equal(
                        kernel(*tensors, wild, *args_of(L)),
                        kernel(*tensors, wild.clamp(0, 2 * L["rad"]),
                               *args_of(L))):
                    raise AssertionError(f"{name} {L['name']} {dname}: "
                                         f"wild offsets not clamped")
            err = (got.float() - want).abs().max().item()
            peak = want.abs().max().item()
            errs[(L["name"], dname)] = err
            print(json.dumps({"compare": name, "dtype": dname,
                              "geometry": L["name"],
                              "path": "tensor_core" if tc else "cuda_core",
                              "x": list(tensors[0].shape),
                              "out": list(got.shape), "max_abs_err": err,
                              "max_rel_err": err / peak, "max_abs_y": peak,
                              "tol_rel": tol, "repeat_bits_equal": True}),
                  flush=True)
            if not err <= tol * peak:
                raise AssertionError(f"{name} {L['name']} {dname}: max err "
                                     f"{err} > {tol} * {peak}")
    return errs


def gru_cell_inputs(cfg, dtype, dev, seed: int = 2) -> list:
    """The cell's six inputs at cond_gru_sc09's cell: x [B, 2F] (the AR
    feature and the conditioning), h [B, H], the scan's weights."""
    h0, cond, w_i, w_h, b_i, b_h = gru_inputs(cfg, torch.float32, dev,
                                              seed)[:6]
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.cat([torch.tanh(torch.randn(cond.shape, generator=gen,
                                          device=dev)), cond], dim=-1)
    return [a.to(dtype).contiguous() for a in (x, h0, w_i, w_h, b_i, b_h)]


def ragged_cell_inputs(dtype, dev, shape=GRU_CELL_RAGGED, seed: int = 5):
    """A cell ragged against every tile of K3's tensor-core path: B below
    one m-tile, in and H not multiples of 16 (a part-filled last k-step
    and unit tile)."""
    b, in_dim, hid = shape
    gen = torch.Generator(dev).manual_seed(seed)

    def r(*s, scale=1.0):
        return torch.randn(*s, generator=gen, device=dev) * scale
    args = (r(b, in_dim), torch.tanh(r(b, hid)),
            r(in_dim, 3 * hid, scale=in_dim ** -0.5),
            r(hid, 3 * hid, scale=hid ** -0.5), r(3 * hid, scale=0.1),
            r(3 * hid, scale=0.1))
    return [a.to(dtype).contiguous() for a in args]


def compare_gru_cell(cfg, dev) -> dict:
    """K3 against its plain form (f32 within F32_REL_TOL of the peak, bf16
    within one ulp of it: the same f32 values before the one rounding of
    h') at cond_gru_sc09's cell and at a ragged one, on the path its
    predicate names (bf16: the tensor cores), a second launch to the same
    bits; and GruCell's gradients (K3 forward, plain backward) against
    autograd through the plain cell, f32, GRU_BWD_REL_L2 each."""
    from audiogan_tpu_torch.kernels import gru as kgru
    from audiogan_tpu_torch.ops.gru import gru_cell
    errs = {}
    for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for cell, args in (("gru_cell", gru_cell_inputs(cfg, dtype, dev)),
                           ("gru_cell ragged", ragged_cell_inputs(dtype,
                                                                  dev))):
            tc = kgru.gru_cell_tensor_core(dtype, args[0].shape[0],
                                           args[0].shape[1],
                                           args[1].shape[1])
            before = kgru.gru_cell_fwd.launches_tc
            got = kgru.gru_cell_fwd(*args)
            again = kgru.gru_cell_fwd(*args)
            want = kgru.gru_cell_plain(*(a.float() for a in args))
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            peak = want.abs().max().item()
            tol = (F32_REL_TOL * peak if dtype == torch.float32
                   else bf16_ulp(peak))
            print(json.dumps({"compare": cell, "dtype": dname,
                              "path": "tensor_core" if tc else "cuda_core",
                              "x": list(args[0].shape),
                              "h": list(args[1].shape),
                              "max_abs_err": err, "max_abs_y": peak,
                              "tol_abs": tol, "repeat_bits_equal":
                              torch.equal(got, again)}), flush=True)
            if got.dtype != dtype or not err <= tol:
                raise AssertionError(f"{cell} {dname}: {err} > {tol}")
            if kgru.gru_cell_fwd.launches_tc - before != 2 * tc:
                raise AssertionError(f"{cell} {dname}: not on the path its "
                                     f"predicate names")
            if dtype == torch.bfloat16 and not tc:
                raise AssertionError(f"{cell} bf16 must run the tensor cores")
            if not torch.equal(got, again):
                raise AssertionError(f"{cell} {dname}: two launches differ")
            errs[(cell, dname)] = err
    args = [a.requires_grad_(True) for a in gru_cell_inputs(cfg,
                                                            torch.float32,
                                                            dev)]
    gen = torch.Generator(dev).manual_seed(3)
    ct = torch.randn(args[1].shape, generator=gen, device=dev)
    got = torch.autograd.grad((gru_cell(*args, impl="pallas") * ct).sum(),
                              args)
    want = torch.autograd.grad((gru_cell(*args, impl="xla") * ct).sum(),
                               args)
    rel = {n: ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
           for n, g, w in zip(kgru.CELL_ARG_NAMES, got, want)}
    print(json.dumps({"compare": "gru_cell_grad", "dtype": "f32",
                      "rel_l2": rel, "tol_rel_l2": GRU_BWD_REL_L2}),
          flush=True)
    bad = {k: v for k, v in rel.items() if not v <= GRU_BWD_REL_L2}
    if bad:
        raise AssertionError(f"gru_cell gradients: {bad}")
    errs[("gru_cell_grad_rel_l2", "f32")] = max(rel.values())
    return errs


def gru_cell_phase(cfg, dev, frames: int = 256) -> dict:
    """A frames-long recurrence h_t = gru_cell(x_t, h_{t-1}, impl="pallas")
    at cond_gru_sc09's cell, f32, forward (K3, counted: zeroed just before,
    read just after) and backward; against the same recurrence through
    the plain cell (impl="xla") on the card: h_T within F32_REL_TOL of the
    peak, every gradient within GRU_BWD_REL_L2 relative L2. Then bf16,
    forward: every launch on the tensor cores, h_T against the plain
    form's recurrence within BF16_REL_TOL of the peak (each frame rounds
    h' once; a rounding that flips in one frame moves the later ones by
    about an ulp, which the cell's blend does not amplify)."""
    from audiogan_tpu_torch.kernels import gru as kgru
    from audiogan_tpu_torch.ops.gru import gru_cell
    x0, h0, *params = gru_cell_inputs(cfg, torch.float32, dev)
    gen = torch.Generator(dev).manual_seed(4)
    xs = torch.tanh(torch.randn(frames, *x0.shape, generator=gen,
                                device=dev))

    def run(impl):
        leaves = [t.clone().requires_grad_(True) for t in (xs, h0, *params)]
        h = leaves[1]
        for t in range(frames):
            h = gru_cell(leaves[0][t], h, *leaves[2:], impl=impl)
        grads = torch.autograd.grad(h.square().sum(), leaves)
        torch.cuda.synchronize()
        return h.detach(), grads

    kgru.gru_cell_fwd.launches = 0
    t0 = time.perf_counter()
    h_k, g_k = run("pallas")
    seconds = time.perf_counter() - t0
    launches = kgru.gru_cell_fwd.launches
    h_p, g_p = run("xla")
    if launches != frames:
        raise AssertionError(f"gru_cell launched {launches} times in "
                             f"{frames} frames")
    err = (h_k - h_p).abs().max().item()
    peak = h_p.abs().max().item()
    rel = {n: ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
           for n, g, w in zip(("xs", *kgru.CELL_ARG_NAMES[1:]), g_k, g_p)}
    if not (torch.isfinite(h_k).all() and err <= F32_REL_TOL * peak
            and max(rel.values()) <= GRU_BWD_REL_L2):
        raise AssertionError(f"gru_cell recurrence: h err {err} (peak "
                             f"{peak}), grads {rel}")

    # bf16, forward: K3 on the tensor cores against the plain form's
    # recurrence (the kernel's numerics) on the same inputs
    xs16, h16 = xs.bfloat16(), h0.bfloat16()
    p16 = [t.bfloat16() for t in params]
    with torch.no_grad():
        kgru.gru_cell_fwd.launches = kgru.gru_cell_fwd.launches_tc = 0
        t0 = time.perf_counter()
        hk = h16
        for t in range(frames):
            hk = gru_cell(xs16[t], hk, *p16, impl="pallas")
        torch.cuda.synchronize()
        seconds16 = time.perf_counter() - t0
        launches16 = kgru.gru_cell_fwd.launches
        launches16_tc = kgru.gru_cell_fwd.launches_tc
        hp = h16
        for t in range(frames):
            hp = kgru.gru_cell_plain(xs16[t], hp, *p16)
    if launches16 != frames or launches16_tc != frames:
        raise AssertionError(f"bf16 gru_cell: {launches16} launches, "
                             f"{launches16_tc} on the tensor cores, in "
                             f"{frames} frames")
    err16 = (hk.float() - hp.float()).abs().max().item()
    peak16 = hp.float().abs().max().item()
    if not (torch.isfinite(hk.float()).all()
            and err16 <= BF16_REL_TOL * peak16):
        raise AssertionError(f"bf16 gru_cell recurrence: h err {err16} "
                             f"(peak {peak16})")
    return dict(frames=frames, batch=h0.shape[0], x=list(x0.shape),
                h=list(h0.shape), dtype="float32", launches=launches,
                seconds_fwd_bwd=seconds, h_max_abs_err=err, h_peak=peak,
                grad_rel_l2=rel, tol_rel=F32_REL_TOL,
                tol_grad_rel_l2=GRU_BWD_REL_L2,
                bf16=dict(launches=launches16,
                          launches_tensor_core=launches16_tc,
                          seconds_fwd=seconds16, h_max_abs_err=err16,
                          h_peak=peak16, tol_rel=BF16_REL_TOL))


def sconv_cuda_core(L: dict, xp, w, b, offs):
    """K6's CUDA-core tiles (its path before the tensor cores, and still
    f32's) launched directly at geometry L: the measured alternative.
    Not a counted launch."""
    from audiogan_tpu_torch.kernels import sconv as ksconv
    lib = ksconv._lib()
    y = torch.empty(L["b"], (L["t_in"] + L["lo"] + L["hi"] - L["k"])
                    // L["s"] + 1, L["cout"], dtype=xp.dtype, device=xp.device)

    def call():
        err = lib.sconv1d_launch(
            xp.data_ptr(), w.data_ptr(), b.data_ptr(), offs.data_ptr(),
            y.data_ptr(), L["b"], xp.shape[1], L["cin"], L["cout"], L["k"],
            L["s"], L["lo"], L["hi"], L["rad"], ksconv.ACTS[L["act"]], 0.2,
            1, torch.cuda.current_stream(xp.device).cuda_stream)
        ksconv._raise_if(lib, err, "sconv1d")
    return call


def sconvt_cuda_core(L: dict, ct, wf, offs):
    """K7's CUDA-core tiles (its path before the tensor cores, and still
    f32's) launched directly at geometry L: the measured alternative.
    Not a counted launch."""
    from audiogan_tpu_torch.kernels import sconv as ksconv
    lib = ksconv._lib()
    y = torch.empty(L["b"], L["out_len"] + 2 * L["rad"], L["cout"],
                    dtype=ct.dtype, device=ct.device)

    def call():
        err = lib.sconvt1d_launch(
            ct.data_ptr(), wf.data_ptr(), offs.data_ptr(), y.data_ptr(),
            L["b"], L["t_in"], L["cin"], L["cout"], L["k"], L["s"],
            L["pad_lo"], L["out_len"], L["rad"], 1,
            torch.cuda.current_stream(ct.device).cuda_stream)
        ksconv._raise_if(lib, err, "sconvt1d")
    return call


def sconvt_tile_times(L: dict, ct, wf, offs) -> dict:
    """K7's tensor-core kernel at each tile of kernels/conv.py TC_TILES,
    launched with that tile's plan: the measured alternatives to the tile
    the wrapper picks. Not counted launches."""
    from audiogan_tpu_torch.kernels import conv as kconv
    from audiogan_tpu_torch.kernels import sconv as ksconv
    y = torch.empty(L["b"], L["out_len"] + 2 * L["rad"], L["cout"],
                    dtype=ct.dtype, device=ct.device)
    out = {}
    for tile, (nwg, bn) in enumerate(kconv.TC_TILES):
        plan = ksconv.sconvt1d_tc_plan(L["b"], L["cout"], L["k"], L["s"],
                                       L["pad_lo"], L["out_len"], L["rad"],
                                       tile)
        out[f"{64 * nwg}x{bn}"] = cuda_ms(
            lambda: ksconv._sconvt1d_tc(ct, wf, offs, y, L["rad"], plan))
    return out


def time_sconv(transpose: bool, layers: list[dict], dev, errs: dict) -> list:
    """K6 (or K7) per geometry, bf16: kernel, plain form, and the unfused
    pair it replaces (PShuf's gather + the conv1d kernel for K6; the convT
    kernel + PShufT for K7), which no single PyTorch call matches; their
    CUDA-core tiles; for K7 also the convT kernel (K1) alone, the tile its
    plan takes and each tile's time."""
    from audiogan_tpu_torch.kernels import conv as kconv
    from audiogan_tpu_torch.kernels import sconv as ksconv
    from audiogan_tpu_torch.ops.phase_shuffle import _pshuf, _pshuft
    rows = []
    for i, L in enumerate(layers):
        *tensors, offs = sconv_inputs(L, torch.bfloat16, dev, i, transpose)
        offs_l = offs.long()
        rad = L["rad"]
        extra = {}
        if transpose:
            ct, wf = tensors
            zeros = torch.zeros(L["cout"], dtype=ct.dtype, device=dev)
            args = sconvt_args(L)
            kernel = lambda: ksconv.sconvt1d(ct, wf, offs, *args)
            plain = lambda: ksconv.sconvt1d_plain(ct, wf, offs, *args)
            pair = lambda: _pshuft(kconv.conv_transpose1d_ba(
                ct, wf, zeros, L["s"], L["pad_lo"], L["out_len"]),
                offs_l, rad)
            flops, nbytes = sconvt_work(L, 2)
            plan = ksconv.sconvt1d_tc_plan(L["b"], L["cout"], L["k"],
                                           L["s"], L["pad_lo"],
                                           L["out_len"], rad)
            nwg, bn = kconv.TC_TILES[int(plan[0])]
            extra = {"path": ("tensor_core" if sconvt_tensor_core(L)
                              else "cuda_core"),
                     "tile": f"{64 * nwg}x{bn}", "nb": int(plan[2]),
                     "tile_ms": sconvt_tile_times(L, ct, wf, offs),
                     "convt1d_ms": cuda_ms(
                         lambda: kconv.conv_transpose1d_ba(
                             ct, wf, zeros, L["s"], L["pad_lo"],
                             L["out_len"])),
                     "cuda_core_ms": cuda_ms(sconvt_cuda_core(L, ct, wf,
                                                              offs),
                                             iters=5, warmup=1)}
        else:
            xp, w, b = tensors
            y = xp[:, rad:xp.shape[1] - rad].contiguous()
            args = sconv_args(L)
            kernel = lambda: ksconv.sconv1d_ba(xp, w, b, offs, *args)
            plain = lambda: ksconv.sconv1d_ba_plain(xp, w, b, offs, *args)
            pair = lambda: kconv.conv1d_ba(_pshuf(y, offs_l, rad), w, b,
                                           L["s"], L["lo"], L["hi"],
                                           L["act"], 0.2)
            flops, nbytes = sconv_work(L, 2)
            extra = {"path": ("tensor_core" if sconv_tensor_core(L)
                              else "cuda_core"),
                     "cuda_core_ms": cuda_ms(sconv_cuda_core(L, xp, w, b,
                                                             offs),
                                             iters=5, warmup=1)}
        bound_ms, bound_by = bound(flops, nbytes)
        ms = cuda_ms(kernel)
        rows.append({
            "geometry": L["name"], "x": list(tensors[0].shape), **extra,
            "ms": ms, "tflops_per_s": flops / ms / 1e9,
            "plain_ms": cuda_ms(plain), "library_ms": None,
            "unfused_pair_ms": cuda_ms(pair),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "flops": flops, "bytes": nbytes,
            "max_abs_err": errs[(L["name"], "bf16")],
        })
        print(json.dumps({"timing": "sconvt1d" if transpose else "sconv1d",
                          **rows[-1]}), flush=True)
    return rows


def queued_device_ms(fn, reps: int = 50) -> float:
    """One call's device time: CUDA events around it, queued behind a
    sleep kernel so that the host's time to enqueue it is hidden; the
    median of reps."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_ms(fn, iters: int = 50) -> float:
    """One call's host time: the calls enqueue behind a sleep kernel, so
    none waits on the device; host clock, per call."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES * 50)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return host


def profiled_device_ms(fn, iters: int = 50) -> float | None:
    """torch.profiler's device time of the kernels fn launches, per call
    (None where the profiler records no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return us / iters / 1e3 if us > 0 else None


def time_gru_cell(cfg, dev, errs: dict) -> dict:
    """K3 at cond_gru_sc09's cell, bf16 (the tensor-core path). Its
    library call is torch.nn.GRUCell, the same r, z, n gates and blend
    over [3H, in] weights (w_i.T and w_h.T, copied outside the timed
    call); it is first held to the plain form in f32 (F32_REL_TOL of the
    peak). Protocol time: the two timed in K3_ROUNDS alternating rounds
    (K3, library, K3, ...) of K3_LAUNCHES back-to-back launches each,
    after one warm-up round of each; ms and library_ms are the medians,
    with each one's spread (max - min over its rounds) beside them.
    Device time: torch.profiler's kernel time per call, and events around
    one call queued behind a sleep (queued_device_ms), for both; and each
    one's host time per call (host_ms), which sets the protocol time where
    it exceeds the device time."""
    from audiogan_tpu_torch.kernels import gru as kgru

    def library(dtype):
        args = gru_cell_inputs(cfg, dtype, dev)
        x, h, w_i, w_h, b_i, b_h = args
        cell = torch.nn.GRUCell(x.shape[1], h.shape[1], device=dev,
                                dtype=dtype)
        with torch.no_grad():
            for p, v in ((cell.weight_ih, w_i.T), (cell.weight_hh, w_h.T),
                         (cell.bias_ih, b_i), (cell.bias_hh, b_h)):
                p.copy_(v)
        return args, cell
    args, cell = library(torch.float32)
    with torch.no_grad():
        want = kgru.gru_cell_plain(*args)
        lib_err = (cell(args[0], args[1]) - want).abs().max().item()
    if not lib_err <= F32_REL_TOL * want.abs().max().item():
        raise AssertionError(f"torch.nn.GRUCell vs the plain cell: {lib_err}")
    args, cell = library(torch.bfloat16)
    x, h = args[0], args[1]
    b, in_dim, hid = x.shape[0], x.shape[1], h.shape[1]
    flops = 2 * b * 3 * hid * (in_dim + hid)
    nbytes = 2 * (sum(a.numel() for a in args) + b * hid)
    bound_ms, bound_by = bound(flops, nbytes)
    rounds = {"kernel": [], "library": []}
    with torch.no_grad():
        for i in range(K3_ROUNDS):
            for name, fn in (("kernel", lambda: kgru.gru_cell_fwd(*args)),
                             ("library", lambda: cell(x, h))):
                rounds[name].append(cuda_ms(fn, iters=K3_LAUNCHES,
                                            warmup=1 if i else 3))
        device = {"device_ms_profiler": profiled_device_ms(
                      lambda: kgru.gru_cell_fwd(*args)),
                  "library_device_ms_profiler": profiled_device_ms(
                      lambda: cell(x, h)),
                  "device_ms_queued": queued_device_ms(
                      lambda: kgru.gru_cell_fwd(*args)),
                  "library_device_ms_queued": queued_device_ms(
                      lambda: cell(x, h)),
                  "host_ms": host_ms(lambda: kgru.gru_cell_fwd(*args)),
                  "library_host_ms": host_ms(lambda: cell(x, h))}
        # the tensor-core kernel at every cluster split: the measured
        # alternatives to gru_cell_plan's (launched directly, not counted)
        out = torch.empty_like(h)
        split_ms = {d: profiled_device_ms(
            lambda: kgru._gru_cell_tc(args, out, d))
            for d in (1, 2, 4, 8)}
    ms = float(np.median(rounds["kernel"]))
    library_ms = float(np.median(rounds["library"]))
    row = {"geometry": f"x [{b},{in_dim}], h [{b},{hid}]", "ms": ms,
           "ms_spread": max(rounds["kernel"]) - min(rounds["kernel"]),
           "library_ms_spread": (max(rounds["library"])
                                 - min(rounds["library"])),
           "rounds_ms": rounds, "protocol": f"median of {K3_ROUNDS} "
           f"alternating rounds of {K3_LAUNCHES} launches",
           "tflops_per_s": flops / ms / 1e9,
           "plain_ms": cuda_ms(lambda: kgru.gru_cell_plain(*args), iters=50),
           "path": ("tensor_core" if kgru.gru_cell_tensor_core(
               x.dtype, b, in_dim, hid) else "cuda_core"), **device,
           "split": int(kgru.gru_cell_plan(b, in_dim, hid)[1]),
           "split_device_ms_profiler": split_ms,
           "library_ms": library_ms, "library_f32_max_abs_err": lib_err,
           "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
           "bytes": nbytes, "max_abs_err": errs[("gru_cell", "bf16")]}
    print(json.dumps({"timing": "gru_cell", **row}), flush=True)
    return row


# -- serving --------------------------------------------------------------------

def http_json(url: str, body: dict | None = None) -> tuple[int, dict]:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def decode_wav(b64: str) -> tuple[int, np.ndarray]:
    with wave.open(io.BytesIO(base64.b64decode(b64))) as f:
        if f.getnchannels() != 1 or f.getsampwidth() != 2:
            raise AssertionError("want 16-bit mono wav")
        rate = f.getframerate()
        pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
    return rate, pcm


def sampler_graph(sampler) -> dict:
    """A replaying sampler's capture: its summary and its pool's bytes."""
    if sampler.route != "replay":
        raise AssertionError(f"the sampler runs {sampler.route}, want replay")
    return {**sampler.summary(),
            "pool_bytes": graph_pool_bytes(sampler._graph.graph)}


def serve_phase(cfg, dev, counters: dict, per_request: dict):
    """cfg's generator exported (at BATCH, and at SMALL for the timing),
    loaded and served over HTTP; the requests carry labels when cfg is
    conditional. per_request: the launches each batch must make of each
    kernel; the other counters must stay 0. The sampler replays one CUDA
    graph per request: each kernel wrapper's kernel nodes in it equal its
    launches per request, and its batch equals the eager route's and
    build_sample_fn's to the bit."""
    from audiogan_tpu_torch.models import build_generator
    from audiogan_tpu_torch.models.init import init_params
    from audiogan_tpu_torch.serve import (ServedSampler, export_sampler,
                                          load_sampler, make_server)
    from audiogan_tpu_torch.train.sample import build_sample_fn, generate
    art = ROOT / "build" / f"chip_smoke_artifact_{cfg.name}"
    art_small = ROOT / "build" / f"chip_smoke_artifact_{cfg.name}_{SMALL}"
    for d in (art, art_small):
        shutil.rmtree(d, ignore_errors=True)
    g = init_params(build_generator(cfg, device=dev), seed=0)
    params = g.state_dict()
    export_sampler(cfg, params, num=BATCH, out_dir=art)
    export_sampler(cfg, params, num=SMALL, out_dir=art_small)
    sampler = load_sampler(art)
    graph = sampler_graph(sampler)
    srv = make_server(sampler, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d" % srv.server_address[:2]
    n_cls = cfg.data.num_classes
    labels = [i % n_cls for i in range(BATCH)] if n_cls else None
    other = [(i + 1) % n_cls for i in range(SMALL)] if n_cls else None

    def generate_req(seed, num, lab=labels):
        body = {"seed": seed, "num": num}
        if lab is not None:
            body["labels"] = lab[:num]
        return http_json(f"{url}/generate", body)
    try:
        for c in counters.values():
            c.launches = 0
        code, health = http_json(f"{url}/healthz")
        r8 = generate_req(1, SMALL)
        r64 = generate_req(1, BATCH)
        r64b = generate_req(1, BATCH)
        r2 = generate_req(2, SMALL)
        answered = [r8, r64, r64b, r2]
        if n_cls:
            r_lab = generate_req(1, SMALL, other)
            answered.append(r_lab)
        bad = [http_json(f"{url}/generate", {"seed": 1, "num": n})[0]
               for n in (0, BATCH + 1)]
        launches = {name: c.launches for name, c in counters.items()}
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")
    n_generate = len(answered)
    if code != 200 or health["num"] != BATCH or health["status"] != "ok":
        raise AssertionError(f"healthz: {code} {health}")
    for c, body in answered:
        if c != 200:
            raise AssertionError(f"generate: {c} {body}")
    if bad != [400, 400]:
        raise AssertionError(f"bad num gave {bad}, want 400")
    if r64[1]["wavs"] != r64b[1]["wavs"]:
        raise AssertionError("same seed gave different bytes")
    if r64[1]["wavs"][:SMALL] != r8[1]["wavs"]:
        raise AssertionError("the small request is not a prefix")
    if r2[1]["wavs"] == r8[1]["wavs"]:
        raise AssertionError("different seeds gave the same bytes")
    if n_cls and r_lab[1]["wavs"] == r8[1]["wavs"]:
        raise AssertionError("different labels gave the same bytes")
    for name, n in launches.items():
        want = per_request.get(name, 0) * n_generate
        if n != want:
            raise AssertionError(f"{name} launched {n} times for "
                                 f"{n_generate} requests, want {want}")
    pcm = []
    for b64 in r64[1]["wavs"]:
        rate, p = decode_wav(b64)
        if rate != cfg.data.sample_rate or p.shape != (cfg.data.clip_len,):
            raise AssertionError(f"wav {rate} Hz, {p.shape}")
        pcm.append(p)
    pcm = np.stack(pcm)
    lab = np.array(labels) if n_cls else None
    waves = sampler.generate(1, lab)
    if not np.isfinite(waves).all() or not pcm.any():
        raise AssertionError("non-finite or silent output")
    want16 = np.round(np.clip(waves, -1, 1) * 32767).astype(np.int16)
    if not np.array_equal(pcm, want16):
        raise AssertionError("served wav bytes differ from the sampler")
    # the graph's kernel nodes against the launches each request counted
    for name, c in counters.items():
        if isinstance(c, PathCounter):
            continue
        rec = graph["port_kernels"].get(hooks.label(c.__name__), {})
        if rec.get("kernel_nodes", 0) != per_request.get(name, 0):
            raise AssertionError(f"{name}: {rec} in the served graph, "
                                 f"{per_request.get(name, 0)} launches a "
                                 f"request")
    # the replayed batch against the eager route and build_sample_fn
    eager = ServedSampler(art, replay=False)
    lab_t = None if lab is None else torch.from_numpy(lab)
    direct = build_sample_fn(cfg, dev)(params, 1, lab_t,
                                       num=BATCH).cpu().numpy()
    for route, other in (("eager route", eager.generate(1, lab)),
                         ("build_sample_fn", direct)):
        if not np.array_equal(waves, other):
            raise AssertionError(f"the replayed batch differs from the "
                                 f"{route}'s")
    del eager
    # the card's output against the port on the CPU (plain forms), same z
    z = torch.randn(BATCH, cfg.model.latent_dim,
                    generator=torch.Generator(dev).manual_seed(1),
                    device=dev)[:2].cpu()
    lab2 = None if lab is None else lab[:2]
    cpu_params = {k: v.cpu() for k, v in params.items()}
    ref_checks = {}
    cfg32 = cfg.replace(train=dataclasses.replace(cfg.train,
                                                  dtype="float32"))
    own = ("bf16", SERVE_BF16_REL_TOL) if cfg.train.dtype == "bfloat16" \
        else ("own f32", F32_REL_TOL)
    for dname, c, tol in ((*own[:1], cfg, own[1]),
                          ("f32", cfg32, F32_REL_TOL)):
        on_card = (waves[:2] if c is cfg else
                   generate(c, params, 2, 1, lab2, device=dev, z=z))
        ref = generate(c, cpu_params, 2, 1, lab2, device="cpu", z=z)
        err = float(np.abs(on_card - ref).max())
        peak = float(np.abs(ref).max())
        ref_checks[dname] = {"max_abs_err": err, "max_abs_ref": peak,
                             "tol_rel": tol}
        if not err <= tol * peak:
            raise AssertionError(f"served {dname} G vs CPU reference: "
                                 f"{err} > {tol} * {peak}")
    return sampler, dict(preset=cfg.name, requests=n_generate + 3,
                         route=sampler.route, graph=graph,
                         replay_equals_eager=True,
                         artifacts={BATCH: str(art), SMALL: str(art_small)},
                         generate_requests=n_generate, launches=launches,
                         launches_per_request={
                             k: v / n_generate for k, v in launches.items()},
                         clip_len=cfg.data.clip_len,
                         sample_rate=cfg.data.sample_rate,
                         labels=bool(n_cls), reference=ref_checks)


# -- training -------------------------------------------------------------------

def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def parity_phase(cfg, dev, batch: int) -> dict:
    """One f32 step on the card and on the CPU from the same state (taken
    after one warm step on the card, so Adam's second moment is non-zero
    and the update is smooth in the gradient) and the same draws. The
    step on the card is bit-reproducible (the weight gradients run cuDNN's
    deterministic algorithms, kernels/autograd.py::conv1d_wgrad), so the
    compared state, and the result, is the same in every run."""
    from audiogan_tpu_torch.train.state import create_train_state
    from audiogan_tpu_torch.train.step import (build_train_step, draw_step,
                                               num_views)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, dtype="float32", batch_size=batch))
    cpu = torch.device("cpu")
    n_views = num_views(cfg)
    card = create_train_state(cfg, device=dev)
    step_card = build_train_step(cfg, dev)
    raw0, lab0 = random_raw(cfg, n_views, batch, seed=10)
    step_card(card, raw0, lab0)
    host = create_train_state(cfg, device=cpu)
    copy_state(card, host)
    draws = draw_step(cfg, card.seed, card.step, batch, cpu)
    raw1, lab1 = random_raw(cfg, n_views, batch, seed=11)
    t_card = time.time()
    m_card = step_card(card, raw1, lab1, draws=draws)
    m_card = {k: float(v) for k, v in m_card.items()}
    t_card = time.time() - t_card
    t_host = time.time()
    m_host = build_train_step(cfg, cpu)(host, raw1, lab1, draws=draws)
    m_host = {k: float(v) for k, v in m_host.items()}
    t_host = time.time() - t_host
    report = compare_steps(m_card, card, m_host, host)
    return dict(batch=batch, dtype="float32", metrics_card=m_card,
                metrics_cpu=m_host, **report, tol_rel=PARITY_REL_TOL,
                tol_param_abs=PARITY_PARAM_TOL,
                card_step_s=t_card, cpu_step_s=t_host)


def copy_state(src, dst) -> None:
    """src's weights, Adam state and step into dst (on dst's device)."""
    dev = next(dst.g.parameters()).device
    for a, b in ((src.g, dst.g), (src.d, dst.d)):
        b.load_state_dict({k: v.to(dev) for k, v in a.state_dict().items()})
    for (so, sm), (do, dm) in (((src.opt_g, src.g), (dst.opt_g, dst.g)),
                               ((src.opt_d, src.d), (dst.opt_d, dst.d))):
        for ps, pd in zip(sm.parameters(), dm.parameters()):
            do.state[pd] = {k: v.detach().to(dev).clone()
                            for k, v in so.state[ps].items()}
    dst.step = src.step


def gp_chunk_phase(cfg, dev, chunks: int = 2) -> dict:
    """One f32 step at the preset's batch with loss.gp_batch_chunks =
    chunks against one with 1, on the card, from one state and the same
    draws (the unchunked penalty's shifts are the chunk's, repeated: the
    chunked penalty gives every chunk the same shifts), under the parity
    bounds; the peak memory of each."""
    from audiogan_tpu_torch.train.state import create_train_state
    from audiogan_tpu_torch.train.step import (build_train_step, draw_step,
                                               num_views)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, dtype="float32"))
    ccfg = cfg.replace(loss=dataclasses.replace(cfg.loss,
                                                gp_batch_chunks=chunks))
    batch, n_views = cfg.train.batch_size, num_views(cfg)
    whole = create_train_state(cfg, device=dev)
    step = build_train_step(cfg, dev)
    step(whole, *random_raw(cfg, n_views, batch, seed=10))
    chunked = create_train_state(cfg, device=dev)
    copy_state(whole, chunked)
    draws = draw_step(ccfg, whole.seed, whole.step, batch, dev)
    unchunked = {"generator": draws["generator"], "critic": [
        {**dr, "shifts": {**dr["shifts"], "gp": dr["shifts"]["gp"].repeat(
            1, chunks)}} for dr in draws["critic"]]}
    raw, lab = random_raw(cfg, n_views, batch, seed=11)
    out = {}
    for name, state, fn, dr in (("whole", whole, step, unchunked),
                                ("chunked", chunked,
                                 build_train_step(ccfg, dev), draws)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.time()
        m = {k: float(v) for k, v in fn(state, raw, lab, draws=dr).items()}
        out[name] = {"metrics": m, "seconds": time.time() - t,
                     "peak_memory_gib":
                         torch.cuda.max_memory_allocated(dev) / 2**30}
    report = compare_steps(out["chunked"]["metrics"], chunked,
                           out["whole"]["metrics"], whole)
    # the penalty alone (x-hat's forward, input gradient, double backward
    # into D's parameters), its peak above what was allocated before it
    from audiogan_tpu_torch.losses import gradient_penalty
    d = whole.d
    real = torch.rand(batch, cfg.data.clip_len, 1, device=dev) * 2 - 1
    fake = torch.rand(batch, cfg.data.clip_len, 1, device=dev) * 2 - 1
    shifts = draws["critic"][0]["shifts"]["gp"]
    for c in (1, chunks):
        sh = shifts.repeat(1, chunks // c)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        gp, _ = gradient_penalty([lambda x: d(x, None, sh)] * c, real,
                                 fake, draws["critic"][0]["eps"],
                                 list(d.parameters()))
        torch.autograd.grad(gp, list(d.parameters()), allow_unused=True)
        torch.cuda.synchronize()
        out["whole" if c == 1 else "chunked"]["penalty_peak_gib"] = (
            torch.cuda.max_memory_allocated(dev) - base) / 2**30
        del gp
    return dict(batch=batch, dtype="float32", chunks=chunks, **out,
                **report, tol_rel=PARITY_REL_TOL,
                tol_param_abs=PARITY_PARAM_TOL)


def compare_steps(m_card, card, m_host, host) -> dict:
    """Metrics, gradients, Adam moments and parameters of two states after
    one step (``host`` the reference side), under the parity bounds;
    raises if they differ, else returns the report."""
    metric_err = {k: abs(m_card[k] - m_host[k]) for k in m_host}
    # the gradients of this step (G's, and D's from its last micro-step)
    # and both Adam moments: relative L2 error over each net, and the worst
    # tensor by max error relative to its own largest element (a small
    # tensor whose sums cancel, such as a bias, shows rounding there); the
    # parameters in absolute terms
    grads, moments, params, moved = {}, {}, {}, {}
    for name, (oa, ma), (ob, mb) in (("G", (card.opt_g, card.g),
                                      (host.opt_g, host.g)),
                                     ("D", (card.opt_d, card.d),
                                      (host.opt_d, host.d))):
        sq = {"grad": [0.0, 0.0], "exp_avg": [0.0, 0.0],
              "exp_avg_sq": [0.0, 0.0]}
        worst_tensor = (0.0, None)
        p_abs, worst_at = 0.0, None
        n_moved = n_all = 0
        for (pname, pa), pb in zip(ma.named_parameters(), mb.parameters()):
            pairs = {"grad": (pa.grad.cpu(), pb.grad.cpu())}
            for key in ("exp_avg", "exp_avg_sq"):
                pairs[key] = (oa.state[pa][key].cpu(),
                              ob.state[pb][key].cpu())
            for key, (va, vb) in pairs.items():
                sq[key][0] += float((va - vb).double().square().sum())
                sq[key][1] += float(vb.double().square().sum())
            r = rel_err(*pairs["grad"])
            if r > worst_tensor[0]:
                worst_tensor = (r, pname)
            d = (pa.detach().cpu() - pb.detach().cpu()).abs()
            if d.max().item() > p_abs:
                i = int(d.argmax())
                p_abs = d.max().item()
                worst_at = {"tensor": pname, "grad_there": pb.grad.flatten()[i]
                            .item(), "tensor_max_abs_grad":
                            pb.grad.abs().max().item()}
            n_moved += int((d > PARITY_PARAM_FINE).sum())
            n_all += d.numel()
        rel = {k: (v[0] / max(v[1], 1e-300)) ** 0.5 for k, v in sq.items()}
        grads[name] = {"rel_l2": rel["grad"],
                       "worst_tensor_max_rel": worst_tensor[0],
                       "worst_tensor": worst_tensor[1]}
        moments[name] = {"exp_avg": rel["exp_avg"],
                         "exp_avg_sq": rel["exp_avg_sq"]}
        params[name] = {"max_abs_err": p_abs, "at": worst_at}
        moved[name] = n_moved / n_all
    report = dict(metric_abs_err=metric_err, grad_err=grads,
                  adam_moment_rel_l2=moments, params=params,
                  fraction_params_moved_over_1e_6=moved)
    print(json.dumps({"parity_report": report}), flush=True)
    for k, e in metric_err.items():
        if not (np.isfinite(m_card[k])
                and e <= PARITY_REL_TOL * max(abs(m_host[k]), 1e-3)):
            raise AssertionError(f"parity {k}: card {m_card[k]} vs CPU "
                                 f"{m_host[k]}")
    for name in grads:
        if not (grads[name]["rel_l2"] <= PARITY_REL_TOL
                and max(moments[name].values()) <= PARITY_REL_TOL
                and params[name]["max_abs_err"] <= PARITY_PARAM_TOL):
            raise AssertionError(f"parity: {name} differs: {report}")
    return report


def train_phase(cfg, dev, counters: dict, per_step: dict,
                timed: int = TRAIN_TIMED) -> tuple[dict, object]:
    """cfg through train.loop.train, which trains by replaying one CUDA
    graph (its first step eager, the second captured): counts zeroed just
    before, read just after, each the eager step's calls plus the graph's
    kernel nodes times its replays (train/step_graph.py). Every counter
    must have launched, a whole number of times per step, but those
    per_step holds at 0; per_step names exact counts (Adam's kernel one
    per update: n_critic + 1). Events around each replay give its device
    time, and the timed window's idle share. Returns the report and the
    trained state."""
    from audiogan_tpu_torch.train.loop import train
    from audiogan_tpu_torch.train.step_graph import StepGraph
    workdir = ROOT / "build" / f"chip_smoke_train_{cfg.name}"
    shutil.rmtree(workdir, ignore_errors=True)
    lines = []
    n_steps = TRAIN_WARMUP + timed
    per_step = {**per_step, **adam_step_launches(cfg)}
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, log_every=1))
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters.values():
        c.launches = 0
    events = []
    replay = StepGraph.replay

    def timed_replay(self, state):
        pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        pair[0].record()
        out = replay(self, state)
        pair[1].record()
        events.append(pair)
        return out
    StepGraph.replay = timed_replay
    try:
        state, last = train(cfg, workdir, n_steps, device=dev,
                            log=lambda s: lines.append(json.loads(s)))
    finally:
        StepGraph.replay = replay
    launches = {name: c.launches for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.synchronize(dev)
    replay_ms = [a.elapsed_time(b) for a, b in events]
    init = [ln for ln in lines if "init" in ln][0]["init"]
    graphs = [ln["graph"] for ln in lines if "graph" in ln]
    if init["steps"] != "replay" or len(graphs) != 1 or \
            len(replay_ms) != n_steps - 1:
        raise AssertionError(f"{cfg.name}: the loop did not replay: "
                             f"{init}, {len(graphs)} captures, "
                             f"{len(replay_ms)} replays")
    steps = [ln for ln in lines if "step" in ln]
    if len(steps) != n_steps:
        raise AssertionError(f"{len(steps)} metric lines for {n_steps} steps")
    for ln in steps:
        bad = [k for k, v in ln.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite {bad} at step {ln['step']}")
    # the loop checkpoints its last step after that step's line: outside
    # the timed window
    saves = [i for i, ln in enumerate(lines) if "ckpt" in ln]
    last_line = max(i for i, ln in enumerate(lines) if "step" in ln)
    if [lines[i]["ckpt"]["step"] for i in saves] != [n_steps] or \
            saves[0] < last_line:
        raise AssertionError(f"want one checkpoint, of step {n_steps}, "
                             f"after the last step's line: {saves}")
    for name, n in launches.items():
        if n <= 0 and per_step.get(name) != 0:
            raise AssertionError(f"{name} was not launched in training")
        if n % n_steps:
            raise AssertionError(f"{name}: {n} launches in {n_steps} steps")
    for name, want in per_step.items():
        if launches[name] != want * n_steps:
            raise AssertionError(f"{name}: {launches[name]} launches in "
                                 f"{n_steps} steps, want {want} per step")
    timed_s = steps[-1]["seconds"] - steps[TRAIN_WARMUP - 1]["seconds"]
    timed_ms = replay_ms[-timed:]
    g = graphs[0]
    return dict(preset=cfg.name, batch=cfg.train.batch_size,
                dtype=cfg.train.dtype, n_critic=cfg.loss.n_critic,
                fused_d_views=cfg.train.fused_d_views, steps=n_steps,
                warmup_steps=TRAIN_WARMUP, timed_steps=timed,
                timed_seconds=timed_s, steps_per_s=timed / timed_s,
                workdir=str(workdir),
                launches=launches,
                launches_per_step={k: v // n_steps
                                   for k, v in launches.items()},
                peak_memory_gib=peak / 2**30, first=steps[0], last=last,
                replay={"device_ms": sum(timed_ms) / timed,
                        "device_ms_min": min(timed_ms),
                        "device_ms_max": max(timed_ms),
                        "idle_share": max(1.0 - sum(timed_ms)
                                          / (timed_s * 1e3), 0.0),
                        "capture_seconds": g["capture_seconds"],
                        "nodes": g["nodes"], "by_kind": g["by_kind"],
                        "captured_at_step": g["step"]},
                ckpt=lines[saves[0]]["ckpt"], init=init), state


def replay_phase(cfg, dev, trained: dict, state) -> dict:
    """The train phase's run of cfg again from the same start, every step
    eager (train.loop.train(..., replay=False), no Config field or flag):
    each step's record (but its seconds) and the last checkpoint equal to
    the replayed run's, to the bit; both rates over the same timed
    window, beside the replay's device time, idle share, capture and
    peak memory. Then ``profile_step`` on the replayed run's state, after
    the eager run (its eager steps read slower after a torch.profiler
    session in this process; tools/replay_rates.py times both routes in
    fresh processes)."""
    from audiogan_tpu_torch.train.loop import train
    workdir = ROOT / "build" / f"chip_smoke_eager_{cfg.name}"
    shutil.rmtree(workdir, ignore_errors=True)
    lines = []
    n_steps, timed = trained["steps"], trained["timed_steps"]
    c = cfg.replace(train=dataclasses.replace(cfg.train, log_every=1))
    torch.cuda.reset_peak_memory_stats(dev)
    train(c, workdir, n_steps, device=dev, replay=False, tensorboard=False,
          log=lambda s: lines.append(json.loads(s)))
    peak = torch.cuda.max_memory_allocated(dev)
    init = [ln for ln in lines if "init" in ln][0]["init"]
    if init["steps"] != "eager: asked by the caller" or \
            any("graph" in ln for ln in lines):
        raise AssertionError(f"{cfg.name}: the eager run replayed: {init}")
    steps = [ln for ln in lines if "step" in ln]
    replayed = [json.loads(ln) for ln in (Path(trained["workdir"])
                                          / "metrics.jsonl").read_text()
                .splitlines()]
    eager = [json.loads(ln) for ln in (workdir / "metrics.jsonl")
             .read_text().splitlines()]

    def losses(recs):
        return [{k: v for k, v in r.items() if k != "seconds"
                 and "per_sec" not in k and k != "time"} for r in recs]
    if losses(replayed) != losses(eager):
        raise AssertionError(f"{cfg.name}: the replayed run's records "
                             f"differ from the eager run's")
    last = f"ckpt/{n_steps}.pt"
    tensors = same_checkpoint(Path(trained["workdir"]) / last,
                              workdir / last)
    timed_s = steps[-1]["seconds"] - steps[TRAIN_WARMUP - 1]["seconds"]
    eager_sps = timed / timed_s
    return dict(preset=cfg.name, fused_shuffle_sites=(
                    cfg.model.fused_shuffle_sites), steps=n_steps,
                timed_steps=timed, records_equal=len(eager),
                checkpoint_tensors_equal=tensors,
                replay_steps_per_s=trained["steps_per_s"],
                eager_steps_per_s=eager_sps,
                replay_over_eager=trained["steps_per_s"] / eager_sps,
                replay=trained["replay"],
                peak_memory_gib={"replay": trained["peak_memory_gib"],
                                 "eager": peak / 2**30},
                profile=profile_step(cfg, dev, state))


def host_batcher_phase(cfg, dev, trained: dict) -> dict:
    """One more step of train_phase's run through train.loop.train from
    its last checkpoint, twice: on the resident corpus and with
    data.device_corpus off (the host batcher, HostFeed's pinned copies).
    The step's metrics.jsonl record (but time and rates) and checkpoint
    must be equal to the bit."""
    from audiogan_tpu_torch.train.loop import train
    src = Path(trained["workdir"])
    last = trained["steps"]
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, log_every=1))
    runs = {}
    for name, on in (("resident", True), ("host", False)):
        wd = src.parent / f"{src.name}_{name}"
        shutil.rmtree(wd, ignore_errors=True)
        shutil.copytree(src, wd)
        c = cfg.replace(data=dataclasses.replace(cfg.data, device_corpus=on))
        t = time.time()
        train(c, wd, last + 1, device=dev, log=lambda _: None,
              tensorboard=False)
        runs[name] = (wd, time.time() - t)
    (ra, sa), (rb, sb) = runs["resident"], runs["host"]
    rec_a, rec_b = step_record(ra, last + 1), step_record(rb, last + 1)
    keys = sorted(k for k in rec_a if k != "time" and "per_sec" not in k)
    if any(rec_a[k] != rec_b.get(k) for k in keys):
        raise AssertionError(f"host batcher step differs: {rec_a} != "
                             f"{rec_b}")
    tensors = same_checkpoint(ra / f"ckpt/{last + 1}.pt",
                              rb / f"ckpt/{last + 1}.pt")
    return {"step": last + 1, "compared_keys": keys,
            "tensors_equal": tensors, "run_seconds": {"resident": sa,
                                                      "host": sb},
            "record": rec_b, "native_gather": native_gather(c, rb)}


def native_gather(cfg, workdir: Path, reps: int = 3) -> dict:
    """The host batcher's row gather of one step ([V, B] rows of the
    workdir's corpus) through the native library and through numpy's
    fancy index: the same bytes; each one's best of ``reps`` seconds."""
    from audiogan_tpu_torch.data import native
    from audiogan_tpu_torch.data.corpus import batch_indices
    from audiogan_tpu_torch.train.loop import resolve_corpus
    from audiogan_tpu_torch.train.step import num_views
    corpus = resolve_corpus(cfg, workdir)
    idx = batch_indices(len(corpus), cfg.train.batch_size, num_views(cfg),
                        cfg.train.seed, 0)
    times, out = {}, {}
    for name, fn in (("native", native.gather_rows),
                     ("numpy", native.gather_rows_plain)):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out[name] = fn(corpus.clips, idx)
            best = min(best, time.perf_counter() - t0)
        times[name] = best
    if out["native"].tobytes() != out["numpy"].tobytes():
        raise AssertionError("the native gather differs from numpy's")
    return {"shape": list(out["native"].shape),
            "bytes": out["native"].nbytes, "seconds": times}


def profile_step(cfg, dev, state) -> dict:
    """One more training step under torch.profiler: the device time of the
    step by kernel (device events only: an op's own entry repeats the time
    of the kernels it launched) and by span (span_device_ms), against the
    step's wall time, which the profiler itself lengthens."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from audiogan_tpu_torch.train.step import build_train_step, num_views
    step = build_train_step(cfg, dev)
    raw, labels = random_raw(cfg, num_views(cfg), cfg.train.batch_size, 12)
    raw, labels = raw.to(dev), labels.to(dev)
    torch.cuda.synchronize()
    with profiler_spans(), profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, raw, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.key_averages():
        # a span also shows as a device-side range around its kernels
        if e.device_type != DeviceType.CUDA or e.key in SPAN_NAMES:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": max(1.0 - device_ms / wall_ms, 0.0),
            "top": [{"name": k[:140], "ms": v, "share": v / device_ms}
                    for k, v in top],
            "by_span": span_device_ms(prof)}


# -- resume: `cli train` killed and resumed ------------------------------------

def cli_cmd(*args) -> list[str]:
    return [sys.executable, "-m", "audiogan_tpu_torch.cli",
            *map(str, args)]


def json_lines(text: str) -> list[dict]:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def run_cli(cmd: list[str]) -> tuple[list[dict], float]:
    """cmd to its end: its JSON lines and its seconds."""
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=CLI_TIMEOUT_S)
    if proc.returncode:
        raise RuntimeError(f"{' '.join(cmd[2:])} exited {proc.returncode}:"
                           f"\n{proc.stderr[-3000:]}")
    return json_lines(proc.stdout), time.time() - t0


def killed_run(cmd: list[str]) -> tuple[list[dict], float]:
    """cmd sent SIGKILL as soon as it logs its step-RESUME_KILL_AT
    checkpoint (the loop logs it after the file is in place, before the
    next step); fails if cmd ends by itself."""
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    out, killed = [], False
    try:
        for raw in proc.stdout:
            out.append(raw)
            if raw.startswith('{"ckpt"') and \
                    json.loads(raw)["ckpt"]["step"] == RESUME_KILL_AT:
                proc.send_signal(signal.SIGKILL)
                killed = True
                break
    finally:
        if proc.poll() is None and not killed:
            proc.kill()
        proc.wait(timeout=60)
        proc.stdout.close()
    if not killed or proc.returncode != -signal.SIGKILL:
        raise AssertionError(f"the run was not killed after its step-"
                             f"{RESUME_KILL_AT} checkpoint (exit "
                             f"{proc.returncode}):\n{''.join(out)[-3000:]}")
    return json_lines("".join(out)), time.time() - t0


def step_record(workdir: Path, step: int) -> dict:
    recs = [json.loads(ln) for ln in
            (workdir / "metrics.jsonl").read_text().splitlines()]
    return [r for r in recs if r["step"] == step][-1]


def resume_case(preset: str, sets: tuple, base: Path) -> dict:
    """(a) uninterrupted to RESUME_STEPS; (b) killed after its
    RESUME_KILL_AT checkpoint, then run again: the same step record
    (but time and rates) and the same last checkpoint, to the bit."""
    tag = preset + "".join("_" + s.split("=")[0].split(".")[-1]
                           for s in sets)
    runs = {k: base / f"{tag}_{k}" for k in ("a", "b")}

    def train(workdir):
        cmd = cli_cmd("train", "--preset", preset, "--total_steps",
                      RESUME_STEPS, "--set",
                      f"train.ckpt_every={RESUME_KILL_AT}", "--set",
                      "train.log_every=1", "--no_tensorboard",
                      "--workdir", workdir)
        for item in sets:
            cmd += ["--set", item]
        return cmd
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        fa = pool.submit(run_cli, train(runs["a"]))
        fb = pool.submit(killed_run, train(runs["b"]))
        (a_lines, a_s), (k_lines, k_s) = fa.result(), fb.result()
    left = sorted(int(q.stem) for q in (runs["b"] / "ckpt").glob("*.pt"))
    if left != [RESUME_KILL_AT]:
        raise AssertionError(f"{tag}: the killed run left {left}")
    r_lines, r_s = run_cli(train(runs["b"]))
    restored = [ln["resume"]["step"] for ln in r_lines if "resume" in ln]
    if restored != [RESUME_KILL_AT]:
        raise AssertionError(f"{tag}: the second run restored {restored}")
    routes = {ln["init"]["steps"] for ln in a_lines + r_lines
              if "init" in ln}
    if routes != {"replay"}:
        raise AssertionError(f"{tag}: the runs did not replay: {routes}")
    ra, rb = (step_record(runs[k], RESUME_STEPS) for k in ("a", "b"))
    keys = sorted(k for k in ra if k != "time" and "per_sec" not in k)
    if keys != sorted(k for k in rb if k != "time" and "per_sec" not in k) \
            or any(ra[k] != rb[k] for k in keys):
        raise AssertionError(f"{tag}: step {RESUME_STEPS} differs after "
                             f"the resume: {ra} != {rb}")
    last = f"ckpt/{RESUME_STEPS}.pt"
    tensors = same_checkpoint(runs["a"] / last, runs["b"] / last)
    return {"preset": preset, "sets": list(sets), "workdir": runs["b"],
            "seconds": {"uninterrupted": a_s, "killed": k_s,
                        "resumed": r_s},
            "restored_step": restored[0],
            "ckpts": {"uninterrupted": [ln["ckpt"] for ln in a_lines
                                        if "ckpt" in ln],
                      "killed": [ln["ckpt"] for ln in k_lines
                                 if "ckpt" in ln],
                      "resumed": [ln["ckpt"] for ln in r_lines
                                  if "ckpt" in ln]},
            "compared_keys": keys, "tensors_equal": tensors,
            "w_dist": rb["w_dist"],
            # the asynchronous save (utils/checkpoint.py::AsyncSaver): the
            # seconds each save blocked the loop and the worker's write
            "save_seconds": {k: [ln["ckpt"][k] for ln in a_lines
                                 if "ckpt" in ln]
                             for k in ("blocked", "write")}}


def sample_twice(cfg, workdir: Path) -> dict:
    """`cli sample --workdir --seed 0` twice: the same bytes."""
    outs = [workdir / f"generated_{i}" for i in (0, 1)]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        secs = [s for _, s in pool.map(run_cli, [
            cli_cmd("sample", "--workdir", workdir, "--seed", 0,
                    "--out_dir", out) for out in outs])]
    names = sorted(q.name for q in outs[0].glob("*.wav"))
    if not names or names != sorted(q.name for q in outs[1].glob("*.wav")):
        raise AssertionError(f"sample wrote {names}")
    for name in names:
        if (outs[0] / name).read_bytes() != (outs[1] / name).read_bytes():
            raise AssertionError(f"sample --seed 0 twice: {name} differs")
        with wave.open(str(outs[0] / name)) as f:
            if (f.getframerate(), f.getnframes()) != (
                    cfg.data.sample_rate, cfg.data.clip_len):
                raise AssertionError(f"{name}: {f.getframerate()} Hz, "
                                     f"{f.getnframes()} frames")
    return {"files": len(names), "seconds": secs}


def serve_workdir(cfg, workdir: Path) -> dict:
    """`cli serve --workdir` answers one /generate with WAVs of the
    preset's rate and length."""
    t0 = time.time()
    proc = subprocess.Popen(cli_cmd("serve", "--workdir", workdir,
                                    "--port", 0, "--num", SMALL),
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        # the card's sampler replays one captured CUDA graph per request
        if not line.startswith("[serve] ") or \
                not line.rstrip().endswith(", replay)"):
            raise AssertionError(f"serve --workdir: {line}"
                                 f"{proc.stdout.read()[-3000:]}")
        url = line.split(" on ", 1)[1].split()[0]
        body = {"seed": 1, "num": 2}
        if cfg.data.num_classes:
            body["labels"] = [3, 7]
        code, out = http_json(f"{url}/generate", body)
        if code != 200 or len(out["wavs"]) != 2:
            raise AssertionError(f"/generate: {code} {str(out)[:300]}")
        for b64 in out["wavs"]:
            rate, pcm = decode_wav(b64)
            if (rate, pcm.size) != (cfg.data.sample_rate, cfg.data.clip_len):
                raise AssertionError(f"served {rate} Hz, {pcm.size} "
                                     f"samples")
        return {"seconds": time.time() - t0, "url": url}
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)
        proc.stdout.close()


def eval_twice(workdir: Path) -> dict:
    """`cli eval --workdir` twice: the same JSON line, every value
    finite."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = list(pool.map(run_cli, [cli_cmd("eval", "--workdir",
                                                workdir)] * 2))
    (a, a_s), (b, b_s) = runs
    if len(a) != 1 or a != b:
        raise AssertionError(f"eval twice: {a} != {b}")
    bad = [k for k, v in a[0].items() if not np.isfinite(v)]
    if bad or a[0]["step"] != RESUME_STEPS:
        raise AssertionError(f"eval: non-finite {bad} or step: {a[0]}")
    return {"metrics": a[0], "seconds": [a_s, b_s]}


def resume_phase() -> dict:
    """Each of RESUME_RUNS killed and resumed (all started together), then
    `cli sample` and `cli serve` on SERVE_RUNS' killed-and-resumed
    workdirs, and `cli eval` on EVAL_PRESETS'."""
    from audiogan_tpu_torch.config import Config
    base = ROOT / "build" / "chip_smoke_resume"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    with concurrent.futures.ThreadPoolExecutor(len(RESUME_RUNS)) as pool:
        cases = list(pool.map(lambda r: resume_case(*r, base), RESUME_RUNS))
    plain = [c for c in cases if c["preset"] in SERVE_RUNS
             and not any(s.startswith("model.") for s in c["sets"])]
    cfgs = [Config.from_json((c["workdir"] / "config.json").read_text())
            for c in plain]
    with concurrent.futures.ThreadPoolExecutor(3 * len(plain)) as pool:
        samples = [pool.submit(sample_twice, cfg, c["workdir"])
                   for cfg, c in zip(cfgs, plain)]
        served = [pool.submit(serve_workdir, cfg, c["workdir"])
                  for cfg, c in zip(cfgs, plain)]
        evals = {c["preset"]: pool.submit(eval_twice, c["workdir"])
                 for c in plain if c["preset"] in EVAL_PRESETS}
        for c, fs, fv in zip(plain, samples, served):
            c["sample"], c["serve"] = fs.result(), fv.result()
            if c["preset"] in evals:
                c["eval"] = evals[c["preset"]].result()
    for c in cases:
        c["workdir"] = str(c["workdir"].relative_to(ROOT))
    return {"steps": RESUME_STEPS, "killed_after": RESUME_KILL_AT,
            "cases": cases}


# -- graph and trace: the loop's tracing options -------------------------------

# the kernel counters' names -> the kernel hook's (kernels/hooks.py)
HOOK_NAMES = {k.counter: hooks.label(w) for w, k in hooks.KERNELS.items()}


def graph_phase(cfg, dev, want: dict, tag: str) -> dict:
    """train.loop.train with train.dump_hlo on and no step to run: the
    step the loop runs first (the resident corpus, data.index_chunk at its
    default) captured as one CUDA graph, replayed once from the pre-step
    state and held to the eager step from the same state and draws to the
    bit (train/step_graph.py). Each port kernel's kernel nodes must equal
    its calls during the capture, and ``want`` (the launches the step's
    structure gives)."""
    from audiogan_tpu_torch.train.loop import train
    from audiogan_tpu_torch.train.step_graph import DOT_FILE, read_summary
    workdir = ROOT / "build" / f"chip_smoke_graph_{tag}"
    shutil.rmtree(workdir, ignore_errors=True)
    c = cfg.replace(train=dataclasses.replace(cfg.train, dump_hlo=True))
    t0 = time.time()
    train(c, workdir, 0, device=dev, log=lambda _: None, tensorboard=False)
    seconds = time.time() - t0
    s = read_summary(workdir)
    if not s["replay_equals_eager"]:
        raise AssertionError(f"{tag}: the replay differs from the eager "
                             f"step in {s['replay_differs_in']}")
    port = s["port_kernels"]
    for name, rec in port.items():
        if rec["kernel_nodes"] != rec["calls"]:
            raise AssertionError(f"{tag}: {name} made {rec['kernel_nodes']}"
                                 f" kernel nodes in {rec['calls']} calls")
    for key, n in want.items():
        got = port.get(HOOK_NAMES[key], {}).get("kernel_nodes", 0)
        if got != n:
            raise AssertionError(f"{tag}: {HOOK_NAMES[key]} has {got} "
                                 f"kernel nodes in the graph, want {n}")
    torch.cuda.empty_cache()
    return {"preset": cfg.name, "tag": tag, "nodes": s["nodes"],
            "by_kind": s["by_kind"], "port_kernels": port,
            "capture_seconds": s["capture_seconds"],
            "dump_seconds": seconds,
            "tensors_compared": s["tensors_compared"],
            "replay_equals_eager": True,
            "inputs_copied_to_device": s["inputs_copied_to_device"],
            "dot_bytes": (workdir / DOT_FILE).stat().st_size}


def graph_phases(cfg, fcfg, gcfg, dcfg, mcfg, rcfg, dev) -> dict:
    """graph_phase for each preset, the fused flagship and music at dp=1:
    K1' and K1 held to the step's structure (conv_step_launches; the GRU
    G's to its calls), K6 and K7 to fused_step_launches, K4 6 and K5 1,
    K2 one per real view (none for resample_22k)."""
    from audiogan_tpu_torch.train.step import num_views

    def convs(c):
        n = conv_step_launches(c)
        return {"conv1d": n["conv1d"], "convt1d": n["convt1d"]}
    k6, k7 = fused_step_launches(fcfg)
    runs = [(cfg, {**convs(cfg), "ingest": num_views(cfg)}, cfg.name),
            (fcfg, {**convs(fcfg), "sconv1d": k6, "sconvt1d": k7,
                    "ingest": num_views(fcfg)}, cfg.name + "_fused"),
            (gcfg, {"gru_scan": 1 + gcfg.loss.n_critic, "gru_scan_bwd": 1,
                    "ingest": num_views(gcfg)}, gcfg.name),
            (dcfg, {**convs(dcfg), "ingest": num_views(dcfg)}, dcfg.name),
            (mcfg, {**convs(mcfg), "ingest": num_views(mcfg)}, mcfg.name),
            (rcfg, {**convs(rcfg), "ingest": 0}, rcfg.name)]
    return {"presets": [graph_phase(c, dev, want, tag)
                        for c, want, tag in runs]}


TRACE_WINDOW = (2, 4)        # train.profile_steps of the trace phase


def trace_cmd(workdir: Path, steps: int, *sets) -> list[str]:
    cmd = cli_cmd("train", "--preset", "wgan_gp_b64", "--total_steps",
                  steps, "--set", f"train.ckpt_every={RESUME_KILL_AT}",
                  "--set", "train.log_every=1", "--no_tensorboard",
                  "--workdir", workdir)
    for item in sets:
        cmd += ["--set", item]
    return cmd


def read_trace(path: Path, cfg) -> dict:
    """The profiled run's trace: its steps' ranges, the model parts' spans
    (host ranges) and the K1/K1' kernel events; each held to the window's
    two steps."""
    events = json.loads(path.read_text())["traceEvents"]
    host = Counter(e["name"] for e in events
                   if e.get("cat") == "user_annotation")
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    k1 = {f for w in ("conv1d_ba", "conv_transpose1d_ba")
          for f in hooks.KERNELS[w].functions}
    conv = sum(any(f in k for f in k1) for k in kernels)
    steps = sorted(k for k in host if k.startswith("train_step "))
    window = [f"train_step {s}" for s in range(*TRACE_WINDOW)]
    views = 1 if cfg.train.fused_d_views else 2
    n = cfg.loss.n_critic
    per_step = {"wave_critic": n * (views + cfg.loss.gp_batch_chunks) + 1,
                "generator": n + 1}
    launches = conv_step_launches(cfg)
    want_conv = (launches["conv1d"] + launches["convt1d"]) * len(window)
    if steps != window or any(host[k] != v * len(window)
                              for k, v in per_step.items()) \
            or conv != want_conv:
        raise AssertionError(f"trace: steps {steps} (want {window}), spans "
                             f"{dict(host)} (want {per_step} per step), "
                             f"{conv} K1/K1' kernel events (want "
                             f"{want_conv})")
    return {"steps": steps, "spans": {k: host[k] for k in per_step},
            "kernel_events": len(kernels), "k1_k1prime_events": conv,
            "bytes": path.stat().st_size}


def poisoned_run(cfg, base: Path) -> dict:
    """A fresh flagship state with one NaN in the critic's conv_0 kernel,
    saved as the step-0 checkpoint of a workdir, then `cli train
    --total_steps 1` with debug_nans resumed from it: it must raise
    FloatingPointError naming K1' in the wave critic, forward."""
    from audiogan_tpu_torch.train.state import create_train_state
    from audiogan_tpu_torch.utils import checkpoint as ckpt_lib
    workdir = base / "poisoned"
    state = create_train_state(cfg, device="cpu")
    with torch.no_grad():
        state.d.conv_0_kernel[0, 0, 0] = float("nan")
    ckpt_lib.save(ckpt_lib.make_manager(workdir, config=cfg), state)
    t0 = time.time()
    proc = subprocess.run(trace_cmd(workdir, 1, "train.debug_nans=true"),
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=CLI_TIMEOUT_S)
    err = [ln for ln in proc.stderr.splitlines()
           if ln.startswith("FloatingPointError")]
    if proc.returncode == 0 or not err or "K1' conv1d_ba" not in err[-1] \
            or "wave_critic, forward" not in err[-1] \
            or "D.conv_0_kernel" not in err[-1]:
        raise AssertionError(f"the poisoned run: exit {proc.returncode}, "
                             f"{proc.stderr[-3000:]}")
    return {"error": err[-1], "seconds": time.time() - t0}


def trace_phase(cfg, dev) -> dict:
    """The flagship's `cli train` for RESUME_STEPS steps three ways at
    once: plain, with train.profile_dir (profile_steps TRACE_WINDOW) and
    with train.debug_nans; the trace holds the window's steps, spans and
    K1/K1' kernels, and all three end in the same checkpoint to the bit.
    Beside them ``poisoned_run``. Last, one healthy flagship step under
    the check mode (train/debug_nans.py): no op may make a NaN."""
    from audiogan_tpu_torch.train.debug_nans import nan_check
    from audiogan_tpu_torch.train.state import create_train_state
    from audiogan_tpu_torch.train.step import build_train_step, num_views
    base = ROOT / "build" / "chip_smoke_trace"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    runs = {"plain": (), "profiled": (
        f"train.profile_dir={base / 'trace'}",
        f"train.profile_steps=[{TRACE_WINDOW[0]},{TRACE_WINDOW[1]}]"),
        "debug_nans": ("train.debug_nans=true",)}
    with concurrent.futures.ThreadPoolExecutor(len(runs) + 1) as pool:
        poisoned = pool.submit(poisoned_run, cfg, base)
        done = dict(zip(runs, pool.map(
            lambda kv: run_cli(trace_cmd(base / kv[0], RESUME_STEPS,
                                         *kv[1])), runs.items())))
        poisoned = poisoned.result()
    last = f"ckpt/{RESUME_STEPS}.pt"
    equal = {k: same_checkpoint(base / "plain" / last, base / k / last)
             for k in ("profiled", "debug_nans")}
    trace = read_trace(base / "trace" / "trace_rank0.json", cfg)
    state = create_train_state(cfg, device=dev)
    step = build_train_step(cfg, dev)
    raw, labels = random_raw(cfg, num_views(cfg), cfg.train.batch_size, 12)
    check = nan_check(state)
    t0 = time.time()
    with torch.autograd.set_detect_anomaly(True, check_nan=False), check:
        step(state, raw.to(dev), labels.to(dev))
    if check.first is not None:
        raise AssertionError(f"a healthy step made a NaN: {check.first}")
    return {"run_seconds": {k: v[1] for k, v in done.items()},
            "checkpoints_equal_plain": equal, "trace": trace,
            "poisoned": poisoned,
            "healthy_step_under_check_s": time.time() - t0}


# -- bench: `cli bench` ---------------------------------------------------------

def bench_run(card: str, *args) -> tuple[list[dict], list[dict], float]:
    """`cli bench` with ``args`` to its end: its stdout lines (every one a
    JSON line with exactly the reference's keys but the proxy fields and
    the card's name), its stderr summaries and its seconds."""
    t0 = time.time()
    proc = subprocess.run(cli_cmd("bench", *args), cwd=ROOT,
                          capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    if proc.returncode:
        raise RuntimeError(f"cli bench {' '.join(map(str, args))} exited "
                           f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()]
    for line in lines:
        if set(line) != BENCH_LINE_KEYS or not line["value"] > 0 or \
                not line["audio_sec_per_sec"] > 0 or line["device"] != card \
                or {line[k] for k in ("kernels", "kernels_g",
                                      "kernels_d")} != {"cuda"}:
            raise AssertionError(f"cli bench line: {line}")
    summaries = [json.loads(ln) for ln in proc.stderr.splitlines()
                 if ln.startswith('{"bench"')]
    return lines, summaries, time.time() - t0


def bench_sampler_clips(preset: str, dev) -> dict:
    """The bench's replayed sampler of ``preset`` at its
    default_sample_num: its first and last BENCH_CLIPS clips for seed 1
    against the port on the CPU (the plain forms) on the same z and labels,
    under the serve phase's tolerance of the compute dtype; the capture,
    its pool and the peak memory."""
    from audiogan_tpu_torch import bench
    from audiogan_tpu_torch.train.sample import generate
    cfg = bench.bench_config(preset)
    num = bench.default_sample_num(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = bench.generator_params(cfg, dev)
    labels = bench.sample_labels(cfg, num)
    sampler = bench.BenchSampler(cfg, params, num, dev, labels)
    rows = np.r_[0:BENCH_CLIPS, num - BENCH_CLIPS:num]
    with torch.cuda.stream(sampler.graph.stream):
        out = sampler(1)[rows].cpu()
        z = sampler.graph.inputs["z"][rows].cpu()
    peak = torch.cuda.max_memory_allocated()
    summary = sampler.summary()
    del sampler
    ref = generate(cfg, {k: v.cpu() for k, v in params.items()},
                   len(rows), 1, None if labels is None else labels[rows],
                   device="cpu", z=z)
    tol = SERVE_BF16_REL_TOL if cfg.train.dtype == "bfloat16" \
        else F32_REL_TOL
    got = out.numpy()
    err = float(np.abs(got - ref).max())
    peak_ref = float(np.abs(ref).max())
    if got.shape != (len(rows), cfg.data.clip_len) or \
            not np.isfinite(got).all() or not err <= tol * peak_ref:
        raise AssertionError(f"{preset}: the bench sampler at {num} vs the "
                             f"CPU: {got.shape}, {err} > {tol} * {peak_ref}")
    if dev.type == "cuda" and summary["route"] != "replay":
        raise AssertionError(f"{preset}: the bench sampler runs "
                             f"{summary['route']}")
    return {"sample_batch": num, "clips_checked": len(rows),
            "max_abs_err": err, "max_abs_ref": peak_ref, "tol_rel": tol,
            **{k: summary.get(k) for k in ("route", "capture_seconds",
                                           "nodes", "pool_bytes",
                                           "port_kernels")},
            "peak_memory_bytes": peak}


def bench_steps_bits(dev) -> dict:
    """Three bench steps of the flagship (eager, captured and replayed,
    replayed) on the staged clips against three eager steps from a fresh
    state of the same seed on the same clips: parameters, both Adams'
    moments and the last metrics to the bit."""
    from audiogan_tpu_torch import bench
    from audiogan_tpu_torch.train.state import (create_train_state,
                                                state_tensors)
    from audiogan_tpu_torch.train.step import build_train_step
    from audiogan_tpu_torch.train.step_graph import StepGraph, differing
    cfg = bench.bench_config("wgan_gp_b64")
    staged = bench.StagedStep(cfg, dev)
    for _ in range(BENCH_STEPS):
        got = staged()
    got = {k: v.clone() for k, v in got.items()}
    state = create_train_state(cfg, device=dev)
    eager = StepGraph(cfg, build_train_step(cfg, dev), dev, resident=(0, 1))
    for _ in range(BENCH_STEPS):
        eager.fill(state, staged.inputs)
        want = eager.eager(state)
    torch.cuda.synchronize()
    differ = differing({**state_tensors(staged.state), **got},
                       {**state_tensors(state), **want})
    if differ or staged.graph.replays != BENCH_STEPS - 1:
        raise AssertionError(f"the bench's replayed steps differ from the "
                             f"eager ones in {differ[:10]} "
                             f"({staged.graph.replays} replays)")
    return {"steps": BENCH_STEPS, "replays": staged.graph.replays,
            "tensors_equal": len(want) + len(state_tensors(state)),
            **staged.summary()}


def bench_phase(card: str, dev) -> dict:
    """Phase 6h (the module docstring): `cli bench` and its checks."""
    from audiogan_tpu_torch import bench
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    t0 = time.time()
    (flagship,), summ, secs = bench_run(card, "--preset", "wgan_gp_b64")
    if flagship["preset"] != "wgan_gp_b64" or \
            flagship["sample_batch"] != 4096:
        raise AssertionError(f"cli bench: {flagship}")
    out["flagship"] = {"line": flagship, "summary": summ[0],
                       "seconds": secs}
    lines, summ, secs = bench_run(card, "--preset", "all", "--steps", 2)
    if [ln["preset"] for ln in lines] != list(bench.PRESETS):
        raise AssertionError(f"cli bench --preset all: {lines}")
    out["all_steps_2"] = {"lines": lines, "summaries": summ,
                          "seconds": secs}
    # the in-process part, the launch counts zeroed just before it
    hooks.add_launches({k: -v for k, v in hooks.launch_counts().items()})
    t1 = time.time()
    out["steps_bits"] = bench_steps_bits(dev)
    out["samplers"] = {p: bench_sampler_clips(p, dev) for p in bench.PRESETS}
    launches = {w: n for (w, attr), n in hooks.launch_counts().items()
                if attr == "launches" and n}
    need = ("conv_transpose1d_ba", "conv1d_ba", "ingest_fused",
            "adam_update", "gru_scan_fwd")
    if any(not launches.get(w) for w in need):
        raise AssertionError(f"the bench path launched {launches}, want "
                             f"every one of {need}")
    out["in_process_seconds"] = time.time() - t1
    out["launches"] = launches
    out["seconds"] = time.time() - t0
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- timing ---------------------------------------------------------------------

def dp_phase(cfg, dcfg, dev) -> dict:
    """Phase 6c (the module docstring): two ranks over gloo on this card."""
    from audiogan_tpu_torch.config import MeshCfg
    from audiogan_tpu_torch.tools import dp_check
    from audiogan_tpu_torch.train.step import num_views

    def on(c, dp, fsdp=False, **train):
        return c.replace(mesh=MeshCfg(dp=dp, fsdp=fsdp),
                         train=dataclasses.replace(c.train, **train))

    def batches(c, seed):
        return [random_raw(c, num_views(c), c.train.batch_size,
                           seed + s) for s in range(DP_STEPS)]
    f32 = {c.name: on(c, 1, dtype="float32", batch_size=DP_F32_BATCH)
           for c in (cfg, dcfg)}
    f32_batches = {name: batches(c, 40) for name, c in f32.items()}
    t_ref = time.time()
    # from a state after one warm step (Adam's second moment non-zero, the
    # update smooth in the gradient, as parity_phase starts), the dp=1
    # steps on this card, in this process; the bf16 steps start there too
    warm = {name: dp_check.steps_job(dev, c.to_json(), batches(c, 30)[:1])
            for name, c in f32.items()}
    want = {name: dp_check.steps_job(dev, c.to_json(), f32_batches[name],
                                     state=warm[name])
            for name, c in f32.items()}
    t_ref = time.time() - t_ref
    bf = on(cfg, DP_RANKS)
    bf_batches = batches(bf, 50)
    # the bf16 steps at dp=1 on the same batches from the same warm state,
    # and the same steps in f32
    want_bf = dp_check.steps_job(dev, on(cfg, 1).to_json(), bf_batches,
                                 state=warm[cfg.name])
    exact_bf = dp_check.steps_job(dev, on(cfg, 1, dtype="float32").to_json(),
                                  bf_batches, state=warm[cfg.name])
    base = ROOT / "build" / "chip_smoke_dp"
    shutil.rmtree(base, ignore_errors=True)
    jobs = [{"name": name, "fn": "steps",
             "kw": {"cfg_json": on(c, DP_RANKS).to_json(),
                    "batches": f32_batches[name], "state": warm[name]}}
            for name, c in f32.items()]
    for name, fsdp in (("bf16_a", False), ("bf16_b", False),
                       ("bf16_fsdp", True)):
        jobs.append({"name": name, "fn": "steps", "kw": {
            "cfg_json": on(cfg, DP_RANKS, fsdp).to_json(),
            "batches": bf_batches, "state": warm[cfg.name]}})
    for mode in ("replicate", "shard"):
        c = on(bf, DP_RANKS, log_every=1).replace(data=dataclasses.replace(
            bf.data, device_corpus=True, device_corpus_shard=mode))
        jobs.append({"name": mode, "fn": "train", "kw": {
            "cfg_json": c.to_json(), "workdir": str(base / mode),
            "steps": DP_STEPS}})
    t_run = time.time()
    res = dp_check.spawn(DP_RANKS, jobs, base / "out", device=str(dev),
                         backend="gloo", timeout_s=DP_TIMEOUT_S)
    t_run = time.time() - t_run
    report = {name: compare_blobs(res[name][0], want[name],
                                  PARITY_REL_TOL, PARITY_PARAM_TOL)
              for name in f32}
    for name in f32:
        report[name]["seconds"] = {"dp2": res[name][0]["seconds"],
                                   "dp1": want[name]["seconds"]}
    report["bf16"] = hold_bf16_to_dp1(res["bf16_a"][0], want_bf, exact_bf)
    report["bf16"]["seconds"] = {"dp2": res["bf16_a"][0]["seconds"],
                                 "dp1": want_bf["seconds"]}
    if "stft_loss" not in res[dcfg.name][0]["metrics"][-1]:
        raise AssertionError("dual_stft at dp=2: no stft_loss")
    tensors = {}
    for name in ("bf16_a", "bf16_b", "bf16_fsdp", "replicate", "shard"):
        r0, r1 = res[name]
        tensors[name + " ranks"] = same_bits(
            state_parts(r0), state_parts(r1))
    for name in ("bf16_b", "bf16_fsdp"):
        if res[name][0]["metrics"] != res["bf16_a"][0]["metrics"]:
            raise AssertionError(f"dp {name}: metrics differ from bf16_a")
        tensors[name + " vs bf16_a"] = same_bits(
            state_parts(res[name][0]), state_parts(res["bf16_a"][0]))
    rows = res["bf16_fsdp"][1]["moment_rows"]
    if not any(kept * DP_RANKS == n for kept, n in rows.values()):
        raise AssertionError(f"ZeRO-1 kept whole moments: {rows}")
    lines = {m: [ln for ln in res[m][0]["lines"] if "step" in ln]
             for m in ("replicate", "shard")}
    strip = [[{k: v for k, v in ln.items() if k != "seconds"} for ln in ls]
             for ls in lines.values()]
    if len(strip[0]) != DP_STEPS or strip[0] != strip[1]:
        raise AssertionError(f"sharded corpus differs: {lines}")
    tensors["shard vs replicate"] = same_bits(
        state_parts(res["shard"][0]), state_parts(res["replicate"][0]))
    corpus = [ln["init"]["corpus"] for m in ("replicate", "shard")
              for ln in res[m][0]["lines"] if "init" in ln]
    if corpus != ["replicate", "shard"]:
        raise AssertionError(f"corpus placements {corpus}")
    per_rank = hold_launches(
        [r["launches"] for r in res["bf16_a"]],
        {**conv_step_launches(bf), "ingest": num_views(bf)}, DP_STEPS, "dp")
    return dict(ranks=DP_RANKS, backend="gloo", f32_batch=DP_F32_BATCH,
                bf16_batch=bf.train.batch_size, steps=DP_STEPS,
                parity=report, tensors_equal=tensors,
                launches_per_rank_step=per_rank,
                bf16_seconds=[r["seconds"] for r in res["bf16_a"]],
                zero1_moment_rows=rows, dp1_seconds=t_ref,
                spawn_seconds=t_run)


def axis_phase(axis: str, cases: list, dev) -> dict:
    """Phases 6d and 6e (the module docstring): two ranks over gloo on
    this card at cp=2 (each one half of every clip's time axis) or tp=2
    (each half of the critic's channels). ``cases``: (config, batch
    seeds, seeds whose two steps are held, plain comparisons held) per
    preset, through dp_check.parity_job."""
    from audiogan_tpu_torch.config import MeshCfg
    from audiogan_tpu_torch.tools import dp_check
    from audiogan_tpu_torch.train.step import num_views
    structure = {"cp": cp_step_launches, "tp": tp_step_launches}[axis]

    def on(c, n):
        return c.replace(
            mesh=MeshCfg(**{axis: n}),
            model=dataclasses.replace(c.model, phase_shuffle=0),
            train=dataclasses.replace(c.train, dtype="float32",
                                      batch_size=AXIS_BATCH))
    base = ROOT / "build" / f"chip_smoke_{axis}"
    shutil.rmtree(base, ignore_errors=True)
    jobs = [{"name": c.name, "fn": "parity", "kw": {
        "cfg_json": on(c, AXIS_RANKS).to_json(), "axis": axis,
        "work": str(base / c.name), "seeds": seeds, "held_seeds": held,
        "plain_held": plain_held}} for c, seeds, held, plain_held in cases]
    res = dp_check.spawn(AXIS_RANKS, jobs, base / "out", device=str(dev),
                         backend="gloo", timeout_s=DP_TIMEOUT_S)
    report, per_rank, failed = {}, {}, []
    for c, *_ in cases:
        ranks = res[c.name]
        n = ranks[0]["steps"]
        report[c.name] = ranks[0]["report"]
        failed += [f"{c.name} {f}" for f in report[c.name]["failed"]]
        per_rank[c.name] = hold_launches(
            [r["launches"] for r in ranks],
            {**structure(on(c, 1)), "ingest": num_views(c)}, n,
            f"{axis} {c.name}")
        if axis == "cp":
            report[c.name]["routes_per_rank_step"] = {
                k: v // n for k, v in ranks[0]["routes"].items()}
    if failed:
        raise AssertionError(f"{axis}={AXIS_RANKS} parity: {failed}: "
                             f"{json.dumps(report)}")
    return dict(ranks=AXIS_RANKS, backend="gloo", batch=AXIS_BATCH,
                dtype="float32", parity=report,
                launches_per_rank_step=per_rank, last_metrics={
                    name: r[0]["last"] for name, r in res.items()})


def tc_tile_times(family: str, L: dict, x, w, b) -> dict:
    """The tensor-core kernel at each of its tiles (kernels/conv.py
    TC_TILES), launched with that tile's plan: the measured alternatives
    to the tile the wrapper picks. Not counted launches."""
    from audiogan_tpu_torch.kernels import conv as kconv
    out = {}
    for tile, (nwg, bn) in enumerate(kconv.TC_TILES):
        if family == "conv1d":
            plan = kconv.conv1d_tc_plan(L["b"], L["t_in"], L["cout"], L["k"],
                                        L["s"], L["lo"], L["hi"], tile)
            y = torch.empty(L["b"], (L["t_in"] + L["lo"] + L["hi"] - L["k"])
                            // L["s"] + 1, L["cout"], dtype=x.dtype,
                            device=x.device)
            call = lambda: kconv._conv1d_tc(x, w, b, y, L["s"], plan,
                                            L["act"], 0.2)
        else:
            plan = kconv.convt_tc_plan(L["b"], L["cout"], L["k"], L["s"],
                                       L["pad_lo"], L["out_len"], tile)
            y = torch.empty(L["b"], L["out_len"], L["cout"], dtype=x.dtype,
                            device=x.device)
            call = lambda: kconv._convt_tc(x, w, b, y, plan, L["act"], 0.2)
        out[f"{64 * nwg}x{bn}"] = cuda_ms(call)
    return out


def cc_plan_of(family: str, L: dict, dtype, tile=None):
    """The CUDA-core plan the wrapper runs at geometry L (or at `tile`)."""
    from audiogan_tpu_torch.kernels import conv as kconv
    if family == "conv1d":
        return kconv.conv1d_cc_plan(dtype, L["b"], L["t_in"], L["cin"],
                                    L["cout"], L["k"], L["s"], L["lo"],
                                    L["hi"], tile)
    return kconv.convt_cc_plan(dtype, L["b"], L["t_in"], L["cin"], L["cout"],
                               L["k"], L["s"], L["pad_lo"], L["out_len"],
                               tile)


def cc_tile_name(plan) -> str:
    """kind and tile of a CUDA-core plan: gemm TM x TN, thin_cout's
    threads (4 rows m each) and NP, thin_cin's rows."""
    from audiogan_tpu_torch.kernels import conv as kconv
    kind, tile = int(plan[0]), int(plan[1])
    if kind == kconv.CC_GEMM:
        tm, tn = kconv.CC_TILES[tile]
        return f"gemm {tm}x{tn} ck{int(plan[2])}"
    if kind == kconv.CC_THIN_COUT:
        return (f"thin_cout {4 * kconv.CC_THIN_COUT_THREADS[tile]} rows "
                f"np{int(plan[2])}")
    return f"thin_cin {kconv.CC_THIN_CIN_ROWS[tile]} rows"


def cc_tile_times(family: str, L: dict, x, w, b) -> dict:
    """The CUDA-core kernel at each candidate tile of its kind
    (kernels/conv.py::cc_tiles), launched with that tile's plan: the
    measured alternatives to the tile the wrapper picks. Not counted
    launches."""
    from audiogan_tpu_torch.kernels import conv as kconv
    lib = kconv._conv1d_lib() if family == "conv1d" else kconv._kernel_lib()
    out_len = (kconv.conv1d_t_out(L["t_in"], L["k"], L["s"], L["lo"],
                                  L["hi"]) if family == "conv1d"
               else L["out_len"])
    y = torch.empty(L["b"], out_len, L["cout"], dtype=x.dtype,
                    device=x.device)
    kind = int(cc_plan_of(family, L, x.dtype)[0])
    out = {}
    for tile in kconv.cc_tiles(kind, L["cout"]):
        plan = cc_plan_of(family, L, x.dtype, tile)
        out[cc_tile_name(plan)] = cuda_ms(
            lambda: kconv._cc_launch(lib, family, x, w, b, y, plan, L["act"],
                                     0.2))
    return out


def time_conv(family: str, layers: list[dict], dev, errs: dict,
              dtype=torch.bfloat16) -> list:
    """Each geometry in dtype (bf16; f32 where the path computes in it:
    the cp step), its bound at that dtype's peak rate."""
    from audiogan_tpu_torch.kernels import conv as kconv
    kname, pname, args_of, work, library = FAMILIES[family]
    kernel, plain = getattr(kconv, kname), getattr(kconv, pname)
    f32 = dtype == torch.float32
    rows = []
    for i, L in enumerate(layers):
        x, w, b = conv_inputs(L, dtype, dev, seed=i)
        args = args_of(L)
        flops, nbytes = work(L, 4 if f32 else 2)
        bound_ms, bound_by = bound(flops, nbytes, PEAK_F32_FLOPS if f32
                                   else PEAK_BF16_FLOPS)
        ms = cuda_ms(lambda: kernel(x, w, b, *args))
        tc = tensor_core(family, L, dtype)
        extra = {}
        if tc:
            if family == "conv1d":
                plan = kconv.conv1d_tc_plan(L["b"], L["t_in"], L["cout"],
                                            L["k"], L["s"], L["lo"], L["hi"])
            else:
                plan = kconv.convt_tc_plan(L["b"], L["cout"], L["k"], L["s"],
                                           L["pad_lo"], L["out_len"])
            nwg, bn = kconv.TC_TILES[int(plan[0])]
            extra = {"tile": f"{64 * nwg}x{bn}", "rows": int(plan[1]),
                     "nb": int(plan[2]),
                     "tile_ms": tc_tile_times(family, L, x, w, b)}
        else:
            extra = {"tile": cc_tile_name(cc_plan_of(family, L, dtype)),
                     "tile_ms": cc_tile_times(family, L, x, w, b)}
        rows.append({
            "geometry": L["name"], "x": list(x.shape), "cout": L["cout"],
            "path": "tensor_core" if tc else "cuda_core", **extra,
            "ms": ms, "tflops_per_s": flops / ms / 1e9,
            "plain_ms": cuda_ms(lambda: plain(x, w, b, *args)),
            "library_ms": cuda_ms(library(L, x, w, b)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "flops": flops, "bytes": nbytes, "dtype": "f32" if f32 else "bf16",
            "max_abs_err": errs[(L["name"], "f32" if f32 else "bf16")],
        })
        print(json.dumps({"timing": family, **rows[-1]}), flush=True)
    return rows


def time_ingest(cases: list[dict], errs: dict) -> list:
    """K2 per geometry, peak mode: the protocol time (ms: 20 back-to-back
    wrapper calls, which the host's time per call can pace) beside the
    device time (torch.profiler's kernel time per call, and events around
    one call queued behind a sleep), at the wrapper's cluster size and
    the other one (launched directly, not counted), and the host time of
    one wrapper call. Beside the flagship's, what bounds it: the same
    launch without its reduction (mode none) and without mu-law, a fill_
    of its 4 MB output (the stores alone), and the batch of 640 rows."""
    from audiogan_tpu_torch.kernels import ingest as king
    rows = []
    for c in cases:
        nbytes = c["raw"].shape[0] * (c["clip"] * (2 + 4) + 4)
        bound_ms, bound_by = bound(0, nbytes)
        args = (c["raw"], c["offs"], c["clip"], "peak")
        ms = cuda_ms(lambda: king.ingest_fused(*args))
        device_ms = profiled_device_ms(lambda: king.ingest_fused(*args))
        cluster_ms = {}
        for cl in king.INGEST_CLUSTERS:
            call = lambda: king._ingest_launch(*args, 0.999, 255.0, 1e-8, cl)
            cluster_ms[cl] = {"device_ms_profiler": profiled_device_ms(call),
                              "device_ms_queued": queued_device_ms(call)}
        limits = {}
        if c is cases[0]:
            cl = king.ingest_cluster(c["clip"])
            out = torch.empty(c["raw"].shape[0], c["clip"],
                              device=c["raw"].device)
            big = c["raw"].repeat(10, 1)
            limits = {"device_ms_mode_none": profiled_device_ms(
                          lambda: king._ingest_launch(
                              *args[:3], "none", 0.999, 255.0, 1e-8, cl)),
                      "device_ms_mu0": profiled_device_ms(
                          lambda: king._ingest_launch(
                              *args, 0.999, 0.0, 1e-8, cl)),
                      "store_fill_device_ms": profiled_device_ms(
                          lambda: out.fill_(0.0)),
                      "device_ms_batch640": profiled_device_ms(
                          lambda: king._ingest_launch(
                              big, c["offs"].repeat(10), c["clip"], "peak",
                              0.999, 255.0, 1e-8, cl))}
        rows.append({
            "geometry": c["name"], "raw": list(c["raw"].shape),
            "cluster": king.ingest_cluster(c["clip"]),
            "ms": ms, "device_ms": device_ms,
            "device_ms_queued": queued_device_ms(
                lambda: king.ingest_fused(*args)),
            "host_ms": host_ms(lambda: king.ingest_fused(*args)),
            "cluster_device_ms": cluster_ms, **limits,
            "share_of_hbm_rate": bound_ms / ms,
            "device_share_of_hbm_rate": (bound_ms / device_ms
                                         if device_ms else None),
            "plain_ms": cuda_ms(lambda: king.ingest_fused_plain(*args)),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "max_abs_err": errs[(c["name"], "peak")],
        })
        print(json.dumps({"timing": "ingest", **rows[-1]}), flush=True)
    return rows


def compare_adam(dev) -> dict:
    """kernels/adam.py's kernel against torch's foreach ops at every
    parameter shape of every preset and ZeRO-1's row blocks, counts 1 ...
    400 (tools/step_checks.py::hold_adam): equal to the bit, or a
    failure."""
    from audiogan_tpu_torch.tools.step_checks import adam_cases, hold_adam
    errs = {}
    for case in adam_cases(dev):
        rec = hold_adam(case)
        print(json.dumps({"compare": "adam", **rec, "bits_equal": True}),
              flush=True)
        errs[case["name"]] = 0.0
    return errs


def time_adam(dev, errs: dict) -> list:
    """Adam's kernel on the flagship's D and G and music's D at count 1
    (ms: 20 back-to-back calls) beside the same four ops as torch's
    foreach kernels with host scalar lists (the port's update before the
    kernel) and the byte bound (16 bytes an element)."""
    from audiogan_tpu_torch.kernels.adam import adam_update, adam_work
    from audiogan_tpu_torch.tools.step_checks import adam_cases
    from audiogan_tpu_torch.train.state import ADAM_EPS, adam_scalars
    rows = []
    names = ("wgan_gp_b64 D", "wgan_gp_b64 G", "music_44k_dp16 D")
    for case in [c for c in adam_cases(dev) if c["name"] in names]:
        ps, mu, nu = case["params"], case["mu"], case["nu"]
        n = len(ps)
        step_size, bias2 = adam_scalars(case["lr"], *case["betas"],
                                        [1.0] * n)
        scal = torch.tensor([step_size, bias2], dtype=torch.float32,
                            device=dev)

        def foreach():
            den = torch._foreach_sqrt(nu)
            torch._foreach_div_(den, bias2)
            torch._foreach_add_(den, ADAM_EPS)
            torch._foreach_addcdiv_(ps, mu, den, step_size)
        flops, nbytes = adam_work(ps)
        bound_ms, bound_by = bound(flops, nbytes, PEAK_F32_FLOPS)
        rows.append({
            "geometry": case["name"], "tensors": n,
            "elements": sum(p.numel() for p in ps),
            "ms": cuda_ms(lambda: adam_update(ps, mu, nu, scal,
                                              list(range(n)), ADAM_EPS)),
            "device_ms": profiled_device_ms(
                lambda: adam_update(ps, mu, nu, scal, list(range(n)),
                                    ADAM_EPS)),
            "plain_ms": cuda_ms(foreach),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "max_abs_err": errs[case["name"]]})
        print(json.dumps({"timing": "adam", **rows[-1]}), flush=True)
    return rows


def kernel_entry(name, source, replaces, function, launches, rows, per,
                 card, **extra) -> dict:
    total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms",
                                                  "bound_ms")}
    libs = [r["library_ms"] for r in rows]
    by_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "replaces_function": function,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"],
            "bound_by": ("operations" if by_ops >= total["bound_ms"] / 2
                         else "bytes"),
            "library_ms": None if None in libs else sum(libs),
            "per": per, "card": card, **extra, "geometries": rows}


def sampler_rate(sampler, cfg, iters: int = 10) -> dict:
    """Host clock around `iters` seeded batches, each ending in a copy to
    the host (generate returns numpy)."""
    return batch_rate(sampler.generate, sampler.num, cfg, iters)


def batch_rate(generate, batch: int, cfg, iters: int) -> dict:
    """sampler_rate of generate(seed, labels) -> numpy [batch, clip_len]."""
    lab = (np.arange(batch) % cfg.data.num_classes
           if cfg.data.num_classes else None)
    generate(0, lab)
    torch.cuda.synchronize()
    ts = time.perf_counter()
    for i in range(iters):
        generate(i, lab)
    per_batch = (time.perf_counter() - ts) / iters
    clips_s = batch / per_batch
    return {"batch": batch, "ms": per_batch * 1e3, "clips_per_s": clips_s,
            "audio_s_per_s": clips_s * cfg.data.clip_len
            / cfg.data.sample_rate}


def parent_route(cfg, dev, art: str, batch: int):
    """The served route before the replayed graph, as a callable
    (seed, labels) -> numpy: build_sample_fn op by op on the artifact's
    weights, then .cpu().numpy() (a pageable copy)."""
    from audiogan_tpu_torch.train.sample import build_sample_fn
    fn = build_sample_fn(cfg, dev)
    params = torch.load(Path(art) / "generator.pt", map_location=dev,
                        weights_only=True)

    def generate(seed, labels):
        lab = None if labels is None else torch.from_numpy(labels)
        return fn(params, seed, lab, num=batch).cpu().numpy()
    return generate


def http_generate_ms(sampler, cfg, requests: int = SAMPLER_HTTP) -> float:
    """The median wall time of one HTTP /generate at num = the sampler's
    batch (labels with it for a conditional model), through make_server
    on 127.0.0.1, the answer read and parsed."""
    from audiogan_tpu_torch.serve import make_server
    srv = make_server(sampler, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d/generate" % srv.server_address[:2]
    n_cls = cfg.data.num_classes
    times = []
    try:
        for seed in range(requests + 1):
            body = {"seed": seed, "num": sampler.num}
            if n_cls:
                body["labels"] = [i % n_cls for i in range(sampler.num)]
            t0 = time.perf_counter()
            code, out = http_json(url, body)
            times.append(time.perf_counter() - t0)
            if code != 200 or len(out["wavs"]) != sampler.num:
                raise AssertionError(f"/generate: {code}")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")
    return float(np.median(times[1:])) * 1e3


def sampler_timing(cfg, dev, sampler, served: dict) -> dict:
    """cfg's samplers at BATCH (the serve phase's) and at SMALL: the
    replay route against the eager route (replay=False) and the route
    before the replayed graph (parent_route) in one process, in rounds
    replay, eager, parent, parent, eager, replay of SAMPLER_ITERS batches
    each (batch_rate; medians); CUDA events around each replay of those
    rounds for its device ms, and the idle share of a replayed request
    (1 - device ms / ms per batch); the median wall time of one HTTP
    /generate at num = batch on the replay and eager routes; the capture
    of each replaying sampler."""
    from audiogan_tpu_torch.serve import ServedSampler, load_sampler
    from audiogan_tpu_torch.serve.sample_graph import SampleGraph
    out = {}
    replay = SampleGraph.replay
    for batch in (BATCH, SMALL):
        art = served["artifacts"][batch]
        rep = sampler if batch == BATCH else load_sampler(art)
        eag = ServedSampler(art, replay=False)
        events = []

        def timed_replay(self):
            pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            pair[0].record()
            y = replay(self)
            pair[1].record()
            events.append(pair)
            return y
        routes = {"replay": rep.generate, "eager": eag.generate,
                  "parent": parent_route(cfg, dev, art, batch)}
        rounds = {k: [] for k in routes}
        SampleGraph.replay = timed_replay
        try:
            for route in ("replay", "eager", "parent", "parent", "eager",
                          "replay"):
                rounds[route].append(batch_rate(routes[route], batch, cfg,
                                                SAMPLER_ITERS))
        finally:
            SampleGraph.replay = replay
        torch.cuda.synchronize(dev)
        device = [a.elapsed_time(b) for a, b in events]
        ms = {k: float(np.median([r["ms"] for r in v]))
              for k, v in rounds.items()}
        device_ms = float(np.mean(device))
        out[batch] = {
            "batch": batch, "replay_ms": ms["replay"],
            "eager_ms": ms["eager"], "parent_route_ms": ms["parent"],
            "rounds_ms": {k: [r["ms"] for r in v]
                          for k, v in rounds.items()},
            "eager_over_replay": ms["eager"] / ms["replay"],
            "parent_over_replay": ms["parent"] / ms["replay"],
            "clips_per_s": batch / ms["replay"] * 1e3,
            "audio_s_per_s": (batch / ms["replay"] * 1e3 * cfg.data.clip_len
                              / cfg.data.sample_rate),
            "replay_device_ms": device_ms,
            "replay_device_ms_min": min(device),
            "replay_device_ms_max": max(device),
            "idle_share": max(1.0 - device_ms / ms["replay"], 0.0),
            "http_ms": {"replay": http_generate_ms(rep, cfg),
                        "eager": http_generate_ms(eag, cfg)},
            "graph": served["graph"] if batch == BATCH
            else sampler_graph(rep)}
        del rep, eag, routes
    print(json.dumps({"timing": "sampler", "preset": cfg.name,
                      **{str(b): v for b, v in out.items()}}), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from audiogan_tpu_torch.cli import apply_overrides
    from audiogan_tpu_torch.config import get_preset
    from audiogan_tpu_torch.kernels import _build
    from audiogan_tpu_torch.kernels import adam as kadam
    from audiogan_tpu_torch.kernels import conv as kconv
    from audiogan_tpu_torch.kernels import gru as kgru
    from audiogan_tpu_torch.kernels import ingest as king
    from audiogan_tpu_torch.kernels import sconv as ksconv
    from audiogan_tpu_torch.ops.phase_shuffle import PShuf
    from audiogan_tpu_torch.train.step import num_views

    # the plain oracle in full f32: cuDNN's TF32 default would blur it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    counters = {"convt1d": kconv.conv_transpose1d_ba,
                "conv1d": kconv.conv1d_ba, "ingest": king.ingest_fused,
                "gru_scan": kgru.gru_scan_fwd,
                "gru_scan_bwd": kgru.gru_scan_bwd,
                "gru_scan_persistent": PathCounter(kgru.gru_scan_fwd,
                                                   "launches_persistent"),
                "gru_scan_bwd_persistent": PathCounter(
                    kgru.gru_scan_bwd, "launches_persistent"),
                "convt1d_tc": PathCounter(kconv.conv_transpose1d_ba,
                                          "launches_tc"),
                "conv1d_tc": PathCounter(kconv.conv1d_ba, "launches_tc"),
                "adam": kadam.adam_update}
    wave_kernels = {k: counters[k] for k in ("convt1d", "conv1d", "ingest",
                                             "convt1d_tc", "conv1d_tc",
                                             "adam")}
    fused_kernels = {**wave_kernels, "sconv1d": ksconv.sconv1d_ba,
                     "sconvt1d": ksconv.sconvt1d,
                     "sconv1d_tc": PathCounter(ksconv.sconv1d_ba,
                                               "launches_tc"),
                     "sconvt1d_tc": PathCounter(ksconv.sconvt1d,
                                                "launches_tc")}

    # 1. env ---------------------------------------------------------------
    t0 = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase("env", t0, device=kind, nvidia_smi=card, torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())

    # 2. build: one nvcc per source, all started together -------------------
    t0 = time.time()
    for name in SOURCES:
        shutil.rmtree(_build.library_path(name).parent, ignore_errors=True)
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        paths = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
    for name in SOURCES:
        _build.load(name)
    build_s = time.time() - t0
    ptxas = {}
    for name, lib_path in paths.items():
        log = (lib_path.parent / f"{name}.log").read_text().splitlines()
        ptxas[name] = [ln.strip() for ln in log
                       if "registers" in ln or "spill" in ln][:20]
    phase("build", t0, libraries={k: str(v) for k, v in paths.items()},
          ptxas=ptxas)
    if build_s > BUILD_LIMIT_S:
        raise RuntimeError(f"kernel build took {build_s:.1f} s "
                           f"(limit {BUILD_LIMIT_S} s)")

    # 3. every kernel vs its plain form ---------------------------------------
    t0 = time.time()
    cfg = get_preset("wgan_gp_b64")
    # the fused configuration, as `cli train --set` reaches it
    fcfg = apply_overrides(cfg, ["model.fused_shuffle_sites=-1"]).validate()
    gcfg = get_preset("cond_gru_sc09")
    dcfg = get_preset("dual_stft")
    # the reference's dp=1 operating point of the music preset, as
    # `cli train --set mesh.dp=1` reaches it
    mcfg = apply_overrides(get_preset("music_44k_dp16"),
                           ["mesh.dp=1"]).validate()
    rcfg = get_preset("resample_22k")
    g_fwd = generator_layers(cfg, BATCH)
    d_dx = critic_dx_layers(cfg, 2 * BATCH)
    d_fwd = critic_layers(cfg, 2 * BATCH)
    g_dx = generator_dx_layers(cfg, BATCH)
    s_fwd = fused_site_layers(cfg, 2 * BATCH)
    s_fwd_b = [dict(L, name=L["name"] + " (B)")
               for L in fused_site_layers(cfg, BATCH)]
    s_dx = fused_site_dx_layers(cfg, 2 * BATCH)
    s_dx_b = [dict(L, name=L["name"] + " (B)")
              for L in fused_site_dx_layers(cfg, BATCH)]
    def music(layers):
        return [dict(L, name="music " + L["name"]) for L in layers]
    m_g_fwd = music(generator_layers(mcfg, BATCH))
    m_d_dx = music(critic_dx_layers(mcfg, 2 * BATCH))
    m_d_fwd = music(critic_layers(mcfg, 2 * BATCH))
    m_g_dx = music(generator_dx_layers(mcfg, BATCH))
    # data parallelism runs every conv at the per-rank batch, where the
    # tensor-core tiles are chosen again: G at B/dp, the critic at 2B/dp,
    # the fused sites' x-hat at B/dp (the dp phase at dp=2, and
    # tools/dp_check.py at dp=4 for the flagship and music)
    r_convt, r_conv = per_rank_layers(cfg, BATCH, (2, 4))
    rm_convt, rm_conv = per_rank_layers(mcfg, BATCH, (4,), "music ")
    r_s_fwd = [dict(L, name=f"{L['name']} (B/{dp})") for dp in (2, 4)
               for L in fused_site_layers(cfg, BATCH // dp)]
    r_s_dx = [dict(L, name=f"{L['name']} (B/{dp})") for dp in (2, 4)
              for L in fused_site_dx_layers(cfg, BATCH // dp)]
    # context parallelism runs each conv on a halo-extended slice with
    # explicit pads, in f32: music's at cp=4 (tools/dp_check.py --cp)
    c_convt, c_conv = (music(layers) for layers in cp_rank_layers(
        apply_overrides(mcfg, [f"mesh.cp={CP_MUSIC}"]).validate(), BATCH,
        CP_MUSIC))
    # tensor parallelism runs the critic's convs on channel slices, in
    # f32: the flagship's at tp=2 (column layers C_out / 2, row layers
    # C_in / 2 with no bias) and their dx, at 2B = 128
    t_convt, t_conv = tp_rank_layers(cfg, BATCH, TP_RANKS)
    errs = {"convt1d": compare_conv("convt1d", g_fwd + d_dx + m_g_fwd
                                    + m_d_dx + r_convt + rm_convt + c_convt
                                    + t_convt, dev),
            "conv1d": compare_conv("conv1d", d_fwd + g_dx + m_d_fwd
                                   + m_g_dx + r_conv + rm_conv + c_conv
                                   + t_conv, dev),
            "sconv1d": compare_sconv(False, s_fwd + s_fwd_b + r_s_fwd, dev),
            "sconvt1d": compare_sconv(True, s_dx + s_dx_b + r_s_dx, dev)}
    cases = ingest_cases(dev)
    errs["ingest"] = compare_ingest(cases, dev)
    errs["gru"] = compare_gru(gcfg, dev)
    gru_launches = gru_launch_counts(gcfg, dev)
    errs["gru_cell"] = compare_gru_cell(gcfg, dev)
    resampled = compare_resample(dev)
    errs["adam"] = compare_adam(dev)
    single = ("gru", "gru_cell")
    phase("compare", t0, geometries={k: len(v) // 2 if k not in
                                     ("ingest", "adam") else len(v)
                                     for k, v in errs.items()
                                     if k not in single},
          max_abs_err={k: max(v.values()) for k, v in errs.items()
                       if k not in single},
          gru={" ".join(k): v for k, v in errs["gru"].items()},
          gru_cuda_launches=gru_launches,
          gru_cell={" ".join(k): v for k, v in errs["gru_cell"].items()},
          resample=resampled)

    # 4. serve both generators -------------------------------------------------
    t0 = time.time()
    sampler, served = serve_phase(
        cfg, dev, counters,
        {"convt1d": len(g_fwd),
         "convt1d_tc": sum(tensor_core("convt1d", L) for L in g_fwd)})
    phase("serve", t0, **served)
    t0 = time.time()
    # the GRU G's convT layers 256 -> 128 -> 64 -> 1: two on the tensor
    # cores
    # the served batch of 64 runs K4 on the persistent path
    gsampler, gserved = serve_phase(gcfg, dev, counters,
                                    {"gru_scan": 1, "gru_scan_persistent": 1,
                                     "convt1d": 3, "convt1d_tc": 2})
    phase("serve", t0, **gserved)
    t0 = time.time()
    # dual_stft's G is the flagship's WaveGAN G
    dsampler, dserved = serve_phase(
        dcfg, dev, counters,
        {"convt1d": len(g_fwd),
         "convt1d_tc": sum(tensor_core("convt1d", L) for L in g_fwd)})
    phase("serve", t0, **dserved)
    t0 = time.time()
    msampler, mserved = serve_phase(
        mcfg, dev, counters,
        {"convt1d": len(m_g_fwd),
         "convt1d_tc": sum(tensor_core("convt1d", L) for L in m_g_fwd)})
    phase("serve", t0, **mserved)
    t0 = time.time()
    # resample_22k's G is f32: every convT on the CUDA-core kernels
    rsampler, rserved = serve_phase(
        rcfg, dev, counters,
        {"convt1d": len(rcfg.model.strides),
         "convt1d_tc": sum(tensor_core("convt1d", L, compute_dtype(rcfg))
                           for L in generator_layers(rcfg, BATCH))})
    phase("serve", t0, **rserved)

    # 5. one full-width f32 step of each preset, card vs CPU ---------------
    for c in (cfg, fcfg, gcfg, dcfg, rcfg, mcfg):
        t0 = time.time()
        phase("parity", t0, preset=c.name,
              fused_shuffle_sites=c.model.fused_shuffle_sites,
              **parity_phase(c, dev, batch=2))
    t0 = time.time()
    phase("parity", t0, preset=mcfg.name, gp_batch_chunks=2,
          **gp_chunk_phase(mcfg, dev))

    # 6. both presets, and the fused flagship, train ------------------------
    t0 = time.time()
    PShuf.calls = ksconv.sconv1d_ba.launches = ksconv.sconvt1d.launches = 0
    # K1' 85 and K1 80 per flagship step, 68 each on the tensor cores;
    # the fused flagship 21 and 36, 4 and 24; K2 one per real view
    trained, cstate = train_phase(cfg, dev, wave_kernels,
                          {**conv_step_launches(cfg),
                           "ingest": num_views(cfg)})
    unfused_shuffles = PShuf.calls
    if not unfused_shuffles or ksconv.sconv1d_ba.launches \
            or ksconv.sconvt1d.launches:
        raise AssertionError("the unfused critic must shuffle and launch "
                             "neither K6 nor K7")
    phase("train", t0, card=card, pshuf_calls=unfused_shuffles, **trained)
    t0 = time.time()
    replayed = {cfg.name: replay_phase(cfg, dev, trained, cstate)}
    phase("replay", t0, card=card, **replayed[cfg.name])
    t0 = time.time()
    k6_step, k7_step = fused_step_launches(fcfg)
    PShuf.calls = 0
    # every K6 and K7 launch of the step on the tensor cores
    ftrained, fstate = train_phase(fcfg, dev, fused_kernels,
                           {"sconv1d": k6_step, "sconvt1d": k7_step,
                            "sconv1d_tc": k6_step, "sconvt1d_tc": k7_step,
                            "ingest": num_views(fcfg),
                            **conv_step_launches(fcfg)})
    if PShuf.calls:
        raise AssertionError(f"fused critic shuffled {PShuf.calls} times")
    phase("train", t0, card=card, fused_shuffle_sites=-1,
          pshuf_calls=PShuf.calls, **ftrained)
    t0 = time.time()
    replayed[cfg.name + " fused_shuffle_sites=-1"] = replay_phase(
        fcfg, dev, ftrained, fstate)
    phase("replay", t0, card=card,
          **replayed[cfg.name + " fused_shuffle_sites=-1"])
    t0 = time.time()
    # K4 6 and K5 1 per step, every one on the persistent path in bf16
    gtrained, gstate = train_phase(gcfg, dev, counters,
                           {"gru_scan": 1 + gcfg.loss.n_critic,
                            "gru_scan_bwd": 1, "ingest": num_views(gcfg),
                            "gru_scan_persistent": 1 + gcfg.loss.n_critic,
                            "gru_scan_bwd_persistent": 1})
    phase("train", t0, card=card, **gtrained)
    t0 = time.time()
    replayed[gcfg.name] = replay_phase(gcfg, dev, gtrained, gstate)
    phase("replay", t0, card=card, **replayed[gcfg.name])
    t0 = time.time()
    # the dual critic's wave critic and G run the flagship's convs; K2 6:
    # five critic views and G's real view for its spectral term
    PShuf.calls = 0
    dtrained, dstate = train_phase(dcfg, dev, wave_kernels,
                           {**conv_step_launches(dcfg),
                            "ingest": num_views(dcfg)})
    if "stft_loss" not in dtrained["last"] or not PShuf.calls:
        raise AssertionError("dual_stft: no stft_loss or no shuffle")
    phase("train", t0, card=card, **dtrained)
    t0 = time.time()
    replayed[dcfg.name] = replay_phase(dcfg, dev, dtrained, dstate)
    phase("replay", t0, card=card, **replayed[dcfg.name])
    t0 = time.time()
    # music at dp=1: K1' and K1 as the step's structure gives them at
    # strides 7/7/5/5/3, K2 one per critic view (store 220500 -> 176400)
    mtrained, mstate = train_phase(mcfg, dev, wave_kernels,
                           {**conv_step_launches(mcfg),
                            "ingest": num_views(mcfg)})
    phase("train", t0, card=card, **mtrained)
    t0 = time.time()
    replayed[mcfg.name] = replay_phase(mcfg, dev, mtrained, mstate)
    phase("replay", t0, card=card, **replayed[mcfg.name])
    t0 = time.time()
    phase("train", t0, card=card, preset=mcfg.name, data_path="host_batcher",
          **host_batcher_phase(mcfg, dev, mtrained))
    t0 = time.time()
    # resample_22k: every view resampled in plain torch ops (the
    # reference's route), so K2 never; f32, so no tensor-core conv
    rtrained, rstate = train_phase(rcfg, dev, wave_kernels,
                           {**conv_step_launches(rcfg), "ingest": 0})
    phase("train", t0, card=card, **rtrained)
    t0 = time.time()
    replayed[rcfg.name] = replay_phase(rcfg, dev, rtrained, rstate)
    phase("replay", t0, card=card, **replayed[rcfg.name])
    t0 = time.time()
    cell_run = gru_cell_phase(gcfg, dev)
    phase("gru_cell", t0, card=card, **cell_run)

    # 6b. `cli train` killed and resumed, then sample / serve --workdir -----
    t0 = time.time()
    phase("resume", t0, card=card, **resume_phase())

    # 6c. data parallelism: two ranks on this card ---------------------------
    t0 = time.time()
    dp_run = dp_phase(cfg, dcfg, dev)
    phase("dp", t0, card=card, **dp_run)

    # 6d. context parallelism: two ranks on this card ------------------------
    t0 = time.time()
    cp_run = axis_phase("cp", [(cfg, PARITY_SEEDS, (60,), True),
                               (dcfg, (60,), (60,), False),
                               (gcfg, (80,), (), True)], dev)
    if "stft_loss" not in cp_run["last_metrics"][dcfg.name]:
        raise AssertionError("dual_stft at cp=2: no stft_loss")
    phase("cp", t0, card=card, **cp_run)

    # 6e. tensor parallelism: two ranks on this card -------------------------
    t0 = time.time()
    tp_run = axis_phase("tp", [(cfg, PARITY_SEEDS, (), True),
                               (gcfg, (80,), (), True)], dev)
    phase("tp", t0, card=card, **tp_run)

    # 6f. one step of each preset captured as one CUDA graph ---------------
    t0 = time.time()
    phase("graph", t0, card=card, **graph_phases(cfg, fcfg, gcfg, dcfg, mcfg,
                                                 rcfg, dev))

    # 6g. the loop's trace and NaN check -------------------------------------
    t0 = time.time()
    phase("trace", t0, card=card, **trace_phase(cfg, dev))

    # 6h. `cli bench`: the reference's headline harness ---------------------
    t0 = time.time()
    phase("bench", t0, card=card, **bench_phase(card, dev))

    # 7. timing ---------------------------------------------------------------
    t0 = time.time()
    rows = {"convt1d": time_conv("convt1d", g_fwd + d_dx, dev,
                                 errs["convt1d"]),
            "conv1d": time_conv("conv1d", d_fwd + g_dx, dev, errs["conv1d"]),
            "convt1d_music": time_conv("convt1d", m_g_fwd + m_d_dx, dev,
                                       errs["convt1d"]),
            "conv1d_music": time_conv("conv1d", m_d_fwd + m_g_dx, dev,
                                      errs["conv1d"]),
            "convt1d_cp": time_conv("convt1d", c_convt, dev,
                                    errs["convt1d"], torch.float32),
            "conv1d_cp": time_conv("conv1d", c_conv, dev, errs["conv1d"],
                                   torch.float32),
            "convt1d_tp": time_conv("convt1d", t_convt, dev,
                                    errs["convt1d"], torch.float32),
            "conv1d_tp": time_conv("conv1d", t_conv, dev, errs["conv1d"],
                                   torch.float32),
            "ingest": time_ingest(cases, errs["ingest"]),
            **time_gru(gcfg, dev, errs["gru"], gru_launches),
            "sconv1d": time_sconv(False, s_fwd, dev, errs["sconv1d"]),
            "sconvt1d": time_sconv(True, s_dx, dev, errs["sconvt1d"]),
            "gru_cell": time_gru_cell(gcfg, dev, errs["gru_cell"]),
            "adam": time_adam(dev, errs["adam"])}
    samplers = {c.name: sampler_timing(c, dev, smp, srv) for c, smp, srv in (
        (cfg, sampler, served), (gcfg, gsampler, gserved),
        (dcfg, dsampler, dserved), (mcfg, msampler, mserved),
        (rcfg, rsampler, rserved))}
    phase("timing", t0, samplers=samplers,
          train_steps_per_s={cfg.name: trained["steps_per_s"],
                             cfg.name + " fused_shuffle_sites=-1":
                                 ftrained["steps_per_s"],
                             gcfg.name: gtrained["steps_per_s"],
                             dcfg.name: dtrained["steps_per_s"],
                             mcfg.name + " mesh.dp=1": mtrained["steps_per_s"],
                             rcfg.name: rtrained["steps_per_s"]},
          peak_memory_gib={mcfg.name: mtrained["peak_memory_gib"],
                           rcfg.name: rtrained["peak_memory_gib"]},
          replay_steps_per_s={k: v["replay_steps_per_s"]
                              for k, v in replayed.items()},
          eager_steps_per_s={k: v["eager_steps_per_s"]
                             for k, v in replayed.items()},
          card=card)

    per_step = trained["launches_per_step"]
    fper_step = ftrained["launches_per_step"]
    gper_step = gtrained["launches_per_step"]
    dper_step = dtrained["launches_per_step"]
    mper_step = mtrained["launches_per_step"]

    def music_rows(family):
        rows_m = rows[family + "_music"] if family != "ingest" else \
            rows["ingest"][2:]
        return {"ms": sum(r["ms"] for r in rows_m),
                "plain_ms": sum(r["plain_ms"] for r in rows_m),
                "bound_ms": sum(r["bound_ms"] for r in rows_m),
                "library_ms": (None if family == "ingest" else
                               sum(r["library_ms"] for r in rows_m)),
                "launches_per_train_step": mper_step[family],
                "launches_serve": mserved["launches"][family],
                "geometries": rows_m}
    def cp_rows(family):
        rows_c = rows[family + "_cp"]
        return {"ms": sum(r["ms"] for r in rows_c),
                "plain_ms": sum(r["plain_ms"] for r in rows_c),
                "bound_ms": sum(r["bound_ms"] for r in rows_c),
                "library_ms": sum(r["library_ms"] for r in rows_c),
                "per": f"one rank of music_44k_dp16 at cp={CP_MUSIC}: the "
                       "halo-extended geometries (critic 2B=128, G B=64), "
                       "f32, the CUDA-core kernels",
                "launches_per_rank_step_cp2": cp_run[
                    "launches_per_rank_step"][cfg.name][0][family],
                "geometries": rows_c}
    def tp_rows(family):
        rows_t = rows[family + "_tp"]
        return {"ms": sum(r["ms"] for r in rows_t),
                "plain_ms": sum(r["plain_ms"] for r in rows_t),
                "bound_ms": sum(r["bound_ms"] for r in rows_t),
                "library_ms": sum(r["library_ms"] for r in rows_t),
                "per": f"one rank of the flagship's critic at tp={TP_RANKS}:"
                       " the channel-sliced geometries (2B=128) and their "
                       "dx, f32, the CUDA-core kernels",
                "launches_per_rank_step_tp2": tp_run[
                    "launches_per_rank_step"][cfg.name][0][family],
                "geometries": rows_t}
    gru_per = ("one scan of cond_gru_sc09's G (B=64, H=512, F=256, 256 "
               "frames), bf16")
    kernels = [
        kernel_entry(
            "convt1d", "audiogan_tpu_torch/csrc/convt1d.cu",
            "audiogan_tpu/kernels/conv.py:397",
            "_convt_pallas (body _rowconv_kernel)",
            trained["launches"]["convt1d"], rows["convt1d"],
            "sum over G's 5 layers forward (B=64) and the dx of D's 5 "
            "layers (2B=128), bf16", card,
            launches_per_train_step=per_step["convt1d"],
            launches_per_train_step_gru=gper_step["convt1d"],
            launches_per_train_step_dual=dper_step["convt1d"],
            launches_serve=served["launches"]["convt1d"],
            launches_serve_gru=gserved["launches"]["convt1d"],
            kernel_nodes_served_graph=served["graph"]["port_kernels"][
                "K1 conv_transpose1d_ba"]["kernel_nodes"],
            kernel_nodes_served_graph_gru=gserved["graph"]["port_kernels"][
                "K1 conv_transpose1d_ba"]["kernel_nodes"],
            launches_tensor_core=trained["launches"]["convt1d_tc"],
            launches_tensor_core_per_train_step=per_step["convt1d_tc"],
            launches_tensor_core_per_train_step_gru=gper_step["convt1d_tc"],
            launches_tensor_core_per_train_step_music=mper_step["convt1d_tc"],
            launches_per_rank_step_dp2=dp_run["launches_per_rank_step"][0][
                "convt1d"],
            music=music_rows("convt1d"), cp=cp_rows("convt1d"),
            tp=tp_rows("convt1d")),
        kernel_entry(
            "conv1d", "audiogan_tpu_torch/csrc/conv1d.cu",
            "audiogan_tpu/kernels/conv.py:285",
            "_conv1d_pallas (body _rowconv_kernel)",
            trained["launches"]["conv1d"], rows["conv1d"],
            "sum over D's 5 layers forward (2B=128) and the dx of G's 5 "
            "layers (B=64), bf16", card,
            launches_per_train_step=per_step["conv1d"],
            launches_per_train_step_gru=gper_step["conv1d"],
            launches_per_train_step_dual=dper_step["conv1d"],
            launches_tensor_core=trained["launches"]["conv1d_tc"],
            launches_tensor_core_per_train_step=per_step["conv1d_tc"],
            launches_tensor_core_per_train_step_gru=gper_step["conv1d_tc"],
            launches_tensor_core_per_train_step_music=mper_step["conv1d_tc"],
            launches_per_rank_step_dp2=dp_run["launches_per_rank_step"][0][
                "conv1d"],
            music=music_rows("conv1d"), cp=cp_rows("conv1d"),
            tp=tp_rows("conv1d")),
        kernel_entry(
            "ingest", "audiogan_tpu_torch/csrc/ingest.cu",
            "audiogan_tpu/kernels/ingest.py:124", "ingest_fused (body _kernel)",
            trained["launches"]["ingest"], rows["ingest"][:1],
            "one flagship ingest, int16 [64, 16384] -> f32 (store = clip)",
            card, launches_per_train_step=per_step["ingest"],
            launches_per_train_step_gru=gper_step["ingest"],
            launches_per_train_step_dual=dper_step["ingest"],
            device_ms=rows["ingest"][0]["device_ms"],
            slack=rows["ingest"][1], music=music_rows("ingest"),
            launches_per_train_step_resample_22k=rtrained[
                "launches_per_step"]["ingest"],
            launches_per_rank_step_dp2=dp_run["launches_per_rank_step"][0][
                "ingest"],
            launches_per_rank_step_cp2=cp_run["launches_per_rank_step"][
                cfg.name][0]["ingest"],
            launches_per_rank_step_tp2=tp_run["launches_per_rank_step"][
                cfg.name][0]["ingest"]),
        kernel_entry(
            "gru_scan", "audiogan_tpu_torch/csrc/gru_scan.cu",
            "audiogan_tpu/kernels/gru.py:213",
            "_gru_scan_impl (bodies _gru_scan_kernel, _gru_scan_kernel_h)",
            gtrained["launches"]["gru_scan"], [rows["gru_scan"]],
            gru_per + ", without h_seq", card,
            launches_per_train_step=gper_step["gru_scan"],
            launches_serve=gserved["launches"]["gru_scan"],
            kernel_nodes_served_graph=gserved["graph"]["port_kernels"][
                "K4 gru_scan_fwd"]["kernel_nodes"],
            launches_persistent=gtrained["launches"]["gru_scan_persistent"],
            launches_persistent_serve=gserved["launches"][
                "gru_scan_persistent"],
            launches_per_rank_step_tp2=tp_run["launches_per_rank_step"][
                gcfg.name][0]["gru_scan"]),
        kernel_entry(
            "gru_scan_bwd", "audiogan_tpu_torch/csrc/gru_scan.cu",
            "audiogan_tpu/kernels/gru.py:397",
            "_gru_scan_bwd (body _gru_scan_bwd_kernel)",
            gtrained["launches"]["gru_scan_bwd"], [rows["gru_scan_bwd"]],
            gru_per + ": the nine gradients", card,
            launches_per_train_step=gper_step["gru_scan_bwd"],
            launches_persistent=gtrained["launches"][
                "gru_scan_bwd_persistent"],
            launches_per_rank_step_tp2=tp_run["launches_per_rank_step"][
                gcfg.name][0]["gru_scan_bwd"]),
        kernel_entry(
            "sconv1d", "audiogan_tpu_torch/csrc/sconv.cu",
            "audiogan_tpu/kernels/sconv.py:440",
            "_sconv1d_pallas (body _sconv_kernel)",
            ftrained["launches"]["sconv1d"], rows["sconv1d"],
            "sum over the fused critic's 4 shuffled-input convs D1-D4 "
            "forward (2B=128), bf16", card,
            launches_per_train_step_fused=fper_step["sconv1d"],
            launches_tensor_core=ftrained["launches"]["sconv1d_tc"],
            launches_tensor_core_per_train_step_fused=fper_step[
                "sconv1d_tc"],
            cuda_core_ms=sum(r["cuda_core_ms"] for r in rows["sconv1d"]),
            unfused_pair_ms=sum(r["unfused_pair_ms"]
                                for r in rows["sconv1d"])),
        kernel_entry(
            "sconvt1d", "audiogan_tpu_torch/csrc/sconv.cu",
            "audiogan_tpu/kernels/sconv.py:627",
            "_sconvt1d_pallas (body _sconvt_kernel)",
            ftrained["launches"]["sconvt1d"], rows["sconvt1d"],
            "sum over the x-gradients of the fused critic's 4 shuffled-input "
            "convs (2B=128), bf16", card,
            launches_per_train_step_fused=fper_step["sconvt1d"],
            launches_tensor_core=ftrained["launches"]["sconvt1d_tc"],
            launches_tensor_core_per_train_step_fused=fper_step[
                "sconvt1d_tc"],
            cuda_core_ms=sum(r["cuda_core_ms"] for r in rows["sconvt1d"]),
            convt1d_ms=sum(r["convt1d_ms"] for r in rows["sconvt1d"]),
            unfused_pair_ms=sum(r["unfused_pair_ms"]
                                for r in rows["sconvt1d"])),
        kernel_entry(
            "gru_cell", "audiogan_tpu_torch/csrc/gru_cell.cu",
            "audiogan_tpu/kernels/gru.py:57",
            "_gru_fwd_impl (body _gru_kernel)",
            cell_run["bf16"]["launches"], [rows["gru_cell"]],
            "one step of cond_gru_sc09's cell, x and h [64, 512], bf16", card,
            launches_per_recurrence=cell_run["bf16"]["launches"],
            launches_tensor_core=cell_run["bf16"]["launches_tensor_core"],
            launches_f32_recurrence=cell_run["launches"]),
        kernel_entry(
            "adam", "audiogan_tpu_torch/csrc/adam.cu",
            "audiogan_tpu/train/state.py:38",
            "optax.adam (XLA's, no Pallas kernel): the update's "
            "step-dependent tail from device scalars",
            trained["launches"]["adam"], rows["adam"],
            "one update of the flagship's D, of its G and of music's D "
            "(f32 parameters and moments)", card,
            launches_per_train_step=per_step["adam"],
            launches_per_train_step_gru=gper_step["adam"],
            launches_per_train_step_dual=dper_step["adam"],
            launches_per_train_step_music=mper_step["adam"],
            launches_per_rank_step_dp2=dp_run["launches_per_rank_step"][0][
                "adam"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
