#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (audiogan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its own ``seconds``; any failure
raises and the script exits non-zero:

1. env      the card's name and power limit (nvidia-smi).
2. build    the convt1d kernel from a clean build directory (plain nvcc).
3. compare  the kernel against its plain PyTorch form at the five
            wgan_gp_b64 generator layers, batch 64, in f32 and bf16.
4. serve    the wgan_gp_b64 generator at full width (random weights from
            init seed 0, bf16) exported, loaded and served over HTTP on
            127.0.0.1; a few requests, the kernel's launch count per request,
            the served audio against a CPU reference on two clips.
5. timing   per layer: kernel, plain form and one library call
            (F.conv_transpose1d, a yardstick the port never calls) beside the
            card's bound; the sampler's clips/s at batch 64.

It prints the kernels line, then, last, {"ok": true, "device": {...}}.
Without a CUDA device, or without the audiogan_tpu_torch package beside it,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import wave
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

BATCH = 64
SMALL = 8                     # a request for a prefix of the batch
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor rate
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 rate
F32_REL_TOL = 1e-4            # same sums in another order
BF16_REL_TOL = 2e-2           # bf16 keeps 8 bits: one rounding of the output
BUILD_LIMIT_S = 120.0


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


def flagship_layers(cfg) -> list[dict]:
    """The generator's conv-transpose layers as the main path runs them."""
    from audiogan_tpu_torch.models.wavegan import _gen_channels
    m = cfg.model
    t = cfg.data.clip_len // m.total_stride
    c_in = min(m.model_dim * 2 ** (len(m.strides) - 1), m.max_channels)
    layers = []
    chs = _gen_channels(m.model_dim, len(m.strides), m.max_channels)
    for i, (s, c_out) in enumerate(zip(m.strides, chs)):
        layers.append(dict(layer=i, t_in=t, cin=c_in, cout=c_out,
                           k=m.kernel_size, s=s, pad_lo=(m.kernel_size - 1) // 2,
                           out_len=t * s,
                           act="relu" if i < len(chs) - 1 else "tanh"))
        t, c_in = t * s, c_out
    return layers


def work(L: dict, itemsize: int) -> tuple[int, int]:
    """(flops, bytes) the layer needs: multiply-adds over the taps that land
    inside the input (edges excluded), each input read and output written
    once."""
    from audiogan_tpu_torch.kernels.conv import _convt_phase_range
    q_min, q_taps = _convt_phase_range(L["k"], L["s"], L["pad_lo"])
    m_out = -(-L["out_len"] // L["s"])
    pairs = 0
    for rho in range(L["s"]):
        rows = [m for m in range(m_out) if m * L["s"] + rho < L["out_len"]]
        for tau in range(q_taps):
            j = L["pad_lo"] - rho + (q_min + tau) * L["s"]
            if 0 <= j < L["k"]:
                pairs += sum(0 <= m + q_min + tau < L["t_in"] for m in rows)
    flops = 2 * BATCH * pairs * L["cin"] * L["cout"]
    nbytes = itemsize * (BATCH * L["t_in"] * L["cin"]
                         + L["k"] * L["cin"] * L["cout"] + L["cout"]
                         + BATCH * L["out_len"] * L["cout"])
    return flops, nbytes


def layer_inputs(L: dict, dtype, dev, seed: int):
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.relu(torch.randn(BATCH, L["t_in"], L["cin"], generator=gen,
                               device=dev))
    lim = (6.0 / (L["k"] * (L["cin"] + L["cout"]))) ** 0.5
    w = (torch.rand(L["k"], L["cin"], L["cout"], generator=gen, device=dev)
         * 2 - 1) * lim * 4
    b = torch.randn(L["cout"], generator=gen, device=dev) * 0.1
    return x.to(dtype), w.to(dtype), b.to(dtype)


def library_call(L: dict, x, w, b):
    """F.conv_transpose1d computing the same convT: taps flipped, padding
    moved, NCW layout prepared outside the timed call."""
    p = L["k"] - 1 - L["pad_lo"]
    out_pad = L["out_len"] - ((L["t_in"] - 1) * L["s"] - 2 * p + L["k"])
    xn = x.transpose(1, 2).contiguous()
    wt = w.flip(0).permute(1, 2, 0).contiguous()      # [Cin, Cout, K]
    return lambda: F.conv_transpose1d(xn, wt, b, stride=L["s"], padding=p,
                                      output_padding=out_pad)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from audiogan_tpu_torch.config import get_preset
    from audiogan_tpu_torch.kernels import _build
    from audiogan_tpu_torch.kernels import conv as kconv
    from audiogan_tpu_torch.models import build_generator
    from audiogan_tpu_torch.models.init import init_params
    from audiogan_tpu_torch.serve import (export_sampler, load_sampler,
                                          make_server)
    from audiogan_tpu_torch.train.sample import generate

    # the plain oracle in full f32: cuDNN's TF32 default would blur it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernel = kconv.conv_transpose1d_ba

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

    # 2. build -------------------------------------------------------------
    t0 = time.time()
    shutil.rmtree(_build.library_path("convt1d").parent, ignore_errors=True)
    lib_path = _build.build("convt1d")
    _build.load("convt1d")
    build_s = time.time() - t0
    log = (lib_path.parent / "convt1d.log").read_text().splitlines()
    ptxas = [ln.strip() for ln in log
             if "registers" in ln or "spill" in ln][:12]
    phase("build", t0, library=str(lib_path), ptxas=ptxas)
    if build_s > BUILD_LIMIT_S:
        raise RuntimeError(f"kernel build took {build_s:.1f} s "
                           f"(limit {BUILD_LIMIT_S} s)")

    # 3. kernel vs plain at the flagship geometries -------------------------
    t0 = time.time()
    cfg = get_preset("wgan_gp_b64")
    layers = flagship_layers(cfg)
    errs = {}
    for dtype, name, tol in ((torch.float32, "f32", F32_REL_TOL),
                             (torch.bfloat16, "bf16", BF16_REL_TOL)):
        for L in layers:
            x, w, b = layer_inputs(L, dtype, dev, seed=L["layer"])
            args = (L["s"], L["pad_lo"], L["out_len"], L["act"], 0.2)
            got = kernel(x, w, b, *args)
            want = kconv.conv_transpose1d_ba_plain(
                x.float(), w.float(), b.float(), *args)
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != want.shape:
                raise AssertionError(f"layer {L['layer']} {name}: "
                                     f"{got.dtype} {tuple(got.shape)}")
            err = (got.float() - want).abs().max().item()
            peak = want.abs().max().item()
            errs[(L["layer"], name)] = err
            print(json.dumps({"compare": name, "layer": L["layer"],
                              "shape": [BATCH, L["t_in"], L["cin"],
                                        L["cout"]],
                              "max_abs_err": err, "max_rel_err": err / peak,
                              "max_abs_y": peak, "tol_rel": tol}),
                  flush=True)
            if not err <= tol * peak:
                raise AssertionError(f"layer {L['layer']} {name}: "
                                     f"max err {err} > {tol} * {peak}")
            # the library yardstick computes the same function
            lib = library_call(L, x.float(), w.float(), b.float())()
            lib = kconv._apply_act(lib.transpose(1, 2), L["act"], 0.2)
            lib_err = (lib - want).abs().max().item()
            if not lib_err <= F32_REL_TOL * peak:
                raise AssertionError(f"library form disagrees at layer "
                                     f"{L['layer']}: {lib_err}")
    phase("compare", t0, layers=len(layers), dtypes=["f32", "bf16"],
          max_abs_err_f32=max(v for (_, n), v in errs.items() if n == "f32"),
          max_abs_err_bf16=max(v for (_, n), v in errs.items()
                               if n == "bf16"))

    # 4. serve the flagship generator ----------------------------------------
    t0 = time.time()
    art = Path(__file__).resolve().parent / "build" / "chip_smoke_artifact"
    shutil.rmtree(art, ignore_errors=True)
    g = init_params(build_generator(cfg, device=dev), seed=0)
    params = g.state_dict()
    export_sampler(cfg, params, num=BATCH, out_dir=art)
    sampler = load_sampler(art)
    srv = make_server(sampler, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d" % srv.server_address[:2]
    try:
        kernel.launches = 0
        code, health = http_json(f"{url}/healthz")
        r8 = http_json(f"{url}/generate", {"seed": 1, "num": SMALL})
        r64 = http_json(f"{url}/generate", {"seed": 1, "num": BATCH})
        r64b = http_json(f"{url}/generate", {"seed": 1, "num": BATCH})
        r2 = http_json(f"{url}/generate", {"seed": 2, "num": SMALL})
        bad = [http_json(f"{url}/generate", {"seed": 1, "num": n})[0]
               for n in (0, BATCH + 1)]
        launches = kernel.launches
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")
    n_generate = 4
    if code != 200 or health["num"] != BATCH or health["status"] != "ok":
        raise AssertionError(f"healthz: {code} {health}")
    for c, body in (r8, r64, r64b, r2):
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
    if launches != len(layers) * n_generate:
        raise AssertionError(f"convt1d launched {launches} times for "
                             f"{n_generate} requests, want "
                             f"{len(layers)} per request")
    pcm = []
    for b64 in r64[1]["wavs"]:
        rate, p = decode_wav(b64)
        if rate != cfg.data.sample_rate or p.shape != (cfg.data.clip_len,):
            raise AssertionError(f"wav {rate} Hz, {p.shape}")
        pcm.append(p)
    pcm = np.stack(pcm)
    waves = sampler.generate(1)
    if not np.isfinite(waves).all() or not pcm.any():
        raise AssertionError("non-finite or silent output")
    want16 = np.round(np.clip(waves, -1, 1) * 32767).astype(np.int16)
    if not np.array_equal(pcm, want16):
        raise AssertionError("served wav bytes differ from the sampler")
    # the card's output against the port on the CPU (plain form), same z
    z = torch.randn(BATCH, cfg.model.latent_dim,
                    generator=torch.Generator(dev).manual_seed(1),
                    device=dev)[:2].cpu()
    cpu_params = {k: v.cpu() for k, v in params.items()}
    ref_checks = {}
    cfg32 = cfg.replace(train=dataclasses.replace(cfg.train,
                                                  dtype="float32"))
    # bf16: five layers each round their output to 8 bits, in another
    # order on the card than on the CPU
    for dname, c, tol in (("bf16", cfg, 5e-2), ("f32", cfg32, F32_REL_TOL)):
        on_card = (waves[:2] if dname == "bf16" else
                   generate(c, params, 2, 1, device=dev, z=z))
        ref = generate(c, cpu_params, 2, 1, device="cpu", z=z)
        err = float(np.abs(on_card - ref).max())
        peak = float(np.abs(ref).max())
        ref_checks[dname] = {"max_abs_err": err, "max_abs_ref": peak,
                             "tol_rel": tol}
        if not err <= tol * peak:
            raise AssertionError(f"served {dname} G vs CPU reference: "
                                 f"{err} > {tol} * {peak}")
    phase("serve", t0, requests=7, generate_requests=n_generate,
          launches=launches, launches_per_request=launches / n_generate,
          clip_len=cfg.data.clip_len, sample_rate=cfg.data.sample_rate,
          reference=ref_checks)

    # 5. timing ---------------------------------------------------------------
    t0 = time.time()
    per_layer = []
    for L in layers:
        x, w, b = layer_inputs(L, torch.bfloat16, dev, seed=L["layer"])
        args = (L["s"], L["pad_lo"], L["out_len"], L["act"], 0.2)
        flops, nbytes = work(L, 2)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        per_layer.append({
            "layer": L["layer"],
            "shape": [BATCH, L["t_in"], L["cin"], L["cout"]],
            "ms": cuda_ms(lambda: kernel(x, w, b, *args)),
            "plain_ms": cuda_ms(
                lambda: kconv.conv_transpose1d_ba_plain(x, w, b, *args)),
            "library_ms": cuda_ms(library_call(L, x, w, b)),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes,
            "max_abs_err": errs[(L["layer"], "bf16")],
        })
        print(json.dumps({"timing": per_layer[-1]}), flush=True)
    iters = 10
    sampler.generate(0)
    torch.cuda.synchronize()
    ts = time.perf_counter()
    for i in range(iters):
        sampler.generate(i)
    per_batch = (time.perf_counter() - ts) / iters
    clips_s = BATCH / per_batch
    phase("timing", t0, sampler_batch=BATCH, sampler_ms=per_batch * 1e3,
          clips_per_s=clips_s,
          audio_s_per_s=clips_s * cfg.data.clip_len / cfg.data.sample_rate,
          card=card)

    total = {key: sum(p[key] for p in per_layer)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by_ops = sum(p["bound_ms"] for p in per_layer
                 if p["bound_by"] == "operations")
    print(json.dumps({"kernels": [{
        "name": "convt1d",
        "route": "cuda",
        "source": "audiogan_tpu_torch/csrc/convt1d.cu",
        "replaces": "audiogan_tpu/kernels/conv.py:397",
        "replaces_function": "_convt_pallas (body _rowconv_kernel)",
        "launches": launches,
        "max_abs_err": max(p["max_abs_err"] for p in per_layer),
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": ("operations" if by_ops >= total["bound_ms"] / 2
                     else "bytes"),
        "library_ms": total["library_ms"],
        "per": "one generator forward at batch 64, bf16 (sum of 5 layers)",
        "card": card,
        "layers": per_layer,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
