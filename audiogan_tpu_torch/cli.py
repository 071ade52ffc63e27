"""CLI of the port: train a preset's GAN (the WaveGAN or the GRU
generator against the WaveGAN critic); sample / export / serve its
generator.

Usage:
    python -m audiogan_tpu_torch.cli train --preset wgan_gp_b64 --steps 10 \\
        --workdir /tmp/run
    python -m audiogan_tpu_torch.cli train --preset cond_gru_sc09 \\
        --steps 10 --workdir /tmp/gru
    python -m audiogan_tpu_torch.cli train --preset wgan_gp_b64 \\
        --set model.fused_shuffle_sites=-1 --steps 10 --workdir /tmp/fused
    python -m audiogan_tpu_torch.cli sample --preset cond_gru_sc09 \\
        --init-seed 0 --seed 0 --labels 0,1,2 --out_dir /tmp/wavs
    python -m audiogan_tpu_torch.cli sample --preset wgan_gp_b64 \\
        --init-seed 0 --num 8 --seed 0 --out_dir /tmp/wavs
    python -m audiogan_tpu_torch.cli export --preset wgan_gp_b64 \\
        --weights state.pt --num 64 --out_dir /tmp/art
    python -m audiogan_tpu_torch.cli serve --artifact /tmp/art --port 8765
    python -m audiogan_tpu_torch.cli serve --preset cond_gru_sc09 \\
        --init-seed 0 --num 64 --port 8766

``train`` takes --steps WGAN-GP steps from a fresh seeded init on the
synthetic SC09 fixture (or --data_dir), printing one JSON line of metrics
per log_every steps; ``--set KEY=VALUE`` overrides any config field by
dotted path, as the JAX CLI's does (the flags above it win). Weights for the others come from ``--weights`` (a
state dict saved with torch.save, e.g. converted with
convert.params_from_jax) or from ``--init-seed`` (random init, as flax
initializes). A conditional preset takes ``--labels`` in ``sample`` and
``"labels"`` in a ``/generate`` request. Everything runs on the card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

from audiogan_tpu_torch.config import PRESETS, Config, get_preset
from audiogan_tpu_torch.device import resolve_device


def _coerce(old, raw: str):
    """raw as the type of the field's current value (audiogan_tpu/cli.py
    _coerce)."""
    if isinstance(old, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(old, int):
        return int(raw)
    if isinstance(old, float):
        return float(raw)
    if isinstance(old, tuple):
        return tuple(json.loads(raw))
    return raw


def apply_overrides(cfg: Config, sets: list[str]) -> Config:
    """Each KEY=VALUE sets the config field at dotted path KEY, rebuilding
    the frozen dataclasses above it (audiogan_tpu/cli.py apply_overrides).
    A malformed item, an unknown key or a value of the wrong type exits."""
    for item in sets:
        key, eq, raw = item.partition("=")
        if not eq:
            raise SystemExit(f"--set expects key=value, got {item!r}")
        parts = key.split(".")
        objs = [cfg]
        try:
            for p in parts[:-1]:
                objs.append(getattr(objs[-1], p))
            old = getattr(objs[-1], parts[-1])
            val = _coerce(old, raw)
        except (AttributeError, ValueError, TypeError) as e:
            raise SystemExit(f"--set {item!r}: {e}") from None
        if not dataclasses.is_dataclass(objs[-1]) or \
                dataclasses.is_dataclass(old):
            raise SystemExit(f"--set {item!r}: {key} is not a config field")
        new = dataclasses.replace(objs[-1], **{parts[-1]: val})
        for obj, name in zip(reversed(objs[:-1]), reversed(parts[:-1])):
            new = dataclasses.replace(obj, **{name: new})
        cfg = new
    return cfg


def _add_device_flag(sp) -> None:
    sp.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu only if asked)")


def _add_model_flags(sp) -> None:
    sp.add_argument("--preset", default="tiny_sc09", choices=sorted(PRESETS))
    _add_device_flag(sp)
    src = sp.add_mutually_exclusive_group(required=True)
    src.add_argument("--weights", default=None,
                     help="generator state dict (torch.save)")
    src.add_argument("--init-seed", type=int, default=None,
                     help="random glorot init from this seed")


def _load_model(args, device) -> tuple[Config, dict[str, torch.Tensor]]:
    from audiogan_tpu_torch.models import build_generator
    from audiogan_tpu_torch.models.init import init_params
    cfg = get_preset(args.preset)
    if args.weights:
        params = torch.load(args.weights, map_location=device,
                            weights_only=True)
    else:
        g = init_params(build_generator(cfg, device=device), args.init_seed)
        params = g.state_dict()
    return cfg, params


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="audiogan_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("sample", help="generate wavs")
    _add_model_flags(s)
    s.add_argument("--num", type=int, default=8)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--labels", default=None,
                   help="comma-separated class labels (conditional models)")
    s.add_argument("--out_dir", required=True)

    x = sub.add_parser("export", help="write a sampler artifact")
    _add_model_flags(x)
    x.add_argument("--num", type=int, default=8,
                   help="serving batch of the artifact")
    x.add_argument("--out_dir", required=True)

    t = sub.add_parser("train", help="train from a fresh init")
    t.add_argument("--preset", default="tiny_sc09", choices=sorted(PRESETS))
    _add_device_flag(t)
    t.add_argument("--steps", type=int, required=True)
    t.add_argument("--workdir", required=True)
    t.add_argument("--data_dir", default=None,
                   help="wav tree or packed corpus (default: synthetic)")
    t.add_argument("--batch_size", type=int, default=None)
    t.add_argument("--log_every", type=int, default=None)
    t.add_argument("--seed", type=int, default=None)
    t.add_argument("--set", action="append", metavar="KEY=VALUE",
                   help="override any config field by dotted path")

    v = sub.add_parser("serve", help="HTTP inference server")
    v.add_argument("--artifact", default=None,
                   help="artifact dir written by `export`")
    v.add_argument("--preset", default=None, choices=sorted(PRESETS),
                   help="instead of --artifact: export this preset's G in "
                        "memory (--weights or --init-seed), then serve")
    v.add_argument("--weights", default=None,
                   help="generator state dict (torch.save), with --preset")
    v.add_argument("--init-seed", type=int, default=None,
                   help="random init from this seed, with --preset")
    v.add_argument("--num", type=int, default=8,
                   help="serving batch when exporting from --preset")
    _add_device_flag(v)
    v.add_argument("--host", default="127.0.0.1")
    v.add_argument("--port", type=int, default=8765)

    args = p.parse_args(argv)
    device = resolve_device(args.device)

    if args.cmd == "train":
        from audiogan_tpu_torch.train.loop import train
        cfg = apply_overrides(get_preset(args.preset), args.set or [])
        tr = {k: v for k, v in (("batch_size", args.batch_size),
                                ("log_every", args.log_every),
                                ("seed", args.seed)) if v is not None}
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **tr))
        if args.data_dir is not None:
            cfg = cfg.replace(data=dataclasses.replace(
                cfg.data, data_dir=args.data_dir))
        train(cfg.validate(), args.workdir, args.steps, device=device,
              log=lambda line: print(line, flush=True))
        return 0

    if args.cmd == "sample":
        import numpy as np

        from audiogan_tpu_torch.data.wavio import write_wav
        from audiogan_tpu_torch.train.sample import generate
        cfg, params = _load_model(args, device)
        labels = (np.array([int(v) for v in args.labels.split(",")])
                  if args.labels else None)
        num = len(labels) if labels is not None else args.num
        waves = generate(cfg, params, num, args.seed, labels, device=device)
        out = Path(args.out_dir)
        out.mkdir(parents=True, exist_ok=True)
        for j, w in enumerate(waves):
            tag = f"_y{labels[j]}" if labels is not None else ""
            path = out / f"gen_seed{args.seed}_{j}{tag}.wav"
            write_wav(path, cfg.data.sample_rate, w)
            print(path)
        return 0

    if args.cmd == "export":
        from audiogan_tpu_torch.serve import export_sampler
        cfg, params = _load_model(args, device)
        print(export_sampler(cfg, params, args.num, args.out_dir))
        return 0

    if args.cmd == "serve":
        import shutil
        import tempfile

        from audiogan_tpu_torch.serve import (export_sampler, load_sampler,
                                              make_server)
        if (args.artifact is None) == (args.preset is None):
            raise SystemExit("serve needs exactly one of --artifact or "
                             "--preset")
        art, tmp = args.artifact, None
        if args.preset:
            if (args.weights is None) == (args.init_seed is None):
                raise SystemExit("serve --preset needs exactly one of "
                                 "--weights or --init-seed")
            cfg, params = _load_model(args, device)
            tmp = tempfile.mkdtemp(prefix="audiogan_torch_export_")
            art = export_sampler(cfg, params, args.num, tmp)
        try:
            sampler = load_sampler(art, device)
        finally:
            if tmp:
                shutil.rmtree(tmp, ignore_errors=True)
        srv = make_server(sampler, host=args.host, port=args.port)
        host, port = srv.server_address[:2]
        print(f"[serve] {sampler.meta.get('model')} on http://{host}:{port} "
              f"(batch {sampler.num}, {sampler.sample_rate} Hz, "
              f"{sampler.device})", flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.server_close()
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
