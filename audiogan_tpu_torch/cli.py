"""CLI of the port: sample / export / serve the WaveGAN generator.

Usage:
    python -m audiogan_tpu_torch.cli sample --preset wgan_gp_b64 \\
        --init-seed 0 --num 8 --seed 0 --out_dir /tmp/wavs
    python -m audiogan_tpu_torch.cli export --preset wgan_gp_b64 \\
        --weights state.pt --num 64 --out_dir /tmp/art
    python -m audiogan_tpu_torch.cli serve --artifact /tmp/art --port 8765

Weights come from ``--weights`` (a state dict saved with torch.save, e.g.
converted with convert.params_from_jax) or from ``--init-seed`` (random
glorot init). Everything runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from audiogan_tpu_torch.config import PRESETS, Config, get_preset
from audiogan_tpu_torch.device import resolve_device


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

    v = sub.add_parser("serve", help="HTTP inference server")
    v.add_argument("--artifact", required=True,
                   help="artifact dir written by `export`")
    _add_device_flag(v)
    v.add_argument("--host", default="127.0.0.1")
    v.add_argument("--port", type=int, default=8765)

    args = p.parse_args(argv)
    device = resolve_device(args.device)

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
        from audiogan_tpu_torch.serve import load_sampler, make_server
        sampler = load_sampler(args.artifact, device)
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
