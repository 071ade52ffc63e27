"""CLI of the port: train a preset's GAN (the WaveGAN or the GRU
generator against the WaveGAN critic, or against the dual wave + STFT
critic), resuming from its workdir's checkpoints; sample / export /
serve / evaluate a generator; pack a wav tree; print a config.

Usage:
    python -m audiogan_tpu_torch.cli train --preset wgan_gp_b64 \\
        --total_steps 1000 --workdir /tmp/run
    python -m audiogan_tpu_torch.cli train --preset cond_gru_sc09 \\
        --total_steps 10 --workdir /tmp/gru
    python -m audiogan_tpu_torch.cli train --preset wgan_gp_b64 \\
        --set model.fused_shuffle_sites=-1 --total_steps 10 --workdir /tmp/f
    python -m audiogan_tpu_torch.cli train --preset dual_stft \\
        --total_steps 10 --workdir /tmp/dual
    python -m audiogan_tpu_torch.cli train --preset music_44k_dp16 \\
        --set mesh.dp=1 --total_steps 10 --workdir /tmp/music
    torchrun --nproc_per_node 4 -m audiogan_tpu_torch.cli train \\
        --preset music_44k_dp16 --set mesh.dp=4 --total_steps 10 \\
        --workdir /tmp/music4
    torchrun --nproc_per_node 4 -m audiogan_tpu_torch.cli train \\
        --preset music_44k_dp16 --set mesh.dp=1 --set mesh.cp=4 \\
        --total_steps 10 --workdir /tmp/music_cp4
    torchrun --nproc_per_node 4 -m audiogan_tpu_torch.cli train \\
        --preset wgan_gp_b64 --set mesh.dp=2 --set mesh.tp=2 \\
        --total_steps 10 --workdir /tmp/flagship_tp2
    torchrun --nproc_per_node 2 -m audiogan_tpu_torch.cli train \\
        --preset tiny_sc09 --set mesh.dp=2 --device cpu --total_steps 2 \\
        --batch_size 2 --workdir /tmp/tiny2
    python -m audiogan_tpu_torch.cli train --preset resample_22k \\
        --total_steps 10 --workdir /tmp/r22k
    python -m audiogan_tpu_torch.cli train --config /tmp/run/config.json \\
        --total_steps 2000 --workdir /tmp/run
    python -m audiogan_tpu_torch.cli eval --workdir /tmp/dual --num 64 \\
        --seed 0
    python -m audiogan_tpu_torch.cli sample --workdir /tmp/run --num 8 \\
        --seed 0
    python -m audiogan_tpu_torch.cli sample --workdir /tmp/gru --step 10 \\
        --seed 0 --labels 0,1,2
    python -m audiogan_tpu_torch.cli export --workdir /tmp/run --num 64
    python -m audiogan_tpu_torch.cli serve --workdir /tmp/run --port 8765
    python -m audiogan_tpu_torch.cli sample --preset wgan_gp_b64 \\
        --init-seed 0 --num 8 --seed 0 --out_dir /tmp/wavs
    python -m audiogan_tpu_torch.cli export --preset wgan_gp_b64 \\
        --weights g.pt --num 64 --out_dir /tmp/art
    python -m audiogan_tpu_torch.cli serve --artifact /tmp/art --port 8765
    python -m audiogan_tpu_torch.cli serve --preset cond_gru_sc09 \\
        --init-seed 0 --num 64 --port 8766
    python -m audiogan_tpu_torch.cli build-corpus --wav_dir data/sc09 \\
        --out_dir data/packed --store_len 16384
    python -m audiogan_tpu_torch.cli info --preset dual_stft
    python -m audiogan_tpu_torch.cli bench --preset wgan_gp_b64
    python -m audiogan_tpu_torch.cli bench --preset all --steps 2

``train`` runs WGAN-GP steps on the synthetic SC09 fixture (or
--data_dir) up to --total_steps (alias --steps; default the preset's
train.total_steps), from the workdir's latest checkpoint unless
--no_resume. It writes ``config.json``, ``ckpt/<step>.pt`` every
train.ckpt_every steps and at the end, ``metrics.jsonl`` and, every
train.sample_every steps, ``samples/``, and prints one JSON line of
metrics per log_every steps. Data, context and tensor parallelism run
one process per card under ``torchrun`` (NCCL; gloo with ``--device
cpu``), mesh.dp times mesh.cp times mesh.tp equal to the number of
processes (with mesh.fsdp, ZeRO-1 over the data axis; with mesh.cp
above 1 each clip's time axis split over cp consecutive ranks,
train/cp_step.py; with mesh.tp above 1 the critic's channels split over
tp consecutive ranks, train/tp_step.py), rank 0 alone printing and
writing; ``music_44k_dp16`` asks for dp=16, so run it on 16 processes
or with ``--set mesh.dp=N`` (and ``--set mesh.cp=M`` or ``--set
mesh.tp=M``) on N M. A mesh of another size than the number of
processes raises ValueError before the card is touched.
``--config PATH`` (a config.json) takes the
place of ``--preset``; ``--set KEY=VALUE`` overrides any config field by
dotted path, as the JAX CLI's does (the flags above it win). ``info``
prints the resolved config's JSON.

The generator of ``sample``, ``export`` and ``serve`` comes from
``--workdir`` (its config.json and latest checkpoint, or ``--step``),
or from ``--preset`` with ``--weights`` (a state dict saved with
torch.save, e.g. converted with convert.params_from_jax) or
``--init-seed`` (random init, as flax initializes). ``sample`` writes to
--out_dir (default <workdir>/generated), ``export`` to --out_dir
(default <workdir>/export). A conditional preset takes ``--labels`` in
``sample`` and ``"labels"`` in a ``/generate`` request. ``eval`` restores
``--workdir``'s latest checkpoint (or ``--step``) and prints one JSON line
of train/evaluate.py's metrics and the ``step``. ``build-corpus`` packs a
wav tree into clips.npy, labels.npy and meta.json. ``bench`` prints the
reference's headline line per preset (train steps/s of the replayed step
on staged clips, audio-seconds/s of the replayed sampler at an HBM-sized
batch; bench.py in this package, run in this process). Everything runs on
the card unless ``--device cpu``.
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


def _load_cfg(args) -> Config:
    """--config's config.json, else --preset's, with the --set items."""
    if args.config:
        cfg = Config.from_json(Path(args.config).read_text())
    else:
        cfg = get_preset(args.preset)
    return apply_overrides(cfg, args.set or [])


def _add_cfg_flags(sp) -> None:
    sp.add_argument("--preset", default="tiny_sc09", choices=sorted(PRESETS))
    sp.add_argument("--config", default=None,
                    help="path to a config.json (overrides --preset)")
    sp.add_argument("--set", action="append", metavar="KEY=VALUE",
                    help="override any config field by dotted path")


def _add_device_flag(sp) -> None:
    sp.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu only if asked)")


def _add_model_flags(sp, *, source_required: bool = True) -> None:
    sp.add_argument("--preset", default=None, choices=sorted(PRESETS),
                    help="with --weights or --init-seed (default tiny_sc09)")
    _add_device_flag(sp)
    src = sp.add_mutually_exclusive_group(required=source_required)
    src.add_argument("--workdir", default=None,
                     help="train workdir: its config and checkpoint")
    src.add_argument("--weights", default=None,
                     help="generator state dict (torch.save)")
    src.add_argument("--init-seed", type=int, default=None,
                     help="random glorot init from this seed")
    sp.add_argument("--step", type=int, default=None,
                    help="checkpoint step, with --workdir (default latest)")


def _load_model(args, device) -> tuple[Config, dict[str, torch.Tensor]]:
    """G's config and state dict on ``device`` from --workdir (and --step)
    or from --preset with --weights or --init-seed."""
    from audiogan_tpu_torch.models import build_generator
    from audiogan_tpu_torch.models.init import init_params
    if args.workdir is not None:
        if args.preset is not None:
            raise SystemExit("--workdir takes its config from the workdir: "
                             "drop --preset")
        from audiogan_tpu_torch.utils import checkpoint as ckpt_lib
        workdir = Path(args.workdir)
        cfg = Config.from_json((workdir / "config.json").read_text())
        mngr = ckpt_lib.make_manager(workdir, keep=cfg.train.keep_ckpts)
        params = ckpt_lib.load(mngr, args.step)["g"]
        return cfg, {k: v.to(device) for k, v in params.items()}
    if args.step is not None:
        raise SystemExit("--step names a checkpoint of --workdir")
    cfg = get_preset(args.preset or "tiny_sc09")
    if args.weights:
        params = torch.load(args.weights, map_location=device,
                            weights_only=True)
    else:
        g = init_params(build_generator(cfg, device=device), args.init_seed)
        params = g.state_dict()
    return cfg, params


def _out_dir(args, default: str) -> Path:
    if args.out_dir is not None:
        return Path(args.out_dir)
    if args.workdir is None:
        raise SystemExit("--out_dir is needed without --workdir")
    return Path(args.workdir) / default


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="audiogan_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("sample", help="generate wavs")
    _add_model_flags(s)
    s.add_argument("--num", type=int, default=8)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--labels", default=None,
                   help="comma-separated class labels (conditional models)")
    s.add_argument("--out_dir", default=None,
                   help="default <workdir>/generated")

    x = sub.add_parser("export", help="write a sampler artifact")
    _add_model_flags(x)
    x.add_argument("--num", type=int, default=8,
                   help="serving batch of the artifact")
    x.add_argument("--out_dir", default=None,
                   help="default <workdir>/export")

    t = sub.add_parser("train", help="train, resuming from the workdir")
    _add_cfg_flags(t)
    _add_device_flag(t)
    t.add_argument("--total_steps", "--steps", dest="total_steps", type=int,
                   default=None, help="train up to this step (default: the "
                   "config's train.total_steps)")
    t.add_argument("--no_resume", action="store_true",
                   help="start from step 0 even if ckpt/ holds a step")
    t.add_argument("--no_tensorboard", action="store_true",
                   help="write no TensorBoard scalars")
    t.add_argument("--workdir", required=True)
    t.add_argument("--data_dir", default=None,
                   help="wav tree or packed corpus (default: synthetic)")
    t.add_argument("--batch_size", type=int, default=None)
    t.add_argument("--log_every", type=int, default=None)
    t.add_argument("--seed", type=int, default=None)

    v = sub.add_parser("serve", help="HTTP inference server")
    v.add_argument("--artifact", default=None,
                   help="artifact dir written by `export`; instead, "
                        "--workdir or --preset (with --weights or "
                        "--init-seed) exports in memory, then serves")
    _add_model_flags(v, source_required=False)
    v.add_argument("--num", type=int, default=8,
                   help="serving batch when exporting in memory")
    v.add_argument("--host", default="127.0.0.1")
    v.add_argument("--port", type=int, default=8765)

    e = sub.add_parser("eval", help="objective metrics: generated vs "
                                    "corpus")
    e.add_argument("--workdir", required=True)
    e.add_argument("--num", type=int, default=64)
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default latest)")
    _add_device_flag(e)

    b = sub.add_parser("build-corpus", help="pack a wav tree into a corpus")
    b.add_argument("--wav_dir", required=True)
    b.add_argument("--out_dir", required=True)
    b.add_argument("--store_len", type=int, required=True)

    i = sub.add_parser("info", help="print the resolved config")
    _add_cfg_flags(i)

    from audiogan_tpu_torch import bench
    bench.add_flags(sub.add_parser("bench",
                                   help="run the headline benchmark"))

    args = p.parse_args(argv)

    if args.cmd == "bench":
        return bench.run(args)

    if args.cmd == "info":
        print(_load_cfg(args).validate().to_json())
        return 0

    if args.cmd == "build-corpus":
        from audiogan_tpu_torch.data.corpus import build_corpus
        print(build_corpus(args.wav_dir, args.out_dir, args.store_len,
                           say=lambda s: print(s, file=sys.stderr)))
        return 0

    if args.cmd == "train":
        from audiogan_tpu_torch.train.loop import check_ported, train
        cfg = _load_cfg(args)
        tr = {k: v for k, v in (("batch_size", args.batch_size),
                                ("log_every", args.log_every),
                                ("seed", args.seed),
                                ("total_steps", args.total_steps))
              if v is not None}
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **tr))
        if args.data_dir is not None:
            cfg = cfg.replace(data=dataclasses.replace(
                cfg.data, data_dir=args.data_dir))
        # before the card is touched
        check_ported(cfg.validate(), args.device)
        try:
            train(cfg, args.workdir, resume=not args.no_resume,
                  device=resolve_device(args.device),
                  log=lambda line: print(line, flush=True),
                  tensorboard=not args.no_tensorboard)
        except Exception:
            if torch.distributed.is_initialized() and \
                    torch.distributed.get_world_size() > 1:
                from audiogan_tpu_torch.parallel.multihost import \
                    exit_after_failure
                exit_after_failure()
            raise
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
        return 0

    device = resolve_device(args.device)

    if args.cmd == "sample":
        import numpy as np

        from audiogan_tpu_torch.data.wavio import write_wav
        from audiogan_tpu_torch.train.sample import generate
        out = _out_dir(args, "generated")
        cfg, params = _load_model(args, device)
        labels = (np.array([int(v) for v in args.labels.split(",")])
                  if args.labels else None)
        num = len(labels) if labels is not None else args.num
        waves = generate(cfg, params, num, args.seed, labels, device=device)
        out.mkdir(parents=True, exist_ok=True)
        for j, w in enumerate(waves):
            tag = f"_y{labels[j]}" if labels is not None else ""
            path = out / f"gen_seed{args.seed}_{j}{tag}.wav"
            write_wav(path, cfg.data.sample_rate, w)
            print(path)
        return 0

    if args.cmd == "eval":
        from audiogan_tpu_torch.train.evaluate import evaluate
        from audiogan_tpu_torch.train.loop import resolve_corpus
        from audiogan_tpu_torch.utils import checkpoint as ckpt_lib
        workdir = Path(args.workdir)
        cfg = Config.from_json((workdir / "config.json").read_text())
        mngr = ckpt_lib.make_manager(workdir, keep=cfg.train.keep_ckpts)
        blob = ckpt_lib.load(mngr, args.step)
        out = evaluate(cfg, blob["g"], resolve_corpus(cfg, workdir),
                       num=args.num, seed=args.seed, device=device)
        out["step"] = int(blob["step"])
        print(json.dumps(out))
        return 0

    if args.cmd == "export":
        from audiogan_tpu_torch.serve import export_sampler
        out = _out_dir(args, "export")
        cfg, params = _load_model(args, device)
        print(export_sampler(cfg, params, args.num, out))
        return 0

    if args.cmd == "serve":
        import shutil
        import tempfile

        from audiogan_tpu_torch.serve import (export_sampler, load_sampler,
                                              make_server)
        in_memory = (args.workdir, args.weights, args.init_seed) != \
            (None, None, None)
        if (args.artifact is None) != in_memory or (
                args.artifact and args.preset):
            raise SystemExit("serve needs exactly one of --artifact, "
                             "--workdir, or --preset with --weights or "
                             "--init-seed")
        art, tmp = args.artifact, None
        if in_memory:
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
              f"{sampler.device}, {sampler.route})", flush=True)
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
