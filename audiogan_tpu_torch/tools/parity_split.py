#!/usr/bin/env python3
"""Splits the generator-gradient error of chip_smoke.py's f32 parity step
(card vs CPU) into the part that the critics' final weights cause and the
part that the two sides' arithmetic causes.

    python3 audiogan_tpu_torch/tools/parity_split.py

For dual_stft and wgan_gp_b64 (f32, batch 2): the parity phase's state
(one warm step on the card, copied to the CPU) and step, then G's update
gradient recomputed from G's weights before the step, term by term (the
critic's score; with the spectral term, the batch spectral-matching
loss): on the card with the card's critic, on the CPU with the CPU's,
and on the CPU with the card's critic weights. Prints one JSON line: per
preset and term the relative L2 error card vs CPU, the part the critic's
weights alone give (CPU with the card's weights vs CPU), the part the
arithmetic alone gives (card vs CPU with the card's weights), the term's
norm, and the critics' largest parameter difference.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


def split(preset: str, dev: torch.device) -> dict:
    from audiogan_tpu_torch.config import get_preset
    from audiogan_tpu_torch.losses import (batch_spectral_matching_loss,
                                           wgan_g_loss)
    from audiogan_tpu_torch.ops.ingest import ingest_batch
    from audiogan_tpu_torch.train.state import create_train_state
    from audiogan_tpu_torch.tools.step_checks import random_raw
    from audiogan_tpu_torch.train.step import (build_train_step, draw_step,
                                               num_views)
    cpu = torch.device("cpu")
    cfg = get_preset(preset)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, dtype="float32", batch_size=2))
    nv = num_views(cfg)
    card = create_train_state(cfg, device=dev)
    step_card = build_train_step(cfg, dev)
    step_card(card, *random_raw(cfg, nv, 2, seed=10))
    g_warm = {k: v.cpu().clone() for k, v in card.g.state_dict().items()}
    host = create_train_state(cfg, device=cpu)
    for src, dst in ((card.g, host.g), (card.d, host.d)):
        dst.load_state_dict({k: v.cpu() for k, v in src.state_dict().items()})
    for (src, smod), (dst, dmod) in (((card.opt_g, card.g),
                                      (host.opt_g, host.g)),
                                     ((card.opt_d, card.d),
                                      (host.opt_d, host.d))):
        for ps, pd in zip(smod.parameters(), dmod.parameters()):
            dst.state[pd] = {k: v.detach().cpu().clone()
                             for k, v in src.state[ps].items()}
    host.step = card.step
    draws = draw_step(cfg, card.seed, card.step, 2, cpu)
    raw1, lab1 = random_raw(cfg, nv, 2, seed=11)
    step_card(card, raw1, lab1, draws=draws)
    build_train_step(cfg, cpu)(host, raw1, lab1, draws=draws)
    out = {"step_g_grad": rel(
        torch.cat([p.grad.flatten() for p in card.g.parameters()]),
        torch.cat([p.grad.flatten() for p in host.g.parameters()]))}
    dr = draws["generator"]
    d_card_on_cpu = copy.deepcopy(host.d)
    d_card_on_cpu.load_state_dict({k: v.cpu()
                                   for k, v in card.d.state_dict().items()})
    g_cpu = copy.deepcopy(host.g)
    g_cpu.load_state_dict(g_warm)
    g_dev = copy.deepcopy(card.g)
    g_dev.load_state_dict({k: v.to(dev) for k, v in g_warm.items()})
    real = (ingest_batch(raw1[-1], cfg.data, offsets=dr["offsets"])
            if "offsets" in dr else None)

    def grads(g, d, where, term):
        fake = g(dr["z"].to(where))
        if term == "loss":
            loss = batch_spectral_matching_loss(
                fake[..., 0], real.to(where), cfg.model.stft_resolutions)
        else:
            loss = wgan_g_loss(d(fake, None, dr["shifts"].to(where)))
        return torch.cat([q.flatten().cpu() for q in torch.autograd.grad(
            loss, list(g.parameters()))])
    for term in ("critic", "loss") if real is not None else ("critic",):
        on_card = grads(g_dev, card.d, dev, term)
        on_cpu = grads(g_cpu, host.d, cpu, term)
        card_weights = grads(g_cpu, d_card_on_cpu, cpu, term)
        out[term] = {"card_vs_cpu": rel(on_card, on_cpu),
                     "critic_weights_only": rel(card_weights, on_cpu),
                     "arithmetic_only": rel(on_card, card_weights),
                     "norm": float(on_cpu.norm())}
    out["d_param_max_abs"] = max(
        float((p.detach().cpu() - q.detach()).abs().max())
        for p, q in zip(card.d.parameters(), host.d.parameters()))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("parity_split: no CUDA device", file=sys.stderr)
        return 1
    # the parity phase's f32: no TF32 on either library
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      **{p: split(p, dev)
                         for p in ("dual_stft", "wgan_gp_b64")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
