"""Objective evaluation of a trained generator, the port of
audiogan_tpu/train/evaluate.py (`cli eval`).

A batch of generated clips against a batch of real corpus clips:

  spectral_distance   the multi-resolution batch-mean-spectrum distance
                      (losses.batch_spectral_matching_loss) at the
                      config's stft_resolutions
  rms / rms_real      mean per-clip RMS of fake vs real
  zcr / zcr_real      mean zero-crossing rate
  peak / peak_real    mean per-clip peak amplitude

Deterministic in (checkpoint, seed): the fakes come from the seeded
sampler, the real clips are the first view of the index stream of
(seed, step 0) (the reference's ``HostBatcher(..., n_views=1).get(0)``),
center-cropped and, with mu-law data, expanded.
"""

from __future__ import annotations

import numpy as np
import torch

from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.data.corpus import Corpus, batch_indices
from audiogan_tpu_torch.device import resolve_device
from audiogan_tpu_torch.losses import batch_spectral_matching_loss
from audiogan_tpu_torch.ops.ingest import ingest_batch
from audiogan_tpu_torch.ops.mulaw import mu_law_expand
from audiogan_tpu_torch.train.sample import build_sample_fn


def _stats(x: torch.Tensor) -> dict[str, torch.Tensor]:
    rms = x.square().mean(dim=-1).sqrt()
    zcr = (torch.diff(torch.sign(x), dim=-1).abs() > 0).float().mean(dim=-1)
    peak = x.abs().amax(dim=-1)
    return {"rms": rms.mean(), "zcr": zcr.mean(), "peak": peak.mean()}


@torch.inference_mode()
def evaluate(cfg: Config, params_g: dict[str, torch.Tensor], corpus: Corpus,
             num: int = 64, seed: int = 0, *, z=None, labels=None,
             device=None) -> dict[str, float]:
    """The metrics above, rounded to 6 places and in the order of their
    names (as the reference's jitted dict comes back), for G's state dict
    ``params_g``; on the card unless ``device`` names another. ``z``
    [num, latent_dim] and ``labels`` [num] replace the sampler's draws
    from ``seed`` (tests inject the reference's)."""
    dev = resolve_device(device)
    params = {k: v.to(dev) for k, v in params_g.items()}
    if z is not None:
        z = torch.tensor(np.asarray(z, np.float32))
    if labels is not None:
        labels = torch.tensor(np.asarray(labels))
    fake = build_sample_fn(cfg, dev)(params, seed, labels, num=num, z=z)

    idx = batch_indices(len(corpus), num, 1, seed, 0)[0]
    raw = torch.from_numpy(np.ascontiguousarray(corpus.clips[idx])).to(dev)
    real = ingest_batch(raw, cfg.data)
    if cfg.data.mu_law:
        real = mu_law_expand(real, cfg.data.mu)

    out = {"spectral_distance": batch_spectral_matching_loss(
        fake, real, cfg.model.stft_resolutions)}
    out.update(_stats(fake))
    out.update({f"{k}_real": v for k, v in _stats(real).items()})
    return {k: round(float(out[k]), 6) for k in sorted(out)}
