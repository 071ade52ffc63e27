"""On-device ingest: int16 store rows -> f32 clips for the critic.

Port of audiogan_tpu/ops/ingest.py. Order (SPEC I1): int16/32768 ->
polyphase resample source -> model rate (skipped when the rates match)
-> crop (random in training, center in eval, zero-pad if short) ->
amplitude normalization -> mu-law.

Which route a batch takes follows the reference (its ``ingest_batch``
uses the fused kernel only for a training batch at identity rates): a
training batch at identity rates goes through the fused ingest kernel
(kernels/ingest.py, K2); a batch whose rates differ, and the eval center
crop, take plain torch ops (ops/resample.py for the rate conversion),
on the card as on the CPU.
"""

from __future__ import annotations

import torch

from audiogan_tpu_torch.config import DataCfg
from audiogan_tpu_torch.kernels.ingest import ingest_fused
from audiogan_tpu_torch.ops.framing import center_crop, crop_offsets, crop_rows
from audiogan_tpu_torch.ops.mulaw import mu_law_compand
from audiogan_tpu_torch.ops.normalize import normalize_amplitude
from audiogan_tpu_torch.ops.resample import resample_poly


def crop_slack(cfg: DataCfg) -> int:
    """The largest training crop offset: the model-rate store row's length
    (after the resample) minus the clip, at least 0."""
    return max(cfg.resampled_len - cfg.clip_len, 0)


def ingest_batch(raw: torch.Tensor, cfg: DataCfg,
                 gen: torch.Generator | None = None,
                 offsets: torch.Tensor | None = None) -> torch.Tensor:
    """raw int16 [B, store_len] -> float32 [B, clip_len] on raw's device.

    Training: crop offsets ~ U{0..crop_slack(cfg)} from ``gen``, or the
    given ``offsets`` (tests inject the reference's). Eval (neither
    given): the deterministic center crop.
    """
    mu = cfg.mu if cfg.mu_law else 0.0
    train = gen is not None or offsets is not None
    if train and offsets is None:
        offsets = crop_offsets(gen, raw.shape[0], crop_slack(cfg),
                               device=raw.device)
    if train and cfg.sample_rate == cfg.source_rate:
        offsets = offsets.to(device=raw.device,
                             dtype=torch.int32).contiguous()
        return ingest_fused(raw.contiguous(), offsets, cfg.clip_len,
                            cfg.normalize, cfg.norm_target, mu)
    x = resample_poly(raw.float() / 32768.0, cfg.sample_rate,
                      cfg.source_rate, cfg.resample_taps_per_phase,
                      cfg.resample_beta)
    if train:
        x = crop_rows(x, offsets, cfg.clip_len)
    else:
        x = center_crop(x, cfg.clip_len)
    x = normalize_amplitude(x, cfg.normalize, cfg.norm_target)
    return mu_law_compand(x, mu) if mu else x
