"""On-device ingest: int16 store rows -> f32 clips for the critic.

Port of audiogan_tpu/ops/ingest.py on the identity-resample path. Order
(SPEC I1): int16/32768 -> crop (random in training, center in eval,
zero-pad if short) -> amplitude normalization -> mu-law. A training batch
goes through the fused ingest kernel (kernels/ingest.py); the eval center
crop takes the plain ops. A resample (source_rate != sample_rate) is not
ported yet and raises.
"""

from __future__ import annotations

import torch

from audiogan_tpu_torch.config import DataCfg
from audiogan_tpu_torch.kernels.ingest import ingest_fused
from audiogan_tpu_torch.ops.framing import center_crop, crop_offsets
from audiogan_tpu_torch.ops.mulaw import mu_law_compand
from audiogan_tpu_torch.ops.normalize import normalize_amplitude


def ingest_batch(raw: torch.Tensor, cfg: DataCfg,
                 gen: torch.Generator | None = None,
                 offsets: torch.Tensor | None = None) -> torch.Tensor:
    """raw int16 [B, store_len] -> float32 [B, clip_len] on raw's device.

    Training: crop offsets ~ U{0..store-clip} from ``gen``, or the given
    ``offsets`` (tests inject the reference's). Eval (neither given): the
    deterministic center crop.
    """
    if cfg.sample_rate != cfg.source_rate:
        raise NotImplementedError(
            "resampling ingest (source_rate != sample_rate) is not ported "
            "to audiogan_tpu_torch yet")
    mu = cfg.mu if cfg.mu_law else 0.0
    if gen is None and offsets is None:
        x = center_crop(raw.float() / 32768.0, cfg.clip_len)
        x = normalize_amplitude(x, cfg.normalize, cfg.norm_target)
        return mu_law_compand(x, mu) if mu else x
    if offsets is None:
        max_off = max(raw.shape[-1] - cfg.clip_len, 0)
        offsets = crop_offsets(gen, raw.shape[0], max_off, device=raw.device)
    offsets = offsets.to(device=raw.device, dtype=torch.int32).contiguous()
    return ingest_fused(raw.contiguous(), offsets, cfg.clip_len,
                        cfg.normalize, cfg.norm_target, mu)
