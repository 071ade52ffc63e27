"""Typed config tree: the port's own copy of the JAX package's dataclasses.

The fields, their defaults and the JSON form are those of
``audiogan_tpu/config.py``, so a ``config.json`` or an exported
``meta.json`` written by either package loads in the other. The port
serves the WaveGAN generator only; training fields are carried so the
JSON round-trips, and are read by later parts of the port.

Presets: ``tiny_sc09`` (CPU-sized) and ``wgan_gp_b64`` (the flagship).
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class DataCfg:
    data_dir: str = ""
    sample_rate: int = 16000        # model rate (Hz)
    source_rate: int = 16000        # corpus rate (Hz)
    clip_len: int = 16384           # samples per generated clip
    store_len: int = 16384
    mu_law: bool = True             # G's output is mu-law companded audio
    mu: float = 255.0
    normalize: str = "peak"
    norm_target: float = 0.999
    num_classes: int = 0            # 0 = unconditional
    resample_taps_per_phase: int = 10
    resample_beta: float = 5.0
    device_corpus: bool = False
    device_corpus_shard: str = "auto"
    index_chunk: int = 512


@dataclass(frozen=True)
class ModelCfg:
    generator: str = "wavegan"      # wavegan | gru
    latent_dim: int = 100
    model_dim: int = 64             # channel base d; G top width d * 2**(L-1)
    kernel_size: int = 25
    strides: tuple[int, ...] = (4, 4, 4, 4, 4)
    phase_shuffle: int = 2
    fused_shuffle_sites: int = 0
    shuffle_impl: str = ""
    use_stft_critic: bool = False
    stft_resolutions: tuple[tuple[int, int, int], ...] = (
        (512, 128, 512), (1024, 256, 1024), (2048, 512, 2048),
    )
    gru_frame_size: int = 64
    gru_hidden: int = 512
    embed_dim: int = 64             # label embedding width
    max_channels: int = 1024        # cap on the widest conv layer

    @property
    def total_stride(self) -> int:
        return math.prod(self.strides)


@dataclass(frozen=True)
class LossCfg:
    gp_lambda: float = 10.0
    n_critic: int = 5
    stft_loss_weight: float = 0.0
    drift_epsilon: float = 0.0
    gp_batch_chunks: int = 1


@dataclass(frozen=True)
class TrainCfg:
    batch_size: int = 64
    lr_g: float = 1e-4
    lr_d: float = 1e-4
    beta1: float = 0.5
    beta2: float = 0.9
    total_steps: int = 200_000
    log_every: int = 50
    ckpt_every: int = 1000
    sample_every: int = 2000
    keep_ckpts: int = 3
    seed: int = 0
    remat_discriminator: bool = False
    scan_unroll: int = 5
    kernels: str = "xla"
    kernels_g: str = ""
    kernels_d: str = ""
    kernels_ingest: str = ""
    wgrad_form: str = ""
    fused_d_views: bool = False
    dtype: str = "float32"          # compute dtype of the conv stacks
    profile_dir: str = ""
    profile_steps: tuple[int, int] = (5, 10)
    dump_hlo: bool = False
    debug_nans: bool = False


@dataclass(frozen=True)
class MeshCfg:
    dp: int = 1
    cp: int = 1
    tp: int = 1
    fsdp: bool = False


DTYPES = ("float32", "bfloat16")


@dataclass(frozen=True)
class Config:
    name: str = "default"
    data: DataCfg = field(default_factory=DataCfg)
    model: ModelCfg = field(default_factory=ModelCfg)
    loss: LossCfg = field(default_factory=LossCfg)
    train: TrainCfg = field(default_factory=TrainCfg)
    mesh: MeshCfg = field(default_factory=MeshCfg)

    def validate(self) -> "Config":
        """Checks the fields the generator and the sampler read."""
        d, m = self.data, self.model
        if m.generator not in ("wavegan", "gru"):
            raise ValueError(f"model.generator={m.generator!r} "
                             "not in wavegan|gru")
        if m.generator == "wavegan" and d.clip_len % m.total_stride != 0:
            raise ValueError(
                f"clip_len={d.clip_len} not divisible by total stride "
                f"{m.total_stride} (strides={m.strides})")
        if min(m.strides) < 1 or m.kernel_size < 1:
            raise ValueError("strides and kernel_size must be >= 1")
        if d.num_classes < 0:
            raise ValueError("data.num_classes must be >= 0")
        if self.train.dtype not in DTYPES:
            raise ValueError(f"train.dtype={self.train.dtype!r} "
                             f"not in {'|'.join(DTYPES)}")
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_json(s: str) -> "Config":
        raw = json.loads(s)
        return Config(
            name=raw.get("name", "default"),
            data=_build(DataCfg, raw.get("data", {})),
            model=_build(ModelCfg, raw.get("model", {})),
            loss=_build(LossCfg, raw.get("loss", {})),
            train=_build(TrainCfg, raw.get("train", {})),
            mesh=_build(MeshCfg, raw.get("mesh", {})),
        )

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


def _build(cls, raw: dict):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in raw:
            v = raw[f.name]
            if isinstance(v, list):
                v = tuple(tuple(e) if isinstance(e, list) else e for e in v)
            kw[f.name] = v
    return cls(**kw)


def tiny_sc09() -> Config:
    """Tiny unconditional WaveGAN on SC09-shaped clips, batch 8, CPU-sized."""
    return Config(
        name="tiny_sc09",
        data=DataCfg(num_classes=0, device_corpus=True),
        model=ModelCfg(generator="wavegan", model_dim=16, max_channels=256),
        loss=LossCfg(n_critic=2),
        train=TrainCfg(batch_size=8, total_steps=2000, log_every=10),
    ).validate()


def wgan_gp_b64() -> Config:
    """Flagship: WaveGAN d=64, five k=25/s=4 layers, bf16 compute."""
    return Config(
        name="wgan_gp_b64",
        data=DataCfg(num_classes=0, device_corpus=True),
        model=ModelCfg(generator="wavegan", model_dim=64,
                       fused_shuffle_sites=0, shuffle_impl="prim"),
        loss=LossCfg(n_critic=5),
        train=TrainCfg(batch_size=64, kernels="auto", wgrad_form="conv",
                       dtype="bfloat16", fused_d_views=True),
    ).validate()


PRESETS = {
    "tiny_sc09": tiny_sc09,
    "wgan_gp_b64": wgan_gp_b64,
}


def get_preset(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]()
