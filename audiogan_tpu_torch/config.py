"""Typed config tree: the port's own copy of the JAX package's dataclasses.

The fields, their defaults and the JSON form are those of
``audiogan_tpu/config.py``, so a ``config.json`` or an exported
``meta.json`` written by either package loads in the other. Fields of
parts not ported yet (meshes, the JAX kernel tiers) are carried so the
JSON round-trips, and ``validate`` rejects what the reference's
``validate`` rejects. Every mesh axis runs (dp, fsdp, cp, tp) over a
process group, one process per card (``parallel/``).

Presets, each equal in JSON to the reference's: ``tiny_sc09``
(CPU-sized), ``wgan_gp_b64`` (the flagship), ``cond_gru_sc09`` (the
class-conditional GRU generator), ``dual_stft`` (the flagship's G
against the wave and STFT critics, with G's multi-resolution spectral
term), ``resample_22k`` (a 22050 Hz corpus resampled to the 16 kHz model
in the ingest) and ``music_44k_dp16`` (4 s clips at 44.1 kHz, strides
7/7/5/5/3; its mesh asks for dp=16: sixteen processes, or fewer with
``--set mesh.dp=N``).
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

    @property
    def resampled_len(self) -> int:
        """Length of a store_len clip after source->model rate conversion."""
        up, down = _ratio(self.sample_rate, self.source_rate)
        return -(-self.store_len * up // down)  # ceil


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
KERNEL_TIERS = ("xla", "pallas", "auto")


@dataclass(frozen=True)
class Config:
    name: str = "default"
    data: DataCfg = field(default_factory=DataCfg)
    model: ModelCfg = field(default_factory=ModelCfg)
    loss: LossCfg = field(default_factory=LossCfg)
    train: TrainCfg = field(default_factory=TrainCfg)
    mesh: MeshCfg = field(default_factory=MeshCfg)

    def validate(self) -> "Config":
        """Rejects what audiogan_tpu/config.py's validate rejects, and a
        generator or dtype the port does not know."""
        d, m, t, mesh = self.data, self.model, self.train, self.mesh
        if m.generator not in ("wavegan", "gru"):
            raise ValueError(f"model.generator={m.generator!r} "
                             "not in wavegan|gru")
        if m.generator == "wavegan" and d.clip_len % m.total_stride != 0:
            raise ValueError(
                f"clip_len={d.clip_len} not divisible by total stride "
                f"{m.total_stride} (strides={m.strides})")
        if m.generator == "gru" and d.clip_len % m.gru_frame_size != 0:
            raise ValueError(f"clip_len={d.clip_len} not divisible by "
                             f"gru_frame_size={m.gru_frame_size}")
        if min(m.strides) < 1 or m.kernel_size < 1:
            raise ValueError("strides and kernel_size must be >= 1")
        if d.num_classes < 0:
            raise ValueError("data.num_classes must be >= 0")
        if t.dtype not in DTYPES:
            raise ValueError(f"train.dtype={t.dtype!r} "
                             f"not in {'|'.join(DTYPES)}")
        if d.resampled_len < d.clip_len:
            raise ValueError(
                f"resampled corpus clips ({d.resampled_len}) shorter than "
                f"clip_len ({d.clip_len}); increase store_len")
        if t.batch_size % mesh.dp != 0:
            raise ValueError("batch_size must be divisible by mesh.dp")
        for f in ("kernels", "kernels_g", "kernels_d", "kernels_ingest"):
            allowed = KERNEL_TIERS if f == "kernels" else ("",) + KERNEL_TIERS
            if getattr(t, f) not in allowed:
                raise ValueError(f"train.{f}={getattr(t, f)!r} "
                                 "not in xla|pallas|auto")
        if m.fused_shuffle_sites < -1:
            raise ValueError("model.fused_shuffle_sites must be >= -1")
        if m.shuffle_impl not in ("", "gather", "select", "prim"):
            raise ValueError(f"model.shuffle_impl={m.shuffle_impl!r} "
                             "not in gather|select|prim")
        if d.device_corpus_shard not in ("auto", "replicate", "shard"):
            raise ValueError(
                f"data.device_corpus_shard={d.device_corpus_shard!r} "
                "not in auto|replicate|shard")
        if d.index_chunk < 0:
            raise ValueError("data.index_chunk must be >= 0")
        if t.wgrad_form not in ("", "einsum", "conv"):
            raise ValueError(f"train.wgrad_form={t.wgrad_form!r} "
                             "not in einsum|conv")
        self._validate_mesh()
        return self

    def _validate_mesh(self) -> None:
        """The cp/tp geometry checks of audiogan_tpu/config.py:242-292."""
        d, m, mesh = self.data, self.model, self.mesh
        if d.clip_len % mesh.cp != 0:
            raise ValueError("clip_len must be divisible by mesh.cp")
        if mesh.tp > 1:
            if mesh.cp > 1:
                raise ValueError("tp>1 with cp>1 is not supported")
            if m.use_stft_critic:
                raise ValueError(
                    "tp covers the wave critic only (no STFT critic)")
            chs = [min(m.model_dim * 2 ** i, m.max_channels)
                   for i in range(len(m.strides))]
            bad = [c for c in chs if c % mesh.tp]
            if bad:
                raise ValueError(
                    f"critic channels {chs} must each be divisible by "
                    f"tp={mesh.tp} (violated by {bad})")
        if mesh.cp == 1:
            return
        if m.use_stft_critic:
            _, hop, _ = m.stft_resolutions[0]
            # 4 = the STFT critic's stride-2 layers
            if (d.clip_len % (mesh.cp * hop)
                    or (d.clip_len // hop) % (mesh.cp * 2 ** 4)):
                raise ValueError(
                    "cp dual-STFT needs hop-aligned shards and a frame axis "
                    f"divisible by cp*16: clip_len={d.clip_len}, hop={hop}, "
                    f"cp={mesh.cp}")
        if self.loss.stft_loss_weight > 0:
            t_loc = d.clip_len // mesh.cp
            for n_fft, hop, win in m.stft_resolutions:
                if t_loc % hop or (win - hop) > t_loc:
                    raise ValueError(
                        "cp spectral-matching loss needs hop-aligned shards "
                        f"and a (win-hop) halo within one shard: shard len "
                        f"{t_loc}, resolution ({n_fft},{hop},{win})")
        if m.generator == "wavegan":
            base = d.clip_len // m.total_stride
            if base % mesh.cp != 0:
                raise ValueError(f"generator base length {base} must be "
                                 f"divisible by cp={mesh.cp}")
        elif (d.clip_len // m.gru_frame_size) % mesh.cp != 0:
            raise ValueError(
                f"gru frame count {d.clip_len // m.gru_frame_size} must be "
                f"divisible by cp={mesh.cp}")

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


def _ratio(target: int, source: int) -> tuple[int, int]:
    g = math.gcd(target, source)
    return target // g, source // g


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


def cond_gru_sc09() -> Config:
    """Class-conditional GRU (frame-level RNN) generator: 256 frames of
    64 samples, hidden 512, three k=25/s=4 upsampling layers; the critic
    is the flagship's with a label projection."""
    return Config(
        name="cond_gru_sc09",
        data=DataCfg(num_classes=10, device_corpus=True),
        model=ModelCfg(generator="gru", model_dim=64,
                       gru_frame_size=64, gru_hidden=512,
                       fused_shuffle_sites=0, shuffle_impl="prim"),
        loss=LossCfg(n_critic=5),
        train=TrainCfg(batch_size=64, kernels="auto", wgrad_form="conv",
                       dtype="bfloat16", fused_d_views=True),
    ).validate()


def dual_stft() -> Config:
    """Dual discriminator: the flagship's WaveGAN G against the WaveGAN
    critic plus an STFT-spectrogram critic (scores summed), and G's
    batch spectral-matching term over three STFT resolutions."""
    return Config(
        name="dual_stft",
        data=DataCfg(num_classes=0, device_corpus=True),
        model=ModelCfg(generator="wavegan", model_dim=64, use_stft_critic=True,
                       fused_shuffle_sites=0, shuffle_impl="prim"),
        loss=LossCfg(n_critic=5, stft_loss_weight=1.0),
        train=TrainCfg(batch_size=64, kernels="auto", wgrad_form="conv",
                       dtype="bfloat16", fused_d_views=True),
    ).validate()


def resample_22k() -> Config:
    """A 22050 Hz corpus feeding the 16 kHz model: every ingest runs the
    polyphase Kaiser-sinc conversion (up/down = 320/441) before crop,
    normalize and mu-law. Store 24000 source samples -> 17415 at the
    model rate, random-crop slack around the 16384-sample clip.
    CPU-sized like tiny_sc09."""
    return Config(
        name="resample_22k",
        data=DataCfg(sample_rate=16000, source_rate=22050,
                     clip_len=16384, store_len=24000, num_classes=0,
                     device_corpus=True),
        model=ModelCfg(generator="wavegan", model_dim=16, max_channels=256),
        loss=LossCfg(n_critic=2),
        train=TrainCfg(batch_size=8, total_steps=2000, log_every=10),
    ).validate()


def music_44k_dp16() -> Config:
    """4 s 44.1 kHz music clips: 176400 = 48 * 7 * 7 * 5 * 5 * 3, so
    strides (7, 7, 5, 5, 3) upsample a 48-frame base to the clip; store
    5 s, crop 4 s. The reference trains it data-parallel over 16 chips;
    so does the port, over 16 processes (``torchrun``), or over N with
    ``--set mesh.dp=N``."""
    return Config(
        name="music_44k_dp16",
        data=DataCfg(sample_rate=44100, source_rate=44100,
                     clip_len=176400, store_len=220500,
                     device_corpus=True, num_classes=0),
        model=ModelCfg(generator="wavegan", model_dim=64,
                       strides=(7, 7, 5, 5, 3), kernel_size=25,
                       fused_shuffle_sites=0, shuffle_impl="prim"),
        loss=LossCfg(n_critic=5),
        train=TrainCfg(batch_size=64, wgrad_form="conv", dtype="bfloat16",
                       fused_d_views=True),
        mesh=MeshCfg(dp=16, cp=1),
    ).validate()


PRESETS = {
    "tiny_sc09": tiny_sc09,
    "wgan_gp_b64": wgan_gp_b64,
    "cond_gru_sc09": cond_gru_sc09,
    "dual_stft": dual_stft,
    "resample_22k": resample_22k,
    "music_44k_dp16": music_44k_dp16,
}


def get_preset(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]()
