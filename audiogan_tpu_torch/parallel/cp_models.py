"""The models with each clip's time axis split over the cp group, the
port of audiogan_tpu/parallel/cp_models.py.

Each function re-expresses a port module's forward on this rank's time
slice through the halo ops of parallel/halo.py, with the module's own
parameters: every conv is a halo-exchange conv (the kernels K1' and K1
on the extended slice), the phase shuffle is the reflect-exact cp form,
and each dense head contracts this rank's rows of the flattened
features against its rows of the head weights, summed over the group
once (``axis_sum``). The result equals the unsharded module's.

As in the reference: the cp critic takes the select-form shuffle of the
shifts it is given and ignores ``model.fused_shuffle_sites`` (so K6 and
K7 are not on this path); the cp GRU generator runs the torch-op cell
(``ops/gru.py::gru_cell(impl="xla")``) under ``cp_chunked_scan``, whose
carry handoff the persistent scan kernel cannot cross (so K3-K5 are not
on it either); and nothing is cast to ``train.dtype``: the reference's
cp functions take the f32 parameters and the f32 ingest as they are, so
its cp step computes in f32 for a bf16 configuration too, and so does
this one (the convs run K1/K1''s f32 CUDA-core kernels).

Which parameters are used only after the sum over cp matters to the
step (train/cp_step.py): the heads' biases and the projection
embeddings (``POST_SUM``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from audiogan_tpu_torch.kernels.autograd import as_compute
from audiogan_tpu_torch.models.gru import GRUGenerator
from audiogan_tpu_torch.models.stft_critic import (STRIDE,
                                                   DualDiscriminator,
                                                   STFTCritic)
from audiogan_tpu_torch.models.wavegan import (WaveGANDiscriminator,
                                               WaveGANGenerator)
from audiogan_tpu_torch.ops.gru import gru_cell
from audiogan_tpu_torch.ops.stft import stft_magnitude
from audiogan_tpu_torch.parallel.halo import (cp_chunked_scan,
                                              cp_conv1d_ba,
                                              cp_conv2d_frames,
                                              cp_conv_transpose1d_ba,
                                              cp_phase_shuffle, axis_sum,
                                              gather_halo)
from audiogan_tpu_torch.parallel.mesh import CpMesh

F32 = torch.float32
# parameter names (suffixes) that enter a critic's score only after the
# sum over cp (cp_models.py:84, 88-91, 139, 143-147)
POST_SUM = ("head.bias", "proj_embed.embedding")


def _p(module: torch.nn.Module, name: str) -> torch.Tensor:
    return as_compute(getattr(module, name), F32)


def _head(h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
          mesh: CpMesh) -> torch.Tensor:
    """h [B, n_loc, m] (this rank's rows of the flattened features) ->
    the dense head's score [B]: this rank's rows of the head weights,
    then one sum over cp, then the bias."""
    n_loc = h.shape[1]
    w_rows = as_compute(kernel, F32).reshape(mesh.size * n_loc, -1)
    w_local = w_rows[mesh.index * n_loc:(mesh.index + 1) * n_loc]
    score = torch.einsum("btc,tc->b", h, w_local)
    return axis_sum(score, mesh) + as_compute(bias, F32)[0]


def _projection(pooled_sum: torch.Tensor, count: int, embed: torch.nn.Module,
                labels: torch.Tensor | None, mesh: CpMesh) -> torch.Tensor:
    """<proj_embed(y), mean features>: the features' sum over this
    rank's rows, summed over cp, over the global count."""
    if labels is None:
        raise ValueError("conditional D needs labels")
    pooled = axis_sum(pooled_sum, mesh) / count
    emb = as_compute(embed.embedding, F32)[labels]
    return (pooled * emb).sum(-1)


def cp_discriminator_forward(d: WaveGANDiscriminator | DualDiscriminator,
                             x_loc: torch.Tensor, mesh: CpMesh,
                             shifts: torch.Tensor | None = None,
                             labels: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """The score [B] of the critic ``d`` (WaveGAN or dual) on this rank's
    time slice x_loc [B, T / cp, 1], the same on every rank; shifts
    [L - 1, B] for the wave critic's phase shuffle (None: none)."""
    if isinstance(d, DualDiscriminator):
        return (_wave_critic_score(d.wave_critic, x_loc, mesh, shifts,
                                   labels)
                + _stft_critic_score(d.stft_critic, x_loc, mesh, labels))
    return _wave_critic_score(d, x_loc, mesh, shifts, labels)


def _wave_critic_score(d: WaveGANDiscriminator, x_loc: torch.Tensor,
                       mesh: CpMesh, shifts: torch.Tensor | None,
                       labels: torch.Tensor | None) -> torch.Tensor:
    n_layers = len(d.strides)
    h = as_compute(x_loc, F32)
    for i, s in enumerate(d.strides):
        h = cp_conv1d_ba(h, _p(d, f"conv_{i}_kernel"), _p(d, f"conv_{i}_bias"),
                         s, mesh, act="leaky_relu", slope=0.2)
        if shifts is not None and d.rad and i < n_layers - 1:
            h = cp_phase_shuffle(h, shifts[i], d.rad, mesh)
    # this rank's rows [i T_loc, (i+1) T_loc) of the [T_out, C] features
    # are a contiguous block of the flattened vector
    score = _head(h, d.head.kernel, d.head.bias, mesh)
    if d.num_classes:
        score = score + _projection(h.sum(1), mesh.size * h.shape[1],
                                    d.proj_embed, labels, mesh)
    return score


def _stft_critic_score(d: STFTCritic, x_loc: torch.Tensor, mesh: CpMesh,
                       labels: torch.Tensor | None) -> torch.Tensor:
    """With hop-aligned slices, this rank's frames need one right halo of
    win - hop samples; the zeros the last rank receives are the
    critic's pad_tail (cp_models.py:94)."""
    t_loc = x_loc.shape[1]
    if t_loc % d.hop:
        raise ValueError(f"local slice {t_loc} is not a multiple of the "
                         f"hop {d.hop}")
    x_ext = gather_halo(as_compute(x_loc, F32), 0, d.win_len - d.hop, mesh)
    mag = stft_magnitude(x_ext[..., 0], d.n_fft, d.hop, d.win_len)
    h = torch.log1p(mag)[:, None]                 # [B, 1, F_loc, bins]
    for i in range(d.n_layers):
        conv = getattr(d, f"conv2d_{i}")
        h = F.leaky_relu(cp_conv2d_frames(h, _p(conv, "kernel"),
                                          _p(conv, "bias"), STRIDE, mesh),
                         0.2)
    b, c, f_loc, bins = h.shape
    # the reference flattens [B, frames, bins, C]
    flat = h.permute(0, 2, 3, 1).reshape(b, f_loc, bins * c)
    score = _head(flat, d.head.kernel, d.head.bias, mesh)
    if d.num_classes:
        score = score + _projection(h.sum((2, 3)), mesh.size * f_loc * bins,
                                    d.proj_embed, labels, mesh)
    return score


def _conditioning(g, z: torch.Tensor,
                  labels: torch.Tensor | None) -> torch.Tensor:
    h = as_compute(z, F32)
    if g.num_classes:
        if labels is None:
            raise ValueError("conditional G needs labels")
        h = torch.cat([h, as_compute(g.label_embed.embedding, F32)[labels]],
                      -1)
    return h


def cp_generator_forward(g: WaveGANGenerator, z: torch.Tensor, mesh: CpMesh,
                         labels: torch.Tensor | None = None) -> torch.Tensor:
    """This rank's slice [B, clip_len / cp, 1] of the WaveGAN generator's
    output: the dense projection whole on every rank, this rank's rows of
    the [B, base_len, c0] seed, then every layer a halo-exchange
    conv-transpose, so no activation holds the whole clip
    (cp_models.py:150). base_len must divide by cp."""
    if g.base_len % mesh.size:
        raise ValueError(f"base_len {g.base_len} must divide over "
                         f"cp={mesh.size}")
    h = _conditioning(g, z, labels)
    h = h @ _p(g.project, "kernel") + _p(g.project, "bias")
    h = torch.relu(h.reshape(h.shape[0], g.base_len, g.c0))
    n = g.base_len // mesh.size
    h = h[:, mesh.index * n:(mesh.index + 1) * n]
    n_layers = len(g.strides)
    for i, s in enumerate(g.strides):
        h = cp_conv_transpose1d_ba(
            h, _p(g, f"convt_{i}_kernel"), _p(g, f"convt_{i}_bias"), s,
            mesh, act="relu" if i < n_layers - 1 else "tanh")
    return h


def cp_gru_generator_forward(g: GRUGenerator, z: torch.Tensor, mesh: CpMesh,
                             labels: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """This rank's slice [B, clip_len / cp, 1] of the GRU generator's
    output: the frame recurrence exact across ranks through
    ``cp_chunked_scan``'s carry handoff (hidden state and the previous
    frame's features), the upsampling stack time-sharded with halos
    (cp_models.py:199). n_frames must divide by cp."""
    if g.n_frames % mesh.size:
        raise ValueError(f"n_frames {g.n_frames} must divide over "
                         f"cp={mesh.size}")
    cond = _conditioning(g, z, labels)
    h0 = torch.tanh(cond @ _p(g.init_state, "kernel")
                    + _p(g.init_state, "bias"))
    cond_proj = cond @ _p(g.cond_proj, "kernel") + _p(g.cond_proj, "bias")
    w_i, w_h, b_i, b_h, w_ar, w_out, b_out = (_p(g, n) for n in (
        "gru_w_i", "gru_w_h", "gru_b_i", "gru_b_h", "ar_proj", "frame_out",
        "frame_out_bias"))

    def step(carry):
        h, prev = carry
        x = torch.cat([prev @ w_ar, cond_proj], -1)
        h = gru_cell(x, h, w_i, w_h, b_i, b_h, impl="xla")
        feat = torch.tanh(h @ w_out + b_out)
        return (h, feat), feat

    feats = cp_chunked_scan(step, (h0, torch.zeros_like(cond_proj)),
                            g.n_frames // mesh.size, mesh)   # [F_loc, B, F]
    h = feats.transpose(0, 1)
    for i, s in enumerate(g.strides):
        h = cp_conv_transpose1d_ba(
            h, _p(g, f"up_{i}_kernel"), _p(g, f"up_{i}_bias"), s, mesh,
            act="relu" if i < len(g.strides) - 1 else "tanh")
    return h


def cp_batch_spectral_matching_loss(fake_loc: torch.Tensor,
                                    real_loc: torch.Tensor,
                                    resolutions: Sequence[tuple[int, int,
                                                                int]],
                                    mesh: CpMesh) -> torch.Tensor:
    """losses/stft_loss.py::batch_spectral_matching_loss of the
    time-sharded fake and real [B, T_loc] (the replica's batch, the same
    on every rank): each rank frames its hop-aligned slice with one
    right halo of win - hop samples, takes its rows of the batch-mean
    magnitude spectra, and the spectral convergence and the
    log-magnitude L1 sum their frame sums over cp. Frames past the
    global (T - win) // hop + 1 read the zeros the last rank receives
    and are masked out (cp_models.py:267)."""
    t_loc = fake_loc.shape[1]
    total = 0.0
    for n_fft, hop, win in resolutions:
        if t_loc % hop or win - hop > t_loc:
            raise ValueError(f"cp shard length {t_loc} needs hop {hop} "
                             f"alignment and a halo {win - hop} within it")
        f_loc = t_loc // hop
        n_valid = (mesh.size * t_loc - win) // hop + 1
        gidx = mesh.index * f_loc + torch.arange(f_loc,
                                                 device=fake_loc.device)
        mask = (gidx < n_valid).to(F32)[:, None]             # [f_loc, 1]

        def mean_mag(x):
            x_ext = gather_halo(as_compute(x, F32), 0, win - hop, mesh)
            return stft_magnitude(x_ext, n_fft, hop, win).mean(0)

        fm, rm = mean_mag(fake_loc), mean_mag(real_loc)
        num = torch.sqrt(axis_sum(((rm - fm).square() * mask).sum(), mesh))
        den = torch.sqrt(axis_sum((rm.square() * mask).sum(), mesh))
        sc = num / (den + 1e-8)
        la = axis_sum(((torch.log(fm + 1e-7) - torch.log(rm + 1e-7)).abs()
                     * mask).sum(), mesh)
        total = total + sc + la / (n_valid * fm.shape[-1])
    return total / len(resolutions)
