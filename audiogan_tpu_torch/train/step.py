"""The WGAN-GP training step, the port of audiogan_tpu/train/step.py.

One step: n_critic critic updates, each on a fresh real view (ingested on
the device through the fused ingest kernel), with the fakes from a G
forward under no_grad, the real and fake scores (one 2B call when
train.fused_d_views, else two B calls), the gradient penalty's double
backprop and one Adam update; then one generator update through the
critic just updated. With loss.stft_loss_weight > 0 the generator's loss
adds that weight times the batch spectral-matching loss of its fakes
against one more real view (ingested the same way), so the step takes
num_views(cfg) = n_critic + 1 views. It runs eagerly; every 1D conv of
it, forward and backward, is a kernel launch on the card; the STFT
critic's 2D convs (with the dual critic) are cuDNN's.

Randomness: per critic micro-step i the crop offsets, z, the penalty's
eps, the fake labels and the phase-shuffle shifts (2B from one draw when
fused, as d_scores_real_fake does; B more for x-hat, or B / chunks with
loss.gp_batch_chunks > 1, the same shifts for every chunk, as the
reference draws each chunk's from one key), then z, labels and shifts
for the G update (and the crop offsets of its real view when the
spectral term is on), all from utils.prng generators of (seed, step,
role). ``draws=`` replaces that stream (tests inject the reference's).

Data parallelism (``mesh``, parallel/mesh.py) is the reference's global
step split by rows, not a step per replica: every rank draws the global
step's draws at the global batch B and takes its rows [r b, (r+1) b),
b = B / dp (``rank_draws``): the crop offsets, z, eps, labels and
shifts; the fused views' 2B shifts from each half, [real; fake]; the
penalty's shifts, drawn at the global chunk size B / gp_batch_chunks and
shared by every chunk, by global row (row j takes shift j mod the chunk
size). ``raw`` and ``labels`` hold this rank's rows. After each backward
the net's gradients are averaged over the ranks in one flat all-reduce,
then Adam runs (ZeRO-1 with mesh.fsdp, train/state.py); the metrics are
averaged too; G's spectral term compares means over the global batch
(losses/stft_loss.py). Every loss is a mean over rows, so the rank-mean
of the rank gradients is the gradient of the global step. No
DistributedDataParallel: its reducer hooks run inside the backward,
which neither the penalty's create_graph backward nor the calling-thread
backward below would keep.

Every backward of the step runs on the calling thread
(``torch.autograd.set_multithreading_enabled(False)``), so the step is a
function of (seed, step) to the bit from a process's first step on. The
autograd engine runs ready nodes in order of their sequence numbers,
which count per thread; on the card the default engine runs backward on a
worker thread, where the penalty's create_graph backward creates its
nodes. The outer backward then interleaves nodes numbered by two counters,
and where a gradient sums three or more terms the order of the sum
depended on how far the worker's counter had come: a fresh process's
first step differed from its later ones. Every cuDNN call of the step
(the 1D weight gradients; with the dual critic the STFT critic's conv2d,
its input and weight gradients and their double backward, which the
autograd engine runs outside any model code) uses cuDNN's deterministic
algorithms (``cudnn_deterministic``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.device import resolve_device
from audiogan_tpu_torch.kernels.autograd import cudnn_deterministic
from audiogan_tpu_torch.losses import (batch_spectral_matching_loss,
                                       gradient_penalty, wgan_d_loss,
                                       wgan_g_loss)
from audiogan_tpu_torch.ops.framing import crop_offsets
from audiogan_tpu_torch.ops.ingest import crop_slack, ingest_batch
from audiogan_tpu_torch.ops.phase_shuffle import draw_shifts
from audiogan_tpu_torch.parallel.mesh import DataMesh, make_mesh
from audiogan_tpu_torch.train.state import TrainState
from audiogan_tpu_torch.utils import prng


def num_views(cfg: Config) -> int:
    """Real views per step: one per critic micro-step, and one for the
    generator's spectral term when it is on."""
    return cfg.loss.n_critic + (1 if cfg.loss.stft_loss_weight > 0 else 0)


def d_scores_real_fake(d, real, fake, lab_r, lab_f, shifts, fused: bool):
    """Critic scores on the real and fake views of one micro-step.
    fused: ONE 2B-batch call with shifts["both"] [sites, 2B]; else two
    B-batch calls with shifts["real"] and shifts["fake"]."""
    if not fused:
        return (d(real, lab_r, shifts["real"]),
                d(fake, lab_f, shifts["fake"]))
    b = real.shape[0]
    lab = None if lab_r is None else torch.cat([lab_r, lab_f])
    scores = d(torch.cat([real, fake]), lab, shifts["both"])
    return scores[:b], scores[b:]


def draw_step(cfg: Config, seed: int, step: int, batch: int,
              device, tag: str = "") -> dict:
    """The port's own draws for one step (see the module docstring);
    ``tag`` ends every role (the cp step's data replica)."""
    m, d = cfg.model, cfg.data
    sites = len(m.strides) - 1 if m.phase_shuffle else 0
    rad = m.phase_shuffle
    max_off = crop_slack(d)
    gp_batch = batch // cfg.loss.gp_batch_chunks

    def labels(gen):
        if not d.num_classes:
            return None
        return torch.randint(0, d.num_classes, (batch,), generator=gen,
                             device=device)

    critic = []
    for i in range(cfg.loss.n_critic):
        gen = prng.generator(seed, step, f"critic/{i}{tag}", device)
        dr = {"offsets": crop_offsets(gen, batch, max_off, device),
              "z": torch.randn(batch, m.latent_dim, generator=gen,
                               device=device),
              "eps": torch.rand(batch, generator=gen, device=device),
              "labels": labels(gen)}
        if cfg.train.fused_d_views:
            dr["shifts"] = {"both": draw_shifts(gen, sites, 2 * batch, rad,
                                                device)}
        else:
            dr["shifts"] = {
                "real": draw_shifts(gen, sites, batch, rad, device),
                "fake": draw_shifts(gen, sites, batch, rad, device)}
        dr["shifts"]["gp"] = draw_shifts(gen, sites, gp_batch, rad, device)
        critic.append(dr)
    gen = prng.generator(seed, step, f"generator{tag}", device)
    g = {"z": torch.randn(batch, m.latent_dim, generator=gen, device=device),
         "labels": labels(gen),
         "shifts": draw_shifts(gen, sites, batch, rad, device)}
    if cfg.loss.stft_loss_weight > 0:
        g["offsets"] = crop_offsets(gen, batch, max_off, device)
    return {"critic": critic, "generator": g}


def step_draws(cfg: Config, seed: int, step: int, device,
               data_rank: int = 0):
    """What the step of ``build_train_step`` draws for itself at (seed,
    step), in the form its ``draws=`` takes: the global step's draws at
    cp = tp = 1; with mesh.cp or mesh.tp above 1 one entry per data
    replica, this rank's (``data_rank``) drawn and the others None (the
    cp step's penalty one shot, train/cp_step.py)."""
    if cfg.mesh.cp == 1 and cfg.mesh.tp == 1:
        return draw_step(cfg, seed, step, cfg.train.batch_size, device)
    c = cfg if cfg.mesh.tp > 1 else dataclasses.replace(
        cfg, loss=dataclasses.replace(cfg.loss, gp_batch_chunks=1))
    out = [None] * cfg.mesh.dp
    out[data_rank] = draw_step(c, seed, step,
                               cfg.train.batch_size // cfg.mesh.dp, device,
                               tag=f"/data{data_rank}")
    return out


def penalty_rows(cfg: Config, mesh: DataMesh, batch: int) -> int:
    """Rows per chunk of the penalty on this rank's rows. The reference
    splits the global batch B into gp_batch_chunks chunks of
    c = B / gp_batch_chunks rows; a rank's b rows split into chunks of
    gcd(b, c) rows, so no chunk holds more rows than the reference's and
    each lies inside one of the reference's. Any b and c that validate
    accepts split so."""
    return math.gcd(batch // mesh.dp, batch // cfg.loss.gp_batch_chunks)


def rank_draws(cfg: Config, draws: dict, mesh: DataMesh,
               batch: int) -> dict:
    """This rank's part of the global step's draws (the module
    docstring); at dp = 1 all of them. The penalty's shifts become a
    list of one [sites, rows] block per chunk of ``penalty_rows``."""
    rows = mesh.rows(batch)
    lo, b = rows.start, rows.stop - rows.start
    c = batch // cfg.loss.gp_batch_chunks
    per = penalty_rows(cfg, mesh, batch)

    def lead(t):
        return None if t is None else t[rows]

    def shifts(key, t):
        if key == "both":
            return torch.cat([t[:, rows], t[:, batch + lo:batch + lo + b]],
                             1)
        if key == "gp":
            return [t[:, (lo + k) % c:(lo + k) % c + per]
                    for k in range(0, b, per)]
        return t[:, rows]

    def part(dr):
        out = {k: lead(v) for k, v in dr.items() if k != "shifts"}
        sh = dr["shifts"]
        out["shifts"] = ({k: shifts(k, v) for k, v in sh.items()}
                         if isinstance(sh, dict) else sh[:, rows])
        return out
    return {"critic": [part(dr) for dr in draws["critic"]],
            "generator": part(draws["generator"])}


def check_penalty_chunks(cfg: Config) -> None:
    """Raises ValueError for gp_batch_chunks > 1 with a conditional
    critic: the reference hands each chunk the whole batch's real labels
    and fails at the projection (audiogan_tpu/train/step.py:226-229;
    its tp step likewise)."""
    if cfg.loss.gp_batch_chunks > 1 and cfg.data.num_classes:
        raise ValueError("gp_batch_chunks > 1 with a conditional critic: "
                         "the reference's penalty fails there too")


def build_train_step(cfg: Config, device=None,
                     mesh: DataMesh | None = None) -> Callable:
    """step_fn(state, raw [num_views, b, store_len] int16, labels
    [num_views, b], draws=None) -> metrics (0-d tensors on the device);
    updates ``state`` in place. b = B / dp rows of the global batch (all
    B at dp = 1); ``draws`` are the global step's. Runs on the card
    unless ``device`` says otherwise. ``mesh`` defaults to
    parallel/mesh.py::make_mesh(cfg), which raises ValueError when the
    mesh's size differs from the number of processes. With mesh.cp above
    1 this is the context-parallel step (train/cp_step.py), with mesh.tp
    above 1 the tensor-parallel step (train/tp_step.py), as the
    reference's loop picks them (audiogan_tpu/train/loop.py:191-201);
    their ``draws`` are per replica."""
    mesh = make_mesh(cfg) if mesh is None else mesh
    if cfg.mesh.cp > 1:
        from audiogan_tpu_torch.train.cp_step import build_cp_train_step
        return build_cp_train_step(cfg, device, mesh)
    if cfg.mesh.tp > 1:
        from audiogan_tpu_torch.train.tp_step import build_tp_train_step
        return build_tp_train_step(cfg, device, mesh)
    check_penalty_chunks(cfg)
    dev = resolve_device(device)
    n_critic = cfg.loss.n_critic
    gp_lambda = cfg.loss.gp_lambda
    drift = cfg.loss.drift_epsilon
    stft_w = cfg.loss.stft_loss_weight
    conditional = cfg.data.num_classes > 0
    fused = cfg.train.fused_d_views

    def on_dev(t):
        return None if t is None else t.to(dev)

    def d_micro_step(state: TrainState, raw, labels_real, dr):
        d = state.d
        real = ingest_batch(raw, cfg.data,
                            offsets=on_dev(dr["offsets"]))[..., None]
        lab_f = on_dev(dr["labels"]) if conditional else None
        lab_r = labels_real.long() if conditional else None
        with torch.no_grad():
            fake = state.g(on_dev(dr["z"]), lab_f)
        shifts = {k: on_dev(v) for k, v in dr["shifts"].items()
                  if k != "gp"}
        real_s, fake_s = d_scores_real_fake(d, real, fake, lab_r, lab_f,
                                            shifts, fused)
        # rank_draws: the penalty's shifts, one block per chunk
        apply = [(lambda x, sh=on_dev(sh): d(x, lab_r, sh))
                 for sh in dr["shifts"]["gp"]]
        gp, gnorm = gradient_penalty(apply, real, fake, on_dev(dr["eps"]),
                                     list(d.parameters()))
        loss = wgan_d_loss(real_s, fake_s) + gp_lambda * gp
        if drift:
            loss = loss + drift * real_s.square().mean()
        w_dist = real_s.mean() - fake_s.mean()
        state.opt_d.zero_grad(set_to_none=True)
        # inputs=: the engine then skips the grads nobody reads (x-hat's)
        loss.backward(inputs=list(d.parameters()))
        mesh.mean_grads(list(d.parameters()))
        state.opt_d.step()
        return {"d_loss": loss.detach(), "w_dist": w_dist.detach(),
                "gp": gp.detach(), "gp_grad_norm": gnorm.detach()}

    def g_update(state: TrainState, raw, dr) -> dict[str, torch.Tensor]:
        lab = on_dev(dr["labels"]) if conditional else None
        fake = state.g(on_dev(dr["z"]), lab)
        loss = wgan_g_loss(state.d(fake, lab, on_dev(dr["shifts"])))
        out = {}
        if stft_w > 0:
            real = ingest_batch(raw, cfg.data, offsets=on_dev(dr["offsets"]))
            out["stft_loss"] = batch_spectral_matching_loss(
                fake[..., 0], real, cfg.model.stft_resolutions, mesh)
            loss = loss + stft_w * out["stft_loss"]
        state.opt_g.zero_grad(set_to_none=True)
        # the critic's weight gradients are not computed (kernels/autograd)
        loss.backward(inputs=list(state.g.parameters()))
        mesh.mean_grads(list(state.g.parameters()))
        state.opt_g.step()
        return {"g_loss": loss.detach(),
                **{k: v.detach() for k, v in out.items()}}

    def step_fn(state: TrainState, raw: torch.Tensor, labels: torch.Tensor,
                draws: dict | None = None) -> dict[str, torch.Tensor]:
        raw, labels = raw.to(dev), labels.to(dev)
        batch = raw.shape[1] * mesh.dp
        if draws is None:
            draws = draw_step(cfg, state.seed, state.step, batch, dev)
        draws = rank_draws(cfg, draws, mesh, batch)
        with torch.autograd.set_multithreading_enabled(False), \
                cudnn_deterministic():
            d_metrics = [d_micro_step(state, raw[i], labels[i],
                                      draws["critic"][i])
                         for i in range(n_critic)]
            g_metrics = g_update(state, raw[n_critic] if stft_w > 0
                                 else None, draws["generator"])
        metrics = dict(d_metrics[-1])
        metrics["d_loss_mean"] = torch.stack(
            [m["d_loss"] for m in d_metrics]).mean()
        metrics.update(g_metrics)
        state.step += 1
        return mesh.mean_metrics(metrics)

    return step_fn


def wrap_device_corpus(inner: Callable) -> Callable:
    """(state, corpus_clips [N, store_len] int16 resident on the device,
    idx [num_views, B], labels [num_views, B], draws=None) -> metrics: the
    step gathers its raw views from the resident corpus by index, so the
    host ships only indices per step (step.py:82-142). With
    data.index_chunk the loop ships resident blocks of indices and hands
    the step its row (data/corpus.py::index_row), as the reference's
    ``wrap_device_corpus(..., chunk)`` takes it inside its step."""

    def step_fn(state, corpus_clips, idx, labels, draws=None):
        idx = idx.to(corpus_clips.device, torch.long)
        raw = corpus_clips[idx.reshape(-1)].reshape(
            *idx.shape, corpus_clips.shape[1])
        return inner(state, raw, labels, draws)

    return step_fn
