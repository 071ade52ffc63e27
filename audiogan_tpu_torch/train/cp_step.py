"""The context-parallel WGAN-GP training step, the port of
audiogan_tpu/train/cp_step.py (``build_cp_train_step``).

The plain step (train/step.py) splits the batch; this one also splits
each clip's time axis over the cp group (parallel/mesh.py::CpMesh): the
generator makes only this rank's time slice, the critic scores slices
through halo exchanges and one sum over cp per head
(parallel/cp_models.py), and no activation holds a whole clip. Every cp
rank of a data replica ingests the replica's whole clips (the fused
ingest kernel, K2) and keeps its window; the replica's batch is its rows
of the global batch (``raw``, ``labels``), as the reference shards it
over 'data'.

Per critic micro-step, as the reference (cp_step.py:120-177): the real
and fake scores (one 2b call with train.fused_d_views), the penalty on
the sliced interpolates, its per-example squared norm summed over cp
(``_cp_gradient_penalty``, one shot: the reference's cp path ignores
loss.gp_batch_chunks, and its critic loss has no drift term), one Adam
update; then one generator update through the updated critic, with the
spectral term (``cp_batch_spectral_matching_loss``, the replica's batch
means) when loss.stft_loss_weight > 0. The metrics are the last critic
micro-step's, g_loss (and stft_loss), averaged over the replicas.

Draws are per data replica, as the reference folds the replica index
into its step key and shares the keys over cp (cp_step.py:123-126):
train/step.py::draw_step at the replica's batch b, every role tagged
``/data{d}``, a function of (seed, step, d) and the same on every cp
rank. ``draws=`` replaces them with a list of one draw per replica
(tests inject the reference's).

Parameter gradients follow the reference's transpose of replicated
parameters used in shard-varying compute (cp_step.py:111-118): a
parameter used before the sum over cp (every conv, the heads' kernels,
through this rank's row slice, G's projection, sliced by the cp index,
every parameter of G) holds on each rank only its slice's share, so its
gradient is summed over every rank and divided by dp; a parameter used
only after that sum (cp_models.POST_SUM: the heads' biases, the
projection embeddings) has the replica's whole gradient on every cp
rank, so it is summed over the data group only. Summing those over cp
too would scale them by cp, which Adam all but hides (a uniform scale
of one tensor); their Adam moments would show it. Two flat all-reduces
per update. ZeRO-1 (mesh.fsdp) shards Adam's state over the data axis
only.

Compute runs in f32 whatever train.dtype says (cp_models.py's
docstring). Every backward runs on the calling thread and every rank of
a group builds the same graph, so the backward's collectives run in the
same order on every rank (parallel/halo.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.device import resolve_device
from audiogan_tpu_torch.kernels.autograd import cudnn_deterministic
from audiogan_tpu_torch.losses import wgan_d_loss, wgan_g_loss
from audiogan_tpu_torch.ops.ingest import ingest_batch
from audiogan_tpu_torch.parallel.cp_models import (
    POST_SUM, cp_batch_spectral_matching_loss, cp_discriminator_forward,
    cp_generator_forward, cp_gru_generator_forward)
from audiogan_tpu_torch.parallel.halo import axis_sum
from audiogan_tpu_torch.parallel.mesh import (CpMesh, DataMesh,
                                              make_meshes, sum_grads)
from audiogan_tpu_torch.train.state import TrainState
from audiogan_tpu_torch.train.step import d_scores_real_fake, draw_step


def _cp_gradient_penalty(d_apply: Callable[[torch.Tensor], torch.Tensor],
                         real_loc: torch.Tensor, fake_loc: torch.Tensor,
                         eps: torch.Tensor, cp: CpMesh
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The penalty on the time-sharded interpolates: eps [b] is the same
    on every cp rank, so eps real_loc + (1 - eps) fake_loc is this
    rank's slice of the global interpolate, and the gradient of a slice
    is the slice of the gradient; each example's squared norm sums its
    slice's squares, then over cp (cp_step.py:54-67)."""
    b = real_loc.shape[0]
    e = eps.to(real_loc.dtype).reshape(b, 1, 1)
    xhat = (e * real_loc + (1.0 - e) * fake_loc).detach().requires_grad_(
        True)
    (grads,) = torch.autograd.grad(d_apply(xhat).sum(), xhat,
                                   create_graph=True)
    sq = axis_sum(grads.square().reshape(b, -1).sum(-1), cp)
    norms = torch.sqrt(sq + 1e-12)
    return (norms - 1.0).square().mean(), norms.mean()


def build_cp_train_step(cfg: Config, device=None,
                        mesh: DataMesh | None = None,
                        cp: CpMesh | None = None) -> Callable:
    """step_fn(state, raw [num_views, b, store_len] int16, labels
    [num_views, b], draws=None) -> metrics; updates ``state`` in place.
    raw and labels hold this rank's data replica's rows (b = B / dp),
    the same on every cp rank; ``draws`` one draw per replica. Runs on
    the card unless ``device`` says otherwise; the meshes default to
    parallel/mesh.py::make_meshes(cfg). At cp = 1 it is the same step on
    whole clips (no exchange), as the reference compares its cp step
    with itself at cp=1."""
    if cp is None:
        data, cp, _ = make_meshes(cfg)
        mesh = data if mesh is None else mesh
    mesh = DataMesh() if mesh is None else mesh
    dev = resolve_device(device)
    n_critic = cfg.loss.n_critic
    gp_lambda = cfg.loss.gp_lambda
    stft_w = cfg.loss.stft_loss_weight
    conditional = cfg.data.num_classes > 0
    fused = cfg.train.fused_d_views
    t_loc = cfg.data.clip_len // cp.size
    window = slice(cp.index * t_loc, (cp.index + 1) * t_loc)
    # the penalty is one shot: its shifts are drawn at the replica's batch
    one_shot = dataclasses.replace(
        cfg, loss=dataclasses.replace(cfg.loss, gp_batch_chunks=1))
    # the sum over every rank of the mesh: the default group
    world_reduce = mesh.dp * cp.size > 1
    g_forward = (cp_gru_generator_forward if cfg.model.generator == "gru"
                 else cp_generator_forward)

    def on_dev(t):
        return None if t is None else t.to(dev)

    def g_apply(g, z, labels):
        return g_forward(g, on_dev(z), cp, labels)

    def critic(d):
        def apply(x, labels, shifts):
            return cp_discriminator_forward(d, x, cp, shifts, labels)
        return apply

    def reduce_grads(module: torch.nn.Module) -> None:
        pre, post = [], []
        for name, p in module.named_parameters():
            if p.grad is not None:
                (post if name.endswith(POST_SUM) else pre).append(p.grad)
        sum_grads(pre, None, world_reduce, mesh.dp)
        sum_grads(post, mesh.group, mesh.parallel, mesh.dp)

    def d_micro_step(state: TrainState, raw, labels_real, dr):
        d = critic(state.d)
        real = ingest_batch(raw, cfg.data,
                            offsets=on_dev(dr["offsets"]))[..., None]
        real_loc = real[:, window]
        lab_f = on_dev(dr["labels"]) if conditional else None
        lab_r = labels_real.long() if conditional else None
        with torch.no_grad():
            fake_loc = g_apply(state.g, dr["z"], lab_f)
        shifts = {k: on_dev(v) for k, v in dr["shifts"].items()}
        real_s, fake_s = d_scores_real_fake(d, real_loc, fake_loc, lab_r,
                                            lab_f, shifts, fused)
        gp, gnorm = _cp_gradient_penalty(
            lambda x: d(x, lab_r, shifts["gp"]), real_loc, fake_loc,
            on_dev(dr["eps"]), cp)
        loss = wgan_d_loss(real_s, fake_s) + gp_lambda * gp
        w_dist = real_s.mean() - fake_s.mean()
        params = list(state.d.parameters())
        state.opt_d.zero_grad(set_to_none=True)
        loss.backward(inputs=params)
        reduce_grads(state.d)
        state.opt_d.step()
        return {"d_loss": loss.detach(), "w_dist": w_dist.detach(),
                "gp": gp.detach(), "gp_grad_norm": gnorm.detach()}

    def g_update(state: TrainState, raw, dr) -> dict[str, torch.Tensor]:
        lab = on_dev(dr["labels"]) if conditional else None
        fake_loc = g_apply(state.g, dr["z"], lab)
        loss = wgan_g_loss(critic(state.d)(fake_loc, lab,
                                           on_dev(dr["shifts"])))
        out = {}
        if stft_w > 0:
            real = ingest_batch(raw, cfg.data, offsets=on_dev(dr["offsets"]))
            out["stft_loss"] = cp_batch_spectral_matching_loss(
                fake_loc[..., 0], real[:, window],
                cfg.model.stft_resolutions, cp)
            loss = loss + stft_w * out["stft_loss"]
        state.opt_g.zero_grad(set_to_none=True)
        loss.backward(inputs=list(state.g.parameters()))
        reduce_grads(state.g)
        state.opt_g.step()
        return {"g_loss": loss.detach(),
                **{k: v.detach() for k, v in out.items()}}

    def step_fn(state: TrainState, raw: torch.Tensor, labels: torch.Tensor,
                draws: list | None = None) -> dict[str, torch.Tensor]:
        raw, labels = raw.to(dev), labels.to(dev)
        if draws is None:
            dr = draw_step(one_shot, state.seed, state.step, raw.shape[1],
                           dev, tag=f"/data{mesh.rank}")
        else:
            dr = draws[mesh.rank]
        with torch.autograd.set_multithreading_enabled(False), \
                cudnn_deterministic():
            for i in range(n_critic):
                metrics = d_micro_step(state, raw[i], labels[i],
                                       dr["critic"][i])
            metrics.update(g_update(state, raw[n_critic] if stft_w > 0
                                    else None, dr["generator"]))
        state.step += 1
        return mesh.mean_metrics(metrics)

    return step_fn
