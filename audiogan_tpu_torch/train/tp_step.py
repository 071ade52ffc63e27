"""The tensor-parallel WGAN-GP training step, the port of
audiogan_tpu/train/tp_step.py (``build_tp_train_step``).

The plain step (train/step.py) splits the batch; this one also splits
the critic's channel axis over the tp group (parallel/mesh.py::TpMesh):
every critic conv runs on a 1/tp channel slice in the column/row
pairing of parallel/tp_models.py (one sum over tp per row layer, one for
the head). The generator is the ordinary module in train.dtype,
replicated on every tp rank (with cond_gru_sc09 the persistent K4/K5),
at the replica's batch; the critic computes in f32 (tp_models.py's
docstring). Every tp rank of a data replica ingests the replica's rows
(K2) and runs the same rows (``raw``, ``labels``), as the reference
shards the batch over 'data' only.

Per critic micro-step, as the reference (tp_step.py:108-155): the real
and fake scores (one 2b call with train.fused_d_views), the canonical
gradient penalty with loss.gp_batch_chunks honoured (losses/wgan.py;
each chunk's shifts are the one draw at the chunk's rows, as
train/step.py::rank_draws cuts them), no drift term, one Adam update;
then one generator update through the updated critic, with G's spectral
term on the whole, replicated clips (the replica's batch means) when
loss.stft_loss_weight > 0. The metrics are the last critic micro-step's
and g_loss (and stft_loss), averaged over the replicas (the tp ranks
hold the same values).

Draws are per data replica, as the reference folds the replica index
into its step key and shares the keys over tp (tp_step.py:103-106),
with the cp step's splits: train/step.py::draw_step at the replica's
batch b, every role tagged ``/data{d}``, the same on every tp rank.
``draws=`` replaces them with a list of one draw per replica (tests
inject the reference's).

Gradients. A critic parameter used through this rank's slice
(tp_models.sliced_params) holds on each rank only its slice's share, so
its gradient is summed over every rank and divided by dp; one used
after a sum over tp (the row layers' biases, head.bias; with an even
layer count the head and proj_embed) has the replica's whole gradient
on every tp rank and is summed over the data group only. So is every
parameter of G: G's output is the same on every tp rank, and the sum
over tp in the backward of the first column layer's input (Megatron's
f) hands each rank the whole gradient of the fakes. Summing those over
tp too would scale them by tp, which Adam all but hides from the
parameters; its moments would show it. Two flat all-reduces per critic
update, one per G update. ZeRO-1 (mesh.fsdp) shards Adam's state over
the data axis only.

Every backward runs on the calling thread with cuDNN's deterministic
algorithms, and every rank of a group builds the same graph, so the
backward's collectives run in the same order on every rank.
"""

from __future__ import annotations

from typing import Callable

import torch

from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.device import resolve_device
from audiogan_tpu_torch.kernels.autograd import cudnn_deterministic
from audiogan_tpu_torch.losses import (batch_spectral_matching_loss,
                                       gradient_penalty, wgan_d_loss,
                                       wgan_g_loss)
from audiogan_tpu_torch.ops.ingest import ingest_batch
from audiogan_tpu_torch.parallel.mesh import (DataMesh, TpMesh, make_meshes,
                                              sum_grads)
from audiogan_tpu_torch.parallel.tp_models import (sliced_params,
                                                   tp_discriminator_forward)
from audiogan_tpu_torch.train.state import TrainState
from audiogan_tpu_torch.train.step import (check_penalty_chunks,
                                           d_scores_real_fake, draw_step,
                                           rank_draws)


def build_tp_train_step(cfg: Config, device=None,
                        mesh: DataMesh | None = None,
                        tp: TpMesh | None = None) -> Callable:
    """step_fn(state, raw [num_views, b, store_len] int16, labels
    [num_views, b], draws=None) -> metrics; updates ``state`` in place.
    raw and labels hold this rank's data replica's rows (b = B / dp),
    the same on every tp rank; ``draws`` one draw per replica. Runs on
    the card unless ``device`` says otherwise; the meshes default to
    parallel/mesh.py::make_meshes(cfg). At tp = 1 it is the same step
    with the whole critic on one rank (no exchange)."""
    if tp is None:
        data, _, tp = make_meshes(cfg)
        mesh = data if mesh is None else mesh
    mesh = DataMesh() if mesh is None else mesh
    check_penalty_chunks(cfg)
    dev = resolve_device(device)
    n_critic = cfg.loss.n_critic
    gp_lambda = cfg.loss.gp_lambda
    stft_w = cfg.loss.stft_loss_weight
    conditional = cfg.data.num_classes > 0
    fused = cfg.train.fused_d_views
    # the sum over every rank of the mesh: the default group
    world_reduce = mesh.dp * tp.size > 1

    def on_dev(t):
        return None if t is None else t.to(dev)

    def critic(d):
        def apply(x, labels, shifts):
            return tp_discriminator_forward(d, x, tp, shifts, labels)
        return apply

    def reduce_d(d: torch.nn.Module) -> None:
        sliced = sliced_params(d)
        pre, post = [], []
        for name, p in d.named_parameters():
            if p.grad is not None:
                (pre if name in sliced else post).append(p.grad)
        sum_grads(pre, None, world_reduce, mesh.dp)
        sum_grads(post, mesh.group, mesh.parallel, mesh.dp)

    def reduce_g(g: torch.nn.Module) -> None:
        sum_grads([p.grad for p in g.parameters() if p.grad is not None],
                  mesh.group, mesh.parallel, mesh.dp)

    def d_micro_step(state: TrainState, raw, labels_real, dr):
        d = critic(state.d)
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
        params = list(state.d.parameters())
        apply = [(lambda x, sh=on_dev(sh): d(x, lab_r, sh))
                 for sh in dr["shifts"]["gp"]]
        gp, gnorm = gradient_penalty(apply, real, fake, on_dev(dr["eps"]),
                                     params)
        loss = wgan_d_loss(real_s, fake_s) + gp_lambda * gp
        w_dist = real_s.mean() - fake_s.mean()
        state.opt_d.zero_grad(set_to_none=True)
        loss.backward(inputs=params)
        reduce_d(state.d)
        state.opt_d.step()
        return {"d_loss": loss.detach(), "w_dist": w_dist.detach(),
                "gp": gp.detach(), "gp_grad_norm": gnorm.detach()}

    def g_update(state: TrainState, raw, dr) -> dict[str, torch.Tensor]:
        lab = on_dev(dr["labels"]) if conditional else None
        fake = state.g(on_dev(dr["z"]), lab)
        loss = wgan_g_loss(critic(state.d)(fake, lab, on_dev(dr["shifts"])))
        out = {}
        if stft_w > 0:
            real = ingest_batch(raw, cfg.data, offsets=on_dev(dr["offsets"]))
            out["stft_loss"] = batch_spectral_matching_loss(
                fake[..., 0], real, cfg.model.stft_resolutions)
            loss = loss + stft_w * out["stft_loss"]
        state.opt_g.zero_grad(set_to_none=True)
        loss.backward(inputs=list(state.g.parameters()))
        reduce_g(state.g)
        state.opt_g.step()
        return {"g_loss": loss.detach(),
                **{k: v.detach() for k, v in out.items()}}

    def step_fn(state: TrainState, raw: torch.Tensor, labels: torch.Tensor,
                draws: list | None = None) -> dict[str, torch.Tensor]:
        raw, labels = raw.to(dev), labels.to(dev)
        b = raw.shape[1]
        dr = (draw_step(cfg, state.seed, state.step, b, dev,
                        tag=f"/data{mesh.rank}")
              if draws is None else draws[mesh.rank])
        # the penalty's shifts as one block per chunk of the replica's rows
        dr = rank_draws(cfg, dr, DataMesh(), b)
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
