"""WGAN value function and gradient penalty (Gulrajani et al. 2017), the
port of audiogan_tpu/losses/wgan.py.

The penalty's gradient with respect to the interpolates is taken with
``create_graph=True``, so differentiating the loss with respect to the
critic's parameters runs the double backprop through the conv Functions
of kernels/autograd.py.

More than one chunk (loss.gp_batch_chunks > 1) bounds the penalty's
memory for long clips, as the reference's
``lax.map(jax.checkpoint(norms_of))`` does: the interpolates are split
over the batch, and each chunk's norms come from ``_ChunkNorms``, which
keeps only the chunk and drops its graph after the forward, then
recomputes the chunk's critic forward and input gradient (with
``create_graph``) when the outer backward reaches it, so one chunk's
activations are live at a time. It costs one more critic forward and
input gradient per chunk. ``torch.utils.checkpoint`` cannot do this:
its non-reentrant form refuses a second unpack of a saved tensor, which
the input gradient taken inside the checkpointed function makes, and its
reentrant form runs the function without a graph.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def wgan_d_loss(real_scores: torch.Tensor,
                fake_scores: torch.Tensor) -> torch.Tensor:
    """Critic loss (to minimize): E[D(fake)] - E[D(real)]."""
    return fake_scores.mean() - real_scores.mean()


def wgan_g_loss(fake_scores: torch.Tensor) -> torch.Tensor:
    """Generator loss (to minimize): -E[D(fake)]."""
    return -fake_scores.mean()


def _grad_norms(d_apply: Callable[[torch.Tensor], torch.Tensor],
                x: torch.Tensor, create_graph: bool = True) -> torch.Tensor:
    """Per-example ||grad_x D(x)||_2 of a batch [b, T, 1], with
    create_graph differentiable in D's parameters (D factorizes over the
    batch, so the gradient of the sum is the per-example gradients)."""
    x = x.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(d_apply(x).sum(), x,
                                   create_graph=create_graph)
    return torch.sqrt(grads.square().reshape(grads.shape[0], -1).sum(-1)
                      + 1e-12)


class _ChunkNorms(torch.autograd.Function):
    """_grad_norms of one chunk, its graph recomputed in the backward:
    forward(d_apply, x, *params) -> norms [b]; the backward returns the
    gradients of ``params`` (D's parameters, which d_apply reads)."""

    @staticmethod
    def forward(ctx, d_apply, x, *params):
        ctx.d_apply = d_apply
        ctx.save_for_backward(x, *params)
        with torch.enable_grad():
            return _grad_norms(d_apply, x, create_graph=False)

    @staticmethod
    def backward(ctx, grad_norms):
        x, *params = ctx.saved_tensors
        with torch.enable_grad():
            norms = _grad_norms(ctx.d_apply, x)
        grads = torch.autograd.grad(norms, params, grad_norms,
                                    allow_unused=True)
        return (None, None, *grads)


def gradient_penalty(d_applies: Sequence[Callable[[torch.Tensor],
                                                  torch.Tensor]],
                     real: torch.Tensor, fake: torch.Tensor,
                     eps: torch.Tensor, params: Sequence[torch.Tensor] = ()
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """WGAN-GP penalty on x^ = eps*real + (1-eps)*fake.

    The batch splits into len(d_applies) chunks of equal size, and chunk
    i is scored by d_applies[i], which maps [b, T, 1] -> scores [b] (each
    chunk's own phase-shuffle shifts: train/step.py::rank_draws). With
    more than one chunk, each is computed by ``_ChunkNorms`` and only
    ``params`` (the parameters the callables read, all of them) get
    gradients through the penalty. eps [B] is one draw per example.
    Returns (mean((||grad_x^ D||_2 - 1)^2), mean gradient norm).
    """
    chunks = len(d_applies)
    b = real.shape[0]
    e = eps.to(real.dtype).reshape((-1,) + (1,) * (real.dim() - 1))
    xhat = (e * real + (1.0 - e) * fake).detach()
    if chunks > 1:
        if b % chunks:
            raise ValueError(f"batch {b} not divisible by gp batch_chunks "
                             f"{chunks}")
        if not params:
            raise ValueError("gp batch_chunks > 1 needs D's params")
        norms = torch.cat([_ChunkNorms.apply(f, chunk, *params)
                           for f, chunk in zip(d_applies,
                                               xhat.chunk(chunks))])
    else:
        norms = _grad_norms(d_applies[0], xhat)
    return (norms - 1.0).square().mean(), norms.mean()
