"""WGAN value function and gradient penalty (Gulrajani et al. 2017), the
port of audiogan_tpu/losses/wgan.py.

The penalty's gradient with respect to the interpolates is taken with
``create_graph=True``, so differentiating the loss with respect to the
critic's parameters runs the double backprop through the conv Functions
of kernels/autograd.py.
"""

from __future__ import annotations

from typing import Callable

import torch


def wgan_d_loss(real_scores: torch.Tensor,
                fake_scores: torch.Tensor) -> torch.Tensor:
    """Critic loss (to minimize): E[D(fake)] - E[D(real)]."""
    return fake_scores.mean() - real_scores.mean()


def wgan_g_loss(fake_scores: torch.Tensor) -> torch.Tensor:
    """Generator loss (to minimize): -E[D(fake)]."""
    return -fake_scores.mean()


def gradient_penalty(d_apply: Callable[[torch.Tensor], torch.Tensor],
                     real: torch.Tensor, fake: torch.Tensor,
                     eps: torch.Tensor, batch_chunks: int = 1
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """WGAN-GP penalty on x^ = eps*real + (1-eps)*fake.

    d_apply maps [B, T, 1] -> scores [B]; eps [B] is one draw per example.
    Returns (mean((||grad_x^ D||_2 - 1)^2), mean gradient norm).
    """
    if batch_chunks > 1:
        raise NotImplementedError(
            "gp_batch_chunks > 1 is not ported to audiogan_tpu_torch yet")
    e = eps.to(real.dtype).reshape((-1,) + (1,) * (real.dim() - 1))
    xhat = (e * real + (1.0 - e) * fake).detach().requires_grad_(True)
    # D factorizes over the batch, so grad of the sum is per-example grads
    (grads,) = torch.autograd.grad(d_apply(xhat).sum(), xhat,
                                   create_graph=True)
    norms = torch.sqrt(grads.square().reshape(grads.shape[0], -1).sum(-1)
                       + 1e-12)
    return (norms - 1.0).square().mean(), norms.mean()
