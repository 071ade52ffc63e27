"""Losses of the port."""

from audiogan_tpu_torch.losses.wgan import (gradient_penalty, wgan_d_loss,
                                            wgan_g_loss)

__all__ = ["gradient_penalty", "wgan_d_loss", "wgan_g_loss"]
