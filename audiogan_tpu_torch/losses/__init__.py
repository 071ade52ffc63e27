"""Losses of the port."""

from audiogan_tpu_torch.losses.stft_loss import (
    batch_spectral_matching_loss, log_stft_magnitude_loss,
    multi_resolution_stft_loss, spectral_convergence_loss)
from audiogan_tpu_torch.losses.wgan import (gradient_penalty, wgan_d_loss,
                                            wgan_g_loss)

__all__ = ["gradient_penalty", "wgan_d_loss", "wgan_g_loss",
           "multi_resolution_stft_loss", "spectral_convergence_loss",
           "log_stft_magnitude_loss", "batch_spectral_matching_loss"]
