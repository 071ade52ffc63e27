"""Multi-resolution STFT losses, the port of audiogan_tpu/losses/stft_loss.py.

``multi_resolution_stft_loss`` is the paired loss (spectral convergence +
log-magnitude L1, averaged over resolutions). GAN training has no paired
target, so the dual_stft preset's generator term is
``batch_spectral_matching_loss``: the same sum on the batch-mean magnitude
spectrograms of the fake and the real batch. Under data parallelism
those means are over the global batch (``mesh``, parallel/mesh.py::
global_mean), as the reference's step computes them over the whole
batch that XLA partitions.
"""

from __future__ import annotations

from typing import Sequence

import torch

from audiogan_tpu_torch.ops.stft import stft_magnitude
from audiogan_tpu_torch.parallel.mesh import DataMesh, global_mean

Resolutions = Sequence[tuple[int, int, int]]

DEFAULT_RESOLUTIONS: Resolutions = (
    (512, 128, 512), (1024, 256, 1024), (2048, 512, 2048))


def spectral_convergence_loss(x_mag: torch.Tensor,
                              y_mag: torch.Tensor) -> torch.Tensor:
    """||y_mag - x_mag||_F / ||y_mag||_F."""
    num = torch.sqrt((y_mag - x_mag).square().sum())
    den = torch.sqrt(y_mag.square().sum()) + 1e-8
    return num / den


def log_stft_magnitude_loss(x_mag: torch.Tensor,
                            y_mag: torch.Tensor) -> torch.Tensor:
    return (torch.log(x_mag + 1e-7) - torch.log(y_mag + 1e-7)).abs().mean()


def multi_resolution_stft_loss(x: torch.Tensor, y: torch.Tensor,
                               resolutions: Resolutions = DEFAULT_RESOLUTIONS
                               ) -> torch.Tensor:
    """Paired loss between waveforms x, y [B, T] (or [B, T, 1])."""
    if x.dim() == 3:
        x, y = x[..., 0], y[..., 0]
    total = 0.0
    for n_fft, hop, win in resolutions:
        xm = stft_magnitude(x, n_fft, hop, win)
        ym = stft_magnitude(y, n_fft, hop, win)
        total = total + spectral_convergence_loss(xm, ym) \
            + log_stft_magnitude_loss(xm, ym)
    return total / len(resolutions)


def batch_spectral_matching_loss(fake: torch.Tensor, real: torch.Tensor,
                                 resolutions: Resolutions = DEFAULT_RESOLUTIONS,
                                 mesh: DataMesh | None = None
                                 ) -> torch.Tensor:
    """Unpaired: the batch-mean magnitude spectra of fake vs real; with a
    data-parallel ``mesh``, fake and real hold this rank's rows and the
    means are over the global batch."""
    if fake.dim() == 3:
        fake, real = fake[..., 0], real[..., 0]
    total = 0.0
    for n_fft, hop, win in resolutions:
        fm = global_mean(stft_magnitude(fake, n_fft, hop, win).mean(dim=0),
                         mesh)
        rm = global_mean(stft_magnitude(real, n_fft, hop, win).mean(dim=0),
                         mesh)
        total = total + spectral_convergence_loss(fm, rm) \
            + log_stft_magnitude_loss(fm, rm)
    return total / len(resolutions)
