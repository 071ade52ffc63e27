"""audiogan_tpu_torch's STFT magnitude and STFT losses against the JAX
package's (audiogan_tpu.ops.stft, audiogan_tpu.losses.stft_loss).

Inputs from a numpy seed, f32. Tolerances: values 1e-5 relative to the
largest (the same sums in another order); first- and second-order
gradients 1e-4 relative to the largest (a gradient through sqrt and log
sums many more terms). The losses' gradients: 1e-3 relative L2, against
JAX and against the same losses in float64. The paired loss
differentiates log |X| frame by frame, and frames of near-zero magnitude,
whose DFT sums cancel, amplify the matmul's rounding there: at these
inputs the port's f32 gradient lies 3.5e-4 (relative L2) from float64,
JAX's 5.4e-5, and the two 4.0e-4 apart; the DFT products themselves
differ from float64 by 2.5e-6 (torch) and 1.2e-6 (JAX) at a largest
value of 6.4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiogan_tpu.losses import stft_loss as jloss
from audiogan_tpu.ops import stft as jstft
from audiogan_tpu_torch.losses import stft_loss
from audiogan_tpu_torch.ops import stft

REL, GRAD_REL = 1e-5, 1e-4
LOSS_GRAD_REL_L2 = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def _signal(shape, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("t,frame,hop", [(256, 64, 16), (250, 64, 16),
                                         (300, 50, 20), (128, 128, 32)])
def test_frame_signal_matches_jax(t, frame, hop):
    x = _signal((2, 3, t))
    got = stft.frame_signal(torch.from_numpy(x), frame, hop)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jstft.frame_signal(jnp.asarray(x), frame,
                                                   hop)))


def test_frame_signal_rejects_a_short_signal():
    with pytest.raises(ValueError, match="too short"):
        stft.frame_signal(torch.zeros(2, 60), 64, 16)


def test_windowed_basis_is_the_reference_constant():
    for n_fft, win in ((128, 128), (130, 128), (512, 512)):
        for a, b in zip(stft._windowed_basis(n_fft, win),
                        jstft._windowed_basis(n_fft, win)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pad_tail", [False, True])
@pytest.mark.parametrize("res", [(128, 32, 128), (130, 32, 96)],
                         ids=["square", "win_lt_nfft"])
def test_stft_magnitude_and_grads_match_jax(res, pad_tail):
    n_fft, hop, win = res
    x = _signal((3, 1024), seed=1)
    w = np.random.default_rng(2).standard_normal(
        np.asarray(jstft.stft_magnitude(jnp.asarray(x), n_fft, hop, win,
                                        pad_tail=pad_tail)).shape
    ).astype(np.float32)

    def jf(v):
        return jstft.stft_magnitude(v, n_fft, hop, win, pad_tail=pad_tail)

    def jscalar(v):
        return jnp.sum(jnp.asarray(w) * jnp.log1p(jf(v)))

    def jsecond(v):
        return jnp.sum(jnp.square(jax.grad(jscalar)(v)))

    xt = torch.from_numpy(x).requires_grad_(True)
    mag = stft.stft_magnitude(xt, n_fft, hop, win, pad_tail=pad_tail)
    assert mag.dtype == torch.float32
    _close(mag, jf(jnp.asarray(x)))
    if pad_tail:
        assert mag.shape[-2] == x.shape[-1] // hop
    (g1,) = torch.autograd.grad((torch.from_numpy(w) * torch.log1p(mag)
                                 ).sum(), xt, create_graph=True)
    _close(g1, jax.grad(jscalar)(jnp.asarray(x)), GRAD_REL)
    (g2,) = torch.autograd.grad(g1.square().sum(), xt)
    _close(g2, jax.grad(jsecond)(jnp.asarray(x)), GRAD_REL)


def test_pad_tail_rejects_a_ragged_signal():
    with pytest.raises(ValueError, match="divisible"):
        stft.stft_magnitude(torch.zeros(2, 1000), 128, 32, pad_tail=True)


RESOLUTIONS = ((128, 32, 128), (256, 64, 256))


def _loss64(name, fake, real):
    """The loss in float64 throughout (stft_magnitude computes in f32)."""
    def mag(v, n_fft, hop, win):
        cos_b, sin_b = (torch.from_numpy(b).double()
                        for b in stft._windowed_basis(n_fft, win))
        frames = v.reshape(v.shape[0], -1).unfold(-1, win, hop)
        return torch.sqrt((frames @ cos_b).square()
                          + (frames @ sin_b).square() + 1e-7)
    total = 0.0
    for n_fft, hop, win in RESOLUTIONS:
        fm, rm = mag(fake, n_fft, hop, win), mag(real, n_fft, hop, win)
        if name == "batch_spectral_matching_loss":
            fm, rm = fm.mean(dim=0), rm.mean(dim=0)
        total = total + stft_loss.spectral_convergence_loss(fm, rm) \
            + stft_loss.log_stft_magnitude_loss(fm, rm)
    return total / len(RESOLUTIONS)


@pytest.mark.parametrize("rank", [2, 3])
def test_stft_losses_match_jax(rank):
    shape = (4, 1024) if rank == 2 else (4, 1024, 1)
    fake, real = _signal(shape, seed=3) * 0.5, _signal(shape, seed=4)
    f_t = torch.from_numpy(fake).requires_grad_(True)
    r_t = torch.from_numpy(real)
    jf, jr = jnp.asarray(fake), jnp.asarray(real)
    for name in ("multi_resolution_stft_loss",
                 "batch_spectral_matching_loss"):
        got = getattr(stft_loss, name)(f_t, r_t, RESOLUTIONS)

        def jl(v):
            return getattr(jloss, name)(v, jr, RESOLUTIONS)
        _close(got, jl(jf))
        (grad,) = torch.autograd.grad(got, f_t)
        want = np.asarray(jax.grad(jl)(jf))
        assert np.linalg.norm(grad.numpy() - want) <= \
            LOSS_GRAD_REL_L2 * np.linalg.norm(want)
        f64 = f_t.detach().double().requires_grad_(True)
        (grad64,) = torch.autograd.grad(_loss64(name, f64, r_t.double()),
                                        f64)
        assert np.linalg.norm(grad.numpy() - grad64.numpy()) <= \
            LOSS_GRAD_REL_L2 * np.linalg.norm(grad64.numpy())
    xm = stft.stft_magnitude(f_t.reshape(4, -1), 128, 32).detach()
    ym = stft.stft_magnitude(r_t.reshape(4, -1), 128, 32)
    for name in ("spectral_convergence_loss", "log_stft_magnitude_loss"):
        _close(getattr(stft_loss, name)(xm, ym),
               getattr(jloss, name)(jnp.asarray(xm.numpy()),
                                    jnp.asarray(ym.numpy())))


def test_default_resolutions_are_the_reference():
    assert tuple(stft_loss.DEFAULT_RESOLUTIONS) == \
        tuple(jloss.DEFAULT_RESOLUTIONS)


def test_a_basis_first_made_under_inference_mode_stays_differentiable():
    """ops/stft.py caches its basis per (n_fft, win_len, device), and the
    first call may come from ``evaluate`` or ``sample``, which run under
    inference mode. A basis made there would be an inference tensor,
    which no later loss can save for backward: in a test process where
    an eval test ran first, test_stft_losses_match_jax failed so. The
    resampler's cached taps (ops/resample.py) likewise."""
    from audiogan_tpu_torch.ops import resample
    with torch.inference_mode():
        stft.stft_magnitude(torch.zeros(2, 480), 96, 24)
        taps = resample._taps_on(7, 5, 3, 4.0, torch.device("cpu"))
    assert not taps.is_inference()
    x = torch.from_numpy(_signal((2, 480), seed=5)).requires_grad_(True)
    (g,) = torch.autograd.grad(stft.stft_magnitude(x, 96, 24).sum(), x)
    assert torch.isfinite(g).all() and g.abs().max() > 0
