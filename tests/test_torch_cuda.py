"""The convt1d CUDA kernel against its plain form, on the card.

Marked ``cuda``: each test skips where there is no CUDA device. These import
torch and the port only, so they also run on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py -q
"""

import pytest
import torch

from audiogan_tpu_torch.kernels import conv as tconv

pytestmark = pytest.mark.cuda

# (k, stride, t_in, cin, cout, pad_lo, out_len): ragged m tiles, ragged
# Cout tiles, each of the kernel's three tile shapes, strides other than 4
GEOMS = [
    (25, 4, 16, 96, 130, None, None),     # short m: 16-row tiles
    (25, 4, 70, 40, 64, None, None),      # 64 x 64 tiles, ragged m
    (25, 4, 300, 24, 1, None, None),      # thin Cout: 1024-row tiles
    (9, 4, 33, 17, 20, None, None),       # pad_lo=4
    (25, 7, 21, 32, 33, None, None),
    (25, 5, 9, 33, 7, None, None),
    (9, 3, 50, 8, 40, None, None),
    (9, 4, 10, 8, 5, 3, 38),              # out_len % stride != 0
    (5, 2, 12, 6, 3, 0, 24),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(geom, dtype, device, seed=0):
    k, _, t_in, cin, cout, _, _ = geom
    gen = torch.Generator(device).manual_seed(seed)
    x = torch.randn(3, t_in, cin, generator=gen, device=device)
    w = torch.randn(k, cin, cout, generator=gen, device=device)
    w /= (k * cin / 4) ** 0.5
    b = torch.randn(cout, generator=gen, device=device) * 0.5
    return x.to(dtype), w.to(dtype), b.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu", "tanh"])
@pytest.mark.parametrize("geom", GEOMS, ids=str)
def test_kernel_matches_plain(cuda_device, geom, act, dtype):
    _, s, _, _, _, pad_lo, out_len = geom
    x, w, b = _inputs(geom, dtype, cuda_device)
    before = tconv.conv_transpose1d_ba.launches
    got = tconv.conv_transpose1d_ba(x, w, b, s, pad_lo=pad_lo,
                                    out_len=out_len, act=act, slope=0.3)
    torch.cuda.synchronize()
    assert tconv.conv_transpose1d_ba.launches == before + 1
    k = w.shape[0]
    want = tconv.conv_transpose1d_ba_plain(
        x.float(), w.float(), b.float(), s,
        (k - 1) // 2 if pad_lo is None else pad_lo,
        x.shape[1] * s if out_len is None else out_len, act, 0.3)
    assert got.dtype == dtype and got.shape == want.shape
    # f32: the same sums in another order; bf16: one rounding of the output
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    err = (got.float() - want).abs().max().item()
    assert err <= rel * want.abs().max().item(), err


def test_kernel_rejects_mixed_devices(cuda_device):
    x, w, b = _inputs(GEOMS[0], torch.float32, cuda_device)
    with pytest.raises(TypeError):
        tconv.conv_transpose1d_ba(x, w.cpu(), b, 4)
    with pytest.raises(TypeError):
        tconv.conv_transpose1d_ba(x, w.bfloat16(), b, 4)
    with pytest.raises(ValueError, match="contiguous"):
        tconv.conv_transpose1d_ba(x.transpose(0, 1).contiguous()
                                  .transpose(0, 1), w, b, 4)
