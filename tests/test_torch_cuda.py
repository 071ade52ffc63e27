"""The CUDA kernels (convt1d, conv1d, ingest, gru_scan, gru_scan_bwd,
sconv1d, sconvt1d and gru_cell) against their plain forms, on the card,
and the autograd Functions' first- and second-order gradients through the
kernels (unfused and fused shuffle sites, and the dual wave + STFT
critic), the GRU generator's forward and backward and the fused GRU
cell's, against the same code on the CPU; and that a training step on the
card (the dual_stft step's too, and music_44k_dp16's at mesh.dp=1 and
resample_22k's at their published widths) is bit-reproducible. K1 and K1'
at every music_44k_dp16 geometry (strides 7, 7, 5, 5, 3) against their
plain forms, and at every flagship and music geometry at the batches a
data-parallel rank runs (4, 8, 16, 32: G at B/dp and the critic at 2B/dp
for dp 16 and 4), K6 and K7 at the fused sites at batches 8 and 32 too.

Marked ``cuda``: each test skips where there is no CUDA device. These import
torch and the port only, so they also run on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py -q
"""

import json
import re

import pytest
import torch

from audiogan_tpu_torch.kernels import conv as tconv
from audiogan_tpu_torch.kernels import gru as tgru
from audiogan_tpu_torch.kernels import ingest as tingest
from audiogan_tpu_torch.kernels import sconv as tsconv

pytestmark = pytest.mark.cuda

# (k, stride, t_in, cin, cout, pad_lo, out_len): ragged m tiles, ragged
# Cout tiles, each CUDA-core kernel (gemm, thin_cout), strides other than 4
GEOMS = [
    (25, 4, 16, 96, 130, None, None),     # short m: elements share a tile
    (25, 4, 70, 40, 64, None, None),      # ragged m
    (25, 4, 300, 24, 1, None, None),      # thin Cout: every phase a block
    (9, 4, 33, 17, 20, None, None),       # pad_lo=4
    (25, 7, 21, 32, 33, None, None),
    (25, 5, 9, 33, 7, None, None),
    (9, 3, 50, 8, 40, None, None),
    (9, 4, 10, 8, 5, 3, 38),              # out_len % stride != 0
    (5, 2, 12, 6, 3, 0, 24),
    # bf16 takes the tensor cores here (Cin, Cout >= 64, multiples of 8)
    (25, 4, 16, 128, 136, None, None),    # m_out 16: stacked, ragged Cout
    (25, 4, 70, 64, 64, None, None),      # ragged m
    (25, 4, 40, 72, 64, None, None),      # ragged channel chunk
    (9, 4, 10, 64, 72, 3, 38),            # out_len % stride != 0
    (25, 7, 21, 64, 80, None, None),      # stride 7
    (9, 16, 5, 64, 64, 4, 80),            # phases without a tap
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
    before_tc = tconv.conv_transpose1d_ba.launches_tc
    before_cc = tconv.conv_transpose1d_ba.launches_cc
    got = tconv.conv_transpose1d_ba(x, w, b, s, pad_lo=pad_lo,
                                    out_len=out_len, act=act, slope=0.3)
    torch.cuda.synchronize()
    assert tconv.conv_transpose1d_ba.launches == before + 1
    tc = tconv.convt_tensor_core(dtype, x.shape[2], w.shape[2], w.shape[0], s)
    assert tconv.conv_transpose1d_ba.launches_tc == before_tc + int(tc)
    assert tconv.conv_transpose1d_ba.launches_cc == before_cc + int(not tc)
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


# (k, stride, t_in, cin, cout, pad_lo, pad_hi): each CUDA-core kernel
# (thin_cin for Cin < 8; the gemm, short rows of several batch elements in
# one tile), ragged t and Cout tiles, strides 2-4, pads below SAME
# (autodiff's dx of a convT) and pad_lo >= stride
CONV1D_GEOMS = [
    (25, 4, 1000, 1, 64, 10, 11),       # Cin < 8: thin_cin
    (25, 4, 64, 96, 130, 10, 11),       # t_out 16: elements share a tile
    (25, 4, 80, 40, 33, 10, 11),        # t_out 20
    (25, 4, 300, 24, 70, 12, 9),        # ragged t and Cout tiles
    (9, 2, 70, 17, 20, 4, 0),
    (9, 3, 50, 8, 40, 4, 4),
    (5, 1, 40, 9, 7, 2, 2),
    (25, 4, 41, 3, 5, 14, 0),
    # bf16 takes the tensor cores here (Cin, Cout >= 64, multiples of 8,
    # T % s == 0)
    (25, 4, 64, 128, 136, 10, 11),      # t_out 16: stacked, ragged Cout
    (25, 4, 80, 64, 64, 10, 11),        # t_out 20: 3 per 64-row tile
    (25, 4, 1000, 64, 72, 12, 9),       # ragged t tiles, hi below SAME
    (9, 2, 70, 72, 64, 4, 0),           # ragged channel chunk, stride 2
    (5, 1, 40, 64, 64, 2, 2),           # stride 1
    (25, 4, 41, 64, 64, 14, 0),         # T % s != 0: the CUDA-core gemm
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "leaky_relu", "tanh"])
@pytest.mark.parametrize("geom", CONV1D_GEOMS, ids=str)
def test_conv1d_kernel_matches_plain(cuda_device, geom, act, dtype):
    k, s, t_in, cin, cout, lo, hi = geom
    x, w, b = _inputs((k, s, t_in, cin, cout, None, None), dtype,
                      cuda_device, seed=1)
    before = tconv.conv1d_ba.launches
    before_tc = tconv.conv1d_ba.launches_tc
    before_cc = tconv.conv1d_ba.launches_cc
    got = tconv.conv1d_ba(x, w, b, s, lo, hi, act, 0.3)
    torch.cuda.synchronize()
    assert tconv.conv1d_ba.launches == before + 1
    tc = tconv.conv1d_tensor_core(dtype, t_in, cin, cout, k, s)
    assert tconv.conv1d_ba.launches_tc == before_tc + int(tc)
    assert tconv.conv1d_ba.launches_cc == before_cc + int(not tc)
    want = tconv.conv1d_ba_plain(x.float(), w.float(), b.float(), s, lo, hi,
                                 act, 0.3)
    assert got.dtype == dtype and got.shape == want.shape
    # f32: the same sums in another order; bf16: one rounding of the output
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    err = (got.float() - want).abs().max().item()
    assert err <= rel * want.abs().max().item(), err


# the tensor-core path at each of its tiles: (family, geometry) with
# geometry as in CONV1D_GEOMS / GEOMS
TC_TILE_CASES = [
    ("conv1d", (25, 4, 64, 128, 136, 10, 11)),
    ("conv1d", (25, 4, 1000, 64, 72, 12, 9)),
    ("convt1d", (25, 4, 16, 128, 136, 12, 64)),
    ("convt1d", (25, 4, 70, 72, 64, 12, 280)),
]


def _tc_call(family, geom, tile, device, dtype=torch.bfloat16):
    """(kernel with the plan of `tile`, plain form) on the same inputs."""
    k, s, t_in, cin, cout, lo, hi_or_len = geom
    x, w, b = _inputs((k, s, t_in, cin, cout, None, None), dtype, device,
                      seed=2)
    if family == "conv1d":
        t_out = tconv.conv1d_t_out(t_in, k, s, lo, hi_or_len)
        plan = tconv.conv1d_tc_plan(3, t_in, cout, k, s, lo, hi_or_len, tile)

        def kernel():
            y = torch.empty(3, t_out, cout, dtype=dtype, device=device)
            tconv._conv1d_tc(x, w, b, y, s, plan, "leaky_relu", 0.3)
            return y
        want = tconv.conv1d_ba_plain(x.float(), w.float(), b.float(), s, lo,
                                     hi_or_len, "leaky_relu", 0.3)
    else:
        plan = tconv.convt_tc_plan(3, cout, k, s, lo, hi_or_len, tile)

        def kernel():
            y = torch.empty(3, hi_or_len, cout, dtype=dtype, device=device)
            tconv._convt_tc(x, w, b, y, plan, "leaky_relu", 0.3)
            return y
        want = tconv.conv_transpose1d_ba_plain(
            x.float(), w.float(), b.float(), s, lo, hi_or_len, "leaky_relu",
            0.3)
    return kernel, want


@pytest.mark.parametrize("tile", range(len(tconv.TC_TILES)))
@pytest.mark.parametrize("family,geom", TC_TILE_CASES, ids=str)
def test_tensor_core_tiles_match_plain_and_repeat_bit_for_bit(
        cuda_device, family, geom, tile):
    """Every tile of the tensor-core kernel against the plain form (one
    rounding of the output, as above), and two launches give the same
    bits: each output sums in one fixed order."""
    kernel, want = _tc_call(family, geom, tile, cuda_device)
    first, second = kernel(), kernel()
    torch.cuda.synchronize()
    err = (first.float() - want).abs().max().item()
    assert err <= 2e-2 * want.abs().max().item(), err
    assert torch.equal(first, second)


def test_tensor_core_path_refuses_a_misaligned_tensor(cuda_device):
    """TMA reads 16-byte aligned bases: the wrapper raises, it does not
    reroute to the CUDA-core kernels."""
    x, w, b = _inputs((25, 4, 65, 64, 64, None, None), torch.bfloat16,
                      cuda_device)
    shifted = x.flatten()[1:1 + 3 * 64 * 64].view(3, 64, 64)
    assert shifted.is_contiguous()
    before = tconv.conv1d_ba.launches
    with pytest.raises(ValueError, match="aligned"):
        tconv.conv1d_ba(shifted, w, b, 4, 10, 11)
    with pytest.raises(ValueError, match="aligned"):
        tconv.conv_transpose1d_ba(shifted, w, b, 4)
    assert tconv.conv1d_ba.launches == before


# the CUDA-core kernels (csrc/conv_cc.cuh) at every tile of their kind:
# (family, (k, stride, t_in, cin, cout, pad_lo, pad_hi or out_len))
CC_TILE_CASES = [
    ("convt1d", (25, 3, 12, 40, 72, 24, 58)),     # gemm: rows of 3 elements
                                                  # per tile, a cp D4 dx's pads
    ("convt1d", (9, 4, 4, 33, 40, 4, 16)),        # gemm, m <= 16, Cin % 4 != 0
    ("convt1d", (25, 7, 300, 24, 1, 15, 2097)),   # thin_cout, every phase
    ("convt1d", (25, 4, 40, 36, 16, 14, 160)),    # thin_cout, N in groups
    ("convt1d", (25, 4, 64, 128, 32, 14, 256)),   # gemm, Cout 32
    ("conv1d", (25, 7, 61, 24, 40, 0, 0)),        # gemm, t_in % s != 0
    ("conv1d", (25, 5, 40, 40, 130, 12, 8)),      # gemm, short rows, ragged
    ("conv1d", (9, 2, 70, 20, 30, 4, 0)),         # gemm, Cout 30: scalar
                                                  # stores
    ("conv1d", (25, 4, 777, 1, 70, 10, 11)),      # thin_cin
    ("conv1d", (25, 7, 300, 3, 33, 9, 9)),        # thin_cin, three channels
]


def _cc_call(family, geom, tile, device, dtype, x=None):
    """(kernel with the CUDA-core plan of `tile`, plain form) on the same
    inputs; x replaces the input (another copy of the same values)."""
    k, s, t_in, cin, cout, lo, hi_or_len = geom
    x0, w, b = _inputs((k, s, t_in, cin, cout, None, None), dtype, device,
                       seed=4)
    x = x0 if x is None else x
    if family == "conv1d":
        t_out = tconv.conv1d_t_out(t_in, k, s, lo, hi_or_len)
        plan = tconv.conv1d_cc_plan(dtype, 3, t_in, cin, cout, k, s, lo,
                                    hi_or_len, tile)
        lib, y_len = tconv._conv1d_lib(), t_out
        want = tconv.conv1d_ba_plain(x0.float(), w.float(), b.float(), s, lo,
                                     hi_or_len, "leaky_relu", 0.3)
    else:
        plan = tconv.convt_cc_plan(dtype, 3, t_in, cin, cout, k, s, lo,
                                   hi_or_len, tile)
        lib, y_len = tconv._kernel_lib(), hi_or_len
        want = tconv.conv_transpose1d_ba_plain(
            x0.float(), w.float(), b.float(), s, lo, hi_or_len, "leaky_relu",
            0.3)

    def kernel():
        y = torch.full((3, y_len, cout), float("nan"), dtype=dtype,
                       device=device)
        tconv._cc_launch(lib, family, x, w, b, y, plan, "leaky_relu", 0.3)
        return y
    return kernel, want, x0, int(plan[0])


def _cc_cases():
    out = []
    for family, geom in CC_TILE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            kind = tconv.cc_kind(family, dtype, geom[3], geom[4], geom[0],
                                 geom[1], geom[5])
            out += [(family, geom, dtype, t)
                    for t in tconv.cc_tiles(kind, geom[4])]
    return out


@pytest.mark.parametrize("family,geom,dtype,tile", _cc_cases(), ids=str)
def test_cuda_core_tiles_match_plain_and_repeat_bit_for_bit(
        cuda_device, family, geom, dtype, tile):
    """Every tile of each CUDA-core kernel against the plain form (f32
    within 1e-4, bf16 within 2e-2 of the peak: the same sums in another
    order, one rounding of the output), every output written (the output
    starts as NaN), and two launches give the same bits."""
    kernel, want, _, _ = _cc_call(family, geom, tile, cuda_device, dtype)
    first, second = kernel(), kernel()
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    err = (first.float() - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err
    assert torch.equal(first, second)


@pytest.mark.parametrize("family,geom,dtype", [
    ("convt1d", CC_TILE_CASES[0][1], torch.float32),    # gemm, cp.async
    ("convt1d", CC_TILE_CASES[2][1], torch.bfloat16),   # thin_cout, cp.async
    ("conv1d", CC_TILE_CASES[4][1], torch.float32)], ids=str)
def test_cuda_core_staging_route_keeps_the_bits(cuda_device, family, geom,
                                                dtype):
    """A tensor off a 16-byte boundary stages through plain loads instead
    of cp.async; the sums run in the same order, so the bits are the
    same as from an aligned copy."""
    kernel, _, x0, _ = _cc_call(family, geom, None, cuda_device, dtype)
    shifted = torch.empty(x0.numel() + 1, dtype=dtype, device=cuda_device)
    x1 = shifted[1:].view(x0.shape)
    x1.copy_(x0)
    assert x1.data_ptr() % 16
    off, _, _, _ = _cc_call(family, geom, None, cuda_device, dtype, x=x1)
    assert torch.equal(kernel(), off())


@pytest.mark.parametrize("mu", [255.0, 0.0])
@pytest.mark.parametrize("mode", ["peak", "rms", "none"])
@pytest.mark.parametrize("store,clip", [(16384, 16384), (20000, 16384),
                                        (1000, 1280), (1300, 1024)])
def test_ingest_kernel_matches_plain(cuda_device, store, clip, mode, mu):
    gen = torch.Generator(cuda_device).manual_seed(store)
    raw = (torch.randn(5, store, generator=gen, device=cuda_device) * 7000
           ).clamp(-32768, 32767).to(torch.int16)
    offs = torch.randint(0, max(store - clip, 0) + 1, (5,), generator=gen,
                         device=cuda_device, dtype=torch.int32)
    before = tingest.ingest_fused.launches
    got = tingest.ingest_fused(raw, offs, clip, mode, 0.999, mu)
    torch.cuda.synchronize()
    assert tingest.ingest_fused.launches == before + 1
    want = tingest.ingest_fused_plain(raw, offs, clip, mode, 0.999, mu)
    assert got.dtype == torch.float32 and got.shape == (5, clip)
    # |y| <= 1; log1pf and one division on the card against torch
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("cluster", [4, 8])
@pytest.mark.parametrize("mu", [255.0, 0.0])
@pytest.mark.parametrize("mode", ["peak", "rms", "none"])
@pytest.mark.parametrize("store", [16384, 20000])
def test_ingest_cluster_kernel_repeats_bit_for_bit(cuda_device, store, mode,
                                                   mu, cluster):
    """K2 at the flagship's geometry (store = clip) and the slack one
    (store 20000, random offsets of every residue mod 8), at both cluster
    sizes: within 1e-5 of the plain form, two launches to the same bits;
    and on a view that starts off a 16-byte boundary (its unaligned head
    and tail) the same, and for peak and none the same bits as on its
    aligned copy (an RMS sum takes another order there)."""
    gen = torch.Generator(cuda_device).manual_seed(store + cluster)
    raw = (torch.randn(64, store, generator=gen, device=cuda_device) * 7000
           ).clamp(-32768, 32767).to(torch.int16)
    offs = torch.randint(0, store - 16384 + 1, (64,), generator=gen,
                         device=cuda_device, dtype=torch.int32)

    def launch(r):
        return tingest._ingest_launch(r, offs, 16384, mode, 0.999, mu, 1e-8,
                                      cluster)
    first, second = launch(raw), launch(raw)
    want = tingest.ingest_fused_plain(raw, offs, 16384, mode, 0.999, mu)
    assert (first - want).abs().max().item() <= 1e-5
    assert torch.equal(first, second)
    view = torch.empty(64 * store + 3, dtype=torch.int16,
                       device=cuda_device)[3:].view(64, store)
    view.copy_(raw)
    assert view.data_ptr() % 16
    got = launch(view)
    assert (got - want).abs().max().item() <= 1e-5
    assert torch.equal(got, launch(view))
    if mode != "rms":
        assert torch.equal(got, first)
    if cluster == tingest.ingest_cluster(16384):
        assert torch.equal(tingest.ingest_fused(raw, offs, 16384, mode,
                                                0.999, mu), first)


def _tiny_cfg(dual: bool = False):
    """The tiny WaveGAN config; ``dual``: with the STFT critic beside the
    wave critic and G's spectral term, at one resolution (128, 32, 128)."""
    from audiogan_tpu_torch.config import Config, DataCfg, LossCfg, ModelCfg
    stft = dict(use_stft_critic=True,
                stft_resolutions=((128, 32, 128),)) if dual else {}
    return Config(data=DataCfg(clip_len=1024, store_len=1280),
                  model=ModelCfg(model_dim=4, kernel_size=25,
                                 strides=(4, 4, 4), max_channels=32,
                                 phase_shuffle=2, **stft),
                  loss=LossCfg(stft_loss_weight=1.0 if dual else 0.0)
                  ).validate()


def _raw_views(cfg, batch):
    from audiogan_tpu_torch.train.step import num_views
    gen = torch.Generator().manual_seed(0)
    n = num_views(cfg)
    raw = (torch.randn(n, batch, cfg.data.store_len, generator=gen)
           * 6000).clamp(-32768, 32767).to(torch.int16)
    return raw, torch.zeros(n, batch, dtype=torch.long)


@pytest.mark.parametrize("fused_sites", [0, -1, "dual"])
def test_second_order_through_kernels_matches_cpu(cuda_device, fused_sites):
    """The penalty's double backprop and the generator's backward through
    the kernels (every conv, dx and d/dct a launch; with fused shuffle
    sites K6 and K7 too; "dual": the dual critic, whose STFT critic runs
    cuDNN's conv2d and the DFT matmuls) against the same Functions on the
    CPU (plain forms), same weights, f32: gradients within 1e-4 relative
    L2 over each tensor."""
    import dataclasses

    from audiogan_tpu_torch.losses import gradient_penalty, wgan_g_loss
    from audiogan_tpu_torch.models import (build_discriminator,
                                           build_generator)
    from audiogan_tpu_torch.models.init import init_params
    dual = fused_sites == "dual"
    cfg = _tiny_cfg(dual)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, fused_shuffle_sites=0 if dual else fused_sites))
    sconv_before = (tsconv.sconv1d_ba.launches, tsconv.sconvt1d.launches)
    cpu = torch.device("cpu")
    g = init_params(build_generator(cfg, device=cpu), 0)
    d = init_params(build_discriminator(cfg, device=cpu), 1)
    nets = {"cpu": (g, d)}
    g2, d2 = (build_generator(cfg, device=cuda_device),
              build_discriminator(cfg, device=cuda_device))
    g2.load_state_dict(g.state_dict())
    d2.load_state_dict(d.state_dict())
    nets["cuda"] = (g2, d2)
    gen = torch.Generator().manual_seed(0)
    real = torch.rand(3, 1024, 1, generator=gen) * 2 - 1
    z = torch.randn(3, cfg.model.latent_dim, generator=gen)
    eps = torch.rand(3, generator=gen)
    shifts = torch.randint(-2, 3, (2, 3), generator=gen)
    grads = {}
    for name, (g, d) in nets.items():
        dev = next(g.parameters()).device
        fake = g(z.to(dev))
        gp, _ = gradient_penalty([lambda v: d(v, None, shifts.to(dev))],
                                 real.to(dev), fake.detach(), eps.to(dev))
        loss = gp + wgan_g_loss(d(fake, None, shifts.to(dev)))
        params = list(g.parameters()) + list(d.parameters())
        grads[name] = torch.autograd.grad(loss, params)
    assert tconv.conv1d_ba.launches > 0
    assert tconv.conv_transpose1d_ba.launches > 0
    if fused_sites == -1:
        assert tsconv.sconv1d_ba.launches > sconv_before[0]
        assert tsconv.sconvt1d.launches > sconv_before[1]
    for gc, gg in zip(grads["cpu"], grads["cuda"]):
        err = (gg.cpu() - gc).norm().item()
        assert err <= 1e-4 * max(gc.norm().item(), 1e-12), err


def _tiny_gru_cfg():
    """A conditional GRU generator whose scans take the persistent path in
    bf16 (H = F = 64)."""
    from audiogan_tpu_torch.config import Config, DataCfg, ModelCfg
    return Config(data=DataCfg(clip_len=2048, store_len=2048, num_classes=10),
                  model=ModelCfg(generator="gru", model_dim=16,
                                 kernel_size=25, gru_frame_size=64,
                                 gru_hidden=64)).validate()


@pytest.mark.parametrize("fused_sites,dtype", [(0, "float32"),
                                               (-1, "float32"),
                                               (0, "bfloat16"),
                                               ("gru", "bfloat16"),
                                               ("dual", "float32"),
                                               ("dual", "bfloat16")])
def test_train_step_on_card_is_bit_reproducible(cuda_device, fused_sites,
                                                dtype):
    """Two runs of two training steps from one seed on the same data give
    the same parameters to the bit: no kernel and no weight gradient sums
    in a run-dependent order. The bf16 case runs the tensor-core convs
    (the model is widened to 64 channels for it); the "gru" case the
    conditional GRU generator, whose scans (K4, K5) take the persistent
    path; the "dual" case the dual critic and G's spectral term (the STFT
    framing's backward, cuDNN's conv2d with its weight gradient and
    double backward, one more ingest per step)."""
    import dataclasses

    from audiogan_tpu_torch.train.state import create_train_state
    from audiogan_tpu_torch.train.step import build_train_step
    batch = 16
    if fused_sites == "gru":
        cfg = _tiny_gru_cfg()
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, dtype=dtype,
                                                    batch_size=batch))
    else:
        dual = fused_sites == "dual"
        cfg = _tiny_cfg(dual)
        width = {} if dtype == "float32" else {"model_dim": 64,
                                               "max_channels": 128}
        cfg = cfg.replace(
            model=dataclasses.replace(
                cfg.model, fused_shuffle_sites=0 if dual else fused_sites,
                **width),
            train=dataclasses.replace(cfg.train, dtype=dtype,
                                      batch_size=batch))
    tc_before = tconv.conv1d_ba.launches_tc
    scan_before = (tgru.gru_scan_fwd.launches_persistent,
                   tgru.gru_scan_bwd.launches_persistent)
    ingest_before = tingest.ingest_fused.launches
    raw, labels = _raw_views(cfg, batch)
    runs = []
    for _ in range(2):
        state = create_train_state(cfg, device=cuda_device)
        step = build_train_step(cfg, cuda_device)
        for _ in range(2):
            step(state, raw, labels)
        runs.append([p.detach().cpu() for p in (*state.g.parameters(),
                                                *state.d.parameters())])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert (tconv.conv1d_ba.launches_tc > tc_before) == (dtype == "bfloat16")
    # one ingest per real view: n_critic, and G's with the spectral term
    assert tingest.ingest_fused.launches - ingest_before == 2 * 2 * len(raw)
    if fused_sites == "gru":
        # per step: the critic's n_critic fakes and G's own pass, one K5
        steps = 2 * 2
        assert (tgru.gru_scan_fwd.launches_persistent - scan_before[0],
                tgru.gru_scan_bwd.launches_persistent - scan_before[1]) == \
            (steps * (cfg.loss.n_critic + 1), steps)


def _preset_cfg(name: str, dtype: str, batch: int):
    """A preset at its published widths, run as one device (music_44k_dp16
    with mesh.dp=1), in dtype at batch."""
    from audiogan_tpu_torch.cli import apply_overrides
    from audiogan_tpu_torch.config import get_preset
    sets = ["mesh.dp=1"] if name == "music_44k_dp16" else []
    return apply_overrides(get_preset(name), sets + [
        f"train.dtype={dtype}", f"train.batch_size={batch}"]).validate()


@pytest.mark.parametrize("name,dtype", [("music_44k_dp16", "bfloat16"),
                                        ("music_44k_dp16", "float32"),
                                        ("resample_22k", "float32"),
                                        ("resample_22k", "bfloat16")])
def test_long_clip_and_resample_steps_on_card_are_bit_reproducible(
        cuda_device, name, dtype):
    """music_44k_dp16 (mesh.dp=1, 176400-sample clips, strides 7/7/5/5/3)
    and resample_22k (its ingest resampled in plain torch ops, never K2)
    at full width, batch 4: two runs of two steps from one seed give the
    same parameters to the bit."""
    from audiogan_tpu_torch.train.state import create_train_state
    from audiogan_tpu_torch.train.step import build_train_step
    batch = 4
    cfg = _preset_cfg(name, dtype, batch)
    raw, labels = _raw_views(cfg, batch)
    ingest_before = tingest.ingest_fused.launches
    runs = []
    for _ in range(2):
        state = create_train_state(cfg, device=cuda_device)
        step = build_train_step(cfg, cuda_device)
        for _ in range(2):
            metrics = step(state, raw, labels)
        assert all(torch.isfinite(v) for v in metrics.values())
        runs.append([p.detach().cpu() for p in (*state.g.parameters(),
                                                *state.d.parameters())])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    resampled = cfg.data.sample_rate != cfg.data.source_rate
    assert tingest.ingest_fused.launches - ingest_before == (
        0 if resampled else 2 * 2 * len(raw))


_FIRST_STEPS = """
import dataclasses, hashlib, json, sys
import torch
sys.path.insert(0, {tests!r})
import test_torch_cuda as t
from audiogan_tpu_torch.train.state import create_train_state
from audiogan_tpu_torch.train.step import build_train_step
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
batch, fused_sites, dtype = 16, {fused_sites!r}, {dtype!r}
dual = fused_sites == "dual"
if fused_sites in ("music_44k_dp16", "resample_22k"):
    batch = 4
    cfg = t._preset_cfg(fused_sites, dtype, batch)
else:
    cfg = t._tiny_cfg(dual)
    width = {{}} if dtype == "float32" else {{"model_dim": 64,
                                            "max_channels": 128}}
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model,
                                  fused_shuffle_sites=0 if dual
                                  else fused_sites, **width),
        train=dataclasses.replace(cfg.train, dtype=dtype, batch_size=batch))
raw, labels = t._raw_views(cfg, batch)
hashes = []
for _ in range(2):
    state = create_train_state(cfg, device=dev)
    step = build_train_step(cfg, dev)
    step(state, raw, labels)
    params = (*state.g.parameters(), *state.d.parameters())
    hashes.append(hashlib.sha256(b"".join(
        p.detach().cpu().numpy().tobytes() for p in params)).hexdigest())
print(json.dumps(hashes))
"""


@pytest.mark.parametrize("fused_sites,dtype", [(0, "float32"),
                                               (-1, "bfloat16"),
                                               ("dual", "bfloat16"),
                                               ("music_44k_dp16", "float32"),
                                               ("music_44k_dp16", "bfloat16"),
                                               ("resample_22k", "float32"),
                                               ("resample_22k", "bfloat16")])
def test_first_train_step_of_a_fresh_process_is_bit_reproducible(
        cuda_device, fused_sites, dtype):
    """The first training step of a fresh process, run twice in it, and
    in a second fresh process, gives the same parameters to the bit: the
    first step of a process (its autograd engine, its libraries' first
    calls) is no different from the later ones. Each process is its own
    interpreter, so no earlier test can have warmed anything up. A preset
    name runs that preset at full width, batch 4."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    tests = Path(__file__).resolve().parent
    script = _FIRST_STEPS.format(tests=str(tests), fused_sites=fused_sites,
                                 dtype=dtype)
    hashes = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", script],
                             cwd=tests.parent, capture_output=True,
                             text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        hashes += json.loads(out.stdout.strip().splitlines()[-1])
    assert len(set(hashes)) == 1, hashes


# (B, H, F, n_frames): ragged against every gemm tile (32, 64, 128), a
# batch that fills 64-row tiles, and one frame
GRU_SCANS = [(3, 20, 12, 7), (64, 64, 32, 16), (5, 33, 17, 9), (2, 8, 4, 1),
             (130, 24, 8, 3)]


def _gru_inputs(shape, dtype, device, seed=0):
    """Weights at the model's scales (glorot-sized, w_h ~ 1/sqrt(H)): with
    much larger weights the recurrence amplifies rounding, and the plain
    form in f32 itself drifts from float64."""
    b, hid, feat, _ = shape
    gen = torch.Generator(device).manual_seed(seed)

    def r(*s, scale=1.0):
        return torch.randn(*s, generator=gen, device=device) * scale

    def glorot(n_in, n_out):
        return r(n_in, n_out, scale=(2.0 / (n_in + n_out)) ** 0.5)
    args = [torch.tanh(r(b, hid)), r(b, feat), glorot(2 * feat, 3 * hid),
            r(hid, 3 * hid, scale=hid ** -0.5), r(3 * hid, scale=0.1),
            r(3 * hid, scale=0.1), glorot(feat, feat), glorot(hid, feat),
            r(feat, scale=0.1)]
    return [a.to(dtype) for a in args]


def _bf16_ulp(peak: float) -> float:
    import math
    return 2.0 ** (math.floor(math.log2(max(peak, 1e-30))) - 7)


@pytest.mark.parametrize("with_h", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GRU_SCANS, ids=str)
def test_gru_scan_kernel_matches_plain(cuda_device, shape, dtype, with_h):
    n = shape[3]
    args = _gru_inputs(shape, dtype, cuda_device)
    before = tgru.gru_scan_fwd.launches
    got = tgru.gru_scan_fwd(*args, n, with_h=with_h)
    torch.cuda.synchronize()
    assert tgru.gru_scan_fwd.launches == before + 1
    want = tgru.gru_scan_plain(*args, n, with_h=with_h)
    pairs = zip(got, want) if with_h else [(got, want)]
    for g, w in pairs:
        assert g.dtype == dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs().max().item()
        peak = w.float().abs().max().item()
        # f32: the same sums in another order; bf16: the same f32 values
        # before the one rounding of the output
        tol = 1e-4 * peak if dtype == torch.float32 else _bf16_ulp(peak)
        assert err <= tol, (err, peak)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GRU_SCANS, ids=str)
def test_gru_scan_bwd_kernel_matches_plain(cuda_device, shape, dtype):
    b, _, feat, n = shape
    args = _gru_inputs(shape, dtype, cuda_device, seed=1)
    out, h_seq = tgru.gru_scan_fwd(*args, n, with_h=True)
    gen = torch.Generator(cuda_device).manual_seed(2)
    g = torch.randn(b, n, feat, generator=gen, device=cuda_device).to(dtype)
    before = tgru.gru_scan_bwd.launches
    got = tgru.gru_scan_bwd(g, *args, out, h_seq)
    torch.cuda.synchronize()
    assert tgru.gru_scan_bwd.launches == before + 1
    want = tgru.gru_scan_bwd_plain(g, *args, out, h_seq)
    # relative L2 per gradient: sums over frames and rows in another order
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    for name, a, gk, w in zip(tgru.ARG_NAMES, args, got, want):
        assert gk.dtype == a.dtype and gk.shape == a.shape, name
        err = (gk.float() - w.float()).norm().item()
        assert err <= tol * max(w.float().norm().item(), 1e-12), name


@pytest.mark.parametrize("frames", [1, 2, 256])
@pytest.mark.parametrize("batch", [1, 7, 64])
def test_persistent_gru_scan_matches_plain_and_repeats_bit_for_bit(
        cuda_device, batch, frames):
    """K4 (with and without h_seq) and K5 on the persistent path at
    cond_gru_sc09's widths (H 512, F 256), bf16: K4 within one bf16 ulp of
    the plain form's peak, K5 within 1e-3 relative L2 per gradient, and a
    second launch gives the same bits."""
    shape = (batch, 512, 256, frames)
    args = _gru_inputs(shape, torch.bfloat16, cuda_device, seed=3)
    assert tgru.gru_scan_persistent(torch.bfloat16, batch, 512, 256)
    before = (tgru.gru_scan_fwd.launches_persistent,
              tgru.gru_scan_bwd.launches_persistent)
    for with_h in (False, True):
        runs = [tgru.gru_scan_fwd(*args, frames, with_h=with_h)
                for _ in range(2)]
        torch.cuda.synchronize()
        want = tgru.gru_scan_plain(*args, frames, with_h=with_h)
        pairs = (zip(runs[0], runs[1], want) if with_h
                 else [(runs[0], runs[1], want)])
        for a, b, w in pairs:
            assert torch.equal(a, b)
            err = (a.float() - w.float()).abs().max().item()
            assert err <= _bf16_ulp(w.float().abs().max().item()), err
    out, h_seq = runs[0]
    gen = torch.Generator(cuda_device).manual_seed(4)
    g = torch.randn(batch, frames, 256, generator=gen,
                    device=cuda_device).bfloat16()
    grads = [tgru.gru_scan_bwd(g, *args, out, h_seq) for _ in range(2)]
    torch.cuda.synchronize()
    want = tgru.gru_scan_bwd_plain(g, *args, out, h_seq)
    for name, a, b, w in zip(tgru.ARG_NAMES, *grads, want):
        assert torch.equal(a, b), name
        err = (a.float() - w.float()).norm().item()
        assert err <= 1e-3 * max(w.float().norm().item(), 1e-12), name
    assert (tgru.gru_scan_fwd.launches_persistent - before[0],
            tgru.gru_scan_bwd.launches_persistent - before[1]) == (4, 2)


def test_gru_generator_on_card_matches_cpu(cuda_device):
    """The conditional GRU G, f32, forward and first-order backward
    through K4, K5 and K1 against the same module on the CPU (plain
    forms): output 1e-4 of the peak, gradients 1e-4 relative L2 each."""
    from audiogan_tpu_torch.config import Config, DataCfg, ModelCfg
    from audiogan_tpu_torch.models import build_generator
    from audiogan_tpu_torch.models.init import init_params
    cfg = Config(data=DataCfg(clip_len=2048, store_len=2048, num_classes=10),
                 model=ModelCfg(generator="gru", model_dim=16, kernel_size=25,
                                gru_frame_size=64, gru_hidden=64)).validate()
    g_cpu = init_params(build_generator(cfg, device="cpu"), 0)
    g_card = build_generator(cfg, device=cuda_device)
    g_card.load_state_dict(g_cpu.state_dict())
    gen = torch.Generator().manual_seed(0)
    z = torch.randn(4, cfg.model.latent_dim, generator=gen)
    labels = torch.tensor([0, 3, 9, 3])
    ct = torch.randn(4, 2048, 1, generator=gen)
    outs, grads = {}, {}
    before = (tgru.gru_scan_fwd.launches, tgru.gru_scan_bwd.launches)
    for name, g in (("cpu", g_cpu), ("card", g_card)):
        dev = next(g.parameters()).device
        y = g(z.to(dev), labels.to(dev))
        outs[name] = y.detach().cpu()
        grads[name] = torch.autograd.grad((y * ct.to(dev)).sum(),
                                          list(g.parameters()))
    assert (tgru.gru_scan_fwd.launches, tgru.gru_scan_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    err = (outs["card"] - outs["cpu"]).abs().max().item()
    assert err <= 1e-4 * outs["cpu"].abs().max().item(), err
    for (name, _), gc, gg in zip(g_cpu.named_parameters(), grads["cpu"],
                                 grads["card"]):
        e = (gg.cpu() - gc).norm().item()
        assert e <= 1e-4 * max(gc.norm().item(), 1e-12), name


# (k, stride, rad, t, cin, cout): the four flagship site shapes cut short
# (k25 s4 rad2, with Cin >= 8 and short rows), tiny_sc09's 16 channels at
# rad 1, one input channel, t % stride != 0, strides 1-7
SCONV_GEOMS = [
    (25, 4, 2, 256, 64, 128),
    (25, 4, 2, 64, 96, 130),        # t_out 16: several elements per block
    (25, 4, 1, 128, 16, 32),
    (9, 4, 2, 50, 3, 20),           # Cin < 8
    (9, 3, 2, 41, 17, 20),
    (7, 7, 3, 49, 32, 33),
    (9, 1, 2, 30, 9, 7),
    (5, 2, 1, 23, 40, 1),           # one output channel
]


def _sconv_inputs(geom, dtype, device, seed=0):
    k, s, rad, t, cin, cout = geom
    from audiogan_tpu_torch.kernels.conv import _same_pads
    b = 2 * rad + 3
    gen = torch.Generator(device).manual_seed(seed)
    xp = torch.randn(b, t + 2 * rad, cin, generator=gen, device=device)
    w = torch.randn(k, cin, cout, generator=gen, device=device)
    w /= (k * cin / 4) ** 0.5
    bias = torch.randn(cout, generator=gen, device=device) * 0.5
    offs = (torch.arange(b, device=device) % (2 * rad + 1)).int()
    _, lo, hi = _same_pads(t, k, s)
    t_out = (t + lo + hi - k) // s + 1
    ct = torch.randn(b, t_out, cout, generator=gen, device=device)
    wf = torch.randn(k, cout, cin, generator=gen, device=device)
    wf /= (k * cout / 4) ** 0.5
    return ([a.to(dtype) for a in (xp, w, bias, ct, wf)], offs, lo, hi)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "leaky_relu"])
@pytest.mark.parametrize("geom", SCONV_GEOMS, ids=str)
def test_sconv1d_kernel_matches_plain(cuda_device, geom, act, dtype):
    k, s, rad = geom[:3]
    (xp, w, bias, _, _), offs, lo, hi = _sconv_inputs(geom, dtype,
                                                      cuda_device)
    before = tsconv.sconv1d_ba.launches
    got = tsconv.sconv1d_ba(xp, w, bias, offs, s, lo, hi, rad, act, 0.3)
    torch.cuda.synchronize()
    assert tsconv.sconv1d_ba.launches == before + 1
    want = tsconv.sconv1d_ba_plain(xp.float(), w.float(), bias.float(), offs,
                                   s, lo, hi, rad, act, 0.3)
    assert got.dtype == dtype and got.shape == want.shape
    # f32: the same sums in another order; bf16: one rounding of the output
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    err = (got.float() - want).abs().max().item()
    assert err <= rel * want.abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", SCONV_GEOMS, ids=str)
def test_sconvt1d_kernel_matches_plain(cuda_device, geom, dtype):
    k, s, rad, t = geom[:4]
    (_, _, _, ct, wf), offs, lo, _ = _sconv_inputs(geom, dtype, cuda_device,
                                                   seed=1)
    before = tsconv.sconvt1d.launches
    got = tsconv.sconvt1d(ct, wf, offs, s, k - 1 - lo, t, rad)
    torch.cuda.synchronize()
    assert tsconv.sconvt1d.launches == before + 1
    want = tsconv.sconvt1d_plain(ct.float(), wf.float(), offs, s, k - 1 - lo,
                                 t, rad)
    assert got.dtype == dtype and got.shape == want.shape
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    err = (got.float() - want).abs().max().item()
    assert err <= rel * want.abs().max().item(), err
    # the rows outside each window are written, as zeros
    from audiogan_tpu_torch.ops.sconv import _live
    assert not torch.where(_live(offs, t, rad), 0.0, got.float()).any()


def test_sconvt1d_overwrites_every_row(cuda_device):
    """The output is allocated uninitialised: a second call on the same
    caching allocator block must not show the first call's rows."""
    geom = SCONV_GEOMS[0]
    k, s, rad, t = geom[:4]
    (_, _, _, ct, wf), offs, lo, _ = _sconv_inputs(geom, torch.float32,
                                                   cuda_device, seed=2)
    first = tsconv.sconvt1d(ct, wf, offs, s, k - 1 - lo, t, rad)
    first.fill_(float("nan"))
    del first
    got = tsconv.sconvt1d(ct, wf, offs.flip(0).contiguous(), s, k - 1 - lo,
                          t, rad)
    assert torch.isfinite(got).all()


# (B, in, H): cond_gru_sc09's cell, ragged against the 16 x 16 tile, and
# depths that are not multiples of the 32-deep chunk
GRU_CELLS = [(64, 512, 512), (5, 20, 33), (17, 1, 7), (130, 48, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GRU_CELLS, ids=str)
def test_gru_cell_kernel_matches_plain(cuda_device, shape, dtype):
    b, in_dim, hid = shape
    gen = torch.Generator(cuda_device).manual_seed(0)

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device=cuda_device)
                * scale).to(dtype)
    args = (r(b, in_dim), torch.tanh(r(b, hid)),
            r(in_dim, 3 * hid, scale=(1.0 / in_dim) ** 0.5),
            r(hid, 3 * hid, scale=hid ** -0.5), r(3 * hid, scale=0.1),
            r(3 * hid, scale=0.1))
    before = tgru.gru_cell_fwd.launches
    got = tgru.gru_cell_fwd(*args)
    torch.cuda.synchronize()
    assert tgru.gru_cell_fwd.launches == before + 1
    want = tgru.gru_cell_plain(*(a.float() for a in args))
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want).abs().max().item()
    peak = want.abs().max().item()
    # f32: the same sums in another order; bf16: the same f32 values
    # before the one rounding of h'
    tol = 1e-4 * peak if dtype == torch.float32 else _bf16_ulp(peak)
    assert err <= tol, (err, peak)


def test_gru_cell_recurrence_on_card_matches_cpu(cuda_device):
    """A 16-frame recurrence through gru_cell(impl="pallas"), f32, forward
    through K3 and backward in torch, against the CPU: h within 1e-4 of
    the peak, gradients within 1e-4 relative L2 each."""
    from audiogan_tpu_torch.ops.gru import gru_cell
    b, in_dim, hid, n = 8, 24, 40, 16
    gen = torch.Generator().manual_seed(1)
    xs = torch.randn(n, b, in_dim, generator=gen)
    params = [torch.randn(in_dim, 3 * hid, generator=gen) / in_dim ** 0.5,
              torch.randn(hid, 3 * hid, generator=gen) / hid ** 0.5,
              torch.randn(3 * hid, generator=gen) * 0.1,
              torch.randn(3 * hid, generator=gen) * 0.1]
    h0 = torch.tanh(torch.randn(b, hid, generator=gen))
    outs, grads = {}, {}
    before = tgru.gru_cell_fwd.launches
    for dev in ("cpu", cuda_device):
        leaves = [t.to(dev).requires_grad_(True) for t in (xs, h0, *params)]
        h = leaves[1]
        for t in range(n):
            h = gru_cell(leaves[0][t], h, *leaves[2:], impl="pallas")
        outs[str(dev)] = h.detach().cpu()
        grads[str(dev)] = [g.cpu() for g in torch.autograd.grad(
            h.square().sum(), leaves)]
    assert tgru.gru_cell_fwd.launches == before + n
    want, got = outs["cpu"], outs[str(cuda_device)]
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    for gc, gg in zip(grads["cpu"], grads[str(cuda_device)]):
        assert (gg - gc).norm().item() <= 1e-4 * max(gc.norm().item(), 1e-12)


@pytest.mark.parametrize("shape", [(1, 512, 512), (7, 512, 512),
                                   (64, 512, 512), (7, 24, 40)], ids=str)
def test_gru_cell_tensor_core_matches_plain_and_repeats_bit_for_bit(
        cuda_device, shape):
    """K3's tensor-core path (bf16) at cond_gru_sc09's cell width with B
    1, 7, 64, and at a cell ragged against its tiles: within one bf16 ulp
    of the plain form's peak (the same f32 values before the one rounding
    of h'), and a second launch gives the same bits (the cluster's partial
    sums are added in rank order)."""
    b, in_dim, hid = shape
    assert tgru.gru_cell_tensor_core(torch.bfloat16, b, in_dim, hid)
    gen = torch.Generator(cuda_device).manual_seed(1)

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device=cuda_device)
                * scale).bfloat16()
    args = (r(b, in_dim), torch.tanh(r(b, hid)),
            r(in_dim, 3 * hid, scale=in_dim ** -0.5),
            r(hid, 3 * hid, scale=hid ** -0.5), r(3 * hid, scale=0.1),
            r(3 * hid, scale=0.1))
    before = tgru.gru_cell_fwd.launches_tc
    first, second = tgru.gru_cell_fwd(*args), tgru.gru_cell_fwd(*args)
    torch.cuda.synchronize()
    assert tgru.gru_cell_fwd.launches_tc == before + 2
    want = tgru.gru_cell_plain(*(a.float() for a in args))
    err = (first.float() - want).abs().max().item()
    assert err <= _bf16_ulp(want.abs().max().item()), err
    assert torch.equal(first, second)


def _site_geoms():
    """The flagship's four fused sites (D1-D4's forwards: k 25, s 4, rad
    2) at their widths and lengths."""
    from audiogan_tpu_torch.kernels.conv import _same_pads
    chans = [(64, 128), (128, 256), (256, 512), (512, 1024)]
    out = []
    for i, (cin, cout) in enumerate(chans):
        t = 16384 // 4 ** (i + 1)
        _, lo, hi = _same_pads(t, 25, 4)
        out.append((t, cin, cout, lo, hi))
    return out


@pytest.mark.parametrize("batch", [9, 64, 8, 32])
@pytest.mark.parametrize("site", range(4))
def test_sconv1d_tensor_core_sites_match_plain_and_repeat_bit_for_bit(
        cuda_device, site, batch):
    """K6 on the tensor cores at each fused site of the flagship, bf16:
    offsets mixed along the batch (each stacked tile mixes them; 9 leaves
    a stacked tile ragged), within one rounding of the output of the plain
    form, two launches to the same bits; and offsets outside [0, 2 rad]
    read as their clamped values."""
    from audiogan_tpu_torch.ops.sconv import mask_reflect_pad
    t, cin, cout, lo, hi = _site_geoms()[site]
    rad = 2
    assert tsconv.sconv1d_tensor_core(torch.bfloat16, t, cin, cout, 25, 4,
                                      rad)
    gen = torch.Generator(cuda_device).manual_seed(site)
    y = torch.randn(batch, t, cin, generator=gen, device=cuda_device)
    offs = torch.randint(0, 2 * rad + 1, (batch,), generator=gen,
                         device=cuda_device, dtype=torch.int32)
    xp = mask_reflect_pad(y, offs, rad).bfloat16()
    w = (torch.randn(25, cin, cout, generator=gen, device=cuda_device)
         / (25 * cin / 4) ** 0.5).bfloat16()
    bias = (torch.randn(cout, generator=gen, device=cuda_device)
            * 0.5).bfloat16()
    before = tsconv.sconv1d_ba.launches_tc
    first = tsconv.sconv1d_ba(xp, w, bias, offs, 4, lo, hi, rad,
                              "leaky_relu", 0.2)
    second = tsconv.sconv1d_ba(xp, w, bias, offs, 4, lo, hi, rad,
                               "leaky_relu", 0.2)
    torch.cuda.synchronize()
    assert tsconv.sconv1d_ba.launches_tc == before + 2
    want = tsconv.sconv1d_ba_plain(xp.float(), w.float(), bias.float(), offs,
                                   4, lo, hi, rad, "leaky_relu", 0.2)
    err = (first.float() - want).abs().max().item()
    assert err <= 2e-2 * want.abs().max().item(), err
    assert torch.equal(first, second)
    wild = offs.clone()
    wild[0], wild[-1] = -7, 2 * rad + 9
    clamped = wild.clamp(0, 2 * rad)
    got = tsconv.sconv1d_ba(xp, w, bias, wild, 4, lo, hi, rad, "leaky_relu",
                            0.2)
    assert torch.equal(got, tsconv.sconv1d_ba(xp, w, bias, clamped, 4, lo,
                                              hi, rad, "leaky_relu", 0.2))


@pytest.mark.parametrize("batch", [9, 64, 8, 32])
@pytest.mark.parametrize("site", range(4))
def test_sconvt1d_tensor_core_sites_match_plain_and_repeat_bit_for_bit(
        cuda_device, site, batch):
    """K7 on the tensor cores at each fused site's x-gradient, bf16:
    offsets mixed along the batch (9 leaves a stacked tile ragged), into
    memory that held NaN just before (a zero row the kernel forgot
    shows), within one rounding of the output of the plain form, zero
    outside each window, two launches to the same bits; and offsets
    outside [0, 2 rad] place the window at their clamped values."""
    from audiogan_tpu_torch.ops.sconv import _live
    t, cin, cout, lo, _ = _site_geoms()[site]
    rad, k, s = 2, 25, 4
    cc, co = cout, cin             # the dx of D(site+1): ct has its Cout
    t_out = t // s
    assert tsconv.sconvt1d_tensor_core(torch.bfloat16, cc, co, k, s, rad)
    gen = torch.Generator(cuda_device).manual_seed(10 + site)
    ct = torch.randn(batch, t_out, cc, generator=gen,
                     device=cuda_device).bfloat16()
    wf = (torch.randn(k, cc, co, generator=gen, device=cuda_device)
          / (k * cc / 4) ** 0.5).bfloat16()
    offs = torch.randint(0, 2 * rad + 1, (batch,), generator=gen,
                         device=cuda_device, dtype=torch.int32)
    offs[:5] = torch.arange(5, device=cuda_device, dtype=torch.int32)
    args = (s, k - 1 - lo, t, rad)
    before = tsconv.sconvt1d.launches_tc
    poison = torch.full((batch, t + 2 * rad, co), float("nan"),
                        dtype=torch.bfloat16, device=cuda_device)
    del poison                   # the caching allocator hands it out next
    first = tsconv.sconvt1d(ct, wf, offs, *args)
    second = tsconv.sconvt1d(ct, wf, offs, *args)
    torch.cuda.synchronize()
    assert tsconv.sconvt1d.launches_tc == before + 2
    want = tsconv.sconvt1d_plain(ct.float(), wf.float(), offs, *args)
    assert torch.isfinite(first.float()).all()
    err = (first.float() - want).abs().max().item()
    assert err <= 2e-2 * want.abs().max().item(), err
    assert not torch.where(_live(offs, t, rad), 0.0, first.float()).any()
    assert torch.equal(first, second)
    wild = offs.clone()
    wild[0], wild[-1] = -3, 2 * rad + 5
    got = tsconv.sconvt1d(ct, wf, wild, *args)
    assert torch.equal(got, tsconv.sconvt1d(ct, wf, wild.clamp(0, 2 * rad),
                                            *args))


def test_fused_bf16_train_step_on_card_is_bit_reproducible(cuda_device):
    """The flagship's tiny step widened to 64 channels with every shuffle
    site fused, bf16: K6 and K7 on the tensor cores (every launch), two
    runs of two steps from one seed to the same parameters."""
    import dataclasses

    from audiogan_tpu_torch.train.state import create_train_state
    from audiogan_tpu_torch.train.step import build_train_step
    batch = 16
    cfg = _tiny_cfg()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, fused_shuffle_sites=-1,
                                  model_dim=64, max_channels=128),
        train=dataclasses.replace(cfg.train, dtype="bfloat16",
                                  batch_size=batch))
    raw, labels = _raw_views(cfg, batch)
    before = (tsconv.sconv1d_ba.launches, tsconv.sconv1d_ba.launches_tc,
              tsconv.sconvt1d.launches, tsconv.sconvt1d.launches_tc)
    runs = []
    for _ in range(2):
        state = create_train_state(cfg, device=cuda_device)
        step = build_train_step(cfg, cuda_device)
        for _ in range(2):
            step(state, raw, labels)
        runs.append([p.detach().cpu() for p in (*state.g.parameters(),
                                                *state.d.parameters())])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    launched = tsconv.sconv1d_ba.launches - before[0]
    assert launched > 0
    assert tsconv.sconv1d_ba.launches_tc - before[1] == launched
    launched = tsconv.sconvt1d.launches - before[2]
    assert launched > 0
    assert tsconv.sconvt1d.launches_tc - before[3] == launched


def _model_geometries(preset: str, b: int):
    """A WaveGAN preset's conv geometries at batch b: ("convt1d" or
    "conv1d", name, (x's shape), kernel args after x, w, b, K, Cout): G's
    convT layers and their dx (conv1d), the critic's conv1d layers and
    their dx (convT), as kernels/autograd.py runs them."""
    from audiogan_tpu_torch.kernels.conv import _same_pads
    from audiogan_tpu_torch.models.wavegan import (_disc_channels,
                                                   _gen_channels)
    cfg = _preset_cfg(preset, "bfloat16", b)
    m, clip = cfg.model, cfg.data.clip_len
    k, n = m.kernel_size, len(m.strides)
    out = []
    t = clip // m.total_stride
    cin = min(m.model_dim * 2 ** (n - 1), m.max_channels)
    for i, (s, co) in enumerate(zip(m.strides,
                                    _gen_channels(m.model_dim, n,
                                                  m.max_channels))):
        lo = (k - 1) // 2
        out.append(("convt1d", f"G{i}", (b, t, cin), (s, lo, t * s), k, co))
        dlo = k - 1 - lo
        dhi = max((t - 1) * s + k - dlo - t * s, 0)
        out.append(("conv1d", f"G{i} dx", (b, t * s, co), (s, dlo, dhi), k,
                    cin))
        t, cin = t * s, co
    t, cin = clip, 1
    for i, (s, co) in enumerate(zip(m.strides,
                                    _disc_channels(m.model_dim, n,
                                                   m.max_channels))):
        t_out, lo, hi = _same_pads(t, k, s)
        out.append(("conv1d", f"D{i}", (b, t, cin), (s, lo, hi), k, co))
        out.append(("convt1d", f"D{i} dx", (b, t_out, co), (s, k - 1 - lo, t),
                    k, cin))
        t, cin = t_out, co
    return out


def _music_geometries():
    """music_44k_dp16's conv geometries at batch 2 (_model_geometries)."""
    return _model_geometries("music_44k_dp16", 2)


def _check_geometry(device, family, shape, args, k, cout, dtype, seed):
    """K1 or K1' at one geometry against its plain form (f32 within 1e-4,
    bf16 within 2e-2 of the output's peak), two launches to the same bits,
    on the tensor-core path exactly where its predicate holds."""
    gen = torch.Generator(device).manual_seed(seed)
    x = torch.randn(*shape, generator=gen, device=device).to(dtype)
    w = (torch.randn(k, shape[2], cout, generator=gen, device=device)
         / (k * shape[2] / 4) ** 0.5).to(dtype)
    b = (torch.randn(cout, generator=gen, device=device) * 0.5).to(dtype)
    if family == "conv1d":
        fn, plain = tconv.conv1d_ba, tconv.conv1d_ba_plain
        tc = tconv.conv1d_tensor_core(dtype, shape[1], shape[2], cout, k,
                                      args[0])
    else:
        fn, plain = (tconv.conv_transpose1d_ba,
                     tconv.conv_transpose1d_ba_plain)
        tc = tconv.convt_tensor_core(dtype, shape[2], cout, k, args[0])
    before = fn.launches_tc
    got = fn(x, w, b, *args, act="leaky_relu")
    again = fn(x, w, b, *args, act="leaky_relu")
    want = plain(x.float(), w.float(), b.float(), *args, act="leaky_relu")
    torch.cuda.synchronize()
    assert fn.launches_tc - before == (2 if tc else 0)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    err = (got.float() - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err
    assert torch.equal(got, again)


# the per-rank batches of data parallelism: G at B / dp and the critic at
# 2B / dp, B = 64, dp = 16 and 4
RANK_BATCHES = [4, 8, 16, 32]


@pytest.mark.parametrize("geom", range(20))
@pytest.mark.parametrize("batch", RANK_BATCHES)
@pytest.mark.parametrize("preset", ["wgan_gp_b64", "music_44k_dp16"])
def test_per_rank_batch_geometries_match_plain(cuda_device, preset, batch,
                                               geom):
    """K1 and K1' at every geometry of the flagship and of music_44k_dp16
    at the batches a data-parallel rank runs, in bf16 (the presets'
    dtype): the tiles and the rows a tensor-core tile stacks depend on the
    batch."""
    family, _, shape, args, k, cout = _model_geometries(preset,
                                                        batch)[geom]
    _check_geometry(cuda_device, family, shape, args, k, cout,
                    torch.bfloat16, geom)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", range(20))
def test_music_geometries_match_plain(cuda_device, geom, dtype):
    """K1 and K1' at every music_44k_dp16 geometry (batch 2, the clip's
    full lengths) against their plain forms: f32 within 1e-4, bf16 within
    2e-2 of the output's peak, two bf16 launches to the same bits; in
    bf16 the tensor-core path wherever its predicate holds (16 of 20)."""
    family, _, shape, args, k, cout = _music_geometries()[geom]
    _check_geometry(cuda_device, family, shape, args, k, cout, dtype, geom)


def test_music_geometry_count():
    """The table above holds 20 geometries, 16 of them on the tensor
    cores in bf16 (the one-channel layers G4, G4 dx, D0, D0 dx not)."""
    geoms = _music_geometries()
    assert len(geoms) == 20
    tc = []
    for family, name, shape, args, k, cout in geoms:
        if family == "conv1d":
            ok = tconv.conv1d_tensor_core(torch.bfloat16, shape[1], shape[2],
                                          cout, k, args[0])
        else:
            ok = tconv.convt_tensor_core(torch.bfloat16, shape[2], cout, k,
                                         args[0])
        if not ok:
            tc.append(name)
    assert sorted(tc) == ["D0", "D0 dx", "G4", "G4 dx"]


def _graph_case(preset: str, sets: list, device, batch: int = 4):
    from audiogan_tpu_torch.cli import apply_overrides
    from audiogan_tpu_torch.config import get_preset
    from audiogan_tpu_torch.tools.step_checks import random_raw
    from audiogan_tpu_torch.train.state import create_train_state
    from audiogan_tpu_torch.train.step import build_train_step, num_views
    cfg = apply_overrides(get_preset(preset),
                          [f"train.batch_size={batch}", *sets]).validate()
    state = create_train_state(cfg, device=device)
    raw, labels = random_raw(cfg, num_views(cfg), batch, 3)
    return (cfg, state, build_train_step(cfg, device),
            (raw.to(device), labels.to(device)))


@pytest.mark.parametrize("preset,sets", [
    ("wgan_gp_b64", ["train.dtype=float32"]), ("wgan_gp_b64", []),
    ("wgan_gp_b64", ["model.fused_shuffle_sites=-1"]),
    ("cond_gru_sc09", [])], ids=["f32", "bf16", "fused_sites", "gru"])
def test_captured_step_replays_the_eager_step_to_the_bit(
        cuda_device, tmp_path, preset, sets):
    """train/step_graph.py at batch 4: one step captured as one CUDA graph
    and replayed from the pre-step state equals the eager step from the
    same state and draws to the bit (parameters, both Adams' moments,
    metrics), and each kernel call of the port is one kernel node."""
    from audiogan_tpu_torch.train.step_graph import DOT_FILE, dump_step
    cfg, state, step, args = _graph_case(preset, sets, cuda_device)
    summary = dump_step(cfg, state, step, args, tmp_path, cuda_device,
                        say=lambda _: None)
    assert summary["replay_equals_eager"], summary["replay_differs_in"]
    assert summary["tensors_compared"] > 0
    for name, rec in summary["port_kernels"].items():
        assert rec["kernel_nodes"] == rec["calls"] > 0, name
    if preset == "cond_gru_sc09":
        assert summary["port_kernels"]["K4 gru_scan_fwd"]["calls"] == 6
        assert summary["port_kernels"]["K5 gru_scan_bwd"]["calls"] == 1
    assert (tmp_path / DOT_FILE).stat().st_size > 0


def test_dump_leaves_the_loop_state_as_it_was(cuda_device, tmp_path):
    """dump_step works on a copy: the state it is given keeps every
    parameter, moment, Adam count and its step, to the bit, after a dump
    at step 1 (Adam's state made)."""
    from audiogan_tpu_torch.train.state import state_tensors
    from audiogan_tpu_torch.train.step_graph import dump_step
    cfg, state, step, args = _graph_case("wgan_gp_b64", [], cuda_device)
    step(state, *args)

    def seen():
        counts = [float(st["step"]) for opt in (state.opt_g, state.opt_d)
                  for st in opt.state.values()]
        return ({k: v.detach().clone() for k, v in
                 state_tensors(state).items()}, counts, state.step)
    before = seen()
    dump_step(cfg, state, step, args, tmp_path, cuda_device,
              say=lambda _: None)
    after = seen()
    assert after[1:] == before[1:] == (after[1], 1)
    assert after[0].keys() == before[0].keys()
    for k, v in before[0].items():
        assert torch.equal(v, after[0][k]), k


def test_native_gather_feeds_the_host_batcher_step_to_the_same_bits(
        cuda_device, tmp_path, monkeypatch):
    """Two steps of the flagship at batch 4 through train.loop.train on
    the host batcher's path (data.device_corpus off, HostFeed's pinned
    copies): its clips gathered by the native row gather
    (data/native.py::gather_rows) and by numpy's fancy index end in the
    same checkpoint, to the bit."""
    from audiogan_tpu_torch.cli import apply_overrides
    from audiogan_tpu_torch.config import get_preset
    from audiogan_tpu_torch.data import corpus
    from audiogan_tpu_torch.data import native
    from audiogan_tpu_torch.tools.step_checks import same_checkpoint
    from audiogan_tpu_torch.train.loop import train
    cfg = apply_overrides(get_preset("wgan_gp_b64"), [
        "train.batch_size=4", "data.device_corpus=false",
        "train.log_every=1"]).validate()
    calls, gather = [], native.gather_rows

    def counted(*a, **k):
        calls.append(1)
        return gather(*a, **k)
    monkeypatch.setattr(corpus.native, "gather_rows", counted)
    train(cfg, tmp_path / "native", 2, device=cuda_device,
          log=lambda _: None, tensorboard=False)
    assert len(calls) >= 2
    monkeypatch.setattr(corpus.native, "gather_rows",
                        native.gather_rows_plain)
    train(cfg, tmp_path / "numpy", 2, device=cuda_device,
          log=lambda _: None, tensorboard=False)
    assert same_checkpoint(tmp_path / "native" / "ckpt" / "2.pt",
                           tmp_path / "numpy" / "ckpt" / "2.pt") > 0


def test_async_save_on_the_card_holds_the_state_it_was_given(cuda_device,
                                                             tmp_path):
    """utils/checkpoint.py::AsyncSaver on the card: a save handed off
    while the next step runs (the fetch through pinned memory on a side
    stream) writes the state as it was at the save, to the bit: the file
    a synchronous save of that state writes."""
    from audiogan_tpu_torch.tools.step_checks import same_checkpoint
    from audiogan_tpu_torch.utils import checkpoint as ckpt
    cfg, state, step, args = _graph_case("wgan_gp_b64", [], cuda_device)
    step(state, *args)
    ckpt.save(ckpt.make_manager(tmp_path / "sync"), state)
    done = []
    saver = ckpt.AsyncSaver(ckpt.make_manager(tmp_path / "async"),
                            cuda_device, on_complete=done.append)
    saver.save(state)
    step(state, *args)
    saver.join()
    assert [r["step"] for r in done] == [1]
    assert same_checkpoint(tmp_path / "sync" / "ckpt" / "1.pt",
                           tmp_path / "async" / "ckpt" / "1.pt") > 0


# -- the loop's replayed step (train/step_graph.py::StepGraph) ---------------

REPLAY_PRESETS = [("wgan_gp_b64", ["train.dtype=float32"]),
                  ("wgan_gp_b64", []),
                  ("wgan_gp_b64", ["model.fused_shuffle_sites=-1"]),
                  ("cond_gru_sc09", []), ("dual_stft", []),
                  ("music_44k_dp16", ["mesh.dp=1"]), ("resample_22k", [])]
REPLAY_IDS = ["f32", "bf16", "fused_sites", "gru", "dual_stft", "music",
              "resample_22k"]


def _replay_cfg(preset: str, sets: list, batch: int = 4):
    from audiogan_tpu_torch.cli import apply_overrides
    from audiogan_tpu_torch.config import get_preset
    return apply_overrides(get_preset(preset), [
        f"train.batch_size={batch}", "data.index_chunk=4",
        "train.log_every=1", "train.ckpt_every=3", "train.sample_every=0",
        *sets]).validate()


def _records(lines: list) -> list:
    return [{k: v for k, v in ln.items() if k != "seconds"}
            for ln in lines if "step" in ln and "d_loss" in ln]


def _loop(cfg, workdir, steps, device, replay=True):
    from audiogan_tpu_torch.train.loop import train
    lines = []
    train(cfg, workdir, steps, device=device, tensorboard=False,
          replay=replay, log=lambda s: lines.append(json.loads(s)))
    return lines


@pytest.mark.parametrize("preset,sets", REPLAY_PRESETS, ids=REPLAY_IDS)
def test_replayed_loop_equals_the_eager_loop_to_the_bit(
        cuda_device, tmp_path, preset, sets):
    """Six steps through train.loop.train at batch 4 (index_chunk 4: a
    block boundary at step 4), replayed (the first step eager, the second
    captured) and all eager: every step's record and the checkpoints of
    steps 3 and 6 equal to the bit; the replayed run's init names its
    route and its graph line each port kernel's nodes."""
    from audiogan_tpu_torch.tools.step_checks import same_checkpoint
    cfg = _replay_cfg(preset, sets)
    rep = _loop(cfg, tmp_path / "replay", 6, cuda_device)
    eag = _loop(cfg, tmp_path / "eager", 6, cuda_device, replay=False)
    assert next(ln["init"]["steps"] for ln in rep if "init" in ln) == \
        "replay"
    graph = [ln["graph"] for ln in rep if "graph" in ln]
    assert len(graph) == 1 and graph[0]["step"] == 1
    for name, rec in graph[0]["port_kernels"].items():
        assert rec["kernel_nodes"] == rec["calls"] > 0, name
    assert _records(rep) == _records(eag)
    for s in (3, 6):
        assert same_checkpoint(tmp_path / "replay" / f"ckpt/{s}.pt",
                               tmp_path / "eager" / f"ckpt/{s}.pt") > 0


@pytest.mark.parametrize("preset,sets", [REPLAY_PRESETS[1],
                                         REPLAY_PRESETS[3]],
                         ids=["bf16", "gru"])
def test_replayed_run_resumed_equals_the_uninterrupted_one(
        cuda_device, tmp_path, preset, sets):
    """Stopped after its step-3 checkpoint and run again to 6 (a fresh
    capture after the resume's eager first step), the replayed run ends
    in the uninterrupted replayed run's records and checkpoint."""
    from audiogan_tpu_torch.tools.step_checks import same_checkpoint
    cfg = _replay_cfg(preset, sets)
    whole = _loop(cfg, tmp_path / "a", 6, cuda_device)
    _loop(cfg, tmp_path / "b", 3, cuda_device)
    resumed = _loop(cfg, tmp_path / "b", 6, cuda_device)
    assert [ln["resume"]["step"] for ln in resumed if "resume" in ln] == [3]
    assert _records(whole)[3:] == _records(resumed)
    assert same_checkpoint(tmp_path / "a" / "ckpt/6.pt",
                           tmp_path / "b" / "ckpt/6.pt") > 0


def test_nan_in_the_critic_is_named_under_replay(cuda_device, tmp_path,
                                                 monkeypatch):
    """train.debug_nans on a replayed run: a NaN written into the critic's
    conv_0 kernel before step 2 (a replay) is found after the replay,
    and the step run again eagerly under the check names K1', the wave
    critic, forward, D.conv_0_kernel."""
    from audiogan_tpu_torch.train import debug_nans
    cfg = _replay_cfg("wgan_gp_b64", ["train.debug_nans=true"])
    before = debug_nans.NanGuard.before

    def poison(self, state):
        if state.step == 2:
            with torch.no_grad():
                state.d.conv_0_kernel[0, 0, 0] = float("nan")
        before(self, state)
    monkeypatch.setattr(debug_nans.NanGuard, "before", poison)
    lines = []
    with pytest.raises(FloatingPointError) as err:
        from audiogan_tpu_torch.train.loop import train
        train(cfg, tmp_path, 4, device=cuda_device, tensorboard=False,
              log=lambda s: lines.append(json.loads(s)))
    assert any("graph" in ln for ln in lines)
    msg = str(err.value)
    assert "step 2" in msg and "K1' conv1d_ba" in msg
    assert "wave_critic, forward" in msg and "D.conv_0_kernel" in msg


@pytest.mark.parametrize("preset", ["wgan_gp_b64", "cond_gru_sc09",
                                    "dual_stft", "music_44k_dp16",
                                    "resample_22k"])
def test_adam_kernel_equals_torch_foreach_ops(cuda_device, preset):
    """kernels/adam.py's kernel against torch's foreach ops to the bit at
    every parameter shape of the preset's G and D (and, for the
    flagship, ZeRO-1's row blocks at dp=4), counts 1 ... 400."""
    from audiogan_tpu_torch.tools import step_checks
    cases = [c for c in step_checks.adam_cases(cuda_device)
             if c["name"].split()[0] == preset]
    assert cases
    for case in cases:
        assert step_checks.hold_adam(case)["counts"] == 400


# -- the served graph (serve/sample_graph.py) --------------------------------

SERVE_PRESETS = {"wgan_gp_b64": [], "cond_gru_sc09": [], "dual_stft": [],
                 "music_44k_dp16": ["mesh.dp=1"], "resample_22k": []}
SERVE_CASES = [(p, b) for p in SERVE_PRESETS for b in (64, 8)] + [
    ("cond_gru_sc09", 128)]
SERVE_SEEDS = (0, 1, 7, 2 ** 40, -3)


def _served(preset: str, batch: int, device, art, init_seed: int = 0):
    """(config, G's weights on the card, artifact dir) of a preset at its
    published widths, random weights from ``init_seed``, exported at
    ``batch``."""
    from audiogan_tpu_torch.cli import apply_overrides
    from audiogan_tpu_torch.config import get_preset
    from audiogan_tpu_torch.models import build_generator
    from audiogan_tpu_torch.models.init import init_params
    from audiogan_tpu_torch.serve import export_sampler
    cfg = apply_overrides(get_preset(preset),
                          SERVE_PRESETS[preset]).validate()
    params = init_params(build_generator(cfg, device=device),
                         seed=init_seed).state_dict()
    export_sampler(cfg, params, num=batch, out_dir=art)
    return cfg, params, art


def _serve_labels(cfg, batch: int, seed: int):
    import numpy as np
    n_cls = cfg.data.num_classes
    return (np.random.default_rng(abs(seed) % 2 ** 32).integers(
        0, n_cls, batch) if n_cls else None)


def _eager_waves(cfg, params, seed: int, labels, batch: int, device):
    from audiogan_tpu_torch.train.sample import build_sample_fn
    lab = None if labels is None else torch.from_numpy(labels)
    return build_sample_fn(cfg, device)(params, seed, lab,
                                        num=batch).cpu().numpy()


@pytest.mark.parametrize("preset,batch", SERVE_CASES, ids=str)
def test_served_graph_equals_eager_sampling_to_the_bit(cuda_device, tmp_path,
                                                       preset, batch):
    """ServedSampler on the card replays one CUDA graph captured at load:
    over five seeds (random labels for the GRU) its batch equals eager
    build_sample_fn's for the same weights to the bit, and so does the
    eager route's (replay=False). A request launches each port kernel as
    often as the graph holds its kernel nodes: K1 5 a WaveGAN request, 3 a
    GRU request with K4 1, K4 on its persistent launch at batch <= 64 and
    on the host loop (no node of its own) at 128."""
    import numpy as np
    from audiogan_tpu_torch.kernels import hooks
    from audiogan_tpu_torch.serve import ServedSampler, load_sampler
    cfg, params, art = _served(preset, batch, cuda_device, tmp_path)
    s = load_sampler(art)
    assert s.route == "replay"
    for seed in SERVE_SEEDS:
        labels = _serve_labels(cfg, batch, seed)
        np.testing.assert_array_equal(
            s.generate(seed, labels),
            _eager_waves(cfg, params, seed, labels, batch, cuda_device))
    eager = ServedSampler(art, replay=False)
    assert eager.route == "eager"
    labels = _serve_labels(cfg, batch, 3)
    np.testing.assert_array_equal(eager.generate(3, labels),
                                  s.generate(3, labels))
    before = hooks.launch_counts()
    s.generate(1, _serve_labels(cfg, batch, 1))
    delta = {k: v - before.get(k, 0) for k, v in hooks.launch_counts().items()
             if v != before.get(k, 0)}
    port = s.summary()["port_kernels"]
    gru = preset == "cond_gru_sc09"
    want = {"K1 conv_transpose1d_ba": 3 if gru else 5}
    if gru:
        want["K4 gru_scan_fwd"] = 1
    assert {k: r["calls"] for k, r in port.items()} == want
    assert {w for w, _ in delta} == {k.split()[-1] for k in want}
    for name, rec in port.items():
        w = name.split()[-1]
        assert delta[(w, "launches")] == rec["calls"]
        assert rec["kernel_nodes"] == rec["calls"] - delta.get(
            (w, "launches_loop"), 0)
    if gru:
        loop = batch > 64
        assert delta.get(("gru_scan_fwd", "launches_loop"), 0) == loop
        assert delta.get(("gru_scan_fwd", "launches_persistent"), 0) == \
            (not loop)
        assert port["K4 gru_scan_fwd"]["kernel_nodes"] == (not loop)


@pytest.mark.parametrize("preset", ["wgan_gp_b64", "cond_gru_sc09"])
def test_two_hundred_sampler_replays_with_changing_seeds_equal_eager(
        cuda_device, tmp_path, preset):
    import numpy as np
    from audiogan_tpu_torch.serve import load_sampler
    cfg, params, art = _served(preset, 64, cuda_device, tmp_path)
    s = load_sampler(art)
    for seed in range(200):
        labels = _serve_labels(cfg, 64, seed)
        np.testing.assert_array_equal(
            s.generate(seed, labels),
            _eager_waves(cfg, params, seed, labels, 64, cuda_device))


def test_two_samplers_in_one_process_keep_to_their_own(cuda_device,
                                                       tmp_path):
    """The flagship from two weight seeds and the GRU, loaded side by
    side (each capture its own pool), their requests interleaved: each
    batch equals its own eager sampling."""
    import numpy as np
    from audiogan_tpu_torch.serve import load_sampler
    cases = [_served("wgan_gp_b64", 64, cuda_device, tmp_path / "a", 0),
             _served("wgan_gp_b64", 8, cuda_device, tmp_path / "b", 1),
             _served("cond_gru_sc09", 64, cuda_device, tmp_path / "c", 2)]
    samplers = [load_sampler(art) for _, _, art in cases]
    for seed in range(4):
        for (cfg, params, _), s in zip(cases, samplers):
            labels = _serve_labels(cfg, s.num, seed)
            np.testing.assert_array_equal(
                s.generate(seed, labels),
                _eager_waves(cfg, params, seed, labels, s.num, cuda_device))
    a, b = (s.generate(5) for s in samplers[:2])
    assert not np.array_equal(a[:8], b)


def test_concurrent_served_requests_get_their_own_seeds_bytes(cuda_device,
                                                              tmp_path):
    """Eight /generate requests with different seeds started together on
    the GRU sampler through make_server (one thread each): every answer
    holds the WAVs of its own seed and labels, as eager sampling gives
    them."""
    import base64
    import threading
    import urllib.request
    from audiogan_tpu_torch.data.wavio import wav_bytes
    from audiogan_tpu_torch.serve import load_sampler, make_server
    cfg, params, art = _served("cond_gru_sc09", 8, cuda_device, tmp_path)
    s = load_sampler(art)
    seeds = [13 * i + 1 for i in range(8)]
    want = {seed: [base64.b64encode(wav_bytes(s.sample_rate, w)).decode()
                   for w in _eager_waves(cfg, params, seed,
                                         _serve_labels(cfg, 8, seed), 8,
                                         cuda_device)]
            for seed in seeds}
    srv = make_server(s, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d/generate" % srv.server_address[:2]
    got, errors = {}, []
    start = threading.Barrier(len(seeds))

    def ask(seed):
        try:
            body = json.dumps({"seed": seed, "labels": _serve_labels(
                cfg, 8, seed).tolist()}).encode()
            req = urllib.request.Request(
                url, data=body, headers={"Content-Type": "application/json"})
            start.wait(timeout=60)
            with urllib.request.urlopen(req, timeout=120) as r:
                got[seed] = json.loads(r.read())["wavs"]
        except Exception as err:  # reported below
            errors.append(err)
    try:
        workers = [threading.Thread(target=ask, args=(seed,))
                   for seed in seeds]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=180)
        assert not any(w.is_alive() for w in workers)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    assert not thread.is_alive() and not errors, errors
    assert got == want


def test_a_sampler_whose_capture_or_warm_up_fails_raises_at_load(
        cuda_device, tmp_path, monkeypatch):
    """No fallback: a host sync inside the body (a monkeypatched mu-law
    expand reading the peak) passes the eager warm-up and breaks the
    capture, and the load raises naming the op and the last kernel call;
    a body that fails eagerly raises from the warm-up. Then a sampler of
    the same artifact loads and serves eager sampling's bytes."""
    import numpy as np
    from audiogan_tpu_torch.serve import load_sampler
    from audiogan_tpu_torch.train import sample
    cfg, params, art = _served("wgan_gp_b64", 8, cuda_device, tmp_path)
    expand = sample.mu_law_expand

    def syncing(y, mu):
        float(y.abs().max())
        return expand(y, mu)
    monkeypatch.setattr(sample, "mu_law_expand", syncing)
    with pytest.raises(RuntimeError) as err:
        load_sampler(art)
    msg = str(err.value)
    assert "capture of the sampler failed at" in msg
    assert re.search(r"aten op aten\.(item|_local_scalar_dense)", msg), msg
    assert "the last kernel call: K1 conv_transpose1d_ba" in msg

    def failing(y, mu):
        raise ValueError("no expand")
    monkeypatch.setattr(sample, "mu_law_expand", failing)
    with pytest.raises(RuntimeError, match="warm-up failed at .*no expand"):
        load_sampler(art)
    monkeypatch.setattr(sample, "mu_law_expand", expand)
    s = load_sampler(art)
    np.testing.assert_array_equal(
        s.generate(9), _eager_waves(cfg, params, 9, None, 8, cuda_device))


def test_captured_f32_gru_step_takes_the_host_loop(cuda_device, tmp_path):
    """cond_gru_sc09 in f32 at batch 4: K4 and K5 run their host loops
    (f32 has no persistent path), captured as they are: the replay
    equals the eager step to the bit, and the scans' calls hold no node
    of their own, only the loop's kernels."""
    from audiogan_tpu_torch.train.step_graph import dump_step
    cfg, state, step, args = _graph_case(
        "cond_gru_sc09", ["train.dtype=float32"], cuda_device)
    summary = dump_step(cfg, state, step, args, tmp_path, cuda_device,
                        say=lambda _: None)
    assert summary["replay_equals_eager"], summary["replay_differs_in"]
    port = summary["port_kernels"]
    for name in ("K4 gru_scan_fwd", "K5 gru_scan_bwd"):
        assert port[name]["kernel_nodes"] == 0 < port[name]["other_nodes"]
    assert port["K4 gru_scan_fwd"]["calls"] == 6


# -- the bench's batches (audiogan_tpu_torch/bench.py) --------------------------

def test_flagship_g3_at_batch_8192_runs_past_the_grid_y_limit(cuda_device):
    """The flagship generator's G3 convT at batch 8192 needs 65536 M
    blocks, one more than grid y holds: csrc/igemm_tc.cuh continues them
    in grid z. The first 8 and the last 8 elements against the plain form
    (the bf16 tolerance of the convT tests), and the first 8 equal to the
    same tile's launch at batch 4096 (32768 M blocks, grid y alone) to the
    bit."""
    from audiogan_tpu_torch.config import get_preset
    from audiogan_tpu_torch.tools.step_checks import generator_layers
    L = generator_layers(get_preset("wgan_gp_b64"), 8192)[3]
    assert (L["cin"], L["cout"], L["t_in"], L["s"]) == (128, 64, 1024, 4)
    plans = {b: tconv.convt_tc_plan(b, L["cout"], L["k"], L["s"],
                                    L["pad_lo"], L["out_len"])
             for b in (8192, 4096)}
    assert plans[8192][0] == plans[4096][0]            # the same tile
    _, _, _, blocks = tconv.tc_tile_shape(8192, L["t_in"], 1, L["cout"],
                                          int(plans[8192][0]))
    assert blocks > 65535
    gen = torch.Generator(cuda_device).manual_seed(3)
    x = torch.randn(8192, L["t_in"], L["cin"], generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    w = (torch.randn(L["k"], L["cin"], L["cout"], generator=gen,
                     device=cuda_device) / (L["k"] * L["cin"] / 4) ** 0.5
         ).to(torch.bfloat16)
    b = (torch.randn(L["cout"], generator=gen, device=cuda_device) * 0.5
         ).to(torch.bfloat16)
    args = (L["s"], L["pad_lo"], L["out_len"], L["act"])
    before = tconv.conv_transpose1d_ba.launches_tc
    y = tconv.conv_transpose1d_ba(x, w, b, *args)
    half = tconv.conv_transpose1d_ba(x[:4096], w, b, *args)
    torch.cuda.synchronize()
    assert tconv.conv_transpose1d_ba.launches_tc == before + 2
    assert torch.equal(y[:8], half[:8])
    for rows in (slice(0, 8), slice(8192 - 8, 8192)):
        want = tconv.conv_transpose1d_ba_plain(
            x[rows].float(), w.float(), b.float(), *args, 0.2)
        err = (y[rows].float() - want).abs().max().item()
        assert err <= 2e-2 * want.abs().max().item(), (rows, err)


def test_gru_sampler_at_4096_replays_its_host_loop(cuda_device):
    """cond_gru_sc09's sampler at the bench's batch 4096: K4 on its host
    loop (B > 64) inside the captured graph. Two replays equal the eager
    body on the same buffers to the bit, and the last 8 clips equal the
    port on the CPU (plain forms, bf16, the same z and labels) within the
    serve phase's tolerance (5e-2 of the peak)."""
    import numpy as np
    from audiogan_tpu_torch import bench
    from audiogan_tpu_torch.serve.sample_graph import SampleGraph
    from audiogan_tpu_torch.train.sample import generate
    cfg = bench.bench_config("cond_gru_sc09")
    num = bench.default_sample_num(cfg)
    assert num == 4096
    params = bench.generator_params(cfg, cuda_device)
    labels = bench.sample_labels(cfg, num)
    sampler = bench.BenchSampler(cfg, params, num, cuda_device, labels)
    graph = sampler.graph
    assert graph.route == "replay"
    port = graph.port_kernels()
    assert port["K4 gru_scan_fwd"]["kernel_nodes"] == 0      # the host loop
    assert port["K4 gru_scan_fwd"]["other_nodes"] > 0
    eager = SampleGraph(cfg, params, num, cuda_device, replay=False)
    for seed in (5, 6):
        with torch.cuda.stream(sampler.graph.stream):
            got = sampler(seed).clone()
        sampler.graph.stream.synchronize()
        with torch.inference_mode():
            eager.fill(seed, labels)
            want = eager.body()
        assert torch.equal(got, want), seed
    z = graph.inputs["z"][-8:].cpu()
    cpu = {k: v.cpu() for k, v in params.items()}
    ref = generate(cfg, cpu, 8, 6, labels[-8:], device="cpu", z=z)
    err = float(np.abs(got[-8:].cpu().numpy() - ref).max())
    assert np.isfinite(ref).all()
    assert err <= 5e-2 * float(np.abs(ref).max()), err
