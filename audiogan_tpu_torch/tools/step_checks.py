"""What chip_smoke.py and tools/dp_check.py both hold a training step
to: the parity bounds of a step against a reference step, random global
batches, the conv geometries a WaveGAN step runs and the K1/K1' launches
its structure gives, the collectives a step issues on each rank of a mesh
(``step_collectives``), and comparisons of states and checkpoints to the
bit. Imports nothing of chip_smoke.py, so both the script and the
package's tools use one copy.
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path

import numpy as np
import torch

# a full step's metrics, and its gradients and Adam moments (relative L2
# over each net), against the same step elsewhere (card vs CPU, dp=N vs
# dp=1) in f32
PARITY_REL_TOL = 1e-3
# Adam normalizes each element: where a gradient is rounding noise (a sum
# that cancels to ~0), the two sides may step it by up to lr in opposite
# directions. So a parameter may differ by up to 2.5 lr (lr 1e-4); the
# share of elements off by more than 1e-6 is reported.
PARITY_PARAM_TOL = 2.5e-4
PARITY_PARAM_FINE = 1e-6
# a bf16 step at dp=N against the same bf16 step at dp=1: every conv's
# output rounds to 8 bits at tiles the per-rank batch picks. Both start
# from a warm state: from the seeded init Adam's first update steps each
# element by lr times its gradient's sign, so where a gradient is rounding
# noise the two runs step it opposite ways and ten critic updates carry
# that on (on the card, flagship B=64, two steps from the seeded init:
# metrics 3.2e-2 apart, moments 6.7e-2). No fixed bound separates
# rounding from a fault, so the distance is held to the
# error bf16 itself makes on the same steps: the dp=1 bf16 run against
# the dp=1 f32 run, times this factor (metrics and moments each).
DP_BF16_FACTOR = 2.0
# The parameter bound above is within rounding's reach once Adam has
# stepped: over two f32 steps at B=8 the flagship's parameters moved up
# to 3.75e-4 apart between two correct runs (tp=2 against tp=1, cp=2
# against cp=1), an element whose gradient is rounding noise each time.
# So the cp and tp steps are held on a frozen step (``frozen``), where
# Adam divides nothing into the comparison, at these batch seeds; the two
# steps at the preset's lr are reported beside the bounds.
PARITY_SEEDS = (60, 70, 80, 90, 100, 110)
PARITY_STEPS = 2


# -- batches and geometries -------------------------------------------------

def random_raw(cfg, n_views: int, batch: int, seed: int):
    rng = np.random.default_rng(seed)
    raw = (rng.standard_normal((n_views, batch, cfg.data.store_len)) * 6000
           ).clip(-32768, 32767).astype(np.int16)
    return torch.from_numpy(raw), torch.zeros(n_views, batch,
                                              dtype=torch.long)


def generator_layers(cfg, batch: int) -> list[dict]:
    """The generator's conv-transpose layers as its forward runs them:
    the WaveGAN G's, or the GRU G's upsampling stack (models/gru.py)."""
    from audiogan_tpu_torch.models.gru import factorize_stride
    from audiogan_tpu_torch.models.wavegan import _gen_channels
    m = cfg.model
    if m.generator == "gru":
        strides = factorize_stride(m.gru_frame_size)
        t = cfg.data.clip_len // m.gru_frame_size
        c_in = min(4 * m.model_dim, 512)
        chs = [max(c_in // 2 ** (i + 1), m.model_dim)
               for i in range(len(strides) - 1)] + [1]
    else:
        strides = m.strides
        t = cfg.data.clip_len // m.total_stride
        c_in = min(m.model_dim * 2 ** (len(m.strides) - 1), m.max_channels)
        chs = _gen_channels(m.model_dim, len(m.strides), m.max_channels)
    layers = []
    for i, (s, c_out) in enumerate(zip(strides, chs)):
        layers.append(dict(name=f"G{i} fwd", b=batch, t_in=t, cin=c_in,
                           cout=c_out, k=m.kernel_size, s=s,
                           pad_lo=(m.kernel_size - 1) // 2, out_len=t * s,
                           act="relu" if i < len(chs) - 1 else "tanh"))
        t, c_in = t * s, c_out
    return layers


def critic_layers(cfg, batch: int) -> list[dict]:
    """The critic's SAME conv1d layers as its forward runs them."""
    from audiogan_tpu_torch.kernels.conv import _same_pads
    from audiogan_tpu_torch.models.wavegan import _disc_channels
    m = cfg.model
    t, c_in = cfg.data.clip_len, 1
    layers = []
    chs = _disc_channels(m.model_dim, len(m.strides), m.max_channels)
    for i, (s, c_out) in enumerate(zip(m.strides, chs)):
        t_out, lo, hi = _same_pads(t, m.kernel_size, s)
        layers.append(dict(name=f"D{i} fwd", b=batch, t_in=t, cin=c_in,
                           cout=c_out, k=m.kernel_size, s=s, lo=lo, hi=hi,
                           act="leaky_relu"))
        t, c_in = t_out, c_out
    return layers


def critic_dx_layers(cfg, batch: int) -> list[dict]:
    """dx of each critic conv: convT of the flipped taps with pad_lo =
    K-1-lo and out_len = t_in (kernels/autograd.py), no bias, no act."""
    out = []
    for L in critic_layers(cfg, batch):
        t_out = (L["t_in"] + L["lo"] + L["hi"] - L["k"]) // L["s"] + 1
        out.append(dict(name=L["name"].replace("fwd", "dx"), b=batch,
                        t_in=t_out, cin=L["cout"], cout=L["cin"], k=L["k"],
                        s=L["s"], pad_lo=L["k"] - 1 - L["lo"],
                        out_len=L["t_in"], act="none"))
    return out


def generator_dx_layers(cfg, batch: int) -> list[dict]:
    """dx of each generator convT: conv1d of the flipped taps with lo =
    K-1-pad_lo, hi = max((T-1)*s + K - lo - out_len, 0)."""
    out = []
    for L in generator_layers(cfg, batch):
        lo = L["k"] - 1 - L["pad_lo"]
        hi = max((L["t_in"] - 1) * L["s"] + L["k"] - lo - L["out_len"], 0)
        out.append(dict(name=L["name"].replace("fwd", "dx"), b=batch,
                        t_in=L["out_len"], cin=L["cout"], cout=L["cin"],
                        k=L["k"], s=L["s"], lo=lo, hi=hi, act="none"))
    return out


def tensor_core(family: str, L: dict, dtype=torch.bfloat16) -> bool:
    """Whether the wrapper runs geometry L in dtype on the tensor cores."""
    from audiogan_tpu_torch.kernels import conv as kconv
    if family == "conv1d":
        return kconv.conv1d_tensor_core(dtype, L["t_in"], L["cin"],
                                        L["cout"], L["k"], L["s"])
    return kconv.convt_tensor_core(dtype, L["cin"], L["cout"], L["k"],
                                   L["s"])


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.train.dtype)


def conv_step_launches(cfg, critic_f32: bool = False) -> dict:
    """K1' and K1 launches of one WaveGAN training step, in total and on
    the tensor-core path. Per critic micro-step, with V critic
    calls on the views: each unfused critic conv runs V + 2 times (the
    views' forwards, x-hat's forward, the penalty's d/dct of its dx) and
    its dx V + 1 times (the loss's backward, the penalty's input gradient;
    D0's dx only the latter); the G update adds one critic forward and
    one dx per layer, and G runs forward n_critic + 1 times and its dx
    once. With fused sites K6 and K7 take D1-D4's forward and dx. The
    tensor-core counts follow the config's compute dtype; with
    ``critic_f32`` the critic's follow f32 and every site is unfused
    (the tp step's critic)."""
    views = 1 if cfg.train.fused_d_views else 2
    dtype = compute_dtype(cfg)
    d_dtype = torch.float32 if critic_f32 else dtype
    n = cfg.loss.n_critic
    fused = cfg.model.fused_shuffle_sites != 0 and not critic_f32
    counts = {"conv1d": 0, "convt1d": 0, "conv1d_tc": 0, "convt1d_tc": 0}

    def add(family, L, times, dt=dtype):
        counts[family] += times
        if tensor_core(family, L, dt):
            counts[family + "_tc"] += times
    for i, (L, dx) in enumerate(zip(critic_layers(cfg, 2), critic_dx_layers(
            cfg, 2))):
        if fused and i > 0:
            continue
        add("conv1d", L, n * (views + 2) + 1, d_dtype)
        add("convt1d", dx, n * (views + 1) + 1 if i > 0 else n + 1, d_dtype)
    for L, dx in zip(generator_layers(cfg, 2), generator_dx_layers(cfg, 2)):
        add("convt1d", L, n + 1)
        add("conv1d", dx, 1)
    return counts


def fused_step_launches(cfg) -> tuple[int, int]:
    """(K6, K7) launches of one training step with every site fused: per
    critic micro-step, with V critic calls on the views (1 for the fused
    2B call, else 2), K6 (V + 2) x sites (the views' forwards, x-hat's
    forward, the penalty's double backprop: d/dct of K7 is K6) and K7
    (V + 1) x sites (the penalty's input gradient, the loss's backward
    through the views); the G update one of each per site."""
    sites = len(cfg.model.strides) - 1
    views = 1 if cfg.train.fused_d_views else 2
    n_critic = cfg.loss.n_critic
    return ((n_critic * (views + 2) + 1) * sites,
            (n_critic * (views + 1) + 1) * sites)


def cp_rank_layers(cfg, batch: int, cp: int) -> tuple[list[dict], list[dict]]:
    """(K1, K1') geometries one rank of a cp group runs
    (parallel/halo.py): the critic's convs on halo-extended slices with
    VALID pads at 2 batch (the fused views) and their dx, G's convT on
    slices extended by ceil(pad / s) input rows each side (pad_lo
    (k-1)//2, out_len the extended length times s) at batch and their
    dx; a layer whose slice is narrower than its halo runs the whole
    signal (the all-gather route). Named with "(cp=N)"."""
    from audiogan_tpu_torch.kernels.conv import _same_pads
    from audiogan_tpu_torch.models.wavegan import (_disc_channels,
                                                   _gen_channels)
    m = cfg.model
    k, n = m.kernel_size, len(m.strides)
    tag = f" (cp={cp})"
    convt, conv = [], []
    t, c_in = cfg.data.clip_len // cp, 1
    for i, (s, c_out) in enumerate(zip(m.strides, _disc_channels(
            m.model_dim, n, m.max_channels))):
        total = max(k - s, 0)
        lo, hi = total // 2, total - total // 2
        if lo > t or hi > t:
            t_in = t * cp
            _, lo, hi = _same_pads(t_in, k, s)
        else:
            t_in, lo, hi = t + lo + hi, 0, 0
        L = dict(name=f"D{i} fwd{tag}", b=2 * batch, t_in=t_in, cin=c_in,
                 cout=c_out, k=k, s=s, lo=lo, hi=hi, act="leaky_relu")
        conv.append(L)
        convt.append(dict(name=f"D{i} dx{tag}", b=2 * batch,
                          t_in=(t_in + lo + hi - k) // s + 1, cin=c_out,
                          cout=c_in, k=k, s=s, pad_lo=k - 1 - lo,
                          out_len=t_in, act="none"))
        t, c_in = t // s, c_out
    t = cfg.data.clip_len // m.total_stride // cp
    c_in = min(m.model_dim * 2 ** (n - 1), m.max_channels)
    pad_lo = (k - 1) // 2
    for i, (s, c_out) in enumerate(zip(m.strides, _gen_channels(
            m.model_dim, n, m.max_channels))):
        lx, rx = -(-pad_lo // s), -(-max(k - 1 - pad_lo, 0) // s)
        t_in = t * cp if lx > t or rx > t else t + lx + rx
        L = dict(name=f"G{i} fwd{tag}", b=batch, t_in=t_in, cin=c_in,
                 cout=c_out, k=k, s=s, pad_lo=pad_lo, out_len=t_in * s,
                 act="relu" if i < n - 1 else "tanh")
        convt.append(L)
        lo = k - 1 - pad_lo
        conv.append(dict(name=f"G{i} dx{tag}", b=batch, t_in=t_in * s,
                         cin=c_out, cout=c_in, k=k, s=s, lo=lo,
                         hi=max((t_in - 1) * s + k - lo - t_in * s, 0),
                         act="none"))
        t, c_in = t * s, c_out
    return convt, conv


def cp_step_launches(cfg) -> dict:
    """Kernel launches of one context-parallel step on each rank: K1' and
    K1 as the WaveGAN step's structure gives them (``conv_step_launches``;
    the GRU G's upsampling convTs), every shuffle site unfused (the cp
    critic ignores fused_shuffle_sites, so no K6 or K7) and none on the
    tensor cores (the cp step computes in f32); no K3, K4 or K5 (the cp
    GRU G runs the torch-op cell under parallel/halo.py's chunked scan);
    Adam's kernel once per update (``adam_step_launches``)."""
    import dataclasses
    return {**conv_step_launches(cfg.replace(
        model=dataclasses.replace(cfg.model, fused_shuffle_sites=0),
        train=dataclasses.replace(cfg.train, dtype="float32"))),
        "sconv1d": 0, "sconvt1d": 0, "gru_cell": 0, "gru_scan": 0,
        "gru_scan_bwd": 0, **adam_step_launches(cfg)}


def adam_step_launches(cfg) -> dict:
    """Adam's kernel (kernels/adam.py) in one step: one launch per update,
    n_critic of the critic and one of G (each net's parameters fit one
    launch's table)."""
    return {"adam": cfg.loss.n_critic + 1}


def tp_rank_layers(cfg, batch: int, tp: int
                   ) -> tuple[list[dict], list[dict]]:
    """(K1, K1') geometries of the critic one rank of a tp group runs
    (parallel/tp_models.py) at 2 batch (the fused views): the column
    layers (0, 2, ...) at C_out / tp with their bias and activation, the
    row layers (1, 3, ...) at C_in / tp with the zero bias and no
    activation, and each layer's dx at the transposed geometry. G runs
    whole (``generator_layers``). Named with "(tp=N)"."""
    tag = f" (tp={tp})"
    convt, conv = [], []
    for i, (L, dx) in enumerate(zip(critic_layers(cfg, 2 * batch),
                                    critic_dx_layers(cfg, 2 * batch))):
        col = i % 2 == 0
        if col:
            L = dict(L, cout=L["cout"] // tp)
            dx = dict(dx, cin=dx["cin"] // tp)
        else:
            L = dict(L, cin=L["cin"] // tp, act="none")
            dx = dict(dx, cout=dx["cout"] // tp)
        form = "col" if col else "row"
        conv.append(dict(L, name=f"{L['name']} {form}{tag}"))
        convt.append(dict(dx, name=f"{dx['name']} {form}{tag}"))
    return convt, conv


def tp_step_launches(cfg) -> dict:
    """K1' and K1 launches of one tensor-parallel step on each rank: the
    WaveGAN step's structure (``conv_step_launches``), every critic conv
    on a channel slice in f32 (so none on the tensor cores) with every
    shuffle site unfused (the tp critic ignores fused_shuffle_sites), G
    the ordinary module in the config's dtype; with the GRU G, K4 once
    per G forward (n_critic + 1) and K5 once; Adam's kernel once per
    update."""
    counts = {**conv_step_launches(cfg, critic_f32=True),
              **adam_step_launches(cfg)}
    if cfg.model.generator == "gru":
        counts.update(gru_scan=cfg.loss.n_critic + 1, gru_scan_bwd=1)
    return counts


def _site(fwd=(), bwd=(), dbl=(), at_input=False, const=False,
          again=False) -> dict:
    """One exchange of a model's forward: the collectives of its forward,
    of its backward and of its backward's backward (the penalty's double
    backprop); ``at_input``: what it exchanges depends on the model's
    input alone (its backward runs only where the input needs a
    gradient); ``const``: the penalty's gradient reaching it does not
    depend on the parameters (its backward is not differentiated again);
    ``again``: the double backprop reaches it in the interpolates' forward
    (a torch leaky_relu's double backward links to its input)."""
    return {"fwd": Counter(fwd), "bwd": Counter(bwd), "dbl": Counter(dbl),
            "at_input": at_input, "const": const, "again": again}


def _halo(lo: int, hi: int, t: int, at_input: bool = False,
          again: bool = False) -> dict:
    """parallel/halo.py's exchange of a conv's halos (lo, hi rows each
    side of a t-row slice): one all-gather per side (a shift, whose
    backward is the other shift), or, where a halo is wider than the
    slice, the all-gather route (GatherTime, whose backward all-reduces)."""
    if lo > t or hi > t:
        return _site(["all_gather"], ["all_reduce"], ["all_gather"],
                     at_input, again=again)
    ag = ["all_gather"] * ((lo > 0) + (hi > 0))
    return _site(ag, ag, ag, at_input, again=again)


def _cp_sites(cfg) -> tuple[list, list]:
    """(the critic's, the generator's) exchanges on one cp rank
    (parallel/cp_models.py)."""
    m, cp = cfg.model, cfg.mesh.cp
    shift = _site(["all_gather"], ["all_gather"], ["all_gather"])
    head = _site(["all_reduce"], dbl=["all_reduce"], const=True)
    proj = _site(["all_reduce"], dbl=["all_reduce"])
    critic, t = [], cfg.data.clip_len // cp
    for i, s in enumerate(m.strides):
        total = max(m.kernel_size - s, 0)
        critic.append(_halo(total // 2, total - total // 2, t, i == 0))
        t //= s
        if m.phase_shuffle and i < len(m.strides) - 1:
            critic += [shift, shift]
    critic.append(head)
    if cfg.data.num_classes:
        critic.append(proj)
    if m.use_stft_critic:
        from audiogan_tpu_torch.models.stft_critic import KERNEL, STRIDE
        _, hop, win = m.stft_resolutions[0]
        if win > hop:
            critic.append(dict(shift, at_input=True))
        f, total = cfg.data.clip_len // cp // hop, max(KERNEL - STRIDE, 0)
        for i in range(4):                # STFTCritic's n_layers
            # conv2d_0's input is the spectrogram of the input alone; the
            # others' F.leaky_relu before them is reached again
            critic.append(_halo(total // 2, total - total // 2, f,
                                at_input=i == 0, again=i > 0))
            f //= STRIDE
        critic.append(head)
        if cfg.data.num_classes:
            critic.append(proj)
    k, gen = m.kernel_size, []
    pad_lo = (k - 1) // 2
    if m.generator == "gru":
        from audiogan_tpu_torch.models.gru import factorize_stride
        gen += [shift] * (2 * (cp - 1))   # the scan's carry handoffs
        strides = factorize_stride(m.gru_frame_size)
        t = cfg.data.clip_len // m.gru_frame_size // cp
    else:
        strides, t = m.strides, cfg.data.clip_len // m.total_stride // cp
    for s in strides:
        gen.append(_halo(-(-pad_lo // s), -(-max(k - 1 - pad_lo, 0) // s),
                         t))
        t *= s
    return critic, gen


def _tp_sites(cfg) -> list:
    """The tp critic's exchanges on one tp rank (parallel/tp_models.py):
    f on a column layer's input (the sum in its backward), g on a row
    layer's output, the sum of the head and of the projection when the
    last layer is a column layer."""
    n = len(cfg.model.strides)
    sites = [_site(bwd=["all_reduce"], at_input=i == 0) if i % 2 == 0 else
             _site(["all_reduce"], dbl=["all_reduce"]) for i in range(n)]
    if n % 2:
        sites.append(_site(["all_reduce"], dbl=["all_reduce"], const=True))
        if cfg.data.num_classes:
            sites.append(_site(["all_reduce"], dbl=["all_reduce"],
                               const=True))
    return sites


def step_collectives(cfg, sharded: bool = False) -> dict[str, int]:
    """The collectives one training step issues on each rank of cfg's
    mesh, by kind, from the step's structure (no run), as the launch
    counts above are the kernels'. ``sharded``: the step gathers its
    clips from the corpus sharded over the data axis.

    Each exchange of a model (``_cp_sites``, ``_tp_sites``) issues its
    forward's collectives at each call, its backward's where autograd
    runs it and its backward's backward in the penalty's double backprop.
    A critic micro-step calls the critic on V views (V = 1 fused, else 2)
    and on the penalty's interpolates; the penalty's input gradient runs
    every exchange's backward; the loss's backward runs, for each view,
    those past the input and, for the interpolates, the double backward
    of those whose gradient is not constant (and the backward of those
    the double backprop reaches in their forward). The generator update
    runs every
    exchange's backward of the critic and the generator. Then the
    gradient sums (train/step.py, cp_step.py, tp_step.py), the metrics'
    mean, ZeRO-1's all-gathers and the sharded corpus's all-to-all."""
    m, n = cfg.mesh, cfg.loss.n_critic
    views = 1 if cfg.train.fused_d_views else 2
    out: Counter = Counter()

    def total(sites, phase, keep=lambda s: True):
        c: Counter = Counter()
        for site in sites:
            if keep(site):
                c.update(site[phase])
        return c

    def critic_step(sites, calls: int, chunks: int = 1) -> Counter:
        """One critic update's exchanges: the views, then the penalty in
        ``chunks`` chunks (more than one: each chunk's forward and input
        gradient run again in the backward, train/losses/wgan.py)."""
        c = Counter()
        again = 2 if chunks > 1 else 1
        for _ in range(calls):
            c.update(total(sites, "fwd"))
            c.update(total(sites, "bwd", lambda s: not s["at_input"]))
        for _ in range(chunks):
            for _ in range(again):
                c.update(total(sites, "fwd"))
                c.update(total(sites, "bwd"))
            c.update(total(sites, "dbl", lambda s: not s["const"]))
            c.update(total(sites, "bwd", lambda s: s["again"]))
        return c

    def generator_step(critic, gen) -> Counter:
        c = total(critic, "fwd") + total(critic, "bwd")
        return c + total(gen, "fwd") + total(gen, "bwd")

    if m.cp > 1:
        critic, gen = _cp_sites(cfg)
        for _ in range(n):
            out.update(total(gen, "fwd"))         # the fakes, no grad
            out.update(critic_step(critic, views))
            # the penalty's norms over cp; the gradient sums over the
            # world and, for the heads' biases, the data axis
            out["all_reduce"] += 2 + (m.dp > 1)
        out.update(generator_step(critic, gen))
        out["all_reduce"] += 1
        if cfg.loss.stft_loss_weight > 0:
            # per resolution the fake's and the real's right halo (the
            # fake's backward too) and three sums over cp
            for _, hop, win in cfg.model.stft_resolutions:
                out["all_gather"] += 3 * (win > hop)
                out["all_reduce"] += 3
    elif m.tp > 1:
        critic = _tp_sites(cfg)
        for _ in range(n):
            out.update(critic_step(critic, views, cfg.loss.gp_batch_chunks))
            # the sliced gradients over the world, the rest over data
            out["all_reduce"] += 1 + (m.dp > 1)
        out.update(generator_step(critic, []))
        out["all_reduce"] += m.dp > 1
    elif m.dp > 1:
        # one flat all-reduce per net per update
        out["all_reduce"] += n + 1
        if cfg.loss.stft_loss_weight > 0:
            # global_mean of the fake and real mean spectra
            out["all_reduce"] += 2 * len(cfg.model.stft_resolutions)
    if m.dp > 1:
        out["all_reduce"] += 1                   # the metrics' mean
        if m.fsdp:
            out["all_gather"] += n + 1          # gather_rows per update
        if sharded:
            out["all_to_all"] += 1
    return {k: v for k, v in out.items() if v}


def hold_launches(by_rank: list[dict], want: dict, steps: int,
                  tag: str) -> list[dict]:
    """Raises unless each rank's launches (counted over ``steps`` steps)
    are want[kernel] per step for every kernel of ``want``; returns each
    rank's launches per step."""
    for rank, got in enumerate(by_rank):
        for name, n in want.items():
            if got[name] != n * steps:
                raise AssertionError(f"{tag} rank {rank}: {name} launched "
                                     f"{got[name]} times in {steps} steps, "
                                     f"want {n} per step")
    return [{k: v // steps for k, v in got.items()} for got in by_rank]


# -- states to the bit ------------------------------------------------------

def bits_of(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def same_bits(a, b, path: str = "") -> int:
    """Raises unless a and b (nested dicts/lists of tensors and numbers)
    are equal to the bit; returns the count of tensors compared."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            raise AssertionError(f"{path}: keys {sorted(a)} != {sorted(b)}")
        return sum(same_bits(a[k], b[k], f"{path}/{k}") for k in a)
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{path}: lengths differ")
        return sum(same_bits(x, y, f"{path}/{i}")
                   for i, (x, y) in enumerate(zip(a, b)))
    if isinstance(a, torch.Tensor):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(
                bits_of(a), bits_of(b)):
            raise AssertionError(f"{path}: tensors differ")
        return 1
    if a != b:
        raise AssertionError(f"{path}: {a!r} != {b!r}")
    return 0


def state_parts(blob: dict) -> dict:
    """The parts of a state_blob that two equal states share to the bit."""
    return {k: blob[k] for k in ("step", "g", "d", "opt_g", "opt_d")}



def same_checkpoint(a: Path, b: Path) -> int:
    """Every tensor and number of two checkpoints equal to the bit; the
    count of tensors compared."""
    ca = torch.load(a, map_location="cpu", weights_only=True)
    cb = torch.load(b, map_location="cpu", weights_only=True)
    parts = ("step", "seed", "g", "d", "opt_g", "opt_d")
    return same_bits({k: ca[k] for k in parts}, {k: cb[k] for k in parts})


def compare_blobs(got: dict, want: dict, rel_tol: float,
                  param_tol: float | None) -> dict:
    """Two runs of the same steps (``want`` at dp=1): each step's metrics
    within rel_tol of the reference (relative to max(|x|, 1e-3)), the
    parameters within param_tol (None: reported, not held), each net's
    Adam moments within rel_tol as one relative L2 error; raises if they
    differ (with every error), else the worst errors."""
    if len(got["metrics"]) != len(want["metrics"]):
        raise AssertionError(f"{len(got['metrics'])} steps against "
                             f"{len(want['metrics'])}")
    metric_err, worst = 0.0, None
    for mg, mw in zip(got["metrics"], want["metrics"]):
        if set(mg) != set(mw):
            raise AssertionError(f"dp metrics {sorted(mg)} != {sorted(mw)}")
        for k in mw:
            err = abs(mg[k] - mw[k]) / max(abs(mw[k]), 1e-3)
            if not np.isfinite(mg[k]):
                err = float("inf")
            if err >= metric_err:
                metric_err, worst = err, (k, mg[k], mw[k])
    param_err, moment_err = 0.0, 0.0
    for net in ("g", "d"):
        for n, ref in want[net].items():
            param_err = max(param_err,
                            (got[net][n] - ref).abs().max().item())
        for key in ("exp_avg", "exp_avg_sq"):
            sq = [0.0, 0.0]
            for i, st in want["opt_" + net]["state"].items():
                a = got["opt_" + net]["state"][i][key].double()
                b = st[key].double()
                sq[0] += float((a - b).square().sum())
                sq[1] += float(b.square().sum())
            moment_err = max(moment_err, (sq[0] / max(sq[1], 1e-300)) ** 0.5)
    out = {"metric_max_rel_err": metric_err, "worst_metric": worst,
           "param_max_abs_err": param_err, "moment_max_rel_l2": moment_err,
           "tol_rel": rel_tol, "tol_param_abs": param_tol}
    if not (metric_err <= rel_tol and moment_err <= rel_tol
            and (param_tol is None or param_err <= param_tol)):
        raise AssertionError(f"dp state differs: {out}")
    return out


def parity_errors(got: dict, want: dict) -> dict:
    """compare_blobs' errors of ``got`` against ``want`` beside the parity
    bounds, and ``over``: the names of the errors beyond their bound."""
    out = compare_blobs(got, want, float("inf"), None)
    out.update(tol_rel=PARITY_REL_TOL, tol_param_abs=PARITY_PARAM_TOL)
    out["over"] = [k for k, tol in (("metric_max_rel_err", PARITY_REL_TOL),
                                    ("moment_max_rel_l2", PARITY_REL_TOL),
                                    ("param_max_abs_err", PARITY_PARAM_TOL))
                   if not out[k] <= tol]
    return out


def frozen(blob: dict) -> dict:
    """A state_blob with both optimizers' lr 0 and Adam's moments zeroed.
    One step from it leaves the parameters as they are, so every update
    of the step takes its gradient at the same parameters, and the
    moments record those gradients before Adam divides one by the
    other's root: m the (1 - b1)-weighted sum of the updates' gradients,
    v the same of their squares. Held to PARITY_REL_TOL they compare the
    gradients themselves."""
    out = dict(blob)
    for key in ("opt_g", "opt_d"):
        opt = blob[key]
        out[key] = {
            "param_groups": [dict(g, lr=0.0) for g in opt["param_groups"]],
            "state": {i: {k: v if k == "step" else torch.zeros_like(v)
                          for k, v in st.items()}
                      for i, st in opt["state"].items()}}
    return out


def hold_bf16_to_dp1(got: dict, want: dict, exact: dict) -> dict:
    """bf16 steps at dp=N (``got``) against the same bf16 steps at dp=1
    (``want``), all from one warm state, held to DP_BF16_FACTOR times
    the distance of ``want`` from the same steps in f32 (``exact``): the
    worst metric and the worst moment relative L2 each. Raises if
    farther, else both comparisons."""
    dp = compare_blobs(got, want, float("inf"), None)
    own = compare_blobs(want, exact, float("inf"), None)
    out = {"dp_vs_dp1": dp, "bf16_vs_f32": own, "factor": DP_BF16_FACTOR}
    for key in ("metric_max_rel_err", "moment_max_rel_l2"):
        if not dp[key] <= DP_BF16_FACTOR * own[key]:
            raise AssertionError(f"bf16 dp state differs beyond bf16's "
                                 f"own error ({key}): {out}")
    return out


# -- Adam's update from device scalars (kernels/adam.py) -----------------------

# every parameter shape of these presets' G and D; ZeRO-1's row blocks of
# the flagship at dp=4 (each rank's views, off the tensors' starts)
ADAM_PRESETS = ("wgan_gp_b64", "cond_gru_sc09", "dual_stft",
                "music_44k_dp16", "resample_22k")
ADAM_ZERO1 = ("wgan_gp_b64", 4)
ADAM_COUNTS = range(1, 401)


def adam_cases(dev) -> list[dict]:
    """Each preset's G and D parameters (seeded values, moments of a few
    steps' scale, the second moment with exact zeros), their lr and
    betas; then the ZeRO-1 blocks of ADAM_ZERO1, one case per rank."""
    from audiogan_tpu_torch.config import get_preset
    from audiogan_tpu_torch.models import (build_discriminator,
                                           build_generator)
    from audiogan_tpu_torch.parallel.mesh import DataMesh, zero1_rows
    gen = torch.Generator(dev).manual_seed(0)

    def tensors(shapes):
        ps = [torch.randn(s, generator=gen, device=dev) for s in shapes]
        mu = [torch.randn(s, generator=gen, device=dev) * 1e-3
              for s in shapes]
        nu = [(torch.rand(s, generator=gen, device=dev) - 0.1).clamp_min(0)
              ** 4 * 1e-4 for s in shapes]
        return ps, mu, nu

    cases = []
    for name in ADAM_PRESETS:
        cfg = get_preset(name)
        t = cfg.train
        for net, build, lr in (("G", build_generator, t.lr_g),
                               ("D", build_discriminator, t.lr_d)):
            shapes = [tuple(p.shape) for p in
                      build(cfg, device="meta").parameters()]
            ps, mu, nu = tensors(shapes)
            cases.append({"name": f"{name} {net}", "params": ps, "mu": mu,
                          "nu": nu, "lr": lr, "betas": (t.beta1, t.beta2)})
    name, dp = ADAM_ZERO1
    for case in [c for c in cases if c["name"].startswith(name + " ")]:
        for r in range(dp):
            mesh = DataMesh(dp, r)
            views = [p[zero1_rows(p, mesh)] for p in case["params"]]
            cases.append({**case, "name": f"{case['name']} zero1 {r}/{dp}",
                          "params": views,
                          "mu": [m[zero1_rows(m, mesh)] for m in case["mu"]],
                          "nu": [v[zero1_rows(v, mesh)]
                                 for v in case["nu"]]})
    return cases


def hold_adam(case: dict, counts=ADAM_COUNTS) -> dict:
    """kernels/adam.py's kernel against its plain form (torch's foreach
    ops) on ``case`` at each count: every parameter equal to the bit, or
    AssertionError. The parameters are put back after each count."""
    from audiogan_tpu_torch.kernels.adam import (adam_update,
                                                 adam_update_plain)
    from audiogan_tpu_torch.train.state import ADAM_EPS, adam_scalars
    ps, mu, nu = case["params"], case["mu"], case["nu"]
    saved = [p.clone() for p in ps]
    n = len(ps)
    cols = list(range(n))
    for t in counts:
        scal = torch.tensor(adam_scalars(case["lr"], *case["betas"],
                                         [float(t)] * n),
                            dtype=torch.float32, device=ps[0].device)
        adam_update(ps, mu, nu, scal, cols, ADAM_EPS)
        got = [p.clone() for p in ps]
        torch._foreach_copy_(ps, saved)
        adam_update_plain(ps, mu, nu, scal, cols, ADAM_EPS)
        for i, (a, b) in enumerate(zip(got, ps)):
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise AssertionError(
                    f"adam {case['name']} count {t}: tensor {i} "
                    f"{list(b.shape)} differs from torch's foreach ops by "
                    f"{(a - b).abs().max().item()}")
        torch._foreach_copy_(ps, saved)
    return {"case": case["name"], "tensors": n, "counts": len(counts),
            "elements": sum(p.numel() for p in ps)}
