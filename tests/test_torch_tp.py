"""audiogan_tpu_torch's tensor parallelism (parallel/tp.py,
parallel/tp_models.py) against the reference's
(audiogan_tpu/parallel/tp.py, tp_models.py) inside ``jax.shard_map`` on
two fake CPU devices, and against the port's own unsharded critic, on
the JAX initial weights (convert.params_from_jax).

The port runs in two processes over gloo, one tp group of two ranks
(tools/dp_check.py::spawn, one spawn for every case, one intra-op thread
each). Checked, at tiny sizes (helpers_train.tiny_config), f32:

- the column/row conv pair (a column conv with its bias, relu, a row
  conv, the row bias after the sum) against the reference's pair: the
  output and the gradients of the input and of every weight, at the
  reference's tolerance 1e-5 (tests/parallel/test_tp.py);
- the channel-parallel critic: unconditional and conditional, with the
  phase shuffle (radius 2, the reference's shifts: fold_in(key, layer))
  and without, and a critic of four layers (even: the head sees whole
  features) against the reference's tp critic and the unsharded one:
  the score at 1e-5 of the largest; the gradient of sum D(x-hat) with
  respect to x-hat and the WGAN-GP loss's gradient of every parameter
  (penalty included) at atol 1e-4, rtol 1e-3
  (tests/parallel/test_tp_model.py). A parameter used through a slice
  has on each rank its slice's share (summed over the ranks here); one
  used after a sum has the whole gradient on every rank, to the bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from audiogan_tpu.losses import gradient_penalty as jgp
from audiogan_tpu.losses import wgan_d_loss as jd_loss
from audiogan_tpu.ops.conv import conv1d as jconv1d
from audiogan_tpu.parallel.tp import tp_conv1d_col, tp_conv1d_row
from audiogan_tpu.parallel.tp_models import tp_discriminator_forward
from audiogan_tpu.train.state import create_train_state as jcreate
from audiogan_tpu_torch.convert import params_from_jax
from audiogan_tpu_torch.losses import gradient_penalty, wgan_d_loss
from audiogan_tpu_torch.parallel.tp_models import sliced_params
from audiogan_tpu_torch.tools import dp_check

from helpers_train import tiny_config
from test_torch_train import _port_state

torch.set_num_threads(1)

TP, B = 2, 3
REL = 1e-5
PAIR_TOL = 1e-5                 # tests/parallel/test_tp.py:40
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3   # tests/parallel/test_tp_model.py:100


def _variants():
    base = tiny_config()

    def cfg(shuffle, classes=0, strides=(4, 4, 4)):
        return dataclasses.replace(
            base, data=dataclasses.replace(base.data, num_classes=classes),
            model=dataclasses.replace(base.model, phase_shuffle=shuffle,
                                      strides=strides)).validate()
    return {"plain": cfg(0), "shuffle": cfg(2), "cond": cfg(0, 4),
            "cond_shuffle": cfg(2, 4), "even": cfg(2, 0, (4, 4, 4, 4)),
            "even_cond": cfg(0, 4, (4, 4, 4, 4))}


VARIANTS = _variants()


def _mesh():
    return Mesh(np.asarray(jax.devices()[:TP]), ("tp",))


def _pair_inputs(seed=3):
    rng = np.random.default_rng(seed)
    b, t, cin, mid, cout, k, s = 2, 256, 8, 32, 16, 9, 2

    def r(*sh, scale=1.0):
        return (rng.standard_normal(sh) * scale).astype(np.float32)
    return dict(x=r(b, t, cin), w1=r(k, cin, mid, scale=0.1),
                b1=r(mid, scale=0.1), w2=r(k, mid, cout, scale=0.1),
                b2=r(cout, scale=0.1), r=r(b, t // s, cout), stride=s)


def _reference_pair(inp):
    """The reference's col/row pair under shard_map and the gradients of
    sum(y r) with respect to (x, w1, b1, w2, b2)."""
    s = inp["stride"]

    def local(x, w1, b1, w2, b2):
        h = jax.nn.relu(tp_conv1d_col(x, w1, s, "tp") + b1)
        return tp_conv1d_row(h, w2, 1, "tp") + b2

    fn = shard_map(local, mesh=_mesh(),
                   in_specs=(P(), P(None, None, "tp"), P("tp"),
                             P(None, "tp", None), P()), out_specs=P())
    args = [jnp.asarray(inp[k]) for k in ("x", "w1", "b1", "w2", "b2")]
    y = jax.jit(fn)(*args)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) * inp["r"]),
                             argnums=(0, 1, 2, 3, 4)))(*args)

    def whole(x, w1, b1, w2, b2):
        h = jax.nn.relu(jconv1d(x, w1, stride=s, impl="xla") + b1)
        return jconv1d(h, w2, stride=1, impl="xla") + b2
    return {"y": np.asarray(y), "y_whole": np.asarray(whole(*args)),
            **{f"d{n}": np.asarray(g)
               for n, g in zip(("x", "w1", "b1", "w2", "b2"), grads)}}


def _critic_inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    t = cfg.data.clip_len
    key = jax.random.PRNGKey(seed + 7)
    rad, sites = cfg.model.phase_shuffle, len(cfg.model.strides) - 1
    return dict(
        x=rng.uniform(-1, 1, (B, t, 1)).astype(np.float32),
        fake=rng.uniform(-1, 1, (B, t, 1)).astype(np.float32),
        eps=np.asarray(jax.random.uniform(jax.random.PRNGKey(seed + 9),
                                          (B, 1, 1))),
        labels=(rng.integers(0, cfg.data.num_classes, B).astype(np.int32)
                if cfg.data.num_classes else None),
        key=key,
        shifts=np.stack([np.asarray(jax.random.randint(
            jax.random.fold_in(key, i), (B,), -rad, rad + 1))
            for i in range(sites)]) if rad else None)


def _reference_critic(cfg, params, inp):
    """The reference's tp critic under shard_map: scores, the gradient of
    sum D at x-hat, and the WGAN-GP loss's parameter gradients."""
    cond = inp["labels"] is not None
    key = inp["key"] if inp["shifts"] is not None else None
    lab = jnp.asarray(inp["labels"]) if cond else None

    def local(p, v, *extra):
        return tp_discriminator_forward(p, v, cfg, "tp", shuffle_key=key,
                                        labels=extra[0] if cond else None)
    extra = (lab,) if cond else ()
    fwd = shard_map(local, mesh=_mesh(),
                    in_specs=(P(), P(), *((P(),) if cond else ())),
                    out_specs=P())

    def d(p, v):
        return fwd(p, v, *extra)
    x, fake = jnp.asarray(inp["x"]), jnp.asarray(inp["fake"])
    e = jnp.asarray(inp["eps"])
    xhat = e * x + (1 - e) * fake

    def loss(p):
        # the reference draws eps from its key inside; the same eps here
        gp, _ = jgp(lambda v: d(p, v), x, fake, jax.random.PRNGKey(9))
        return jd_loss(d(p, x), d(p, fake)) + 10.0 * gp
    eps_drawn = jax.random.uniform(jax.random.PRNGKey(9), (B, 1, 1))
    np.testing.assert_array_equal(np.asarray(eps_drawn), inp["eps"])
    grads = jax.jit(jax.grad(loss))(params)
    return {"score": np.asarray(jax.jit(d)(params, x)),
            "dxhat": np.asarray(jax.jit(jax.grad(
                lambda v: jnp.sum(d(params, v))))(xhat)),
            "grads": params_from_jax(flatten_dict(grads, sep="/"))}


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _unsharded(st, inp):
    """The port's unsharded critic on the same inputs."""
    t = {k: _t(v) for k, v in inp.items() if k != "key"}
    lab = None if t["labels"] is None else t["labels"].long()

    def d(v):
        return st.d(v, lab, t["shifts"])
    e = t["eps"].reshape(-1, 1, 1)
    xhat = (e * t["x"] + (1 - e) * t["fake"]).requires_grad_(True)
    (dxhat,) = torch.autograd.grad(d(xhat).sum(), xhat)
    params = dict(st.d.named_parameters())
    gp, _ = gradient_penalty([d], t["x"], t["fake"], t["eps"])
    loss = wgan_d_loss(d(t["x"]), d(t["fake"])) + 10.0 * gp
    grads = torch.autograd.grad(loss, list(params.values()))
    with torch.no_grad():
        score = d(t["x"])
    return {"score": score, "dxhat": dxhat,
            "grads": dict(zip(params, grads))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{variant: (reference, port per rank, port unsharded)} and the
    pair's (reference, port per rank)."""
    jobs, ref, whole = [], {}, {}
    pair = _pair_inputs()
    for name, cfg in VARIANTS.items():
        state = jcreate(cfg)
        inp = _critic_inputs(cfg)
        ref[name] = _reference_critic(cfg, state.params_d, inp)
        pcfg, st = _port_state(cfg, state)
        whole[name] = _unsharded(st, inp)
        cases = [{"op": "critic", **{k: _t(v) for k, v in inp.items()
                                     if k != "key"}}]
        if cases[0]["labels"] is not None:
            cases[0]["labels"] = cases[0]["labels"].long()
        if name == "plain":
            cases.append({"op": "pair", "stride": pair["stride"],
                          **{k: _t(v) for k, v in pair.items()
                             if k != "stride"}})
        jobs.append({"name": name, "fn": "tp_model", "kw": {
            "cfg_json": pcfg.to_json(), "state": dp_check.state_blob(st),
            "cases": cases}})
    port = dp_check.spawn(TP, jobs, tmp_path_factory.mktemp("tp_model"))
    pair_port = [r["results"][1] for r in port["plain"]]
    return ({n: (ref[n], [r["results"][0] for r in port[n]], whole[n])
             for n in VARIANTS}, (_reference_pair(pair), pair_port))


def _close(got, want, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want.detach() if isinstance(want, torch.Tensor)
                      else want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(got, want, rtol=0, err_msg=err_msg,
                               atol=REL * max(np.abs(want).max(), 1e-6))


def test_col_row_pair_matches_the_reference(runs):
    want, ranks = runs[1]
    np.testing.assert_allclose(want["y"], want["y_whole"], rtol=PAIR_TOL,
                               atol=PAIR_TOL)
    for r in ranks:
        for k in ("y", "dx", "dw1", "db1", "dw2", "db2"):
            np.testing.assert_allclose(r[k].numpy(), want[k], rtol=PAIR_TOL,
                                       atol=PAIR_TOL, err_msg=k)
        for k in ("y", "dx", "dw1", "db1", "dw2", "db2"):
            assert torch.equal(r[k], ranks[0][k]), k


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_tp_critic_score_matches_reference_and_unsharded(runs, variant):
    ref, ranks, whole = runs[0][variant]
    for r in ranks:                 # the score is the same on every rank
        assert torch.equal(r["score"], ranks[0]["score"])
        _close(r["score"], ref["score"], "vs reference")
        _close(r["score"], whole["score"], "vs unsharded")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_tp_critic_gradients_match(runs, variant):
    """The penalty's input gradient and every parameter's WGAN-GP
    gradient: against the reference's tp critic and the unsharded one."""
    ref, ranks, whole = runs[0][variant]
    for r in ranks:
        assert torch.equal(r["dxhat"], ranks[0]["dxhat"])
        for want in (ref["dxhat"], whole["dxhat"]):
            np.testing.assert_allclose(r["dxhat"].numpy(), np.asarray(want),
                                       atol=GRAD_ATOL, rtol=GRAD_RTOL)
        assert set(r["grads"]) == set(whole["grads"]) == set(ref["grads"])
        for n, g in r["grads"].items():
            for want in (ref["grads"][n], whole["grads"][n]):
                np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                           atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                           err_msg=n)
            # summed over the ranks, or whole on each: the same bits
            assert torch.equal(g, ranks[0]["grads"][n]), n


def test_sliced_params_follow_the_layer_parity():
    """Odd layer counts shard the head (its kernel and proj_embed summed
    over tp); even counts leave it whole. Row layers' biases never sum."""
    from audiogan_tpu_torch.models.factory import build_discriminator
    from audiogan_tpu_torch.config import Config
    odd = sliced_params(build_discriminator(Config.from_json(
        VARIANTS["cond"].to_json())))
    even = sliced_params(build_discriminator(Config.from_json(
        VARIANTS["even_cond"].to_json())))
    assert odd == {"conv_0_kernel", "conv_0_bias", "conv_1_kernel",
                   "conv_2_kernel", "conv_2_bias", "head.kernel",
                   "proj_embed.embedding"}
    assert even == {"conv_0_kernel", "conv_0_bias", "conv_1_kernel",
                    "conv_2_kernel", "conv_2_bias", "conv_3_kernel"}
