"""audiogan_tpu_torch's halo-exchange ops (parallel/halo.py) against the
reference's (audiogan_tpu/parallel/halo.py) inside ``jax.shard_map`` on
two fake CPU devices, at tests/parallel/test_halo.py's (k, s) cases.

The port runs in two processes over gloo, one cp group of two ranks
(tools/dp_check.py::spawn, one spawn for every case, one intra-op
thread each); each rank's slices are put back together along time and
compared with the reference's global result. Checked:

- cp_conv1d_ba (K1''s plain form on the halo-extended slice) and
  cp_conv_transpose1d_ba (K1's), with bias and activation: the output,
  the first-order gradients of sum(y r) in x, w and b, and the second
  order (the gradients of sum(dx q) in x and w), as the penalty's
  double backprop takes them; a slice narrower than the halo takes the
  all-gather route (each rank's routes are counted);
- cp_conv2d_frames (the STFT critic's conv2d), output and first order,
  on both routes;
- cp_phase_shuffle: the reference's shifts, reflection at the global
  edges (also against the port's unsharded phase_shuffle), the gradient;
- cp_chunked_scan: the output slices and the gradient of a weight;
- gather_halo: the extended slices, zeros at the global edges.

f32; the same sums in another order: 1e-5 relative to the largest value
(1e-4 for gradients).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from audiogan_tpu.parallel import halo as jhalo
from audiogan_tpu_torch.ops.phase_shuffle import phase_shuffle
from audiogan_tpu_torch.tools import dp_check

torch.set_num_threads(1)

CP = 2
REL, GRAD_REL = 1e-5, 1e-4
T_SPEC = P(None, "cp", None)

# (k, s, T, act): the critic's LeakyReLU, and tanh, whose second
# derivative keeps x in the second order
CONV1D = {"k25s4": (25, 4, 640, "leaky_relu"), "k9s2": (9, 2, 640, "tanh"),
          "k25s1": (25, 1, 640, "tanh"), "k5s5": (5, 5, 640, "tanh"),
          "k25s4_narrow": (25, 4, 16, "leaky_relu")}
CONVT = {"k25s4": (25, 4, 64), "k9s2": (9, 2, 64), "k5s5": (5, 5, 64),
         "k25s4_narrow": (25, 4, 4)}
CONV2D = {"k5": (5, 16), "k9_narrow": (9, 4)}
SHUFFLE = {"rad2": 2, "rad1": 1}


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _mesh():
    return Mesh(np.asarray(jax.devices()[:CP]), ("cp",))


def _cases():
    rng = np.random.default_rng(0)
    cases = {}
    for name, (k, s, t, act) in CONV1D.items():
        cases["conv1d/" + name] = dict(
            op="conv1d", stride=s, act=act, x=_rand(rng, 2, t, 4),
            w=_rand(rng, k, 4, 3, scale=0.1), b=_rand(rng, 3),
            r=_rand(rng, 2, t // s, 3), q=_rand(rng, 2, t, 4))
    for name, (k, s, t) in CONVT.items():
        cases["convt1d/" + name] = dict(
            op="convt1d", stride=s, act="tanh", x=_rand(rng, 2, t, 4),
            w=_rand(rng, k, 4, 3, scale=0.1), b=_rand(rng, 3),
            r=_rand(rng, 2, t * s, 3), q=_rand(rng, 2, t, 4))
    for name, (k, f) in CONV2D.items():
        cases["conv2d/" + name] = dict(
            op="conv2d", stride=2, x=_rand(rng, 2, f, 9, 3),       # NHWC
            w=_rand(rng, k, 5, 3, 4, scale=0.1), b=_rand(rng, 4),
            r=_rand(rng, 2, f // 2, 5, 4))
    for name, rad in SHUFFLE.items():
        key = jax.random.PRNGKey(rad)
        cases["shuffle/" + name] = dict(
            op="shuffle", rad=rad, key=key, x=_rand(rng, 3, 32, 2),
            shifts=np.asarray(jax.random.randint(key, (3,), -rad, rad + 1)),
            r=_rand(rng, 3, 32, 2))
    cases["scan"] = dict(op="scan", length=3, a=_rand(rng, 4, 4, scale=0.5),
                         c=_rand(rng, 2, 4), h0=_rand(rng, 2, 4),
                         r=_rand(rng, 6, 2, 4))
    cases["halo"] = dict(op="halo", left=3, right=5, x=_rand(rng, 2, 16, 2))
    return cases


CASES = _cases()


def _port_case(case):
    """The case as the job takes it: torch tensors, NCHW for conv2d."""
    out = {}
    for k, v in case.items():
        if k == "key":
            continue
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.array(v))
            if case["op"] == "conv2d" and k in ("x", "r"):
                v = v.permute(0, 3, 1, 2).contiguous()
        out[k] = v
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """{case name: (per-rank results, per-rank routes)}, one spawn."""
    names = list(CASES)
    res = dp_check.spawn(CP, [{"name": "halo", "fn": "halo", "kw": {
        "cases": [_port_case(CASES[n]) for n in names]}}],
        tmp_path_factory.mktemp("halo"))["halo"]
    return {n: [r["results"][i] for r in res] for i, n in
            enumerate(names)}, [r["routes"] for r in res]


def _joined(ranks, key, dim=1):
    return np.concatenate([r[key].numpy() for r in ranks], axis=dim)


def _close(got, want, rel=REL, err_msg=""):
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    np.testing.assert_allclose(got, want, rtol=0, err_msg=err_msg,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def _conv_ref(case):
    """The reference's op with bias and activation, in shard_map: (y,
    first-order grads of sum(y r), second-order grads of sum(dx q))."""
    s, op = case["stride"], case["op"]

    act = (functools.partial(jax.nn.leaky_relu, negative_slope=0.2)
           if case["act"] == "leaky_relu" else jnp.tanh)

    def local(x, w, b):
        if op == "conv1d":
            return act(jhalo.cp_conv1d(x, w, s, "cp") + b)
        return act(jhalo.cp_conv_transpose1d(x, w, s, "cp") + b)
    f = shard_map(local, mesh=_mesh(), in_specs=(T_SPEC, P(), P()),
                  out_specs=T_SPEC)
    r, q = jnp.asarray(case["r"]), jnp.asarray(case["q"])

    def l1(x, w, b):
        return jnp.sum(f(x, w, b) * r)

    def l2(x, w, b):
        return jnp.sum(jax.grad(l1)(x, w, b) * q)

    @jax.jit
    def all_orders(x, w, b):
        return (f(x, w, b), jax.grad(l1, argnums=(0, 1, 2))(x, w, b),
                jax.grad(l2, argnums=(0, 1))(x, w, b))
    return all_orders(*[jnp.asarray(case[k]) for k in "xwb"])


@pytest.mark.parametrize("name", [n for n in CASES
                                  if n.split("/")[0] in ("conv1d",
                                                         "convt1d")])
def test_conv_matches_reference_to_second_order(port, name):
    case, ranks = CASES[name], port[0][name]
    y, (dx, dw, db), (dx2, dw2) = _conv_ref(case)
    _close(_joined(ranks, "y"), y, err_msg="y")
    _close(_joined(ranks, "dx"), dx, GRAD_REL, "dx")
    for key, want in (("dw", dw), ("db", db), ("dw2", dw2)):
        for r in ranks:
            _close(r[key].numpy(), want, GRAD_REL, key)
    _close(_joined(ranks, "dx2"), dx2, GRAD_REL, "dx2")


def test_narrow_slices_take_the_all_gather_route(port):
    """Two of the conv1d cases, one convT and one conv2d per rank have
    slices narrower than their halo: the reference's all-gather route."""
    for routes in port[1]:
        assert routes == {"conv1d/halo": 4, "conv1d/gather": 1,
                          "convt1d/halo": 3, "convt1d/gather": 1,
                          "conv2d/halo": 1, "conv2d/gather": 1}, routes


def _vjp(f, args, r):
    """(f(*args), the gradients of sum(f(*args) r) in every arg), jitted."""
    @jax.jit
    def run(*a):
        y, back = jax.vjp(f, *a)
        return y, back(r)
    return run(*args)


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("conv2d")])
def test_conv2d_frames_matches_reference(port, name):
    case, ranks = CASES[name], port[0][name]
    f = shard_map(lambda h, w, b: jhalo.cp_conv2d_frames(h, w, (2, 2), "cp")
                  + b, mesh=_mesh(), in_specs=(T_SPEC, P(), P()),
                  out_specs=T_SPEC)
    y, (dx, dw, db) = _vjp(f, [jnp.asarray(case[k]) for k in "xwb"],
                           jnp.asarray(case["r"]))
    nhwc = (0, 2, 3, 1)
    _close(_joined(ranks, "y", 2).transpose(nhwc), y, err_msg="y")
    _close(_joined(ranks, "dx", 2).transpose(nhwc), dx, GRAD_REL, "dx")
    for r_ in ranks:
        _close(r_["dw"].numpy(), dw, GRAD_REL, "dw")
        _close(r_["db"].numpy(), db, GRAD_REL, "db")


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("shuffle")])
def test_phase_shuffle_reflects_at_the_global_edges(port, name):
    case, ranks = CASES[name], port[0][name]
    rad, key = case["rad"], case["key"]
    f = shard_map(lambda x: jhalo.cp_phase_shuffle(x, key, rad, "cp"),
                  mesh=_mesh(), in_specs=(T_SPEC,), out_specs=T_SPEC)
    y, (dx,) = _vjp(f, [jnp.asarray(case["x"])], jnp.asarray(case["r"]))
    got = _joined(ranks, "y")
    _close(got, y, err_msg="y")
    _close(_joined(ranks, "dx"), dx, GRAD_REL, "dx")
    # the unsharded op's reflect pad at both ends of the clip
    whole = phase_shuffle(torch.tensor(case["x"]),
                          torch.tensor(case["shifts"]), rad)
    np.testing.assert_array_equal(got, whole.numpy())
    assert (case["shifts"] != 0).any()


def test_chunked_scan_matches_reference(port):
    case, ranks = CASES["scan"], port[0]["scan"]
    c, h0 = jnp.asarray(case["c"]), jnp.asarray(case["h0"])

    def local(a):
        def step(carry, _):
            h = jnp.tanh(carry @ a + c)
            return h, h
        return jhalo.cp_chunked_scan(step, h0, case["length"], "cp")
    f = shard_map(local, mesh=_mesh(), in_specs=(P(),),
                  out_specs=P("cp", None, None))
    y, (da,) = _vjp(f, [jnp.asarray(case["a"])], jnp.asarray(case["r"]))
    _close(_joined(ranks, "y", 0), y, err_msg="y")
    for r_ in ranks:
        _close(r_["da"].numpy(), da, GRAD_REL, "da")


def test_gather_halo_matches_reference(port):
    case, ranks = CASES["halo"], port[0]["halo"]
    f = shard_map(lambda x: jhalo.gather_halo(x, case["left"],
                                              case["right"], "cp"),
                  mesh=_mesh(), in_specs=(T_SPEC,), out_specs=T_SPEC)
    want = np.asarray(jax.jit(f)(jnp.asarray(case["x"])))
    np.testing.assert_array_equal(_joined(ranks, "y"), want)
    assert not ranks[0]["y"][:, :case["left"]].any()        # left edge
    assert not ranks[-1]["y"][:, -case["right"]:].any()     # right edge
