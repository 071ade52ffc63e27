"""The served sampler's fixed-buffer body (serve/sample_graph.py) on the
CPU: against the JAX package's sampler on its own z draw, against
build_sample_fn to the bit at batch 8, the eager route it reports, the
copy each request gets, concurrent requests through make_server, labels
from one request to the next, and the capture's node check
(train/step_graph.py::check_kernel_nodes) on the counts a host loop gives.
The replayed CUDA graph itself runs on the card
(tests/test_torch_cuda.py -k "serve or sampler")."""

import base64
import dataclasses
import json
import sys
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from audiogan_tpu.config import PRESETS as JAX_PRESETS
from audiogan_tpu.config import ModelCfg
from audiogan_tpu.train.sample import build_sample_fn as jax_build_sample_fn
from audiogan_tpu.train.state import create_train_state
from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.convert import params_from_jax
from audiogan_tpu_torch.data.wavio import wav_bytes
from audiogan_tpu_torch.models import build_generator
from audiogan_tpu_torch.models.init import init_params
from audiogan_tpu_torch.serve import (ServedSampler, export_sampler,
                                      load_sampler, make_server, server)
from audiogan_tpu_torch.train.sample import build_sample_fn
from audiogan_tpu_torch.train.step_graph import _Watch, check_kernel_nodes

from helpers_train import tiny_config

BATCH = 8
SEEDS = [0, 1, 7, 2 ** 40, -3]


def _jax_config(kind: str):
    """tiny_sc09 (unconditional WaveGAN), or a tiny conditional GRU G."""
    if kind == "wavegan":
        return JAX_PRESETS["tiny_sc09"]()
    cfg = tiny_config(model=ModelCfg(
        generator="gru", model_dim=4, kernel_size=9, gru_frame_size=64,
        gru_hidden=16, max_channels=16, phase_shuffle=1))
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, num_classes=4)).validate()


def _port_config(jcfg) -> Config:
    return Config.from_json(jcfg.to_json()).validate()


@pytest.fixture(scope="module", params=["wavegan", "gru"])
def artifact(request, tmp_path_factory):
    """(port config, G's state dict, artifact dir) at batch 8."""
    cfg = _port_config(_jax_config(request.param))
    sd = init_params(build_generator(cfg, device="cpu"), seed=0).state_dict()
    d = tmp_path_factory.mktemp(f"art_{request.param}")
    export_sampler(cfg, sd, num=BATCH, out_dir=d)
    return cfg, sd, d


def _labels(cfg, seed: int) -> np.ndarray | None:
    n_cls = cfg.data.num_classes
    if not n_cls:
        return None
    return np.random.default_rng(abs(seed) % 2 ** 32).integers(
        0, n_cls, BATCH)


@pytest.mark.parametrize("kind", ["wavegan", "gru"])
def test_sampler_body_matches_jax(kind, tmp_path):
    """The body on its fixed buffers, filled with the z the reference's
    jit'd sampler draws for a key (and the same labels), against that
    sampler's waveforms: the generator parity tests' tolerance."""
    jcfg = _jax_config(kind)
    cfg = _port_config(jcfg)
    params_g = create_train_state(jcfg, seed=0).params_g
    sd = params_from_jax({k: np.asarray(v) for k, v in
                          flatten_dict(params_g, sep="/").items()})
    export_sampler(cfg, sd, num=BATCH, out_dir=tmp_path)
    graph = ServedSampler(tmp_path, device="cpu")._graph
    key = jax.random.key(5)
    z = np.array(jax.random.normal(key, (BATCH, cfg.model.latent_dim)))
    labels = _labels(cfg, 5)
    want = np.asarray(jax_build_sample_fn(jcfg)(
        params_g, key, None if labels is None else labels.astype(np.int32),
        num=BATCH))
    graph.inputs["z"].copy_(torch.from_numpy(z))
    if labels is not None:
        graph.inputs["labels"].copy_(torch.from_numpy(labels))
    got = graph.body()
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("seed", SEEDS)
def test_fixed_buffer_body_equals_build_sample_fn(artifact, seed):
    """ServedSampler on the CPU (the fixed-buffer body, run eagerly, and
    the copy out) gives build_sample_fn's bytes for the same weights, seed
    and labels."""
    cfg, sd, d = artifact
    s = load_sampler(d, device="cpu")
    labels = _labels(cfg, seed)
    got = s.generate(seed, labels)
    want = build_sample_fn(cfg, "cpu")(
        sd, seed, None if labels is None else torch.from_numpy(labels),
        num=BATCH).numpy()
    assert got.shape == (BATCH, cfg.data.clip_len)
    np.testing.assert_array_equal(got, want)


def test_the_cpu_sampler_reports_the_eager_route(artifact):
    _, _, d = artifact
    for s in (load_sampler(d, device="cpu"),
              ServedSampler(d, device="cpu", replay=False)):
        assert s.route == "eager"
        assert s.summary() == {"route": "eager", "batch": BATCH}


def test_each_request_gets_an_array_of_its_own(artifact):
    """Two requests in turn: the first's array is unchanged by the second
    and shares no memory with it or with the sampler's fixed buffers."""
    cfg, _, d = artifact
    s = load_sampler(d, device="cpu")
    a = s.generate(1, _labels(cfg, 1))
    kept = a.copy()
    b = s.generate(2, _labels(cfg, 2))
    np.testing.assert_array_equal(a, kept)
    assert not np.array_equal(a, b)
    assert not np.shares_memory(a, b)
    for buf in s._graph.inputs.values():
        assert buf is None or not np.shares_memory(a, buf.numpy())


def _post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _serving(sampler):
    srv = make_server(sampler, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread, "http://%s:%d/generate" % srv.server_address[:2]


def _stop(srv, thread) -> None:
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=60)
    assert not thread.is_alive()


def _wavs(sampler, waves) -> list[str]:
    return [base64.b64encode(wav_bytes(sampler.sample_rate, w)).decode()
            for w in waves]


def test_concurrent_requests_get_their_own_seeds_bytes(artifact,
                                                      monkeypatch):
    """Eight /generate requests with different seeds started together
    through make_server, three rounds, the interpreter switching threads
    often: each answer holds its own seed's WAVs. The server encodes them
    outside the sampler's lock, here slowed to 20 ms a clip, so an answer
    that were a view of a fixed buffer would carry a later request's
    audio."""
    cfg, _, d = artifact
    s = load_sampler(d, device="cpu")
    seeds = [11 * i + 3 for i in range(8)]
    want = {seed: _wavs(s, s.generate(seed, _labels(cfg, seed)))
            for seed in seeds}

    def slow_wav_bytes(*args):
        time.sleep(0.02)
        return wav_bytes(*args)
    monkeypatch.setattr(server, "wav_bytes", slow_wav_bytes)
    srv, thread, url = _serving(s)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            got, errors = {}, []
            start = threading.Barrier(len(seeds))

            def ask(seed):
                try:
                    body = {"seed": seed}
                    labels = _labels(cfg, seed)
                    if labels is not None:
                        body["labels"] = labels.tolist()
                    start.wait(timeout=60)
                    got[seed] = _post(url, body)["wavs"]
                except Exception as err:  # reported below
                    errors.append(err)
            workers = [threading.Thread(target=ask, args=(seed,))
                       for seed in seeds]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=120)
            assert not any(w.is_alive() for w in workers)
            assert not errors, errors
            for seed in seeds:
                assert got[seed] == want[seed], seed
    finally:
        sys.setswitchinterval(interval)
        _stop(srv, thread)


def test_labels_do_not_leak_into_the_next_request(tmp_path):
    """A conditional sampler: a request with labels, then one without
    (the default labels) and one for a prefix with two labels (padded with
    zeros by the server): each equals a fresh sampler's answer."""
    cfg = _port_config(_jax_config("gru"))
    sd = init_params(build_generator(cfg, device="cpu"), seed=0).state_dict()
    export_sampler(cfg, sd, num=BATCH, out_dir=tmp_path)
    s = load_sampler(tmp_path, device="cpu")
    fresh = load_sampler(tmp_path, device="cpu")
    s.generate(4, np.full(BATCH, 3))
    np.testing.assert_array_equal(s.generate(4), fresh.generate(4))
    srv, thread, url = _serving(s)
    try:
        _post(url, {"seed": 4, "labels": [2] * BATCH})
        got = _post(url, {"seed": 4, "num": 2, "labels": [1, 3]})["wavs"]
        default = _post(url, {"seed": 4})["wavs"]
    finally:
        _stop(srv, thread)
    padded = np.zeros(BATCH, np.int64)
    padded[:2] = [1, 3]
    fresh = load_sampler(tmp_path, device="cpu")
    assert got == _wavs(fresh, fresh.generate(4, padded)[:2])
    assert default == _wavs(fresh, fresh.generate(4))


# (own kernel nodes, other nodes) of one port kernel in a capture, and
# the launch counts its calls took back: the check passes or raises
NODE_CASES = {
    "one_node_a_launch": ((5, 0), {"launches": 5, "launches_tc": 4}, True),
    "a_launch_short": ((4, 0), {"launches": 5}, False),
    "host_loop": ((0, 1029), {"launches": 1, "launches_loop": 1}, True),
    "host_loop_without_nodes": ((0, 0), {"launches": 1,
                                         "launches_loop": 1}, False),
    "persistent_beside_a_loop": ((1, 1030), {"launches": 2,
                                             "launches_loop": 1}, True),
}


@pytest.mark.parametrize("case", NODE_CASES)
def test_kernel_nodes_are_held_to_the_launches(case):
    (own, other), counts, ok = NODE_CASES[case]
    port = {"K4 gru_scan_fwd": {"calls": counts["launches"],
                                "kernel_nodes": own, "other_nodes": other}}
    delta = {("gru_scan_fwd", k): v for k, v in counts.items()}
    if ok:
        check_kernel_nodes(port, delta, "the captured sampler")
    else:
        with pytest.raises(RuntimeError, match="the captured sampler holds"):
            check_kernel_nodes(port, delta, "the captured sampler")


def test_a_failure_under_the_watch_names_the_op_and_kernel_call(artifact):
    """What a failed warm-up or capture names: the last op, and the last
    kernel call of the port (here the generator's last convT, K1, whose
    plain form the CPU runs), also after ops outside any kernel."""
    cfg, sd, d = artifact
    graph = load_sampler(d, device="cpu")._graph
    graph.fill(0, _labels(cfg, 0))
    watch = _Watch(record_ops=False)
    with pytest.raises(ZeroDivisionError), watch:
        graph.body()
        1 / 0
    where = watch.failed_at()
    assert "aten op" in where
    assert "the last kernel call: K1 conv_transpose1d_ba" in where
