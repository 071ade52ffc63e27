"""audiogan_tpu_torch serving on the CPU: export -> load -> HTTP, mirroring
tests/serve/test_export.py, with the JAX package's meta.json and WAV codec
as the references."""

import base64
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from audiogan_tpu.data.wavio import read_wav
from audiogan_tpu.data.wavio import wav_bytes as jax_wav_bytes
from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.data.wavio import wav_bytes
from audiogan_tpu_torch.models import build_generator
from audiogan_tpu_torch.models.init import init_params
from audiogan_tpu_torch.serve import export_sampler, load_sampler, make_server
from audiogan_tpu_torch.train.sample import build_sample_fn

from helpers_train import tiny_config


def _artifact(path, num_classes=0, num=3):
    jcfg = tiny_config()
    jcfg = dataclasses.replace(
        jcfg, data=dataclasses.replace(jcfg.data, num_classes=num_classes))
    cfg = Config.from_json(jcfg.to_json()).validate()
    g = init_params(build_generator(cfg, device="cpu"), seed=0)
    sd = g.state_dict()
    export_sampler(cfg, sd, num=num, out_dir=path)
    return jcfg, cfg, sd


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    d = tmp_path_factory.mktemp("art")
    jcfg, cfg, sd = _artifact(d)
    return jcfg, cfg, sd, d


def test_export_matches_live_sampler(art):
    _, cfg, sd, d = art
    got = load_sampler(d, device="cpu").generate(seed=7)
    assert got.shape == (3, cfg.data.clip_len) and got.dtype == np.float32
    want = build_sample_fn(cfg, "cpu")(sd, 7, num=3).numpy()
    np.testing.assert_array_equal(got, want)


def test_export_deterministic_and_seed_sensitive(art):
    s = load_sampler(art[3], device="cpu")
    np.testing.assert_array_equal(s.generate(3), s.generate(3))
    assert not np.array_equal(s.generate(3), s.generate(4))


def test_export_meta_has_the_jax_keys(art, tmp_path):
    from audiogan_tpu.serve import export_sampler as jax_export_sampler
    from audiogan_tpu.train.state import create_train_state
    jcfg, _, _, d = art
    jax_export_sampler(jcfg, create_train_state(jcfg).params_g, num=3,
                       out_dir=tmp_path)
    want = json.loads((tmp_path / "meta.json").read_text())
    meta = json.loads((d / "meta.json").read_text())
    assert meta.keys() == want.keys()
    for key in ("num", "clip_len", "sample_rate", "num_classes", "model",
                "config"):
        assert meta[key] == want[key], key
    assert "cpu" in meta["platforms"] and "cuda" in meta["platforms"]


def test_export_conditional(tmp_path):
    _artifact(tmp_path, num_classes=4, num=4)
    s = load_sampler(tmp_path, device="cpu")
    labels = np.array([0, 1, 2, 3], np.int32)
    got = s.generate(seed=0, labels=labels)
    np.testing.assert_array_equal(got, s.generate(seed=0, labels=labels))
    assert not np.array_equal(got, s.generate(0, labels=labels[::-1]))
    with pytest.raises(ValueError, match="shape"):
        s.generate(0, labels=np.array([1, 2], np.int32))
    with pytest.raises(ValueError, match=r"\[0, 4\)"):
        s.generate(0, labels=np.array([0, 1, 2, 4], np.int32))


def test_entry_point_refuses_cpu_fallback(art):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_sampler(art[3])


def test_wav_bytes_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.2, 1.2, 777).astype(np.float32)
    assert wav_bytes(16000, x) == jax_wav_bytes(16000, x)
    i16 = (rng.standard_normal((50, 2)) * 1000).astype(np.int16)
    assert wav_bytes(8000, i16) == jax_wav_bytes(8000, i16)


def _post(url, body: bytes):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _status_of_post(url, body: bytes) -> int:
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url, body)
    return ei.value.code


@pytest.fixture
def served(request, tmp_path):
    num_classes = request.param
    _artifact(tmp_path, num_classes=num_classes)
    sampler = load_sampler(tmp_path, device="cpu")
    srv = make_server(sampler, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    host, port = srv.server_address[:2]
    try:
        yield sampler, f"http://{host}:{port}"
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    assert not t.is_alive()


@pytest.mark.parametrize("served", [0], indirect=True)
def test_http_server_roundtrip(served, tmp_path):
    sampler, url = served
    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["num"] == 3
    assert health["conditional"] is False

    out = _post(f"{url}/generate", json.dumps({"seed": 5, "num": 2}).encode())
    assert out["num"] == 2 and len(out["wavs"]) == 2
    again = _post(f"{url}/generate",
                  json.dumps({"seed": 5, "num": 3}).encode())
    assert again["wavs"][:2] == out["wavs"]       # same seed, same bytes
    other = _post(f"{url}/generate",
                  json.dumps({"seed": 6, "num": 2}).encode())
    assert other["wavs"] != out["wavs"]

    # the served wav decodes back to the sampler's waveform
    path = tmp_path / "a.wav"
    path.write_bytes(base64.b64decode(out["wavs"][0]))
    rate, x = read_wav(path)
    assert rate == sampler.sample_rate
    want = sampler.generate(5)[0]
    want16 = np.round(np.clip(want, -1, 1) * 32767) / 32768.0
    np.testing.assert_allclose(x, want16, atol=1.0 / 32768)

    for body in ({"num": 99}, {"num": 0}, {"seed": 1, "labels": [1, 2, 3]},
                 [1, 2]):
        assert _status_of_post(f"{url}/generate",
                               json.dumps(body).encode()) == 400, body
    assert _status_of_post(f"{url}/generate", b"{not json") == 400
    assert _status_of_post(f"{url}/nope", b"{}") == 404


@pytest.mark.parametrize("served", [4], indirect=True)
def test_http_server_conditional(served):
    sampler, url = served
    out = _post(f"{url}/generate",
                json.dumps({"seed": 1, "num": 2, "labels": [3, 0]}).encode())
    assert out["num"] == 2
    want = sampler.generate(1, np.array([3, 0, 0]))[:2]
    got = [np.frombuffer(base64.b64decode(w)[44:], "<i2") for w in out["wavs"]]
    want16 = np.round(np.clip(want, -1, 1) * 32767).astype(np.int16)
    np.testing.assert_array_equal(np.stack(got), want16)
    for labels in ([3], [0, 9], [0.5, 1], ["a", "b"], 3):
        body = json.dumps({"seed": 1, "num": 2, "labels": labels}).encode()
        assert _status_of_post(f"{url}/generate", body) == 400, labels


def test_cli_export_sample_on_cpu(tmp_path, capsys):
    from audiogan_tpu_torch.cli import main
    art = tmp_path / "art"
    assert main(["export", "--preset", "tiny_sc09", "--init-seed", "0",
                 "--num", "2", "--out_dir", str(art), "--device", "cpu"]) == 0
    s = load_sampler(art, device="cpu")
    assert s.num == 2 and s.meta["model"] == "tiny_sc09"
    torch.save(s._params, tmp_path / "g.pt")
    wav_dir = tmp_path / "wavs"
    for src in (["--init-seed", "0"], ["--weights", str(tmp_path / "g.pt")]):
        assert main(["sample", "--preset", "tiny_sc09", *src, "--num", "2",
                     "--seed", "4", "--out_dir", str(wav_dir),
                     "--device", "cpu"]) == 0
    rate, x = read_wav(wav_dir / "gen_seed4_1.wav")
    assert rate == 16000 and x.shape == (16384,)
    want = np.round(np.clip(s.generate(4)[1], -1, 1) * 32767) / 32768.0
    np.testing.assert_allclose(x, want, atol=1.0 / 32768)
