"""audiogan_tpu_torch's host batcher and the loop's two data paths against
the JAX package's (audiogan_tpu/data/corpus.py::HostBatcher,
audiogan_tpu/train/loop.py:146-175), and the port's checks of the mesh
before any device is touched.

The batcher must give the reference's indices, labels and clip bytes for
every step, gathered or as indices; ``loop.train`` with
data.device_corpus off (the host batcher through HostFeed) must write the
same checkpoint bits as with it on (the resident corpus), and a corpus
over DEVICE_CORPUS_MAX_GB must fall back to the host batcher with the
reference's notice. Exact comparisons throughout: the same integers, the
same bytes, the same bits. One intra-op thread, as the CPU resume tests.
"""

import dataclasses

import numpy as np
import pytest
import torch

from audiogan_tpu.data.corpus import Corpus as JCorpus
from audiogan_tpu.data.corpus import HostBatcher as JHostBatcher
from audiogan_tpu.data.corpus import build_corpus as jbuild_corpus
from audiogan_tpu.data.synthetic import make_synthetic_sc09 as jsynth
from audiogan_tpu_torch.config import Config, MeshCfg, get_preset
from audiogan_tpu_torch.data.corpus import Corpus, HostBatcher
from audiogan_tpu_torch.parallel.mesh import check_world
from audiogan_tpu_torch.train import loop as tloop
from audiogan_tpu_torch.train.step import build_train_step

from helpers_train import tiny_config

torch.set_num_threads(1)


@pytest.fixture
def corpora(tmp_path):
    jsynth(tmp_path / "w", n_per_class=3, num_classes=4, clip_len=900)
    jbuild_corpus(tmp_path / "w", tmp_path / "c", store_len=1000)
    return JCorpus(tmp_path / "c"), Corpus(tmp_path / "c")


@pytest.mark.parametrize("indices_only", [False, True])
def test_host_batcher_matches_the_reference(corpora, indices_only):
    jc, tc = corpora
    kw = dict(batch_size=5, n_views=3, seed=11, indices_only=indices_only)
    jb, tb = JHostBatcher(jc, **kw), HostBatcher(tc, **kw)
    for step in (0, 1, 7, 123):
        assert np.array_equal(tb._indices(step), jb._indices(step))
        (ja, jl), (ta, tl) = jb.get(step), tb.get(step)
        assert ta.dtype == ja.dtype and ta.shape == ja.shape
        assert ta.tobytes() == ja.tobytes()
        assert tl.dtype == jl.dtype and np.array_equal(tl, jl)
    if not indices_only:
        assert tb.get(0)[0].shape == (3, 5, 1000)


def test_host_batcher_prefetch_replays_the_stream(corpora):
    """The prefetch thread yields (step, batch) for each step in order,
    then None, each batch the same bytes as get(step); close() stops a
    thread blocked on its full queue."""
    _, tc = corpora
    tb = HostBatcher(tc, batch_size=4, n_views=2, seed=3)
    tb.start_prefetch(5, 9)
    for step in range(5, 9):
        s, (clips, labels) = tb.next_prefetched()
        want = tb.get(step)
        assert s == step and clips.tobytes() == want[0].tobytes()
        assert np.array_equal(labels, want[1])
    assert tb.next_prefetched() is None
    tb.start_prefetch(0, 1000)
    tb.close()
    assert tb._thread is None


def _tiny(steps=2, **data):
    cfg = Config.from_json(tiny_config().to_json())
    return cfg.replace(
        data=dataclasses.replace(cfg.data, **data),
        train=dataclasses.replace(cfg.train, total_steps=steps, log_every=1,
                                  ckpt_every=0, sample_every=0,
                                  batch_size=2)).validate()


def _ckpt(workdir, step):
    return torch.load(workdir / "ckpt" / f"{step}.pt", weights_only=True)


def _same_bits(a, b):
    for part in ("g", "d"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    for part in ("opt_g", "opt_d"):
        for sa, sb in zip(a[part]["state"].values(),
                          b[part]["state"].values()):
            for k in sa:
                assert torch.equal(sa[k], sb[k]), (part, k)


def test_loop_trains_to_the_same_bits_on_either_data_path(tmp_path):
    """Two steps of loop.train with data.device_corpus off (the host
    batcher, its prefetch thread and HostFeed) and on (the resident
    corpus): the same metrics and the same checkpoint, to the bit."""
    runs = {}
    for on in (True, False):
        wd = tmp_path / f"dev_{on}"
        _, runs[on] = tloop.train(_tiny(device_corpus=on), wd, device="cpu",
                                  log=lambda _: None, tensorboard=False)
        runs[on] = (runs[on], _ckpt(wd, 2))
    assert runs[True][0] == runs[False][0]
    _same_bits(runs[True][1], runs[False][1])


def test_oversized_corpus_falls_back_to_the_host_batcher(tmp_path,
                                                        monkeypatch,
                                                        capsys):
    """A packed corpus over DEVICE_CORPUS_MAX_GB trains through the host
    batcher with the reference's notice (the presets turn the resident
    corpus on; a corpus's size is the data's), to the same bits."""
    fed = []
    feed = tloop.HostFeed

    class Spy(feed):
        def take(self, step):
            fed.append(step)
            return super().take(step)
    monkeypatch.setattr(tloop, "HostFeed", Spy)
    monkeypatch.setattr(tloop, "DEVICE_CORPUS_MAX_GB", 1e-9)
    tloop.train(_tiny(1, device_corpus=True), tmp_path / "fb",
                device="cpu", log=lambda _: None, tensorboard=False)
    assert "falling back to the host batcher" in capsys.readouterr().out
    assert fed == [0]
    monkeypatch.setattr(tloop, "DEVICE_CORPUS_MAX_GB", 8.0)
    tloop.train(_tiny(1, device_corpus=True), tmp_path / "res",
                device="cpu", log=lambda _: None, tensorboard=False)
    assert fed == [0]
    _same_bits(_ckpt(tmp_path / "fb", 1), _ckpt(tmp_path / "res", 1))


MESHES = [MeshCfg(dp=2), MeshCfg(cp=2), MeshCfg(tp=2),
          MeshCfg(fsdp=True)]
# in one process: dp=2, cp=2 or tp=2 asks for two processes (the
# reference's "mesh needs N devices"); fsdp at dp=1 runs


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_a_mesh_the_port_does_not_run_raises(tmp_path, mesh):
    """build_train_step and loop.train raise ValueError for dp=2, cp=2 or
    tp=2 in one process, the loop before it writes anything; fsdp at
    dp=1 builds a step."""
    cfg = _tiny().replace(mesh=mesh).validate()
    if mesh.fsdp:
        build_train_step(cfg, device="cpu")
        return
    with pytest.raises(ValueError, match="mesh needs 2 devices"):
        build_train_step(cfg, device="cpu")
    with pytest.raises(ValueError, match="mesh needs 2 devices"):
        tloop.train(cfg, tmp_path / "w", device="cpu", tensorboard=False)
    assert not (tmp_path / "w").exists()


@pytest.mark.parametrize("sets", [[], ["mesh.cp=2"], ["mesh.tp=2"],
                                  ["mesh.fsdp=true"],
                                  ["data.device_corpus_shard=shard"]],
                         ids=str)
def test_cli_train_rejects_the_mesh_before_the_card(tmp_path, monkeypatch,
                                                    sets):
    """`cli train --preset music_44k_dp16` (dp=16) in one process raises
    ValueError (the mesh needs 16 processes), at mesh.dp=1 cp=2 or tp=2
    too (it needs 2), before the device is resolved; nothing is
    written. With mesh.dp=1, fsdp and the sharded corpus pass the checks
    and reach the device and the loop with what was set (both stand-ins
    here, so the case does not depend on the machine)."""
    from audiogan_tpu_torch import cli
    calls = []
    monkeypatch.setattr(cli, "resolve_device",
                        lambda device: calls.append("device") or "cpu")
    monkeypatch.setattr(tloop, "train",
                        lambda cfg, *a, **k: calls.append(cfg))
    extra = ["--set", "mesh.dp=1"] if sets else []
    for item in sets:
        extra += ["--set", item]
    argv = ["train", "--preset", "music_44k_dp16", "--total_steps", "1",
            "--workdir", str(tmp_path / "m"), *extra]
    if not sets or any(k in sets[0] for k in ("cp", "tp")):
        with pytest.raises(ValueError, match="mesh needs"):
            cli.main(argv)
        assert calls == []
        assert not (tmp_path / "m").exists()
        return
    assert cli.main(argv) == 0
    assert calls[0] == "device"
    cfg = calls[1]
    assert (cfg.mesh.dp, cfg.mesh.fsdp, cfg.data.device_corpus_shard) == (
        1, sets[0] == "mesh.fsdp=true",
        "shard" if "shard" in sets[0] else get_preset(
            "music_44k_dp16").data.device_corpus_shard)


def test_music_preset_keeps_the_reference_mesh_and_trains_at_dp1():
    """The preset's JSON keeps dp=16; with mesh.dp=1 it builds a step."""
    from audiogan_tpu_torch.cli import apply_overrides
    cfg = get_preset("music_44k_dp16")
    assert cfg.mesh.dp == 16
    one = apply_overrides(cfg, ["mesh.dp=1"]).validate()
    check_world(one)
    build_train_step(one, device="cpu")
