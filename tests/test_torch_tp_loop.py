"""audiogan_tpu_torch's tensor parallelism through its entry points:
``Config.validate`` rejects the tp meshes the reference rejects
(audiogan_tpu/config.py:250-262); train/loop.py at dp=2 x tp=2 (four
gloo ranks) on the resident corpus, replicated and sharded (the corpus
sharded over the data axis, each replica's clips to both of its tp
ranks), and through the host batcher, the same records and states to
the bit; and `cli train --preset tiny_sc09 --device cpu --set
mesh.tp=2` under torchrun's two gloo ranks, killed after its step-2
checkpoint and run again, against an uninterrupted run: the same step-4
record and checkpoint, to the bit.
"""

import dataclasses

import pytest
import torch

from audiogan_tpu.config import Config as JConfig
from audiogan_tpu.config import MeshCfg
from audiogan_tpu_torch.config import Config

from helpers_train import tiny_config
from test_torch_cp_step import corpus_paths_agree, killed_and_resumed

torch.set_num_threads(1)


def _mesh_case(tp, cp=1, **model):
    base = tiny_config()
    return dataclasses.replace(
        base, model=dataclasses.replace(base.model, **model),
        mesh=MeshCfg(tp=tp, cp=cp))


CASES = {
    "tp2": (_mesh_case(2), None),
    "tp4": (_mesh_case(4), None),
    "tp_with_cp": (_mesh_case(2, cp=2), "tp>1 with cp>1"),
    "stft_critic": (_mesh_case(2, use_stft_critic=True), "wave critic only"),
    "channels": (_mesh_case(3), "divisible by tp=3"),
    "capped_channels": (_mesh_case(8, model_dim=4, max_channels=12),
                        "violated by"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_validate_rejects_what_the_reference_rejects(case):
    cfg, match = CASES[case]
    text = cfg.to_json()
    if match is None:
        JConfig.validate(cfg)
        Config.from_json(text).validate()
        return
    with pytest.raises(ValueError, match=match):
        JConfig.validate(cfg)
    with pytest.raises(ValueError, match=match):
        Config.from_json(text).validate()


def test_cli_train_at_tp2_killed_and_resumed_to_the_bit(tmp_path):
    killed_and_resumed(tmp_path, "tp")


def test_the_loop_trains_tp_on_every_corpus_path(tmp_path):
    def make(data):
        base = tiny_config()
        return dataclasses.replace(
            base, data=dataclasses.replace(base.data, **data),
            train=dataclasses.replace(base.train, batch_size=4, log_every=1),
            mesh=MeshCfg(dp=2, tp=2))
    corpus_paths_agree(tmp_path, make, world=4)


@pytest.mark.parametrize("strides", [(4, 4, 4), (4, 4, 4, 4)], ids=str)
def test_tp_step_runs_the_convs_its_structure_gives(monkeypatch, strides):
    """One tp step (tp=1, one process) calls the K1' and K1 wrappers as
    often as tools/step_checks.py::tp_step_launches says: the row layers'
    bias and activation (``BiasAct``) keep the penalty's double backward
    out of the forward graph below them, as the fused convs do."""
    from audiogan_tpu_torch.kernels import conv as kconv
    from audiogan_tpu_torch.parallel.mesh import DataMesh, TpMesh
    from audiogan_tpu_torch.tools.step_checks import (random_raw,
                                                      tp_step_launches)
    from audiogan_tpu_torch.train.state import create_train_state
    from audiogan_tpu_torch.train.step import num_views
    from audiogan_tpu_torch.train.tp_step import build_tp_train_step
    calls = {"conv1d": 0, "convt1d": 0}
    for family, attr in (("conv1d", "conv1d_ba"),
                         ("convt1d", "conv_transpose1d_ba")):
        def counted(*a, _f=getattr(kconv, attr), _n=family, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(kconv, attr, counted)
    base = tiny_config()
    cfg = Config.from_json(dataclasses.replace(
        base, model=dataclasses.replace(base.model, strides=strides),
        train=dataclasses.replace(base.train, fused_d_views=True)
    ).to_json()).validate()
    state = create_train_state(cfg, device="cpu")
    step = build_tp_train_step(cfg, "cpu", DataMesh(), TpMesh())
    step(state, *random_raw(cfg, num_views(cfg), cfg.train.batch_size, 0))
    want = tp_step_launches(cfg)
    assert calls == {"conv1d": want["conv1d"], "convt1d": want["convt1d"]}
