"""The meshes that tools/dp_check.py brings onto four cards beside the ones
it ran before: ``Config.validate`` takes cond_gru_sc09 and dual_stft at
(dp, cp) = (1, 4) and (2, 2), and music_44k_dp16 at tp=4, exactly as the
reference's does (audiogan_tpu/config.py:242-292); ``--cp``'s plan
(``cp_plan``: music alone by default, each of ``--presets`` with its
checks, rates and resume); and ``--graph``'s failing-rank case
(``graph_fault_case``) on the CPU, two gloo ranks under torchrun: the
dump's warm-up fails on rank 1, torchrun exits non-zero naming it, every
rank ends non-zero and none outlives it.
"""

import dataclasses

import pytest

from audiogan_tpu.config import get_preset as jget_preset
from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.tools import dp_check

# name -> (preset, mesh fields)
MESHES = {
    "cond_gru_sc09 cp=4": ("cond_gru_sc09", {"dp": 1, "cp": 4}),
    "cond_gru_sc09 dp=2 cp=2": ("cond_gru_sc09", {"dp": 2, "cp": 2}),
    "dual_stft cp=4": ("dual_stft", {"dp": 1, "cp": 4}),
    "dual_stft dp=2 cp=2": ("dual_stft", {"dp": 2, "cp": 2}),
    "music_44k_dp16 tp=4": ("music_44k_dp16", {"dp": 1, "tp": 4}),
}


@pytest.mark.parametrize("case", list(MESHES))
def test_the_four_card_meshes_validate_as_in_the_reference(case):
    preset, mesh = MESHES[case]
    ref = jget_preset(preset)
    ref = dataclasses.replace(ref, mesh=dataclasses.replace(ref.mesh,
                                                            **mesh))
    ref.validate()
    port = Config.from_json(ref.to_json()).validate()
    assert dataclasses.asdict(port.mesh) == dataclasses.asdict(ref.mesh)
    assert port.to_json() == Config.from_json(ref.to_json()).to_json()
    # dp_check names the same config
    sets = [f"mesh.{k}={v}" for k, v in mesh.items()]
    assert dp_check.preset_config(preset, *sets).mesh == port.mesh


def test_cp_plan_runs_music_alone_by_default():
    assert dp_check.cp_plan(None, 4) == {
        "checks": ["music_44k_dp16"],
        "rates": [("music_44k_dp16", 4), ("music_44k_dp16", 2)],
        "resume": [("music_44k_dp16", 4)]}


@pytest.mark.parametrize("presets", [["cond_gru_sc09"], ["dual_stft"],
                                     ["cond_gru_sc09", "dual_stft"]],
                         ids=lambda p: "+".join(p))
def test_cp_plan_gives_each_preset_its_checks_rates_and_resume(presets):
    plan = dp_check.cp_plan(presets, 4)
    assert plan["checks"] == presets
    assert plan["rates"] == [(p, cp) for p in presets for cp in (4, 2)]
    assert plan["resume"] == [(p, 4) for p in presets]


def test_cp_takes_only_its_presets():
    with pytest.raises(ValueError, match="--cp takes"):
        dp_check.cp_plan(["wgan_gp_b64"], 4)
    # the parser takes the cp presets, the plan refuses the others, both
    # before any card is looked for
    with pytest.raises(ValueError, match="--cp takes"):
        dp_check.main(["--cp", "--presets", "wgan_gp_b64"])
    assert dp_check.main(["--cp", "--presets", "dual_stft",
                          "cond_gru_sc09"]) == 1


def test_a_rank_failing_in_the_dumps_warm_up_ends_every_rank(tmp_path):
    rep = dp_check.graph_fault_case(
        "tiny_sc09", 2, 1, 1, 1, tmp_path, "--device", "cpu",
        "--batch_size", "2")
    assert rep["returncode"] not in (0, None)
    assert rep["seconds"] < dp_check.FAULT_RUN_S
    assert 1 in rep["failed_ranks"]
    assert sorted(rep["rank_ends"]) == [0, 1]
    assert rep["alive_after"] == []
    assert "the step failed on rank 1 of 2" in rep["error"][0]
    assert "a fault injected into the dump's first run" in rep["error"][0]
