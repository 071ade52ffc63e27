"""A job for tools/dp_check.py::spawn: the loop with train.dump_hlo on, on
every rank, with the run's initial state, its draws or a fault in one
rank's dump injected. Imports nothing of JAX, so the spawned ranks stay
light."""

import dataclasses

import torch.distributed as dist

from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.tools.dp_check import (inject_dump_fault, load_blob,
                                               train_job)


def dump_job(dev, cfg_json: str, workdir: str, steps: int,
             fail_rank: int | None = None, state: dict | None = None,
             draws: dict | None = None, fail_in_step: bool = False
             ) -> dict:
    """``train_job`` with train.dump_hlo on: its log lines, the rank's
    state and what the dump returned on this rank. ``state``: the run
    starts from it; ``draws``: each step's draws by step (the
    reference's, injected as train/step.py::draw_step's). With
    ``fail_rank``, that rank's record of the step fails after the step
    (every collective done), or with ``fail_in_step`` its step fails
    before its first collective, and the error each rank raised is
    returned."""
    from audiogan_tpu_torch.train import loop, step_graph
    from audiogan_tpu_torch.train import step as tstep
    cfg = Config.from_json(cfg_json)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, dump_hlo=True))
    dumped: list = []
    saved = (loop.dump_step, step_graph._Watch.__exit__,
             loop.create_train_state, tstep.draw_step)

    def dump(*a, **k):
        dumped.append(saved[0](*a, **k))
        return dumped[-1]

    def failing_exit(self, *exc):
        saved[1](self, *exc)
        raise RuntimeError("a fault injected into this rank's dump")

    def create(*a, **k):
        st = saved[2](*a, **k)
        load_blob(st, state)
        return st
    loop.dump_step = dump
    if fail_rank == dist.get_rank() and fail_in_step:
        inject_dump_fault()
    elif fail_rank == dist.get_rank():
        step_graph._Watch.__exit__ = failing_exit
    if state is not None:
        loop.create_train_state = create
    if draws is not None:
        tstep.draw_step = lambda c, seed, step, *a, **k: draws[step]
    try:
        out = train_job(dev, cfg.to_json(), workdir, steps, resume=False)
    except RuntimeError as err:
        return {"error": str(err)}
    finally:
        (loop.dump_step, step_graph._Watch.__exit__,
         loop.create_train_state, tstep.draw_step) = saved
    return {**out, "dump": dumped[0]}
