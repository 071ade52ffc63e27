"""The loop's replayed step (train/step_graph.py::StepGraph) on the CPU.

On the card the loop runs its first step eagerly, captures the next as
one CUDA graph and replays it for every step after; the graph bakes in
everything that is not a device buffer. Here, at tests/helpers_train.py's
tiny sizes and one intra-op thread:

* nothing step-dependent is baked in: the aten ops of a step's body (the
  step on its fixed buffers, its input fill left out), with their shapes,
  dtypes and every non-tensor argument, are the same at steps s and
  s + 1, across a data.index_chunk boundary and after a resume, for the
  plain step on every data path (resident corpus with index_chunk 4,
  host batcher, sharded corpus), the fused shuffle sites, the GRU, the
  dual critic, and the cp and tp steps and the sharded corpus at dp=2
  over two gloo ranks;
* the bits are kept: the loop, its Adam's scalars staged on the device
  and its draws in fixed buffers, equals the parent's form of the step
  (Adam's scalars as host lists, the step drawing for itself) over 6
  steps with a resume at 3; the fill-and-body step equals the plain call
  with the same draws;
* the sharded corpus's fixed-size exchange is byte-equal to the planned
  one at dp=2, one index set with every index on one rank;
* the routes: the CPU and a gloo group on CUDA run eagerly and say so in
  the run's ``init`` record;
* Adam's staged scalars give the bits of its own per-update scalars, a
  row staged for other counts raises, and a restore writes its moments
  in place.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from audiogan_tpu_torch.cli import apply_overrides
from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.tools import dp_check
from audiogan_tpu_torch.tools.step_checks import same_checkpoint
from audiogan_tpu_torch.train import loop
from audiogan_tpu_torch.train import state as tstate
from audiogan_tpu_torch.train.state import create_train_state
from audiogan_tpu_torch.train.step import build_train_step, step_draws
from audiogan_tpu_torch.train.step_graph import StepGraph
from audiogan_tpu_torch.utils import checkpoint as ckpt_lib

from helpers_replay import exchange_job, record_job, recorded_train
from helpers_train import raw_batch, tiny_config

torch.set_num_threads(1)

STOP, STEPS = 3, 6       # a checkpoint at 3, resumed to 6


def _cfg(*sets) -> Config:
    base = Config.from_json(tiny_config().to_json())
    return apply_overrides(base, [
        "data.device_corpus=true", "data.index_chunk=4",
        f"train.total_steps={STEPS}", "train.log_every=1",
        "train.ckpt_every=0", "train.sample_every=0", *sets]).validate()


def _gru(cfg: Config) -> Config:
    return cfg.replace(
        data=dataclasses.replace(cfg.data, num_classes=10),
        model=dataclasses.replace(cfg.model, generator="gru",
                                  gru_frame_size=64, gru_hidden=16),
        train=dataclasses.replace(cfg.train, fused_d_views=True))


def _dual(cfg: Config) -> Config:
    return cfg.replace(
        model=dataclasses.replace(cfg.model, use_stft_critic=True,
                                  stft_resolutions=((128, 32, 128),)),
        loss=dataclasses.replace(cfg.loss, stft_loss_weight=1.0))


CASES = {
    "flagship": lambda: _cfg(),
    "fused_sites": lambda: _cfg("model.fused_shuffle_sites=-1",
                                "train.fused_d_views=true"),
    "gru": lambda: _gru(_cfg()),
    "dual_stft": lambda: _dual(_cfg()),
    "host_batcher": lambda: _cfg("data.device_corpus=false"),
    "sharded": lambda: _cfg("data.device_corpus_shard=shard"),
}


def _same_after_first(records: dict) -> None:
    """Every record from step 1 on equals step 1's (step 0 makes Adam's
    moments)."""
    assert sorted(records) == list(range(STEPS))
    first = records[1]
    assert first, "an empty record"
    for s in range(2, STEPS):
        assert records[s] == first, f"step {s}'s body differs from step 1's"


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_body_is_the_same_every_step(case, tmp_path):
    """Steps 1 ... 5 of one process, the run stopped after step 3 and
    resumed (index_chunk 4: steps 3 -> 4 cross a block), dispatch the
    same ops with the same arguments."""
    cfg = CASES[case]()
    dev = torch.device("cpu")
    records = recorded_train(cfg, tmp_path, STOP, dev)
    records.update(recorded_train(cfg, tmp_path, STEPS, dev))
    _same_after_first(records)


@pytest.mark.parametrize("sets", [
    ("mesh.dp=2", "data.device_corpus_shard=shard"),
    ("mesh.cp=2",), ("mesh.tp=2",)], ids=["sharded_dp2", "cp2", "tp2"])
def test_step_body_is_the_same_every_step_on_two_ranks(sets, tmp_path):
    """The same on two gloo ranks: the sharded corpus's fixed exchange at
    dp=2, the cp step at cp=2 and the tp step at tp=2, on every rank."""
    cfg = _cfg(*sets)
    out = dp_check.spawn(2, [{"name": "rec", "fn": record_job, "kw": {
        "cfg_json": cfg.to_json(), "workdir": str(tmp_path / "w"),
        "stop": STOP, "steps": STEPS}}], tmp_path / "out")
    for rank in out["rec"]:
        _same_after_first(rank["records"])


def _parent_update(self, gi, group, params, views, staged):
    """train/state.py::Adam._update as it was before the scalars moved to
    the device: the step sizes and bias corrections as host lists."""
    lr, (b1, b2), eps = group["lr"], group["betas"], group["eps"]
    grads, mu, nu, counts = [], [], [], []
    for p, v in zip(params, views):
        st = self.state[p]
        if not st:
            st["step"] = torch.tensor(0.0)
            st["exp_avg"] = torch.zeros_like(v)
            st["exp_avg_sq"] = torch.zeros_like(v)
        rows = tstate.zero1_rows(p, self.zero1)
        grads.append(p.grad if rows == slice(None) else p.grad[rows])
        counts.append(st["step"])
        mu.append(st["exp_avg"])
        nu.append(st["exp_avg_sq"])
    torch._foreach_add_(counts, 1)
    steps = [float(t) for t in counts]
    torch._foreach_lerp_(mu, grads, 1 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, 1 - b2)
    step_size = [(lr / (1 - b1 ** t)) * -1 for t in steps]
    den = torch._foreach_sqrt(nu)
    torch._foreach_div_(den, [(1 - b2 ** t) ** 0.5 for t in steps])
    torch._foreach_add_(den, eps)
    torch._foreach_addcdiv_(views, mu, den, step_size)


def _parent_run(cfg: Config, workdir, monkeypatch) -> dict:
    """The parent's loop on the resident corpus: each step called with
    its host indices and no draws (the step draws for itself), Adam's
    scalars as host lists; the state after STEPS steps, as a
    checkpoint blob."""
    from audiogan_tpu_torch.data.corpus import HostBatcher
    from audiogan_tpu_torch.train.step import num_views, wrap_device_corpus
    monkeypatch.setattr(tstate.Adam, "_update", _parent_update)
    corpus = loop.resolve_corpus(cfg, workdir)
    state = create_train_state(cfg, device="cpu")
    step_fn = wrap_device_corpus(build_train_step(cfg, "cpu"))
    batcher = HostBatcher(corpus, cfg.train.batch_size, num_views(cfg),
                          seed=cfg.train.seed, indices_only=True)
    clips = torch.from_numpy(np.array(corpus.clips))
    for s in range(STEPS):
        idx, labels = batcher.get(s)
        step_fn(state, clips, torch.from_numpy(idx),
                torch.from_numpy(labels))
    batcher.close()
    mngr = ckpt_lib.make_manager(workdir / "parent", config=cfg)
    ckpt_lib.save(mngr, state)
    return mngr.path(STEPS)


@pytest.mark.parametrize("case", ["flagship", "gru", "dual_stft"])
def test_staged_step_keeps_the_parents_bits(case, tmp_path, monkeypatch):
    """The loop (the step's draws in fixed buffers, Adam's scalars staged
    into its slots), stopped after step 3 and resumed to 6, ends in the
    checkpoint of the parent's form of the same 6 steps, to the bit."""
    cfg = CASES[case]()
    kw = dict(device="cpu", tensorboard=False, log=lambda _: None)
    loop.train(cfg, tmp_path, STOP, **kw)
    loop.train(cfg, tmp_path, STEPS, **kw)
    ours = ckpt_lib.make_manager(tmp_path).path(STEPS)
    assert same_checkpoint(ours, _parent_run(cfg, tmp_path,
                                             monkeypatch)) > 0


def test_fill_and_body_equal_the_plain_call(tmp_path):
    """StepGraph's eager step (its inputs and draws copied into fixed
    buffers, Adam staged) equals step_fn called with the same inputs and
    draws, two steps, to the bit."""
    cfg = _cfg()
    clips, labels = (torch.from_numpy(a) for a in raw_batch(tiny_config()))
    a, b = (create_train_state(cfg, device="cpu") for _ in range(2))
    fn = build_train_step(cfg, "cpu")
    runner = StepGraph(cfg, fn, "cpu")
    for _ in range(2):
        runner.fill(a, (clips, labels))
        got = runner.eager(a)
        want = fn(b, clips, labels, draws=step_draws(cfg, b.seed, b.step,
                                                     "cpu"))
        assert {k: float(v) for k, v in got.items()} == \
            {k: float(v) for k, v in want.items()}
    assert a.step == b.step == 2
    for pa, pb in zip([*a.g.parameters(), *a.d.parameters()],
                      [*b.g.parameters(), *b.d.parameters()]):
        assert torch.equal(pa, pb)


def test_fill_refuses_another_form(tmp_path):
    """A fixed buffer takes only its own shape and dtype, a resident input
    only its own tensor, and a non-tensor input only its value."""
    cfg = _cfg()
    clips, labels = (torch.from_numpy(a) for a in raw_batch(tiny_config()))
    state = create_train_state(cfg, device="cpu")
    runner = StepGraph(cfg, lambda *a, **k: None, "cpu", resident=(0,))
    runner.fill(state, (clips, labels, 3))
    with pytest.raises(ValueError, match="input 1"):
        runner.fill(state, (clips, labels[:, :2], 3))
    with pytest.raises(ValueError, match="resident"):
        runner.fill(state, (clips.clone(), labels, 3))
    with pytest.raises(ValueError, match="input 2"):
        runner.fill(state, (clips, labels, 4))


def test_fixed_exchange_is_byte_equal_to_the_planned_one(tmp_path):
    """At dp=2 the fixed-size exchange (dp V b rows per rank, even splits)
    gives each rank the planned exchange's clips to the byte, for random
    index sets and one whose every index lies on rank 1's shard."""
    rng = np.random.default_rng(0)
    clips = rng.integers(-32768, 32767, (21, 40), dtype=np.int16)
    v, batch = 3, 4
    sets = [rng.integers(0, 21, (v, batch)) for _ in range(3)]
    sets.append(rng.integers(11, 21, (v, batch)))     # rank 1's rows alone
    out = dp_check.spawn(2, [{"name": "x", "fn": exchange_job, "kw": {
        "clips": clips, "idx_sets": sets}}], tmp_path)
    for rank, res in enumerate(out["x"]):
        rows = slice(rank * batch // 2, (rank + 1) * batch // 2)
        for idx, got in zip(sets, res["sets"]):
            want = torch.from_numpy(clips[idx[:, rows]])
            assert torch.equal(got["planned"], want)
            assert torch.equal(got["fixed"].view(torch.uint8),
                               got["planned"].view(torch.uint8))
            planned, fixed = got["bytes"]
            assert fixed == 2 * v * (batch // 2) * 40 * 2 >= planned


def test_routes_say_why_they_are_eager(tmp_path, monkeypatch):
    """The CPU run's init record names its eager route; a gloo group on
    CUDA tensors and replay=False are eager, the card alone replays."""
    lines = []
    loop.train(_cfg(), tmp_path, 1, device="cpu", tensorboard=False,
               log=lambda s: lines.append(json.loads(s)))
    init = next(ln["init"] for ln in lines if "init" in ln)
    assert init["steps"] == "eager: the CPU has no CUDA graphs"
    cuda = torch.device("cuda")
    assert loop.step_route(cuda) == "replay"
    assert loop.step_route(cuda, replay=False) == "eager: asked by the " \
                                                  "caller"
    monkeypatch.setattr(loop, "world_size", lambda: 2)
    monkeypatch.setattr(loop.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(loop.dist, "get_backend", lambda *a: "gloo")
    assert loop.step_route(cuda).startswith("eager: a gloo group on CUDA")


def _stepped(staged: bool, updates: int = 3):
    cfg = _cfg()
    state = create_train_state(cfg, device="cpu")
    opt, params = state.opt_d, list(state.d.parameters())
    gen = torch.Generator().manual_seed(0)
    if staged:
        opt.stage(updates)
    for _ in range(updates):
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
    return params, opt


def test_staged_adam_equals_its_own_scalars():
    """Three updates from rows staged before them equal three that each
    write their own row, to the bit; counts advance the same."""
    a, opt_a = _stepped(True)
    b, opt_b = _stepped(False)
    for pa, pb in zip(a, b):
        assert torch.equal(pa, pb)
        assert torch.equal(opt_a.state[pa]["exp_avg"],
                           opt_b.state[pb]["exp_avg"])
    assert {float(st["step"]) for st in opt_a.state.values()} == {3.0}


def test_staged_adam_refuses_rows_of_other_counts():
    cfg = _cfg()
    state = create_train_state(cfg, device="cpu")
    opt = state.opt_d
    for p in state.d.parameters():
        p.grad = torch.zeros_like(p)
    opt.stage(1)
    opt.step()
    opt._cursor = 0       # the row of count 1 again, at count 2
    with pytest.raises(RuntimeError, match="other counts"):
        opt.step()


def test_restore_writes_adam_state_in_place(tmp_path):
    """A checkpoint restored into a state that has Adam's moments keeps
    the same tensors (a captured step holds their addresses)."""
    cfg = _cfg()
    kw = dict(device="cpu", tensorboard=False, log=lambda _: None)
    state, _ = loop.train(cfg, tmp_path, 2, **kw)
    held = {id(v) for opt in (state.opt_g, state.opt_d)
            for st in opt.state.values() for v in st.values()}
    ckpt_lib.restore(ckpt_lib.make_manager(tmp_path), state)
    now = {id(v) for opt in (state.opt_g, state.opt_d)
           for st in opt.state.values() for v in st.values()}
    assert now == held
