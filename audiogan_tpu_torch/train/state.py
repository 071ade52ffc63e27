"""TrainState: what a training step mutates, the port of
audiogan_tpu/train/state.py.

The generator and the critic hold f32 parameters (compute runs in
cfg.train.dtype inside the models); each has an ``Adam`` with the WGAN-GP
settings (lr 1e-4, betas (0.5, 0.9), eps 1e-8 outside the square root,
bias-corrected: the formula of optax.adam). The step updates the modules
and optimizers in place and advances ``step``.

``Adam`` is the port's own: torch.optim.Adam's foreach update, op for op
(lerp, multiply, addcmul; square root, divide, add; addcdiv, the last
four from device scalars in one kernel on the card, kernels/adam.py), so
it gives torch.optim.Adam's bits on the card and on the CPU. Each op is
elementwise, and its result for an element does not depend on where the
element lies in the tensor (a CPU and a card test hold a block of rows
updated alone equal to the same rows of the whole), so ZeRO-1
(``mesh.fsdp``: each rank keeps the moments of its block of rows of each
shardable parameter, parallel/mesh.py::zero1_update) equals the
replicated update to the bit: one implementation runs both, never
torch's foreach path beside its single-tensor one. Its state dict has
``torch.optim.Adam``'s form (``step`` a CPU tensor, ``exp_avg``,
``exp_avg_sq``); ``full_state_dict`` gathers a ZeRO-1 optimizer's
moments, and ``load_state_dict`` takes whole moments (or this rank's
block) on any topology.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.device import resolve_device
from audiogan_tpu_torch.kernels.adam import adam_update
from audiogan_tpu_torch.models import build_discriminator, build_generator
from audiogan_tpu_torch.models.gru import GRUGenerator
from audiogan_tpu_torch.models.init import init_params
from audiogan_tpu_torch.models.stft_critic import DualDiscriminator
from audiogan_tpu_torch.models.wavegan import (WaveGANDiscriminator,
                                               WaveGANGenerator)
from audiogan_tpu_torch.parallel.mesh import DataMesh, zero1_rows, \
    zero1_update
from audiogan_tpu_torch.utils.prng import role_seed

ADAM_EPS = 1e-8


def adam_scalars(lr: float, b1: float, b2: float,
                 counts: list[float]) -> list[list[float]]:
    """[step sizes, bias corrections] at these counts, in double, as
    torch.optim.Adam's foreach update computes them."""
    return [[(lr / (1 - b1 ** t)) * -1 for t in counts],
            [(1 - b2 ** t) ** 0.5 for t in counts]]


class Adam(torch.optim.Optimizer):
    """optax.adam (b1, b2, eps outside the square root, both moments
    bias-corrected), ZeRO-1 over ``zero1`` when given (the module
    docstring).

    Each update's step size and bias correction come from the CPU counts,
    in double as torch.optim.Adam computes them, and reach the device as
    a [2, n] f32 row of the group's ``slots`` buffer, which the update's
    last four ops read there (kernels/adam.py): a captured step reads its
    scalars from these fixed buffers instead of freezing numbers into
    its kernels. ``stage(k)`` before a step writes the rows of its next k
    updates (counts + 1 ... counts + k); the step's updates then take rows
    0 ... k - 1 in turn, each checking that the row was staged for the
    count it has reached. An update with no staged row left writes row 0
    itself (eagerly; under a capture it raises)."""

    def __init__(self, params, lr: float, betas: tuple[float, float],
                 eps: float = ADAM_EPS, zero1: DataMesh | None = None):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps))
        self.zero1 = zero1
        self.slots: dict[int, torch.Tensor] = {}
        self._staged: list = []     # per staged row: each group's counts
        self._cursor = 0

    def __getstate__(self):
        # the base class keeps only its own fields: a copy (copy.deepcopy,
        # train/step_graph.py) keeps the mesh and the slots too
        return {**super().__getstate__(), "zero1": self.zero1,
                "slots": self.slots, "_staged": self._staged,
                "_cursor": self._cursor}

    def _counts(self, group: dict) -> list[float]:
        return [float(self.state[p]["step"]) if self.state.get(p) else 0.0
                for p in group["params"]]

    def _scalars(self, group: dict, counts: list[float]) -> list:
        return adam_scalars(group["lr"], *group["betas"], counts)

    def _write(self, gi: int, rows: list) -> None:
        """Rows [i][2][n] into slots[gi][0:len(rows)], on the current
        stream; from pinned memory on the card (the host allocator keeps
        the buffer until the copy has run)."""
        group = self.param_groups[gi]
        dev = group["params"][0].device
        buf = self.slots.get(gi)
        if buf is None or buf.shape[0] < len(rows):
            if torch.cuda.is_available() and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError("Adam: a captured step needs its "
                                   "scalars' slots made before the capture")
            buf = self.slots[gi] = torch.zeros(
                (max(len(rows), 1), 2, len(group["params"])),
                dtype=torch.float32, device=dev)
        host = torch.tensor(rows, dtype=torch.float32)
        if dev.type == "cuda":
            host = host.pin_memory()
        buf[:len(rows)].copy_(host, non_blocking=True)

    def stage(self, updates: int) -> None:
        """Before a step that calls ``step`` ``updates`` times: the scalars
        of those updates into rows 0 ... updates - 1 of ``slots``."""
        self._staged, self._cursor = [], 0
        per_group = []
        for gi, group in enumerate(self.param_groups):
            base = self._counts(group)
            counts = [[c + k + 1 for c in base] for k in range(updates)]
            self._write(gi, [self._scalars(group, c) for c in counts])
            per_group.append(counts)
        self._staged = [[g[k] for g in per_group] for k in range(updates)]

    def release(self) -> None:
        """Marks the staged rows used: a replayed step used them without
        running ``step``."""
        self._cursor = len(self._staged)

    @torch.no_grad()
    def step(self, closure=None):
        staged = (self._staged[self._cursor]
                  if self._cursor < len(self._staged) else None)
        for gi, group in enumerate(self.param_groups):
            params = [p for p in group["params"] if p.grad is not None]
            zero1_update(
                lambda views: self._update(gi, group, params, views,
                                           None if staged is None
                                           else staged[gi]),
                params, self.zero1)
        self._cursor += 1

    def _update(self, gi: int, group: dict, params: list, views: list,
                staged: list | None) -> None:
        if not params:
            return
        b1, b2 = group["betas"]
        grads, mu, nu, counts = [], [], [], []
        for p, v in zip(params, views):
            st = self.state[p]
            if not st:
                st["step"] = torch.tensor(0.0)
                st["exp_avg"] = torch.zeros_like(v)
                st["exp_avg_sq"] = torch.zeros_like(v)
            rows = zero1_rows(p, self.zero1)
            grads.append(p.grad if rows == slice(None) else p.grad[rows])
            counts.append(st["step"])
            mu.append(st["exp_avg"])
            nu.append(st["exp_avg_sq"])
        torch._foreach_add_(counts, 1)
        torch._foreach_lerp_(mu, grads, 1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, 1 - b2)
        index = {p: i for i, p in enumerate(group["params"])}
        cols = [index[p] for p in params]
        if staged is None:
            if torch.cuda.is_available() and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError("Adam: a captured update needs its "
                                   "scalars staged first (Adam.stage)")
            self._write(gi, [self._scalars(group, self._counts(group))])
        elif any(staged[c] != float(self.state[p]["step"])
                 for c, p in zip(cols, params)):
            raise RuntimeError("Adam: the staged scalars are for other "
                               "counts than this update's")
        row = 0 if staged is None else self._cursor
        adam_update(views, mu, nu, self.slots[gi][row], cols,
                    group["eps"])

    def full_state_dict(self) -> dict:
        """state_dict() with whole moments: a ZeRO-1 optimizer gathers its
        blocks (a collective: every rank calls it)."""
        sd = self.state_dict()
        mesh = self.zero1
        if mesh is None or not mesh.parallel:
            return sd
        # state_dict() holds the live per-parameter dicts
        sd["state"] = {i: dict(st) for i, st in sd["state"].items()}
        whole = []
        for i, p in enumerate(self._params()):
            st = sd["state"].get(i)
            if st is None or zero1_rows(p, mesh) == slice(None):
                continue
            for key in ("exp_avg", "exp_avg_sq"):
                full = torch.zeros_like(p)
                full[zero1_rows(p, mesh)] = st[key]
                st[key] = full
                whole.append(full)
        mesh.gather_rows(whole)
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        """Takes whole moments (a checkpoint) or this rank's block, as
        copies: the base class keeps the caller's tensors, which the
        update would then change in place. A moment or count this
        optimizer holds already is written in place (a captured step
        keeps its addresses)."""
        held = {p: dict(st) for p, st in self.state.items() if st}
        super().load_state_dict(state_dict)
        for p in self._params():
            st, rows = self.state.get(p), zero1_rows(p, self.zero1)
            if not st:
                continue
            for key, v in st.items():
                whole = key != "step" and v.shape == p.shape
                v = v[rows] if whole else v
                old = held.get(p, {}).get(key)
                if old is not None and old.shape == v.shape:
                    st[key] = old.copy_(v)
                else:
                    st[key] = v.clone()

    def _params(self) -> list:
        return [p for g in self.param_groups for p in g["params"]]


@dataclass
class TrainState:
    step: int
    g: WaveGANGenerator | GRUGenerator
    d: WaveGANDiscriminator | DualDiscriminator
    opt_g: Adam
    opt_d: Adam
    seed: int


def make_optimizers(cfg: Config, g: torch.nn.Module, d: torch.nn.Module,
                    mesh: DataMesh | None = None) -> tuple[Adam, Adam]:
    """Both nets' Adams; ZeRO-1 over ``mesh`` when cfg.mesh.fsdp."""
    t = cfg.train
    betas = (t.beta1, t.beta2)
    zero1 = mesh if cfg.mesh.fsdp else None
    return (Adam(g.parameters(), lr=t.lr_g, betas=betas, zero1=zero1),
            Adam(d.parameters(), lr=t.lr_d, betas=betas, zero1=zero1))


def create_train_state(cfg: Config, seed: int | None = None,
                       device=None, mesh: DataMesh | None = None
                       ) -> TrainState:
    """Both nets (seeded flax-style init) and both optimizers on
    ``device`` (the card unless the caller asks for another); every rank
    of ``mesh`` builds the same weights from the seed."""
    dev = resolve_device(device)
    seed = cfg.train.seed if seed is None else seed
    g = init_params(build_generator(cfg, device=dev), seed)
    d = init_params(build_discriminator(cfg, device=dev),
                    role_seed(seed, 0, "init/critic"))
    opt_g, opt_d = make_optimizers(cfg, g, d, mesh)
    return TrainState(step=0, g=g, d=d, opt_g=opt_g, opt_d=opt_d, seed=seed)


def param_count(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def state_tensors(state: TrainState) -> dict:
    """What a step changes, by name: both nets' parameters and both
    Adams' moments (this rank's blocks under ZeRO-1), live tensors."""
    out = {}
    for net, opt in (("g", state.opt_g), ("d", state.opt_d)):
        module = state.g if net == "g" else state.d
        for name, p in module.named_parameters():
            out[f"{net}/{name}"] = p
            for key, v in opt.state.get(p, {}).items():
                if key != "step":
                    out[f"opt_{net}/{name}/{key}"] = v
    return out


def snapshot(state: TrainState) -> dict:
    """A copy of what a step changes: ``step``, both nets' parameters and
    each Adam's per-parameter state (moments and its CPU count), for
    ``restore``."""
    return {"step": state.step,
            "params": [p.detach().clone() for p in _all_params(state)],
            "opt": [{p: {k: v.clone() for k, v in opt.state[p].items()}
                     for p in opt._params() if opt.state.get(p)}
                    for opt in (state.opt_g, state.opt_d)]}


@torch.no_grad()
def restore(state: TrainState, snap: dict, drop_new: bool = True) -> None:
    """Puts ``snapshot``'s values back into the same tensors (a captured
    graph keeps its addresses). An Adam that had no state for a parameter
    loses the one the step made, or with ``drop_new`` False keeps it as
    it is (a graph that made it makes it again when replayed)."""
    state.step = snap["step"]
    for p, v in zip(_all_params(state), snap["params"]):
        p.copy_(v)
    for opt, saved in zip((state.opt_g, state.opt_d), snap["opt"]):
        for p in opt._params():
            if p not in saved:
                if drop_new:
                    opt.state.pop(p, None)
                continue
            st = opt.state[p]
            for k, v in saved[p].items():
                if k in st:
                    st[k].copy_(v)
                else:
                    st[k] = v.clone()


def _all_params(state: TrainState) -> list:
    return [*state.g.parameters(), *state.d.parameters()]
