"""TrainState: what a training step mutates, the port of
audiogan_tpu/train/state.py.

The generator and the critic hold f32 parameters (compute runs in
cfg.train.dtype inside the models); each has an ``Adam`` with the WGAN-GP
settings (lr 1e-4, betas (0.5, 0.9), eps 1e-8 outside the square root,
bias-corrected: the formula of optax.adam). The step updates the modules
and optimizers in place and advances ``step``.

``Adam`` is the port's own: torch.optim.Adam's foreach update, op for op
(lerp, multiply, addcmul; square root, divide, add; addcdiv), so it gives
torch.optim.Adam's bits on the card and on the CPU. Each op is
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


class Adam(torch.optim.Optimizer):
    """optax.adam (b1, b2, eps outside the square root, both moments
    bias-corrected), ZeRO-1 over ``zero1`` when given (the module
    docstring)."""

    def __init__(self, params, lr: float, betas: tuple[float, float],
                 eps: float = ADAM_EPS, zero1: DataMesh | None = None):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps))
        self.zero1 = zero1

    def __getstate__(self):
        # the base class keeps only its own fields: a copy (copy.deepcopy,
        # train/step_graph.py) keeps the mesh too
        return {**super().__getstate__(), "zero1": self.zero1}

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            zero1_update(lambda views: self._update(group, params, views),
                         params, self.zero1)

    def _update(self, group: dict, params: list, views: list) -> None:
        if not params:
            return
        lr, (b1, b2), eps = group["lr"], group["betas"], group["eps"]
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
        steps = [float(t) for t in counts]
        torch._foreach_lerp_(mu, grads, 1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, 1 - b2)
        step_size = [(lr / (1 - b1 ** t)) * -1 for t in steps]
        den = torch._foreach_sqrt(nu)
        torch._foreach_div_(den, [(1 - b2 ** t) ** 0.5 for t in steps])
        torch._foreach_add_(den, eps)
        torch._foreach_addcdiv_(views, mu, den, step_size)

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
        update would then change in place."""
        super().load_state_dict(state_dict)
        for p in self._params():
            st, rows = self.state.get(p), zero1_rows(p, self.zero1)
            if not st:
                continue
            for key, v in st.items():
                whole = key != "step" and v.shape == p.shape
                st[key] = (v[rows] if whole else v).clone()

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
