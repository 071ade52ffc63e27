"""Carry weights and optimizer state from the JAX package into the port.

``params_from_jax`` takes flax generator or critic params flattened to
``{"project/kernel": array, ..., "convt_0_kernel": array, ...}`` (the
WaveGAN G), ``{"init_state/kernel": array, "cond_proj/kernel": array,
"gru_w_i": array, "gru_w_h": array, "gru_b_i": array, "ar_proj": array,
"frame_out": array, ..., "up_0_kernel": array, ...}`` (the GRU G, whose
recurrent weights are stored pre-transposed, [in, 3H] and [H, 3H] in
(r, z, n) gate order, as the port keeps them) or ``{"conv_0_kernel":
array, ..., "head/kernel": array}`` (the critic), with or without a
leading ``params/``, and returns the port's state dict. The two
packages share layouts ([K, C_in, C_out] conv kernels, [in, out] dense
kernels), so the values pass through unchanged and only the names move
from ``/`` to ``.``. The port never reads an orbax checkpoint: the caller
flattens the tree, e.g. with ``flax.traverse_util.flatten_dict(params,
sep="/")``.

``load_adam_state`` carries an optax ``adam`` state (its ``count``, ``mu``
and ``nu``, each flattened the same way) into a ``torch.optim.Adam`` over
a module's parameters, so a step from a non-initial state can be compared.

``train_state_from_jax`` carries a whole JAX ``TrainState`` (both nets,
both Adam states, the step) into a port ``TrainState`` that
``utils/checkpoint.py::save`` can write, so a run trained by the JAX
package can be sampled and resumed by the port. The JAX state keeps a PRNG
key where the port keeps a seed, so the caller names the seed.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.train.state import TrainState, create_train_state


def params_from_jax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    out = {}
    for name, value in flat.items():
        if name.startswith("params/"):
            name = name[len("params/"):]
        arr = np.asarray(value, dtype=np.float32)
        out[name.replace("/", ".")] = torch.from_numpy(arr.copy())
    return out


def load_adam_state(opt: torch.optim.Optimizer, module: torch.nn.Module,
                    count: int, mu: dict[str, np.ndarray],
                    nu: dict[str, np.ndarray]) -> None:
    """Sets exp_avg = mu, exp_avg_sq = nu and step = count for every
    parameter of ``module`` (names as in params_from_jax)."""
    mu_t, nu_t = params_from_jax(mu), params_from_jax(nu)
    for name, p in module.named_parameters():
        st = opt.state[p]
        st["step"] = torch.tensor(float(count))
        st["exp_avg"] = mu_t[name].to(p.device).clone()
        st["exp_avg_sq"] = nu_t[name].to(p.device).clone()


def train_state_from_jax(cfg: Config, params_g: dict[str, np.ndarray],
                         params_d: dict[str, np.ndarray],
                         opt_g: Mapping, opt_d: Mapping, step: int, seed: int,
                         device=None) -> TrainState:
    """A port TrainState on ``device`` (the card unless named) holding the
    JAX state's leaves: flat params as params_from_jax takes them, each
    optimizer as {"count", "mu", "nu"} of its optax adam state (mu and nu
    flattened the same way), the step and the seed to draw from."""
    st = create_train_state(cfg, seed=seed, device=device)
    for mod, opt, params, adam in ((st.g, st.opt_g, params_g, opt_g),
                                   (st.d, st.opt_d, params_d, opt_d)):
        mod.load_state_dict(params_from_jax(params))
        load_adam_state(opt, mod, int(adam["count"]), adam["mu"],
                        adam["nu"])
    st.step = int(step)
    return st
