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
"""

from __future__ import annotations

import numpy as np
import torch


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
