"""Carry generator weights from the JAX package into the port.

``params_from_jax`` takes the flax generator params flattened to
``{"project/kernel": array, ..., "convt_0_kernel": array, ...}`` (with or
without a leading ``params/``) and returns the port's state dict. The two
packages share layouts ([K, C_in, C_out] conv kernels, [in, out] dense
kernels), so the values pass through unchanged and only the names move
from ``/`` to ``.``. The port never reads an orbax checkpoint: the caller
flattens the tree, e.g. with ``flax.traverse_util.flatten_dict(params,
sep="/")``.
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
