"""JAX parameter pytree (as numpy) -> the port's parameter dicts.

The JAX model stacks the layers of each ``cfg.layer_groups()`` group into
``group{gi}/sub{i}`` leaves with a leading ``reps`` axis (scan over
layers); the port keeps one dict per layer in ``params["layers"]``.
Repetition r of group gi runs its sub-layers in order, so layer order is
group by group, repetition by repetition, sub-layer by sub-layer.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import check_config


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: reinterpret bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def from_jax_params(cfg: ModelConfig, tree: dict,
                    device: Optional[str | torch.device] = "cpu") -> dict:
    """``tree``: ``repro.models.model.init`` output with numpy leaves."""
    check_config(cfg)
    dev = resolve_device(device)
    layers = []
    for gi, (pattern, reps) in enumerate(cfg.layer_groups()):
        group = tree[f"group{gi}"]
        for r in range(reps):
            for i in range(len(pattern)):
                layers.append(_map(group[f"sub{i}"],
                                   lambda a, r=r: _tensor(np.asarray(a)[r],
                                                          dev)))
    return {"embed": _tensor(tree["embed"], dev),
            "head": _tensor(tree["head"], dev),
            "layers": layers,
            "final_norm": _tensor(tree["final_norm"], dev)}
