"""Parameter shapes and the seeded initialisation, in the JAX layouts.

A definition tree is a nested dict of ``ParamDef``s (lists for the
per-layer stack).  ``init_params`` draws each leaf from its own seeded
``torch.Generator`` on the target device, with the JAX init's scales
(``repro/models/param.py``): truncated normal on [-2, 2] times
1/sqrt(fan_in), norms set to ones.  The draws differ from JAX's (another
generator); tests that compare the packages convert the JAX pytree instead
(``models.convert``).
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Callable

import torch

INIT_NORMAL = "normal"       # truncated-normal, 1/sqrt(fan_in)
INIT_ONES = "ones"

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    init: str = INIT_NORMAL
    dtype: str = "bfloat16"
    fan_in_axes: tuple[int, ...] = ()      # () => axis 0

    @property
    def fan_in(self) -> int:
        axes = self.fan_in_axes or (0,)
        return int(math.prod(self.shape[i] for i in axes))


def map_defs(fn: Callable, tree, path: tuple[str, ...] = ()):
    """Apply ``fn(path, leaf)`` over a tree of dicts and lists."""
    if isinstance(tree, ParamDef):
        return fn(path, tree)
    if isinstance(tree, list):
        return [map_defs(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return {k: map_defs(fn, v, path + (k,)) for k, v in tree.items()}


def count_params(tree) -> int:
    total = 0

    def leaf(_path, d: ParamDef):
        nonlocal total
        total += math.prod(d.shape)

    map_defs(leaf, tree)
    return total


def _materialize(d: ParamDef, gen: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    dt = DTYPES[d.dtype]
    if d.init == INIT_ONES:
        return torch.ones(d.shape, dtype=dt, device=device)
    if d.init != INIT_NORMAL:
        raise ValueError(d.init)
    w = torch.empty(d.shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    w.mul_(1.0 / math.sqrt(max(d.fan_in, 1)))
    return w.to(dt)


def init_params(tree, seed: int, device: torch.device) -> dict:
    """Materialise every leaf on ``device``; each leaf's generator is seeded
    from (seed, crc32 of its path), so a leaf does not depend on the order
    or number of the others."""
    def leaf(path, d: ParamDef):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed * 1_000_003 + zlib.crc32("/".join(path).encode()))
        return _materialize(d, gen, device)
    return map_defs(leaf, tree)
