"""Parameter shapes and the seeded initialisation, in the JAX layouts.

A definition tree is a nested dict of ``ParamDef``s (lists for the
per-layer stack).  ``init_params`` draws each leaf from its own seeded
``torch.Generator`` on the target device, with the JAX init's scales
(``repro/models/param.py``): truncated normal on [-2, 2] times
1/sqrt(fan_in) (0.02 for the MoE router and the mLSTM's input and forget
gates, drawn in f32), norms set to ones, biases to zeros (the mLSTM's
forget bias to ones), and Mamba's ``a_log`` (log 1..N per channel) and
``dt_bias`` (the inverse softplus of a step drawn log-uniform on [1e-3,
1e-1]).  The draws differ from JAX's (another
generator); tests that compare the packages convert the JAX pytree instead
(``models.convert``).  A leaf marked ``per_slice`` (the experts' stacked
weights) draws each index of its first axis from a generator of its own,
so that the f32 scratch of a draw is one expert's, not the whole leaf's
(an Arctic expert leaf is 4.46 G values).
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Callable, Optional

import torch

INIT_NORMAL = "normal"       # truncated-normal, 1/sqrt(fan_in)
INIT_ONES = "ones"
INIT_ZEROS = "zeros"
INIT_SMALL = "small"         # fixed 0.02 std (MoE router, mLSTM gates)
INIT_A_LOG = "a_log"         # mamba: A = -exp(A_log)
INIT_DT_BIAS = "dt_bias"     # mamba: softplus^-1 of the initial step

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    init: str = INIT_NORMAL
    dtype: str = "bfloat16"
    fan_in_axes: tuple[int, ...] = ()      # () => axis 0
    per_slice: bool = False                # draw axis 0's slices apart

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
    if d.init == INIT_ZEROS:
        return torch.zeros(d.shape, dtype=dt, device=device)
    if d.init == INIT_A_LOG:
        n = d.shape[-1]
        a = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device))
        return a.expand(d.shape).to(dt).contiguous()
    if d.init == INIT_DT_BIAS:
        dt_min, dt_max = 1e-3, 1e-1
        u = torch.rand(d.shape, dtype=torch.float32, device=device,
                       generator=gen)
        dt_v = torch.exp(u * (math.log(dt_max) - math.log(dt_min))
                         + math.log(dt_min))
        return (dt_v + torch.log(-torch.expm1(-dt_v))).to(dt)
    if d.init not in (INIT_NORMAL, INIT_SMALL):
        raise ValueError(d.init)
    w = torch.empty(d.shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    w.mul_(0.02 if d.init == INIT_SMALL else 1.0 / math.sqrt(max(d.fan_in, 1)))
    return w.to(dt)


def init_params(tree, seed: int, device: torch.device,
                cut: Optional[Callable] = None) -> dict:
    """Materialise every leaf on ``device``; each leaf's generator is seeded
    from (seed, crc32 of its path), so a leaf does not depend on the order
    or number of the others; slice i of a ``per_slice`` leaf from (seed,
    crc32 of its path + "/i"), written into the leaf in place.
    ``cut(path, leaf)``, when given, replaces each leaf as soon as it is
    drawn (a tensor-parallel rank keeps its shard: the full leaf is freed
    before the next one is drawn)."""
    def gen_for(path) -> torch.Generator:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed * 1_000_003 + zlib.crc32("/".join(path).encode()))
        return gen

    def leaf(path, d: ParamDef):
        full = drawn(path, d)
        return full if cut is None else cut(path, full)

    def drawn(path, d: ParamDef):
        if not d.per_slice:
            return _materialize(d, gen_for(path), device)
        out = torch.empty(d.shape, dtype=DTYPES[d.dtype], device=device)
        one = dataclasses.replace(d, shape=d.shape[1:], per_slice=False,
                                  fan_in_axes=tuple(
                                      a - 1 for a in d.fan_in_axes))
        for i in range(d.shape[0]):
            out[i] = _materialize(one, gen_for(path + (str(i),)), device)
        return out
    return map_defs(leaf, tree)
