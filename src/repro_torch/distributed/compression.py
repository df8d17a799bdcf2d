"""Gradient compression for the slow all-reduce (port of
``repro.distributed.compression``).

int8 uniform quantization with error feedback: each rank quantizes its
gradient plus the residual carried from the last step, keeps what the
quantization lost as the next residual, and the group sums the dequantized
values and takes the mean (JAX's ``compressed_psum``; ``plain_psum`` is
``plain_all_reduce``).  Error feedback makes the compressed trajectory
converge to the uncompressed one (Karimireddy et al. 2019).  Over
``torch.distributed``: gloo on the CPU, nccl on cards.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.training.optimizer import rebuild, tree_leaves, tree_map


def compress_state_init(grads: Any) -> Any:
    """Zero f32 residuals, congruent with the gradient tree."""
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, f32 scale): scale = max|x| / 127 + 1e-12, values
    rounded half to even and clipped to [-127, 127]."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_all_reduce(grads: Any, residuals: Any,
                          group: Optional[Any] = None) -> tuple[Any, Any]:
    """int8 all-reduce with error feedback over ``group`` (the default
    group when None).  Returns (mean-reduced grads in their dtypes, new
    residuals).  The dequantized values are summed: numerically what an
    int8 payload with per-rank scales gives; the wire would carry 1 byte
    per element plus one scale per leaf."""
    n = dist.get_world_size(group)

    def leaf(g, r):
        x = g.float() + r
        q, scale = _quantize(x)
        deq = q.float() * scale
        summed = deq.clone()
        dist.all_reduce(summed, group=group)
        return (summed / n).to(g.dtype), x - deq

    pairs = {path: leaf(g, r) for (path, g), (_, r)
             in zip(tree_leaves(grads), tree_leaves(residuals))}
    return (rebuild(grads, {k: v[0] for k, v in pairs.items()}),
            rebuild(grads, {k: v[1] for k, v in pairs.items()}))


def plain_all_reduce(grads: Any, group: Optional[Any] = None) -> Any:
    """The uncompressed mean over ``group``."""
    n = dist.get_world_size(group)

    def leaf(g):
        s = g.clone()
        dist.all_reduce(s, group=group)
        return s / n
    return tree_map(leaf, grads)

