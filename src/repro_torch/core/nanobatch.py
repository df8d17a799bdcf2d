"""NanoFlow §4.3 nano-batching (port of ``repro.core.nanobatch``):

  * ``NanoBatchPlan``          — sizes along the token axis (``even``, or
                                 ``nano_batch_sizes_for``'s multiples)
  * ``split``/``merge``        — slice a dense token batch into nano-batches
  * ``interleaved_apply``      — run a two-stage op pair over nano-batches in
                                 the paper's Figure-6 interleave order
  * ``packed_segment_order``   — the scheduler's layout of the packed stream

Correctness invariant (tested): for any plan, outputs equal the unsplit op.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class NanoBatchPlan:
    """Nano-batch sizes along the token axis.  sum(sizes) == batch tokens."""
    sizes: tuple[int, ...]

    @staticmethod
    def even(total: int, n: int) -> "NanoBatchPlan":
        base, rem = divmod(total, n)
        sizes = tuple(base + (1 if i < rem else 0) for i in range(n))
        return NanoBatchPlan(sizes=tuple(s for s in sizes if s > 0))

    @property
    def offsets(self) -> tuple[int, ...]:
        out, acc = [], 0
        for s in self.sizes:
            out.append(acc)
            acc += s
        return tuple(out)

    def assign_segments(self, lengths: Sequence[int]) -> tuple[int, ...]:
        """Map packed-stream segments (laid out in order) to nano-batches:
        segment i belongs to the nano-batch holding its first token."""
        bounds = self.offsets + (sum(self.sizes),)
        out, pos = [], 0
        for ln in lengths:
            nb = 0
            while nb + 1 < len(self.sizes) and pos >= bounds[nb + 1]:
                nb += 1
            out.append(nb)
            pos += ln
        return tuple(out)


def split(x: torch.Tensor, plan: NanoBatchPlan,
          axis: int = 0) -> list[torch.Tensor]:
    assert x.shape[axis] == sum(plan.sizes), (x.shape, plan)
    return list(torch.split(x, list(plan.sizes), dim=axis))


def merge(parts: Sequence[torch.Tensor], axis: int = 0) -> torch.Tensor:
    return torch.cat(list(parts), dim=axis)


def interleaved_apply(stage_compute: Callable[[torch.Tensor], torch.Tensor],
                      stage_network: Callable[[torch.Tensor], torch.Tensor],
                      x: torch.Tensor, plan: NanoBatchPlan,
                      axis: int = 0) -> torch.Tensor:
    """Figure-6 interleave: Com(1) ; [Net(1) ∥ Com(2)] ; Net(2) ; ...

    Net(i) depends only on Com(i); semantics are those of the unsplit
    composition (tested)."""
    chunks = split(x, plan, axis)
    computed = [stage_compute(c) for c in chunks]
    netted = [stage_network(c) for c in computed]
    return merge(netted, axis)


def packed_segment_order(kinds: Sequence[str],
                         lengths: Sequence[int]) -> tuple[int, ...]:
    """Figure-6 interleave order for the segments of a packed batch:
    memory-bound decode (and verify) segments first, in stable order, then
    the compute-bound prefill chunks by descending length.  Returns the
    permutation of segment indices."""
    decode = [i for i, k in enumerate(kinds) if k in ("decode", "verify")]
    prefill = sorted((i for i, k in enumerate(kinds)
                      if k not in ("decode", "verify")),
                     key=lambda i: (-lengths[i], i))
    return tuple(decode + prefill)


def nano_batch_sizes_for(total_tokens: int, nano: int,
                         multiple_of: int = 8) -> NanoBatchPlan:
    """Sizes rounded to hardware-friendly multiples (the paper's discrete
    batching applied at nano-batch granularity)."""
    if nano <= 1 or total_tokens <= multiple_of:
        return NanoBatchPlan((total_tokens,))
    base = max(multiple_of, (total_tokens // nano) // multiple_of * multiple_of)
    sizes = []
    left = total_tokens
    for _ in range(nano - 1):
        take = min(base, left)
        if take <= 0:
            break
        sizes.append(take)
        left -= take
    if left > 0:
        sizes.append(left)
    return NanoBatchPlan(tuple(sizes))
