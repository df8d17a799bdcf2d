"""NanoFlow §4.3 nano-batching: the pure-Python planning parts of
``repro.core.nanobatch`` (``NanoBatchPlan``, ``packed_segment_order``,
``nano_batch_sizes_for``), which the scheduler uses to lay out the packed
stream.  The tensor split/merge helpers wait for the slices that launch per
nano-batch.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class NanoBatchPlan:
    """Nano-batch sizes along the token axis.  sum(sizes) == batch tokens."""
    sizes: tuple[int, ...]

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
