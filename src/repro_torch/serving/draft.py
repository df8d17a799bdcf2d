"""Draft-token proposers for speculative decoding (DESIGN.md §13); the
port's copy of ``repro.serving.draft``.

The engine's verify segments are drafter-agnostic: anything that can
propose up to ``k`` next tokens for a request's committed history can
drive them.  ``Drafter`` is the protocol; ``NgramDrafter`` is the
reference implementation — prompt-lookup / self-history n-gram matching
(no model, no device work), the cheap end of the speculative-decoding
design space.  A tiny self-drafting model slots in later by implementing
``propose`` (its own forward pass happens *outside* the packed step, so
the 1-dispatch-per-iteration invariant is about the target model only).

Drafts are *proposals*, never trusted: the packed step verifies every
position against the target model and accepts only the longest matching
prefix (rejection sampling degenerates to exact prefix-match acceptance
for a point-mass drafter — see DESIGN.md §13), so a bad drafter costs
compute, not correctness.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

from repro_torch.serving.request import Request


@runtime_checkable
class Drafter(Protocol):
    def propose(self, req: Request, k: int) -> list[int]:
        """Up to ``k`` draft tokens continuing ``req``'s committed history
        (prompt + committed output).  May return fewer than ``k`` (the
        scheduler pads the verify segment); must be cheap — this runs on
        the host scheduling path of every iteration."""
        ...


@dataclass
class NgramDrafter:
    """Prompt-lookup / self-history n-gram drafter: find the most recent
    earlier occurrence of the history's trailing n-gram (longest n first,
    down to a single token) and propose the tokens that followed it.

    The single-token floor (``min_n=1``) matters on decode-heavy
    workloads: greedy decoding frequently enters short cycles, and a
    length-1 suffix match catches period-1 fixed points that longer
    n-grams would miss early in the cycle."""
    max_n: int = 3
    min_n: int = 1

    def propose(self, req: Request, k: int) -> list[int]:
        hist = req.prompt + req.output
        if k <= 0 or len(hist) < 2:
            return []
        top = min(self.max_n, len(hist) - 1)
        for n in range(top, self.min_n - 1, -1):
            tail = hist[-n:]
            # most recent earlier occurrence whose continuation is nonempty
            for start in range(len(hist) - n - 1, -1, -1):
                if hist[start:start + n] == tail:
                    cont = hist[start + n:start + n + k]
                    if cont:
                        return cont
                    break
        return []


_REGISTRY = {"ngram": NgramDrafter}


def drafter_names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_drafter(name: str, **kwargs) -> Drafter:
    if name not in _REGISTRY:
        raise ValueError(f"unknown drafter {name!r}; "
                         f"available: {drafter_names()}")
    return _REGISTRY[name](**kwargs)
