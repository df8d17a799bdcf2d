"""Deterministic fault injection (chaos) for the replica pool (copy of
``repro.serving.faults``).

A ``FaultPlan`` is a list of events indexed by the pool's *tick counter*
(one tick = one sweep in which every live replica steps once), not by wall
time: a seeded plan perturbs the same iteration on every run, so a killed
pool can be compared token for token with an unperturbed one.

Event kinds:

  * ``kill``    — the replica dies: its in-flight (uncommitted) work is
                  lost, its committed tokens are checkpointed and
                  re-dispatched.
  * ``stall``   — the replica freezes for ``arg`` ticks: it holds its work
                  but steps nothing; the router marks it suspect and the
                  pool's request timeouts fire if the stall outlives them.
  * ``degrade`` — the replica steps only every ``arg``-th tick: the
                  straggler EMA sheds load from it.
  * ``join``    — a fresh replica is added (elastic scale-up).
  * ``leave``   — the replica drains and departs (scale-down).

Spec strings (``--fault-plan``) are comma-separated ``kind@tick[:rN][:arg]``:

    kill@40:r1  stall@10:r0:20  degrade@5:r1:3  join@60  leave@80:r0

``FaultPlan.seeded`` draws a reproducible random plan from a seed.
"""
from __future__ import annotations

import dataclasses
import random

KINDS = ("kill", "stall", "degrade", "join", "leave")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    tick: int
    kind: str          # one of KINDS
    replica: int = 0   # target replica index (ignored for join)
    arg: int = 0       # stall: duration ticks; degrade: step-every-N

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.tick < 0:
            raise ValueError("fault tick must be >= 0")

    def describe(self) -> str:
        base = f"{self.kind}@{self.tick}:r{self.replica}"
        return f"{base}:{self.arg}" if self.arg else base


class FaultPlan:
    def __init__(self, events: list[FaultEvent] = ()):  # type: ignore[assignment]
        self.events = sorted(events, key=lambda e: (e.tick, e.kind))
        self._fired: set[int] = set()

    def __bool__(self) -> bool:
        return bool(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def due(self, tick: int) -> list[FaultEvent]:
        """Events that fire at or before ``tick``, each delivered once."""
        out = []
        for i, ev in enumerate(self.events):
            if ev.tick <= tick and i not in self._fired:
                self._fired.add(i)
                out.append(ev)
        return out

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse ``kind@tick[:rN][:arg]`` comma-separated event specs."""
        events = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            head, _, rest = part.partition("@")
            kind = head.strip()
            fields = rest.split(":")
            if not fields[0]:
                raise ValueError(f"fault event {part!r} missing @tick")
            tick = int(fields[0])
            replica, arg = 0, 0
            for f in fields[1:]:
                f = f.strip()
                if f.startswith("r"):
                    replica = int(f[1:])
                else:
                    arg = int(f)
            if kind == "stall" and arg <= 0:
                arg = 10
            if kind == "degrade" and arg <= 1:
                arg = 2
            events.append(FaultEvent(tick=tick, kind=kind,
                                     replica=replica, arg=arg))
        return cls(events)

    @classmethod
    def seeded(cls, seed: int, n_events: int, horizon: int,
               n_replicas: int, kinds: tuple[str, ...] = KINDS) \
            -> "FaultPlan":
        """Reproducible random plan: same (seed, args) -> same events."""
        rng = random.Random(seed)
        events = []
        for _ in range(n_events):
            kind = rng.choice(kinds)
            events.append(FaultEvent(
                tick=rng.randrange(1, max(horizon, 2)), kind=kind,
                replica=rng.randrange(max(n_replicas, 1)),
                arg=rng.randrange(2, 8)))
        return cls(events)

    def describe(self) -> str:
        return ",".join(e.describe() for e in self.events)
