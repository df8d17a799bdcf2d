"""Multi-replica request router (port of ``repro.serving.router``;
DESIGN.md §14).

The serving fleet is many independent engines; the router places each
request on one of them:

  * **load-aware dispatch**: to the replica with the lowest estimated
    backlog, queued prompt tokens *plus* launched-but-uncommitted tokens
    (at async depth k up to k iterations of samples are in flight, §10;
    counting committed work only would make a saturated pipelined replica
    look idle), divided by its straggler speed share and raised by KV-pool
    pressure;
  * **session affinity**: a multi-turn session stays on the replica that
    holds its prefix-cached KV (§12) until that replica dies or its KV pool
    passes ``KV_SPILL``;
  * **failure handling**: a dead replica is never selected again;
    ``retire_replica`` evacuates its whole backlog, queued and in flight,
    checkpointed so committed tokens replay as a forced prefix, and puts
    each request back into the dispatch path exactly once (into
    ``pending`` when no live replica exists: parked, never dropped).

The router needs only ``submit`` and queue metrics of an engine; a handle
without an engine keeps its assigned requests itself.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

from repro_torch.distributed.elastic import StragglerMitigator
from repro_torch.serving.request import Request, State

_DONE = (State.FINISHED, State.DISCARDED, State.REJECTED)
# tokens of backlog charged for each active request's remaining decode
DECODE_COST = 64
# KV pressure above this fraction breaks session affinity and raises the
# replica's dispatch cost
KV_SPILL = 0.9


class NoLiveReplicas(RuntimeError):
    """Raised by ``submit`` when every replica is dead (the pool catches it
    and sheds)."""


@dataclasses.dataclass
class ReplicaStats:
    queued_tokens: int = 0       # prompt tokens not yet launched
    inflight_tokens: int = 0     # launched-but-uncommitted (§10 pipeline)
    active_requests: int = 0
    kv_used_frac: float = 0.0    # device KV pool pressure [0, 1]
    ema_step_s: float = 0.0
    alive: bool = True

    @property
    def backlog_tokens(self) -> int:
        """Work ahead of a newly routed request: queued + in-flight."""
        return self.queued_tokens + self.inflight_tokens


class ReplicaHandle:
    """One engine (or, without one, a stand-in that only keeps its
    assigned requests).  The pool's fault harness drives ``stall_until``,
    ``degrade`` and ``suspect``; the router reads ``alive`` and
    ``suspect`` (a stalled replica gets no work while a healthy one
    exists)."""

    def __init__(self, rid: int, engine=None):
        self.rid = rid
        self.engine = engine
        self.alive = True
        self.suspect = False      # stalled/degraded: deprioritized, not dead
        self.stall_until = 0      # pool tick until which steps are skipped
        self.degrade = 1          # step only every `degrade` pool ticks
        self.assigned: dict[int, Request] = {}

    def _prune(self) -> None:
        self.assigned = {rid: r for rid, r in self.assigned.items()
                         if r.state not in _DONE}

    def stats(self) -> ReplicaStats:
        if not self.alive:
            return ReplicaStats(alive=False)
        if self.engine is None:
            self._prune()
            reqs = list(self.assigned.values())
            return ReplicaStats(
                queued_tokens=sum(r.prefill_unlaunched for r in reqs),
                inflight_tokens=sum(r.inflight for r in reqs),
                active_requests=len(reqs))
        sched = self.engine.scheduler
        queued = sum(r.prefill_unlaunched for r in sched.waiting) + \
            sum(r.prefill_unlaunched for r in sched.active)
        # launched but uncommitted: in-flight samples plus prefill chunks
        # past the committed boundary
        inflight = sum(r.inflight + (r.prefill_launched - r.prefill_done)
                       for r in sched.active)
        kvs = self.engine.kv.stats
        return ReplicaStats(
            queued_tokens=queued, inflight_tokens=inflight,
            active_requests=sched.n_active + sched.n_waiting,
            kv_used_frac=kvs.device_pages_used
            / max(kvs.device_pages_total, 1))

    def submit(self, req: Request) -> None:
        req.replica = self.rid
        self.assigned[req.rid] = req
        if self.engine is not None:
            self.engine.submit(req)

    def evacuate(self, *, drain: bool) \
            -> tuple[list[Request], list[Request]]:
        """Checkpoint and collect the whole backlog: ``(finished, moved)``,
        through ``ServeEngine.evacuate`` (which releases slots and KV) or,
        without an engine, over the assigned requests."""
        if self.engine is not None:
            finished, moved = self.engine.evacuate(drain=drain)
        else:
            finished, moved = [], []
            for r in self.assigned.values():
                if r.state in _DONE:
                    continue
                r.checkpoint_redispatch()
                (finished if r.state == State.FINISHED else moved).append(r)
        self.assigned = {}
        return finished, moved


class Router:
    def __init__(self, replicas: list[ReplicaHandle],
                 straggler_alpha: float = 0.2, affinity: bool = True):
        if not replicas:
            raise ValueError("the router needs at least one replica")
        self.replicas = list(replicas)
        self.straggler_alpha = straggler_alpha
        self.straggler = StragglerMitigator(len(replicas),
                                            alpha=straggler_alpha)
        self.affinity = affinity
        self._session: dict[int, int] = {}     # session key -> replica idx
        # orphans with no live replica to take them, flushed when capacity
        # returns (join or recovery)
        self.pending: deque[Request] = deque()
        self.dispatched = 0
        self.redispatched = 0

    # ---- dispatch ----------------------------------------------------------
    def submit(self, req: Request) -> int:
        """Route to the cheapest live replica (``_select``); returns its
        index, or raises ``NoLiveReplicas``."""
        best = self._select(req)
        if best is None:
            raise NoLiveReplicas("no live replicas")
        self._place(req, best)
        return best

    def _select(self, req: Request) -> Optional[int]:
        if self.affinity and req.session is not None:
            rid = self._session.get(req.session)
            if rid is not None:
                rep = self.replicas[rid]
                if rep.alive and not rep.suspect \
                        and rep.stats().kv_used_frac < KV_SPILL:
                    return rid
        # suspect (stalled or degraded) replicas get work only when no
        # healthy one is alive
        for include_suspect in (False, True):
            shares = self.straggler.shares()
            best, best_cost = None, None
            for i, rep in enumerate(self.replicas):
                if not rep.alive or (rep.suspect and not include_suspect):
                    continue
                st = rep.stats()
                backlog = (st.backlog_tokens
                           + DECODE_COST * st.active_requests
                           + req.prompt_len)
                cost = backlog / max(shares[i], 1e-9)
                if st.kv_used_frac >= KV_SPILL:
                    cost *= 1.0 + 4.0 * (st.kv_used_frac - KV_SPILL)
                if best_cost is None or cost < best_cost:
                    best, best_cost = i, cost
            if best is not None:
                return best
        return None

    def _place(self, req: Request, rid: int) -> None:
        if self.affinity and req.session is not None:
            self._session[req.session] = rid
        self.replicas[rid].submit(req)
        self.dispatched += 1

    def flush_pending(self) -> list[Request]:
        """Place parked orphans while a live replica takes them, stopping
        at the first that none does, so their order holds."""
        placed = []
        while self.pending:
            req = self.pending[0]
            best = self._select(req)
            if best is None:
                break
            self.pending.popleft()
            self._place(req, best)
            placed.append(req)
        return placed

    # ---- membership --------------------------------------------------------
    def add_replica(self, handle: ReplicaHandle) -> int:
        """Replica join: the straggler EMA restarts for the new fleet size
        and parked work is flushed onto the added capacity."""
        self.replicas.append(handle)
        self.straggler = StragglerMitigator(len(self.replicas),
                                            alpha=self.straggler_alpha)
        self.flush_pending()
        return len(self.replicas) - 1

    # ---- health ------------------------------------------------------------
    def observe_step_times(self, times: list[float]) -> None:
        self.straggler.observe(times)

    def retire_replica(self, rid: int, *, drain: bool) \
            -> tuple[list[Request], list[Request]]:
        """The failure and graceful-leave path: mark the replica dead,
        evacuate its whole backlog (queued and in flight) and put every
        unfinished request back into the dispatch path exactly once (the
        evacuation empties the replica, so a second call finds nothing).
        Returns ``(finished, moved)``: requests finished at the checkpoint
        (committed EOS or spent budget, and on the graceful path the
        drained completions), and requests moved or parked in
        ``pending``."""
        rep = self.replicas[rid]
        if not rep.alive:
            return [], []
        rep.alive = False
        finished, orphans = rep.evacuate(drain=drain)
        self._session = {k: v for k, v in self._session.items() if v != rid}
        moved = []
        for r in orphans:
            self.redispatched += 1
            r.retries += 1
            best = self._select(r)
            if best is None:
                self.pending.append(r)
            else:
                self._place(r, best)
            moved.append(r)
        return finished, moved

    def mark_failed(self, rid: int) -> list[Request]:
        """Kill a replica and re-dispatch its queued and in-flight requests;
        returns the moved ones."""
        _, moved = self.retire_replica(rid, drain=False)
        return moved

    @property
    def n_alive(self) -> int:
        return sum(1 for r in self.replicas if r.alive)
