"""Multi-replica online serving pool (port of ``repro.serving.pool``;
DESIGN.md §14).

``ReplicaPool`` is the paper's §4.1 deployment box: N live ``ServeEngine``
replicas (each with its async depth, prefix caching and spec decoding
unchanged) behind the load-aware ``Router``, driven by a tick loop.  One
tick steps every live replica once, fires due fault events, releases
backed-off retries, flushes parked work and enforces queue timeouts.

  * **never hang**: every submitted request ends in exactly one of
    ``results`` (completed) or ``shed`` (``State.REJECTED`` with a
    ``reject_reason``).  Admission control sheds up front, ``run_ticked``
    sheds leftovers at its deadline, and retries are bounded by
    ``retry_limit``.
  * **no silent loss**: a replica kill evacuates its queued and in-flight
    requests; committed tokens are checkpointed into the prompt as a
    forced replay prefix (``Request.checkpoint_redispatch``), and every
    re-dispatch, retry and shed is counted in ``PoolStats``.
  * **determinism**: with ``virtual_dt`` set the pool runs on a virtual
    clock advanced per tick, the engines stamp their commits with it, every
    replica's step takes ``virtual_dt`` (so the router's straggler shares
    stay equal and placement never reads the host's clock), and
    ``FaultPlan`` events are indexed by tick, so a seeded chaos run
    perturbs the same iteration every time.
  * **no leaked replica**: a killed or departed replica's engine drops its
    device state (KV cache, slot tensors) once it is evacuated; its stats
    stay.

SLO admission: a new request's predicted TTFT is the cheapest live
replica's backlog (queued + launched-but-uncommitted tokens, §10) plus its
own prompt, over the pool's measured service rate (EMA of committed
tokens/s); above ``slo_ttft_ms * slo_safety`` it is shed with reason
``"ttft_slo"``.  ``shed_backlog_tokens`` is a trigger that needs no rate
history.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.distributed.elastic import ClusterState, ElasticManager
from repro_torch.serving.config import PoolConfig
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.request import Request, State
from repro_torch.serving.router import NoLiveReplicas, ReplicaHandle, Router

# weight of the newest committed-tokens/s sample in the service-rate EMA
RATE_ALPHA = 0.3
# a replica's step time before its first measured step (wall clock)
FIRST_STEP_S = 1e-3


@dataclasses.dataclass
class PoolStats:
    submitted: int = 0
    completed: int = 0
    shed_requests: int = 0          # explicit rejections (admission/timeout)
    retries: int = 0                # timeout/backoff re-routes
    redispatched_requests: int = 0  # failure/leave evacuations re-entered
    redispatched_tokens: int = 0    # committed tokens replayed as prefix
    slo_violations: int = 0         # completed requests beyond TTFT/TPOT SLO
    timeouts: int = 0
    faults_injected: int = 0
    joins: int = 0
    leaves: int = 0
    ticks: int = 0

    def snapshot(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


class ReplicaPool:
    def __init__(self, engines: list, cfg: PoolConfig = PoolConfig(), *,
                 fault_plan: Optional[FaultPlan] = None,
                 engine_factory: Optional[Callable[[], object]] = None,
                 virtual_dt: Optional[float] = None):
        if not engines:
            raise ValueError("the pool needs at least one engine")
        self.cfg = cfg
        if fault_plan is None and cfg.fault_plan:
            fault_plan = FaultPlan.parse(cfg.fault_plan)
        self.faults = fault_plan or FaultPlan([])
        self.engine_factory = engine_factory
        self.elastic = ElasticManager(
            ClusterState(data=len(engines), model=1), min_data=1)
        # virtual clock: tests advance time by virtual_dt per tick so
        # arrival/TTFT stamps and timeouts are deterministic; engines are
        # re-pointed at the pool clock so their commit stamps agree with it
        self.virtual_dt = virtual_dt
        self._vnow = 0.0
        handles = []
        for i, eng in enumerate(engines):
            eng._clock = self.clock
            handles.append(ReplicaHandle(i, eng))
        self.router = Router(handles, affinity=cfg.affinity)
        self.stats = PoolStats()
        self.results: dict[int, Request] = {}
        self.shed: list[Request] = []
        self.tick_count = 0
        self.halted = False
        self._rate: Optional[float] = None          # committed tokens/s EMA
        self._prev_tokens = [0] * len(engines)
        self._last_step_s = [self._first_step_s()] * len(engines)
        self._dispatched_at: dict[int, float] = {}
        self._backoff: list[tuple[float, Request]] = []

    # ---- clock -------------------------------------------------------------
    def clock(self) -> float:
        if self.virtual_dt is not None:
            return self._vnow
        return time.perf_counter()

    def _first_step_s(self) -> float:
        return FIRST_STEP_S if self.virtual_dt is None else self.virtual_dt

    # ---- admission ---------------------------------------------------------
    def _shed(self, req: Request, reason: str) -> None:
        req.state = State.REJECTED
        req.reject_reason = reason
        self.stats.shed_requests += 1
        self.shed.append(req)

    def _servable(self, req: Request) -> bool:
        """Can some live engine fit this prompt and still generate at
        least one token?  (The engine clamps ``max_new_tokens`` to the
        slot extent; a prompt at/over ``max_len`` would clamp to zero and
        sit in the scheduler forever.)"""
        for h in self.router.replicas:
            if not h.alive or h.engine is None:
                return True      # engine-less handle: no length limit known
            eng = h.engine
            if req.prompt_len + 1 + eng.spec_k <= eng.max_len:
                return True
        return False

    def _best_backlog(self) -> Optional[int]:
        best = None
        for h in self.router.replicas:
            if not h.alive:
                continue
            b = h.stats().backlog_tokens
            if best is None or b < best:
                best = b
        return best

    def predicted_ttft_s(self, prompt_len: int) -> Optional[float]:
        """Admission estimate: cheapest backlog + own prompt, over the
        measured service rate.  ``None`` until a rate has been observed
        (optimistic: the empty pool admits everything)."""
        if self._rate is None or self._rate <= 0:
            return None
        best = self._best_backlog()
        if best is None:
            return None
        return (best + prompt_len) / self._rate

    def submit(self, req: Request) -> bool:
        """Admit-or-shed, never hang: returns False with the request in
        ``self.shed`` (explicit ``REJECTED`` + reason) when admission
        declines it."""
        self.stats.submitted += 1
        if not req.arrival:
            req.arrival = self.clock()
        if self.halted:
            self._shed(req, "pool_halted")
            return False
        if self.router.n_alive == 0:
            self._shed(req, "no_live_replicas")
            return False
        if not self._servable(req):
            # a prompt no live engine can fit would head-of-line block its
            # scheduler forever — reject it up front instead
            self._shed(req, "too_long")
            return False
        cap = self.cfg.shed_backlog_tokens
        best = self._best_backlog()
        if cap is not None and best is not None \
                and best + req.prompt_len > cap:
            self._shed(req, "backlog")
            return False
        if self.cfg.slo_ttft_ms is not None:
            pred = self.predicted_ttft_s(req.prompt_len)
            if pred is not None and pred * 1e3 > \
                    self.cfg.slo_ttft_ms * self.cfg.slo_safety:
                self._shed(req, "ttft_slo")
                return False
        try:
            self.router.submit(req)
        except NoLiveReplicas:
            self._shed(req, "no_live_replicas")
            return False
        self._dispatched_at[req.rid] = self.clock()
        return True

    # ---- completion --------------------------------------------------------
    def _complete(self, req: Request) -> None:
        if req.rid in self.results:
            return
        self.results[req.rid] = req
        self.stats.completed += 1
        self._dispatched_at.pop(req.rid, None)
        if req.replica is not None \
                and req.replica < len(self.router.replicas):
            self.router.replicas[req.replica].assigned.pop(req.rid, None)
        slo_t, slo_p = self.cfg.slo_ttft_ms, self.cfg.slo_tpot_ms
        if slo_t is not None and req.first_token_at is not None \
                and (req.first_token_at - req.arrival) * 1e3 > slo_t:
            self.stats.slo_violations += 1
        elif slo_p is not None and req.finished_at is not None \
                and req.first_token_at is not None and len(req.output) > 1:
            tpot = (req.finished_at - req.first_token_at) \
                / (len(req.output) - 1)
            if tpot * 1e3 > slo_p:
                self.stats.slo_violations += 1

    # ---- faults / membership ----------------------------------------------
    def _count_evacuation(self, handle: ReplicaHandle,
                          fn: Callable[[], tuple]) -> list[Request]:
        """Run an evacuation, folding its engine-side token counts into the
        pool counters and completing checkpoint-finished requests."""
        eng = handle.engine
        before = eng.stats.evacuated_tokens if eng is not None else 0
        finished, moved = fn()
        if eng is not None:
            self.stats.redispatched_tokens += \
                eng.stats.evacuated_tokens - before
        self.stats.redispatched_requests += len(moved)
        for r in finished:
            self._complete(r)
        for r in moved:
            self._dispatched_at[r.rid] = self.clock()
        return moved

    @staticmethod
    def _release(handle: ReplicaHandle) -> None:
        """A retired replica never steps again: its engine's device state
        goes now, not when the pool is collected."""
        if handle.engine is not None:
            handle.engine.release()

    def fail_replica(self, idx: int) -> list[Request]:
        """Abrupt kill: in-flight (uncommitted) tokens are lost; committed
        work is checkpointed and re-dispatched.  Returns moved requests."""
        if idx >= len(self.router.replicas) \
                or not self.router.replicas[idx].alive:
            return []
        handle = self.router.replicas[idx]
        moved = self._count_evacuation(
            handle, lambda: self.router.retire_replica(idx, drain=False))
        self._release(handle)
        decision = self.elastic.on_failure("data", 1)
        if decision.action == "halt":
            self.halted = True
            # nothing can run: everything evacuated-but-unplaced is shed
            # explicitly rather than parked forever
            for r in list(self.router.pending):
                self._shed(r, "pool_halted")
            self.router.pending.clear()
        return moved

    def leave_replica(self, idx: int) -> list[Request]:
        """Graceful scale-down: drain the pipeline first (its in-flight
        tokens commit), then evacuate what remains."""
        if idx >= len(self.router.replicas) \
                or not self.router.replicas[idx].alive:
            return []
        if self.router.n_alive <= 1:
            return []           # refuse to drain the last replica
        handle = self.router.replicas[idx]
        moved = self._count_evacuation(
            handle, lambda: self.router.retire_replica(idx, drain=True))
        self._release(handle)
        self.elastic.on_leave(1)     # planned, not failed
        self.stats.leaves += 1
        return moved

    def join_replica(self, engine=None) -> Optional[int]:
        """Elastic scale-up; pulls parked work onto the new replica."""
        if engine is None:
            if self.engine_factory is None:
                return None
            engine = self.engine_factory()
        engine._clock = self.clock
        idx = len(self.router.replicas)
        self.router.add_replica(ReplicaHandle(idx, engine))
        self._prev_tokens.append(self._engine_tokens(engine))
        self._last_step_s.append(self._first_step_s())
        self.elastic.on_capacity(1)
        self.stats.joins += 1
        self.halted = False
        return idx

    def _apply_fault(self, ev) -> None:
        self.stats.faults_injected += 1
        h = (self.router.replicas[ev.replica]
             if ev.replica < len(self.router.replicas) else None)
        if ev.kind == "kill":
            self.fail_replica(ev.replica)
        elif ev.kind == "stall" and h is not None and h.alive:
            h.stall_until = max(h.stall_until, self.tick_count + ev.arg)
            h.suspect = True
        elif ev.kind == "degrade" and h is not None and h.alive:
            h.degrade = max(ev.arg, 2)
            h.suspect = True
        elif ev.kind == "join":
            self.join_replica()
        elif ev.kind == "leave":
            self.leave_replica(ev.replica)

    # ---- timeouts / retries ------------------------------------------------
    def _check_timeouts(self, now: float) -> None:
        limit = self.cfg.request_timeout_s
        if limit is None:
            return
        for h in self.router.replicas:
            if not h.alive or h.engine is None:
                continue
            sched = h.engine.scheduler
            for r in [r for r in sched.waiting
                      if now - self._dispatched_at.get(r.rid, now) > limit]:
                sched.waiting.remove(r)
                h.assigned.pop(r.rid, None)
                self.stats.timeouts += 1
                r.retries += 1
                if r.retries > self.cfg.retry_limit:
                    self._dispatched_at.pop(r.rid, None)
                    self._shed(r, "retry_limit")
                    continue
                self.stats.retries += 1
                delay = self.cfg.backoff_base_s * 2 ** (r.retries - 1)
                self._backoff.append((now + delay, r))

    def _release_backoff(self, now: float) -> None:
        due = [r for t, r in self._backoff if t <= now]
        self._backoff = [(t, r) for t, r in self._backoff if t > now]
        for r in due:
            try:
                self.router.submit(r)
                self._dispatched_at[r.rid] = now
            except NoLiveReplicas:
                self._shed(r, "no_live_replicas")

    # ---- the event loop ----------------------------------------------------
    def _engine_tokens(self, eng) -> int:
        return eng.stats.prefill_tokens + eng.stats.decode_tokens

    def _observe_rate(self, dt: float, committed: int) -> None:
        if dt <= 0 or committed <= 0:
            return
        inst = committed / dt
        self._rate = inst if self._rate is None else (
            RATE_ALPHA * inst + (1 - RATE_ALPHA) * self._rate)

    def tick(self) -> list[Request]:
        """One pool iteration: advance the clock, fire due faults, release
        retries, flush parked work, step every live (non-stalled) replica
        once, observe service rate, enforce queue timeouts."""
        if self.virtual_dt is not None:
            self._vnow += self.virtual_dt
        now = self.clock()
        self.stats.ticks += 1
        for ev in self.faults.due(self.tick_count):
            self._apply_fault(ev)
        self._release_backoff(now)
        for r in self.router.flush_pending():
            self._dispatched_at[r.rid] = now
        finished: list[Request] = []
        committed = 0
        reps = self.router.replicas
        for i, h in enumerate(reps):
            if not h.alive or h.engine is None:
                continue
            if self.tick_count < h.stall_until:
                continue
            if h.degrade > 1 and self.tick_count % h.degrade:
                continue
            if h.suspect and self.tick_count >= h.stall_until \
                    and h.degrade <= 1:
                h.suspect = False        # stall expired: healthy again
            eng = h.engine
            t0 = time.perf_counter()
            plan = eng.scheduler.plan()
            if plan is None:
                done = eng.drain(max_retire=1) if eng.in_flight else []
            else:
                done = eng.step(plan)
            if plan is not None or done:
                self._last_step_s[i] = (
                    self.virtual_dt if self.virtual_dt is not None
                    else max(time.perf_counter() - t0, 1e-9))
            tot = self._engine_tokens(eng)
            committed += tot - self._prev_tokens[i]
            self._prev_tokens[i] = tot
            finished += done
        self.router.observe_step_times(list(self._last_step_s))
        dt = self.virtual_dt if self.virtual_dt is not None \
            else sum(self._last_step_s) / max(len(self._last_step_s), 1)
        self._observe_rate(dt, committed)
        self._check_timeouts(now)
        for r in finished:
            self._complete(r)
        self.tick_count += 1
        return finished

    def outstanding(self) -> int:
        """Requests admitted but not yet completed or shed."""
        n = len(self.router.pending) + len(self._backoff)
        for h in self.router.replicas:
            if not h.alive or h.engine is None:
                continue
            sched = h.engine.scheduler
            n += sched.n_waiting
            n += sum(1 for r in sched.active
                     if r.state not in (State.FINISHED, State.DISCARDED,
                                        State.REJECTED))
        return n

    def drain(self) -> list[Request]:
        """Flush every live replica's pipeline (no new work planned)."""
        done: list[Request] = []
        for h in self.router.replicas:
            if h.alive and h.engine is not None:
                done += h.engine.drain()
        for r in done:
            self._complete(r)
        return done

    def run_ticked(self, arrivals: list[tuple[int, Request]],
                   max_ticks: int = 10_000) -> dict[int, Request]:
        """Deterministic loop: submit each request at its arrival tick,
        tick until everything has completed or been shed, bounded by
        ``max_ticks`` (leftovers are shed with reason ``"deadline"`` — the
        pool never hangs).  Returns ``self.results``."""
        arrivals = sorted(arrivals, key=lambda a: a[0])
        i = 0
        while True:
            while i < len(arrivals) and arrivals[i][0] <= self.tick_count:
                self.submit(arrivals[i][1])
                i += 1
            if i >= len(arrivals) and self.outstanding() == 0:
                break
            if self.tick_count >= max_ticks:
                for h in self.router.replicas:
                    if not h.alive or h.engine is None:
                        continue
                    # abandon in-flight work UNfetched: a later drain()
                    # must not commit tokens into requests shed below
                    # (they would land in both results and shed)
                    h.engine._ring.clear()
                    sched = h.engine.scheduler
                    stuck = list(sched.waiting) + [
                        r for r in sched.active
                        if r.state not in (State.FINISHED, State.DISCARDED)]
                    sched.waiting.clear()
                    sched.active = []
                    for r in stuck:
                        self._shed(r, "deadline")
                for r in list(self.router.pending) + \
                        [r for _, r in self._backoff]:
                    self._shed(r, "deadline")
                self.router.pending.clear()
                self._backoff = []
                break
            self.tick()
        self.drain()
        return self.results

    def run_online(self, reqs: list[Request], offsets: list[float],
                   duration: Optional[float] = None) -> dict[int, Request]:
        """Wall-clock loop for benchmarks/serve: submit request ``k`` at
        ``t0 + offsets[k]``, tick when there is work, sleep (never
        busy-wait) when idle before the next arrival."""
        if len(reqs) != len(offsets):
            raise ValueError(f"{len(reqs)} requests, {len(offsets)} offsets")
        t0 = self.clock()
        i = 0
        while True:
            now = self.clock() - t0
            while i < len(reqs) and offsets[i] <= now:
                reqs[i].arrival = self.clock()
                self.submit(reqs[i])
                i += 1
            if i >= len(reqs) and self.outstanding() == 0:
                break
            if duration is not None and now > duration:
                break
            if self.outstanding() == 0 and i < len(reqs):
                # idle until the next arrival: sleep, don't spin
                time.sleep(min(max(offsets[i] - now, 0.0), 0.002)
                           or 0.0005)
                continue
            self.tick()
        self.drain()
        return self.results

    # ---- observability -----------------------------------------------------
    def snapshot(self) -> dict:
        snap = self.stats.snapshot()
        snap["service_rate_tok_s"] = self._rate
        snap["pending"] = len(self.router.pending)
        snap["backoff"] = len(self._backoff)
        snap["dispatched"] = self.router.dispatched
        snap["router_redispatched"] = self.router.redispatched
        per = []
        for h in self.router.replicas:
            st = h.stats()
            per.append({
                "replica": h.rid, "alive": h.alive, "suspect": h.suspect,
                "queued_tokens": st.queued_tokens,
                "inflight_tokens": st.inflight_tokens,
                "queue_depth": st.active_requests,
                "kv_used_frac": round(st.kv_used_frac, 4),
            })
        snap["replicas"] = per
        return snap
