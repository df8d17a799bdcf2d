"""The port's replica pool (DESIGN.md §14) against the JAX pool: f32 on
the CPU, the same converted weights and requests in both packages.

Chaos exactness (``tests/test_fault_tolerance.py:70``): two replicas, one
killed at tick 3, on tiny-toy and scale_down(DeepSeek-V2) (absorbed MLA at
capacity_factor 16) at async depths 0 and 1, greedy, and tiny-toy under
temperature sampling.  Every request's generated stream equals the JAX
killed pool's and the port's unperturbed pool's, and the pool and engine
counters equal the JAX pool's.  Then the scenarios of
``test_fault_tolerance.py:115-269`` as cases of one test: each compares the
results (generated tokens, virtual-clock stamps, replica, retries), the
shed requests with their reasons and the snapshot with the JAX pool's.

Two inputs of the JAX pool would make the comparison depend on the host:
its router's straggler shares are fed wall-clock step times even on a
virtual clock, so its ``time`` is replaced by one under which every step
takes 1 ms, its replicas' first step time, and its shares stay equal, as
the port's do on a virtual clock (every step takes ``virtual_dt``); and
at depth 1 an engine harvests an iteration as soon as its result is
ready, which on the CPU is at once for the port and whenever XLA's thread
is done for JAX, so the depth-1 engines run with harvesting off and both
keep exactly one iteration in flight.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import dataclasses
import time
import types

import pytest

import repro.serving.pool as jax_pool_mod
import repro_torch.serving.pool as torch_pool_mod
from _torch_serving import DEEPSEEK, models
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.config import PoolConfig as JaxPoolConfig
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro.serving.faults import FaultPlan as JaxFaultPlan
from repro.serving.request import Request as JaxRequest
from repro.serving.request import State as JaxState
from repro_torch.serving.config import EngineConfig, PoolConfig
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.request import Request, State

JAX = types.SimpleNamespace(
    name="jax", side=0, Engine=JaxServeEngine, EngineConfig=JaxEngineConfig,
    PoolConfig=JaxPoolConfig, Pool=jax_pool_mod.ReplicaPool,
    FaultPlan=JaxFaultPlan, Request=JaxRequest, State=JaxState, kw={})
PORT = types.SimpleNamespace(
    name="port", side=1, Engine=ServeEngine, EngineConfig=EngineConfig,
    PoolConfig=PoolConfig, Pool=torch_pool_mod.ReplicaPool,
    FaultPlan=FaultPlan, Request=Request, State=State, kw={"device": "cpu"})
SIDES = (JAX, PORT)
ENGINE_COUNTS = ("iterations", "model_dispatches", "host_syncs",
                 "prefill_tokens", "prefill_model_tokens", "decode_tokens",
                 "evacuated_requests", "evacuated_tokens")


class _Instant(float):
    """A reading of the JAX pool's clock: any two are 1 ms apart."""

    def __sub__(self, other):
        return 1e-3


@pytest.fixture(autouse=True)
def jax_steps_take_1ms(monkeypatch):
    """Every step of the JAX pool measures 1 ms, the step time its
    replicas start from, so its straggler shares stay equal.  The port's
    pool keeps the real ``time``."""
    monkeypatch.setattr(jax_pool_mod, "time", types.SimpleNamespace(
        perf_counter=lambda: _Instant(0.0), sleep=time.sleep))


def _ecfg(side, depth, **kw):
    """The JAX fault tests' engine: 4 slots x 64 rows, blocks of 8."""
    return side.EngineConfig(max_slots=4, max_len=64, kv_block_size=8,
                             discrete_sizes=(16, 8), async_depth=depth,
                             avg_decode_len=4.0, async_harvest=depth == 0,
                             **kw)


def _mk(side, model, ecfg):
    cfg, params = model[side.side], model[2 + side.side]
    return lambda: side.Engine(cfg, params, ecfg, **side.kw)


def _req(side, rid, prompt, max_new, **kw):
    return side.Request(rid=rid, prompt=list(prompt), max_new_tokens=max_new,
                        **kw)


def _arrivals(side, n, stagger=2):
    return [(i // stagger, _req(side, i, range(5 + i, 15 + i), 8))
            for i in range(n)]


def _outcome(pool) -> dict:
    """What a pool run decided: each result's stream, virtual-clock stamps
    (arrival, first token, finish), replica and retries; the shed requests
    in order with their reasons; the snapshot; each replica engine's
    counters."""
    return dict(
        results={rid: (tuple(r.generated), r.arrival, r.first_token_at,
                       r.finished_at, r.replica, r.retries)
                 for rid, r in sorted(pool.results.items())},
        shed=[(r.rid, r.reject_reason, r.retries, r.state.value)
              for r in pool.shed],
        snapshot=pool.snapshot(),
        engines=[{f: getattr(h.engine.stats, f) for f in ENGINE_COUNTS}
                 for h in pool.router.replicas],
        elastic=dataclasses.asdict(pool.elastic.state),
        halted=pool.halted, ticks=pool.tick_count)


def _two_pool(side, model, ecfg, plan, n=8, pcfg=None, max_ticks=500):
    """The JAX fault tests' ``_run_pool``: two replicas, requests arriving
    two a tick, a virtual clock of 10 ms a tick."""
    mk = _mk(side, model, ecfg)
    pool = side.Pool([mk(), mk()], pcfg or side.PoolConfig(replicas=2),
                     fault_plan=plan and side.FaultPlan.parse(plan),
                     virtual_dt=0.01, engine_factory=mk)
    pool.run_ticked(_arrivals(side, n), max_ticks=max_ticks)
    return pool


def _generated(pool) -> dict:
    return {rid: tuple(r.generated) for rid, r in pool.results.items()}


CHAOS = [("tiny-toy", 0, {}), ("tiny-toy", 1, {}), (DEEPSEEK, 0, {}),
         (DEEPSEEK, 1, {}), ("tiny-toy", 1, dict(temperature=0.8, seed=7))]


@pytest.mark.parametrize("name,depth,sampling", CHAOS,
                         ids=[f"{n}-{d}{'-sampled' if s else ''}"
                              for n, d, s in CHAOS])
def test_chaos_kill_matches_jax(name, depth, sampling):
    """test_fault_tolerance.py:70, :101: replica 1 of 2 killed at tick 3.
    Nothing is shed, every request completes, the port's streams equal the
    JAX killed pool's and the port's unperturbed pool's, and the kill
    interrupted work (requests re-dispatched, replica 1 dead)."""
    model = models(name)
    jax_pool = _two_pool(JAX, model, _ecfg(JAX, depth, **sampling),
                         "kill@3:r1")
    port = _two_pool(PORT, model, _ecfg(PORT, depth, **sampling),
                     "kill@3:r1")
    base = _two_pool(PORT, model, _ecfg(PORT, depth, **sampling), None)
    assert not port.shed and set(port.results) == set(range(8))
    assert _generated(port) == _generated(base)
    assert _outcome(port) == _outcome(jax_pool)
    assert port.stats.faults_injected == 1
    assert port.stats.redispatched_requests > 0
    assert port.router.redispatched == port.stats.redispatched_requests
    assert not port.router.replicas[1].alive
    # the engine-side evacuation counters are the pool's
    dead = port.router.replicas[1].engine.stats
    assert dead.evacuated_requests == port.stats.redispatched_requests
    assert dead.evacuated_tokens == port.stats.redispatched_tokens
    # the killed engine's cache went with it, the live one's stays
    assert port.router.replicas[1].engine.cache is None
    assert port.router.replicas[0].engine.cache is not None


def test_virtual_clock_placement_ignores_host_time(monkeypatch):
    """On a virtual clock the port's pool reads no host time that could
    move a request: under a host clock whose steps take random times the
    killed pool's outcome is the same."""
    import random
    model = models("tiny-toy")
    want = _outcome(_two_pool(PORT, model, _ecfg(PORT, 1), "kill@3:r1"))
    rng, now = random.Random(3), [0.0]

    def jittery():
        now[0] += rng.expovariate(1.0)
        return now[0]
    monkeypatch.setattr(torch_pool_mod, "time", types.SimpleNamespace(
        perf_counter=jittery, sleep=time.sleep))
    assert _outcome(_two_pool(PORT, model, _ecfg(PORT, 1),
                              "kill@3:r1")) == want


# ---------------------------------------------------------------------------
# the scenarios of test_fault_tolerance.py:115-269, each run on either side
# ---------------------------------------------------------------------------
def _eos_checkpoint(side, model):
    """:115: committed EOS at kill time finishes at the checkpoint."""
    r = _req(side, 0, [1, 2, 3], 6, eos_id=9)
    r.output = [4, 9, 5]          # EOS committed, one §5.3 overshoot token
    r.state = side.State.DECODE
    folded = r.checkpoint_redispatch()
    return dict(folded=folded, state=r.state.value, generated=r.generated,
                prompt=r.prompt, max_new=r.max_new_tokens)


def _slo_backlog(side, model):
    """:131: a burst over a 30-token backlog cap is shed with "backlog"."""
    mk = _mk(side, model, _ecfg(side, 1))
    pool = side.Pool([mk(), mk()], side.PoolConfig(
        replicas=2, shed_backlog_tokens=30, slo_ttft_ms=500.0),
        virtual_dt=0.01)
    pool.run_ticked([(0, _req(side, i, range(3 + i, 19 + i), 6))
                     for i in range(12)], max_ticks=400)
    return _outcome(pool)


def _slo_ttft(side, model):
    """:157: a warm-up wave measures the service rate, then a flood is
    shed with "ttft_slo" and the admitted requests keep the SLO."""
    mk = _mk(side, model, _ecfg(side, 1))
    pool = side.Pool([mk(), mk()], side.PoolConfig(
        replicas=2, slo_ttft_ms=80.0, slo_safety=0.5), virtual_dt=0.01)
    pool.run_ticked([(0, _req(side, 100 + i, range(4, 12), 4))
                     for i in range(2)], max_ticks=100)
    flood = [(pool.tick_count, _req(side, i, range(3 + i, 19 + i), 6))
             for i in range(16)]
    pool.run_ticked(flood, max_ticks=pool.tick_count + 400)
    return _outcome(pool)


def _stall_retry(side, model):
    """:194: replica 0 stalls before its first step; its requests time
    out, back off and complete on replica 1."""
    mk = _mk(side, model, _ecfg(side, 0))
    pool = side.Pool([mk(), mk()], side.PoolConfig(
        replicas=2, request_timeout_s=0.05, retry_limit=3,
        backoff_base_s=0.01),
        fault_plan=side.FaultPlan.parse("stall@0:r0:10000"), virtual_dt=0.01)
    pool.run_ticked(_arrivals(side, 6, stagger=6), max_ticks=300)
    return _outcome(pool)


def _retry_limit(side, model):
    """:214: one replica stalled forever: the request cycles timeout,
    backoff, re-dispatch, then is shed with "retry_limit"."""
    pool = side.Pool([_mk(side, model, _ecfg(side, 0))()], side.PoolConfig(
        replicas=1, request_timeout_s=0.03, retry_limit=2,
        backoff_base_s=0.01),
        fault_plan=side.FaultPlan.parse("stall@0:r0:100000"), virtual_dt=0.01)
    pool.run_ticked([(0, _req(side, 0, [1, 2, 3, 4], 4))], max_ticks=300)
    return _outcome(pool)


def _join_leave(side, model):
    """:234: a replica joins at tick 2 and replica 0 leaves at tick 4:
    nothing is dropped."""
    return _outcome(_two_pool(side, model, _ecfg(side, 1),
                              "join@2,leave@4:r0"))


def _leave_last(side, model):
    """:252: the last replica is never drained."""
    pool = side.Pool([_mk(side, model, _ecfg(side, 0))()], side.PoolConfig())
    return dict(moved=pool.leave_replica(0), **_outcome(pool))


def _all_dead(side, model):
    """:259: with every replica dead the pool halts and sheds."""
    pool = side.Pool([_mk(side, model, _ecfg(side, 0))()], side.PoolConfig(),
                     virtual_dt=0.01)
    pool.fail_replica(0)
    ok = pool.submit(_req(side, 0, [1, 2], 2))
    return dict(ok=ok, **_outcome(pool))


SCENARIOS = {"eos-checkpoint": _eos_checkpoint, "slo-backlog": _slo_backlog,
             "slo-ttft": _slo_ttft, "stall-retry": _stall_retry,
             "retry-limit": _retry_limit, "join-leave": _join_leave,
             "leave-last": _leave_last, "all-dead": _all_dead}


def _port_holds(case: str, got: dict) -> None:
    """The JAX test's own assertions of each scenario, on the port."""
    if case == "eos-checkpoint":
        assert got["folded"] == 0 and got["state"] == "finished"
        assert got["generated"] == [4, 9] and got["prompt"] == [1, 2, 3, 4, 9]
        return
    snap, results, shed = got["snapshot"], got["results"], got["shed"]
    assert snap["ticks"] < 300
    assert len(results) + len(shed) == snap["submitted"]
    if case == "slo-backlog":
        assert shed and all(s[1] == "backlog" for s in shed)
        assert len(results) + len(shed) == 12
    elif case == "slo-ttft":
        flood_shed = [s for s in shed if s[0] < 100]
        assert flood_shed and all(s[1] == "ttft_slo" for s in flood_shed)
        ttft = [r[2] - r[1] for rid, r in results.items() if rid < 100]
        assert ttft and max(ttft) * 1e3 <= 80.0
        assert snap["slo_violations"] == 0
    elif case == "stall-retry":
        assert len(results) == 6 and not shed
        assert snap["timeouts"] > 0 and snap["retries"] > 0
        moved = [r for r in results.values() if r[5] > 0]
        assert moved and all(r[4] == 1 for r in moved)
    elif case == "retry-limit":
        assert shed == [(0, "retry_limit", 3, "rejected")]
    elif case == "join-leave":
        assert snap["joins"] == 1 and snap["leaves"] == 1
        assert not shed and set(results) == set(range(8))
        assert [r["alive"] for r in snap["replicas"]] == [False, True, True]
        assert got["elastic"]["data"] == 2
        assert got["elastic"]["failed_hosts"] == 0
    elif case == "leave-last":
        assert got["moved"] == [] and snap["replicas"][0]["alive"]
    elif case == "all-dead":
        assert got["halted"] and not got["ok"]
        assert shed == [(0, "pool_halted", 0, "rejected")]


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_pool_scenario_matches_jax(case):
    model = models("tiny-toy")
    want = SCENARIOS[case](JAX, model)
    got = SCENARIOS[case](PORT, model)
    assert got == want
    _port_holds(case, got)


def test_join_leave_is_token_exact():
    """:234: the join and the graceful leave change no token against the
    unperturbed pool."""
    model = models("tiny-toy")
    base = _two_pool(PORT, model, _ecfg(PORT, 1), None)
    moved = _two_pool(PORT, model, _ecfg(PORT, 1), "join@2,leave@4:r0")
    assert _generated(moved) == _generated(base)
    # the departed replica's cache went with it, the others' stay
    assert [h.engine.cache is None for h in moved.router.replicas] == [
        True, False, False]


def _snapshot_keys(snap: dict) -> tuple:
    return (sorted(snap), sorted(k for rep in snap["replicas"] for k in rep))


def test_snapshot_schemas_match_jax():
    """EngineStats, KVStats and ReplicaPool snapshots have exactly the JAX
    package's keys (the schema the CLI's lines and a benchmark read),
    and the engine's new counters read what JAX's read at tp=1."""
    model = models("tiny-toy")
    pools = [_two_pool(side, model, _ecfg(side, 0), "kill@3:r1", n=4)
             for side in SIDES]
    (jpool, tpool) = pools
    assert _snapshot_keys(tpool.snapshot()) == _snapshot_keys(
        jpool.snapshot())
    for jh, th in zip(jpool.router.replicas, tpool.router.replicas):
        jsnap, tsnap = jh.engine.stats.snapshot(), th.engine.stats.snapshot()
        assert sorted(tsnap) == sorted(jsnap)
        for key in ("tp_collective_bytes", "tp_collective_bytes_per_iter",
                    "kv_quant_drift", "evacuated_requests",
                    "evacuated_tokens"):
            assert tsnap[key] == jsnap[key], key
        assert sorted(th.engine.kv.stats.snapshot()) == sorted(
            jh.engine.kv.stats.snapshot())
    assert tpool.router.replicas[1].engine.stats.evacuated_requests > 0


def test_engine_backed_stats_count_inflight_tokens():
    """tests/test_router.py:116: at depth 1 a replica whose samples are in
    flight is busy to the router, and idle again once drained."""
    from repro_torch.serving.router import ReplicaHandle
    _, cfg, _, params = models("tiny-toy")
    eng = ServeEngine(cfg, params, EngineConfig(
        max_slots=2, max_len=32, kv_block_size=8, discrete_sizes=(8,),
        async_depth=1, async_harvest=False, avg_decode_len=4.0),
        device="cpu")
    handle = ReplicaHandle(0, eng)
    handle.submit(Request(rid=0, prompt=[1, 2, 3, 4, 5, 6, 7, 8],
                          max_new_tokens=4))
    for _ in range(8):
        plan = eng.scheduler.plan()
        if plan is None:
            break
        eng.step(plan)
        if handle.stats().inflight_tokens > 0:
            break
    st = handle.stats()
    assert st.inflight_tokens > 0
    assert st.backlog_tokens >= st.inflight_tokens
    eng.drain()
    assert handle.stats().inflight_tokens == 0


@pytest.mark.parametrize("drain", [False, True])
def test_evacuate_releases_the_engine(drain):
    """``evacuate`` on a mid-stream engine at depth 1: the failure path
    abandons the in-flight iteration unfetched (its samples are lost, the
    checkpoint keeps only committed tokens), the graceful path retires it
    first; both free every slot and KV block and leave the scheduler empty,
    and the live path clears the released slots' lengths on the device."""
    _, cfg, _, params = models("tiny-toy")
    eng = ServeEngine(cfg, params, _ecfg(PORT, 1), device="cpu")
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=list(range(5 + rid, 15 + rid)),
                           max_new_tokens=8))
    for _ in range(3):
        eng.step(eng.scheduler.plan())
    assert eng.in_flight == 1
    committed = {r.rid: list(r.output) for r in eng.scheduler.active}
    lens = eng.cache_len.clone()
    finished, moved = eng.evacuate(drain=drain)
    assert eng.in_flight == 0 and not finished
    assert sorted(r.rid for r in moved) == [0, 1, 2]
    for r in moved:
        assert r.state == State.WAITING and r.slot == -1 and r.inflight == 0
        assert r.generated == r.prompt[r.orig_prompt_len:]
        # the drained iteration commits one more sample per decoding request
        assert r.generated[:len(committed[r.rid])] == committed[r.rid]
        assert len(r.generated) == len(committed[r.rid]) + (
            drain and bool(committed[r.rid]))
    assert eng.stats.evacuated_requests == 3
    assert eng.stats.evacuated_tokens == sum(len(r.generated) for r in moved)
    assert sorted(eng.slot_free) == [0, 1, 2, 3]
    assert eng.kv.stats.device_pages_used == 0
    assert not eng.scheduler.active and not eng.scheduler.waiting
    assert bool(lens.any())
    assert bool((eng.cache_len == 0).all()) == drain
