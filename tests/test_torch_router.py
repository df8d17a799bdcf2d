"""The port's router, fault plans and elastic state machine against the
JAX package's, on the host: ``FaultPlan.parse`` over spec strings and
``FaultPlan.seeded`` over seeds (hypothesis), ``ElasticManager`` decisions
and ``StragglerMitigator`` shares over random event sequences, and
``Router`` placements over random sequences of submits, failures, joins
and step-time observations, with engine-less replica handles.  Each
outcome must equal the JAX package's, exceptions included."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import pytest

from _hyp import given, settings, st
from repro.distributed import elastic as jax_elastic
from repro.serving import faults as jax_faults
from repro.serving import router as jax_router
from repro.serving.request import Request as JaxRequest
from repro_torch.distributed import elastic
from repro_torch.serving import faults, router
from repro_torch.serving.request import Request

SIDES = ((jax_faults, jax_elastic, jax_router, JaxRequest),
         (faults, elastic, router, Request))


def _outcome(fn):
    """``fn()``'s value, or its exception's type name (raising is part of
    the behaviour being compared)."""
    try:
        return fn()
    except Exception as e:      # noqa: BLE001 - compared, not handled
        return type(e).__name__


def _events(plan):
    return [(e.tick, e.kind, e.replica, e.arg) for e in plan.events]


# ---- FaultPlan ---------------------------------------------------------------
_KIND = st.sampled_from(("kill", "stall", "degrade", "join", "leave",
                         "explode", ""))
_FIELD = st.one_of(st.integers(-3, 40).map(str),
                   st.integers(0, 4).map(lambda r: f"r{r}"),
                   st.sampled_from(("", "r", "x", " r1 ")))
_PART = st.tuples(_KIND, st.sampled_from(("@", "")),
                  st.lists(_FIELD, min_size=0, max_size=3)).map(
    lambda t: f"{t[0]}{t[1]}{':'.join(t[2])}")
SPECS = st.lists(_PART, min_size=0, max_size=5).map(", ".join)


def _parsed(mod, spec):
    plan = mod.FaultPlan.parse(spec)
    fired = [[(e.tick, e.kind) for e in plan.due(t)] for t in (0, 5, 40)]
    return _events(plan), plan.describe(), len(plan), bool(plan), fired


@settings(max_examples=300, deadline=None)
@given(SPECS)
def test_fault_plan_parse_matches_jax(spec):
    """Events, ``describe``, ``due`` (each event once) and the errors of
    malformed specs, as JAX's."""
    want, got = (_outcome(lambda m=m: _parsed(m, spec))
                 for m, *_ in SIDES)
    assert got == want, spec


def test_fault_plan_parse_roundtrip():
    """test_fault_tolerance.py:305 on the port."""
    plan = faults.FaultPlan.parse("kill@40:r1, stall@10:r0:20, "
                                  "degrade@5:r1:3,join@60, leave@80:r0")
    assert len(plan) == 5
    assert plan.events[0] == faults.FaultEvent(tick=5, kind="degrade",
                                               replica=1, arg=3)
    assert faults.FaultPlan.parse(plan.describe()).events == plan.events
    assert [e.kind for e in plan.due(10)] == ["degrade", "stall"]
    assert plan.due(10) == []
    with pytest.raises(ValueError):
        faults.FaultPlan.parse("explode@3:r0")


@settings(max_examples=100, deadline=None)
@given(st.integers(0, 2**32), st.integers(0, 8), st.integers(0, 100),
       st.integers(0, 5),
       st.lists(st.sampled_from(faults.KINDS), min_size=1, max_size=5,
                unique=True).map(tuple))
def test_fault_plan_seeded_matches_jax(seed, n, horizon, replicas, kinds):
    want, got = (_outcome(lambda m=m: _events(m.FaultPlan.seeded(
        seed, n, horizon, replicas, kinds))) for m, *_ in SIDES)
    assert got == want


# ---- ElasticManager and StragglerMitigator ------------------------------------
_ELASTIC_OPS = st.lists(st.one_of(
    st.tuples(st.just("failure"), st.sampled_from(("data", "model")),
              st.integers(1, 3)),
    st.tuples(st.just("leave"), st.integers(1, 3)),
    st.tuples(st.just("capacity"), st.integers(1, 3))), max_size=12)


def _elastic_run(mod, data, model, pods, min_data, ops):
    mgr = mod.ElasticManager(mod.ClusterState(data, model, pods), min_data)
    out = []
    for op, *args in ops:
        d = {"failure": mgr.on_failure, "leave": mgr.on_leave,
             "capacity": mgr.on_capacity}[op](*args)
        s = mgr.state
        out.append((d.action, d.reason, d.new_state.data, d.new_state.pods,
                    d.new_state.failed_hosts, s.data, s.model, s.pods,
                    s.failed_hosts, s.n_devices,
                    mod.per_replica_batch(64, s)
                    if s.pods * s.data else None))
    return out


@settings(max_examples=150, deadline=None)
@given(st.integers(1, 6), st.integers(1, 4), st.integers(1, 3),
       st.integers(1, 3), _ELASTIC_OPS)
def test_elastic_decisions_match_jax(data, model, pods, min_data, ops):
    want, got = (_elastic_run(m, data, model, pods, min_data, ops)
                 for _, m, *_ in SIDES)
    assert got == want


def test_elastic_decisions():
    """test_fault_tolerance.py:272-302 on the port."""
    mgr = elastic.ElasticManager(elastic.ClusterState(data=4, model=2))
    d = mgr.on_failure("data", 1)
    assert d.action == "rescale" and mgr.state.data == 3
    assert mgr.state.failed_hosts == 1
    floor = elastic.ElasticManager(elastic.ClusterState(2, 1), min_data=2)
    assert floor.on_failure("data", 1).action == "halt"
    assert floor.state.data == 2
    pods = elastic.ElasticManager(elastic.ClusterState(2, 4, pods=3))
    assert pods.on_failure("model", 1).new_state.pods == 2
    solo = elastic.ElasticManager(elastic.ClusterState(2, 4, pods=1))
    d = solo.on_failure("model", 1)
    assert d.action == "halt" and "TP shard" in d.reason
    leave = elastic.ElasticManager(elastic.ClusterState(3, 2), min_data=2)
    assert leave.on_leave(1).action == "rescale"
    assert leave.state.failed_hosts == 0
    assert leave.on_leave(1).action == "halt" and leave.state.data == 2
    up = elastic.ElasticManager(elastic.ClusterState(2, 2))
    assert up.on_capacity(2).action == "rescale" and up.state.data == 4


_TIMES = st.floats(1e-4, 10.0, allow_nan=False)


@settings(max_examples=100, deadline=None)
@given(st.integers(1, 6).flatmap(lambda n: st.tuples(
    st.just(n), st.lists(st.lists(_TIMES, min_size=n, max_size=n),
                         max_size=5))),
    st.floats(0.05, 1.0), st.integers(1, 512), st.sampled_from((1, 8)))
def test_straggler_shares_match_jax(hosts_obs, alpha, batch, multiple):
    n, observations = hosts_obs

    def shares(mod):
        sm = mod.StragglerMitigator(n, alpha=alpha)
        out = [sm.shares()]
        for times in observations:
            sm.observe(times)
            out.append((sm.shares(), sm.split_batch(batch, multiple)))
        return out
    want, got = (shares(m) for _, m, *_ in SIDES)
    assert got == want


# ---- Router -----------------------------------------------------------------
_ROUTER_OPS = st.lists(st.one_of(
    st.tuples(st.just("submit"), st.integers(1, 64),
              st.one_of(st.none(), st.integers(0, 3))),
    st.tuples(st.just("fail"), st.integers(0, 5)),
    st.tuples(st.just("add")),
    st.tuples(st.just("observe"), st.lists(_TIMES, min_size=6, max_size=6)),
    st.tuples(st.just("suspect"), st.integers(0, 5), st.booleans()),
    st.tuples(st.just("flush"))), max_size=40)


def _router_run(mods, n, affinity, ops):
    """Apply ``ops`` to a router of ``n`` engine-less handles; record each
    op's outcome and, after it, every replica's assigned rids and the
    pending queue."""
    _, _, rmod, req_cls = mods
    rt = rmod.Router([rmod.ReplicaHandle(i) for i in range(n)],
                     straggler_alpha=0.5, affinity=affinity)
    out, rid = [], 0
    for op, *args in ops:
        if op == "submit":
            plen, session = args
            req = req_cls(rid=rid, prompt=list(range(plen)),
                          max_new_tokens=4, session=session)
            rid += 1
            res = _outcome(lambda: rt.submit(req))
        elif op == "fail":
            res = _outcome(lambda: [r.rid for r in rt.mark_failed(
                args[0] % len(rt.replicas))])
        elif op == "add":
            res = rt.add_replica(rmod.ReplicaHandle(len(rt.replicas)))
        elif op == "observe":
            res = rt.observe_step_times(
                [args[0][i % 6] for i in range(len(rt.replicas))])
        elif op == "suspect":
            rt.replicas[args[0] % len(rt.replicas)].suspect = args[1]
            res = None
        else:
            res = [r.rid for r in rt.flush_pending()]
        out.append((op, res, [sorted(h.assigned) for h in rt.replicas],
                    [r.rid for r in rt.pending], rt.n_alive, rt.dispatched,
                    rt.redispatched))
    return out


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 4), st.booleans(), _ROUTER_OPS)
def test_router_placements_match_jax(n, affinity, ops):
    want, got = (_router_run(m, n, affinity, ops) for m in SIDES)
    assert got == want


def _reqs(n, plen=32):
    return [Request(rid=i, prompt=list(range(plen)), max_new_tokens=8)
            for i in range(n)]


def test_router_behaviours():
    """tests/test_router.py's cases on the port: balance, straggler skew,
    failure re-dispatch exactly once, parking with no live replica, session
    affinity until failure."""
    rt = router.Router([router.ReplicaHandle(i) for i in range(4)])
    counts = [0] * 4
    for r in _reqs(40):
        counts[rt.submit(r)] += 1
    assert max(counts) - min(counts) <= 2
    slow = router.Router([router.ReplicaHandle(i) for i in range(4)],
                         straggler_alpha=1.0)
    slow.observe_step_times([1.0, 1.0, 1.0, 3.0])
    counts = [0] * 4
    for r in _reqs(60):
        counts[slow.submit(r)] += 1
    assert counts[3] == min(counts) and counts[3] < 15
    rt = router.Router([router.ReplicaHandle(i) for i in range(3)])
    for r in _reqs(12):
        rt.submit(r)
    moved = rt.mark_failed(1)
    assert len(moved) == len({r.rid for r in moved}) > 0
    assert rt.mark_failed(1) == [] and rt.redispatched == len(moved)
    assert sum(len(h.assigned) for h in rt.replicas if h.alive) == 12
    assert all(rt.submit(r) != 1 for r in _reqs(20))
    solo = router.Router([router.ReplicaHandle(0)])
    for r in _reqs(5):
        solo.submit(r)
    assert len(solo.mark_failed(0)) == len(solo.pending) == 5
    with pytest.raises(router.NoLiveReplicas):
        solo.submit(_reqs(1)[0])
    solo.add_replica(router.ReplicaHandle(1))
    assert not solo.pending and len(solo.replicas[1].assigned) == 5
    rt = router.Router([router.ReplicaHandle(i) for i in range(3)])
    first = rt.submit(Request(rid=0, prompt=[1] * 8, max_new_tokens=2,
                              session=42))
    for r in _reqs(9):
        rt.submit(r)
    assert rt.submit(Request(rid=100, prompt=[1] * 8, max_new_tokens=2,
                             session=42)) == first
    rt.mark_failed(first)
    assert rt.submit(Request(rid=101, prompt=[1] * 8, max_new_tokens=2,
                             session=42)) != first
