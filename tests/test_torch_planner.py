"""The port's planner against the JAX package's: the config registry and
parameter counts, the §3 cost model (Eqs. 1-9, ``op_costs``, ``table2``),
the §4.3 pipeline builder, the §5.5 search and the nano-batch helpers.

The same calls go through ``repro.core.*`` and ``repro_torch.core.*``:
integers and strings must be equal, cost-model floats equal at rel 1e-12
and schedule times at rel 1e-9.  A call that raises (a model whose weights
leave no KV room gives a zero batch, and Eq. 8 divides by it) must raise
the same exception type in both.  Each grid is computed once per module
and package.

The port's list scheduler checks the unit and bandwidth budgets over a
node's whole run, JAX's at its start alone, which lets JAX's schedules
oversubscribe both (ROADMAP C6).  So the search is held to JAX's with
JAX's scheduler replaced by the port's, and the scheduler itself to JAX's
on every graph the grid schedules: the same placement wherever JAX's keeps
the budgets, and the budgets kept wherever it does not.  Then the
port-side properties of ``tests/test_costmodel.py`` and
``tests/test_nanobatch.py``: the paper's published numbers and the
schedules' budgets.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.configs import base as jax_configs
from repro.core import autosearch as jax_as
from repro.core import costmodel as jax_cm
from repro.core import nanobatch as jax_nb
from repro.core import pipeline as jax_pl
from repro.models import model as jax_model
from repro_torch.configs import base as configs
from repro_torch.core import autosearch as asrch
from repro_torch.core import costmodel as cm
from repro_torch.core import nanobatch as nb
from repro_torch.core import pipeline as pl
from repro_torch.models import model

CONFIGS = configs.list_configs()
N_DEVS = (1, 8, 256)
SCHED_HW = ("TPUv5e", "A100-80G", "H100")
SCHED_WORKLOADS = (("sharegpt", None), ("const", (512, 1024)))
SCHED_N_DEVS = (1, 8)
COST_REL = 1e-12
SCHED_REL = 1e-9


def _try(fn):
    try:
        return fn()
    except ArithmeticError as e:          # a zero batch: Eq. 8 divides by it
        return ("raises", type(e).__name__)


def _eqs(m, ms, hw, w, n):
    return {name: _try(lambda f=f: f(hw, ms, w, n)) for name, f in (
        ("e_kv", lambda hw, ms, w, n: m.e_kv(hw, ms, n)),
        ("b_req", m.b_req), ("b_dense", m.b_dense),
        ("t_mem", lambda hw, ms, w, n: m.t_mem(hw)),
        ("t_compute", m.t_compute), ("t_net", m.t_net), ("t_r", m.t_r),
        ("classify", m.classify),
        ("optimal_throughput",
         lambda hw, ms, w, n: m.optimal_throughput(hw, ms, n)))}


def _op_rows(m, cfg, hw, w, n):
    return [(c.name, c.kind, c.flops, c.mem_bytes, c.net_bytes,
             c.times(hw, n), c.bound(hw, n))
            for c in m.op_costs(cfg, w, hw, n)]


def _cost_grid(m, get_config, name):
    cfg = get_config(name)
    ms = m.model_stats(cfg)
    out = {}
    for hwn, hw in m.HARDWARE.items():
        for wn, w in m.WORKLOADS.items():
            for n in N_DEVS:
                out[(hwn, wn, n)] = (
                    _eqs(m, ms, hw, w, n),
                    _try(lambda: _op_rows(m, cfg, hw, w, n)),
                    _try(lambda: m.table2(cfg, w, hw, n)))
    return out


def _schedule(s):
    return dict(nano_kqv=s.nano_kqv, nano_dense=s.nano_dense,
                critical_path=s.critical_path,
                unit_assignment=s.unit_assignment, iter_time=s.iter_time,
                compute_busy=s.compute_busy,
                nodes={k: (n.kind, n.nano, n.work, n.deps, n.units, n.start,
                           n.end) for k, n in s.pipeline.nodes.items()})


def _sched_grid(m, a, get_config, name):
    """(autosearch, sequential, sequential at nano_split 4, throughput
    estimate) per cell, or the exception a zero batch raises."""
    cfg = get_config(name)
    out = {}
    for hwn in SCHED_HW:
        hw = m.HARDWARE[hwn]
        for wn, pd in SCHED_WORKLOADS:
            w = m.WORKLOADS[wn] if pd is None else m.Workload(*pd)
            for n in SCHED_N_DEVS:
                def run():
                    best = a.autosearch(cfg, w, hw, n)
                    return (best, a.sequential_schedule(cfg, w, hw, n),
                            a.sequential_schedule(cfg, w, hw, n,
                                                  nano_split=4),
                            _try(lambda: a.throughput_estimate(
                                cfg, best, w, hw, n)))
                out[(hwn, wn, n)] = _try(run)
    return out


def _sched_view(cell):
    if isinstance(cell, tuple) and cell[0] == "raises":
        return cell
    return [_schedule(s) for s in cell[:3]] + [cell[3]]


def _assert_close(got, want, rel, where=()):
    """Equal structure; ints, strings and bools equal; floats at ``rel``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            _assert_close(got[k], want[k], rel, where + (k,))
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            (where, got, want)
        for i, (g, x) in enumerate(zip(got, want)):
            _assert_close(g, x, rel, where + (i,))
    elif isinstance(want, float):
        assert isinstance(got, float) and math.isclose(
            got, want, rel_tol=rel, abs_tol=0.0), (where, got, want)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


@pytest.fixture(scope="module")
def jax_costs():
    # JAX's model_stats recounts the parameters in every call: count each
    # config once (the counts themselves are held by the test above)
    with pytest.MonkeyPatch.context() as mp:
        for fn in ("num_params", "active_params"):
            mp.setattr(jax_model, fn, functools.cache(getattr(jax_model, fn)))
        return {n: _cost_grid(jax_cm, jax_configs.get_config, n)
                for n in jax_configs.list_configs()}


@pytest.fixture(scope="module")
def port_costs():
    return {}               # filled per config by the test that needs it


@pytest.fixture(scope="module")
def jax_schedules():
    """JAX's search with its list scheduler replaced by the port's (C6)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_as, "_schedule_times", asrch._schedule_times)
        return {n: [_sched_view(c) for c in _sched_grid(
                    jax_cm, jax_as, jax_configs.get_config, n).values()]
                for n in jax_configs.list_configs()}


@pytest.fixture(scope="module")
def port_schedules():
    return {}


# ---------------------------------------------------------------------------
# the registry and the parameter counts
# ---------------------------------------------------------------------------
def test_list_configs_matches_jax():
    assert configs.list_configs() == jax_configs.list_configs()


@pytest.mark.parametrize("name", CONFIGS)
def test_param_counts_match_jax(name):
    cfg, jcfg = configs.get_config(name), jax_configs.get_config(name)
    assert model.num_params(cfg) == jax_model.num_params(jcfg)
    assert model.active_params(cfg) == jax_model.active_params(jcfg)
    assert model.active_params(cfg) <= model.num_params(cfg)


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("name", CONFIGS)
def test_model_stats_match_jax(name, kv_dtype):
    import dataclasses
    got = cm.model_stats(configs.get_config(name), kv_dtype)
    want = jax_cm.model_stats(jax_configs.get_config(name), kv_dtype)
    _assert_close(dataclasses.asdict(got), dataclasses.asdict(want),
                  COST_REL)


def test_tables_match_jax():
    for table in ("HARDWARE", "WORKLOADS"):
        got, want = getattr(cm, table), getattr(jax_cm, table)
        assert {k: vars(v) for k, v in got.items()} == \
            {k: vars(v) for k, v in want.items()}
    assert cm.H100 is cm.HARDWARE["H100"]
    assert vars(cm.TPU_V5E) == vars(jax_cm.TPU_V5E)
    assert vars(cm.A100_80G) == vars(jax_cm.A100_80G)
    for hw in cm.HARDWARE.values():
        j = jax_cm.HARDWARE[hw.name]
        assert (hw.ratio, hw.net_bw_oneway) == (j.ratio, j.net_bw_oneway)


@pytest.mark.parametrize("part", ["eqs", "op_costs", "table2"])
@pytest.mark.parametrize("name", CONFIGS)
def test_cost_model_matches_jax(name, part, jax_costs, port_costs):
    """Every HARDWARE entry x every WORKLOADS entry x n_dev 1, 8, 256."""
    i = ("eqs", "op_costs", "table2").index(part)
    if name not in port_costs:
        port_costs[name] = _cost_grid(cm, configs.get_config, name)
    got = port_costs[name]
    assert got.keys() == jax_costs[name].keys()
    for key, want in jax_costs[name].items():
        _assert_close(got[key][i], want[i], COST_REL, (name, part) + key)


def test_op_costs_int8_and_bdense_match_jax():
    for name in ("llama2-70b", "deepseek-v2-236b", "jamba-1.5-large-398b"):
        cfg, jcfg = configs.get_config(name), jax_configs.get_config(name)
        for bd in (None, 256.0, 2048.0):
            for kv in (None, "int8"):
                w = cm.Workload(512, 1024)
                got = cm.table2(cfg, w, cm.A100_80G, 8, bd, kv)
                want = jax_cm.table2(jcfg, jax_cm.Workload(512, 1024),
                                     jax_cm.A100_80G, 8, bd, kv)
                _assert_close(got, want, COST_REL, (name, bd, kv))


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------
def _port_grid(port_schedules, name):
    if name not in port_schedules:
        port_schedules[name] = _sched_grid(cm, asrch, configs.get_config,
                                           name)
    return port_schedules[name]


@pytest.mark.parametrize("name", CONFIGS)
def test_schedules_match_jax(name, jax_schedules, port_schedules):
    """autosearch, sequential_schedule (nano_split 1 and 4) and
    throughput_estimate over {TPUv5e, A100-80G, H100} x two workloads x
    n_dev 1, 8: equal nano counts, critical paths and unit assignments,
    times at rel 1e-9; every schedule keeps both budgets."""
    got = _port_grid(port_schedules, name)
    assert len(got) == len(jax_schedules[name])
    for key, cell, want in zip(got, got.values(), jax_schedules[name]):
        _assert_close(_sched_view(cell), want, SCHED_REL, (name,) + key)
        if not isinstance(cell[0], str):
            for sched in cell[:3]:
                assert _worst_load(sched.pipeline) <= 1.0 + 1e-6, key


def _copy(mod, pipe):
    """A fresh graph of ``mod``'s nodes with ``pipe``'s works and units."""
    return mod.Pipeline(nodes={k: mod.OpNode(n.name, n.kind, n.nano, n.work,
                                             n.deps, n.units)
                               for k, n in pipe.nodes.items()},
                        nano_kqv=pipe.nano_kqv, nano_dense=pipe.nano_dense)


@pytest.mark.parametrize("name", CONFIGS)
def test_list_scheduler_matches_jax_where_jax_keeps_the_budgets(
        name, port_schedules):
    """Each graph of the grid, units as searched, through both list
    schedulers: where JAX's placement keeps the unit and bandwidth budgets
    at every event the port's places every node alike; where it does not,
    the port's keeps them."""
    for key, cell in _port_grid(port_schedules, name).items():
        if isinstance(cell[0], str):
            continue
        for sched in cell[:3]:
            mine, ref = _copy(pl, sched.pipeline), _copy(jax_pl,
                                                         sched.pipeline)
            t, t_ref = asrch._schedule_times(mine), jax_as._schedule_times(ref)
            if _worst_load(ref) <= 1.0 + 1e-9:
                assert t == t_ref, key
                assert [(n.start, n.end) for n in mine.nodes.values()] == \
                    [(n.start, n.end) for n in ref.nodes.values()], key
            else:
                assert _worst_load(mine) <= 1.0 + 1e-9, key


def test_jax_scheduler_oversubscribes_where_the_port_does_not():
    """C6 on the card's own entry: LLaMA-2-70B on 8 x H100 at the paper's
    Workload(512, 1024).  JAX's schedule runs 1.325 of the units at once;
    the port's keeps both budgets and takes longer."""
    w = cm.Workload(512, 1024)
    ref = jax_as.autosearch(jax_configs.get_config("llama2-70b"),
                            jax_cm.Workload(512, 1024),
                            jax_cm.HARDWARE["H100"], 8)
    got = asrch.autosearch(configs.get_config("llama2-70b"), w, cm.H100, 8)
    assert _worst_load(ref.pipeline) > 1.3
    assert _worst_load(got.pipeline) <= 1.0 + 1e-9
    assert got.iter_time > ref.iter_time


def test_profiles_from_costs_match_jax():
    for name in ("qwen3-8b", "deepseek-v2-236b", "xlstm-1.3b"):
        got = asrch._profiles_from_costs(configs.get_config(name),
                                         cm.Workload(215, 32), cm.H100, 1,
                                         bdense=256)
        want = jax_as._profiles_from_costs(jax_configs.get_config(name),
                                           jax_cm.Workload(215, 32),
                                           jax_cm.HARDWARE["H100"], 1,
                                           bdense=256)
        _assert_close(got, want, COST_REL, (name,))


def test_port_defaults_are_one_h100():
    """The port's defaults are the card it runs on (JAX's: v5e x 256)."""
    cfg = configs.get_config("qwen3-8b")
    w = cm.Workload(512, 1024)
    _assert_close(_schedule(asrch.autosearch(cfg, w)),
                  _schedule(asrch.autosearch(cfg, w, cm.H100, 1)), 0.0)
    s = asrch.sequential_schedule(cfg, w)
    assert asrch.throughput_estimate(cfg, s, w) == \
        asrch.throughput_estimate(cfg, s, w, cm.H100, 1)


# ---------------------------------------------------------------------------
# the pipeline builder
# ---------------------------------------------------------------------------
PROFILE = {"KQV": ("compute", 1.0), "GEMV": ("memory", 2.0),
           "PF": ("compute", 0.2), "O": ("compute", 0.8),
           "UGD": ("compute", 3.0), "AG": ("network", 0.5),
           "AR": ("network", 1.0)}


def _pipe(p):
    return [(n.name, n.kind, n.nano, n.work, n.deps, n.units, n.start, n.end)
            for n in p.topo_order()], p.critical_path(), \
        (p.nano_kqv, p.nano_dense)


@pytest.mark.parametrize("nano_kqv", [2, 4])
@pytest.mark.parametrize("decode_attn", [True, False])
@pytest.mark.parametrize("network", [True, False])
def test_pipeline_builder_matches_jax(network, decode_attn, nano_kqv,
                                      monkeypatch):
    kw = dict(has_network=network, has_decode_attn=decode_attn)
    got = pl.build_nanoflow_pipeline(PROFILE, nano_kqv=nano_kqv, **kw)
    want = jax_pl.build_nanoflow_pipeline(PROFILE, nano_kqv=nano_kqv, **kw)
    _assert_close(_pipe(got), _pipe(want), 0.0)
    # the greedy unit search on the same graph, JAX's on the port's list
    # scheduler (C6)
    monkeypatch.setattr(jax_as, "_schedule_times", asrch._schedule_times)
    assert asrch._greedy_units(got) == jax_as._greedy_units(want)
    _assert_close(_pipe(got), _pipe(want), 0.0)
    monkeypatch.undo()
    assert asrch._compute_busy(got, 1.0) == jax_as._compute_busy(want, 1.0)
    seq, jseq = (pl.sequential_pipeline(PROFILE, **kw),
                 jax_pl.sequential_pipeline(PROFILE, **kw))
    assert asrch._schedule_times(seq) == jax_as._schedule_times(jseq)
    _assert_close(_pipe(seq), _pipe(jseq), 0.0)


def test_schedule_profiles_is_autosearch_on_measured_times():
    """The measured-profile interface: on the cost model's own profiles it
    gives autosearch's schedule (or the sequential one where that wins)."""
    cfg, w = configs.get_config("qwen3-8b"), cm.Workload(215, 32)
    prof = asrch._profiles_from_costs(cfg, w, cm.H100, 1, bdense=256)
    best = asrch.schedule_profiles(prof, has_network=False)
    seq = asrch.sequential_profiles(prof, has_network=False)
    want = asrch.autosearch(cfg, w, cm.H100, 1, bdense=256)
    _assert_close(_schedule(min(best, seq, key=lambda s: s.iter_time)),
                  _schedule(want), 0.0)


# ---------------------------------------------------------------------------
# the nano-batch helpers
# ---------------------------------------------------------------------------
def test_even_plans_match_jax():
    for total in range(0, 70):
        for n in range(1, 9):
            assert nb.NanoBatchPlan.even(total, n).sizes == \
                jax_nb.NanoBatchPlan.even(total, n).sizes


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("rows,n", [(1, 1), (7, 3), (33, 4), (64, 6)])
def test_split_merge_interleave_match_jax(rows, n, axis):
    rng = np.random.default_rng(rows * 10 + n)
    x = rng.normal(size=(rows, 8) if axis == 0 else (8, rows)) \
        .astype(np.float32)
    w1 = rng.normal(size=(8, 8)).astype(np.float32)
    plan, jplan = nb.NanoBatchPlan.even(rows, n), \
        jax_nb.NanoBatchPlan.even(rows, n)
    parts = nb.split(torch.from_numpy(x), plan, axis)
    jparts = jax_nb.split(jnp.asarray(x), jplan, axis)
    assert [tuple(p.shape) for p in parts] == [p.shape for p in jparts]
    for p, q in zip(parts, jparts):
        np.testing.assert_array_equal(p.numpy(), np.asarray(q))
    np.testing.assert_array_equal(nb.merge(parts, axis).numpy(), x)
    tw, jw = torch.from_numpy(w1), jnp.asarray(w1)
    if axis == 0:
        com, jcom = (lambda c: torch.tanh(c @ tw)), (lambda c: jnp.tanh(c @ jw))
    else:
        com, jcom = (lambda c: torch.tanh(tw @ c)), (lambda c: jnp.tanh(jw @ c))
    got = nb.interleaved_apply(com, lambda c: c * 2.0 + 1.0,
                               torch.from_numpy(x), plan, axis)
    # jitted stages: one compile per chunk shape instead of one per op
    want = jax_nb.interleaved_apply(jax.jit(jcom),
                                    jax.jit(lambda c: c * 2.0 + 1.0),
                                    jnp.asarray(x), jplan, axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@given(total=st.integers(1, 512), n=st.integers(1, 8))
@settings(max_examples=50, deadline=None)
def test_even_plan_partitions(total, n):
    plan = nb.NanoBatchPlan.even(total, n)
    assert sum(plan.sizes) == total
    assert all(s > 0 for s in plan.sizes)
    assert len(plan.sizes) <= n


@given(rows=st.integers(2, 64), n=st.integers(1, 4))
@settings(max_examples=25, deadline=None)
def test_interleaved_apply_semantics_preserving(rows, n):
    """Figure-6 interleave == unsplit compute∘network composition."""
    w1 = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 8))
                          .astype(np.float32))
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(rows, 8))
                         .astype(np.float32))
    com = lambda c: torch.tanh(c @ w1)      # noqa: E731
    net = lambda c: c * 2.0 + 1.0           # noqa: E731
    out = nb.interleaved_apply(com, net, x, nb.NanoBatchPlan.even(rows, n))
    np.testing.assert_allclose(out.numpy(), net(com(x)).numpy(), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# port-side properties: the paper's numbers and the schedules' budgets
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def llama70b():
    return cm.model_stats(configs.get_config("llama2-70b"))


def _table2_paper():
    return cm.table2(configs.get_config("llama2-70b"), cm.Workload(512, 1024),
                     cm.A100_80G, 8, bdense=2048)


def test_paper_table2_gemm_and_net_rows():
    rows = {r["op"]: r for r in _table2_paper()}
    for op, gflops in (("GEMM-KQV", 27487.8), ("GEMM-O", 21990.2),
                       ("GEMM-UG", 153931.6), ("GEMM-D", 76965.8)):
        assert abs(rows[op]["gflops"] - gflops) < 1.0, op
    assert abs(sum(r["net_gb"] for r in rows.values()) - 75.2) < 1.0
    assert abs(sum(r["t_net_ms"] for r in rows.values()) - 31.33) < 1.0


def test_paper_eq9_and_classification(llama70b):
    assert 67e9 < llama70b.p_model < 70e9
    opt = cm.optimal_throughput(cm.A100_80G, llama70b, 8)
    assert abs(opt - 17828) / 17828 < 0.05
    for w in ("splitwise", "lmsys", "sharegpt"):
        assert cm.classify(cm.A100_80G, llama70b, cm.WORKLOADS[w], 8) == \
            "compute-bound"


def test_nanoflow_beats_sequential():
    """Overlap wins on the paper's setting, by less than JAX's 1.20x: JAX's
    schedule oversubscribes the units (C6); within both budgets the model
    gives 1.014x."""
    cfg, w = configs.get_config("llama2-70b"), cm.Workload(512, 1024)
    nano = asrch.autosearch(cfg, w, cm.A100_80G, 8, bdense=2048)
    seq = asrch.sequential_schedule(cfg, w, cm.A100_80G, 8, bdense=2048)
    assert 1.0 < seq.iter_time / nano.iter_time < 2.5
    assert _worst_load(nano.pipeline) <= 1.0 + 1e-9


def test_int8_doubles_kv_capacity():
    cfg = configs.get_config("llama2-70b")
    ms_bf, ms_i8 = cm.model_stats(cfg), cm.model_stats(cfg, "int8")
    assert ms_i8.kv_per_token == ms_bf.kv_per_token
    assert ms_i8.kv_bytes_per_elem < 0.52 * ms_bf.kv_bytes_per_elem
    assert cm.e_kv(cm.A100_80G, ms_i8, 8) >= \
        1.9 * cm.e_kv(cm.A100_80G, ms_bf, 8)


def _worst_load(pipe):
    """The largest unit share, or per-kind rate, in flight at any event."""
    nodes = list(pipe.nodes.values())
    worst = 0.0
    for t0 in sorted({n.start for n in nodes} | {n.end for n in nodes}):
        live = [n for n in nodes if n.start <= t0 < n.end]
        worst = max(worst, sum(n.units for n in live), *(
            sum(asrch.efficiency(n.kind, n.units) for n in live
                if n.kind == kind)
            for kind in ("compute", "memory", "network")))
    return worst


@pytest.mark.parametrize("bdense", [None, 2048.0])
@pytest.mark.parametrize("name,n_dev", [
    ("qwen3-8b", 1), ("llama2-70b", 8), ("arctic-480b", 8),
    ("deepseek-v2-236b", 8)])
def test_autosearch_budgets_on_h100(name, n_dev, bdense):
    """chip_smoke's planner cases: each unit and per-kind bandwidth budget
    holds at every event, overlap never loses to sequential, and the
    modelled throughput stays under Eq. 9 (Arctic's bf16 weights, 954 GB,
    leave 8 cards no KV room: its own dense batch is 0 tokens)."""
    cfg, w = configs.get_config(name), cm.Workload(512, 1024)
    sched = asrch.autosearch(cfg, w, cm.H100, n_dev, bdense=bdense)
    assert _worst_load(sched.pipeline) <= 1.0 + 1e-9
    seq = asrch.sequential_schedule(cfg, w, cm.H100, n_dev, bdense=bdense)
    assert sched.iter_time <= seq.iter_time
    opt = cm.optimal_throughput(cm.H100, cm.model_stats(cfg), n_dev) / n_dev
    tp = asrch.throughput_estimate(cfg, sched, w, cm.H100, n_dev, bdense)
    assert 0 <= tp <= opt
    assert tp > 0 or (bdense is None and name == "arctic-480b")


@given(p=st.floats(16, 4096), d=st.floats(1, 2000), n=st.integers(2, 64))
@settings(max_examples=20, deadline=None)
def test_schedule_between_bottleneck_and_sequential(p, d, n):
    cfg = configs.get_config("qwen3-8b")
    w = cm.Workload(p, d)
    nano = asrch.autosearch(cfg, w, cm.TPU_V5E, n, bdense=2048)
    seq = asrch.sequential_schedule(cfg, w, cm.TPU_V5E, n, bdense=2048)
    assert nano.iter_time <= seq.iter_time * 1.001
    per_kind = {}
    for node in nano.pipeline.nodes.values():
        per_kind[node.kind] = per_kind.get(node.kind, 0.0) + node.work
    assert nano.iter_time >= max(per_kind.values()) * 0.999
    assert _worst_load(nano.pipeline) <= 1.0 + 1e-9
