"""NanoFlow §5.5: automatic parameter search (port of
``repro.core.autosearch``, the same names and arithmetic).

Topological sort -> critical path -> greedy unit re-assignment, iterated over
nano-batch size combinations, exactly as the paper describes.  A node's
``units`` is its share of the device's execution units: on the H100 the
share of SMs (CTAs) it runs on, which is what the fused GEMM + decode
attention op's ``gemm_fraction`` sets.

Non-linearity (paper Fig. 7): an op at unit share u runs at relative
efficiency eff(u) = min(1, u / u_sat), u_sat per resource kind — network
kernels saturate at ~32% of units reaching ~92% throughput; memory streams
saturate around 60%; compute is linear to 100%.

``autosearch`` consumes *offline profiles* from the analytical cost model;
``schedule_profiles`` and ``sequential_profiles`` take any profiles, so the
same search runs on measured op times (``chip_smoke.py``'s planner phase
feeds it the card's).

The defaults differ from the JAX package's (``cm.TPU_V5E``, 256 devices):
here ``hw`` defaults to ``cm.H100`` and ``n_dev`` to 1, the card the port
runs on.  Host arithmetic only.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

from repro_torch.core import costmodel as cm
from repro_torch.core.pipeline import (COMPUTE, MEMORY, NETWORK, OpNode,
                                       Pipeline, build_nanoflow_pipeline,
                                       sequential_pipeline)

# resource-share saturation points (paper Fig. 7 shape)
U_SAT = {COMPUTE: 1.0, MEMORY: 0.6, NETWORK: 0.32}


def efficiency(kind: str, units: float) -> float:
    return min(1.0, units / U_SAT[kind])


@dataclasses.dataclass
class Schedule:
    pipeline: Pipeline
    iter_time: float               # seconds per layer-iteration
    critical_path: list[str]
    unit_assignment: dict[str, float]
    nano_kqv: int
    nano_dense: int
    compute_busy: float            # fraction of iter_time compute is active

    def summary(self) -> dict:
        return {
            "iter_time_ms": self.iter_time * 1e3,
            "critical_path": "->".join(self.critical_path),
            "nano_kqv": self.nano_kqv, "nano_dense": self.nano_dense,
            "compute_busy": round(self.compute_busy, 4),
            "units": {k: round(v, 3) for k, v in self.unit_assignment.items()},
        }


def _schedule_times(pipe: Pipeline) -> float:
    """Resource-aware list scheduling under two constraints (DESIGN.md §2):

      (a) execution-unit budget: Σ units of ALL in-flight ops ≤ 1.0
          (the SM-partition / grid-partition budget);
      (b) bandwidth: Σ rate of in-flight ops of the SAME kind ≤ 1.0, where
          rate = eff(units) — two network kernels can each saturate the wire
          with 32% of the units, but they still share one wire.

    A node starts at the first event where both hold over its whole run:
    at the start and at every start of an op already placed inside it.
    The JAX package checks the start alone, so a node that starts before
    an op already placed (earlier in topological order, later in time) can
    run into it and oversubscribe both budgets (ROADMAP C6); where that
    does not happen, the two place every node alike.

    Fills node.start/end; returns makespan."""
    order = pipe.topo_order()
    running: list[tuple[float, float, float, str, float]] = []
    time = 0.0
    ready: dict[str, float] = {}

    def fits(n: OpNode, rate: float, t: float) -> bool:
        # (start, end, units, kind, rate) of each placed op, in placement
        # order: the sums add in JAX's order
        units_inflight = rate_inflight = 0.0
        for s, e, u, k, r in running:
            if s <= t < e:
                units_inflight += u
                if k == n.kind:
                    rate_inflight += r
        return (units_inflight + n.units <= 1.0 + 1e-9
                and rate_inflight + rate <= 1.0 + 1e-9)

    for n in order:
        t_ready = max((ready[d] for d in n.deps), default=0.0)
        rate = max(efficiency(n.kind, n.units), 1e-9)
        dur = n.work / rate
        events = sorted({t_ready} | {e for _, e, *_ in running if e > t_ready})
        start = None
        for t0 in events:
            if fits(n, rate, t0) and all(
                    fits(n, rate, s) for s, *_ in running if t0 < s < t0 + dur):
                start = t0
                break
        if start is None:
            start = max((e for _, e, *_ in running), default=t_ready)
        n.start, n.end = start, start + dur
        ready[n.name] = n.end
        running.append((n.start, n.end, n.units, n.kind,
                        efficiency(n.kind, n.units)))
        time = max(time, n.end)
    return time


def _greedy_units(pipe: Pipeline, *, iters: int = 64) -> float:
    """Paper's greedy loop: assign more units to critical-path ops, bounded
    by the total unit budget per overlapping set; re-derive the critical path
    each round until converged."""
    # start with a partition that leaves overlap headroom: compute takes the
    # bulk, memory/network take (roughly) their saturation shares — the
    # paper's Fig.-7 insight that small unit shares already saturate them.
    init = {COMPUTE: 0.6, MEMORY: 0.25, NETWORK: 0.32}
    for n in pipe.nodes.values():
        n.units = init[n.kind]
    best = _schedule_times(pipe)
    for _ in range(iters):
        _, path = pipe.critical_path()
        changed = False
        for name in path:
            n = pipe.nodes[name]
            if n.units < 1.0 - 1e-6:
                old = n.units
                n.units = min(1.0, n.units + 0.125)
                t = _schedule_times(pipe)
                if t < best - 1e-12:
                    best = t
                    changed = True
                else:
                    n.units = old
                    _schedule_times(pipe)
        # try shrinking off-path ops (frees resource headroom for overlap)
        for n in pipe.nodes.values():
            if n.name in path or n.units <= 0.25:
                continue
            old = n.units
            n.units = max(0.25, n.units - 0.125)
            t = _schedule_times(pipe)
            if t < best - 1e-12:
                best = t
                changed = True
            else:
                n.units = old
                _schedule_times(pipe)
        if not changed:
            break
    return best


def _profiles_from_costs(cfg, workload: cm.Workload, hw: cm.Hardware,
                         n_dev: int, bdense: Optional[float] = None
                         ) -> dict[str, tuple[str, float]]:
    """Collapse the Table-2 op costs into the Figure-4 op classes."""
    costs = cm.op_costs(cfg, workload, hw, n_dev, bdense)
    per_layer = 1.0 / max(cfg.n_layers, 1)

    def t_of(c: cm.OpCost) -> float:
        return max(c.times(hw, n_dev)) * per_layer

    prof: dict[str, tuple[str, float]] = {}
    acc: dict[str, float] = {}
    kindmap: dict[str, str] = {}
    for c in costs:
        if c.name.startswith(("GEMM-KQV", "GEMM-Q", "GEMM-KV")):
            key = "KQV"
        elif c.name.startswith("GEMM-O"):
            key = "O"
        elif c.name.startswith(("GEMM-UG", "GEMM-D", "MoE")) \
                and "AllToAll" not in c.name:
            key = "UGD"
        elif c.name == "DecodeAttention" or c.name == "RecurrentScan":
            key = "GEMV"
        elif c.name == "PrefillAttention":
            key = "PF"
        elif "AG" in c.name:
            key = "AG"
        elif "AR" in c.name or "AllToAll" in c.name:
            key = "AR"
        else:
            key = "UGD"
        acc[key] = acc.get(key, 0.0) + t_of(c)
        kindmap.setdefault(key, c.kind)
    for k, t in acc.items():
        prof[k] = (kindmap[k], t)
    for k in ("KQV", "O", "UGD", "GEMV", "PF", "AG", "AR"):
        prof.setdefault(k, (COMPUTE if k in ("KQV", "O", "UGD", "PF")
                            else (MEMORY if k == "GEMV" else NETWORK), 0.0))
    return prof


def autosearch(cfg, workload: cm.Workload, hw: cm.Hardware = cm.H100,
               n_dev: int = 1, *, bdense: Optional[float] = None,
               nano_kqv_options=(2, 4), nano_dense_options=(2,),
               has_network: Optional[bool] = None) -> Schedule:
    """Search nano-batch counts × unit assignments; return the best schedule."""
    prof = _profiles_from_costs(cfg, workload, hw, n_dev, bdense)
    if has_network is None:
        has_network = n_dev > 1 and (prof["AG"][1] > 0 or prof["AR"][1] > 0)
    best = schedule_profiles(prof, has_network=has_network,
                             nano_kqv_options=nano_kqv_options,
                             nano_dense_options=nano_dense_options)
    # the search space includes the non-overlapped plan: when overlap can't
    # win (tiny models, no network/GEMV to hide) deploy sequential (nano=1)
    seq = sequential_schedule(cfg, workload, hw, n_dev, bdense=bdense)
    if seq.iter_time < best.iter_time:
        return seq
    return best


def sequential_schedule(cfg, workload: cm.Workload,
                        hw: cm.Hardware = cm.H100, n_dev: int = 1, *,
                        bdense: Optional[float] = None,
                        nano_split: int = 1) -> Schedule:
    """Non-overlap baseline (paper Fig. 3 / ablation Fig. 13).

    nano_split > 1 models the 'nano-batch-only' ablation: the batching-
    efficiency penalty of splitting without overlapping (paper: ~13.2% at 4
    splits — we charge the dense ops the paper's measured efficiency loss)."""
    prof = _profiles_from_costs(cfg, workload, hw, n_dev, bdense)
    if nano_split > 1:
        penalty = 1.0 + 0.132 * (nano_split / 4.0)
        prof = {k: (kind, t * penalty if kind == COMPUTE else t)
                for k, (kind, t) in prof.items()}
    return sequential_profiles(prof, has_network=n_dev > 1)


def schedule_profiles(prof: dict[str, tuple[str, float]], *,
                      has_network: bool, nano_kqv_options=(2, 4),
                      nano_dense_options=(2,)) -> Schedule:
    """The best overlapped (Figure-4) schedule of ``prof`` (op class ->
    (kind, seconds for the whole dense batch), modelled or measured) over
    the nano-batch counts, each with its greedy unit assignment."""
    best: Optional[Schedule] = None
    for nk, nd in itertools.product(nano_kqv_options, nano_dense_options):
        pipe = build_nanoflow_pipeline(
            prof, nano_kqv=nk, nano_dense=nd, has_network=has_network,
            has_decode_attn=prof["GEMV"][1] > 0)
        t = _greedy_units(pipe)
        _, path = pipe.critical_path()
        busy = _compute_busy(pipe, t)
        sched = Schedule(pipeline=pipe, iter_time=t, critical_path=path,
                         unit_assignment={n.name: n.units
                                          for n in pipe.nodes.values()},
                         nano_kqv=nk, nano_dense=nd, compute_busy=busy)
        if best is None or t < best.iter_time:
            best = sched
    assert best is not None
    return best


def sequential_profiles(prof: dict[str, tuple[str, float]], *,
                        has_network: bool) -> Schedule:
    """The non-overlapped schedule of ``prof``: every op after the last."""
    pipe = sequential_pipeline(prof, has_network=has_network,
                               has_decode_attn=prof["GEMV"][1] > 0)
    t = _schedule_times(pipe)
    _, path = pipe.critical_path()
    return Schedule(pipeline=pipe, iter_time=t, critical_path=path,
                    unit_assignment={n.name: n.units for n in pipe.nodes.values()},
                    nano_kqv=1, nano_dense=1,
                    compute_busy=_compute_busy(pipe, t))


def _compute_busy(pipe: Pipeline, total: float) -> float:
    if total <= 0:
        return 0.0
    # union of compute-op intervals
    ivals = sorted((n.start, n.end) for n in pipe.nodes.values()
                   if n.kind == COMPUTE and n.end > n.start)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in ivals:
        if cur_s is None:
            cur_s, cur_e = s, e
        elif s <= cur_e:
            cur_e = max(cur_e, e)
        else:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
    if cur_s is not None:
        busy += cur_e - cur_s
    return busy / total


def throughput_estimate(cfg, sched: Schedule, workload: cm.Workload,
                        hw: cm.Hardware = cm.H100, n_dev: int = 1,
                        bdense: Optional[float] = None) -> float:
    """tokens/s/device implied by a schedule (layer iter time × n_layers),
    clamped at the Eq.-9 bound (the per-layer profile sum slightly
    under-counts embedding/head work for shallow, attention-free models)."""
    ms = cm.model_stats(cfg)
    bd = bdense if bdense is not None else cm.b_dense(hw, ms, workload, n_dev)
    iter_total = sched.iter_time * cfg.n_layers
    opt = cm.optimal_throughput(hw, ms, n_dev) / n_dev
    return min(bd / iter_total / n_dev, opt)
