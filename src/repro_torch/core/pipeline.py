"""NanoFlow §4.3: the operation-level pipeline (Figure 4) as an explicit
dependency graph over nano-batched operations (port of
``repro.core.pipeline``, the same names, signatures and arithmetic).

``core/autosearch.py`` schedules the graph (critical path, unit shares).
Node kinds carry the *bottleneck resource*; durations come from the cost
model's profiles or from measured op times.  Host arithmetic only.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

COMPUTE, MEMORY, NETWORK = "compute", "memory", "network"


@dataclasses.dataclass
class OpNode:
    name: str
    kind: str                      # compute | memory | network
    nano: int                      # nano-batch index
    work: float                    # seconds at full-device resource share
    deps: tuple[str, ...] = ()
    units: float = 1.0             # assigned execution-unit fraction (0..1]
    start: float = 0.0             # filled by the scheduler
    end: float = 0.0


@dataclasses.dataclass
class Pipeline:
    """One transformer layer's op graph, replicated per iteration."""
    nodes: dict[str, OpNode]
    nano_kqv: int                  # nano-batch counts (paper: 4 for KQV/GEMV)
    nano_dense: int                # and 2 for O/UGD/network ops

    def topo_order(self) -> list[OpNode]:
        order, seen = [], set()

        def visit(n: OpNode):
            if n.name in seen:
                return
            for d in n.deps:
                visit(self.nodes[d])
            seen.add(n.name)
            order.append(n)

        for n in self.nodes.values():
            visit(n)
        return order

    def critical_path(self) -> tuple[float, list[str]]:
        """Longest dependency chain under current durations (units applied)."""
        dist: dict[str, float] = {}
        pred: dict[str, Optional[str]] = {}
        for n in self.topo_order():
            base = max((dist[d] for d in n.deps), default=0.0)
            dist[n.name] = base + n.work / max(n.units, 1e-6)
            pred[n.name] = max(n.deps, key=lambda d: dist[d], default=None) \
                if n.deps else None
        end = max(dist, key=lambda k: dist[k])
        path, cur = [], end
        while cur is not None:
            path.append(cur)
            cur = pred[cur]
        return dist[end], list(reversed(path))


def build_nanoflow_pipeline(profiles: dict[str, tuple[str, float]], *,
                            nano_kqv: int = 4, nano_dense: int = 2,
                            has_network: bool = True,
                            has_decode_attn: bool = True) -> Pipeline:
    """Construct the paper's Figure-4 pipeline.

    ``profiles``: op base name -> (kind, seconds for the *whole* dense batch).
    Per-nano-batch work = total / nano_count.  Ops and dependencies follow
    Figure 4: KQV split 4-ways feeding GEMV (decode attention) 4-ways; O
    split 2-ways (O2 row-parallel: AR after, not AG before); UGD 2-ways; AG1
    after O1, AR after O2 overlapped by UGD1.
    """
    nodes: dict[str, OpNode] = {}

    def add(name, base, kind, nano, frac, deps=()):
        nodes[name] = OpNode(name=name, kind=kind, nano=nano,
                             work=base * frac, deps=tuple(deps))

    kqv_kind, kqv_t = profiles["KQV"]
    for i in range(nano_kqv):
        add(f"KQV{i+1}", kqv_t, kqv_kind, i, 1 / nano_kqv,
            deps=() if i == 0 else (f"KQV{i}",))

    last_attn: list[str] = []
    if has_decode_attn:
        gemv_kind, gemv_t = profiles["GEMV"]
        for i in range(nano_kqv):
            add(f"GEMV{i+1}", gemv_t, gemv_kind, i, 1 / nano_kqv,
                deps=(f"KQV{i+1}",))
        pf_kind, pf_t = profiles.get("PF", (COMPUTE, 0.0))
        if pf_t:
            add("PF", pf_t, pf_kind, 0, 1.0, deps=("KQV1",))
            last_attn.append("PF")
        last_attn += [f"GEMV{i+1}" for i in range(nano_kqv)]
    else:
        last_attn += [f"KQV{i+1}" for i in range(nano_kqv)]

    o_kind, o_t = profiles["O"]
    half = nano_kqv // nano_dense
    add("O1", o_t, o_kind, 0, 1 / nano_dense,
        deps=tuple(last_attn[: max(1, len(last_attn) // 2)]))
    add("O2", o_t, o_kind, 1, 1 / nano_dense, deps=tuple(last_attn))

    ug_kind, ug_t = profiles["UGD"]
    if has_network:
        ag_kind, ag_t = profiles["AG"]
        ar_kind, ar_t = profiles["AR"]
        add("AG1", ag_t, ag_kind, 0, 1 / nano_dense, deps=("O1",))
        # O2 is row-parallel: AR after it (overlapped by UGD1) — paper §4.3
        add("UGD1", ug_t, ug_kind, 0, 1 / nano_dense, deps=("AG1",))
        add("AR2", ar_t, ar_kind, 1, 1 / nano_dense, deps=("O2",))
        add("UGD2", ug_t, ug_kind, 1, 1 / nano_dense, deps=("AR2", "UGD1"))
        add("AG-next1", ag_t, ag_kind, 0, 1 / nano_dense, deps=("UGD1",))
        add("AG-next2", ag_t, ag_kind, 1, 1 / nano_dense, deps=("UGD2",))
    else:
        add("UGD1", ug_t, ug_kind, 0, 1 / nano_dense, deps=("O1",))
        add("UGD2", ug_t, ug_kind, 1, 1 / nano_dense, deps=("O2", "UGD1"))

    return Pipeline(nodes=nodes, nano_kqv=nano_kqv, nano_dense=nano_dense)


def sequential_pipeline(profiles: dict[str, tuple[str, float]], *,
                        has_network: bool = True,
                        has_decode_attn: bool = True) -> Pipeline:
    """The non-overlapping baseline (Fig. 3): every op depends on the last."""
    order = ["KQV"]
    if has_decode_attn:
        order += ["GEMV", "PF"]
    order += ["O"]
    if has_network:
        order += ["AG"]
    order += ["UGD"]
    if has_network:
        order += ["AG2", "AR"]
    nodes: dict[str, OpNode] = {}
    prev = None
    for name in order:
        base = name.rstrip("2")
        if base not in profiles or profiles[base][1] == 0.0:
            continue
        kind, t = profiles[base]
        nodes[name] = OpNode(name=name, kind=kind, nano=0, work=t,
                             deps=(prev,) if prev else ())
        prev = name
    return Pipeline(nodes=nodes, nano_kqv=1, nano_dense=1)
