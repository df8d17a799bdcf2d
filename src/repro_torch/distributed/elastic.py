"""Elastic scaling and fault tolerance decisions (port of
``repro.distributed.elastic`` without ``make_mesh_for``, which comes with
tensor parallelism, ROADMAP A11).

The same state machine drives the replica pool's joins, leaves and
injected failures (``serving/pool.py``).  Policy (DESIGN.md §5):

  * a failed host removes one ``data``-axis row; a ``model``-axis failure
    leaves its TP shards incomplete, so the pod drops out (or, with one
    pod, the cluster halts);
  * ``min_data`` is the floor below which a failure or a leave halts;
  * the global batch stays constant: the per-replica batch grows.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ClusterState:
    data: int
    model: int
    pods: int = 1
    failed_hosts: int = 0

    @property
    def n_devices(self) -> int:
        return self.pods * self.data * self.model


@dataclasses.dataclass
class ElasticDecision:
    action: str              # "continue" | "rescale" | "halt"
    new_state: ClusterState
    reason: str = ""


class ElasticManager:
    """Decides the cluster's reconfiguration on failure and capacity
    events; a halt leaves the state as it was."""

    def __init__(self, state: ClusterState, min_data: int = 1):
        self.state = state
        self.min_data = min_data

    def on_failure(self, axis: str = "data", count: int = 1) -> ElasticDecision:
        s = self.state
        if axis == "model":
            if s.pods > 1:
                new = ClusterState(s.data, s.model, s.pods - 1,
                                   s.failed_hosts + count)
                self.state = new
                return ElasticDecision("rescale", new,
                                       "model-axis failure: drop pod")
            return ElasticDecision("halt", s, "TP shard lost, single pod")
        new_data = s.data - count
        if new_data < self.min_data:
            return ElasticDecision("halt", s, "below minimum data parallelism")
        new = ClusterState(new_data, s.model, s.pods, s.failed_hosts + count)
        self.state = new
        return ElasticDecision("rescale", new, f"data axis {s.data}->{new_data}")

    def on_leave(self, count: int = 1) -> ElasticDecision:
        """Planned scale-down (a drained replica retiring): a failure's
        arithmetic and ``min_data`` floor, but ``failed_hosts`` stays."""
        s = self.state
        new_data = s.data - count
        if new_data < self.min_data:
            return ElasticDecision("halt", s, "below minimum data parallelism")
        new = ClusterState(new_data, s.model, s.pods, s.failed_hosts)
        self.state = new
        return ElasticDecision("rescale", new,
                               f"graceful leave {s.data}->{new_data}")

    def on_capacity(self, added_rows: int) -> ElasticDecision:
        s = self.state
        new = ClusterState(s.data + added_rows, s.model, s.pods)
        self.state = new
        return ElasticDecision("rescale", new, f"scale up +{added_rows} rows")


def per_replica_batch(global_batch: int, state: ClusterState) -> int:
    """Keep the global batch constant across rescales (grad-noise scale)."""
    replicas = state.pods * state.data
    return -(-global_batch // replicas)


class StragglerMitigator:
    """EMA of per-host step times -> per-host batch shares proportional to
    speed, each held within ``max_skew`` of the mean so the dense batches
    of discrete batching stay efficient."""

    def __init__(self, n_hosts: int, alpha: float = 0.2, max_skew: float = 0.25):
        self.n = n_hosts
        self.alpha = alpha
        self.max_skew = max_skew
        self.ema: Optional[list[float]] = None

    def observe(self, step_times: list[float]) -> None:
        if len(step_times) != self.n:
            raise ValueError(f"{len(step_times)} step times for {self.n} "
                             f"hosts")
        if self.ema is None:
            self.ema = list(step_times)
        else:
            self.ema = [(1 - self.alpha) * e + self.alpha * t
                        for e, t in zip(self.ema, step_times)]

    def shares(self) -> list[float]:
        """Batch share per host, normalized to sum 1 (speed-proportional)."""
        if self.ema is None:
            return [1.0 / self.n] * self.n
        speed = [1.0 / max(t, 1e-9) for t in self.ema]
        mean = sum(speed) / self.n
        lo, hi = (1 - self.max_skew) * mean, (1 + self.max_skew) * mean
        speed = [min(max(s, lo), hi) for s in speed]
        total = sum(speed)
        return [s / total for s in speed]

    def split_batch(self, global_batch: int, multiple_of: int = 8) -> list[int]:
        """Integer batch split honoring discrete-batching multiples; the
        rounding drift goes to the fastest host."""
        shares = self.shares()
        raw = [global_batch * s for s in shares]
        out = [max(multiple_of, int(r // multiple_of) * multiple_of)
               for r in raw]
        drift = global_batch - sum(out)
        fastest = max(range(self.n), key=lambda i: shares[i])
        out[fastest] = max(multiple_of, out[fastest] + drift)
        return out
