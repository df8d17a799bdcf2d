"""Paged KV accounting (paper §4.4 / §5.4): the port's copy of
``repro.serving.kvcache.PagedKVManager`` with private blocks only.

Blocks are the unit of admission control: the §4.4 finish-time sweep runs
on launch-side state (committed + in-flight tokens), and finished
requests' KV is recorded in a size-only host LRU pool.  Prefix caching
(content-hashed shared blocks, copy-on-write, eviction) comes with its
slice (ROADMAP A6); until then every block is private, which is exactly
the JAX allocator's behaviour with ``prefix_caching=False``.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional

from repro_torch.serving.request import Request


@dataclasses.dataclass
class KVStats:
    device_pages_total: int
    device_pages_used: int = 0
    host_bytes: int = 0
    offload_bytes: int = 0          # cumulative D2H traffic
    aggregated_copies: int = 0
    discarded_requests: int = 0
    # extend() calls that found no free page: admission overshoot.  Must
    # stay 0 while peak_pages counts in-flight tokens
    extend_failures: int = 0

    def snapshot(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


class PagedKVManager:
    """Block-table allocator over ``total_pages`` private blocks."""

    def __init__(self, *, total_pages: int, page_size: int,
                 bytes_per_token: int, avg_decode_len: float,
                 host_capacity_bytes: int = 1 << 30):
        self.page_size = page_size
        self.bytes_per_token = bytes_per_token
        self.avg_decode_len = avg_decode_len
        self.host_capacity = host_capacity_bytes
        self.free_pages = list(range(total_pages))
        self.tables: dict[int, list[int]] = {}        # rid -> block ids
        self.lengths: dict[int, int] = {}             # rid -> token count
        self.host_pool: OrderedDict[int, int] = OrderedDict()  # rid -> bytes
        self.stats = KVStats(device_pages_total=total_pages)

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    @property
    def pages_used(self) -> int:
        return sum(len(t) for t in self.tables.values())

    # ---- peak-memory admission (§4.4) --------------------------------------
    def peak_pages(self, active: list[Request],
                   candidate: Optional[Request] = None) -> int:
        """Max page demand over the future, assuming one token/iteration and
        avg-decode completion (requests free their pages when they finish).
        Occupancy starts from launch-side state: in-flight samples already
        occupy rows that ``extend`` will claim at commit."""
        reqs = list(active) + ([candidate] if candidate is not None else [])
        if not reqs:
            return 0
        remaining = []
        current = []
        for r in reqs:
            pred = r.predicted_final_len(self.avg_decode_len)
            cur = max(r.total_tokens + r.inflight, min(r.prompt_len, pred))
            remaining.append(max(pred - cur, 0))
            current.append(cur)
        order = sorted(range(len(reqs)), key=lambda i: remaining[i])
        peak = 0
        alive = set(range(len(reqs)))
        for i in order:
            t = remaining[i]
            # just before request i finishes, everyone alive grew by t tokens
            demand = sum(self.pages_for(current[j] + min(t, remaining[j]))
                         for j in alive)
            peak = max(peak, demand)
            alive.discard(i)
        return peak

    def can_admit(self, req: Request, active: list[Request]) -> bool:
        return self.peak_pages(active, req) <= self.stats.device_pages_total

    # ---- allocation --------------------------------------------------------
    def allocate(self, rid: int, tokens: int) -> bool:
        """Build ``rid``'s block table for a ``tokens``-token prompt."""
        if rid in self.tables:
            self.free(rid)
        need = self.pages_for(tokens)
        if need > len(self.free_pages):
            return False
        self.tables[rid] = [self.free_pages.pop() for _ in range(need)]
        self.lengths[rid] = tokens
        self._sync_used()
        return True

    def extend(self, rid: int, new_len: int) -> bool:
        """Commit-side growth: cover ``new_len`` tokens."""
        table = self.tables[rid]
        extra = self.pages_for(new_len) - len(table)
        if extra > len(self.free_pages):
            self.stats.extend_failures += 1
            return False
        for _ in range(extra):
            table.append(self.free_pages.pop())
        self.lengths[rid] = new_len
        self._sync_used()
        return True

    def free(self, rid: int) -> None:
        self.free_pages.extend(self.tables.pop(rid, []))
        self.lengths.pop(rid, None)
        self._sync_used()

    def _sync_used(self):
        self.stats.device_pages_used = self.pages_used

    # ---- offload (§5.4) ----------------------------------------------------
    def offload(self, rid: int, nbytes: int) -> None:
        """Record the finished request's KV in the host LRU pool (size-only
        accounting: no host copy is made) and release its device blocks."""
        if self.lengths.get(rid, 0) == 0:
            return
        self.stats.aggregated_copies += 1
        self.stats.offload_bytes += nbytes
        prev = self.host_pool.pop(rid, None)
        if prev is not None:
            self.stats.host_bytes -= prev
        self.host_pool[rid] = nbytes
        self.stats.host_bytes += nbytes
        while self.stats.host_bytes > self.host_capacity and self.host_pool:
            _, evicted = self.host_pool.popitem(last=False)   # LRU
            self.stats.host_bytes -= evicted
            self.stats.discarded_requests += 1
        self.free(rid)
