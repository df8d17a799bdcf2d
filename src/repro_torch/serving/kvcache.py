"""Block-table KV accounting with cross-request prefix caching (paper §4.4 /
§5.4; DESIGN.md §12): the port's copy of ``repro.serving.kvcache``'s
``PagedKVManager``.

The allocator manages a pool of ``total_pages`` fixed-size blocks (one block
= ``page_size`` token rows of every attention-cache leaf).  Each request
holds a block table, an ordered list of block ids.  With
``prefix_caching=True``:

  * full blocks are content-hashed with a chained digest (parent digest +
    the block's token ids, so a block's key pins its whole prefix); a new
    prompt is matched block by block, and matched blocks are shared
    (refcount++) and never prefilled again (``KVStats.prefix_hit_tokens``);
  * a shared or hash-registered block is immutable: a request that diverges
    inside one gets a private copy — a fresh block and a queued (src, dst)
    device copy that the engine drains before its next step
    (``KVStats.cow_copies``);
  * blocks whose refcount drops to 0 while still registered go to an LRU
    evictor instead of the free list and keep serving hits until allocation
    reclaims them (``KVStats.evicted_blocks``).

Admission is the §4.4 finish-time sweep over launch-side state (committed +
in-flight tokens); finished requests' KV is recorded in a size-only host LRU
pool.  With ``prefix_caching=False`` no block is ever shared or registered,
and every block is private.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Iterable, Optional, Sequence

import numpy as np

from repro_torch.serving.request import Request


@dataclasses.dataclass
class KVStats:
    device_pages_total: int
    device_pages_used: int = 0
    host_bytes: int = 0
    offload_bytes: int = 0          # cumulative D2H traffic
    upload_bytes: int = 0           # cumulative H2D traffic (not counted by
    #                                 any engine path, as in JAX)
    aggregated_copies: int = 0
    discarded_requests: int = 0
    # extend() calls that found no free page: admission overshoot.  Must
    # stay 0 while peak_pages counts in-flight tokens
    extend_failures: int = 0
    # ---- prefix caching (DESIGN.md §12) ------------------------------------
    prefix_hit_tokens: int = 0      # prompt tokens served from shared blocks
    cow_copies: int = 0             # block copies queued on divergence
    evicted_blocks: int = 0         # cached ref-0 blocks reclaimed

    def snapshot(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


class LRUEvictor:
    """Cached-but-unreferenced blocks, reclaimed least recently cached
    first: a block enters when its refcount drops to 0 while it is still
    hash-registered, and leaves by being shared again (``remove``) or
    reclaimed for allocation (``pop``)."""

    def __init__(self):
        self._order: OrderedDict[int, None] = OrderedDict()

    def add(self, block: int) -> None:
        self._order[block] = None
        self._order.move_to_end(block)

    def remove(self, block: int) -> None:
        self._order.pop(block, None)

    def pop(self) -> int:
        block, _ = self._order.popitem(last=False)
        return block

    def __len__(self) -> int:
        return len(self._order)

    def __contains__(self, block: int) -> bool:
        return block in self._order


def _block_digest(parent: bytes, token_ids: Iterable[int]) -> bytes:
    """Chained content hash: a block's key commits to its own tokens *and*
    its whole prefix (the parent's key), so equal keys mean equal KV."""
    h = hashlib.sha256(parent)
    h.update(np.asarray(list(token_ids), np.int64).tobytes())
    return h.digest()


def _common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class PagedKVManager:
    """Refcounted block-table allocator over ``total_pages`` blocks.  Its
    invariants: a block with refcount > 0 is never freed or handed out
    again; hash entries point only at immutable full blocks (a write into a
    registered or shared block copies it first); no block enters two tables
    without its refcount counting both."""

    def __init__(self, *, total_pages: int, page_size: int,
                 bytes_per_token: int, avg_decode_len: float,
                 host_capacity_bytes: int = 1 << 30,
                 prefix_caching: bool = False):
        self.page_size = page_size
        self.bytes_per_token = bytes_per_token
        self.avg_decode_len = avg_decode_len
        self.host_capacity = host_capacity_bytes
        self.prefix_caching = bool(prefix_caching)
        self.free_pages = list(range(total_pages))
        self.tables: dict[int, list[int]] = {}        # rid -> block ids
        self.lengths: dict[int, int] = {}             # rid -> token count
        self.host_pool: OrderedDict[int, int] = OrderedDict()  # rid -> bytes
        self.stats = KVStats(device_pages_total=total_pages)
        # ---- block-table state (DESIGN.md §12) -----------------------------
        self.evictor = LRUEvictor()
        self._ref: dict[int, int] = {}                # block -> refcount (>0)
        self._hash: dict[bytes, int] = {}             # chain key -> block
        self._key: dict[int, bytes] = {}              # registered block -> key
        self._tokens: dict[int, tuple[int, ...]] = {}  # registered block ids
        self._parent: dict[int, bytes] = {}           # registered -> parent key
        self._children: dict[bytes, list[int]] = {}   # parent key -> blocks
        self._cached: dict[int, int] = {}             # rid -> prefix-hit tokens
        # rid -> (full blocks promoted/walked, chain digest at that point)
        self._promoted: dict[int, tuple[int, bytes]] = {}
        self._pending_copies: list[tuple[int, int]] = []

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    @property
    def pages_used(self) -> int:
        """Distinct blocks referenced by at least one table (a shared block
        counts once)."""
        return len(self._ref)

    # ---- peak-memory admission (§4.4) --------------------------------------
    def peak_pages(self, active: list[Request],
                   candidate: Optional[Request] = None) -> int:
        """Max page demand over the future, assuming one token/iteration and
        avg-decode completion (requests free their pages when they finish).
        Occupancy starts from launch-side state: in-flight samples already
        occupy rows that ``extend`` will claim at commit.  Prefix sharing is
        ignored, which makes the sweep conservative, never optimistic."""
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

    # ---- refcounted block pool ---------------------------------------------
    def _available(self) -> int:
        return len(self.free_pages) + len(self.evictor)

    def _incref(self, block: int) -> None:
        self._ref[block] = self._ref.get(block, 0) + 1
        self.evictor.remove(block)

    def _decref(self, block: int) -> None:
        n = self._ref[block] - 1
        if n > 0:
            self._ref[block] = n
            return
        del self._ref[block]
        if block in self._key:
            # still hash-registered: keep it cached for future prefix hits
            # until allocation reclaims it (_take_block)
            self.evictor.add(block)
        else:
            self.free_pages.append(block)

    def _take_block(self) -> int:
        """A writable private block: the free list first, then the
        evictor's pick, whose cached prefix is then gone for good."""
        if self.free_pages:
            return self.free_pages.pop()
        block = self.evictor.pop()
        self._unregister(block)
        self.stats.evicted_blocks += 1
        return block

    def _unregister(self, block: int) -> None:
        key = self._key.pop(block)
        self._hash.pop(key, None)
        self._tokens.pop(block, None)
        parent = self._parent.pop(block, b"")
        kids = self._children.get(parent)
        if kids is not None:
            if block in kids:
                kids.remove(block)
            if not kids:
                del self._children[parent]

    def _fresh(self, table: list[int]) -> None:
        block = self._take_block()
        self._ref[block] = self._ref.get(block, 0) + 1
        table.append(block)

    def _copy_of(self, src: int) -> int:
        """A fresh private block with a queued (src, dst) device copy.  src
        is pinned (an extra ref) until the engine drains the copy: an
        eviction in between could hand src to a request whose write would
        race the copy's read."""
        dst = self._take_block()
        self._ref[dst] = self._ref.get(dst, 0) + 1
        self._incref(src)
        self._pending_copies.append((src, dst))
        self.stats.cow_copies += 1
        return dst

    def take_pending_copies(self) -> list[tuple[int, int]]:
        """Queued copy-on-write block copies, (src, dst), cleared on read.
        The engine applies them on the device before its next step; copy
        sources are unpinned here."""
        out, self._pending_copies = self._pending_copies, []
        for src, _ in out:
            self._decref(src)
        return out

    # ---- allocation --------------------------------------------------------
    def allocate(self, rid: int, tokens: int, *,
                 token_ids: Optional[Sequence[int]] = None) -> bool:
        """Build ``rid``'s block table for a ``tokens``-token prompt.  With
        prefix caching and ``token_ids``, the prompt is first matched
        against the content-hash table: whole matched blocks are shared,
        and a divergence *inside* a cached block takes a private copy of
        it.  At most ``len(token_ids) - 1`` tokens are served from cache:
        the last prompt token is always recomputed, so the prefill still
        samples the first token."""
        if rid in self.tables:
            self.free(rid)
        need = self.pages_for(tokens)
        matched: list[int] = []
        cow_src = None
        cached = 0
        chain = b""
        if self.prefix_caching and token_ids is not None and len(token_ids):
            bs = self.page_size
            ids = tuple(token_ids)
            cap = len(ids) - 1
            j = 0
            while (j + 1) * bs <= cap:
                key = _block_digest(chain, ids[j * bs:(j + 1) * bs])
                block = self._hash.get(key)
                if block is None:
                    break
                matched.append(block)
                chain = key
                j += 1
            cached = j * bs
            if cached < cap:
                # partial-tail match: a registered sibling whose leading
                # tokens agree — copy it, then overwrite the divergent tail
                tail = ids[cached:min(cached + bs, cap)]
                best = 0
                for block in self._children.get(chain, ()):
                    m = _common_prefix(self._tokens[block], tail)
                    if m > best:
                        best, cow_src = m, block
                cached += best
        # matched blocks held by the evictor stop being allocatable once
        # shared (the JAX allocator counts them and can then run dry
        # mid-allocation: ROADMAP C3)
        if need - len(matched) > self._available() - sum(
                b in self.evictor for b in matched):
            return False
        for block in matched:
            self._incref(block)
        table = list(matched)
        if cow_src is not None:
            table.append(self._copy_of(cow_src))
        while len(table) < need:
            self._fresh(table)
        self.tables[rid] = table
        self.lengths[rid] = tokens
        if self.prefix_caching:
            self._cached[rid] = cached
            self._promoted[rid] = (len(matched), chain)
            self.stats.prefix_hit_tokens += cached
        self._sync_used()
        return True

    def ensure(self, rid: int, new_len: int) -> bool:
        """Launch-side growth (the engine calls this when it *writes* row
        ``new_len - 1``, before commit): append blocks to cover ``new_len``
        and make the written block private — a shared or registered block
        takes a copy first."""
        table = self.tables.get(rid)
        if table is None:
            return False
        need = self.pages_for(new_len)
        while len(table) < need:
            if not self._available():
                self.stats.extend_failures += 1
                return False
            self._fresh(table)
        j = (new_len - 1) // self.page_size
        block = table[j]
        if self._ref.get(block, 0) > 1 or block in self._key:
            if not self._available():
                self.stats.extend_failures += 1
                return False
            table[j] = self._copy_of(block)
            self._decref(block)                # the table's own ref
        self._sync_used()
        return True

    def extend(self, rid: int, new_len: int, *,
               token_ids: Optional[Sequence[int]] = None) -> bool:
        """Commit-side growth: cover ``new_len`` tokens (idempotent after a
        launch-side ``ensure``).  With prefix caching, ``token_ids`` — the
        request's committed token stream — promotes newly completed full
        blocks into the content-hash table."""
        table = self.tables[rid]
        extra = self.pages_for(new_len) - len(table)
        if extra > self._available():
            self.stats.extend_failures += 1
            return False
        for _ in range(extra):
            self._fresh(table)
        self.lengths[rid] = new_len
        if self.prefix_caching and token_ids is not None:
            self._promote(rid, token_ids)
        self._sync_used()
        return True

    def _promote(self, rid: int, token_ids: Sequence[int]) -> None:
        """Register every complete committed block of ``rid`` whose chain
        position is still unclaimed.  A block whose content another request
        registered first stays private; the chain still advances through
        the canonical key, so later blocks can register."""
        j, chain = self._promoted.get(rid, (0, b""))
        table = self.tables[rid]
        bs = self.page_size
        while (j + 1) * bs <= len(token_ids) and j < len(table):
            blk_ids = tuple(token_ids[j * bs:(j + 1) * bs])
            key = _block_digest(chain, blk_ids)
            block = table[j]
            if key not in self._hash and block not in self._key:
                self._hash[key] = block
                self._key[block] = key
                self._tokens[block] = blk_ids
                self._parent[block] = chain
                self._children.setdefault(chain, []).append(block)
            chain = key
            j += 1
        self._promoted[rid] = (j, chain)

    def free(self, rid: int) -> None:
        for block in self.tables.pop(rid, []):
            self._decref(block)
        self.lengths.pop(rid, None)
        self._cached.pop(rid, None)
        self._promoted.pop(rid, None)
        self._sync_used()

    def table(self, rid: int) -> list[int]:
        """The request's block table (block id of logical block j)."""
        return self.tables[rid]

    def cached_tokens(self, rid: int) -> int:
        """Prompt tokens served from shared blocks at admission: the
        scheduler does not prefill them."""
        return self._cached.get(rid, 0)

    def _sync_used(self):
        self.stats.device_pages_used = self.pages_used

    # ---- offload (§5.4) ----------------------------------------------------
    def offload(self, rid: int, nbytes: int) -> None:
        """Record the finished request's KV in the host LRU pool (size-only
        accounting: no host copy is made) and release its device blocks;
        registered ones stay cached and keep serving prefix hits."""
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
