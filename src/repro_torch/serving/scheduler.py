"""Global batch scheduler (paper §4.2): continuous batching + chunked
prefill + discrete batching, planned from launch-side state (§5.3).

The port's copy of ``repro.serving.scheduler``: the policy is the JAX
scheduler's step for step (the engine tests compare token streams).

Every iteration the scheduler emits a ``BatchPlan``:
  * all active decode requests contribute one token each, or with
    speculative decoding (``spec_k > 0``, DESIGN.md §13) a ``spec_k + 1``
    token *verify segment*: the device-fed last accepted token plus
    ``spec_k`` drafter proposals;
  * head-of-line prefill requests contribute chunks sized to top the dense
    batch up to the chosen *discrete* size;
  * new requests are admitted eagerly while the KV peak-memory estimate fits.

Plans are formed from launch-side state (``prefill_launched``,
``inflight``), so the engine can launch iteration i+1 before i's samples
reach the host (the async pipeline, §10); ``commit`` applies the samples
late and drops those that raced past a finish (``dropped_tokens``).  Every
launch-side count charges a verify segment its worst case, all ``spec_k +
1`` samples; ``commit`` reconciles with the accepted prefix.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

from repro_torch.core.nanobatch import (NanoBatchPlan, nano_batch_sizes_for,
                                        packed_segment_order)
from repro_torch.serving.kvcache import PagedKVManager
from repro_torch.serving.request import Request, State


@dataclasses.dataclass
class PrefillChunk:
    req: Request
    offset: int          # token offset within the prompt
    length: int


@dataclasses.dataclass
class BatchPlan:
    decode: list[Request]
    prefill: list[PrefillChunk]
    dense_batch: int     # the discrete dense size this plan fills
    # tokens per decode entry: 1, or spec_k + 1 for verify segments (§13)
    decode_width: int = 1

    @property
    def dense_tokens(self) -> int:
        return (len(self.decode) * self.decode_width
                + sum(c.length for c in self.prefill))


@dataclasses.dataclass
class PackedSegment:
    """One contiguous token run of the packed stream: a single decode token,
    one prefill chunk, or a ``spec_k + 1``-token verify segment whose first
    token is fed on the device and whose tail holds the drafts (§13)."""
    req: Request
    offset: int          # position of the segment's first token (prefill);
    #                      decode positions come from the engine's slot state
    length: int
    is_decode: bool
    draft: tuple[int, ...] = ()   # spec_k proposals (verify segments only)


@dataclasses.dataclass
class PackedPlan:
    """Token-packed launch layout for one iteration: segments in nano-batch
    interleave order, the bucketed launch length and the iteration's
    KV-length bucket (DESIGN.md §9)."""
    segments: list[PackedSegment]
    tokens: int                     # real tokens (== BatchPlan.dense_tokens)
    launch_tokens: int              # bucketed T the step is launched with
    dense_batch: int                # the discrete size the plan targeted
    nano: NanoBatchPlan             # nano-batch split of the launched stream
    segment_nano: tuple[int, ...]   # nano-batch id per segment
    kv_bucket: Optional[int] = None  # quantized max KV extent this iteration
    kv_needed: int = 0              # exact max KV extent (diagnostics)

    @property
    def padding(self) -> int:
        return self.launch_tokens - self.tokens


def default_kv_buckets(max_len: int, floor: int = 64) -> tuple[int, ...]:
    """Power-of-two KV-length grid up to ``max_len`` (DESIGN.md §9):
    ``(64, 128, 256, ..., max_len)``."""
    b = min(floor, max_len)
    out = []
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


class GlobalBatchScheduler:
    def __init__(self, kv: PagedKVManager, *,
                 discrete_sizes: tuple[int, ...] = (2048, 1024, 512, 256, 128,
                                                    64, 32, 16, 8),
                 max_active: int = 256,
                 prefill_chunk_min: int = 8,
                 kv_buckets: Optional[tuple[int, ...]] = None,
                 max_request_len: Optional[int] = None,
                 spec_k: int = 0, drafter=None):
        self.kv = kv
        self.sizes = tuple(sorted(discrete_sizes, reverse=True))
        self.max_active = max_active
        # every decode entry plans, launches and is charged spec_k + 1
        # tokens; the drafter fills a verify segment's tail at pack()
        self.spec_k = int(spec_k)
        self.drafter = drafter
        # a prompt longer than a slot can hold is never admitted
        self.max_request_len = max_request_len
        # KV-length grid, ascending; None disables bucketing
        self.kv_buckets = (tuple(sorted(set(kv_buckets)))
                          if kv_buckets else None)
        # chunk lengths are quantized to the discrete sizes; the only
        # unbucketed lengths are terminal remainders < chunk_min
        self.chunk_min = max(prefill_chunk_min, self.sizes[-1])
        self.waiting: deque[Request] = deque()
        self.active: list[Request] = []
        self.padding_tokens = 0
        self.launched_tokens = 0
        # tokens launched for requests that finished before their commit
        self.dropped_tokens = 0
        # prompt tokens served from shared blocks at admission (§12)
        self.prefix_hit_tokens = 0

    # ---- admission ---------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    def _admit(self) -> None:
        """Eager admission under the peak-memory estimate (§4.4).  With a
        prefix-caching allocator (DESIGN.md §12) the prompt's token ids go
        to ``allocate`` for content-hash matching, and prefill starts at
        the cached boundary: only the uncached suffix is ever planned."""
        prefix = self.kv.prefix_caching
        while self.waiting and len(self.active) < self.max_active:
            cand = self.waiting[0]
            if (self.max_request_len is not None
                    and cand.prompt_len > self.max_request_len):
                break
            if not self.kv.can_admit(cand, self.active):
                break
            if not self.kv.allocate(cand.rid, max(cand.prompt_len, 1),
                                    token_ids=cand.prompt if prefix else None):
                break
            self.waiting.popleft()
            cand.state = State.PREFILL
            if prefix:
                cached = self.kv.cached_tokens(cand.rid)
                cand.prefill_done = cand.prefill_launched = cached
                self.prefix_hit_tokens += cached
            self.active.append(cand)

    # ---- discrete batching (§4.2) -------------------------------------------
    def _pick_dense(self, available: int) -> int:
        for s in self.sizes:
            if s <= available:
                return s
        return self.sizes[-1]

    def _quantize_chunk(self, want: int) -> int:
        """Round a prefill chunk length down to a discrete size (terminal
        remainders below the smallest size pass through)."""
        for s in self.sizes:
            if s <= want:
                return s
        return want

    # ---- per-iteration plan --------------------------------------------------
    def _decodable(self, r: Request) -> bool:
        """Decode eligibility from *launched* state: the whole prompt was
        launched, generation is capped by launched samples, and a committed
        EOS stops planning once one post-EOS token is in flight."""
        return (r.state != State.FINISHED
                and r.prefill_launched >= r.prompt_len
                and len(r.output) + r.inflight < r.max_new_tokens
                and not (r.pending_eos and r.inflight > 0))

    def plan(self) -> Optional[BatchPlan]:
        self._admit()
        decode = [r for r in self.active if self._decodable(r)]
        prefilling = [r for r in self.active if r.prefill_unlaunched > 0]

        width = self.spec_k + 1
        available = len(decode) * width + sum(r.prefill_unlaunched
                                              for r in prefilling)
        if available == 0:
            return None
        dense = self._pick_dense(available)

        budget = max(dense - len(decode) * width, 0)
        chunks: list[PrefillChunk] = []
        for r in prefilling:
            if budget < min(self.chunk_min, r.prefill_unlaunched):
                break
            take = self._quantize_chunk(min(budget, r.prefill_unlaunched))
            chunks.append(PrefillChunk(req=r, offset=r.prefill_launched,
                                       length=take))
            budget -= take
        return BatchPlan(decode=decode, prefill=chunks, dense_batch=dense,
                         decode_width=width)

    def mark_launched(self, plan: BatchPlan) -> None:
        """Advance launch-side state when the engine dispatches ``plan``
        (after ``pack()``, which reads the pre-launch in-flight counts):
        each decode entry puts ``decode_width`` sampled tokens in flight
        (a verify segment's worst case), each prefill-*final* chunk one;
        ``commit`` retires them."""
        for r in plan.decode:
            r.inflight += plan.decode_width
        for c in plan.prefill:
            c.req.prefill_launched += c.length
            if c.req.prefill_launched >= c.req.prompt_len:
                c.req.inflight += 1

    # ---- packed launch layout (single-dispatch step, DESIGN.md §8) ----------
    def bucket_tokens(self, tokens: int) -> int:
        """Launch length for ``tokens`` packed tokens: the smallest discrete
        size that fits, with ``max_active × (spec_k + 1)`` as a floor bucket
        when it sits below the smallest size (decode-only iterations never
        exceed it)."""
        grid = tuple(reversed(self.sizes))   # ascending
        floor = self.max_active * (self.spec_k + 1)
        if floor < grid[0]:
            grid = (floor,) + grid
        for s in grid:
            if tokens <= s:
                return s
        return -(-tokens // self.sizes[0]) * self.sizes[0]

    def bucket_kv(self, needed: int) -> int:
        """Quantize an iteration's max KV extent up to the kv-bucket grid."""
        if not self.kv_buckets:
            raise ValueError("scheduler constructed without kv_buckets")
        for s in self.kv_buckets:
            if needed <= s:
                return s
        return self.kv_buckets[-1]

    def _kv_needed(self, segs: list[PackedSegment]) -> int:
        """Exact max KV extent this iteration's attention touches: a decode
        token attends ``total_tokens + inflight`` rows, and a verify
        segment's last draft ``spec_k`` more (the worst case: the device
        may roll back to fewer); a prefill chunk ``offset + length``."""
        needed = 1
        for s in segs:
            needed = max(needed,
                         s.req.total_tokens + s.req.inflight + self.spec_k
                         if s.is_decode else s.offset + s.length)
        return needed

    def _draft(self, r: Request) -> tuple[int, ...]:
        """Exactly ``spec_k`` draft tokens for a verify segment, from the
        committed history (stale under the pipeline: that lowers acceptance,
        never correctness); a short proposal is padded with its last token,
        or the history's, so every segment has the same width."""
        if self.spec_k == 0:
            return ()
        prop = list(self.drafter.propose(r, self.spec_k))[:self.spec_k] \
            if self.drafter is not None else []
        if len(prop) < self.spec_k:
            hist = r.prompt + r.output
            pad = prop[-1] if prop else (hist[-1] if hist else 0)
            prop += [pad] * (self.spec_k - len(prop))
        return tuple(int(t) for t in prop)

    def pack(self, plan: BatchPlan, *, nano: int = 2) -> PackedPlan:
        """Lay one iteration out as a token-packed stream: segments in the
        nano-batch interleave order, launch length bucketed to the discrete
        sizes, max KV extent quantized to the kv-bucket grid."""
        width = plan.decode_width
        segs = [PackedSegment(req=r, offset=-1, length=width, is_decode=True,
                              draft=self._draft(r))
                for r in plan.decode]
        segs += [PackedSegment(req=c.req, offset=c.offset, length=c.length,
                               is_decode=False) for c in plan.prefill]
        order = packed_segment_order(
            [("verify" if s.length > 1 else "decode") if s.is_decode
             else "prefill" for s in segs],
            [s.length for s in segs])
        segs = [segs[i] for i in order]
        tokens = plan.dense_tokens
        launch = self.bucket_tokens(tokens)
        nano_plan = nano_batch_sizes_for(launch, nano)
        self.padding_tokens += launch - tokens
        self.launched_tokens += launch
        kv_needed = self._kv_needed(segs)
        return PackedPlan(segments=segs, tokens=tokens, launch_tokens=launch,
                          dense_batch=plan.dense_batch, nano=nano_plan,
                          segment_nano=nano_plan.assign_segments(
                              [s.length for s in segs]),
                          kv_bucket=(self.bucket_kv(kv_needed)
                                     if self.kv_buckets else None),
                          kv_needed=kv_needed)

    # ---- post-iteration bookkeeping -------------------------------------------
    def commit(self, plan: BatchPlan, sampled: dict, now: float) \
            -> list[Request]:
        """Apply iteration results.  ``sampled``: rid -> next token id, or
        for a verify segment the list of accepted tokens (the target's
        sample at the segment base, then every accepted draft).

        EOS is acted on at the next planning opportunity (§5.3: one extra
        token, or one extra verify segment, dropped at finalize); tokens
        sampled for a request that has already FINISHED are dropped, and so
        are accepted tokens past a finish or past ``max_new_tokens``."""
        finished = []
        prefix = self.kv.prefix_caching
        for c in plan.prefill:
            c.req.prefill_done += c.length
            c.req.prefill_launched = max(c.req.prefill_launched,
                                         c.req.prefill_done)
            # committed-and-written rows are the prefilled prompt prefix:
            # full blocks below it promote into the hash table (§12)
            self.kv.extend(c.req.rid, max(c.req.total_tokens, 1),
                           token_ids=(c.req.prompt[:c.req.prefill_done]
                                      if prefix else None))
            if c.req.prefill_remaining == 0:
                c.req.state = State.DECODE
        decode_rids = {r.rid for r in plan.decode}
        for r in list(plan.decode) + [c.req for c in plan.prefill
                                      if c.req.state == State.DECODE]:
            tok = sampled.get(r.rid)
            if tok is None:
                continue
            toks = list(tok) if isinstance(tok, (list, tuple)) else [tok]
            # retire what launch charged: decode_width per decode entry,
            # 1 per prefill-final chunk
            launched = plan.decode_width if r.rid in decode_rids else 1
            r.inflight = max(r.inflight - launched, 0)
            if r.state in (State.FINISHED, State.DISCARDED):
                self.dropped_tokens += len(toks)
                continue
            if r.first_token_at is None:
                r.first_token_at = now
            for t in toks:
                if r.state == State.FINISHED:
                    self.dropped_tokens += 1    # accepted past a finish
                    continue
                r.output.append(t)
                # written rows are the prompt and every output but the
                # newest (its K/V lands next launch): only blocks fully
                # below them promote (§12)
                self.kv.extend(r.rid, r.total_tokens + 1,
                               token_ids=(r.prompt + r.output[:-1]
                                          if prefix else None))
                hit_eos = (r.eos_id is not None and t == r.eos_id)
                if r.pending_eos or len(r.output) >= r.max_new_tokens:
                    r.state = State.FINISHED
                    r.finished_at = now
                    finished.append(r)
                elif hit_eos:
                    r.pending_eos = True   # detected next iteration
        self.active = [r for r in self.active if r.state != State.FINISHED]
        return finished
