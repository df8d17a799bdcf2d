"""Serving engine (port of ``repro.serving.engine.ServeEngine``): the
token-packed single-dispatch step in all four KV modes — contiguous or
block-table caches with prefix caching (DESIGN.md §12), each with native or
int8 KV (§15) — with the async pipeline (§10), speculative decoding (§13)
and greedy or stochastic sampling; and the legacy step kept for A/B
(``step_mode="legacy"``, with incremental or recompute prefill; greedy and
lock-step, as in JAX).

**Legacy step.**  One iteration = a decode dispatch over all slots at
static shape (``model.forward_decode``; an inactive slot writes a garbage
row at its ``cache_len``, which the next chunk overwrites before attending,
exactly as in JAX), then one dispatch per prefill chunk, each followed by
a device-to-host copy of its sampled token.  Incremental prefill
(``model.forward_chunk``) runs the chunk against the slot's ``(1, S, KV,
hd)`` view of the cache in place (JAX gathers the slot's sub-cache and
scatters it back) after zeroing the slot's rows on (re)assignment;
recompute prefill (``model.forward_full``) reruns the whole prefix and
writes its K/V into the slot's first rows.

**Recurrent state** (Mamba layers of a hybrid, the xLSTM mixers): a
slot's state is advanced by every token of its request and must not be by
anything else.  The legacy decode commits it only for the decoding slots
(a mid-prefill slot's garbage decode token would advance it); a chunk
writes its new state back into the slot's views; recompute writes the
whole state of the prefix; a slot taken by a new request starts from the
initial state (zeros, and -1e30 for the xLSTM stabiliser ``m``: the legacy
reset, or, on the packed step, a masked fill on the device before the
forward).  Prefix caching and speculative decoding refuse models with
recurrent layers (ValueError), as in JAX: their state can neither be
shared by blocks nor rolled back.  int8 KV applies to the attention
layers' leaves only; the recurrent state keeps its own dtypes.  A model
without attention (xLSTM) caches nothing per token: 0 KV bytes per token,
so a KV byte budget buys it nothing and the pool falls back to max_slots x
max_len rows, as in JAX.

**Frontends.**  The audio stub's (MusicGen's) inputs are K codebook
streams: every fed-back token is repeated across the K codebooks, and of
each (K,) sample the engine keeps codebook 0, in the token ring and on the
host, as JAX's engine does.  The vision stub (LLaVA) is served text-only,
as in JAX: the engine passes no patches.

**Packed step.**  One iteration = one call of the packed step: the decode
tokens (one per decoding slot, or with ``spec_k > 0`` a ``spec_k + 1``
token verify segment: the fed token, then the drafter's proposals) and
every scheduled prefill chunk are packed into a single ``(1, T)`` stream
with per-token ``(slot, position)`` metadata, run through
``model.forward_packed`` (K/V scattered at each segment's offset,
attention masked to each token's own slot) and sampled on the device.  The
samples land in a device-resident per-slot token ring (``last_token``,
``(max_slots, spec_k + 1)``, with ``accept_len``) from which the next
iteration's decode inputs are gathered on the device.  A verify segment's
true positions come from ``cache_len`` on the device (the host launches
with the worst case); its drafts are accepted by prefix match against the
target's samples, and ``cache_len`` advances by the accepted count only
(the rollback: rejected rows are overwritten by the next launch before
anything attends them).  Sampling is greedy at ``temperature == 0``, else
a Gumbel-max draw keyed on ``(seed, rid, pos)`` and drawn as JAX draws
it (``sampling.py``), taken only at the stream's sample points.

The host metadata (with, under prefix caching, each token's physical cache
row, the per-slot block tables and the rows of the iteration's
copy-on-write block copies) goes up in one host-to-device copy from pinned
memory of its own, and the one device-to-host transfer is the per-slot
payload, ring ‖ accept_len (``EngineStats.model_dispatches`` /
``host_syncs``).  That copy is enqueued at launch, behind the step, into
pinned memory of its own with an event after it; ``async_depth=k`` keeps up
to k launched iterations in a ring and retires (waits on the event,
commits to the scheduler) the oldest beyond k, so the host plans and
launches iteration i+1 while the device runs i.  A retire counts as
blocking when its event had not been reached.  ``T`` is bucketed to the
scheduler's discrete sizes and attention sweeps only the iteration's
KV-length bucket (DESIGN.md §9).

Both steps run eagerly; capturing the packed step in a CUDA graph per (T
bucket, kv bucket) is a speed follow-up (ROADMAP B, item 3).

**Tensor parallelism** (DESIGN.md §11; ``config.tp > 1``, packed step
only).  The engine is one rank of a ``torch.distributed`` group of tp
ranks (``launch.mesh``): every rank runs this same host loop on the same
requests, holds its shard of the weights (``distributed.tp``; full params
are cut on construction, params drawn sharded pass through) and of the KV
/ state cache (only its leaves are allocated), and runs the forward inside
``tp.tp_ctx`` with the launch's nano-batch split, so the row-parallel
all-reduces go out per nano-batch group.  Logits, samples, the token ring
and ``cache_len`` are replicated: the feedback loop closes with no
collective.  The one host decision that depends on timing, which in-flight
iterations have landed (``async_harvest``), is agreed over a host-side
gloo group: every rank retires the least count ready on any rank, so the
ranks plan the same batches (JAX has one controller, and a sharded result
is ready when every shard is).  tp = 1 creates no group.

**Replica pool** (DESIGN.md §14).  ``evacuate`` hands every unfinished
request back, checkpointed for re-dispatch on another replica, and
``_clock`` is the source of the commit stamps, which the pool points at
its virtual clock.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.distributed import tp as tp_lib
from repro_torch.launch import mesh
from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models import model as model_lib
from repro_torch.models.param import DTYPES
from repro_torch.serving import draft as draft_lib
from repro_torch.serving import sampling
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.kvcache import PagedKVManager
from repro_torch.serving.request import Request, State
from repro_torch.serving.scheduler import BatchPlan, GlobalBatchScheduler

# rows of the per-iteration host metadata block (one H2D copy); ``rid`` is
# the sampler's draw identity (unread under greedy)
_META_ROWS = ("tokens", "slot", "pos", "active", "from_last", "sample_slot",
              "rid")


def kv_bytes_per_token(cfg: ModelConfig,
                       kv_dtype: Optional[str] = None) -> int:
    """Per-token KV-cache bytes, from the cache shapes themselves (built on
    the ``meta`` device, so nothing is allocated): for every attention
    layer, the bytes of one sequence row of each cache leaf — int8 values
    plus f32 scales for ``kv_dtype="int8"``.  A recurrent layer's state is
    per slot, not per token, and is not charged."""
    cache = model_lib.init_cache(cfg, 1, 1, device="meta", kv_dtype=kv_dtype)
    return sum(int(np.prod(leaf.shape[2:])) * leaf.element_size()
               for spec, layer in zip(cfg.layer_specs(), cache)
               if spec.mixer == ATTN for leaf in layer.values())


def _take(src: torch.Tensor, idx: torch.Tensor, fill: int) -> torch.Tensor:
    """``src[idx]`` with ``fill`` where ``idx == len(src)`` (JAX's
    ``mode="fill"``)."""
    return torch.cat([src, src.new_full((1,), fill)])[idx.long()]


@dataclasses.dataclass
class EngineStats:
    iterations: int = 0
    prefill_tokens: int = 0          # prompt tokens admitted to the cache
    prefill_model_tokens: int = 0    # token-positions run through the model
    decode_tokens: int = 0
    wall_time: float = 0.0
    # host work / time inside the step call (enqueue on the card) / time
    # blocked on the device-to-host payload copy
    host_time: float = 0.0
    dispatch_time: float = 0.0
    blocked_sync_time: float = 0.0
    blocking_syncs: int = 0          # payload copies that had to wait
    model_dispatches: int = 0        # step calls (legacy: decode, slot
    #                                  resets and one per prefill chunk)
    host_syncs: int = 0              # device->host copies of results
    packed_pad_tokens: int = 0       # bucketing padding launched
    dense_batch_hist: dict[int, int] = dataclasses.field(default_factory=dict)
    kv_bucket_hist: dict[int, int] = dataclasses.field(default_factory=dict)
    # sum of launch_tokens x kv_bucket: the attention score work launched
    packed_attn_kv_rows: int = 0
    # modeled TP collective wire bytes (DESIGN.md §11,
    # tp.collective_bytes_per_iter); 0 at tp=1
    tp_collective_bytes: int = 0
    # speculative decoding (§13), counted at retire (the device's truth):
    # drafts launched, drafts accepted, verify segments retired
    spec_proposed_tokens: int = 0
    spec_accepted_tokens: int = 0
    spec_verify_segments: int = 0
    # fault-tolerant re-dispatch (DESIGN.md §14): requests checkpointed and
    # handed back by ``evacuate``, and the committed tokens folded into
    # their replay prefixes (the re-prefill another replica takes on)
    evacuated_requests: int = 0
    evacuated_tokens: int = 0
    # cache bytes the int8 rows did not write vs the native dtype (§15), and
    # a measured logit drift, which the engine leaves None as JAX's does
    kv_quant_bytes_saved: int = 0
    kv_quant_drift: Optional[float] = None

    @property
    def total_tokens(self) -> int:
        return self.prefill_tokens + self.decode_tokens

    @property
    def throughput(self) -> float:
        return self.total_tokens / self.wall_time if self.wall_time else 0.0

    @property
    def prefill_expansion(self) -> float:
        return (self.prefill_model_tokens / self.prefill_tokens
                if self.prefill_tokens else 0.0)

    @property
    def dispatches_per_iter(self) -> float:
        return self.model_dispatches / self.iterations if self.iterations else 0.0

    @property
    def syncs_per_iter(self) -> float:
        return self.host_syncs / self.iterations if self.iterations else 0.0

    @property
    def blocking_syncs_per_iter(self) -> float:
        """Below 1 when some payloads were already on the host when the
        engine retired them: the pipeline hid the sync."""
        return self.blocking_syncs / self.iterations if self.iterations \
            else 0.0

    @property
    def tp_collective_bytes_per_iter(self) -> float:
        return self.tp_collective_bytes / self.iterations \
            if self.iterations else 0.0

    @property
    def spec_acceptance_rate(self) -> float:
        """Share of the launched drafts that the target model accepted."""
        return self.spec_accepted_tokens / self.spec_proposed_tokens \
            if self.spec_proposed_tokens else 0.0

    @property
    def spec_accepted_per_verify(self) -> float:
        """Committed tokens per verify segment (its base sample plus the
        accepted drafts)."""
        return (self.spec_accepted_tokens + self.spec_verify_segments) \
            / self.spec_verify_segments if self.spec_verify_segments else 0.0

    _DERIVED = ("total_tokens", "throughput", "prefill_expansion",
                "dispatches_per_iter", "syncs_per_iter",
                "blocking_syncs_per_iter", "tp_collective_bytes_per_iter",
                "spec_acceptance_rate", "spec_accepted_per_verify")

    def snapshot(self) -> dict:
        out = {f.name: getattr(self, f.name)
               for f in dataclasses.fields(self)}
        out["dense_batch_hist"] = dict(self.dense_batch_hist)
        out["kv_bucket_hist"] = dict(self.kv_bucket_hist)
        for name in self._DERIVED:
            out[name] = getattr(self, name)
        return out


@dataclasses.dataclass
class _InFlight:
    """One launched packed iteration, until it is retired: the host memory
    its payload (ring ‖ accept_len, (max_slots, W + 1)) is copied into at
    launch, and the event after that copy (None on the CPU)."""
    plan: BatchPlan
    sample_at: list              # (rid, slot, kind); kind is "decode",
    #                              "verify" or "prefill"
    host: torch.Tensor
    done: Optional[torch.cuda.Event]


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: dict,
                 config: Optional[EngineConfig] = None, *,
                 device: Optional[str | torch.device] = None):
        """``ServeEngine(cfg, params, EngineConfig(...))`` runs on ``cuda``
        unless ``device`` names another; ``params`` must already live
        there (``model.init(cfg, device=...)``).  With ``config.tp > 1``
        the caller is one rank of a tp-rank process group and ``device``
        its card (or the CPU); ``params`` may be full or this rank's
        shard."""
        config = config if config is not None else EngineConfig()
        self.tp = int(config.tp)
        if self.tp > 1:
            # before anything else: a width that cannot shard raises even
            # without a group
            tp_lib.validate_tp(cfg, self.tp)
        self.device = resolve_device(device)
        model_lib.check_config(cfg)
        if params["embed"].device != self.device:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.config = config
        self.cfg = cfg
        self._group = self._host_group = None
        if self.tp > 1:
            self._group = mesh.make_tp_group(self.tp, self.device)
            self._host_group = mesh.host_group()
            params = tp_lib.shard_params(cfg, params,
                                         dist.get_rank(self._group), self.tp)
        self.params = params
        # modeled collective wire bytes per launched token (linear in T)
        self._tp_iter_bytes = tp_lib.collective_bytes_per_iter(
            cfg, 1, self.tp, DTYPES[cfg.dtype].itemsize)
        self.recurrent = any(spec.mixer != ATTN
                             for spec in cfg.layer_specs())
        if self.recurrent:
            # as the JAX engine refuses them: recurrent state can neither be
            # block-shared nor rolled back over rejected drafts
            if config.prefix_caching:
                raise ValueError("prefix caching (DESIGN.md §12) needs "
                                 "attention-only models")
            if config.spec_k:
                raise ValueError("speculative decoding (DESIGN.md §13) "
                                 "needs attention-only models")
        # each recurrent leaf's initial value (0, or the xLSTM
        # stabiliser's -1e30), to which a reused slot is reset; None for
        # an attention layer, whose rows need no reset
        fills: dict = {}
        for spec in cfg.layer_specs():
            if spec.mixer != ATTN and spec not in fills:
                fills[spec] = {
                    name: float(leaf.reshape(-1)[0])
                    for name, leaf in blocks.block_init_cache(
                        cfg, spec, 1, 1, torch.device("cpu")).items()}
        self._state_fill = [fills.get(spec) for spec in cfg.layer_specs()]
        self.max_slots = config.max_slots
        self.max_len = config.max_len
        self.prefill_mode = config.prefill_mode
        self.step_mode = config.resolved_step_mode
        self.nano = config.nano
        self.kv_buckets = config.resolved_kv_buckets()
        # the async pipeline (§10): up to async_depth launched iterations
        # stay in flight; async_harvest also retires any whose payload has
        # already landed
        self.async_depth = config.resolved_async_depth
        self.async_harvest = bool(config.async_harvest)
        self._ring: deque[_InFlight] = deque()
        # the source of commit stamps (first_token_at, finished_at): the
        # replica pool points it at its virtual clock (DESIGN.md §14); the
        # time splits of EngineStats always use perf_counter
        self._clock = time.perf_counter
        # speculative decoding (§13) and the packed step's sampling
        self.spec_k = int(config.spec_k)
        self.drafter = (draft_lib.make_drafter(config.resolved_drafter)
                        if self.spec_k else None)
        self.temperature = float(config.temperature)
        self.top_k = config.top_k
        self.seed = int(config.seed)

        # KV storage (DESIGN.md §15): "bf16" keeps the model's dtype, "int8"
        # stores int8 K/V plus f32 per-(row, KV head) scales
        self._cache_kv_dtype = "int8" if config.kv_dtype == "int8" else None
        page_size = config.kv_block_size
        kv_bytes = kv_bytes_per_token(cfg, self._cache_kv_dtype)
        self._kv_bytes_native = kv_bytes_per_token(cfg)
        if config.total_pages is not None:
            pages = config.total_pages
        elif config.kv_budget_bytes is not None and kv_bytes > 0:
            pages = max(int(config.kv_budget_bytes) // (kv_bytes * page_size), 1)
        else:
            pages = config.max_slots * config.max_len // page_size
        # prefix caching (DESIGN.md §12): block ids are physical storage
        # (flat slot-cache rows / block size), so the pool is capped at what
        # the cache leaves hold, and every swept bucket is whole blocks
        self.prefix_caching = bool(config.prefix_caching)
        if self.prefix_caching:
            for b in self.kv_buckets:
                if b % page_size:
                    raise ValueError(f"kv bucket {b} not divisible by "
                                     f"kv_block_size {page_size}")
            pages = min(pages, config.max_slots * config.max_len // page_size)
        self._nb_cols = config.max_len // page_size
        self.kv = PagedKVManager(total_pages=pages, page_size=page_size,
                                 bytes_per_token=kv_bytes,
                                 avg_decode_len=config.avg_decode_len,
                                 prefix_caching=self.prefix_caching)
        self.scheduler = GlobalBatchScheduler(
            self.kv, discrete_sizes=config.discrete_sizes,
            max_active=config.max_slots, kv_buckets=self.kv_buckets,
            max_request_len=self.max_len, spec_k=self.spec_k,
            drafter=self.drafter)

        dev = self.device
        self.cache = model_lib.init_cache(cfg, self.max_slots, self.max_len,
                                          device=dev,
                                          kv_dtype=self._cache_kv_dtype,
                                          world=self.tp)
        self.cache_len = torch.zeros((self.max_slots,), dtype=torch.int32,
                                     device=dev)
        # device-resident sampled-token feedback, the per-slot token ring:
        # a row holds the W = spec_k + 1 samples of the slot's last verify
        # segment, of which the first accept_len were accepted (W = 1: the
        # last sample).  The packed step gathers the next decode inputs
        # from ring[slot, accept_len - 1] on the device
        self.last_token = torch.zeros((self.max_slots, self.spec_k + 1),
                                      dtype=torch.int32, device=dev)
        self.accept_len = torch.ones((self.max_slots,), dtype=torch.int32,
                                     device=dev)
        self.slot_free = list(range(self.max_slots))
        self.stats = EngineStats()
        # the (T bucket, kv bucket) shapes the packed step was launched at:
        # the keys of the JAX engine's jit cache
        self.launch_shapes: set[tuple[int, int]] = set()
        # host mirror of each slot's context length: the packed stream's
        # positions come from here without any device read.  Under
        # speculation it is an upper bound (each verify launch adds W), and
        # retire resyncs it to the committed truth
        self._pos = np.zeros((self.max_slots,), np.int64)

    # ---- public API ----------------------------------------------------------
    def submit(self, req: Request) -> None:
        # a slot holds max_len positions: never decode past the cache, and
        # leave spec_k rows for the drafts of a verify segment at the cap
        req.max_new_tokens = min(
            req.max_new_tokens,
            max(self.max_len - req.prompt_len - self.spec_k, 0))
        self.scheduler.submit(req)

    @property
    def in_flight(self) -> int:
        """Launched iterations not yet retired; 0 once drained."""
        return len(self._ring)

    def run(self, max_iters: int = 10_000) -> list[Request]:
        done: list[Request] = []
        t0 = time.perf_counter()
        for _ in range(max_iters):
            tp = time.perf_counter()
            plan = self.scheduler.plan()
            self.stats.host_time += time.perf_counter() - tp
            if plan is None:
                if self._ring:
                    # nothing plans until in-flight results land (every
                    # request waits out its post-EOS window): retire the
                    # oldest iteration and plan again with its commits
                    done += self._retire_oldest()
                    continue
                break
            done += self.step(plan)
        done += self.drain()
        self.stats.wall_time += time.perf_counter() - t0
        return done

    def drain(self, max_retire: Optional[int] = None) -> list[Request]:
        """Retire in-flight iterations, oldest first: all of them (the exit
        barrier that ``run`` ends with, and that a caller looping over
        ``step`` itself must call after its loop), or at most ``max_retire``."""
        done: list[Request] = []
        retired = 0
        while self._ring and (max_retire is None or retired < max_retire):
            done += self._retire_oldest()
            retired += 1
        return done

    def evacuate(self, *, drain: bool = True) \
            -> tuple[list[Request], list[Request]]:
        """Checkpoint every unfinished request for re-dispatch on another
        replica (DESIGN.md §14) and release its slot and KV blocks.
        Returns ``(finished, moved)``.

        ``drain=True`` is the graceful leave: the in-flight iterations
        retire first, so their samples commit and the replay prefixes are
        as long as they can be, and each released slot's ``cache_len`` is
        cleared in place.  ``drain=False`` is the failure path: the ring is
        abandoned unfetched, so only committed tokens reach the checkpoint
        (nothing uncommitted is ever replayed), and the device is not
        touched.  A request whose committed output already holds EOS, or
        whose budget is spent, finishes here instead of moving."""
        finished: list[Request] = []
        if drain:
            finished += self.drain()
        else:
            # an abandoned entry's pinned buffer stays reserved by the
            # allocator until the copy into it has run
            self._ring.clear()
        moved: list[Request] = []
        sched = self.scheduler
        for r in list(sched.active) + list(sched.waiting):
            if r.state in (State.FINISHED, State.DISCARDED, State.REJECTED):
                continue
            if r.slot >= 0:
                self.slot_free.append(r.slot)
                self._pos[r.slot] = 0
                if drain:
                    self.cache_len[r.slot] = 0
                r.slot = -1
            self.kv.free(r.rid)
            folded = r.checkpoint_redispatch()
            if r.state == State.FINISHED:
                r.finished_at = self._clock()
                finished.append(r)
                continue
            self.stats.evacuated_requests += 1
            self.stats.evacuated_tokens += folded
            moved.append(r)
        sched.active = []
        sched.waiting.clear()
        return finished, moved

    def release(self) -> None:
        """Drop the device state (KV cache, slot tensors, in-flight ring) of
        an engine that will not step again, as a replica the pool has
        retired; its stats stay readable."""
        self._ring.clear()
        self.cache = self.cache_len = self.last_token = self.accept_len = None

    def step(self, plan: BatchPlan) -> list[Request]:
        """Run one iteration.  Packed: launch it, retire what has already
        landed (``async_harvest``), then retire the oldest until at most
        ``async_depth`` remain in flight.  Legacy: run it and commit it."""
        self.stats.iterations += 1
        self.stats.dense_batch_hist[plan.dense_batch] = \
            self.stats.dense_batch_hist.get(plan.dense_batch, 0) + 1
        if self.step_mode == "packed":
            self._ring.append(self._launch_packed(plan))
            finished: list[Request] = []
            if self.async_harvest and self.tp > 1:
                for _ in range(self._agreed_ready()):
                    finished += self._retire_oldest()
            elif self.async_harvest:
                while self._ring and self._ready(self._ring[0].done):
                    finished += self._retire_oldest()
            while len(self._ring) > self.async_depth:
                finished += self._retire_oldest()
            return finished
        self.scheduler.mark_launched(plan)
        sampled = self._step_legacy(plan)
        now = time.perf_counter()
        finished = self.scheduler.commit(plan, sampled, self._clock())
        for r in finished:
            self._finalize(r)
        self.stats.host_time += time.perf_counter() - now
        return finished

    # ---- packed iteration: one dispatch, one (deferred) host sync ------------
    def _retire_oldest(self) -> list[Request]:
        """Wait for the oldest in-flight iteration's payload, commit its
        samples to the scheduler and finalize what finished.  A verify
        slot's row is its ring ‖ accept_len: the first ``accept_len``
        entries are the committed run; other sample points read column 0."""
        inf = self._ring.popleft()
        payload = self._fetch(inf.host, inf.done)      # (max_slots, W + 1)
        t1 = time.perf_counter()
        w = self.spec_k + 1
        sampled: dict = {}
        for rid, s, kind in inf.sample_at:
            if kind == "verify":
                n_acc = int(min(max(payload[s, w], 1), w))
                sampled[rid] = [int(x) for x in payload[s, :n_acc]]
                self.stats.spec_verify_segments += 1
                self.stats.spec_proposed_tokens += self.spec_k
                self.stats.spec_accepted_tokens += n_acc - 1
                # launch counted the base sample; add the accepted drafts
                self.stats.decode_tokens += n_acc - 1
            else:
                sampled[rid] = int(payload[s, 0])
        finished = self.scheduler.commit(inf.plan, sampled, self._clock())
        for r in finished:
            self._finalize(r)
        if self.spec_k:
            # resync the host's position bound to the committed truth: the
            # device's cache_len after this commit, plus the worst case of
            # every launch still in flight
            for r in inf.plan.decode:
                if r.slot >= 0 and r.state not in (State.FINISHED,
                                                   State.DISCARDED):
                    self._pos[r.slot] = r.total_tokens - 1 + r.inflight
        self.stats.host_time += time.perf_counter() - t1
        return finished

    def _stage(self, result: torch.Tensor) \
            -> tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """Enqueue the device-to-host copy of a step's result now, in stream
        order behind the step, into host memory of its own (pinned, the copy
        non-blocking, and an event recorded after it, on the card; a plain
        copy on the CPU)."""
        cuda = self.device.type == "cuda"
        host = torch.empty(result.shape, dtype=result.dtype, pin_memory=cuda)
        host.copy_(result, non_blocking=cuda)
        if not cuda:
            return host, None
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _ready(done: Optional[torch.cuda.Event]) -> bool:
        return done is None or done.query()

    def _agreed_ready(self) -> int:
        """Under TP: the count of oldest in-flight iterations whose payload
        has landed on every rank (the least of the ranks' counts, over the
        host group: no device sync), so every rank retires the same ones
        and plans the same next batch."""
        n = 0
        while n < len(self._ring) and self._ready(self._ring[n].done):
            n += 1
        count = torch.tensor([n], dtype=torch.int64)
        dist.all_reduce(count, op=dist.ReduceOp.MIN, group=self._host_group)
        return int(count)

    def _fetch(self, host: torch.Tensor,
               done: Optional[torch.cuda.Event]) -> np.ndarray:
        """Wait for a staged copy, counting the sync, the time spent waiting
        and whether it had to wait (``done`` not yet reached)."""
        t0 = time.perf_counter()
        ready = self._ready(done)
        if done is not None:
            done.synchronize()
        out = host.numpy()
        self.stats.blocked_sync_time += time.perf_counter() - t0
        self.stats.host_syncs += 1
        if not ready:
            self.stats.blocking_syncs += 1
        return out

    def _upload(self, host_block: np.ndarray) -> torch.Tensor:
        """The iteration's one host-to-device copy.  On the card it goes from
        pinned memory of its own, without blocking: the host may build the
        next iteration's block before this copy has run."""
        block = torch.from_numpy(host_block)
        if self.device.type != "cuda":
            return block.to(self.device)
        return block.pin_memory().to(self.device, non_blocking=True)

    def _launch_packed(self, plan: BatchPlan) -> _InFlight:
        t_host = time.perf_counter()
        packed = self.scheduler.pack(plan, nano=self.nano)
        w = self.spec_k + 1
        reset = np.zeros((self.max_slots,), np.int32)
        for seg in packed.segments:
            r = seg.req
            if r.slot < 0:
                if not self.slot_free:
                    raise RuntimeError("scheduler admitted beyond slot capacity")
                r.slot = self.slot_free.pop()
                reset[r.slot] = 1
                self._pos[r.slot] = 0

        bs = self.kv.page_size
        oob = self.max_slots * self.max_len
        if self.prefix_caching:
            # decode writes land at _pos[slot] .. _pos[slot] + W - 1 (the
            # worst case under speculation): grow the block table and make
            # the written blocks private now, launch-side, so the write
            # targets exist before the commit's ``extend`` (DESIGN.md §12)
            for seg in packed.segments:
                if seg.is_decode:
                    self.kv.ensure(seg.req.rid,
                                   int(self._pos[seg.req.slot]) + w)

        t_total = packed.launch_tokens
        meta = np.zeros((len(_META_ROWS), t_total), np.int32)
        tokens, slot, pos, active, from_last, sample_slot, rid = meta
        # non-sample positions scatter out of bounds -> dropped; verify
        # segments are not sample points: their rows land through the
        # acceptance path
        sample_slot[:] = self.max_slots
        # per-slot stream positions of its verify segment (§13); t_total
        # marks a slot without one
        verify_idx = np.full((self.max_slots, w), t_total, np.int32)
        # block-table operands (prefix mode): each token's flat cache row
        # (padding, uncovered rows and verify segments, whose rows the
        # device computes: the out-of-bounds N·S) and the per-slot tables
        token_dst = np.full((t_total,), oob, np.int32)
        tables = np.zeros((self.max_slots, self._nb_cols), np.int32)
        sample_at: list[tuple[int, int, str]] = []
        t = 0
        for seg in packed.segments:
            r = seg.req
            tbl = None
            if self.prefix_caching:
                tbl = np.asarray(self.kv.table(r.rid), np.int64)
                # tables are sized by *predicted* length, which may run past
                # max_len: only the addressable prefix is gathered
                nb = min(len(tbl), self._nb_cols)
                tables[r.slot, :nb] = tbl[:nb]
            rid[t:t + seg.length] = r.rid & 0x7FFFFFFF
            if seg.is_decode:
                # the first token comes from the ring on the device; the
                # positions are the host's bound (the device's are exact)
                from_last[t] = 1
                slot[t:t + w] = r.slot
                p = int(self._pos[r.slot])
                pos[t:t + w] = p + np.arange(w)
                active[t:t + w] = 1
                if self.spec_k:
                    tokens[t + 1:t + w] = seg.draft
                    verify_idx[r.slot] = np.arange(t, t + w)
                    sample_at.append((r.rid, r.slot, "verify"))
                else:
                    sample_slot[t] = r.slot
                    sample_at.append((r.rid, r.slot, "decode"))
                    if tbl is not None and p // bs < len(tbl):
                        token_dst[t] = tbl[p // bs] * bs + p % bs
                t += w
            else:
                ln = seg.length
                tokens[t:t + ln] = r.prompt[seg.offset:seg.offset + ln]
                slot[t:t + ln] = r.slot
                qs = np.arange(seg.offset, seg.offset + ln)
                pos[t:t + ln] = qs
                active[t:t + ln] = 1
                if tbl is not None and len(tbl):
                    cov = qs // bs < len(tbl)
                    token_dst[t:t + ln] = np.where(
                        cov, tbl[np.minimum(qs // bs, len(tbl) - 1)] * bs
                        + qs % bs, oob)
                if seg.offset + ln == r.prompt_len:
                    sample_slot[t + ln - 1] = r.slot
                    sample_at.append((r.rid, r.slot, "prefill"))
                t += ln
        assert t == packed.tokens, (t, packed.tokens)

        # every attended row must sit below the iteration's KV bucket (the
        # host positions are the worst case, so the check is sufficient)
        kv_bucket = packed.kv_bucket if packed.kv_bucket is not None \
            else self.max_len
        act = active.astype(bool)
        assert not act.any() or int(pos[act].max()) < kv_bucket, \
            (int(pos[act].max()), kv_bucket)
        self.stats.kv_bucket_hist[kv_bucket] = \
            self.stats.kv_bucket_hist.get(kv_bucket, 0) + 1
        self.stats.packed_attn_kv_rows += packed.launch_tokens * kv_bucket
        self.launch_shapes.add((t_total, kv_bucket))

        # launch-side bookkeeping before the dispatch: the next plan may be
        # formed while this iteration is still on the device (§10)
        self.scheduler.mark_launched(plan)
        n_decode = 0
        for seg in packed.segments:
            if seg.is_decode:
                self._pos[seg.req.slot] += w
                n_decode += 1
            else:
                self._pos[seg.req.slot] = seg.offset + seg.length
        # the base sample of each decode or verify segment; accepted drafts
        # are added at retire
        self.stats.decode_tokens += n_decode
        self.stats.prefill_tokens += packed.tokens - n_decode * w
        self.stats.prefill_model_tokens += packed.tokens - n_decode * w
        self.stats.packed_pad_tokens += packed.padding
        if self.tp > 1:
            self.stats.tp_collective_bytes += \
                packed.launch_tokens * self._tp_iter_bytes
        if self._cache_kv_dtype is not None:
            # every real token scatters one quantized row per layer
            self.stats.kv_quant_bytes_saved += packed.tokens * \
                (self._kv_bytes_native - self.kv.bytes_per_token)

        parts = [meta.reshape(-1), reset]
        if self.spec_k:
            parts.append(verify_idx.reshape(-1))
        n_copy_rows = 0
        if self.prefix_caching:
            # queued copy-on-write block copies run on the device before the
            # forward, inside the same step: their rows ride this block
            copies = np.asarray(self.kv.take_pending_copies(),
                                np.int32).reshape(-1, 2)
            rows = (copies[:, :, None] * bs
                    + np.arange(bs, dtype=np.int32)).transpose(1, 0, 2)
            n_copy_rows = rows.shape[1] * bs
            parts += [token_dst, tables.reshape(-1), rows.reshape(-1)]
        host_block = np.concatenate(parts)
        t_disp = time.perf_counter()
        self.stats.host_time += t_disp - t_host
        host, done = self._stage(self._packed_core(
            host_block, t_total, kv_bucket, n_copy_rows, packed.nano.sizes))
        self.stats.dispatch_time += time.perf_counter() - t_disp
        self.stats.model_dispatches += 1
        return _InFlight(plan=plan, sample_at=sample_at, host=host,
                         done=done)

    def _packed_core(self, host_block: np.ndarray, t_total: int,
                     kv_bucket: int, n_copy_rows: int,
                     nano: tuple[int, ...]) -> torch.Tensor:
        """The whole iteration on the device: apply the queued block copies
        (prefix mode), reset reused slots' recurrent state, put the verify
        segments at their true positions (``cache_len + j``; under prefix
        caching their write rows too, through the block tables), substitute
        the decode placeholders from the ring, run the packed forward,
        sample, accept each verify segment's longest matching draft prefix,
        advance ``cache_len`` (verify slots by the accepted count only: the
        rollback) and write the samples into the ring.  Under TP the
        forward runs in ``tp.tp_ctx`` with the launch's nano-batch split
        ``nano``.  Returns a new payload tensor, ring ‖ accept_len
        ``(max_slots, W + 1)``."""
        block = self._upload(host_block)
        n, w = self.max_slots, self.spec_k + 1
        n_meta = len(_META_ROWS) * t_total
        tokens, slot, pos, active, from_last, sample_slot, rid = \
            block[:n_meta].view(len(_META_ROWS), t_total)
        at = n_meta + n
        reset = block[n_meta:at].bool()
        verify_idx = None
        if self.spec_k:
            verify_idx = block[at:at + n * w].view(n, w)
            at += n * w
        token_dst = block_tables = None
        if self.prefix_caching:
            n_tbl = n * self._nb_cols
            token_dst = block[at:at + t_total]
            block_tables = block[at + t_total:at + t_total + n_tbl] \
                .view(n, self._nb_cols)
            at += t_total + n_tbl
            if n_copy_rows:
                src, dst = block[at:at + 2 * n_copy_rows].long() \
                    .view(2, n_copy_rows)
                self._copy_rows(src, dst)
        active = active.bool()
        if self.recurrent:
            self._reset_recurrent(reset)
        if self.spec_k:
            vflat = verify_idx.reshape(-1)
            vpos = self.cache_len[:, None] + torch.arange(
                w, dtype=torch.int32, device=self.device)
            pos = sampling.scatter_last(pos, vflat, vpos.reshape(-1))
            is_verify = sampling.scatter_last(
                torch.zeros_like(active), vflat,
                torch.ones_like(vflat, dtype=torch.bool))
            verify_on = verify_idx[:, 0] < t_total
        wpos = torch.where(active, pos, self.max_len)
        toks = sampling.substitute_last(tokens[None], self.last_token, slot,
                                        from_last.bool(),
                                        accept_len=self.accept_len)
        if self.prefix_caching and self.spec_k:
            # verify writes follow the device's positions through the
            # slot's block table (the host left them out of bounds)
            bs = self.kv.page_size
            col = torch.clamp(pos // bs, max=self._nb_cols - 1).long()
            vdst = block_tables[slot.long(), col] * bs + pos % bs
            token_dst = torch.where(is_verify & active, vdst, token_dst)
        with tp_lib.tp_ctx(self._group, nano):
            logits, self.cache = model_lib.forward_packed(
                self.cfg, self.params, self._model_tokens(toks), self.cache,
                slot, pos, wpos, active, kv_bucket=kv_bucket,
                token_dst=token_dst, block_tables=block_tables)
        if self.temperature > 0:
            next_tok = self._sample(logits[0], pos, rid, sample_slot,
                                    verify_idx)
        else:
            next_tok = self._codebook0(sampling.greedy(logits[0]))
        new_len = torch.where(reset, 0, self.cache_len)
        ring, n_acc = self.last_token, self.accept_len
        grow = active
        if self.spec_k:
            # per verify slot: its W inputs and W target samples (the fill
            # values never match on slots without a segment)
            seg_in = _take(toks[0], verify_idx, -1)
            seg_out = _take(next_tok, verify_idx, -2)
            # draft j is accepted iff it equals target sample j - 1; the
            # accepted run is the longest matching prefix
            match = (seg_in[:, 1:] == seg_out[:, :-1]).to(torch.int32)
            acc = torch.cumprod(match, dim=1, dtype=torch.int32) \
                .sum(dim=1, dtype=torch.int32)
            n_acc = torch.where(verify_on, acc + 1, n_acc)
            ring = torch.where(verify_on[:, None], seg_out, ring)
            grow = active & ~is_verify
        new_len = new_len.scatter_reduce(
            0, slot.long(), torch.where(grow, pos + 1, 0), reduce="amax")
        if self.spec_k:
            new_len = torch.where(verify_on, self.cache_len + acc + 1,
                                  new_len)
        # single-sample points (prefill-final; every decode at spec_k 0)
        # write ring column 0 with accept_len 1
        ring = sampling.scatter_last(ring, sample_slot, next_tok)
        n_acc = sampling.scatter_last(n_acc, sample_slot,
                                      torch.ones_like(next_tok))
        self.cache_len, self.last_token, self.accept_len = new_len, ring, n_acc
        return torch.cat([ring, n_acc[:, None]], dim=1)

    def _sample(self, logits: torch.Tensor, pos: torch.Tensor,
                rid: torch.Tensor, sample_slot: torch.Tensor,
                verify_idx: Optional[torch.Tensor]) -> torch.Tensor:
        """Stochastic next tokens of the stream (T,), drawn only at its
        sample points: each slot's single sample point and every verify
        position, a fixed ``max_slots × (spec_k + 2)`` rows found on the
        device (the stream's length T stands for "none" and is dropped).
        Every other row is 0 and never read."""
        t, n = logits.shape[0], self.max_slots
        ss = sample_slot.long()
        ss = torch.where((ss >= 0) & (ss < n), ss, n)
        single = torch.full((n + 1,), t, dtype=torch.int64,
                            device=self.device)
        single.index_copy_(0, ss, torch.arange(t, device=self.device))
        rows = single[:n]
        if verify_idx is not None:
            rows = torch.cat([verify_idx.reshape(-1).long(), rows])
        at = rows.clamp(max=t - 1)
        keys = sampling.packed_keys(self.seed, rid[at], pos[at],
                                    self.max_len + 1)
        drawn = self._codebook0(sampling.sample_tokens(
            logits[at], keys, self.temperature, self.top_k))
        out = torch.zeros((t + 1,), dtype=torch.int32, device=self.device)
        out.index_copy_(0, rows, drawn)
        return out[:t]

    def _model_tokens(self, toks: torch.Tensor) -> torch.Tensor:
        """Token ids as the model takes them: the audio stub's repeated
        across its K codebooks (a view), as JAX's engine repeats them."""
        if self.cfg.frontend != "audio":
            return toks
        return toks[..., None].expand(*toks.shape, self.cfg.num_codebooks)

    def _codebook0(self, sampled: torch.Tensor) -> torch.Tensor:
        """Samples as the engine keeps them: codebook 0 of the audio
        stub's (..., K) samples (the one rule of every step path)."""
        return sampled[..., 0] if self.cfg.frontend == "audio" else sampled

    def _reset_recurrent(self, reset: torch.Tensor) -> None:
        """Reset the recurrent state of the slots in ``reset`` to its
        initial value (a reused slot must not leak the previous request's
        state; the port of the JAX ``_reset_recurrent``), in place on the
        device.  Attention leaves need no reset: rows past a request's
        written extent are never attended."""
        for fill, layer in zip(self._state_fill, self.cache):
            if fill is not None:
                for name, leaf in layer.items():
                    m = reset.view(-1, *(1,) * (leaf.dim() - 1))
                    leaf.masked_fill_(m, fill[name])

    # ---- legacy iteration: decode dispatch + one dispatch per chunk ----------
    def _step_legacy(self, plan: BatchPlan) -> dict[int, int]:
        sampled: dict[int, int] = {}

        # batched decode over all slots (static shape)
        decode_reqs = [r for r in plan.decode if r.slot >= 0]
        if decode_reqs:
            host = np.zeros((2, self.max_slots), np.int32)
            tokens, active = host
            for r in decode_reqs:
                tokens[r.slot] = r.output[-1] if r.output else r.prompt[-1]
                active[r.slot] = 1
            block = torch.from_numpy(host).to(self.device)
            t_disp = time.perf_counter()
            logits, new_cache = model_lib.forward_decode(
                self.cfg, self.params, self._model_tokens(block[0][:, None]),
                self.cache, self.cache_len)
            # attention leaves were written in place; recurrent states
            # commit only for the decoding slots
            act = block[1].bool()
            for spec, old, new in zip(self.cfg.layer_specs(), self.cache,
                                      new_cache):
                if spec.mixer != ATTN:
                    for name, leaf in old.items():
                        m = act.view(-1, *(1,) * (leaf.dim() - 1))
                        leaf.copy_(torch.where(m, new[name], leaf))
            next_tok = self._codebook0(sampling.greedy(logits))
            staged = self._stage(next_tok)
            self.stats.dispatch_time += time.perf_counter() - t_disp
            self.stats.model_dispatches += 1
            self.cache_len = self.cache_len + block[1]
            nt = self._fetch(*staged)
            for r in decode_reqs:
                sampled[r.rid] = int(nt[r.slot])
                self._pos[r.slot] += 1
            self.stats.decode_tokens += len(decode_reqs)

        # chunked prefill
        for chunk in plan.prefill:
            r = chunk.req
            if r.slot < 0:
                if not self.slot_free:
                    raise RuntimeError("scheduler admitted beyond slot capacity")
                r.slot = self.slot_free.pop()
                self._pos[r.slot] = 0
                if self.prefill_mode == "incremental":
                    self._reset_slot(r.slot)
                    self.stats.model_dispatches += 1
            if self.prefill_mode == "incremental":
                last_tok = self._prefill_chunk(r, chunk.offset, chunk.length)
                self.stats.prefill_model_tokens += chunk.length
            else:
                last_tok = self._prefill_to(r, chunk.offset + chunk.length)
                self.stats.prefill_model_tokens += chunk.offset + chunk.length
            self.stats.prefill_tokens += chunk.length
            self._pos[r.slot] = chunk.offset + chunk.length
            if chunk.offset + chunk.length == r.prompt_len:
                sampled[r.rid] = last_tok
        return sampled

    def _prefill_chunk(self, r: Request, offset: int, length: int) -> int:
        """Incremental path: run exactly ``length`` new prompt tokens
        against the slot's carried cache, through the slot's ``(1, S, ...)``
        view of every leaf (written in place; a Mamba layer's new state is
        copied into its views).  The tokens and the offset go up in one
        host-to-device copy."""
        host = np.asarray(r.prompt[offset:offset + length] + [offset],
                          np.int32)
        block = torch.from_numpy(host).to(self.device)
        t_disp = time.perf_counter()
        sub = [{name: leaf[r.slot:r.slot + 1] for name, leaf in layer.items()}
               for layer in self.cache]
        logits, _ = model_lib.forward_chunk(
            self.cfg, self.params, self._model_tokens(block[None, :length]),
            sub, block[length:])
        next_tok = self._codebook0(sampling.greedy(logits[:, -1]))
        staged = self._stage(next_tok)
        self.stats.dispatch_time += time.perf_counter() - t_disp
        self.stats.model_dispatches += 1
        self.cache_len[r.slot] = offset + length
        return int(self._fetch(*staged)[0])

    def _prefill_to(self, r: Request, upto: int) -> int:
        """Recompute path (``prefill_mode="recompute"``, kept for A/B):
        rerun ``forward_full`` over the whole prefix [0, upto) and write its
        K/V into the slot's first ``upto`` rows."""
        toks = torch.from_numpy(np.asarray(r.prompt[:upto], np.int32)) \
            .to(self.device)[None]
        t_disp = time.perf_counter()
        logits, _aux, states = model_lib.forward_full(
            self.cfg, self.params, self._model_tokens(toks),
            return_states=True)
        next_tok = self._codebook0(sampling.greedy(logits[:, -1]))
        staged = self._stage(next_tok)
        self.stats.dispatch_time += time.perf_counter() - t_disp
        self.stats.model_dispatches += 1
        self._scatter_states(r.slot, states)
        self.cache_len[r.slot] = upto
        return int(self._fetch(*staged)[0])

    def _scatter_states(self, slot: int, states: list) -> None:
        """Write each attention layer's prefix K/V (MLA's latent c_kv and
        k_rope) into rows [0, s) of ``slot`` and each recurrent layer's
        state whole into the slot (the port of the JAX ``_scatter_states``
        / ``_write_slot_seq`` / ``_write_slot``)."""
        names = attn.kv_names(self.cfg)
        for spec, layer, st in zip(self.cfg.layer_specs(), self.cache,
                                   states):
            if spec.mixer == ATTN:
                for name, val in zip(names, st["kv"]):
                    layer[name][slot, :val.shape[1]] = val[0]
            else:
                for name, leaf in layer.items():
                    leaf[slot].copy_(st[name][0])

    def _reset_slot(self, slot: int) -> None:
        """Set the slot's rows of every leaf to their initial value in
        place: zeros, and a recurrent leaf's own initial value (the JAX
        ``_reset_slot`` scatters a fresh one-slot cache)."""
        for fill, layer in zip(self._state_fill, self.cache):
            for name, leaf in layer.items():
                leaf[slot].fill_(0 if fill is None else fill[name])

    def _copy_rows(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """Copy-on-write block copies (port of the JAX ``_cow_impl``): flat
        cache rows ``src`` to ``dst`` in every leaf of every layer, one
        indexed copy per leaf, in stream order before the forward — no
        host sync.  No row is both a source and a destination (a copy's
        destination is a fresh private block)."""
        for layer in self.cache:
            for leaf in layer.values():
                flat = leaf.view((-1,) + tuple(leaf.shape[2:]))
                flat.index_copy_(0, dst, flat.index_select(0, src))

    def _finalize(self, r: Request) -> None:
        if r.slot >= 0:
            self.slot_free.append(r.slot)
            self.cache_len[r.slot] = 0
            self._pos[r.slot] = 0
            r.slot = -1
        # strip the post-EOS overshoot (async EOS, §5.3)
        if r.pending_eos and r.eos_id is not None and r.eos_id in r.output:
            r.output = r.output[: r.output.index(r.eos_id) + 1]
        self.kv.offload(r.rid,
                        nbytes=max(r.total_tokens * self.kv.bytes_per_token, 1))
