"""Serving engine (port of ``repro.serving.engine.ServeEngine`` for greedy
serving at tp=1 and ``async_depth=0``): the token-packed single-dispatch
step in all four KV modes — contiguous or block-table caches with prefix
caching (DESIGN.md §12), each with native or int8 KV (§15) — and the legacy
step kept for A/B (``step_mode="legacy"``, with incremental or recompute
prefill).

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

**Recurrent state** (Mamba layers of a hybrid): a slot's ``{"conv",
"ssm"}`` state is advanced by every token of its request and must not be
by anything else.  The legacy decode commits it only for the decoding
slots (a mid-prefill slot's garbage decode token would advance it); a
chunk writes its new state back into the slot's views; recompute writes
the whole state of the prefix; a slot taken by a new request starts from
zeros (the legacy reset, or, on the packed step, a masked select on the
device before the forward).  Prefix caching and speculative decoding
refuse models with recurrent layers, as in JAX: their state can neither
be shared by blocks nor rolled back.

**Packed step.**  One iteration = one call of the packed step: the decode
tokens (one per decoding slot) and every scheduled prefill chunk are packed
into a single ``(1, T)`` stream with per-token ``(slot, position)``
metadata, run through ``model.forward_packed`` (K/V scattered at each
segment's offset, attention masked to each token's own slot), sampled
greedily on the device, and the samples scattered into a device-resident
per-slot ``last_token`` buffer from which the next iteration's decode
inputs are gathered on the device.  The host metadata (with, under prefix
caching, each token's physical cache row, the per-slot block tables and the
rows of the iteration's copy-on-write block copies) goes up in one
host-to-device copy, and the only device-to-host transfer is the
``last_token`` payload, once per iteration (``EngineStats.model_dispatches``
/ ``host_syncs``).  ``T`` is bucketed to the scheduler's discrete sizes and
attention sweeps only the iteration's KV-length bucket (DESIGN.md §9).

Both steps run eagerly; capturing the packed step in a CUDA graph per (T
bucket, kv bucket) is ROADMAP A3's remaining work, and the async pipeline
(``async_depth >= 1``) is A4.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.serving import sampling
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.kvcache import PagedKVManager
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import BatchPlan, GlobalBatchScheduler

# rows of the per-iteration host metadata block (one H2D copy)
_META_ROWS = ("tokens", "slot", "pos", "active", "from_last", "sample_slot")


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
    # cache bytes the int8 rows did not write vs the native dtype (§15)
    kv_quant_bytes_saved: int = 0

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

    _DERIVED = ("total_tokens", "throughput", "prefill_expansion",
                "dispatches_per_iter", "syncs_per_iter")

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
    """One launched packed iteration, until its payload reaches the host."""
    plan: BatchPlan
    sample_at: list              # (rid, slot) pairs
    payload: torch.Tensor        # last_token after the step, on the device
    done: Optional[torch.cuda.Event]


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: dict,
                 config: Optional[EngineConfig] = None, *,
                 device: Optional[str | torch.device] = None):
        """``ServeEngine(cfg, params, EngineConfig(...))`` runs on ``cuda``
        unless ``device`` names another; ``params`` must already live
        there (``model.init(cfg, device=...)``)."""
        self.device = resolve_device(device)
        model_lib.check_config(cfg)
        if params["embed"].device != self.device:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine on {self.device}")
        config = config if config is not None else EngineConfig()
        self.config = config
        self.cfg = cfg
        self.params = params
        self.recurrent = any(spec.mixer != ATTN
                             for spec in cfg.layer_specs())
        if self.recurrent:
            # as the JAX engine refuses it: recurrent state cannot be
            # block-shared (speculative decoding, which JAX refuses too,
            # is refused for every model by EngineConfig until ROADMAP A8)
            if config.prefix_caching:
                raise ValueError("prefix caching (DESIGN.md §12) needs "
                                 "attention-only models")
            if config.kv_dtype == "int8":
                raise NotImplementedError(
                    "int8 KV on models with recurrent layers is ROADMAP A9")
        self.max_slots = config.max_slots
        self.max_len = config.max_len
        self.prefill_mode = config.prefill_mode
        self.step_mode = config.resolved_step_mode
        self.nano = config.nano
        self.kv_buckets = config.resolved_kv_buckets()

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
            max_request_len=self.max_len)

        dev = self.device
        self.cache = model_lib.init_cache(cfg, self.max_slots, self.max_len,
                                          device=dev,
                                          kv_dtype=self._cache_kv_dtype)
        self.cache_len = torch.zeros((self.max_slots,), dtype=torch.int32,
                                     device=dev)
        # device-resident sampled-token feedback: the packed step scatters
        # each sample point's token here and gathers the next iteration's
        # decode inputs from it on the device
        self.last_token = torch.zeros((self.max_slots,), dtype=torch.int32,
                                      device=dev)
        self.slot_free = list(range(self.max_slots))
        self.stats = EngineStats()
        # host mirror of each slot's context length: the packed stream's
        # positions come from here without any device read
        self._pos = np.zeros((self.max_slots,), np.int64)

    # ---- public API ----------------------------------------------------------
    def submit(self, req: Request) -> None:
        # a slot holds max_len positions: never decode past the cache
        req.max_new_tokens = min(req.max_new_tokens,
                                 max(self.max_len - req.prompt_len, 0))
        self.scheduler.submit(req)

    def run(self, max_iters: int = 10_000) -> list[Request]:
        done: list[Request] = []
        t0 = time.perf_counter()
        for _ in range(max_iters):
            tp = time.perf_counter()
            plan = self.scheduler.plan()
            self.stats.host_time += time.perf_counter() - tp
            if plan is None:
                break
            done += self.step(plan)
        self.stats.wall_time += time.perf_counter() - t0
        return done

    def step(self, plan: BatchPlan) -> list[Request]:
        """Run one iteration: launch the packed step and retire it
        (``async_depth=0``), or run the legacy step and commit it."""
        self.stats.iterations += 1
        self.stats.dense_batch_hist[plan.dense_batch] = \
            self.stats.dense_batch_hist.get(plan.dense_batch, 0) + 1
        if self.step_mode == "packed":
            return self._retire_oldest(self._launch_packed(plan))
        self.scheduler.mark_launched(plan)
        sampled = self._step_legacy(plan)
        now = time.perf_counter()
        finished = self.scheduler.commit(plan, sampled, now)
        for r in finished:
            self._finalize(r)
        self.stats.host_time += time.perf_counter() - now
        return finished

    # ---- packed iteration: one dispatch, one host sync -----------------------
    def _retire_oldest(self, inf: _InFlight) -> list[Request]:
        """Copy the iteration's payload to the host, commit its samples to
        the scheduler and finalize what finished."""
        payload = self._fetch(inf.payload, inf.done)
        t1 = time.perf_counter()
        sampled = {rid: int(payload[s]) for rid, s in inf.sample_at}
        finished = self.scheduler.commit(inf.plan, sampled, time.perf_counter())
        for r in finished:
            self._finalize(r)
        self.stats.host_time += time.perf_counter() - t1
        return finished

    def _fetch(self, payload: torch.Tensor,
               done: Optional[torch.cuda.Event]) -> np.ndarray:
        """Device-to-host copy of a step's result, counting the sync, the
        time spent waiting and whether it had to wait (``done`` not yet
        reached)."""
        t0 = time.perf_counter()
        ready = done is None or done.query()
        out = payload.cpu().numpy()
        self.stats.blocked_sync_time += time.perf_counter() - t0
        self.stats.host_syncs += 1
        if not ready:
            self.stats.blocking_syncs += 1
        return out

    def _launch_packed(self, plan: BatchPlan) -> _InFlight:
        t_host = time.perf_counter()
        packed = self.scheduler.pack(plan, nano=self.nano)
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
            # a decode token writes row _pos[slot]: grow its block table and
            # make the written block private now, launch-side, so the write
            # target exists before the commit's ``extend`` (DESIGN.md §12)
            for seg in packed.segments:
                if seg.is_decode:
                    self.kv.ensure(seg.req.rid, int(self._pos[seg.req.slot]) + 1)

        t_total = packed.launch_tokens
        meta = np.zeros((len(_META_ROWS), t_total), np.int32)
        tokens, slot, pos, active, from_last, sample_slot = meta
        # non-sample positions scatter out of bounds -> dropped
        sample_slot[:] = self.max_slots
        # block-table operands (prefix mode): each token's flat cache row
        # (padding and uncovered rows: the out-of-bounds N·S) and the
        # per-slot tables
        token_dst = np.full((t_total,), oob, np.int32)
        tables = np.zeros((self.max_slots, self._nb_cols), np.int32)
        sample_at: list[tuple[int, int]] = []
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
            if seg.is_decode:
                # the token itself comes from last_token on the device
                from_last[t] = 1
                slot[t] = r.slot
                p = self._pos[r.slot]
                pos[t] = p
                active[t] = 1
                sample_slot[t] = r.slot
                sample_at.append((r.rid, r.slot))
                if tbl is not None and p // bs < len(tbl):
                    token_dst[t] = tbl[p // bs] * bs + p % bs
                t += 1
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
                    sample_at.append((r.rid, r.slot))
                t += ln
        assert t == packed.tokens, (t, packed.tokens)

        # every attended row must sit below the iteration's KV bucket
        kv_bucket = packed.kv_bucket if packed.kv_bucket is not None \
            else self.max_len
        act = active.astype(bool)
        assert not act.any() or int(pos[act].max()) < kv_bucket, \
            (int(pos[act].max()), kv_bucket)
        self.stats.kv_bucket_hist[kv_bucket] = \
            self.stats.kv_bucket_hist.get(kv_bucket, 0) + 1
        self.stats.packed_attn_kv_rows += packed.launch_tokens * kv_bucket

        self.scheduler.mark_launched(plan)
        n_decode = 0
        for seg in packed.segments:
            if seg.is_decode:
                self._pos[seg.req.slot] += 1
                n_decode += 1
            else:
                self._pos[seg.req.slot] = seg.offset + seg.length
        self.stats.decode_tokens += n_decode
        self.stats.prefill_tokens += packed.tokens - n_decode
        self.stats.prefill_model_tokens += packed.tokens - n_decode
        self.stats.packed_pad_tokens += packed.padding
        if self._cache_kv_dtype is not None:
            # every real token scatters one quantized row per layer
            self.stats.kv_quant_bytes_saved += packed.tokens * \
                (self._kv_bytes_native - self.kv.bytes_per_token)

        parts = [meta.reshape(-1), reset]
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
        payload = self._packed_core(host_block, t_total, kv_bucket,
                                    n_copy_rows)
        done = self._launched()
        self.stats.dispatch_time += time.perf_counter() - t_disp
        self.stats.model_dispatches += 1
        return _InFlight(plan=plan, sample_at=sample_at, payload=payload,
                         done=done)

    def _packed_core(self, host_block: np.ndarray, t_total: int,
                     kv_bucket: int, n_copy_rows: int) -> torch.Tensor:
        """The whole iteration on the device: apply the queued block copies
        (prefix mode), substitute the decode placeholders from
        ``last_token``, run the packed forward, sample greedily, scatter
        the samples into ``last_token`` and advance ``cache_len``.  Returns
        the new ``last_token`` (the payload)."""
        block = torch.from_numpy(host_block).to(self.device)
        n_meta = len(_META_ROWS) * t_total
        tokens, slot, pos, active, from_last, sample_slot = \
            block[:n_meta].view(len(_META_ROWS), t_total)
        at = n_meta + self.max_slots
        reset = block[n_meta:at].bool()
        token_dst = block_tables = None
        if self.prefix_caching:
            n_tbl = self.max_slots * self._nb_cols
            token_dst = block[at:at + t_total]
            block_tables = block[at + t_total:at + t_total + n_tbl] \
                .view(self.max_slots, self._nb_cols)
            at += t_total + n_tbl
            if n_copy_rows:
                src, dst = block[at:at + 2 * n_copy_rows].long() \
                    .view(2, n_copy_rows)
                self._copy_rows(src, dst)
        active = active.bool()
        if self.recurrent:
            self._reset_recurrent(reset)
        wpos = torch.where(active, pos, self.max_len)
        toks = sampling.substitute_last(tokens[None], self.last_token, slot,
                                        from_last.bool())
        logits, self.cache = model_lib.forward_packed(
            self.cfg, self.params, toks, self.cache, slot, pos, wpos, active,
            kv_bucket=kv_bucket, token_dst=token_dst,
            block_tables=block_tables)
        next_tok = sampling.greedy(logits[0])
        new_len = torch.where(reset, 0, self.cache_len)
        self.cache_len = new_len.scatter_reduce(
            0, slot.long(), torch.where(active, pos + 1, 0), reduce="amax")
        self.last_token = sampling.scatter_last(self.last_token, sample_slot,
                                                next_tok)
        return self.last_token

    def _reset_recurrent(self, reset: torch.Tensor) -> None:
        """Zero the recurrent state of the slots in ``reset`` (a reused slot
        must not leak the previous request's state; the port of the JAX
        ``_reset_recurrent``), in place on the device.  Attention leaves
        need no reset: rows past a request's written extent are never
        attended."""
        for spec, layer in zip(self.cfg.layer_specs(), self.cache):
            if spec.mixer != ATTN:
                for leaf in layer.values():
                    m = reset.view(-1, *(1,) * (leaf.dim() - 1))
                    leaf.masked_fill_(m, 0)

    def _launched(self) -> Optional[torch.cuda.Event]:
        """An event after the work enqueued so far (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        done = torch.cuda.Event()
        done.record()
        return done

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
                self.cfg, self.params, block[0][:, None], self.cache,
                self.cache_len)
            # attention leaves were written in place; recurrent states
            # commit only for the decoding slots
            act = block[1].bool()
            for spec, old, new in zip(self.cfg.layer_specs(), self.cache,
                                      new_cache):
                if spec.mixer != ATTN:
                    for name, leaf in old.items():
                        m = act.view(-1, *(1,) * (leaf.dim() - 1))
                        leaf.copy_(torch.where(m, new[name], leaf))
            next_tok = sampling.greedy(logits)
            done = self._launched()
            self.stats.dispatch_time += time.perf_counter() - t_disp
            self.stats.model_dispatches += 1
            self.cache_len = self.cache_len + block[1]
            nt = self._fetch(next_tok, done)
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
        logits, _ = model_lib.forward_chunk(self.cfg, self.params,
                                            block[None, :length], sub,
                                            block[length:])
        next_tok = sampling.greedy(logits[:, -1])
        done = self._launched()
        self.stats.dispatch_time += time.perf_counter() - t_disp
        self.stats.model_dispatches += 1
        self.cache_len[r.slot] = offset + length
        return int(self._fetch(next_tok, done)[0])

    def _prefill_to(self, r: Request, upto: int) -> int:
        """Recompute path (``prefill_mode="recompute"``, kept for A/B):
        rerun ``forward_full`` over the whole prefix [0, upto) and write its
        K/V into the slot's first ``upto`` rows."""
        toks = torch.from_numpy(np.asarray(r.prompt[:upto], np.int32)) \
            .to(self.device)[None]
        t_disp = time.perf_counter()
        logits, _aux, states = model_lib.forward_full(
            self.cfg, self.params, toks, return_states=True)
        next_tok = sampling.greedy(logits[:, -1])
        done = self._launched()
        self.stats.dispatch_time += time.perf_counter() - t_disp
        self.stats.model_dispatches += 1
        self._scatter_states(r.slot, states)
        self.cache_len[r.slot] = upto
        return int(self._fetch(next_tok, done)[0])

    def _scatter_states(self, slot: int, states: list) -> None:
        """Write each attention layer's prefix K/V into rows [0, s) of
        ``slot`` and each recurrent layer's state whole into the slot (the
        port of the JAX ``_scatter_states`` / ``_write_slot_seq`` /
        ``_write_slot``)."""
        for spec, layer, st in zip(self.cfg.layer_specs(), self.cache,
                                   states):
            if spec.mixer == ATTN:
                k, v = st["kv"]
                layer["k"][slot, :k.shape[1]] = k[0]
                layer["v"][slot, :v.shape[1]] = v[0]
            else:
                for name, leaf in layer.items():
                    leaf[slot].copy_(st[name][0])

    def _reset_slot(self, slot: int) -> None:
        """Zero the slot's rows of every leaf in place, recurrent state
        included (the JAX ``_reset_slot`` scatters a fresh one-slot cache,
        whose recurrent state is zeros too)."""
        for layer in self.cache:
            for leaf in layer.values():
                leaf[slot].zero_()

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
