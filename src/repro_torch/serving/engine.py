"""Serving engine on the token-packed single-dispatch step (port of
``repro.serving.engine.ServeEngine`` for the packed greedy path at tp=1,
bf16 KV, ``async_depth=0``).

One iteration = one call of the packed step: the decode tokens (one per
decoding slot) and every scheduled prefill chunk are packed into a single
``(1, T)`` stream with per-token ``(slot, position)`` metadata, run through
``model.forward_packed`` (K/V scattered at each segment's offset, attention
masked to each token's own slot), sampled greedily on the device, and the
samples scattered into a device-resident per-slot ``last_token`` buffer
from which the next iteration's decode inputs are gathered on the device.
The host metadata goes up in one host-to-device copy, and the only
device-to-host transfer is the ``last_token`` payload, once per iteration
(``EngineStats.model_dispatches`` / ``host_syncs``).  ``T`` is bucketed to
the scheduler's discrete sizes and attention sweeps only the iteration's
KV-length bucket (DESIGN.md §9).

The step runs eagerly; capturing it in a CUDA graph per (T bucket, kv
bucket) is ROADMAP A3's remaining work, and the async pipeline
(``async_depth >= 1``) is A4.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.serving import sampling
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.kvcache import PagedKVManager
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import BatchPlan, GlobalBatchScheduler

# rows of the per-iteration host metadata block (one H2D copy)
_META_ROWS = ("tokens", "slot", "pos", "active", "from_last", "sample_slot")


def kv_bytes_per_token(cfg: ModelConfig) -> int:
    """Per-token KV-cache bytes, from the cache shapes themselves (built on
    the ``meta`` device, so nothing is allocated): for every layer, the
    bytes of one sequence row of each cache leaf."""
    cache = model_lib.init_cache(cfg, 1, 1, device="meta")
    return sum(int(np.prod(leaf.shape[2:])) * leaf.element_size()
               for layer in cache for leaf in layer.values())


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
    model_dispatches: int = 0        # packed-step calls
    host_syncs: int = 0              # device->host payload copies
    packed_pad_tokens: int = 0       # bucketing padding launched
    dense_batch_hist: dict[int, int] = dataclasses.field(default_factory=dict)
    kv_bucket_hist: dict[int, int] = dataclasses.field(default_factory=dict)
    # sum of launch_tokens x kv_bucket: the attention score work launched
    packed_attn_kv_rows: int = 0

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
        self.max_slots = config.max_slots
        self.max_len = config.max_len
        self.nano = config.nano
        self.kv_buckets = config.resolved_kv_buckets()

        page_size = config.kv_block_size
        kv_bytes = kv_bytes_per_token(cfg)
        if config.total_pages is not None:
            pages = config.total_pages
        elif config.kv_budget_bytes is not None and kv_bytes > 0:
            pages = max(int(config.kv_budget_bytes) // (kv_bytes * page_size), 1)
        else:
            pages = config.max_slots * config.max_len // page_size
        self.kv = PagedKVManager(total_pages=pages, page_size=page_size,
                                 bytes_per_token=kv_bytes,
                                 avg_decode_len=config.avg_decode_len)
        self.scheduler = GlobalBatchScheduler(
            self.kv, discrete_sizes=config.discrete_sizes,
            max_active=config.max_slots, kv_buckets=self.kv_buckets,
            max_request_len=self.max_len)

        dev = self.device
        self.cache = model_lib.init_cache(cfg, self.max_slots, self.max_len,
                                          device=dev)
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
        """Launch one packed iteration and retire it (``async_depth=0``)."""
        self.stats.iterations += 1
        self.stats.dense_batch_hist[plan.dense_batch] = \
            self.stats.dense_batch_hist.get(plan.dense_batch, 0) + 1
        return self._retire_oldest(self._launch_packed(plan))

    # ---- packed iteration: one dispatch, one host sync -----------------------
    def _retire_oldest(self, inf: _InFlight) -> list[Request]:
        """Copy the iteration's payload to the host, commit its samples to
        the scheduler and finalize what finished."""
        payload = self._fetch(inf)
        t1 = time.perf_counter()
        sampled = {rid: int(payload[s]) for rid, s in inf.sample_at}
        finished = self.scheduler.commit(inf.plan, sampled, time.perf_counter())
        for r in finished:
            self._finalize(r)
        self.stats.host_time += time.perf_counter() - t1
        return finished

    def _fetch(self, inf: _InFlight) -> np.ndarray:
        t0 = time.perf_counter()
        ready = inf.done is None or inf.done.query()
        out = inf.payload.cpu().numpy()
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

        t_total = packed.launch_tokens
        meta = np.zeros((len(_META_ROWS), t_total), np.int32)
        tokens, slot, pos, active, from_last, sample_slot = meta
        # non-sample positions scatter out of bounds -> dropped
        sample_slot[:] = self.max_slots
        sample_at: list[tuple[int, int]] = []
        t = 0
        for seg in packed.segments:
            r = seg.req
            if seg.is_decode:
                # the token itself comes from last_token on the device
                from_last[t] = 1
                slot[t] = r.slot
                pos[t] = self._pos[r.slot]
                active[t] = 1
                sample_slot[t] = r.slot
                sample_at.append((r.rid, r.slot))
                t += 1
            else:
                ln = seg.length
                tokens[t:t + ln] = r.prompt[seg.offset:seg.offset + ln]
                slot[t:t + ln] = r.slot
                pos[t:t + ln] = np.arange(seg.offset, seg.offset + ln)
                active[t:t + ln] = 1
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

        host_block = np.concatenate([meta.reshape(-1), reset])
        t_disp = time.perf_counter()
        self.stats.host_time += t_disp - t_host
        payload = self._packed_core(host_block, t_total, kv_bucket)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        self.stats.dispatch_time += time.perf_counter() - t_disp
        self.stats.model_dispatches += 1
        return _InFlight(plan=plan, sample_at=sample_at, payload=payload,
                         done=done)

    def _packed_core(self, host_block: np.ndarray, t_total: int,
                     kv_bucket: int) -> torch.Tensor:
        """The whole iteration on the device: substitute the decode
        placeholders from ``last_token``, run the packed forward, sample
        greedily, scatter the samples into ``last_token`` and advance
        ``cache_len``.  Returns the new ``last_token`` (the payload)."""
        block = torch.from_numpy(host_block).to(self.device)
        tokens, slot, pos, active, from_last, sample_slot = \
            block[:len(_META_ROWS) * t_total].view(len(_META_ROWS), t_total)
        reset = block[len(_META_ROWS) * t_total:].bool()
        active = active.bool()
        wpos = torch.where(active, pos, self.max_len)
        toks = sampling.substitute_last(tokens[None], self.last_token, slot,
                                        from_last.bool())
        logits, self.cache = model_lib.forward_packed(
            self.cfg, self.params, toks, self.cache, slot, pos, wpos,
            kv_bucket=kv_bucket)
        next_tok = sampling.greedy(logits[0])
        new_len = torch.where(reset, 0, self.cache_len)
        self.cache_len = new_len.scatter_reduce(
            0, slot.long(), torch.where(active, pos + 1, 0), reduce="amax")
        self.last_token = sampling.scatter_last(self.last_token, sample_slot,
                                                next_tok)
        return self.last_token

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
