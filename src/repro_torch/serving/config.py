"""Engine configuration: the port's ``EngineConfig``, with the same fields
as ``repro.serving.config.EngineConfig``.

The port serves on two steps: the packed step, with native or int8 KV
(``kv_dtype``), with or without prefix caching, with the async pipeline
(``async_depth``, DESIGN.md §10), speculative decoding (``spec_k``,
``drafter``, §13), stochastic sampling (``temperature``, ``top_k``) and
tensor parallelism (``tp``, §11: one process per rank, see
``launch.mesh``); and the legacy step (``step_mode="legacy"``), with
incremental or recompute prefill (``prefill_mode``; recompute implies the
legacy step, as in JAX), greedy, lock-step and at tp=1.  What the JAX
config refuses raises ``ValueError``, so a configuration never silently
runs something other than what it says.
``async_depth=None`` resolves as in JAX: 1 on the packed step, 0 on the
legacy step.

``PoolConfig`` holds the replica pool's knobs (DESIGN.md §14).  Both
configs define their command-line flags once (``add_args``, with the JAX
package's names and defaults) and rebuild themselves from the parsed
namespace (``from_args``).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

from repro_torch.serving.draft import drafter_names
from repro_torch.serving.scheduler import default_kv_buckets


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving-engine knobs (model-independent)."""
    # ---- capacity -----------------------------------------------------------
    max_slots: int = 8
    max_len: int = 512
    kv_block_size: int = 16
    total_pages: Optional[int] = None
    kv_budget_bytes: Optional[int] = None
    avg_decode_len: float = 64.0
    # ---- batching -----------------------------------------------------------
    discrete_sizes: tuple[int, ...] = (256, 128, 64, 32, 16, 8)
    nano: int = 2
    # ---- step / pipeline ----------------------------------------------------
    prefill_mode: str = "incremental"
    step_mode: Optional[str] = None
    async_depth: Optional[int] = None
    async_harvest: bool = True
    tp: int = 1
    # ---- KV-length bucketing (DESIGN.md §9) ---------------------------------
    kv_buckets: Optional[tuple[int, ...]] = None
    kv_bucketing: bool = True
    # ---- block-table KV (DESIGN.md §12) and int8 KV (§15) -------------------
    prefix_caching: bool = False
    kv_dtype: str = "bf16"
    # ---- speculative decoding (DESIGN.md §13) and sampling ------------------
    spec_k: int = 0
    drafter: Optional[str] = None    # None -> "ngram" when spec_k > 0
    temperature: float = 0.0         # 0: greedy (packed step only samples)
    top_k: Optional[int] = None
    attn_fast: Optional[bool] = None
    attn_stream: Optional[bool] = None
    seed: int = 0

    def __post_init__(self):
        if self.prefill_mode not in ("incremental", "recompute") or \
                self.step_mode not in (None, "packed", "legacy"):
            raise ValueError((self.prefill_mode, self.step_mode))
        # values the JAX config refuses whatever the step
        for bad, what in (
                (self.tp < 1, f"tp {self.tp} < 1"),
                (self.async_depth is not None and self.async_depth < 0,
                 f"async_depth {self.async_depth} < 0"),
                (self.spec_k < 0, f"spec_k {self.spec_k} < 0"),
                (self.temperature < 0, f"temperature {self.temperature} < 0")):
            if bad:
                raise ValueError(what)
        if self.resolved_step_mode == "packed":
            if self.prefill_mode == "recompute":
                raise ValueError("the packed step runs incremental prefill "
                                 "only")
        else:
            # what the JAX config refuses on the legacy step
            for refused, what in (
                    (self.tp != 1, "tensor parallelism"),
                    (self.async_depth is not None and self.async_depth >= 1,
                     "the async pipeline"),
                    (self.prefix_caching, "prefix caching"),
                    (self.kv_dtype == "int8", "int8 KV"),
                    (self.spec_k > 0, "speculative decoding")):
                if refused:
                    raise ValueError(f"{what} requires the packed step")
        if self.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype {self.kv_dtype!r} (bf16 or int8)")
        if self.spec_k >= self.max_len:
            raise ValueError(f"spec_k {self.spec_k} >= max_len {self.max_len}")
        if self.drafter is not None and self.drafter not in drafter_names():
            raise ValueError(f"drafter {self.drafter!r}: one of "
                             f"{drafter_names()}")
        if self.top_k is not None and (self.top_k < 1
                                       or self.temperature <= 0):
            raise ValueError(f"top_k {self.top_k} needs top_k >= 1 and "
                             f"temperature > 0 (temperature 0 is greedy)")
        if self.attn_fast or self.attn_stream:
            raise ValueError("attn_fast/attn_stream select variants of the "
                             "JAX XLA attention; the port always runs its "
                             "attention kernels")
        if self.max_slots < 1 or self.max_len < 1 or self.kv_block_size < 1:
            raise ValueError((self.max_slots, self.max_len,
                              self.kv_block_size))
        if self.prefix_caching and self.max_len % self.kv_block_size:
            raise ValueError(f"prefix caching needs max_len {self.max_len} "
                             f"divisible by kv_block_size "
                             f"{self.kv_block_size}")

    @property
    def resolved_step_mode(self) -> str:
        """``step_mode`` if given, else the JAX rule: recompute prefill has
        no packed equivalent, so it implies the legacy step."""
        if self.step_mode is not None:
            return self.step_mode
        return "packed" if self.prefill_mode == "incremental" else "legacy"

    @property
    def resolved_async_depth(self) -> int:
        """``async_depth`` if given, else the JAX rule: the pipeline is the
        packed step's default mode; the legacy step has no deferred sync."""
        if self.async_depth is not None:
            return int(self.async_depth)
        return 1 if self.resolved_step_mode == "packed" else 0

    @property
    def resolved_drafter(self) -> Optional[str]:
        """The drafter to build: the given name, else the n-gram drafter
        whenever speculation is on; None with speculation off."""
        if self.spec_k <= 0:
            return None
        return self.drafter if self.drafter is not None else "ngram"

    def resolved_kv_buckets(self) -> tuple[int, ...]:
        """The KV-length bucket grid (DESIGN.md §9), ascending, topped by
        ``max_len``; ``kv_bucketing=False`` pins the single max_len bucket."""
        if not self.kv_bucketing:
            return (self.max_len,)
        if self.kv_buckets is None:
            return default_kv_buckets(self.max_len)
        grid = tuple(sorted({min(b, self.max_len) for b in self.kv_buckets}))
        return grid if grid[-1] == self.max_len else grid + (self.max_len,)

    @classmethod
    def add_args(cls, ap: argparse.ArgumentParser) -> None:
        """Register the engine's flags (the JAX CLI's names and defaults;
        what the port refuses raises when the config is built)."""
        ap.add_argument("--slots", type=int, default=cls.max_slots,
                        help="slot count (concurrent active requests)")
        ap.add_argument("--max-len", type=int, default=256,
                        help="per-slot cache capacity (tokens)")
        ap.add_argument("--step-mode", default="packed",
                        choices=["packed", "legacy"],
                        help="packed = one fused dispatch/iteration "
                             "(DESIGN.md §8)")
        ap.add_argument("--async-depth", type=int, default=None,
                        help="iterations kept in flight before syncing their "
                             "sampled tokens (DESIGN.md §10); 0 = eager "
                             "lock-step; default: 1 packed / 0 legacy")
        ap.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree (DESIGN.md §11): N "
                             "ranks, one card each (packed step only)")
        ap.add_argument("--no-kv-bucketing", action="store_true",
                        help="sweep max_len every iteration instead of the "
                             "KV-length bucket (DESIGN.md §9; A/B baseline)")
        ap.add_argument("--prefix-caching",
                        action=argparse.BooleanOptionalAction, default=False,
                        help="cross-request prefix caching over the "
                             "block-table KV (DESIGN.md §12)")
        ap.add_argument("--kv-block-size", type=int, default=cls.kv_block_size,
                        help="KV block size (tokens per block-table block; "
                             "must divide --max-len when --prefix-caching)")
        ap.add_argument("--kv-dtype", default=cls.kv_dtype,
                        choices=["bf16", "int8"],
                        help="KV-cache storage dtype (DESIGN.md §15): int8 "
                             "values + per-(token, kv-head) f32 scales")
        ap.add_argument("--spec-k", type=int, default=cls.spec_k,
                        help="speculative decoding (DESIGN.md §13): draft "
                             "tokens verified per decoding slot per packed "
                             "iteration; 0 = off")
        ap.add_argument("--drafter", default=None, choices=drafter_names(),
                        help="draft proposer for --spec-k > 0 (default: "
                             "ngram)")
        ap.add_argument("--temperature", type=float, default=cls.temperature,
                        help="sampling temperature (0 = greedy)")
        ap.add_argument("--top-k", type=int, default=None,
                        help="top-k sampling cutoff (needs --temperature > 0)")
        ap.add_argument("--attn-fast", action=argparse.BooleanOptionalAction,
                        default=None,
                        help="a JAX attention variant; the port refuses it")
        ap.add_argument("--attn-stream", action=argparse.BooleanOptionalAction,
                        default=None,
                        help="a JAX attention variant; the port refuses it")

    @classmethod
    def from_args(cls, ns: argparse.Namespace, **overrides) -> "EngineConfig":
        """Build a config from an ``add_args`` namespace; ``overrides`` win
        over flags."""
        kw = dict(
            max_slots=ns.slots,
            max_len=ns.max_len,
            step_mode=ns.step_mode,
            async_depth=ns.async_depth,
            tp=ns.tp,
            kv_bucketing=not ns.no_kv_bucketing,
            prefix_caching=ns.prefix_caching,
            kv_block_size=ns.kv_block_size,
            kv_dtype=ns.kv_dtype,
            spec_k=ns.spec_k,
            drafter=ns.drafter,
            temperature=ns.temperature,
            top_k=ns.top_k,
            attn_fast=ns.attn_fast,
            attn_stream=ns.attn_stream,
        )
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """Multi-replica pool and SLO admission knobs (DESIGN.md §14).  Every
    SLO field is optional: ``None`` disables that check, so a bare
    one-replica pool behaves like the engine it wraps."""

    replicas: int = 1
    # TTFT admission SLO: a predicted time to first token (cheapest
    # replica's backlog / measured service rate) above it is shed
    slo_ttft_ms: Optional[float] = None
    # per-output-token SLO, checked at completion (counted, not shed)
    slo_tpot_ms: Optional[float] = None
    # hard backlog cap per replica in tokens: the deterministic shed
    # trigger (virtual-clock runs have no wall-time prediction)
    shed_backlog_tokens: Optional[int] = None
    # admission headroom: predicted TTFT is compared with
    # slo_ttft_ms * slo_safety
    slo_safety: float = 1.0
    # timeout of a request left WAITING on one replica; after
    # ``retry_limit`` re-routes it is shed with reason "retry_limit"
    request_timeout_s: Optional[float] = None
    retry_limit: int = 3
    backoff_base_s: float = 0.01
    # chaos: a FaultPlan spec string ("kill@40:r1,...") or None
    fault_plan: Optional[str] = None
    # session affinity (multi-turn requests pinned to their prefix cache)
    affinity: bool = True

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if self.retry_limit < 0:
            raise ValueError("retry_limit must be >= 0")
        for f in ("slo_ttft_ms", "slo_tpot_ms", "request_timeout_s"):
            v = getattr(self, f)
            if v is not None and v <= 0:
                raise ValueError(f"{f} must be positive when set")

    @classmethod
    def add_args(cls, ap: argparse.ArgumentParser) -> None:
        """Register the pool's flags (the JAX CLI's names and defaults)."""
        ap.add_argument("--replicas", type=int, default=cls.replicas,
                        help="engine replicas behind the router")
        ap.add_argument("--slo-ttft-ms", type=float, default=None,
                        help="TTFT SLO; admission sheds requests whose "
                             "predicted TTFT exceeds it")
        ap.add_argument("--slo-tpot-ms", type=float, default=None,
                        help="per-output-token SLO; violations counted "
                             "at completion")
        ap.add_argument("--shed-backlog-tokens", type=int, default=None,
                        help="hard per-replica backlog cap (tokens) "
                             "before shedding")
        ap.add_argument("--request-timeout-s", type=float, default=None,
                        help="queue timeout before retry-with-backoff")
        ap.add_argument("--retry-limit", type=int, default=cls.retry_limit,
                        help="re-dispatch attempts before a request is "
                             "shed")
        ap.add_argument("--fault-plan", default=None,
                        help="chaos spec, e.g. 'kill@40:r1,stall@10:r0:20'"
                             " (tick-indexed, deterministic)")

    @classmethod
    def from_args(cls, ns: argparse.Namespace, **overrides) -> "PoolConfig":
        kw = dict(
            replicas=ns.replicas,
            slo_ttft_ms=ns.slo_ttft_ms,
            slo_tpot_ms=ns.slo_tpot_ms,
            shed_backlog_tokens=ns.shed_backlog_tokens,
            request_timeout_s=ns.request_timeout_s,
            retry_limit=ns.retry_limit,
            fault_plan=ns.fault_plan,
        )
        kw.update(overrides)
        return cls(**kw)
