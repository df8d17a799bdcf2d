"""Engine configuration: the port's ``EngineConfig``, with the same fields
as ``repro.serving.config.EngineConfig``.

The port serves at tp=1 on two steps: the packed step, with native or
int8 KV (``kv_dtype``), with or without prefix caching, with the async
pipeline (``async_depth``, DESIGN.md §10), speculative decoding
(``spec_k``, ``drafter``, §13) and stochastic sampling (``temperature``,
``top_k``); and the legacy step (``step_mode="legacy"``), with incremental
or recompute prefill (``prefill_mode``; recompute implies the legacy step,
as in JAX), greedy and lock-step.  What the JAX config refuses raises
``ValueError``; tensor parallelism, which the port does not implement yet,
raises ``NotImplementedError`` naming the ROADMAP item that brings it, so
a configuration never silently runs something other than what it says.
``async_depth=None`` resolves as in JAX: 1 on the packed step, 0 on the
legacy step.
"""
from __future__ import annotations

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
        if self.tp != 1:
            raise NotImplementedError("tensor parallelism is ROADMAP A11")
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
