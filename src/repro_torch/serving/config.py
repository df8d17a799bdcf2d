"""Engine configuration: the port's ``EngineConfig``, with the same fields
as ``repro.serving.config.EngineConfig``.

The port runs the packed greedy serving step at tp=1 with bf16 KV and
``async_depth=0``.  Every value it does not implement yet raises
``NotImplementedError`` naming the ROADMAP item that brings it, so a
configuration never silently runs something other than what it says.
``async_depth=None`` resolves to 0 here (the JAX engine's packed default is
1; ROADMAP A4 restores it).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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
    # ---- features of later slices -------------------------------------------
    prefix_caching: bool = False
    kv_dtype: str = "bf16"
    spec_k: int = 0
    drafter: Optional[str] = None
    temperature: float = 0.0
    top_k: Optional[int] = None
    attn_fast: Optional[bool] = None
    attn_stream: Optional[bool] = None
    seed: int = 0

    def __post_init__(self):
        if self.prefill_mode == "recompute" or self.step_mode == "legacy":
            raise NotImplementedError(
                "the legacy step and recompute prefill are ROADMAP A10")
        if self.prefill_mode != "incremental" or \
                self.step_mode not in (None, "packed"):
            raise ValueError((self.prefill_mode, self.step_mode))
        if self.tp != 1:
            raise NotImplementedError("tensor parallelism is ROADMAP A11")
        if self.prefix_caching:
            raise NotImplementedError("prefix caching is ROADMAP A6")
        if self.kv_dtype == "int8":
            raise NotImplementedError("int8 KV is ROADMAP A7")
        if self.kv_dtype != "bf16":
            raise ValueError(self.kv_dtype)
        if self.spec_k > 0 or self.drafter is not None:
            raise NotImplementedError("speculative decoding is ROADMAP A8")
        if self.temperature > 0 or self.top_k is not None:
            raise NotImplementedError("stochastic sampling is ROADMAP A8")
        if self.async_depth is not None and self.async_depth >= 1:
            raise NotImplementedError("the async pipeline is ROADMAP A4")
        if self.attn_fast or self.attn_stream:
            raise ValueError("attn_fast/attn_stream select variants of the "
                             "JAX XLA attention; the port always runs its "
                             "packed-attention kernel")
        if self.max_slots < 1 or self.max_len < 1 or self.kv_block_size < 1:
            raise ValueError((self.max_slots, self.max_len,
                              self.kv_block_size))

    @property
    def resolved_step_mode(self) -> str:
        return "packed"

    @property
    def resolved_async_depth(self) -> int:
        return 0

    def resolved_kv_buckets(self) -> tuple[int, ...]:
        """The KV-length bucket grid (DESIGN.md §9), ascending, topped by
        ``max_len``; ``kv_bucketing=False`` pins the single max_len bucket."""
        if not self.kv_bucketing:
            return (self.max_len,)
        if self.kv_buckets is None:
            return default_kv_buckets(self.max_len)
        grid = tuple(sorted({min(b, self.max_len) for b in self.kv_buckets}))
        return grid if grid[-1] == self.max_len else grid + (self.max_len,)
