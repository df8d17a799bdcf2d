"""GQA attention with qk-norm on the token-packed stream (port of the
contiguous-mode ``gqa_packed`` path of ``repro.models.attention``, tp=1).

The slot caches keep the JAX layout, ``(N_slots, S, KV, hd)`` per layer,
and are updated in place (the JAX function returns new arrays).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, rmsnorm
from repro_torch.models.param import DTYPES, ParamDef


def gqa_defs(cfg: ModelConfig) -> dict:
    d, hd, dt = cfg.d_model, cfg.resolved_head_dim, cfg.dtype
    h, kv = cfg.n_heads, cfg.n_kv_heads
    defs = {
        "wq": ParamDef((d, h, hd), dtype=dt),
        "wk": ParamDef((d, kv, hd), dtype=dt),
        "wv": ParamDef((d, kv, hd), dtype=dt),
        "wo": ParamDef((h, hd, d), dtype=dt, fan_in_axes=(0, 1)),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), init="ones", dtype=dt)
        defs["k_norm"] = ParamDef((hd,), init="ones", dtype=dt)
    return defs


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one GEMM over the flattened heads."""
    b, s, d = x.shape
    return torch.matmul(x, w.reshape(d, -1)).reshape(b, s, *w.shape[1:])


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
         positions: torch.Tensor):
    """x: (B, S, D) -> q (B, S, H, hd), k/v (B, S, KV, hd)."""
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _row_store(cache: torch.Tensor) -> torch.Tensor:
    """The (N·S + 1, KV, hd) row view of a slot cache made by
    ``gqa_init_cache``: the N·S rows of the cache followed by one spare row
    that padding tokens write into.  A cache without the spare row raises
    here (``as_strided`` checks the storage bounds)."""
    n, s = cache.shape[:2]
    return cache.as_strided((n * s + 1,) + tuple(cache.shape[2:]),
                            (cache.stride(1),) + tuple(cache.stride()[2:]))


def _scatter(cache: torch.Tensor, new: torch.Tensor, token_slot: torch.Tensor,
             token_wpos: torch.Tensor) -> None:
    """Write each token's row at (slot, wpos) in place.  Padding tokens carry
    ``wpos == S`` (the JAX scatter drops them as out of bounds); here they
    land in the spare row, so the write needs no mask and no host sync."""
    n, s = cache.shape[:2]
    slot = token_slot.long()
    wpos = token_wpos.long()
    dst = torch.where((wpos >= 0) & (wpos < s) & (slot >= 0) & (slot < n),
                      slot * s + wpos, n * s)
    _row_store(cache).index_copy_(0, dst, new.to(cache.dtype))


def gqa_packed(cfg: ModelConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor, cache: dict, token_slot: torch.Tensor,
               token_wpos: torch.Tensor, kv_bucket: Optional[int] = None,
               impl: Optional[str] = None):
    """Token-packed step (DESIGN.md §8).  x: (1, T, D); positions: (1, T)
    int32; cache{k,v}: (N_slots, S, KV, hd).  Scatters each token's K/V at
    ``(slot, wpos)``, then token t attends rows [0, positions[t]] of its own
    slot, reading at most ``kv_bucket`` rows (DESIGN.md §9)."""
    q, k_new, v_new = _qkv(cfg, p, x, positions)
    _scatter(cache["k"], k_new[0], token_slot, token_wpos)
    _scatter(cache["v"], v_new[0], token_slot, token_wpos)
    out = ops.packed_attention(q[0], cache["k"], cache["v"], token_slot,
                               positions[0] + 1, kv_bucket=kv_bucket,
                               impl=impl)
    t = out.shape[0]
    y = torch.matmul(out.reshape(t, -1), p["wo"].reshape(-1, cfg.d_model))
    return y[None], cache


def gqa_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   device: torch.device) -> dict:
    """Zeroed (batch, max_len, KV, hd) K and V caches.  Each is a view of
    ``batch·max_len + 1`` rows: the last row (outside the view) takes the
    writes of padding tokens (see ``_scatter``)."""
    hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
    dt = DTYPES[cfg.dtype]

    def leaf():
        rows = torch.zeros((batch * max_len + 1, kv, hd), dtype=dt,
                           device=device)
        return rows[:batch * max_len].view(batch, max_len, kv, hd)

    return {"k": leaf(), "v": leaf()}
