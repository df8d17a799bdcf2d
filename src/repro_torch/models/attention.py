"""GQA attention with qk-norm (port of ``repro.models.attention`` for GQA
at tp=1): the token-packed stream (``gqa_packed``), and the legacy step's
paths — the whole-chunk prefill (``gqa_full``), the batched decode
(``gqa_decode``) and the incremental chunk (``gqa_prefill_chunk``).

The slot caches keep the JAX layout, ``(N_slots, S, KV, hd)`` per layer
(plus ``(N_slots, S, KV)`` f32 scale leaves ``k_s``/``v_s`` for int8 KV),
and are updated in place (the JAX functions return new arrays).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, rmsnorm
from repro_torch.models.param import DTYPES, ParamDef
from repro_torch.serving import kvquant


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
    """The (N·S + 1, ...) row view of a cache leaf made by
    ``gqa_init_cache``: the N·S rows of the leaf followed by one spare row
    that padding tokens write into.  A leaf without the spare row raises
    here (``as_strided`` checks the storage bounds)."""
    n, s = cache.shape[:2]
    return cache.as_strided((n * s + 1,) + tuple(cache.shape[2:]),
                            (cache.stride(1),) + tuple(cache.stride()[2:]))


def _dst_rows(n: int, s: int, token_slot: torch.Tensor,
              token_wpos: torch.Tensor,
              token_dst: Optional[torch.Tensor]) -> torch.Tensor:
    """Each token's flat row in the N·S row space: ``slot·S + wpos`` in
    contiguous mode, ``token_dst`` in block-table mode.  Padding tokens
    (``wpos == S``, or ``token_dst == N·S``) and any row out of range get
    the spare row N·S, where the JAX scatter drops them."""
    if token_dst is not None:
        dst = token_dst.long()
        return torch.where((dst >= 0) & (dst < n * s), dst, n * s)
    slot = token_slot.long()
    wpos = token_wpos.long()
    return torch.where((wpos >= 0) & (wpos < s) & (slot >= 0) & (slot < n),
                       slot * s + wpos, n * s)


def _flat_scatter(cache: torch.Tensor, new: torch.Tensor,
                  dst: torch.Tensor) -> None:
    """Write each token's row at flat row ``dst[t]`` (from ``_dst_rows``)
    in place — the port of the JAX ``_flat_scatter`` (DESIGN.md §12), whose
    out-of-bounds drops land in the spare row here, so the write needs no
    mask and no host sync."""
    _row_store(cache).index_copy_(0, dst, new.to(cache.dtype))


def _out_project(cfg: ModelConfig, p: dict,
                 out: torch.Tensor) -> torch.Tensor:
    """einsum("...hk,hkd->...d") as one GEMM over the flattened heads."""
    lead = out.shape[:-2]
    return torch.matmul(out.reshape(*lead, -1),
                        p["wo"].reshape(-1, cfg.d_model))


def _write_seq_at(cache: torch.Tensor, new: torch.Tensor,
                  idx: torch.Tensor) -> None:
    """cache (B, S, ...); new (B, s, ...); idx (B,): write row b's s new
    rows at its own offset, in place.  As ``jax.lax.dynamic_update_slice``
    does, the start is clamped to [0, S - s] so that the write fits (a
    chunk whose offset + s passes S lands on the last s rows); the clamp
    and the row indices are computed on the device, with no host sync."""
    b, s_max = cache.shape[:2]
    n = new.shape[1]
    start = idx.long().clamp(0, s_max - n)
    rows = (torch.arange(b, device=idx.device) * s_max + start)[:, None] \
        + torch.arange(n, device=idx.device)
    flat = cache.view((b * s_max,) + tuple(cache.shape[2:]))
    flat.index_copy_(0, rows.reshape(-1),
                     new.reshape((b * n,) + tuple(new.shape[2:]))
                     .to(cache.dtype))


def _write_at(cache: torch.Tensor, new: torch.Tensor,
              idx: torch.Tensor) -> None:
    """cache (B, S, ...); new (B, ...); idx (B,): the one-row case of
    ``_write_seq_at`` (a decode at ``idx == S`` overwrites row S - 1)."""
    _write_seq_at(cache, new[:, None], idx)


def gqa_full(cfg: ModelConfig, p: dict, x: torch.Tensor,
             positions: torch.Tensor, *, q_offset=0,
             kv_prefix: Optional[tuple] = None, return_kv: bool = False,
             impl: Optional[str] = None):
    """Whole-chunk causal attention (prefill, and the recompute path):
    x (B, S, D); query i sees keys [0, q_offset + i] of its own chunk.
    ``return_kv`` also returns this chunk's post-RoPE (k, v), each
    (B, S, KV, hd).  The engine never passes ``kv_prefix``; it raises."""
    if kv_prefix is not None:
        raise NotImplementedError("gqa_full: kv_prefix is not used by the "
                                  "engine and is not ported")
    q, k, v = _qkv(cfg, p, x, positions)
    out = ops.flash_attention(q, k, v, q_offset=q_offset, impl=impl)
    y = _out_project(cfg, p, out)
    return (y, (k, v)) if return_kv else y


def gqa_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor, cache: dict, cache_len: torch.Tensor,
               impl: Optional[str] = None):
    """Single-token decode.  x: (B, 1, D); cache{k,v}: (B, S, KV, hd);
    cache_len: (B,) int32 valid rows *before* this token.  Writes the new
    token's K/V at cache_len (in place), then attends rows
    [0, cache_len + 1).  Returns (y (B, 1, D), cache)."""
    q, k_new, v_new = _qkv(cfg, p, x, positions)
    _write_at(cache["k"], k_new[:, 0], cache_len)
    _write_at(cache["v"], v_new[:, 0], cache_len)
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"],
                               cache_len + 1, impl=impl)
    return _out_project(cfg, p, out)[:, None], cache


def gqa_prefill_chunk(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      positions: torch.Tensor, cache: dict,
                      cache_len: torch.Tensor, impl: Optional[str] = None):
    """Incremental chunked prefill (DESIGN.md §7).  x: (B, L, D);
    cache_len: (B,) int32 prefix rows already in the cache.  Writes the
    chunk's K/V at cache_len (in place), then its queries attend the cache
    causally with ``q_offset = cache_len`` (a device tensor), so rows past
    cache_len + L are never read.  Returns (y (B, L, D), cache)."""
    q, k_new, v_new = _qkv(cfg, p, x, positions)
    _write_seq_at(cache["k"], k_new, cache_len)
    _write_seq_at(cache["v"], v_new, cache_len)
    out = ops.flash_attention(q, cache["k"], cache["v"], q_offset=cache_len,
                              impl=impl)
    return _out_project(cfg, p, out), cache


def gqa_packed(cfg: ModelConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor, cache: dict, token_slot: torch.Tensor,
               token_wpos: torch.Tensor, kv_bucket: Optional[int] = None,
               token_dst: Optional[torch.Tensor] = None,
               block_tables: Optional[torch.Tensor] = None,
               impl: Optional[str] = None):
    """Token-packed step (DESIGN.md §8).  x: (1, T, D); positions: (1, T)
    int32; cache{k,v}: (N_slots, S, KV, hd).  Scatters each token's K/V at
    ``(slot, wpos)``, then token t attends rows [0, positions[t]] of its own
    slot, reading at most ``kv_bucket`` rows (DESIGN.md §9).

    Block-table mode (``token_dst``/``block_tables`` set, DESIGN.md §12):
    the leaves are physical block storage — K/V scatter at flat row
    ``token_dst[t]`` and attention reads through the per-slot tables.
    int8 KV (scale leaves ``k_s``/``v_s`` in the cache, DESIGN.md §15):
    each token's K/V row quantizes at scatter time and attention
    dequantizes after the int8 load."""
    q, k_new, v_new = _qkv(cfg, p, x, positions)
    n, s = cache["k"].shape[:2]
    dst = _dst_rows(n, s, token_slot, token_wpos,
                    token_dst if block_tables is not None else None)
    new = {"k": k_new[0], "v": v_new[0]}
    if "k_s" in cache:
        new["k"], new["k_s"] = kvquant.quantize_kv(new["k"])
        new["v"], new["v_s"] = kvquant.quantize_kv(new["v"])
    for name, rows in new.items():
        _flat_scatter(cache[name], rows, dst)
    out = ops.packed_attention(q[0], cache["k"], cache["v"], token_slot,
                               positions[0] + 1, kv_bucket=kv_bucket,
                               block_tables=block_tables,
                               k_scale=cache.get("k_s"),
                               v_scale=cache.get("v_s"), impl=impl)
    return _out_project(cfg, p, out)[None], cache


def gqa_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   device: torch.device,
                   kv_dtype: Optional[str] = None) -> dict:
    """Zeroed (batch, max_len, KV, hd) K and V caches in the model's dtype,
    or, for ``kv_dtype="int8"``, int8 K and V with f32 (batch, max_len, KV)
    scale leaves ``k_s``/``v_s``.  Each leaf is a view of ``batch·max_len +
    1`` rows: the last row (outside the view) takes the writes of padding
    tokens (see ``_flat_scatter``)."""
    hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads

    def leaf(row_shape, dt):
        rows = torch.zeros((batch * max_len + 1,) + row_shape, dtype=dt,
                           device=device)
        return rows[:batch * max_len].view((batch, max_len) + row_shape)

    if kv_dtype == "int8":
        return {"k": leaf((kv, hd), torch.int8),
                "v": leaf((kv, hd), torch.int8),
                "k_s": leaf((kv,), torch.float32),
                "v_s": leaf((kv,), torch.float32)}
    if kv_dtype is not None:
        raise ValueError(f"kv_dtype {kv_dtype!r} (None or 'int8')")
    dt = DTYPES[cfg.dtype]
    return {"k": leaf((kv, hd), dt), "v": leaf((kv, hd), dt)}
