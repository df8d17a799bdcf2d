"""Attention blocks (port of ``repro.models.attention`` at tp=1): GQA with
qk-norm and DeepSeek-V2's absorbed MLA, each on the token-packed stream
(``gqa_packed``, ``mla_packed``) and the legacy step's paths — the
whole-chunk prefill (``*_full``), the batched decode (``*_decode``) and the
incremental chunk (``*_prefill_chunk``).

The slot caches keep the JAX layout: GQA's ``(N_slots, S, KV, hd)`` K and
V per layer (plus ``(N_slots, S, KV)`` f32 scale leaves ``k_s``/``v_s`` for
int8 KV), MLA's latent ``c_kv`` (N_slots, S, rank) and ``k_rope``
(N_slots, S, rope) (plus ``(N_slots, S)`` scales ``c_kv_s``/``k_rope_s``).
They are updated in place (the JAX functions return new arrays).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.packed_attention import (block_gather_view,
                                                  kv_bucket_view)
from repro_torch.models.layers import apply_rope, apply_rope_nohead, rmsnorm
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


def _cache_leaves(cfg: ModelConfig, batch: int, max_len: int,
                  device: torch.device, rows: dict,
                  kv_dtype: Optional[str]) -> dict:
    """Zeroed (batch, max_len, *row) leaves, one per ``rows`` entry (name
    -> row shape), in the model's dtype, or, for ``kv_dtype="int8"``, int8
    values with an f32 ``<name>_s`` scale leaf of the row shape less its
    last axis.  Each leaf is a view of ``batch·max_len + 1`` rows: the last
    row (outside the view) takes the writes of padding tokens (see
    ``_flat_scatter``)."""
    def leaf(row_shape, dt):
        flat = torch.zeros((batch * max_len + 1,) + row_shape, dtype=dt,
                           device=device)
        return flat[:batch * max_len].view((batch, max_len) + row_shape)

    if kv_dtype == "int8":
        out = {name: leaf(shape, torch.int8) for name, shape in rows.items()}
        out.update({f"{name}_s": leaf(shape[:-1], torch.float32)
                    for name, shape in rows.items()})
        return out
    if kv_dtype is not None:
        raise ValueError(f"kv_dtype {kv_dtype!r} (None or 'int8')")
    return {name: leaf(shape, DTYPES[cfg.dtype])
            for name, shape in rows.items()}


def gqa_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   device: torch.device,
                   kv_dtype: Optional[str] = None) -> dict:
    """Zeroed (batch, max_len, KV, hd) K and V caches in the model's dtype,
    or, for ``kv_dtype="int8"``, int8 K and V with f32 (batch, max_len, KV)
    scale leaves ``k_s``/``v_s``, each with the spare row of
    ``_cache_leaves``."""
    row = (cfg.n_kv_heads, cfg.resolved_head_dim)
    return _cache_leaves(cfg, batch, max_len, device, {"k": row, "v": row},
                         kv_dtype)


def kv_names(cfg: ModelConfig) -> tuple[str, str]:
    """The cache leaves that an attention layer's prefill state ``{"kv":
    (a, b)}`` fills: GQA's post-RoPE ``(k, v)``, MLA's ``(c_kv, k_rope)``."""
    return ("c_kv", "k_rope") if cfg.mla is not None else ("k", "v")


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): the cache holds only the latent (c_kv, k_rope) per
# token.  Every path runs the absorbed form, as in JAX: W_uk is folded into
# the query and W_uv applied after the softmax, so attention runs in the
# (rank + rope) latent as a GQA with one shared KV head, through
# ``ops.mla_attention`` on the cache leaves in place.
# ---------------------------------------------------------------------------
def mla_defs(cfg: ModelConfig) -> dict:
    m = cfg.mla
    d, dt, nh = cfg.d_model, cfg.dtype, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wdq": ParamDef((d, m.q_lora_rank), dtype=dt),
        "q_ln": ParamDef((m.q_lora_rank,), init="ones", dtype=dt),
        "wuq": ParamDef((m.q_lora_rank, nh, qk), dtype=dt),
        "wdkv": ParamDef((d, m.kv_lora_rank), dtype=dt),
        "kv_ln": ParamDef((m.kv_lora_rank,), init="ones", dtype=dt),
        "wkr": ParamDef((d, m.qk_rope_dim), dtype=dt),
        "wuk": ParamDef((m.kv_lora_rank, nh, m.qk_nope_dim), dtype=dt),
        "wuv": ParamDef((m.kv_lora_rank, nh, m.v_head_dim), dtype=dt),
        "wo": ParamDef((nh, m.v_head_dim, d), dtype=dt, fan_in_axes=(0, 1)),
    }


def _mla_q(cfg: ModelConfig, p: dict, x: torch.Tensor,
           positions: torch.Tensor):
    """x: (B, S, D) -> q_nope (B, S, H, nope), q_rope (B, S, H, rope)."""
    m = cfg.mla
    cq = rmsnorm(torch.matmul(x, p["wdq"]), p["q_ln"], cfg.norm_eps)
    q = _project(cq, p["wuq"])
    q_nope = q[..., :m.qk_nope_dim]
    q_rope = apply_rope(q[..., m.qk_nope_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor):
    """x: (B, S, D) -> c_kv (B, S, rank), k_rope (B, S, rope)."""
    c_kv = rmsnorm(torch.matmul(x, p["wdkv"]), p["kv_ln"], cfg.norm_eps)
    k_rope = apply_rope_nohead(torch.matmul(x, p["wkr"]), positions,
                               cfg.rope_theta)
    return c_kv, k_rope


def _mla_q_absorbed(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """Absorbed query, q_nope · W_uk folded into the latent: (B, S, H,
    rank + rope)."""
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wuk"])
    return torch.cat([q_lat, q_rope], dim=-1)


def _mla_unabsorb(p: dict, out_lat: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """The latent context (..., H, rank), cast to the activations' dtype as
    JAX casts it, through W_uv: (..., H, v_head_dim)."""
    return torch.einsum("...hr,rhk->...hk", out_lat.to(dtype), p["wuv"])


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim) ** -0.5


def _mla_chunk_attention(cfg: ModelConfig, q_abs: torch.Tensor,
                         c_kv: torch.Tensor, k_rope: torch.Tensor,
                         q_offset, impl: Optional[str]) -> torch.Tensor:
    """Causal latent attention of B chunks of L queries: query (b, i)
    attends rows [0, q_offset[b] + i] of row b's latents, the stream token
    b·L + i with slot b and length q_offset[b] + i + 1 (flash's causal
    mask; a length past S is clamped by the sweep).  The stream is built on
    the device.  q_abs (B, L, H, rank + rope) -> (B, L, H, rank)."""
    b, n_q = q_abs.shape[:2]
    dev = q_abs.device
    if isinstance(q_offset, torch.Tensor):
        lengths = q_offset.reshape(-1, 1).to(torch.int32) + torch.arange(
            1, n_q + 1, dtype=torch.int32, device=dev)
    else:
        lengths = torch.arange(q_offset + 1, q_offset + n_q + 1,
                               dtype=torch.int32, device=dev)
    slot = torch.arange(b, dtype=torch.int32, device=dev) \
        .repeat_interleave(n_q)
    out = ops.mla_attention(q_abs.reshape(b * n_q, *q_abs.shape[2:]), c_kv,
                            k_rope, slot, lengths.expand(b, n_q).reshape(-1),
                            logit_scale=_mla_scale(cfg), impl=impl)
    return out.reshape(b, n_q, *out.shape[1:])


def mla_full(cfg: ModelConfig, p: dict, x: torch.Tensor,
             positions: torch.Tensor, *, q_offset=0,
             kv_prefix: Optional[tuple] = None, return_kv: bool = False,
             impl: Optional[str] = None):
    """Absorbed MLA over the whole chunk (prefill, and the recompute path):
    x (B, S, D); query i attends this chunk's latents [0, q_offset + i].
    ``return_kv`` also returns the chunk's (c_kv, k_rope).  The engine
    never passes ``kv_prefix``; it raises."""
    if kv_prefix is not None:
        raise NotImplementedError("mla_full: kv_prefix is not used by the "
                                  "engine and is not ported")
    q_abs = _mla_q_absorbed(cfg, p, x, positions)
    c_kv, k_rope = _mla_latent(cfg, p, x, positions)
    out_lat = _mla_chunk_attention(cfg, q_abs, c_kv, k_rope, q_offset, impl)
    y = _out_project(cfg, p, _mla_unabsorb(p, out_lat, x.dtype))
    return (y, (c_kv, k_rope)) if return_kv else y


def mla_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor, cache: dict, cache_len: torch.Tensor,
               impl: Optional[str] = None):
    """Absorbed decode.  x: (B, 1, D); cache{c_kv, k_rope}: (B, S, ...).
    Writes the token's latents at cache_len (in place), then row b's query
    attends rows [0, cache_len[b] + 1) of slot b.  Returns (y (B, 1, D),
    cache)."""
    q_abs = _mla_q_absorbed(cfg, p, x, positions)
    c_new, r_new = _mla_latent(cfg, p, x, positions)
    _write_at(cache["c_kv"], c_new[:, 0], cache_len)
    _write_at(cache["k_rope"], r_new[:, 0], cache_len)
    slot = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    out_lat = ops.mla_attention(q_abs[:, 0], cache["c_kv"], cache["k_rope"],
                                slot, cache_len + 1,
                                logit_scale=_mla_scale(cfg), impl=impl)
    out = _mla_unabsorb(p, out_lat, x.dtype)
    return _out_project(cfg, p, out)[:, None], cache


def mla_prefill_chunk(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      positions: torch.Tensor, cache: dict,
                      cache_len: torch.Tensor, impl: Optional[str] = None):
    """Incremental chunked prefill (DESIGN.md §7): the chunk's latents are
    written at cache_len (in place), then its absorbed queries attend the
    latent cache causally from ``q_offset = cache_len``.  Returns (y (B, L,
    D), cache)."""
    q_abs = _mla_q_absorbed(cfg, p, x, positions)
    c_new, r_new = _mla_latent(cfg, p, x, positions)
    _write_seq_at(cache["c_kv"], c_new, cache_len)
    _write_seq_at(cache["k_rope"], r_new, cache_len)
    out_lat = _mla_chunk_attention(cfg, q_abs, cache["c_kv"],
                                   cache["k_rope"], cache_len, impl)
    y = _out_project(cfg, p, _mla_unabsorb(p, out_lat, x.dtype))
    return y, cache


def mla_packed(cfg: ModelConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor, cache: dict, token_slot: torch.Tensor,
               token_wpos: torch.Tensor, kv_bucket: Optional[int] = None,
               token_dst: Optional[torch.Tensor] = None,
               block_tables: Optional[torch.Tensor] = None,
               impl: Optional[str] = None):
    """Token-packed step for MLA (DESIGN.md §8): scatter each token's
    latents at ``(slot, wpos)`` (flat row ``token_dst[t]`` in block-table
    mode, §12), then token t's absorbed query attends rows [0, positions[t]]
    of its slot, reading at most ``kv_bucket`` rows (§9).  The contiguous
    bf16 cache is read in place by the kernel; in block-table mode the
    bucket's view is gathered through the tables first, and with int8 KV
    (scale leaves ``c_kv_s``/``k_rope_s``, §15: each token's latent rows
    quantize at scatter time) the views dequantize to the activations'
    dtype first, as JAX does."""
    q_abs = _mla_q_absorbed(cfg, p, x, positions)
    c_new, r_new = _mla_latent(cfg, p, x, positions)
    n, s = cache["c_kv"].shape[:2]
    dst = _dst_rows(n, s, token_slot, token_wpos,
                    token_dst if block_tables is not None else None)
    new = {"c_kv": c_new[0], "k_rope": r_new[0]}
    quantized = "c_kv_s" in cache
    if quantized:
        new["c_kv"], new["c_kv_s"] = kvquant.quantize_kv(new["c_kv"])
        new["k_rope"], new["k_rope_s"] = kvquant.quantize_kv(new["k_rope"])
    for name, rows in new.items():
        _flat_scatter(cache[name], rows, dst)
    views, bucket = dict(cache), kv_bucket
    if block_tables is not None or quantized:
        views = {name: (block_gather_view(leaf, block_tables, kv_bucket)
                        if block_tables is not None
                        else kv_bucket_view(leaf, kv_bucket))
                 for name, leaf in cache.items()}
        bucket = None
    if quantized:
        for name in ("c_kv", "k_rope"):
            views[name] = kvquant.dequantize_kv(views[name],
                                                views[f"{name}_s"], x.dtype)
    out_lat = ops.mla_attention(q_abs[0], views["c_kv"], views["k_rope"],
                                token_slot, positions[0] + 1,
                                logit_scale=_mla_scale(cfg), kv_bucket=bucket,
                                impl=impl)
    out = _mla_unabsorb(p, out_lat, x.dtype)
    return _out_project(cfg, p, out)[None], cache


def mla_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   device: torch.device,
                   kv_dtype: Optional[str] = None) -> dict:
    """Zeroed latent leaves ``c_kv`` (batch, max_len, rank) and ``k_rope``
    (batch, max_len, rope) in the model's dtype, or, for
    ``kv_dtype="int8"``, int8 with f32 (batch, max_len) scale leaves
    ``c_kv_s``/``k_rope_s``, each with the spare row of
    ``_cache_leaves``."""
    m = cfg.mla
    return _cache_leaves(cfg, batch, max_len, device,
                         {"c_kv": (m.kv_lora_rank,),
                          "k_rope": (m.qk_rope_dim,)}, kv_dtype)
