"""Per-layer block: GQA attention + dense FFN, pre-norm residual (port of
``repro.models.blocks`` for ``LayerSpec(ATTN, FFN_DENSE)``): the packed
step (``block_packed``) and the legacy step's whole-chunk, decode and
incremental-chunk paths (``block_full``, ``block_decode``,
``block_chunk``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ATTN, FFN_DENSE, LayerSpec, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import rmsnorm
from repro_torch.models.param import ParamDef


def check_spec(spec: LayerSpec) -> None:
    if spec.mixer != ATTN or spec.ffn != FFN_DENSE:
        raise NotImplementedError(
            f"layer {spec}: the port runs GQA attention + dense FFN layers; "
            "MoE, MLA and recurrent mixers are ROADMAP A5 and A9")


def block_defs(cfg: ModelConfig, spec: LayerSpec) -> dict:
    check_spec(spec)
    d, dt = cfg.d_model, cfg.dtype
    return {"norm1": ParamDef((d,), init="ones", dtype=dt),
            "mixer": attn.gqa_defs(cfg),
            "norm2": ParamDef((d,), init="ones", dtype=dt),
            "ffn": moe_mod.ffn_defs(d, cfg.d_ff, dt)}


def _ffn_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
               impl: Optional[str]) -> torch.Tensor:
    h = rmsnorm(x, p["norm2"], cfg.norm_eps)
    return x + moe_mod.dense_ffn(p["ffn"], h, impl=impl)


def block_full(cfg: ModelConfig, spec: LayerSpec, p: dict, x: torch.Tensor,
               positions: torch.Tensor, *, q_offset=0,
               return_state: bool = False, impl: Optional[str] = None):
    """Whole-chunk prefill for one layer.  Returns (x, state): ``state`` is
    ``{"kv": (k, v)}`` with the chunk's K/V when ``return_state``, else
    None."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    r = attn.gqa_full(cfg, p["mixer"], h, positions, q_offset=q_offset,
                      return_kv=return_state, impl=impl)
    y, kv = r if return_state else (r, None)
    x = _ffn_apply(cfg, p, x + y, impl)
    return x, ({"kv": kv} if return_state else None)


def block_decode(cfg: ModelConfig, spec: LayerSpec, p: dict, x: torch.Tensor,
                 positions: torch.Tensor, cache: dict,
                 cache_len: torch.Tensor, impl: Optional[str] = None):
    """Single-token decode for one layer.  Returns (x, cache), the cache
    updated in place."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    y, cache = attn.gqa_decode(cfg, p["mixer"], h, positions, cache,
                               cache_len, impl=impl)
    return _ffn_apply(cfg, p, x + y, impl), cache


def block_chunk(cfg: ModelConfig, spec: LayerSpec, p: dict, x: torch.Tensor,
                positions: torch.Tensor, cache: dict,
                cache_len: torch.Tensor, impl: Optional[str] = None):
    """Incremental chunked prefill for one layer (DESIGN.md §7): the chunk's
    K/V are written at ``cache_len`` and it attends the prefix.  Returns
    (x, cache), the cache updated in place."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    y, cache = attn.gqa_prefill_chunk(cfg, p["mixer"], h, positions, cache,
                                      cache_len, impl=impl)
    return _ffn_apply(cfg, p, x + y, impl), cache


def block_packed(cfg: ModelConfig, spec: LayerSpec, p: dict, x: torch.Tensor,
                 positions: torch.Tensor, cache: dict,
                 token_slot: torch.Tensor, token_wpos: torch.Tensor,
                 kv_bucket: Optional[int] = None,
                 token_dst: Optional[torch.Tensor] = None,
                 block_tables: Optional[torch.Tensor] = None,
                 impl: Optional[str] = None):
    """Token-packed step for one layer (DESIGN.md §8); ``token_dst`` and
    ``block_tables`` switch attention to block-table mode (§12).  Returns
    (x, cache), the cache updated in place."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    y, cache = attn.gqa_packed(cfg, p["mixer"], h, positions, cache,
                               token_slot, token_wpos, kv_bucket=kv_bucket,
                               token_dst=token_dst, block_tables=block_tables,
                               impl=impl)
    return _ffn_apply(cfg, p, x + y, impl), cache


def block_init_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, device: torch.device,
                     kv_dtype: Optional[str] = None) -> dict:
    check_spec(spec)
    return attn.gqa_init_cache(cfg, batch, max_len, device, kv_dtype)
