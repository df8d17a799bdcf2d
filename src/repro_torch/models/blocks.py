"""Per-layer block: a sequence mixer (GQA or, when the config has ``mla``,
absorbed MLA attention, or Mamba) + an FFN (dense, MoE, or MoE beside a
dense residual), pre-norm residual (port of ``repro.models.blocks`` for
those layer kinds): the packed step (``block_packed``) and the legacy
step's whole-chunk, decode and incremental-chunk paths (``block_full``,
``block_decode``, ``block_chunk``).  An attention layer's cache is
``{"k", "v"}`` for GQA and ``{"c_kv", "k_rope"}`` for MLA (plus int8
scales), a Mamba layer's its state ``{"conv", "ssm"}``.  Every path
computes the MoE balance loss; only ``block_full`` returns it, as in
JAX."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import (ATTN, FFN_DENSE, FFN_MOE,
                                      FFN_MOE_DENSE, MAMBA, LayerSpec,
                                      ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import rmsnorm
from repro_torch.models.param import ParamDef


def check_spec(spec: LayerSpec) -> None:
    if spec.mixer not in (ATTN, MAMBA) or \
            spec.ffn not in (FFN_DENSE, FFN_MOE, FFN_MOE_DENSE):
        raise NotImplementedError(
            f"layer {spec}: the port runs GQA attention or Mamba mixers with "
            "a dense, MoE or MoE + dense FFN; the xLSTM mixers and FFN-less "
            "layers are ROADMAP A9")


def block_defs(cfg: ModelConfig, spec: LayerSpec) -> dict:
    check_spec(spec)
    d, dt = cfg.d_model, cfg.dtype
    if spec.mixer == ATTN:
        mixer = attn.mla_defs(cfg) if cfg.mla is not None \
            else attn.gqa_defs(cfg)
    else:
        mixer = ssm_mod.mamba_defs(cfg)
    if spec.ffn == FFN_DENSE:
        ffn = moe_mod.ffn_defs(d, cfg.d_ff, dt)
    else:
        ffn = moe_mod.moe_defs(cfg,
                               dense_residual=spec.ffn == FFN_MOE_DENSE)
    return {"norm1": ParamDef((d,), init="ones", dtype=dt),
            "mixer": mixer,
            "norm2": ParamDef((d,), init="ones", dtype=dt),
            "ffn": ffn}


def _ffn_apply(cfg: ModelConfig, spec: LayerSpec, p: dict, x: torch.Tensor,
               impl: Optional[str]):
    """Returns (x + FFN(norm2(x)), the MoE balance loss, or None for a
    dense FFN)."""
    h = rmsnorm(x, p["norm2"], cfg.norm_eps)
    if spec.ffn == FFN_DENSE:
        return x + moe_mod.dense_ffn(p["ffn"], h, impl=impl), None
    y, aux = moe_mod.moe_ffn(cfg, p["ffn"], h,
                             dense_residual=spec.ffn == FFN_MOE_DENSE,
                             impl=impl)
    return x + y, aux


def block_full(cfg: ModelConfig, spec: LayerSpec, p: dict, x: torch.Tensor,
               positions: torch.Tensor, *, q_offset=0,
               return_state: bool = False, impl: Optional[str] = None):
    """Whole-chunk prefill for one layer.  Returns (x, aux, state): the
    MoE balance loss (None for a dense FFN), and with ``return_state``
    ``state`` is ``{"kv": (k, v)}`` with the chunk's K/V (MLA's latent
    ``(c_kv, k_rope)``) for attention and the new ``{"conv", "ssm"}`` for
    Mamba, else None."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if spec.mixer == ATTN:
        fn = attn.mla_full if cfg.mla is not None else attn.gqa_full
        r = fn(cfg, p["mixer"], h, positions, q_offset=q_offset,
               return_kv=return_state, impl=impl)
        y, kv = r if return_state else (r, None)
        state = {"kv": kv} if return_state else None
    else:
        r = ssm_mod.mamba_full(cfg, p["mixer"], h, return_state=return_state,
                               impl=impl)
        y, state = r if return_state else (r, None)
    x, aux = _ffn_apply(cfg, spec, p, x + y, impl)
    return x, aux, state


def block_decode(cfg: ModelConfig, spec: LayerSpec, p: dict, x: torch.Tensor,
                 positions: torch.Tensor, cache: dict,
                 cache_len: torch.Tensor, impl: Optional[str] = None):
    """Single-token decode for one layer.  Returns (x, cache): attention's
    cache updated in place, Mamba's new state as new tensors (the old one
    untouched, so the engine commits only the decoding rows)."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if spec.mixer == ATTN:
        fn = attn.mla_decode if cfg.mla is not None else attn.gqa_decode
        y, cache = fn(cfg, p["mixer"], h, positions, cache, cache_len,
                      impl=impl)
    else:
        y, cache = ssm_mod.mamba_decode(cfg, p["mixer"], h, cache)
    x, _aux = _ffn_apply(cfg, spec, p, x + y, impl)
    return x, cache


def block_chunk(cfg: ModelConfig, spec: LayerSpec, p: dict, x: torch.Tensor,
                positions: torch.Tensor, cache: dict,
                cache_len: torch.Tensor, impl: Optional[str] = None):
    """Incremental chunked prefill for one layer (DESIGN.md §7): the chunk's
    K/V are written at ``cache_len`` and it attends the prefix; a Mamba
    layer resumes from its state (cache format == state format).  Returns
    (x, cache), the cache updated in place: the new Mamba state is copied
    into the given leaves, which may be views of a slot."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if spec.mixer == ATTN:
        fn = attn.mla_prefill_chunk if cfg.mla is not None \
            else attn.gqa_prefill_chunk
        y, cache = fn(cfg, p["mixer"], h, positions, cache, cache_len,
                      impl=impl)
    else:
        y, state = ssm_mod.mamba_full(cfg, p["mixer"], h, initial=cache,
                                      return_state=True, impl=impl)
        for name, leaf in cache.items():
            leaf.copy_(state[name])
    x, _aux = _ffn_apply(cfg, spec, p, x + y, impl)
    return x, cache


def block_packed(cfg: ModelConfig, spec: LayerSpec, p: dict, x: torch.Tensor,
                 positions: torch.Tensor, cache: dict,
                 token_slot: torch.Tensor, token_wpos: torch.Tensor,
                 token_active: Optional[torch.Tensor] = None,
                 kv_bucket: Optional[int] = None,
                 token_dst: Optional[torch.Tensor] = None,
                 block_tables: Optional[torch.Tensor] = None,
                 impl: Optional[str] = None):
    """Token-packed step for one layer (DESIGN.md §8); ``token_dst`` and
    ``block_tables`` switch attention to block-table mode (§12); a Mamba
    layer advances each token's slot state, committing only tokens with
    ``token_active`` set (required for Mamba layers).  Returns (x, cache),
    the cache updated in place."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if spec.mixer == ATTN:
        fn = attn.mla_packed if cfg.mla is not None else attn.gqa_packed
        y, cache = fn(cfg, p["mixer"], h, positions, cache, token_slot,
                      token_wpos, kv_bucket=kv_bucket, token_dst=token_dst,
                      block_tables=block_tables, impl=impl)
    else:
        if token_active is None:
            raise ValueError("a Mamba layer's packed step needs token_active")
        y, cache = ssm_mod.mamba_packed(cfg, p["mixer"], h, cache,
                                        token_slot, token_active)
    x, _aux = _ffn_apply(cfg, spec, p, x + y, impl)
    return x, cache


def block_init_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, device: torch.device,
                     kv_dtype: Optional[str] = None) -> dict:
    """Attention's K/V (MLA's latent) cache (``kv_dtype`` applies to it
    only), or a Mamba layer's zero state."""
    check_spec(spec)
    if spec.mixer == MAMBA:
        return ssm_mod.mamba_init_cache(cfg, batch, device)
    fn = attn.mla_init_cache if cfg.mla is not None else attn.gqa_init_cache
    return fn(cfg, batch, max_len, device, kv_dtype)
