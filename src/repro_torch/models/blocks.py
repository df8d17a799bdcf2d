"""Per-layer block: a sequence mixer (GQA or, when the config has ``mla``,
absorbed MLA attention; Mamba; the xLSTM mLSTM or sLSTM) + an FFN (dense,
MoE, MoE beside a dense residual, or none), pre-norm residual (port of
``repro.models.blocks``): the packed step (``block_packed``) and the
legacy step's whole-chunk, decode and incremental-chunk paths
(``block_full``, ``block_decode``, ``block_chunk``).  An attention layer's
cache is ``{"k", "v"}`` for GQA and ``{"c_kv", "k_rope"}`` for MLA (plus
int8 scales); a recurrent layer's is its state: Mamba's ``{"conv",
"ssm"}``, the mLSTM's ``{"conv", "c", "n", "m"}``, the sLSTM's ``{"conv",
"c", "n", "h", "m"}``.  Every path computes the MoE balance loss; only
``block_full`` returns it, as in JAX."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import (ATTN, FFN_DENSE, FFN_MOE,
                                      FFN_MOE_DENSE, FFN_NONE, MAMBA, MLSTM,
                                      SLSTM, LayerSpec, ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import rmsnorm
from repro_torch.models.param import ParamDef

# the recurrent mixers' functions by kind: (defs, full, decode, packed,
# init_cache); ``full`` takes ``initial``/``return_state`` (chunks resume
# from the cache: cache format == state format), ``decode`` returns a new
# state and leaves the cache as it was, ``packed`` updates it in place
_RECURRENT = {
    MAMBA: (ssm_mod.mamba_defs, ssm_mod.mamba_full, ssm_mod.mamba_decode,
            ssm_mod.mamba_packed, ssm_mod.mamba_init_cache),
    MLSTM: (xlstm_mod.mlstm_defs, xlstm_mod.mlstm_full,
            xlstm_mod.mlstm_decode, xlstm_mod.mlstm_packed,
            xlstm_mod.mlstm_init_cache),
    SLSTM: (xlstm_mod.slstm_defs, xlstm_mod.slstm_full,
            xlstm_mod.slstm_decode, xlstm_mod.slstm_packed,
            xlstm_mod.slstm_init_cache),
}


def check_spec(spec: LayerSpec) -> None:
    if spec.mixer != ATTN and spec.mixer not in _RECURRENT:
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    if spec.ffn not in (FFN_DENSE, FFN_MOE, FFN_MOE_DENSE, FFN_NONE):
        raise ValueError(f"unknown FFN kind {spec.ffn!r}")


def block_defs(cfg: ModelConfig, spec: LayerSpec) -> dict:
    check_spec(spec)
    d, dt = cfg.d_model, cfg.dtype
    if spec.mixer == ATTN:
        mixer = attn.mla_defs(cfg) if cfg.mla is not None \
            else attn.gqa_defs(cfg)
    else:
        mixer = _RECURRENT[spec.mixer][0](cfg)
    defs = {"norm1": ParamDef((d,), init="ones", dtype=dt), "mixer": mixer}
    if spec.ffn == FFN_NONE:
        return defs
    defs["norm2"] = ParamDef((d,), init="ones", dtype=dt)
    if spec.ffn == FFN_DENSE:
        defs["ffn"] = moe_mod.ffn_defs(d, cfg.d_ff, dt, cfg.ffn_gated)
    else:
        defs["ffn"] = moe_mod.moe_defs(
            cfg, dense_residual=spec.ffn == FFN_MOE_DENSE)
    return defs


def _ffn_apply(cfg: ModelConfig, spec: LayerSpec, p: dict, x: torch.Tensor,
               impl: Optional[str]):
    """Returns (x + FFN(norm2(x)), the MoE balance loss, or None for a
    dense FFN or none)."""
    if spec.ffn == FFN_NONE:
        return x, None
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
    MoE balance loss (None for a dense FFN or none), and with
    ``return_state`` ``state`` is ``{"kv": (k, v)}`` with the chunk's K/V
    (MLA's latent ``(c_kv, k_rope)``) for attention and the new recurrent
    state for the other mixers, else None."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if spec.mixer == ATTN:
        fn = attn.mla_full if cfg.mla is not None else attn.gqa_full
        r = fn(cfg, p["mixer"], h, positions, q_offset=q_offset,
               return_kv=return_state, impl=impl)
        y, kv = r if return_state else (r, None)
        state = {"kv": kv} if return_state else None
    else:
        r = _full(cfg, spec, p["mixer"], h, None, return_state, impl)
        y, state = r if return_state else (r, None)
    x, aux = _ffn_apply(cfg, spec, p, x + y, impl)
    return x, aux, state


def _full(cfg: ModelConfig, spec: LayerSpec, p: dict, h: torch.Tensor,
          initial: Optional[dict], return_state: bool, impl: Optional[str]):
    """A recurrent mixer's whole-chunk path; only Mamba's runs a kernel
    (the selective scan), so only it takes ``impl``."""
    fn = _RECURRENT[spec.mixer][1]
    if spec.mixer == MAMBA:
        return fn(cfg, p, h, initial=initial, return_state=return_state,
                  impl=impl)
    return fn(cfg, p, h, initial=initial, return_state=return_state)


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
        y, cache = _RECURRENT[spec.mixer][2](cfg, p["mixer"], h, cache)
    x, _aux = _ffn_apply(cfg, spec, p, x + y, impl)
    return x, cache


def block_chunk(cfg: ModelConfig, spec: LayerSpec, p: dict, x: torch.Tensor,
                positions: torch.Tensor, cache: dict,
                cache_len: torch.Tensor, impl: Optional[str] = None):
    """Incremental chunked prefill for one layer (DESIGN.md §7): the chunk's
    K/V are written at ``cache_len`` and it attends the prefix; a
    recurrent layer resumes from its state (cache format == state format).
    Returns (x, cache), the cache updated in place: the new recurrent state
    is copied into the given leaves, which may be views of a slot."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if spec.mixer == ATTN:
        fn = attn.mla_prefill_chunk if cfg.mla is not None \
            else attn.gqa_prefill_chunk
        y, cache = fn(cfg, p["mixer"], h, positions, cache, cache_len,
                      impl=impl)
    else:
        y, state = _full(cfg, spec, p["mixer"], h, cache, True, impl)
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
    ``block_tables`` switch attention to block-table mode (§12); a
    recurrent layer advances each token's slot state, committing only
    tokens with ``token_active`` set (required for recurrent layers).
    Returns (x, cache), the cache updated in place."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if spec.mixer == ATTN:
        fn = attn.mla_packed if cfg.mla is not None else attn.gqa_packed
        y, cache = fn(cfg, p["mixer"], h, positions, cache, token_slot,
                      token_wpos, kv_bucket=kv_bucket, token_dst=token_dst,
                      block_tables=block_tables, impl=impl)
    else:
        if token_active is None:
            raise ValueError(f"a {spec.mixer} layer's packed step needs "
                             "token_active")
        y, cache = _RECURRENT[spec.mixer][3](cfg, p["mixer"], h, cache,
                                             token_slot, token_active)
    x, _aux = _ffn_apply(cfg, spec, p, x + y, impl)
    return x, cache


def block_init_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, device: torch.device,
                     kv_dtype: Optional[str] = None) -> dict:
    """Attention's K/V (MLA's latent) cache (``kv_dtype`` applies to it
    only), or a recurrent layer's initial state."""
    check_spec(spec)
    if spec.mixer != ATTN:
        return _RECURRENT[spec.mixer][4](cfg, batch, device)
    fn = attn.mla_init_cache if cfg.mla is not None else attn.gqa_init_cache
    return fn(cfg, batch, max_len, device, kv_dtype)
