"""Per-layer block: GQA attention + dense FFN, pre-norm residual (port of
``repro.models.blocks`` for ``LayerSpec(ATTN, FFN_DENSE)``)."""
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


def block_packed(cfg: ModelConfig, spec: LayerSpec, p: dict, x: torch.Tensor,
                 positions: torch.Tensor, cache: dict,
                 token_slot: torch.Tensor, token_wpos: torch.Tensor,
                 kv_bucket: Optional[int] = None,
                 impl: Optional[str] = None):
    """Token-packed step for one layer (DESIGN.md §8).  Returns
    (x, cache), the cache updated in place."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    y, cache = attn.gqa_packed(cfg, p["mixer"], h, positions, cache,
                               token_slot, token_wpos, kv_bucket=kv_bucket,
                               impl=impl)
    x = x + y
    h = rmsnorm(x, p["norm2"], cfg.norm_eps)
    return x + moe_mod.dense_ffn(p["ffn"], h, impl=impl), cache


def block_init_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, device: torch.device) -> dict:
    check_spec(spec)
    return attn.gqa_init_cache(cfg, batch, max_len, device)
