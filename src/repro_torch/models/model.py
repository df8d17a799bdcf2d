"""Unified LM on the token-packed serving path: embedding -> decoder layers
-> head (port of ``repro.models.model``'s ``init``, ``init_cache`` and
``forward_packed``).

Parameters are plain dicts of tensors in the JAX layouts, with the
per-layer leaves unstacked into ``params["layers"]`` (a Python loop over
layers takes the place of ``jax.lax.scan``); the cache is a list of
per-layer ``{"k", "v"}`` dicts.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.layers import rmsnorm
from repro_torch.models.param import ParamDef, init_params


def check_config(cfg: ModelConfig) -> None:
    """The port runs dense GQA decoders with untied SwiGLU and no
    modality frontend; anything else raises."""
    if cfg.frontend != "none" or cfg.tie_embeddings or not cfg.ffn_gated:
        raise NotImplementedError(
            f"{cfg.name}: frontends, tied embeddings and ungated FFNs are "
            "not in the port yet (ROADMAP A5, A9)")
    for spec in cfg.layer_specs():
        blocks.check_spec(spec)


def model_defs(cfg: ModelConfig) -> dict:
    check_config(cfg)
    d, v, dt = cfg.d_model, cfg.vocab_size, cfg.dtype
    return {
        "embed": ParamDef((v, d), dtype=dt),
        "head": ParamDef((d, v), dtype=dt),
        "layers": [blocks.block_defs(cfg, spec) for spec in cfg.layer_specs()],
        "final_norm": ParamDef((d,), init="ones", dtype=dt),
    }


def init(cfg: ModelConfig, seed: int = 0,
         device: Optional[str | torch.device] = None) -> dict:
    """Seeded random weights in the JAX init's shapes and scales, drawn on
    ``device`` (``cuda`` unless the caller asks for another)."""
    return init_params(model_defs(cfg), seed, resolve_device(device))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Optional[str | torch.device] = None) -> list:
    """Zeroed per-layer slot caches ``{"k", "v"}: (batch, max_len, KV, hd)``."""
    check_config(cfg)
    dev = resolve_device(device)
    return [blocks.block_init_cache(cfg, spec, batch, max_len, dev)
            for spec in cfg.layer_specs()]


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def _head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return torch.matmul(x, params["head"])


def forward_packed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                   cache: list, token_slot: torch.Tensor,
                   token_pos: torch.Tensor, token_wpos: torch.Tensor,
                   kv_bucket: Optional[int] = None,
                   impl: Optional[str] = None):
    """One iteration's model work on a token-packed stream (DESIGN.md §8).

    tokens: (1, T) packed stream; token_slot: (T,) int32 slot per token;
    token_pos: (T,) int32 position of the token in its request;
    token_wpos: (T,) int32 cache write row — ``token_pos`` for real tokens,
    ``max_len`` for padding (whose K/V are then not written).  Each token
    attends rows [0, pos] of its own slot, so segments never attend across
    each other; ``kv_bucket`` bounds the rows read (DESIGN.md §9).
    ``impl="plain"`` runs the kernels' plain versions on any device.

    Returns (logits (1, T, vocab), cache), the cache updated in place."""
    x = _embed(params, tokens)
    positions = token_pos[None]
    for spec, p, c in zip(cfg.layer_specs(), params["layers"], cache):
        x, _ = blocks.block_packed(cfg, spec, p, x, positions, c, token_slot,
                                   token_wpos, kv_bucket=kv_bucket, impl=impl)
    return _head(cfg, params, x), cache
