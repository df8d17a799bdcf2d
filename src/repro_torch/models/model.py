"""Unified LM: embedding -> decoder layers -> head (port of
``repro.models.model``'s ``init``, ``init_cache``, the packed step's
``forward_packed`` and the legacy step's ``forward_full``,
``forward_decode``, ``forward_chunk`` and ``prefill``).

Parameters are plain dicts of tensors in the JAX layouts, with the
per-layer leaves unstacked into ``params["layers"]`` (a Python loop over
layers takes the place of ``jax.lax.scan``); the cache is a list of
per-layer dicts: ``{"k", "v"}`` for GQA attention and the latent
``{"c_kv", "k_rope"}`` for MLA (plus ``<name>_s`` scales for int8 KV) and
the recurrent state ``{"conv", "ssm"}`` for Mamba.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models.layers import rmsnorm
from repro_torch.models.param import ParamDef, init_params


def check_config(cfg: ModelConfig) -> None:
    """The port runs decoders of GQA or absorbed-MLA attention and Mamba
    layers (hybrids included), each with a dense SwiGLU, MoE or MoE + dense
    FFN, untied embeddings and no modality frontend; anything else
    raises."""
    if cfg.frontend != "none" or cfg.tie_embeddings or not cfg.ffn_gated:
        raise NotImplementedError(
            f"{cfg.name}: frontends, tied embeddings and ungated FFNs are "
            "not in the port yet (ROADMAP A16)")
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
               device: Optional[str | torch.device] = None,
               kv_dtype: Optional[str] = None) -> list:
    """Zeroed per-layer slot caches ``{"k", "v"}: (batch, max_len, KV, hd)``
    (MLA: ``{"c_kv": (batch, max_len, rank), "k_rope": (batch, max_len,
    rope)}``); ``kv_dtype="int8"`` stores int8 values with f32 scale leaves
    ``<name>_s`` of one scale per row (DESIGN.md §15)."""
    check_config(cfg)
    dev = resolve_device(device)
    return [blocks.block_init_cache(cfg, spec, batch, max_len, dev, kv_dtype)
            for spec in cfg.layer_specs()]


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def _head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return torch.matmul(x, params["head"])


def forward_packed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                   cache: list, token_slot: torch.Tensor,
                   token_pos: torch.Tensor, token_wpos: torch.Tensor,
                   token_active: Optional[torch.Tensor] = None,
                   kv_bucket: Optional[int] = None,
                   token_dst: Optional[torch.Tensor] = None,
                   block_tables: Optional[torch.Tensor] = None,
                   impl: Optional[str] = None):
    """One iteration's model work on a token-packed stream (DESIGN.md §8).

    tokens: (1, T) packed stream; token_slot: (T,) int32 slot per token;
    token_pos: (T,) int32 position of the token in its request;
    token_wpos: (T,) int32 cache write row — ``token_pos`` for real tokens,
    ``max_len`` for padding (whose K/V are then not written);
    token_active: (T,) bool, False for padding, whose recurrent state is
    then not committed (required when the model has Mamba layers).  Each
    token attends rows [0, pos] of its own slot, so segments never attend
    across each other; ``kv_bucket`` bounds the rows read (DESIGN.md §9).
    ``token_dst`` ((T,) int32 flat physical rows, N·S for padding) and
    ``block_tables`` ((N_slots, max_len / block_size) int32) switch
    attention to block-table mode (DESIGN.md §12): K/V scatter by physical
    row and are read through the per-slot tables.
    ``impl="plain"`` runs the kernels' plain versions on any device.

    Returns (logits (1, T, vocab), cache), the cache updated in place."""
    x = _embed(params, tokens)
    positions = token_pos[None]
    for spec, p, c in zip(cfg.layer_specs(), params["layers"], cache):
        x, _ = blocks.block_packed(cfg, spec, p, x, positions, c, token_slot,
                                   token_wpos, token_active,
                                   kv_bucket=kv_bucket,
                                   token_dst=token_dst,
                                   block_tables=block_tables, impl=impl)
    return _head(cfg, params, x), cache


def forward_full(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
                 positions: Optional[torch.Tensor] = None, q_offset=0,
                 return_states: bool = False, impl: Optional[str] = None):
    """Whole-chunk causal forward (prefill; the recompute path).  tokens:
    (B, S); ``q_offset`` (an int or a (B,) int32 tensor) is the position of
    the first token, and sets the positions unless they are given.

    Returns (logits (B, S, vocab), aux) or, with ``return_states``,
    (logits, aux, states): ``states[i]`` is layer i's ``{"kv": (k, v)}``,
    each (B, S, KV, hd) (MLA: the latent ``(c_kv, k_rope)``), for an
    attention layer and its final ``{"conv",
    "ssm"}`` for a Mamba layer, for handing off to a decode cache.  ``aux``
    is the MoE balance loss summed over the layers (0 without experts)."""
    x = _embed(params, tokens)
    b, s = tokens.shape
    if positions is None:
        if isinstance(q_offset, torch.Tensor):
            positions = q_offset.reshape(-1, 1).to(torch.int32) + \
                torch.arange(s, dtype=torch.int32, device=x.device)
        else:
            positions = torch.arange(q_offset, q_offset + s,
                                     dtype=torch.int32, device=x.device)
        positions = positions.expand(b, s)
    states = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for spec, p in zip(cfg.layer_specs(), params["layers"]):
        x, a, st = blocks.block_full(cfg, spec, p, x, positions,
                                     q_offset=q_offset,
                                     return_state=return_states, impl=impl)
        if a is not None:
            aux = aux + a
        states.append(st)
    logits = _head(cfg, params, x)
    return (logits, aux, states) if return_states else (logits, aux)


def forward_decode(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                   cache: list, cache_len: torch.Tensor,
                   impl: Optional[str] = None):
    """tokens: (B, 1); cache_len: (B,) int32 valid rows before this token.
    Writes each row's K/V at its ``cache_len`` and attends [0, cache_len].
    Returns (logits (B, vocab), new cache): attention layers' entries are
    the given dicts, updated in place; Mamba layers' are new states, every
    row advanced, with the given ones left as they were (the engine
    commits only the decoding slots, as JAX's ``_decode_impl`` does)."""
    x = _embed(params, tokens)
    positions = cache_len[:, None]
    new_cache = []
    for spec, p, c in zip(cfg.layer_specs(), params["layers"], cache):
        x, c = blocks.block_decode(cfg, spec, p, x, positions, c, cache_len,
                                   impl=impl)
        new_cache.append(c)
    return _head(cfg, params, x)[:, 0], new_cache


def forward_chunk(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                  cache: list, cache_len: torch.Tensor,
                  impl: Optional[str] = None):
    """Incremental chunked prefill (DESIGN.md §7): ``tokens`` (B, L) are
    the next L positions after the ``cache_len`` (B,) int32 rows already in
    ``cache``; each prompt token passes through the model once across
    chunks; Mamba layers resume from their state.  Returns (logits (B, L,
    vocab), cache), the cache updated in place (each Mamba state copied
    into its given leaves, which may be views of a slot)."""
    x = _embed(params, tokens)
    positions = cache_len[:, None] + torch.arange(
        tokens.shape[1], dtype=torch.int32, device=x.device)
    for spec, p, c in zip(cfg.layer_specs(), params["layers"], cache):
        x, _ = blocks.block_chunk(cfg, spec, p, x, positions, c, cache_len,
                                  impl=impl)
    return _head(cfg, params, x), cache


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            max_len: Optional[int] = None, impl: Optional[str] = None):
    """Run ``forward_full`` over the prompts, then place each attention
    layer's K/V at rows [0, S) of a fresh cache of ``max_len`` rows
    (default S), made by ``init_cache`` on the tokens' device; a Mamba
    layer's final state is its cache.  Returns (last logits (B, vocab),
    cache, cache_len (B,) int32)."""
    logits, _aux, states = forward_full(cfg, params, tokens,
                                        return_states=True, impl=impl)
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len or s, device=tokens.device)
    for spec, c, st in zip(cfg.layer_specs(), cache, states):
        if spec.mixer == ATTN:
            for name, val in zip(attn.kv_names(cfg), st["kv"]):
                c[name][:, :s] = val
        else:
            for name, leaf in c.items():
                leaf.copy_(st[name])
    cache_len = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    return logits[:, -1], cache, cache_len
