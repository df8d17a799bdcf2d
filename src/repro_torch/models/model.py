"""Unified LM: embedding or frontend stub -> decoder layers -> head (port of
``repro.models.model``'s ``init``, ``init_cache``, the packed step's
``forward_packed`` and the legacy step's ``forward_full``,
``forward_decode``, ``forward_chunk`` and ``prefill``, and training's
``loss_fn`` with ``forward_full``'s remat policies).

Parameters are plain dicts of tensors in the JAX layouts, with the
per-layer leaves unstacked into ``params["layers"]`` (a Python loop over
layers takes the place of ``jax.lax.scan``); the cache is a list of
per-layer dicts: ``{"k", "v"}`` for GQA attention and the latent
``{"c_kv", "k_rope"}`` for MLA (plus ``<name>_s`` scales for int8 KV) and
the recurrent state for Mamba and the xLSTM mixers (``blocks``).

The frontends are JAX's stubs: the vision stub (LLaVA) projects given patch
embeddings (B, P, D) with ``patch_proj`` and prepends them to the text
embeddings (``forward_full`` and ``prefill`` only, as in JAX); the audio
stub (MusicGen) takes (..., K) token streams, sums the K codebooks'
embeddings and has one head per codebook, so logits are (..., K, vocab).
With tied embeddings the head is the embedding's transpose.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.distributed import tp
from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models.layers import cross_entropy, rmsnorm
from repro_torch.models.param import (ParamDef, count_params, init_params,
                                      map_defs)


def check_config(cfg: ModelConfig) -> None:
    """Every layer kind of the JAX package (``blocks.check_spec``) and one
    of its frontends; anything else raises."""
    if cfg.frontend not in ("none", "vision", "audio"):
        raise ValueError(f"{cfg.name}: unknown frontend {cfg.frontend!r}")
    for spec in cfg.layer_specs():
        blocks.check_spec(spec)


def model_defs(cfg: ModelConfig) -> dict:
    check_config(cfg)
    d, v, dt = cfg.d_model, cfg.vocab_size, cfg.dtype
    defs: dict = {}
    if cfg.frontend == "audio":
        k = cfg.num_codebooks
        defs["embed"] = ParamDef((k, v, d), dtype=dt, fan_in_axes=(1,))
        defs["head"] = ParamDef((d, k, v), dtype=dt)
    else:
        defs["embed"] = ParamDef((v, d), dtype=dt)
        if not cfg.tie_embeddings:
            defs["head"] = ParamDef((d, v), dtype=dt)
    if cfg.frontend == "vision":
        defs["patch_proj"] = ParamDef((d, d), dtype=dt)
    defs["layers"] = [blocks.block_defs(cfg, spec)
                      for spec in cfg.layer_specs()]
    defs["final_norm"] = ParamDef((d,), init="ones", dtype=dt)
    return defs


def init(cfg: ModelConfig, seed: int = 0,
         device: Optional[str | torch.device] = None,
         shard: Optional[tuple[int, int]] = None) -> dict:
    """Seeded random weights in the JAX init's shapes and scales, drawn on
    ``device`` (``cuda`` unless the caller asks for another).  ``shard=(rank,
    world)`` keeps only a tensor-parallel rank's shard of each leaf
    (``distributed.tp``): the same values as the full init's, cut as each
    leaf is drawn, so the peak is the shard plus one full leaf."""
    cut = None
    if shard is not None:
        rank, world = shard
        cut = functools.partial(tp.cut_param, cfg, rank=rank, world=world)
    return init_params(model_defs(cfg), seed, resolve_device(device), cut)


# the cost model asks for both counts in every call (``model_stats``); a
# config is frozen, so each is counted once
@functools.lru_cache(maxsize=64)
def num_params(cfg: ModelConfig) -> int:
    return count_params(model_defs(cfg))


@functools.lru_cache(maxsize=64)
def active_params(cfg: ModelConfig) -> int:
    """6·N_active·D — total minus the inactive routed-expert fraction (the
    routed experts' stacked leaves are the ``per_slice`` ones)."""
    tree = model_defs(cfg)
    total = count_params(tree)
    if cfg.moe is None:
        return total
    expert_total = 0

    def leaf(path, d: ParamDef):
        nonlocal expert_total
        if d.per_slice and path[-1] in ("w_gate", "w_up", "w_down"):
            expert_total += math.prod(d.shape)

    map_defs(leaf, tree)
    frac = cfg.moe.top_k / cfg.moe.num_experts
    return total - expert_total + int(expert_total * frac)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Optional[str | torch.device] = None,
               kv_dtype: Optional[str] = None, world: int = 1) -> list:
    """Zeroed per-layer slot caches ``{"k", "v"}: (batch, max_len, KV, hd)``
    (MLA: ``{"c_kv": (batch, max_len, rank), "k_rope": (batch, max_len,
    rope)}``); ``kv_dtype="int8"`` stores int8 values with f32 scale leaves
    ``<name>_s`` of one scale per row (DESIGN.md §15).  ``world > 1``
    allocates a tensor-parallel rank's leaves only, each cut on the axis of
    ``tp.cache_axes``."""
    check_config(cfg)
    dev = resolve_device(device)
    return [blocks.block_init_cache(cfg, spec, batch, max_len, dev, kv_dtype,
                                    world)
            for spec in cfg.layer_specs()]


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
           patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, S), or (B, S, K) for audio, whose codebook embeddings
    are summed in codebook order; the vision stub prepends the projected
    ``patches`` when they are given."""
    tok = tokens.long()
    if cfg.frontend == "audio":
        x = params["embed"][0][tok[..., 0]]
        for i in range(1, cfg.num_codebooks):
            x = x + params["embed"][i][tok[..., i]]
    else:
        x = params["embed"][tok]
    if cfg.frontend == "vision" and patches is not None:
        pe = torch.matmul(patches.to(x.dtype), params["patch_proj"])
        x = torch.cat([pe, x], dim=1)
    return x


def _head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cfg.frontend == "audio":
        w = params["head"]                                  # (D, K, V)
        return torch.matmul(x, w.reshape(w.shape[0], -1)).reshape(
            *x.shape[:-1], *w.shape[1:])
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return torch.matmul(x, w)


def forward_packed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                   cache: list, token_slot: torch.Tensor,
                   token_pos: torch.Tensor, token_wpos: torch.Tensor,
                   token_active: Optional[torch.Tensor] = None,
                   kv_bucket: Optional[int] = None,
                   token_dst: Optional[torch.Tensor] = None,
                   block_tables: Optional[torch.Tensor] = None,
                   impl: Optional[str] = None):
    """One iteration's model work on a token-packed stream (DESIGN.md §8).

    tokens: (1, T) packed stream ((1, T, K) for audio); token_slot: (T,)
    int32 slot per token; token_pos: (T,) int32 position of the token in its request;
    token_wpos: (T,) int32 cache write row — ``token_pos`` for real tokens,
    ``max_len`` for padding (whose K/V are then not written);
    token_active: (T,) bool, False for padding, whose recurrent state is
    then not committed (required when the model has recurrent layers).  Each
    token attends rows [0, pos] of its own slot, so segments never attend
    across each other; ``kv_bucket`` bounds the rows read (DESIGN.md §9).
    ``token_dst`` ((T,) int32 flat physical rows, N·S for padding) and
    ``block_tables`` ((N_slots, max_len / block_size) int32) switch
    attention to block-table mode (DESIGN.md §12): K/V scatter by physical
    row and are read through the per-slot tables.
    ``impl="plain"`` runs the kernels' plain versions on any device.

    Returns (logits (1, T, vocab) or (1, T, K, vocab), cache), the cache
    updated in place."""
    x = _embed(cfg, params, tokens)
    positions = token_pos[None]
    for spec, p, c in zip(cfg.layer_specs(), params["layers"], cache):
        x, _ = blocks.block_packed(cfg, spec, p, x, positions, c, token_slot,
                                   token_wpos, token_active,
                                   kv_bucket=kv_bucket,
                                   token_dst=token_dst,
                                   block_tables=block_tables, impl=impl)
    return _head(cfg, params, x), cache


# JAX's remat policies (``repro.models.model._remat``), applied per layer
REMAT = ("none", "full", "dots", "dots_no_batch")


def _remat_context(policy: str):
    """``context_fn`` of ``torch.utils.checkpoint`` for a policy: ``full``
    saves nothing of the layer (None: plain checkpointing); ``dots`` saves
    every matrix product's output and recomputes the rest, as
    ``jax.checkpoint_policies.checkpoint_dots``; ``dots_no_batch`` saves
    the products without a batch axis only (``mm``, ``addmm``, not
    ``bmm``), as ``checkpoint_dots_with_no_batch_dims``."""
    if policy == "full":
        return None
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    aten = torch.ops.aten
    saved = {aten.mm.default, aten.addmm.default}
    if policy == "dots":
        saved |= {aten.bmm.default, aten.baddbmm.default}

    def policy_fn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


def forward_full(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
                 patches: Optional[torch.Tensor] = None,
                 positions: Optional[torch.Tensor] = None, q_offset=0,
                 return_states: bool = False, impl: Optional[str] = None,
                 remat: str = "none"):
    """Whole-chunk causal forward (prefill; the recompute path).  tokens:
    (B, S) ((B, S, K) for audio); the vision stub's ``patches`` (B, P, D)
    come first in the sequence, so S counts them too below.  ``q_offset``
    (an int or a (B,) int32 tensor) is the position of the first token,
    and sets the positions unless they are given.

    Returns (logits (B, S, vocab), aux) or, with ``return_states``,
    (logits, aux, states): ``states[i]`` is layer i's ``{"kv": (k, v)}``,
    each (B, S, KV, hd) (MLA: the latent ``(c_kv, k_rope)``), for an
    attention layer and its final recurrent state for the others, for
    handing off to a decode cache.  ``aux`` is the MoE balance loss summed
    over the layers (0 without experts).

    ``remat`` (one of ``REMAT``) recomputes each layer's activations in
    the backward instead of keeping them (``torch.utils.checkpoint``,
    non-reentrant, per layer; JAX applies its policy to the scanned layer
    group); it does not combine with ``return_states``."""
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r} not in {REMAT}")
    if remat != "none" and return_states:
        raise ValueError("remat does not return states")
    x = _embed(cfg, params, tokens, patches)
    b, s = x.shape[0], x.shape[1]
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
        if remat == "none":
            x, a, st = blocks.block_full(cfg, spec, p, x, positions,
                                         q_offset=q_offset,
                                         return_state=return_states,
                                         impl=impl)
        else:
            layer = functools.partial(blocks.block_full, cfg, spec, p,
                                      positions=positions, q_offset=q_offset,
                                      impl=impl)
            context = _remat_context(remat)
            x, a, st = torch.utils.checkpoint.checkpoint(
                layer, x, use_reentrant=False,
                **({} if context is None else {"context_fn": context}))
        if a is not None:
            aux = aux + a
        states.append(st)
    logits = _head(cfg, params, x)
    return (logits, aux, states) if return_states else (logits, aux)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *,
            remat: str = "none", aux_weight: float = 0.01,
            impl: Optional[str] = None):
    """batch: {tokens, labels[, patches]} tensors; labels < 0 are masked
    out.  With the vision stub's patches the loss is taken on the text
    positions only (after the patch prefix).  Returns (xent + aux_weight ·
    aux, {"xent", "aux"})."""
    patches = batch.get("patches")
    logits, aux = forward_full(cfg, params, batch["tokens"], patches=patches,
                               remat=remat, impl=impl)
    labels = batch["labels"]
    if cfg.frontend == "vision" and patches is not None:
        logits = logits[:, patches.shape[1]:]
    mask = (labels >= 0).to(torch.float32)
    xent = cross_entropy(logits, torch.clamp(labels, min=0), mask)
    return xent + aux_weight * aux, {"xent": xent, "aux": aux}


def forward_decode(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                   cache: list, cache_len: torch.Tensor,
                   impl: Optional[str] = None):
    """tokens: (B, 1) ((B, 1, K) for audio); cache_len: (B,) int32 valid
    rows before this token.  Writes each row's K/V at its ``cache_len`` and
    attends [0, cache_len].  Returns (logits (B, vocab) or (B, K, vocab),
    new cache): attention layers' entries are the given dicts, updated in
    place; recurrent layers' are new states, every row advanced, with the
    given ones left as they were (the engine commits only the decoding
    slots, as JAX's ``_decode_impl`` does)."""
    x = _embed(cfg, params, tokens)
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
    """Incremental chunked prefill (DESIGN.md §7): ``tokens`` (B, L) ((B,
    L, K) for audio) are the next L positions after the ``cache_len`` (B,)
    int32 rows already in ``cache``; each prompt token passes through the
    model once across chunks; recurrent layers resume from their state.
    Returns (logits (B, L, vocab) or (B, L, K, vocab), cache), the cache
    updated in place (each recurrent state copied into its given leaves,
    which may be views of a slot)."""
    x = _embed(cfg, params, tokens)
    positions = cache_len[:, None] + torch.arange(
        tokens.shape[1], dtype=torch.int32, device=x.device)
    for spec, p, c in zip(cfg.layer_specs(), params["layers"], cache):
        x, _ = blocks.block_chunk(cfg, spec, p, x, positions, c, cache_len,
                                  impl=impl)
    return _head(cfg, params, x), cache


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            patches: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None, impl: Optional[str] = None):
    """Run ``forward_full`` over the prompts (after the ``patches``, when
    given), then place each attention layer's K/V at rows [0, S) of a
    fresh cache of ``max_len`` rows (default S, the patches counted), made
    by ``init_cache`` on the tokens' device; a recurrent layer's final
    state is its cache.  Returns (last logits (B, vocab) or (B, K, vocab),
    cache, cache_len (B,) int32)."""
    logits, _aux, states = forward_full(cfg, params, tokens,
                                        patches=patches, return_states=True,
                                        impl=impl)
    b, s = logits.shape[0], logits.shape[1]
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
