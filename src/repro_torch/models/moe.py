"""FFNs (port of ``repro.models.moe``): the dense FFN (SwiGLU, or
the ungated GELU MLP of StarCoder2, Minitron and MusicGen) and
the Mixture-of-Experts FFN with GShard top-k routing and capacity,
DeepSeek-style shared experts and Arctic's parallel dense residual.

The MoE FFN keeps the JAX formulation: tokens are cut into dispatch groups
of ``MoEConfig.dispatch_group`` (the JAX package's ``REPRO_MOE_GROUP``
override is not kept), every group's (token, expert) choices are placed
in each expert's C capacity rows by one-hot dispatch and combine tensors
(G, S, E, C), and every expert runs over all of its C rows.  The JAX
function computes the expert products with ``jnp.einsum`` outside any
Pallas kernel, so here they are ``torch.einsum`` (batched GEMMs); the
shared experts and the dense residual go through ``dense_ffn`` and so the
SwiGLU kernel.  The bf16 casts of the JAX function are made explicitly
(``torch.einsum`` does not promote), in f32 configurations too: the tokens
enter the dispatch product and the combine weights the combine product as
bf16.

Under tensor parallelism (``distributed.tp``) the dense FFN is column- then
row-parallel: SwiGLU runs on the rank's ``d_ff / tp`` columns and the down
projection is ``tp.row_parallel``.  The MoE FFN routes replicated, keeps
the dispatch and combine columns of the rank's experts, runs those and
psums the combine; its shared and dense-residual FFNs are dense FFNs.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.distributed import tp
from repro_torch.kernels import ops
from repro_torch.models.layers import gelu, silu
from repro_torch.models.param import ParamDef


def ffn_defs(d: int, d_ff: int, dt: str, gated: bool = True) -> dict:
    """``w_up``, ``w_down`` and, for SwiGLU, ``w_gate``."""
    defs = {
        "w_up": ParamDef((d, d_ff), dtype=dt),
        "w_down": ParamDef((d_ff, d), dtype=dt),
    }
    if gated:
        defs["w_gate"] = ParamDef((d, d_ff), dtype=dt)
    return defs


def moe_defs(cfg: ModelConfig, *, dense_residual: bool = False) -> dict:
    """The router (f32, 0.02-scaled), the experts' stacked (E, D, F) /
    (E, F, D) weights (each expert drawn on its own: ``per_slice``), and
    the shared experts' and the dense residual's FFNs where the config has
    them."""
    m = cfg.moe
    d, dt, e, f = cfg.d_model, cfg.dtype, m.num_experts, m.expert_d_ff
    defs = {
        "router": ParamDef((d, e), init="small", dtype="float32"),
        "w_gate": ParamDef((e, d, f), dtype=dt, fan_in_axes=(1,),
                           per_slice=True),
        "w_up": ParamDef((e, d, f), dtype=dt, fan_in_axes=(1,),
                         per_slice=True),
        "w_down": ParamDef((e, f, d), dtype=dt, fan_in_axes=(1,),
                           per_slice=True),
    }
    if m.num_shared_experts:
        defs["shared"] = ffn_defs(d, m.shared_d_ff, dt)
    if dense_residual:
        defs["dense"] = ffn_defs(d, cfg.d_ff, dt)
    return defs


def dense_ffn(p: dict, x: torch.Tensor,
              impl: Optional[str] = None) -> torch.Tensor:
    """``(silu(x @ w_gate) * (x @ w_up)) @ w_down``; x: (..., D).  The gate
    and up products and the SiLU·mul go through the SwiGLU kernel.
    Without ``w_gate`` it is ``gelu(x @ w_up) @ w_down``, two GEMMs and an
    elementwise pass, which JAX too computes outside any Pallas kernel.
    The down projection is ``tp.row_parallel``."""
    if "w_gate" not in p:
        return tp.row_parallel(gelu(torch.matmul(x, p["w_up"])), p["w_down"])
    lead = x.shape[:-1]
    h = ops.swiglu(x.reshape(-1, x.shape[-1]), p["w_gate"], p["w_up"],
                   impl=impl)
    return tp.row_parallel(h, p["w_down"]).reshape(*lead, -1)


def capacity(m: MoEConfig, group_size: int) -> int:
    """Rows per expert and dispatch group: ``ceil(S·k / E · factor)``, at
    least 4."""
    c = math.ceil(group_size * m.top_k / m.num_experts * m.capacity_factor)
    return max(4, c)


def route_topk(m: MoEConfig, router_logits: torch.Tensor):
    """router_logits: (G, S, E).  Returns (gates (G, S, K) f32 renormalised
    over the chosen k, idx (G, S, K) int64, aux scalar): the top k of the
    softmax, the larger probability first and, between equal ones, the
    lower expert (``jax.lax.top_k``'s order: a stable descending sort), and
    the Switch load-balance loss ``E · sum_e f_e · p_e`` over the top-1
    choices."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :m.top_k], idx[..., :m.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    e = m.num_experts
    me = probs.mean(dim=(0, 1))
    ce = torch.nn.functional.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))
    return gates, idx, e * torch.sum(me * ce)


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
            dense_residual: bool = False, impl: Optional[str] = None):
    """x: (B, S, D) -> (y (B, S, D) in x's dtype, aux scalar f32).  Every
    row of x is routed (padding too: it takes capacity, as in JAX); a
    (token, expert) pair past its expert's C rows in its group is dropped,
    an earlier choice k having priority (GShard)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    tokens = x.reshape(t, d)
    sg = min(m.dispatch_group, t)
    g = math.ceil(t / sg)
    if g * sg > t:
        tokens = torch.nn.functional.pad(tokens, (0, 0, 0, g * sg - t))
    grouped = tokens.reshape(g, sg, d)

    logits = torch.einsum("gsd,de->gse", grouped.float(), p["router"])
    gates, idx, aux = route_topk(m, logits)

    c = capacity(m, sg)
    e = m.num_experts
    slots = torch.arange(c, device=x.device)
    dispatch = torch.zeros((g, sg, e, c), dtype=torch.bfloat16,
                           device=x.device)
    combine = torch.zeros((g, sg, e, c), dtype=torch.float32,
                          device=x.device)
    prev = torch.zeros((g, 1, e), dtype=torch.int64, device=x.device)
    for k in range(m.top_k):
        mask = torch.nn.functional.one_hot(idx[..., k], e)       # (G,S,E)
        pos = torch.cumsum(mask, dim=1) - mask + prev             # (G,S,E)
        keep = (pos < c) & (mask > 0)
        pos_oh = ((pos[..., None] == slots) & keep[..., None]).to(
            torch.bfloat16)
        dispatch = dispatch + pos_oh
        combine = combine + pos_oh.float() * gates[..., k][..., None, None]
        prev = prev + mask.sum(dim=1, keepdim=True)

    ctx = tp.active()
    if ctx is not None:
        # the rank's experts: routing was replicated, the expert weights
        # hold E / tp experts, and the combine becomes a partial sum
        e_loc = e // ctx.size
        dispatch = dispatch[:, :, ctx.rank * e_loc:(ctx.rank + 1) * e_loc]
        combine = combine[:, :, ctx.rank * e_loc:(ctx.rank + 1) * e_loc]
    wdt = torch.promote_types(torch.bfloat16, p["w_gate"].dtype)
    # one token per (expert, group, row): the dispatch sums are exact.  The
    # bf16 expert_in is promoted in each product, as JAX's einsums do, so
    # that the backward rounds each product's gradient to bf16 before
    # summing them, as JAX's autodiff does
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch,
                             grouped.to(torch.bfloat16))
    h = silu(torch.einsum("egcd,edf->egcf", expert_in.to(wdt),
                          p["w_gate"])) * \
        torch.einsum("egcd,edf->egcf", expert_in.to(wdt), p["w_up"])
    expert_out = torch.einsum("egcf,efd->egcd", h, p["w_down"])
    y = tp.psum(torch.einsum("gsec,egcd->gsd",
                             combine.to(torch.bfloat16).to(expert_out.dtype),
                             expert_out))
    y = y.reshape(g * sg, d)[:t].reshape(b, s, d).to(x.dtype)

    if m.num_shared_experts:
        y = y + dense_ffn(p["shared"], x, impl=impl)
    if dense_residual:
        y = y + dense_ffn(p["dense"], x, impl=impl)
    return y, aux
