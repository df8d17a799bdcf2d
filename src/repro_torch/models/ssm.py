"""Mamba-1 selective-SSM mixer, Jamba's sequence mixer (port of
``repro.models.ssm``).

A layer's state is ``{"conv": (B, K-1, d_in) model dtype, "ssm": (B, d_in,
N) f32}``: the last K-1 conv inputs and the scan state.  ``mamba_full``
(prefill, incremental chunks, recompute) runs the selective scan through
``ops.ssm_scan`` (the CUDA kernel on the card); ``mamba_decode`` and
``mamba_packed`` step the state one token at a time with plain ops, as the
JAX package does with ``ssm_step_ref``.

Under tensor parallelism (``distributed.tp``) a rank holds a contiguous
block of the inner channels ``d_in``: its halves of ``w_in``'s x and z
columns, its rows of ``w_x`` (so the dt/B/C projection is psum'd to the
full width) and ``w_out`` (row-parallel), and its channels of the state.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import MambaConfig, ModelConfig
from repro_torch.distributed import tp
from repro_torch.kernels import ops
from repro_torch.kernels.ssm_scan import ssm_step_ref
from repro_torch.models.layers import (causal_conv1d, causal_conv1d_step,
                                       conv_packed, conv_tail, silu,
                                       softplus)
from repro_torch.models.param import DTYPES, ParamDef


def _dims(cfg: ModelConfig) -> tuple[int, int, int]:
    mc = cfg.mamba or MambaConfig()
    d_in = mc.expand * cfg.d_model
    dt_rank = mc.dt_rank or -(-cfg.d_model // 16)
    return d_in, dt_rank, mc.d_state


def mamba_defs(cfg: ModelConfig) -> dict:
    mc = cfg.mamba or MambaConfig()
    d, dt = cfg.d_model, cfg.dtype
    d_in, dt_rank, n = _dims(cfg)
    return {
        "w_in": ParamDef((d, 2 * d_in), dtype=dt),
        "conv_w": ParamDef((d_in, mc.d_conv), dtype=dt),
        "conv_b": ParamDef((d_in,), init="zeros", dtype=dt),
        "w_x": ParamDef((d_in, dt_rank + 2 * n), dtype=dt),
        "w_dt": ParamDef((dt_rank, d_in), dtype=dt),
        "dt_bias": ParamDef((d_in,), init="dt_bias", dtype="float32"),
        "a_log": ParamDef((d_in, n), init="a_log", dtype="float32"),
        "d_skip": ParamDef((d_in,), init="ones", dtype="float32"),
        "w_out": ParamDef((d_in, d), dtype=dt),
    }


def _pre(p: dict, x: torch.Tensor):
    """The input projection: x (B, S, D) -> (xs, z), each (B, S, d_in)."""
    xz = torch.matmul(x, p["w_in"])
    return xz.chunk(2, dim=-1)


def _ssm_params(cfg: ModelConfig, p: dict, xc: torch.Tensor):
    """dt = softplus(f32(dt_low @ w_dt) + dt_bias) in f32; b and c stay in
    the model's dtype; a = -exp(a_log) in f32.  The dt/B/C projection sees
    the full inner width: a psum under tensor parallelism."""
    _, dt_rank, n = _dims(cfg)
    proj = tp.psum(torch.matmul(xc, p["w_x"]))
    dt_low, b, c = proj.split([dt_rank, n, n], dim=-1)
    dt = softplus(torch.matmul(dt_low, p["w_dt"]).float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    return dt, a, b, c


def mamba_full(cfg: ModelConfig, p: dict, x: torch.Tensor,
               initial: Optional[dict] = None, return_state: bool = False,
               impl: Optional[str] = None):
    """Prefill or a chunk of it.  x: (B, S, D); ``initial`` is a carried
    state (the conv history is prepended to the chunk, the scan starts from
    its ``ssm``).  Returns out (B, S, D), and with ``return_state`` also the
    new state: the tail of (history ++ chunk), so a chunk shorter than
    d_conv - 1 keeps earlier history, and the scan's final state."""
    mc = cfg.mamba or MambaConfig()
    xs, z = _pre(p, x)
    if initial is not None:
        hist = initial["conv"]                        # (B, K-1, d_in)
        xs_ext = torch.cat([hist, xs], dim=1)
        xc = causal_conv1d(xs_ext, p["conv_w"], p["conv_b"])[:, hist.shape[1]:]
        h0 = initial["ssm"]
    else:
        xs_ext = xs
        xc = causal_conv1d(xs, p["conv_w"], p["conv_b"])
        h0 = None
    xc = silu(xc)
    dt, a, b, c = _ssm_params(cfg, p, xc)
    y, h_final = ops.ssm_scan(xc, dt, a, b, c, p["d_skip"], h0, impl=impl)
    out = torch.matmul(y * silu(z), p["w_out"])
    if return_state:
        return out, {"conv": conv_tail(xs_ext, mc.d_conv - 1),
                     "ssm": h_final}
    return out


def mamba_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict):
    """One token per row.  x: (B, 1, D); cache {conv, ssm}.  Returns (out
    (B, 1, D), new state): new tensors, the cache is left as it was, so
    the caller chooses which rows commit."""
    xs, z = _pre(p, x)
    xc, conv_state = causal_conv1d_step(xs[:, 0], cache["conv"],
                                        p["conv_w"], p["conv_b"])
    xc = silu(xc)[:, None, :]
    dt, a, b, c = _ssm_params(cfg, p, xc)
    y, h = ssm_step_ref(xc[:, 0], dt[:, 0], a, b[:, 0], c[:, 0],
                        p["d_skip"], cache["ssm"])
    out = torch.matmul(y * silu(z[:, 0]), p["w_out"])[:, None, :]
    return out, {"conv": conv_state, "ssm": h}


def mamba_packed(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
                 token_slot: torch.Tensor, token_active: torch.Tensor):
    """Token-packed step (DESIGN.md §8).  x: (1, T, D) mixed decode and
    prefill-chunk tokens; cache: the whole {conv (N, K-1, d_in), ssm (N,
    d_in, N_state)} slot-state arrays, updated in place.

    As in JAX, a loop over the T tokens gathers each token's slot state,
    advances it one step and commits it, so tokens of one segment chain
    through their slot's state exactly as the chunked path does; inactive
    (padding) tokens are masked out of the commit.  The loop runs twice:
    first over the conv history, then over the scan state.  Between the
    two, the projections that depend on no state (``w_x``, ``w_dt``) run
    once over the whole stream, where JAX computes the same values token by
    token inside its scan (at Jamba's widths that would re-read 35 MB of
    weights per token and layer).  Indices stay on the device: no sync."""
    xs, z = _pre(p, x)                                  # (1, T, d_in)
    ssm_c = cache["ssm"]
    n_tok = xs.shape[1]
    slots = token_slot.long()
    xc = silu(conv_packed(cache["conv"], xs[0], p["conv_w"], p["conv_b"],
                          slots, token_active))[None]   # (1, T, d_in)
    dt, a, b, c = _ssm_params(cfg, p, xc)
    ys = []
    for t in range(n_tok):
        s_i = slots[t:t + 1]
        h0 = ssm_c.index_select(0, s_i)                 # (1, d_in, N)
        y_t, h1 = ssm_step_ref(xc[:, t], dt[:, t], a, b[:, t], c[:, t],
                               p["d_skip"], h0)
        ssm_c.index_copy_(0, s_i, torch.where(token_active[t], h1, h0))
        ys.append(y_t[0])
    y = torch.stack(ys)[None] * silu(z)
    return tp.row_parallel(y, p["w_out"]), cache


def mamba_init_cache(cfg: ModelConfig, batch: int, device: torch.device,
                     world: int = 1) -> dict:
    """The zero state; d_in / ``world`` channels on a tensor-parallel
    rank."""
    mc = cfg.mamba or MambaConfig()
    d_in, _, n = _dims(cfg)
    d_in //= world
    return {"conv": torch.zeros((batch, mc.d_conv - 1, d_in),
                                dtype=DTYPES[cfg.dtype], device=device),
            "ssm": torch.zeros((batch, d_in, n), dtype=torch.float32,
                               device=device)}
