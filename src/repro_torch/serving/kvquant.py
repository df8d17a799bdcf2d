"""int8 KV-cache quantization (port of ``repro.serving.kvquant``,
DESIGN.md §15).

Symmetric int8 per (token, KV head) row: one f32 scale per ``(..., D)`` row.
The packed step quantizes K/V at scatter time (``models/attention.py``); the
packed-attention kernel dequantizes in registers after the int8 load.  The
ops are the JAX ones in the same order, in f32 — ``max|x| / 127 + 1e-12``,
divide, round half to even (``torch.round`` as ``jnp.round``), clip to
±127 — so the int8 codes match the JAX package bit for bit.
"""
from __future__ import annotations

import torch


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (..., D) -> (int8 values (..., D), f32 scales (...,))."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1) / 127.0 + 1e-12
    q = torch.round(x32 / scale[..., None]).clamp_(-127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)
