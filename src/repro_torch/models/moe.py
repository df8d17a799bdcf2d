"""Dense SwiGLU FFN (port of ``repro.models.moe.dense_ffn``, tp=1).  The
MoE FFN comes with its slice (ROADMAP A5)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.param import ParamDef


def ffn_defs(d: int, d_ff: int, dt: str) -> dict:
    return {
        "w_up": ParamDef((d, d_ff), dtype=dt),
        "w_down": ParamDef((d_ff, d), dtype=dt),
        "w_gate": ParamDef((d, d_ff), dtype=dt),
    }


def dense_ffn(p: dict, x: torch.Tensor,
              impl: Optional[str] = None) -> torch.Tensor:
    """``(silu(x @ w_gate) * (x @ w_up)) @ w_down``; x: (..., D).  The gate
    and up products and the SiLU·mul go through the SwiGLU kernel."""
    lead = x.shape[:-1]
    h = ops.swiglu(x.reshape(-1, x.shape[-1]), p["w_gate"], p["w_up"],
                   impl=impl)
    return torch.matmul(h, p["w_down"]).reshape(*lead, -1)
