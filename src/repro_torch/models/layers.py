"""Shared layer primitives: RMSNorm, SiLU, RoPE (ports of
``repro.models.layers``)."""
from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """Normalise in f32, cast back to x's dtype, *then* scale by the weight
    in the working dtype — the JAX order, which matters in bf16."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rope_rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate *interleaved* pairs (x[..., 0::2], x[..., 1::2]) — the JAX
    layout, not the half-split one."""
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D) — explicit head axis.  positions: (S,) or (B, S)."""
    if x.dim() != 4:
        raise ValueError(f"apply_rope wants (B, S, H, D), got {tuple(x.shape)}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions.float()[..., None] * freqs
    ang = ang[..., None, :]                 # broadcast over heads
    if ang.dim() == 3:                      # positions were (S,)
        ang = ang[None]
    return _rope_rotate(x, ang)
