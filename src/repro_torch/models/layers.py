"""Shared layer primitives: RMSNorm, SiLU, GELU, softplus, RoPE and the
causal depthwise convolution of the Mamba and xLSTM mixers (ports of
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


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation, which ``jax.nn.gelu`` computes by default
    (the ungated FFN).  Torch evaluates it in f32 and rounds to x's dtype;
    JAX evaluates it in x's dtype, so bf16 results may differ by an
    ulp."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))``, as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


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


def apply_rope_nohead(x: torch.Tensor, positions: torch.Tensor,
                      theta: float) -> torch.Tensor:
    """x: (B, S, D) — no head axis (MLA's decoupled key).  positions: (S,)
    or (B, S)."""
    if x.dim() != 3:
        raise ValueError(f"apply_rope_nohead wants (B, S, D), got "
                         f"{tuple(x.shape)}")
    ang = positions.float()[..., None] * rope_freqs(x.shape[-1], theta,
                                                    x.device)
    if ang.dim() == 2:                      # positions were (S,)
        ang = ang[None]
    return _rope_rotate(x, ang)


# ---------------------------------------------------------------------------
# causal depthwise conv (mamba) — streaming decode and chunk carries
# ---------------------------------------------------------------------------
def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor | None) -> torch.Tensor:
    """x: (B, S, C); w: (C, K) depthwise taps; left-pads with zeros.  The
    JAX formula, K shifted multiply-adds accumulated in x's dtype — not
    ``F.conv1d``, which on the card runs through cuDNN (TF32 in f32) and
    sums in another order."""
    k = w.shape[-1]
    s = x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + s, :] * w[:, i]
    if b is not None:
        out = out + b
    return out


def causal_conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor,
                       w: torch.Tensor, b: torch.Tensor | None):
    """One decode step.  x_t: (B, C); conv_state: (B, K-1, C) past inputs.
    Returns (out (B, C), new state (B, K-1, C))."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)      # (B,K,C)
    out = torch.einsum("bkc,ck->bc", window, w)
    if b is not None:
        out = out + b
    return out, window[:, 1:, :]


def conv_tail(xs: torch.Tensor, kk: int) -> torch.Tensor:
    """Conv history carry for chunked prefill: the last ``kk`` rows of (B,
    S, C), left-zero-padded when S < kk.  Callers pass (prev history ++
    chunk) so chunks shorter than the kernel keep earlier history."""
    s = xs.shape[1]
    if s >= kk:
        return xs[:, s - kk:, :]
    return torch.nn.functional.pad(xs, (0, 0, kk - s, 0))


def conv_packed(conv_c: torch.Tensor, xs: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor, slots: torch.Tensor,
                token_active: torch.Tensor) -> torch.Tensor:
    """The packed step's conv (Mamba, xLSTM): token by token, the token's
    slot history is gathered from ``conv_c`` (N, K-1, C), stepped and
    committed in place (active tokens only; a padding token writes its old
    history back), so a segment's tokens chain through their slot's
    history.  xs: (T, C); slots: (T,) int64 on the device.  Returns the
    conv outputs (T, C)."""
    out = []
    for t in range(xs.shape[0]):
        s_i = slots[t:t + 1]
        hist = conv_c.index_select(0, s_i)
        y_t, new_hist = causal_conv1d_step(xs[t][None], hist, w, b)
        conv_c.index_copy_(0, s_i, torch.where(token_active[t], new_hist,
                                               hist))
        out.append(y_t[0])
    return torch.stack(out)
