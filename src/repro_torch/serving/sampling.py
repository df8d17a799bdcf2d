"""Greedy sampling and the device-resident sampled-token feedback of the
packed step (ports of ``repro.serving.sampling.greedy``,
``substitute_last`` and ``scatter_last`` for the per-slot buffer)."""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32, first index on ties (as jnp.argmax)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def substitute_last(tokens: torch.Tensor, last_token: torch.Tensor,
                    token_slot: torch.Tensor,
                    from_last: torch.Tensor) -> torch.Tensor:
    """Replace the packed stream's decode placeholders with the on-device
    per-slot ``last_token`` buffer, so the host never needs the previous
    iteration's samples to build the next stream.  tokens: (1, T);
    last_token: (n_slots,); token_slot: (T,); from_last: (T,) bool."""
    fed = last_token[token_slot.long()].to(tokens.dtype)
    return torch.where(from_last, fed, tokens[0])[None]


def scatter_last(last_token: torch.Tensor, sample_slot: torch.Tensor,
                 sampled: torch.Tensor) -> torch.Tensor:
    """Scatter this iteration's samples into the feedback buffer at the
    stream's sample points.  ``sample_slot`` is the token's slot at sample
    points and out of bounds (``n_slots``) elsewhere; those writes are
    dropped — they land in a spare entry that is cut off, so the scatter
    needs no mask and no host sync."""
    n = last_token.shape[0]
    idx = sample_slot.long()
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    buf = torch.cat([last_token, last_token.new_zeros(1)])
    buf.index_copy_(0, idx, sampled.to(buf.dtype))
    return buf[:n]
