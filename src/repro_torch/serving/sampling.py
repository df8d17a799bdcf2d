"""Token sampling and the device-resident sampled-token feedback of the
packed step (ports of ``repro.serving.sampling``: ``greedy``,
``packed_keys``, ``sample_tokens``, ``substitute_last`` and
``scatter_last``, the last two on the per-slot buffer and on the
speculative-decoding token ring).

Stochastic draws are JAX's: threefry2x32 (Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3", SC 2011; JAX's default generator)
in torch integer ops, keyed as ``repro.serving.sampling.packed_keys``
keys them, ``fold_in(PRNGKey(seed), rid * stride + pos)``, and drawn in
JAX's layout (``jax_threefry_partitionable``: word i of a draw of any
shape hashes the counter (0, i) and xors the two halves), mapped to
Gumbel noise as ``jax.random.gumbel`` maps it.  The bits equal JAX's
exactly; the noise within an f32 ulp of its logarithms, so the drawn
tokens are JAX's.  Every intermediate stays below 2^34, so the CPU and
the card compute the same bits.  A draw depends only on ``(seed, rid,
pos)`` and the index in its shape, never on the launch, the slot or an
earlier sample: the same draw at any async depth, and a re-verified
rejected position repeats its draw (speculation stays token-exact under
sampling).
"""
from __future__ import annotations

from typing import Optional

import torch

_M32 = 0xFFFFFFFF
# threefry2x32's rotations, alternating by group of four rounds, and the
# key schedule's parity constant (Random123, as JAX's ``threefry_2x32``)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits: (B, V) or (B, K, V) -> (B,) / (B, K) int32, first index on
    ties (as jnp.argmax)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# counter-based random bits
# ---------------------------------------------------------------------------
def threefry2x32(key: tuple, count: tuple) -> tuple:
    """threefry2x32 with 20 rounds on int64 tensors holding 32-bit words:
    two key words and two counter words (broadcastable), two output
    words."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (count[0] + k0) & _M32
    x1 = (count[1] + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def packed_keys(seed: int, token_rid: torch.Tensor, token_pos: torch.Tensor,
                stride: int) -> torch.Tensor:
    """Per-row keys ``(n, 2)`` int64 (two 32-bit words): the engine key
    ``PRNGKey(seed)`` folded with ``rid * stride + pos`` taken mod 2^32, as
    JAX's ``jax.random.fold_in`` folds it.  ``stride`` must exceed the
    largest position (the engine passes ``max_len + 1``), so (rid, pos)
    pairs never collide."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    data = (token_rid.to(torch.int64) * stride
            + token_pos.to(torch.int64)) & _M32
    k0, k1 = threefry2x32((seed >> 32, seed & _M32),
                          (torch.zeros_like(data), data))
    return torch.stack([k0, k1], dim=1)


def random_bits(keys: torch.Tensor, index) -> torch.Tensor:
    """32 random bits (int64 in [0, 2^32)) for each row of ``keys`` at each
    flat index of a draw: of ``index`` ((n, m) int64), or of
    ``range(index)`` for an int.  Word i of a row is JAX's word i of any
    draw from its key (``jax.random.bits(key, shape)`` flattened)."""
    if isinstance(index, int):
        index = torch.arange(index, dtype=torch.int64,
                             device=keys.device)[None]
    a, b = threefry2x32((keys[:, 0:1], keys[:, 1:2]),
                        (torch.zeros_like(index), index))
    return a ^ b


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise, f32, from 32-bit words (int64 in [0, 2^32)),
    as ``jax.random.gumbel`` makes it: the top 23 bits give u = b / 2^23,
    raised to the smallest normal f32 where b = 0, so u lies in [tiny, 1 -
    2^-23] and the noise in [-4.47, 15.94], finite."""
    u = (bits >> 9).to(torch.float32) * (1.0 / (1 << 23))
    u = torch.clamp(u, min=_TINY)
    return -torch.log(-torch.log(u))


def gumbel(keys: torch.Tensor, index) -> torch.Tensor:
    """Standard Gumbel noise, f32, at the flat indices ``index`` (as in
    ``random_bits``)."""
    return gumbel_from_bits(random_bits(keys, index))


def sample_tokens(logits: torch.Tensor, keys: Optional[torch.Tensor],
                  temp: float = 0.0,
                  topk: Optional[int] = None) -> torch.Tensor:
    """Next tokens of the sampled rows: greedy when ``temp <= 0``, else
    the Gumbel-max draw from softmax(logits / temp), restricted to the
    ``topk`` largest logits when given, as JAX's ``sample_tokens`` draws
    it: each row's noise has the shape of what it perturbs, (V,) or (K, V)
    over the vocab, (topk,) or (K, topk) over the top-k values in
    descending order, so a codebook's draw is its own slice of the row's.

    logits: (n, V) or (n, K, V); keys: (n, 2) from ``packed_keys`` -> (n,)
    or (n, K) int32."""
    if temp <= 0:
        return greedy(logits)
    if keys is None:
        raise ValueError("stochastic sampling needs packed_keys")
    lg = logits.to(torch.float32) / max(temp, 1e-6)
    if topk is not None:
        vals, idx = torch.topk(lg, topk, dim=-1)
        noise = gumbel(keys, vals[0].numel()).reshape(vals.shape)
        choice = torch.argmax(vals + noise, dim=-1, keepdim=True)
        return idx.gather(-1, choice)[..., 0].to(torch.int32)
    noise = gumbel(keys, lg[0].numel()).reshape(lg.shape)
    return torch.argmax(lg + noise, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# device-resident sampled-token feedback (DESIGN.md §10, §13)
# ---------------------------------------------------------------------------
def substitute_last(tokens: torch.Tensor, last_token: torch.Tensor,
                    token_slot: torch.Tensor, from_last: torch.Tensor,
                    accept_len: Optional[torch.Tensor] = None) \
        -> torch.Tensor:
    """Replace the packed stream's decode placeholders with the on-device
    feedback, so the host never needs the previous iteration's samples to
    build the next stream.  tokens: (1, T); token_slot: (T,); from_last:
    (T,) bool.  ``last_token`` is the per-slot buffer (n_slots,) or the
    token ring (n_slots, W) of the slot's last verify segment, of which
    the first ``accept_len[slot]`` were accepted: the fed token is the
    newest accepted, ``ring[slot, accept_len - 1]`` (column 0 without
    ``accept_len``)."""
    slot = token_slot.long()
    if last_token.dim() == 1:
        fed = last_token[slot]
    else:
        if accept_len is None:
            col = torch.zeros_like(slot)
        else:
            col = (accept_len.long()[slot] - 1).clamp(0,
                                                      last_token.shape[1] - 1)
        fed = last_token[slot, col]
    return torch.where(from_last, fed.to(tokens.dtype), tokens[0])[None]


def scatter_last(last_token: torch.Tensor, sample_slot: torch.Tensor,
                 sampled: torch.Tensor) -> torch.Tensor:
    """Scatter this iteration's samples into the feedback buffer at the
    stream's sample points, into column 0 of a ring (verify segments write
    whole rows through the acceptance path instead).  ``sample_slot`` is
    the token's slot at sample points and out of bounds (``n_slots``)
    elsewhere; those writes land in a spare row that is cut off, so the
    scatter needs no mask and no host sync.  Returns a new tensor."""
    n = last_token.shape[0]
    idx = sample_slot.long()
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    buf = torch.cat([last_token, last_token.new_zeros((1,)
                                                      + last_token.shape[1:])])
    if buf.dim() == 1:
        buf.index_copy_(0, idx, sampled.to(buf.dtype))
    else:
        buf[:, 0].index_copy_(0, idx, sampled.to(buf.dtype))
    return buf[:n]
