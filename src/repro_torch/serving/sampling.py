"""Token sampling and the device-resident sampled-token feedback of the
packed step (ports of ``repro.serving.sampling``: ``greedy``,
``packed_keys``, ``sample_tokens``, ``substitute_last`` and
``scatter_last``, the last two on the per-slot buffer and on the
speculative-decoding token ring).

Stochastic draws come from Philox4x32-10 (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC 2011) written in torch integer ops: the
bits of a draw depend only on ``(seed, rid, pos, vocab index)``, never on
the launch, the slot or the device.  Every intermediate stays below 2^63
(a 32 x 32-bit product is taken in 16-bit halves), so the CPU and the card
compute the same bits.  JAX's threefry bits are not reproduced; what the
engine relies on is: the same draw for the same ``(rid, pos)``, hence no
dependence on async depth, and a re-verified rejected position repeats its
draw (so speculation stays token-exact under sampling).
"""
from __future__ import annotations

from typing import Optional

import torch

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF
# Philox4x32 round multipliers and Weyl key increments (Random123)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_PHILOX_ROUNDS = 10


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32, first index on ties (as jnp.argmax)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# counter-based random bits
# ---------------------------------------------------------------------------
def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of ``a * m`` for int64 ``a`` in [0, 2^32)
    and a 32-bit constant ``m``, from 16-bit halves: no partial product
    reaches 2^34."""
    a_hi, a_lo = a >> 16, a & _M16
    m_hi, m_lo = m >> 16, m & _M16
    ll = a_lo * m_lo
    mid = a_lo * m_hi + a_hi * m_lo + (ll >> 16)
    lo = ((mid & _M16) << 16) | (ll & _M16)
    hi = a_hi * m_hi + (mid >> 16)
    return hi, lo


def philox4x32(counter: tuple, key: tuple) -> tuple:
    """Philox4x32-10 on int64 tensors holding 32-bit words: four counter
    words and two key words (broadcastable), four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(_PHILOX_ROUNDS):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _M32
            k1 = (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def packed_keys(seed: int, token_rid: torch.Tensor,
                token_pos: torch.Tensor) -> torch.Tensor:
    """Per-row draw identities ``(n, 4)`` int64: the Philox key (the
    engine seed's two 32-bit words) and the counter's fixed words, the
    row's position and request id.  Nothing else enters a draw: not the
    launch, not the slot, not an earlier sample."""
    rid = token_rid.to(torch.int64) & _M32
    pos = token_pos.to(torch.int64) & _M32
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    k0 = torch.full_like(rid, seed & _M32)
    k1 = torch.full_like(rid, seed >> 32)
    return torch.stack([k0, k1, pos, rid], dim=1)


def _philox_words(keys: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """The four words (n, m, 4) of Philox's counter ``(block, pos, rid, 0)``
    for each row of ``keys`` and each entry of ``block`` (n, m)."""
    col = lambda j: keys[:, j:j + 1]                       # noqa: E731
    words = philox4x32((block, col(2).expand_as(block),
                        col(3).expand_as(block), torch.zeros_like(block)),
                       (col(0), col(1)))
    return torch.stack(words, dim=-1)


def random_bits(keys: torch.Tensor, index) -> torch.Tensor:
    """32 random bits (int64 in [0, 2^32)) for each row of ``keys`` at each
    vocab index: of ``index`` ((n, m) int64), or of ``range(index)`` for an
    int.  Vocab index v is word ``v % 4`` of the counter ``(v // 4, pos,
    rid, 0)``; the int form computes each counter once."""
    n = keys.shape[0]
    if isinstance(index, int):
        nb = -(-index // 4)
        block = torch.arange(nb, dtype=torch.int64,
                             device=keys.device)[None].expand(n, nb)
        return _philox_words(keys, block).reshape(n, 4 * nb)[:, :index]
    return _philox_words(keys, index >> 2).gather(
        -1, (index & 3)[..., None])[..., 0]


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise, f32, from 32-bit words (int64 in [0, 2^32)):
    the top 23 bits give u = (b + 1/2) / 2^23 in [2^-24, 1 - 2^-24], every
    value exact in f32, so u never rounds to 0 or 1 and the noise is
    finite (with 24 bits, b + 1/2 rounds up to 2^24 at the top word and
    u = 1 gives +inf noise)."""
    u = ((bits >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))
    return -torch.log(-torch.log(u))


def gumbel(keys: torch.Tensor, index) -> torch.Tensor:
    """Standard Gumbel noise, f32, at the vocab indices ``index`` (as in
    ``random_bits``)."""
    return gumbel_from_bits(random_bits(keys, index))


def sample_tokens(logits: torch.Tensor, keys: Optional[torch.Tensor],
                  temp: float = 0.0,
                  topk: Optional[int] = None) -> torch.Tensor:
    """Next tokens of the sampled rows: greedy when ``temp <= 0``, else
    the Gumbel-max draw from softmax(logits / temp), restricted to the
    ``topk`` largest logits when given.  A token's noise is keyed by its
    vocab index, so top-k and the full draw share their bits.

    logits: (n, V); keys: (n, 4) from ``packed_keys`` -> (n,) int32."""
    if temp <= 0:
        return greedy(logits)
    if keys is None:
        raise ValueError("stochastic sampling needs packed_keys")
    lg = logits.to(torch.float32) / max(temp, 1e-6)
    if topk is not None:
        vals, idx = torch.topk(lg, topk, dim=-1)
        choice = torch.argmax(vals + gumbel(keys, idx), dim=-1, keepdim=True)
        return idx.gather(-1, choice)[:, 0].to(torch.int32)
    return torch.argmax(lg + gumbel(keys, lg.shape[-1]),
                        dim=-1).to(torch.int32)


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
