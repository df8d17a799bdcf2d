"""Decode attention for the legacy step's batched decode: the CUDA kernel's
wrapper and its plain PyTorch version.

Row b's one query attends rows ``[0, cache_len[b])`` of its own cache row.
The kernel is the ``decode_attention`` build of
``csrc/packed_attention.cu`` (``-DREPRO_PA_DECODE=1``: token b is slot b
and its length is ``cache_len[b]``); it replaces the TPU kernel
``src/repro/kernels/decode_attention.py:decode_attention``.
``decode_attention_ref`` ports ``src/repro/kernels/ref.py:
decode_attention_ref`` and is what the CPU runs and what the card's kernel
is held against.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import packed_attention as pa


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         cache_len: torch.Tensor) -> torch.Tensor:
    """Plain version.  q: (B, H, D); k_cache/v_cache: (B, S, KV, D/Dv);
    cache_len: (B,) int — the new token's K/V are already written, so rows
    [0, cache_len) are attended (a length past S attends all S rows).
    Returns (B, H, Dv) in q's dtype; scores are scaled by ``D ** -0.5`` and
    taken in f32."""
    b, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    dv = v_cache.shape[-1]
    qg = q.reshape(b, kv, h // kv, d).float()
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * d ** -0.5
    valid = torch.arange(s, device=q.device)[None, :] < cache_len[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], pa.NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhv->bhgv", probs, v_cache.float())
    return out.reshape(b, h, dv).to(q.dtype)


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor,
                          cache_len: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (same contract as ``decode_attention_ref``,
    with ``cache_len >= 1``: a row with no valid key gives zeros).  The
    caches are read in place through their (row, position) strides, rows
    past ``cache_len`` are never read.  Raises on any input the kernel does
    not take and on a failed launch; counts launches in
    ``decode_attention_cuda.launches``."""
    out = pa.launch("decode_attention", q, k_cache, v_cache, None, cache_len)
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
