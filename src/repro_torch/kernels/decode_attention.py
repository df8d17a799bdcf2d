"""Decode attention, over slot caches and through a page table: the CUDA
kernels' wrappers and their plain PyTorch versions.

Row b's one query attends rows ``[0, cache_len[b])`` of its own cache row.
The kernel is the ``decode_attention`` build of
``csrc/packed_attention.cu`` (``-DREPRO_PA_DECODE=1``: token b is slot b
and its length is ``cache_len[b]``); it replaces the TPU kernel
``src/repro/kernels/decode_attention.py:decode_attention``.
``decode_attention_ref`` ports ``src/repro/kernels/ref.py:
decode_attention_ref`` and is what the CPU runs and what the card's kernel
is held against.

Paged decode reads the caches as a global pool of pages through a
``(B, MAXP)`` page table.  Its kernel is the ``paged_decode_attention``
build of the same source (``-DREPRO_PA_DECODE=1 -DREPRO_PA_BLOCK_TABLE=1``);
it replaces ``src/repro/kernels/decode_attention.py:
paged_decode_attention``, and ``paged_decode_attention_ref`` ports
``src/repro/kernels/ref.py:paged_decode_attention_ref``.  In the port it is
called only through ``kernels.ops.paged_decode_attention``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import packed_attention as pa


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                         logit_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version.  q: (B, H, D); k_cache/v_cache: (B, S, KV, D/Dv);
    cache_len: (B,) int — the new token's K/V are already written, so rows
    [0, cache_len) are attended (a length past S attends all S rows).
    Returns (B, H, Dv) in q's dtype; scores are scaled by ``logit_scale``
    (default ``D ** -0.5``) and taken in f32."""
    b, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    dv = v_cache.shape[-1]
    qg = q.reshape(b, kv, h // kv, d).float()
    scale = d ** -0.5 if logit_scale is None else logit_scale
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * scale
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


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, page_table: torch.Tensor,
                               cache_len: torch.Tensor, *,
                               logit_scale: Optional[float] = None
                               ) -> torch.Tensor:
    """Plain version.  q: (B, H, D); k_pages/v_pages: (NP, PS, KV, D) page
    pools; page_table: (B, MAXP) int page ids, -1 unused; cache_len: (B,).
    Gathers each row's MAXP pages through ``clamp(page_table, min=0)`` (a
    -1 inside the length reads page 0, as the JAX reference does) and
    attends rows [0, cache_len) of the gathered MAXP * PS rows."""
    b = q.shape[0]
    _, ps, kv, d = k_pages.shape
    maxp = page_table.shape[1]
    safe = page_table.long().clamp(min=0)
    k = k_pages[safe].reshape(b, maxp * ps, kv, d)
    v = v_pages[safe].reshape(b, maxp * ps, kv, v_pages.shape[-1])
    return decode_attention_ref(q, k, v, cache_len, logit_scale=logit_scale)


def paged_decode_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                page_table: torch.Tensor,
                                cache_len: torch.Tensor, *,
                                logit_scale: Optional[float] = None
                                ) -> torch.Tensor:
    """Launch the CUDA kernel (same contract as
    ``paged_decode_attention_ref``, with ``1 <= cache_len[b] <= MAXP * PS``
    and page ids in ``[-1, NP)``; a row with no valid key gives zeros).  The
    pools are read in place through their (page, row) strides and need a
    uniform flat row space; pages past ``ceil(cache_len[b] / PS)`` are
    never read.  Raises on any input the kernel does not take and on a
    failed launch; counts launches in
    ``paged_decode_attention_cuda.launches``."""
    out = pa.launch("paged_decode_attention", q, k_pages, v_pages, None,
                    cache_len, block_tables=page_table, scale=logit_scale)
    paged_decode_attention_cuda.launches += 1
    return out


paged_decode_attention_cuda.launches = 0
