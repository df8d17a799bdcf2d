"""Decode attention, over slot caches and through a page table: the CUDA
kernels' wrappers and their plain PyTorch versions.

Row b's one query attends rows ``[0, cache_len[b])`` of its own cache row.
The kernel (``csrc/decode_attention.cu``, on the unit of
``csrc/attn_decode.cuh`` that the fused op's attention role shares) runs
one CTA per (row, KV head, chunk of ``CHUNK`` rows) and merges a row's
chunks in chunk order; it replaces the TPU kernel
``src/repro/kernels/decode_attention.py:decode_attention``.
``decode_attention_ref`` ports ``src/repro/kernels/ref.py:
decode_attention_ref`` and is what the CPU runs and what the card's kernel
is held against.

Paged decode reads the caches as a global pool of pages through a
``(B, MAXP)`` page table.  Its kernel is the same unit in its paged form,
the second C entry of ``csrc/decode_attention.cu``
(``repro_paged_decode_attention``): each stage's rows are looked up in the
table one stage ahead.  It replaces ``src/repro/kernels/decode_attention.py:
paged_decode_attention``, and ``paged_decode_attention_ref`` ports
``src/repro/kernels/ref.py:paged_decode_attention_ref``.  In the port it is
called only through ``kernels.ops.paged_decode_attention``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import packed_attention as pa

# cache rows per unit of csrc/decode_attention.cu, the fastest of 64-1024
# at the legacy step's 8 slots x 8 KV heads, where its ~150 live units fill
# the 132 SMs (PERF.md §6)
CHUNK = 128
# the split-KV ticket counters, per (device, stream), shared with packed
# attention's tile kernel; each launch leaves them 0
_TICKETS = pa._TICKETS
split_kv_tickets = pa.split_kv_tickets


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


def check_caches(check, q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor) -> None:
    """What the unit's cp.async ring needs of q and the caches: each cache
    row a contiguous (KV, D) block, and every row 16-byte aligned."""
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        check(x.stride(3) == 1 and x.stride(2) == x.shape[3],
              f"{name} rows must hold contiguous (KV, D) blocks")
        check(all(x.stride(i) * x.element_size() % 16 == 0 for i in (0, 1)),
              f"{name} strides must keep rows 16-byte aligned")
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        check(x.data_ptr() % 16 == 0, f"{name} is not 16-byte aligned")


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"decode_attention kernel: {what}")


def launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           cache_len: torch.Tensor, *,
           page_table: Optional[torch.Tensor] = None,
           scale: Optional[float] = None, chunk: int = CHUNK) -> torch.Tensor:
    """Check the operands and launch ``csrc/decode_attention.cu`` with
    units of ``chunk`` cache rows (a positive multiple of 64).  With
    ``page_table`` ((B, MAXP) int32) the caches are (NP, PS, KV, D) page
    pools read through it (the paged C entry).  ``scale`` multiplies the
    scores (default ``D ** -0.5``).  Leaves (units launched, chunk) in
    ``launch.units``."""
    dev = q.device
    _check(dev.type == "cuda", "q is not a CUDA tensor")
    paged = page_table is not None
    named = [("k_cache", k_cache), ("v_cache", v_cache),
             ("cache_len", cache_len)]
    for name, x in named + ([("page_table", page_table)] if paged else []):
        _check(x.device == dev, f"{name} is on {x.device}, q on {dev}")
    _check(q.dtype in pa._DTYPES, f"dtype {q.dtype} (float32 or bfloat16)")
    _check(k_cache.dtype == q.dtype and v_cache.dtype == q.dtype,
           f"k_cache and v_cache must be {q.dtype} for q {q.dtype}")
    _check(q.dim() == 3 and k_cache.dim() == 4 and v_cache.dim() == 4,
           "q (B, H, D), caches (B, S, KV, D)")
    b, h, d = q.shape
    n, s, kvh, dk = k_cache.shape
    _check(v_cache.shape[-1] == d, f"d_v != d_qk ({v_cache.shape[-1]} vs "
           f"{d}): absorbed MLA's latent attention is ops.mla_attention")
    _check(tuple(v_cache.shape) == (n, s, kvh, d) and dk == d,
           f"shapes q {tuple(q.shape)} k {tuple(k_cache.shape)} "
           f"v {tuple(v_cache.shape)}")
    pa.check_heads(_check, h, kvh, d)
    _check(paged or b == n, f"decode: {b} queries for {n} slots")
    _check(cache_len.dtype == torch.int32 and tuple(cache_len.shape) == (b,)
           and cache_len.is_contiguous(),
           "cache_len must be contiguous int32 (B,)")
    _check(q.is_contiguous(), "q must be contiguous")
    check_caches(_check, q, k_cache, v_cache)
    _check(chunk > 0 and chunk % 64 == 0,
           f"chunk {chunk} is not a positive multiple of 64")
    if paged:
        _check(page_table.dtype == torch.int32 and page_table.dim() == 2
               and page_table.shape[0] == b and page_table.shape[1] >= 1
               and page_table.is_contiguous(),
               f"page_table must be contiguous int32 ({b}, MAXP)")
        for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
            _check(x.stride(0) == s * x.stride(1),
                   f"{name}: a page pool needs a uniform flat row space "
                   "(stride(0) == PS * stride(1))")
        _check(n * s < 2 ** 31 and page_table.shape[1] * s < 2 ** 31,
               "page pools and tables past 2**31 rows")
    sweep = page_table.shape[1] * s if paged else s   # rows a unit may reach
    n_chunks = max(1, -(-sweep // chunk))
    group = h // kvh
    out = torch.empty((b, h, d), dtype=q.dtype, device=dev)
    part_ml = torch.empty(b * kvh * n_chunks * 2 * group,
                          dtype=torch.float32, device=dev)
    part_acc = torch.empty(b * kvh * n_chunks * group * d,
                           dtype=torch.float32, device=dev)
    sched = (ctypes.c_int * 2)()
    scale = float(d ** -0.5 if scale is None else scale)
    target = "paged_decode_attention" if paged else "decode_attention"
    fn = build.build().fn(target)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets = split_kv_tickets(dev, stream, b * kvh)
        common = (out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
                  tickets.data_ptr(), pa._DTYPES[q.dtype], b, h, kvh, d)
        if paged:
            rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    page_table.data_ptr(), cache_len.data_ptr(), *common,
                    page_table.shape[1], s, chunk, k_cache.stride(1),
                    v_cache.stride(1), scale, sched, stream)
        else:
            rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    cache_len.data_ptr(), *common, s, chunk,
                    k_cache.stride(0), k_cache.stride(1), v_cache.stride(0),
                    v_cache.stride(1), scale, sched, stream)
    if rc != 0:
        raise RuntimeError(f"{target} kernel launch failed: {rc}")
    launch.units = tuple(sched)
    return out


launch.units = None


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                          logit_scale: Optional[float] = None
                          ) -> torch.Tensor:
    """Launch the CUDA kernel (same contract as ``decode_attention_ref``,
    with ``d_v == d_qk`` and ``cache_len >= 1``: a row with no valid key
    gives zeros).  The caches are read in place through their (row,
    position) strides, rows past ``cache_len`` are never read, and
    ``cache_len`` is never read on the host.  Raises on any input the
    kernel does not take and on a failed launch; counts launches in
    ``decode_attention_cuda.launches``."""
    out = launch(q, k_cache, v_cache, cache_len, scale=logit_scale)
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
    never read, and neither ``cache_len`` nor the table is read on the
    host.  Raises on any input the kernel does not take and on a failed
    launch; counts launches in ``paged_decode_attention_cuda.launches``."""
    out = launch(q, k_pages, v_pages, cache_len, page_table=page_table,
                 scale=logit_scale)
    paged_decode_attention_cuda.launches += 1
    return out


paged_decode_attention_cuda.launches = 0
