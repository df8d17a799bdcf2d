"""Kernel entry points, chosen by the device of their tensors.

A CUDA tensor always goes to the hand-written kernel (which raises on what
it does not take); a CPU tensor goes to the kernel's plain PyTorch version.
There is no environment override and no fallback.  ``impl="plain"`` asks
for the plain version on any device; it exists for one caller, the
whole-forward comparison in ``chip_smoke.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import (
    decode_attention_cuda, decode_attention_ref, paged_decode_attention_cuda,
    paged_decode_attention_ref)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_ref)
from repro_torch.kernels.fused_overlap import (fused_overlap_cuda,
                                               fused_overlap_ref)
from repro_torch.kernels.mla_attention import (mla_attention_cuda,
                                               mla_attention_ref)
from repro_torch.kernels.packed_attention import (packed_attention_cuda,
                                                  packed_attention_ref)
from repro_torch.kernels.ssm_scan import ssm_scan_cuda, ssm_scan_ref
from repro_torch.kernels.swiglu import swiglu_cuda, swiglu_ref

IMPLS = (None, "plain")


def _use_kernel(x: torch.Tensor, impl: Optional[str]) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if impl == "plain" or x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"no kernel for device {x.device}")


def packed_attention(q, k_cache, v_cache, token_slot, lengths, *,
                     kv_bucket: Optional[int] = None,
                     block_tables: Optional[torch.Tensor] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     logit_scale: Optional[float] = None,
                     impl: Optional[str] = None) -> torch.Tensor:
    """Segment-masked attention over a token-packed stream (DESIGN.md §8):
    token t attends rows [0, lengths[t]) of slot ``token_slot[t]``'s cache;
    ``kv_bucket`` bounds the swept rows (DESIGN.md §9).  ``block_tables``
    reads the caches as physical blocks through per-slot tables (§12);
    ``k_scale``/``v_scale`` mark int8 caches with per-row scales (§15).
    Scores are scaled by ``logit_scale`` (default D ** -0.5).  The kernel
    takes ``d_v == d_qk`` only: absorbed MLA is ``mla_attention``."""
    fn = packed_attention_cuda if _use_kernel(q, impl) else packed_attention_ref
    return fn(q, k_cache, v_cache, token_slot, lengths, kv_bucket=kv_bucket,
              block_tables=block_tables, k_scale=k_scale, v_scale=v_scale,
              logit_scale=logit_scale)


def mla_attention(q, c_kv, k_rope, token_slot, lengths, *,
                  logit_scale: float, kv_bucket: Optional[int] = None,
                  impl: Optional[str] = None) -> torch.Tensor:
    """Absorbed MLA's latent attention over a token stream: token t's H
    query heads (rank + rope columns) attend rows [0, lengths[t]) of slot
    ``token_slot[t]``, key row ``[c_kv | k_rope]``, value row ``c_kv``,
    one KV head for all H; ``c_kv`` (N, S, rank) and ``k_rope`` (N, S,
    rope) are the cache leaves, read in place; ``kv_bucket`` bounds the
    swept rows.  Returns (T, H, rank)."""
    fn = mla_attention_cuda if _use_kernel(q, impl) else mla_attention_ref
    return fn(q, c_kv, k_rope, token_slot, lengths, logit_scale=logit_scale,
              kv_bucket=kv_bucket)


def swiglu(x, w_gate, w_up, *, impl: Optional[str] = None) -> torch.Tensor:
    """``silu(x @ w_gate) * (x @ w_up)``; x (M, K), weights (K, N)."""
    fn = swiglu_cuda if _use_kernel(x, impl) else swiglu_ref
    return fn(x, w_gate, w_up)


def flash_attention(q, k, v, *, q_offset=0,
                    logit_scale: Optional[float] = None,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Causal GQA attention: query i of batch row b sees keys
    [0, q_offset[b] + i]; q (B, Sq, H, D), k/v (B, Skv, KV, D);
    ``q_offset`` an int or a (B,) int32 tensor; scores scaled by
    ``logit_scale`` (default D ** -0.5)."""
    fn = flash_attention_cuda if _use_kernel(q, impl) else flash_attention_ref
    return fn(q, k, v, q_offset=q_offset, logit_scale=logit_scale)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     logit_scale: Optional[float] = None,
                     impl: Optional[str] = None) -> torch.Tensor:
    """One query per row over its length-masked cache row: q (B, H, D),
    caches (B, S, KV, D), rows [0, cache_len[b]) attended; scores scaled
    by ``logit_scale`` (default D ** -0.5)."""
    fn = decode_attention_cuda if _use_kernel(q, impl) \
        else decode_attention_ref
    return fn(q, k_cache, v_cache, cache_len, logit_scale=logit_scale)


def paged_decode_attention(q, k_pages, v_pages, page_table, cache_len, *,
                           logit_scale: Optional[float] = None,
                           impl: Optional[str] = None) -> torch.Tensor:
    """Decode through a page table: q (B, H, D), page pools (NP, PS, KV,
    D), ``page_table`` (B, MAXP) int32 page ids (-1 unused), rows
    [0, cache_len[b]) of row b's pages attended; scores scaled by
    ``logit_scale`` (default D ** -0.5)."""
    fn = paged_decode_attention_cuda if _use_kernel(q, impl) \
        else paged_decode_attention_ref
    return fn(q, k_pages, v_pages, page_table, cache_len,
              logit_scale=logit_scale)


def fused_overlap(x, w, q, k_cache, v_cache, cache_len, *,
                  gemm_fraction: float = 0.5, impl: Optional[str] = None):
    """NanoFlow's signature op: ``x @ w`` co-scheduled with decode
    attention of q (B, H, D) over caches (B, S, KV, D).  ``gemm_fraction``
    is the share of the kernel's CTAs that take GEMM tiles (the paper's
    SM-partition ratio); the plain version computes the pair one after the
    other.  Returns (gemm_out, attn_out)."""
    if _use_kernel(x, impl):
        return fused_overlap_cuda(x, w, q, k_cache, v_cache, cache_len,
                                  gemm_fraction=gemm_fraction)
    return fused_overlap_ref(x, w, q, k_cache, v_cache, cache_len)


def ssm_scan(x, dt, a, b, c, d, h0=None, *, impl: Optional[str] = None):
    """Mamba-1 selective scan: x, dt (B, S, C); a (C, N); b, c (B, S, N);
    d (C,); h0 (B, C, N) f32 or None.  Returns (y (B, S, C) in x's dtype,
    h_final (B, C, N) f32)."""
    fn = ssm_scan_cuda if _use_kernel(x, impl) else ssm_scan_ref
    return fn(x, dt, a, b, c, d, h0)
