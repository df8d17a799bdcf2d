"""Kernel entry points, chosen by the device of their tensors.

A CUDA tensor always goes to the hand-written kernel (which raises on what
it does not take); a CPU tensor goes to the kernel's plain PyTorch version.
There is no environment override and no fallback.  ``impl="plain"`` asks
for the plain version on any device (autograd then differentiates its
PyTorch ops); it exists for the whole-forward and train-step comparisons
in ``chip_smoke.py``.

Training: where grad mode is on and an input requires grad, SwiGLU and
flash attention go through their ``torch.autograd.Function`` (the kernels
and their backward kernels on the card, the plain forward and backward on
the CPU).  The other kernels have no backward yet: on the card they raise
a RuntimeError under grad instead of dropping the gradient (``_guard``);
their plain versions on the CPU stay differentiable.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import (
    decode_attention_cuda, decode_attention_ref, paged_decode_attention_cuda,
    paged_decode_attention_ref)
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention_bwd_cuda,
                                                 flash_attention_cuda,
                                                 flash_attention_ref)
from repro_torch.kernels.fused_overlap import (fused_overlap_cuda,
                                               fused_overlap_ref)
from repro_torch.kernels.mla_attention import (mla_attention_cuda,
                                               mla_attention_ref)
from repro_torch.kernels.packed_attention import (packed_attention_cuda,
                                                  packed_attention_ref)
from repro_torch.kernels.ssm_scan import ssm_scan_cuda, ssm_scan_ref
from repro_torch.kernels.swiglu import (SwiGLUFn, swiglu_bwd_cuda,
                                        swiglu_cuda, swiglu_ref)

IMPLS = (None, "plain")

# each kernel's wrapper counts its launches, where it launches and nowhere
# else: the packed-attention wrapper per variant (a dict), the others as an
# int attribute
_COUNTED = {"swiglu": swiglu_cuda, "flash_attention": flash_attention_cuda,
            "decode_attention": decode_attention_cuda,
            "ssm_scan": ssm_scan_cuda,
            "paged_decode_attention": paged_decode_attention_cuda,
            "fused_overlap": fused_overlap_cuda,
            "mla_attention": mla_attention_cuda,
            "flash_attention_bwd": flash_attention_bwd_cuda,
            "swiglu_bwd": swiglu_bwd_cuda}


def zero_launch_counts() -> None:
    """Set every kernel's launch count in this process to 0."""
    for kname in packed_attention_cuda.launches:
        packed_attention_cuda.launches[kname] = 0
    for fn in _COUNTED.values():
        fn.launches = 0


def launch_counts() -> dict:
    """Every kernel's launches in this process since the counts were last
    set to 0, by kernel name (packed attention by variant)."""
    return dict(packed_attention_cuda.launches,
                **{kname: fn.launches for kname, fn in _COUNTED.items()})


def _use_kernel(x: torch.Tensor, impl: Optional[str]) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if impl == "plain" or x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"no kernel for device {x.device}")


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _guard(name: str, *tensors) -> None:
    """A kernel without a backward, about to launch: raise rather than
    return an output that autograd cannot see through."""
    if _needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; an input requires "
            "grad (run under torch.no_grad(), or on the CPU's plain path)")


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
    fn = packed_attention_ref
    if _use_kernel(q, impl):
        _guard("packed_attention", q, k_cache, v_cache, k_scale, v_scale)
        fn = packed_attention_cuda
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
    fn = mla_attention_ref
    if _use_kernel(q, impl):
        _guard("mla_attention", q, c_kv, k_rope)
        fn = mla_attention_cuda
    return fn(q, c_kv, k_rope, token_slot, lengths, logit_scale=logit_scale,
              kv_bucket=kv_bucket)


def swiglu(x, w_gate, w_up, *, impl: Optional[str] = None) -> torch.Tensor:
    """``silu(x @ w_gate) * (x @ w_up)``; x (M, K), weights (K, N)."""
    kernel = _use_kernel(x, impl)
    if impl != "plain" and _needs_grad(x, w_gate, w_up):
        return SwiGLUFn.apply(x, w_gate, w_up)
    fn = swiglu_cuda if kernel else swiglu_ref
    return fn(x, w_gate, w_up)


def flash_attention(q, k, v, *, q_offset=0,
                    logit_scale: Optional[float] = None,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Causal GQA attention: query i of batch row b sees keys
    [0, q_offset[b] + i]; q (B, Sq, H, D), k/v (B, Skv, KV, D);
    ``q_offset`` an int or a (B,) int32 tensor; scores scaled by
    ``logit_scale`` (default D ** -0.5)."""
    kernel = _use_kernel(q, impl)
    if impl != "plain" and _needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, q_offset, logit_scale)
    fn = flash_attention_cuda if kernel else flash_attention_ref
    return fn(q, k, v, q_offset=q_offset, logit_scale=logit_scale)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     logit_scale: Optional[float] = None,
                     impl: Optional[str] = None) -> torch.Tensor:
    """One query per row over its length-masked cache row: q (B, H, D),
    caches (B, S, KV, D), rows [0, cache_len[b]) attended; scores scaled
    by ``logit_scale`` (default D ** -0.5)."""
    fn = decode_attention_ref
    if _use_kernel(q, impl):
        _guard("decode_attention", q, k_cache, v_cache)
        fn = decode_attention_cuda
    return fn(q, k_cache, v_cache, cache_len, logit_scale=logit_scale)


def paged_decode_attention(q, k_pages, v_pages, page_table, cache_len, *,
                           logit_scale: Optional[float] = None,
                           impl: Optional[str] = None) -> torch.Tensor:
    """Decode through a page table: q (B, H, D), page pools (NP, PS, KV,
    D), ``page_table`` (B, MAXP) int32 page ids (-1 unused), rows
    [0, cache_len[b]) of row b's pages attended; scores scaled by
    ``logit_scale`` (default D ** -0.5)."""
    fn = paged_decode_attention_ref
    if _use_kernel(q, impl):
        _guard("paged_decode_attention", q, k_pages, v_pages)
        fn = paged_decode_attention_cuda
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
        _guard("fused_overlap", x, w, q, k_cache, v_cache)
        return fused_overlap_cuda(x, w, q, k_cache, v_cache, cache_len,
                                  gemm_fraction=gemm_fraction)
    return fused_overlap_ref(x, w, q, k_cache, v_cache, cache_len)


def ssm_scan(x, dt, a, b, c, d, h0=None, *, impl: Optional[str] = None):
    """Mamba-1 selective scan: x, dt (B, S, C); a (C, N); b, c (B, S, N);
    d (C,); h0 (B, C, N) f32 or None.  Returns (y (B, S, C) in x's dtype,
    h_final (B, C, N) f32)."""
    fn = ssm_scan_ref
    if _use_kernel(x, impl):
        _guard("ssm_scan", x, dt, a, b, c, d, h0)
        fn = ssm_scan_cuda
    return fn(x, dt, a, b, c, d, h0)
