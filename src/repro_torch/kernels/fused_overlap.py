"""NanoFlow's fused GEMM + decode-attention overlap: the CUDA kernel's
wrapper and its plain PyTorch version.

``x @ w`` and decode attention of ``q`` over slot caches, computed in one
launch whose CTAs are split between the two by ``gemm_fraction`` (the
paper's SM partition).  The kernel (``csrc/fused_overlap.cu``) replaces the
TPU kernel ``src/repro/kernels/fused_overlap.py:fused_overlap``;
``fused_overlap_ref`` ports ``src/repro/kernels/ref.py:fused_overlap_ref``
and is what the CPU runs and what the card's kernel is held against.  In
the port it is called only through ``kernels.ops.fused_overlap``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (check_caches,
                                                  decode_attention_ref,
                                                  split_kv_tickets)
from repro_torch.kernels.packed_attention import check_heads

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# cache rows per attention unit (csrc/attn_decode.cuh): the fastest of
# 128-1024 for the attention role alone at chip_smoke's shape (PERF.md §6;
# the TPU kernel's block_s is 256)
CHUNK = 512


def fused_overlap_ref(x: torch.Tensor, w: torch.Tensor, q: torch.Tensor,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      cache_len: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (x @ w accumulated in f32 and cast to x's dtype,
    ``decode_attention_ref`` of q over the caches with scale D ** -0.5).
    x: (M, K); w: (K, N); q: (B, H, D); caches (B, S, KV, D); cache_len
    (B,)."""
    gemm_out = torch.matmul(x.float(), w.float()).to(x.dtype)
    return gemm_out, decode_attention_ref(q, k_cache, v_cache, cache_len)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"fused_overlap kernel: {what}")


def fused_overlap_cuda(x: torch.Tensor, w: torch.Tensor, q: torch.Tensor,
                       k_cache: torch.Tensor, v_cache: torch.Tensor,
                       cache_len: torch.Tensor, *,
                       gemm_fraction: float = 0.5
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel (same contract as ``fused_overlap_ref``, with
    ``1 <= cache_len[b] <= S``; a row with no valid key gives zeros).
    ``gemm_fraction`` in (0, 1] is the share of the launch's CTAs that take
    GEMM tiles; at least one CTA keeps each kind of work, and the outputs do
    not depend on it.  All operands share one dtype; the caches are read in
    place through their (row, position) strides.  Raises on any input the
    kernel does not take and on a failed launch; counts launches in
    ``fused_overlap_cuda.launches`` and leaves the launch's (CTAs, GEMM
    CTAs, CTAs per SM) in ``fused_overlap_cuda.schedule``."""
    outs = launch(x, w, q, k_cache, v_cache, cache_len,
                  gemm_fraction=gemm_fraction)
    fused_overlap_cuda.launches += 1
    fused_overlap_cuda.schedule = launch.schedule
    return outs


fused_overlap_cuda.launches = 0
fused_overlap_cuda.schedule = None


def launch(x: torch.Tensor, w: torch.Tensor, q: torch.Tensor,
           k_cache: torch.Tensor, v_cache: torch.Tensor,
           cache_len: torch.Tensor, *, gemm_fraction: float = 0.5,
           chunk: int = CHUNK) -> tuple[torch.Tensor, torch.Tensor]:
    """Check the operands and launch ``csrc/fused_overlap.cu`` with
    attention units of ``chunk`` cache rows (a positive multiple of 64).
    Leaves (CTAs, GEMM CTAs, CTAs per SM) in ``launch.schedule`` and
    (attention units, chunk) in ``launch.units``."""
    dev = x.device
    _check(dev.type == "cuda", "x is not a CUDA tensor")
    named = (("w", w), ("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
             ("cache_len", cache_len))
    for name, a in named:
        _check(a.device == dev, f"{name} is on {a.device}, x on {dev}")
    _check(0.0 < gemm_fraction <= 1.0,
           f"gemm_fraction {gemm_fraction} not in (0, 1]")
    _check(x.dtype in _DTYPES, f"dtype {x.dtype} (float32 or bfloat16)")
    for name, a in named[:4]:
        _check(a.dtype == x.dtype, f"{name} is {a.dtype}, x {x.dtype}")
    _check(x.dim() == 2 and w.dim() == 2 and q.dim() == 3
           and k_cache.dim() == 4, "x (M, K), w (K, N), q (B, H, D), "
           "caches (B, S, KV, D)")
    m, kdim = x.shape
    n = w.shape[1]
    b, h, d = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    _check(w.shape[0] == kdim, f"x {tuple(x.shape)} @ w {tuple(w.shape)}")
    _check(tuple(k_cache.shape) == (b, s, kvh, d)
           and tuple(v_cache.shape) == (b, s, kvh, d),
           f"shapes q {tuple(q.shape)} k {tuple(k_cache.shape)} "
           f"v {tuple(v_cache.shape)}")
    check_heads(_check, h, kvh, d)
    _check(cache_len.dtype == torch.int32 and tuple(cache_len.shape) == (b,)
           and cache_len.is_contiguous(),
           "cache_len must be contiguous int32 (B,)")
    _check(x.is_contiguous() and w.is_contiguous() and q.is_contiguous(),
           "x, w and q must be contiguous")
    check_caches(_check, q, k_cache, v_cache)
    _check(chunk > 0 and chunk % 64 == 0,
           f"chunk {chunk} is not a positive multiple of 64")
    if x.dtype == torch.bfloat16:
        _check(kdim > 0 and kdim % 8 == 0 and n % 8 == 0,
               "bf16 needs K > 0 and K and N % 8 == 0")
        _check(x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
               "x and w must be 16-byte aligned")
    n_chunks = max(1, -(-s // chunk))
    group = h // kvh
    gemm_out = torch.empty((m, n), dtype=x.dtype, device=dev)
    attn_out = torch.empty((b, h, d), dtype=q.dtype, device=dev)
    part_ml = torch.empty(b * kvh * n_chunks * 2 * group, dtype=torch.float32,
                          device=dev)
    part_acc = torch.empty(b * kvh * n_chunks * group * d,
                           dtype=torch.float32, device=dev)
    sched = (ctypes.c_int * 4)()
    fn = build.build().fn("fused_overlap")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets = split_kv_tickets(dev, stream, b * kvh)
        rc = fn(x.data_ptr(), w.data_ptr(), gemm_out.data_ptr(),
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                cache_len.data_ptr(), attn_out.data_ptr(), part_ml.data_ptr(),
                part_acc.data_ptr(), tickets.data_ptr(), _DTYPES[x.dtype],
                m, n, kdim, b, h, kvh, d, s, chunk, k_cache.stride(0),
                k_cache.stride(1), v_cache.stride(0), v_cache.stride(1),
                float(d ** -0.5), float(gemm_fraction), sched, stream)
    if rc != 0:
        raise RuntimeError(f"fused_overlap kernel launch failed: {rc}")
    launch.schedule = tuple(sched[:3])
    launch.units = (sched[3], chunk)
    return gemm_out, attn_out


launch.schedule = launch.units = None
