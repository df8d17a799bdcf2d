"""Packed attention for the token-packed serving step: the CUDA kernel's
wrapper and its plain PyTorch version.

Token t of a packed ``(T,)`` stream attends rows ``[0, lengths[t])`` of
its own slot ``token_slot[t]`` in the slot caches, and nothing else.  The
kernel (``csrc/packed_attention.cu``) replaces the TPU kernel
``src/repro/kernels/packed_attention.py:packed_attention`` in contiguous
mode; ``packed_attention_ref`` ports ``src/repro/kernels/ref.py:
packed_attention_ref`` and is what the CPU runs and what the card's kernel
is held against.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
GROUPS = (1, 2, 4, 8)          # query heads per KV head the kernel is built for
HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _kv_bucket_view(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    kv_bucket: Optional[int]):
    """Rows at or beyond the bucket are never attended, so slicing them off
    is exact (DESIGN.md §9)."""
    if kv_bucket is not None and kv_bucket < k_cache.shape[1]:
        k_cache = k_cache[:, :kv_bucket]
        v_cache = v_cache[:, :kv_bucket]
    return k_cache, v_cache


def packed_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, token_slot: torch.Tensor,
                         lengths: torch.Tensor, *,
                         kv_bucket: Optional[int] = None) -> torch.Tensor:
    """Plain version.  q: (T, H, D); k_cache/v_cache: (N_slots, S, KV,
    D/Dv); token_slot, lengths: (T,) int.  Returns (T, H, Dv) in q's dtype;
    scores are scaled by ``D ** -0.5``.

    Scores are computed in f32 against *all* slots over the bucket rows and
    selected per token (N_slots is small, and each cache is then read once
    per einsum instead of once per token)."""
    k_cache, v_cache = _kv_bucket_view(k_cache, v_cache, kv_bucket)
    t, h, d = q.shape
    n, s, kv, _ = k_cache.shape
    dv = v_cache.shape[-1]
    group = h // kv
    scale = d ** -0.5

    qg = q.reshape(t, kv, group, d).float()
    scores_all = torch.einsum("tkgd,nskd->tnkgs", qg, k_cache.float()) * scale
    rows = torch.arange(t, device=q.device)
    slot = token_slot.long()
    scores = scores_all[rows, slot]                               # (T,KV,G,S)
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx_all = torch.einsum("tkgs,nskv->tnkgv", probs, v_cache.float())
    out = ctx_all[rows, slot]                                     # (T,KV,G,Dv)
    return out.reshape(t, h, dv).to(q.dtype)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"packed_attention kernel: {what}")


def packed_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, token_slot: torch.Tensor,
                          lengths: torch.Tensor, *,
                          kv_bucket: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel (same contract as ``packed_attention_ref``).
    The caches are read in place through their (slot, row) strides; each
    row's (KV, D) block must be contiguous.  Raises on any input the kernel
    does not take and on a failed launch."""
    dev = q.device
    _check(dev.type == "cuda", "q is not a CUDA tensor")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("token_slot", token_slot), ("lengths", lengths)):
        _check(x.device == dev, f"{name} is on {x.device}, q on {dev}")
    _check(q.dtype in _DTYPES, f"dtype {q.dtype} (float32 or bfloat16)")
    _check(k_cache.dtype == q.dtype and v_cache.dtype == q.dtype,
           "q, k_cache and v_cache must share a dtype")
    _check(q.dim() == 3 and k_cache.dim() == 4 and v_cache.dim() == 4,
           "q (T, H, D), caches (N, S, KV, D)")
    t, h, d = q.shape
    n, s, kvh, dk = k_cache.shape
    _check(tuple(v_cache.shape) == (n, s, kvh, d) and dk == d,
           f"shapes q {tuple(q.shape)} k {tuple(k_cache.shape)} "
           f"v {tuple(v_cache.shape)}")
    _check(h % kvh == 0 and h // kvh in GROUPS,
           f"group {h}/{kvh} not in {GROUPS}")
    _check(d in HEAD_DIMS, f"head_dim {d} not in {HEAD_DIMS}")
    _check(t < 65536, "at most 65535 tokens per launch")
    for name, x in (("token_slot", token_slot), ("lengths", lengths)):
        _check(x.dtype == torch.int32 and tuple(x.shape) == (t,)
               and x.is_contiguous(), f"{name} must be contiguous int32 (T,)")
    _check(q.is_contiguous(), "q must be contiguous")
    vec = d // 32                  # elements each lane loads per row
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check(x.stride(3) == 1 and x.stride(2) == d,
               f"{name} rows must hold contiguous (KV, D) blocks")
        _check(x.stride(0) % vec == 0 and x.stride(1) % vec == 0,
               f"{name} strides must keep rows vector-aligned")
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        _check(x.data_ptr() % (vec * x.element_size()) == 0,
               f"{name} is not aligned for vector loads")
    sweep = s if kv_bucket is None else min(int(kv_bucket), s)
    scale = d ** -0.5
    out = torch.empty((t, h, d), dtype=q.dtype, device=dev)
    fn = build.build().fn("packed_attention")
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                token_slot.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], t, h, kvh, d, n, sweep,
                k_cache.stride(0), k_cache.stride(1), v_cache.stride(0),
                v_cache.stride(1), float(scale),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"packed_attention kernel launch failed: {rc}")
    packed_attention_cuda.launches += 1
    return out


packed_attention_cuda.launches = 0
