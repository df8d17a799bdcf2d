"""Causal GQA flash attention for the legacy step's prefill paths: the CUDA
kernel's wrapper and its plain PyTorch version.

Query row i of batch row b attends keys ``[0, q_offset[b] + i]`` of its own
batch row (never past Skv).  The kernel (``csrc/flash_attention.cu``)
replaces the TPU kernel ``src/repro/kernels/flash_attention.py:
flash_attention`` and, unlike it, takes a per-row offset on the device.
``flash_attention_ref`` ports ``src/repro/kernels/ref.py:causal_qmask`` and
``flash_attention_ref`` and is what the CPU runs and what the card's kernel
is held against.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.kernels import build
from repro_torch.kernels.packed_attention import (GROUPS, HEAD_DIMS,
                                                  NEG_INF)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
Offset = Union[int, torch.Tensor]


def causal_qmask(sq: int, skv: int, q_offset: Offset,
                 device: torch.device) -> torch.Tensor:
    """(B|1, 1, 1, Sq, Skv) bool causal mask: query i of row b sees key j
    iff ``q_offset[b] + i >= j``; ``q_offset`` is an int or a (B,) tensor.
    Broadcasts against (B, KV, G, Sq, Skv) scores."""
    qo = torch.as_tensor(q_offset, dtype=torch.int64,
                         device=device).reshape(-1, 1)
    qpos = qo + torch.arange(sq, device=device)[None, :]
    kpos = torch.arange(skv, device=device)
    return (qpos[:, :, None] >= kpos[None, None, :])[:, None, None]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, q_offset: Offset = 0) -> torch.Tensor:
    """Plain version.  q: (B, Sq, H, D); k, v: (B, Skv, KV, D/Dv) with
    H = KV · group.  Scores are scaled by ``D ** -0.5`` and taken in f32;
    returns (B, Sq, H, Dv) in q's dtype.  ``d_v != d_qk`` is taken, as in
    the JAX ref."""
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    qg = q.reshape(b, sq, kv, h // kv, d).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d ** -0.5
    scores = scores.masked_fill(~causal_qmask(sq, skv, q_offset, q.device),
                                NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, h, dv).to(q.dtype)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention kernel: {what}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, q_offset: Offset = 0) -> torch.Tensor:
    """Launch the CUDA kernel (same contract as ``flash_attention_ref``,
    with ``d_v == d_qk``).  K and V are read in place through their (batch,
    row) strides — a slot's view of the serving cache — and each row's
    (KV, D) block must be contiguous; a tensor ``q_offset`` is read on the
    device (no host sync).  Raises on any input the kernel does not take
    and on a failed launch; counts launches in
    ``flash_attention_cuda.launches``."""
    dev = q.device
    _check(dev.type == "cuda", "q is not a CUDA tensor")
    _check(k.device == dev and v.device == dev,
           "q, k and v must share a device")
    _check(q.dtype in _DTYPES, f"dtype {q.dtype} (float32 or bfloat16)")
    _check(k.dtype == q.dtype and v.dtype == q.dtype,
           "q, k and v must share a dtype")
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
           "q (B, Sq, H, D), k and v (B, Skv, KV, D)")
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    _check(v.shape[-1] == d, "d_v != d_qk waits for absorbed MLA "
                             "(ROADMAP A5)")
    _check(tuple(k.shape) == (b, skv, kvh, d) and v.shape == k.shape,
           f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
           f"v {tuple(v.shape)}")
    _check(h % kvh == 0 and h // kvh in GROUPS,
           f"group {h}/{kvh} not in {GROUPS}")
    _check(d in HEAD_DIMS, f"head_dim {d} not in {HEAD_DIMS}")
    _check(b < 65536 and sq < 65536, "at most 65535 rows and queries")
    _check(q.is_contiguous(), "q must be contiguous")
    # bf16 moves 16-byte chunks; f32 loads head_dim / 32 floats per lane
    vec = 8 if q.dtype == torch.bfloat16 else d // 32
    for name, x in (("k", k), ("v", v)):
        _check(x.stride(3) == 1 and x.stride(2) == d,
               f"{name} rows must hold contiguous (KV, D) blocks")
        _check(x.stride(0) % vec == 0 and x.stride(1) % vec == 0,
               f"{name} strides must keep rows vector-aligned")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(x.data_ptr() % (vec * x.element_size()) == 0,
               f"{name} is not aligned for vector loads")
    offsets, scalar = None, 0
    if isinstance(q_offset, torch.Tensor):
        _check(q_offset.device == dev and q_offset.dtype == torch.int32
               and tuple(q_offset.shape) == (b,)
               and q_offset.is_contiguous(),
               f"q_offset must be a contiguous int32 ({b},) tensor on {dev}")
        offsets = q_offset.data_ptr()
    else:
        scalar = int(q_offset)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    fn = build.build().fn("flash_attention")
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), offsets,
                out.data_ptr(), _DTYPES[q.dtype], b, sq, skv, h, kvh, d,
                scalar, k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                float(d ** -0.5), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: {rc}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
