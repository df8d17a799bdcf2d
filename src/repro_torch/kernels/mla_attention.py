"""Latent attention of absorbed MLA (DeepSeek-V2): the CUDA kernel's wrapper,
its split plan and its plain PyTorch version.

Absorbed MLA attends in the latent space as a GQA with one shared KV
"head": query t (H heads of ``rank + rope`` columns) attends rows
``[0, lengths[t])`` of slot ``token_slot[t]``, whose key row is
``[c_kv | k_rope]`` and whose value row is ``c_kv``, with scores scaled by
``logit_scale`` (MLA's ``(qk_nope_dim + qk_rope_dim) ** -0.5``).  Every MLA
path runs it: the packed step on its token stream, decode (token b = slot
b), and the chunk and whole-prompt prefills (token (b, i) = slot b with
length ``q_offset[b] + i + 1``, flash's causal mask).

The kernel (``csrc/mla_attention.cu``) replaces the TPU kernel
``src/repro/kernels/packed_attention.py:packed_attention`` in the form MLA
runs it (KV = 1, d_v != d_qk), reading the two cache leaves in place; it is
built for ``kv_lora_rank`` 512 and ``qk_rope_dim`` 64 (DeepSeek-V2, -V2-Lite
and -V3) with H a multiple of 64 up to 128, and refuses other shapes.  Its
bf16 build runs one CTA per (token, 64-head block, key chunk) on wgmma and
a TMA ring of 64-row stages; ``plan`` sizes the chunks from the shapes and
the SM count, never from the lengths, and ``items`` replays how the kernel
decodes them.  ``mla_attention_ref`` concatenates the key and runs the
packed plain version with ``logit_scale``; it is what the CPU runs and what
the card's kernel is held against.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.packed_attention import (kv_bucket_view,
                                                  packed_attention_ref,
                                                  split_kv_tickets)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
RANK = 512              # kv_lora_rank the kernel is built for
ROPE = 64               # qk_rope_dim
HEAD_BLOCK = 64         # query heads per CTA (bf16)
MAX_HEADS = 128
STAGE = 64              # key rows per bf16 stage; a chunk is whole stages
F32_STAGE = 32          # key rows per stage of the f32 kernel
MIN_CHUNK = 64          # the fewest key rows a split chunk takes
PART = 2 * (RANK // 4 + 4) * 128   # f32 of a bf16 split chunk's partial


class Item(NamedTuple):
    """One CTA of the bf16 grid: its token, head block and chunk, its rows
    [k0, k1) (none when k1 <= k0: then it writes zeros if it is chunk 0,
    else exits), and how many chunks of its (token, head block) have rows
    (above 1 their partials are merged in chunk order)."""
    cta: int
    token: int
    hb: int
    chunk: int
    k0: int
    k1: int
    live: int


def mla_attention_ref(q: torch.Tensor, c_kv: torch.Tensor,
                      k_rope: torch.Tensor, token_slot: torch.Tensor,
                      lengths: torch.Tensor, *, logit_scale: float,
                      kv_bucket: Optional[int] = None) -> torch.Tensor:
    """Plain version.  q: (T, H, rank + rope); c_kv: (N, S, rank); k_rope:
    (N, S, rope); token_slot, lengths: (T,) int.  Returns (T, H, rank) in
    q's dtype: the packed plain version over the concatenated key, scores
    taken in f32 and scaled by ``logit_scale``.  A token whose slot is out
    of range or whose length is not positive gives zeros, as the kernel
    does (the JAX reference's answer there is undefined)."""
    c_kv = kv_bucket_view(c_kv, kv_bucket)
    k_rope = kv_bucket_view(k_rope, kv_bucket)
    n = c_kv.shape[0]
    valid = (token_slot >= 0) & (token_slot < n) & (lengths > 0)
    key = torch.cat([c_kv, k_rope], dim=-1)[:, :, None]
    out = packed_attention_ref(q, key, c_kv[:, :, None],
                               torch.where(valid, token_slot, 0), lengths,
                               logit_scale=logit_scale)
    return torch.where(valid[:, None, None], out, torch.zeros_like(out))


def plan(t: int, h: int, sweep: int, sms: int) -> tuple[int, int]:
    """(key rows per chunk, chunks) of a launch, from the shapes alone (never
    the lengths): one chunk when the T x H / 64 (token, head block) items
    fill the SMs, else as many chunks of at least ``MIN_CHUNK`` rows as
    bring the CTAs up to one per SM (a decode batch).  More, shorter chunks
    lost at the decode shape: each chunk with rows adds a 135 KB f32
    partial that the item's last CTA reads back (tools/mla_probe.py
    --sweep, PERF.md)."""
    items = max(1, t * max(1, h // HEAD_BLOCK))
    splits = 1
    if items < sms:
        splits = max(1, min(-(-sms // items), sweep // MIN_CHUNK))
    per = -(-max(sweep, 1) // splits)
    chunk = -(-per // STAGE) * STAGE
    return chunk, max(1, -(-sweep // chunk))


def items(sched: tuple[int, int], h: int, n: int, sweep: int,
          slots: Sequence[int], lengths: Sequence[int]) -> list[Item]:
    """The bf16 grid as the kernel decodes it (``mla_bf16_kernel``): CTA i
    is chunk i // (T x H / 64), then token, then head block.  ``slots`` and
    ``lengths`` are the tokens' values (the kernel reads them on the
    device)."""
    chunk, splits = sched
    hblocks = h // HEAD_BLOCK
    per_chunk = len(slots) * hblocks
    out = []
    for cta in range(per_chunk * splits):
        c, rest = divmod(cta, per_chunk)
        tok, hb = divmod(rest, hblocks)
        lim = (min(int(lengths[tok]), sweep) if 0 <= slots[tok] < n else 0)
        k0 = c * chunk
        out.append(Item(cta, tok, hb, c, k0, min(lim, k0 + chunk),
                        -(-lim // chunk) if lim > 0 else 0))
    return out


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"mla_attention kernel: {what}")


def mla_attention_cuda(q: torch.Tensor, c_kv: torch.Tensor,
                       k_rope: torch.Tensor, token_slot: torch.Tensor,
                       lengths: torch.Tensor, *, logit_scale: float,
                       kv_bucket: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel (same contract as ``mla_attention_ref``).  The
    latent leaves are read in place through their (slot, row) strides and
    neither the lengths nor the slots are read on the host.  Raises on any
    input the kernel does not take and on a failed launch; counts launches
    in ``mla_attention_cuda.launches``."""
    out = launch(q, c_kv, k_rope, token_slot, lengths,
                 logit_scale=logit_scale, kv_bucket=kv_bucket)
    if q.shape[0]:          # an empty stream launches nothing
        mla_attention_cuda.launches += 1
    return out


mla_attention_cuda.launches = 0


def launch(q: torch.Tensor, c_kv: torch.Tensor, k_rope: torch.Tensor,
           token_slot: torch.Tensor, lengths: torch.Tensor, *,
           logit_scale: float, kv_bucket: Optional[int] = None,
           sched: Optional[tuple[int, int]] = None) -> torch.Tensor:
    """``mla_attention_cuda`` without the count: checks, then one launch of
    the C entry (in f32 the kernel, and a merge kernel when the sweep is
    split; in bf16 one kernel that also merges).  ``sched`` (chunk, chunks)
    overrides ``plan``'s; the schedule run is left in ``launch.schedule``.
    """
    dev = q.device
    _check(dev.type == "cuda", "q is not a CUDA tensor")
    named = [("c_kv", c_kv), ("k_rope", k_rope), ("token_slot", token_slot),
             ("lengths", lengths)]
    for name, x in named:
        _check(x.device == dev, f"{name} is on {x.device}, q on {dev}")
    _check(q.dtype in _DTYPES, f"dtype {q.dtype} (float32 or bfloat16)")
    _check(c_kv.dtype == q.dtype and k_rope.dtype == q.dtype,
           f"c_kv and k_rope must be {q.dtype} for q {q.dtype}")
    _check(q.dim() == 3 and c_kv.dim() == 3 and k_rope.dim() == 3,
           "q (T, H, rank + rope), c_kv (N, S, rank), k_rope (N, S, rope)")
    t, h, d = q.shape
    n, s, rank = c_kv.shape
    rope = k_rope.shape[2]
    _check(tuple(k_rope.shape[:2]) == (n, s) and d == rank + rope,
           f"shapes q {tuple(q.shape)} c_kv {tuple(c_kv.shape)} "
           f"k_rope {tuple(k_rope.shape)}")
    _check(rank == RANK and rope == ROPE,
           f"built for kv_lora_rank {RANK} and qk_rope_dim {ROPE}, not "
           f"{rank} and {rope}")
    _check(h % HEAD_BLOCK == 0 and HEAD_BLOCK <= h <= MAX_HEADS,
           f"{h} heads: built for multiples of {HEAD_BLOCK} up to "
           f"{MAX_HEADS}")
    for name, x in (("token_slot", token_slot), ("lengths", lengths)):
        _check(x.dtype == torch.int32 and tuple(x.shape) == (t,)
               and x.is_contiguous(), f"{name} must be contiguous int32 (T,)")
    _check(q.is_contiguous() and q.data_ptr() % 16 == 0,
           "q must be contiguous and 16-byte aligned")
    for name, x in (("c_kv", c_kv), ("k_rope", k_rope)):
        # TMA (bf16) and cp.async (f32) read 16-byte pieces of every row
        _check(x.stride(2) == 1, f"{name} rows must be contiguous")
        _check(all(x.stride(i) * x.element_size() % 16 == 0 for i in (0, 1))
               and x.data_ptr() % 16 == 0,
               f"{name} rows must be 16-byte aligned")
    sweep = s if kv_bucket is None else max(0, min(int(kv_bucket), s))
    chunk, splits = sched or plan(t, h, sweep, _sms(dev.index))
    stage = STAGE if q.dtype == torch.bfloat16 else F32_STAGE
    _check(chunk > 0 and chunk % stage == 0
           and splits == max(1, -(-sweep // chunk)),
           f"schedule {(chunk, splits)} for a sweep of {sweep}")
    launch.schedule = (chunk, splits)
    out = torch.empty((t, h, rank), dtype=q.dtype, device=dev)
    if t == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    # held until the launch is enqueued: freed earlier, a block could come
    # back as ``out``
    part_ml = part_acc = tickets = None
    if splits > 1 and q.dtype == torch.bfloat16:
        part_acc = torch.empty(t * (h // HEAD_BLOCK) * splits * PART,
                               dtype=torch.float32, device=dev)
        tickets = split_kv_tickets(dev, stream, t * (h // HEAD_BLOCK))
    elif splits > 1:
        part_ml = torch.empty(t * h * splits * 2, dtype=torch.float32,
                              device=dev)
        part_acc = torch.empty(t * h * splits * rank, dtype=torch.float32,
                               device=dev)
    fn = build.build().fn("mla_attention")
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), c_kv.data_ptr(), k_rope.data_ptr(),
                token_slot.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                *(None if x is None else x.data_ptr()
                  for x in (part_ml, part_acc, tickets)),
                _DTYPES[q.dtype], t, h, n, sweep, chunk, splits,
                c_kv.stride(0), c_kv.stride(1), k_rope.stride(0),
                k_rope.stride(1), float(logit_scale), stream)
    if rc != 0:
        raise RuntimeError(f"mla_attention kernel launch failed: {rc}")
    return out


launch.schedule = None
