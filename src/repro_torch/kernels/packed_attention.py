"""Packed attention for the token-packed serving step: the CUDA kernel's
wrapper and its plain PyTorch version.

Token t of a packed ``(T,)`` stream attends rows ``[0, lengths[t])`` of
its own slot ``token_slot[t]`` in the slot caches, and nothing else.  The
kernel (``csrc/packed_attention.cu``) replaces the TPU kernel
``src/repro/kernels/packed_attention.py:packed_attention`` in its four
variants: contiguous or block-table caches (DESIGN.md §12), each with
native or int8 K/V (DESIGN.md §15).  It runs query tiles over runs of one
slot (a tile reads each K/V row once for up to ``tq`` tokens, the largest
power of two with ``tq * group <= 64``)
split into chunks of key rows, on the tensor cores with bf16 q and the
CUDA cores with f32 q; ``tile_plan`` sizes them and the split-KV scratch
from T and the sweep alone.  ``packed_attention_ref`` ports ``src/repro/kernels/ref.py:
packed_attention_ref`` and is what the CPU runs and what the card's kernel
is held against.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.serving.kvquant import dequantize_kv

NEG_INF = -1e30
GROUPS = (1, 2, 4, 8)          # query heads per KV head, built at every head dim
HEAD_DIMS = (64, 128, 256)
# groups 3, 7 and 9 (minitron-4b, Arctic and LLaVA-NeXT-34B, StarCoder2-7B)
# are built at head_dim 128 only, the head dim of every configuration with
# them; the five attention kernels share this rule
GROUPS_128 = (3, 7, 9)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (block tables, int8 K/V) -> the kernel variant's build target
VARIANTS = {(False, False): "packed_attention",
            (False, True): "packed_attention_quant",
            (True, False): "packed_attention_block",
            (True, True): "packed_attention_block_quant"}
# the tile kernel: a tile's rows (tokens x the group's heads), the
# least key rows per chunk (a power of two >= CHUNK_MULTIPLE: the kernel
# takes CHUNK << e, the smallest whose items fill no more than its grid;
# tools/packed_attention_probe.py), and the most (tokens x chunks) of
# split-KV scratch one launch may use: past it the chunks grow instead
TILE_ROWS = 64
CHUNK = 64
CHUNK_MULTIPLE = 64
SPLIT_BUDGET = 2048
# per-(device, stream) split-KV ticket counters; each launch leaves them 0
_TICKETS: dict = {}


def check_heads(check, h: int, kvh: int, d: int) -> None:
    """The (group, head dim) pairs the attention kernels are built for:
    ``GROUPS`` at every head dim of ``HEAD_DIMS``, ``GROUPS_128`` at 128.
    ``check(cond, what)`` raises the calling kernel's error."""
    group = h // kvh if kvh > 0 and h % kvh == 0 else 0
    check(group in GROUPS + GROUPS_128,
          f"group {h}/{kvh} not in {GROUPS + GROUPS_128}")
    check(d in HEAD_DIMS, f"head_dim {d} not in {HEAD_DIMS}")
    check(group in GROUPS or d == 128,
          f"group {group} is built at head_dim 128 only, not {d}")


def split_kv_tickets(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """Zeroed int32 counters for ``n`` (row or tile, KV head) pairs, kept
    per device and stream and shared by every split-KV kernel (packed
    attention's tiles, decode attention and the fused op's attention role):
    the launch that uses them sets them back to 0, and launches on one
    stream run in order."""
    key = (dev, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = _TICKETS[key] = torch.zeros(max(n, 1), dtype=torch.int32,
                                          device=dev)
    return buf


def tile_plan(t: int, group: int, sweep: int, *, tq: Optional[int] = None,
              chunk: Optional[int] = None) -> tuple[int, int, int]:
    """(tokens per group ``tq``, key rows per chunk, chunks) of the tile
    kernel for a T-token stream over ``sweep`` rows, from the shapes alone
    (never the lengths).  The chunks cover the sweep; when T x chunks would
    pass ``SPLIT_BUDGET`` the chunks grow so that the scratch stays within
    it, and a stream of SPLIT_BUDGET tokens or more is not split at all."""
    if tq is None:   # the largest power of two with tq x group <= 64
        tq = 1 << ((TILE_ROWS // group).bit_length() - 1)
    chunk = CHUNK if chunk is None else chunk
    if not (1 <= tq and tq & (tq - 1) == 0 and tq * group <= TILE_ROWS):
        raise ValueError(f"tq {tq} must be a power of two, and tq x group "
                         f"{group} at most {TILE_ROWS} rows")
    if chunk < CHUNK_MULTIPLE or chunk & (chunk - 1):
        raise ValueError(f"chunk {chunk} is not a power of two >= "
                         f"{CHUNK_MULTIPLE}")
    cap = max(1, SPLIT_BUDGET // max(t, 1))
    while -(-sweep // chunk) > cap:
        chunk *= 2
    return tq, chunk, max(1, -(-sweep // chunk))


def kv_bucket_view(cache: torch.Tensor,
                   kv_bucket: Optional[int]) -> torch.Tensor:
    """Rows at or beyond the bucket are never attended, so slicing them off
    is exact (DESIGN.md §9)."""
    if kv_bucket is not None and kv_bucket < cache.shape[1]:
        cache = cache[:, :kv_bucket]
    return cache


def _block_sweep(s: int, nb_cols: int, kv_bucket: Optional[int]):
    """(block size, rows swept) of a block-table cache with S rows per slot
    and ``nb_cols`` table columns."""
    if nb_cols < 1 or s % nb_cols:
        raise ValueError(f"block tables of {nb_cols} columns do not divide "
                         f"{s} rows per slot")
    bs = s // nb_cols
    sweep = s if kv_bucket is None or kv_bucket > s else kv_bucket
    if sweep % bs:
        raise ValueError(f"kv sweep {sweep} is not a multiple of the block "
                         f"size {bs}")
    return bs, sweep


def block_gather_view(cache: torch.Tensor, block_tables: torch.Tensor,
                      kv_bucket: Optional[int]) -> torch.Tensor:
    """Per-slot contiguous view of a block-table cache (DESIGN.md §12):
    ``cache`` (N, S, ...) is physical storage whose flat N·S row space is
    carved into blocks; ``block_tables`` (N, S // bs) names the physical
    block behind each slot's logical block.  Gathers the first ``kv_bucket``
    logical rows of every slot into (N, kv_bucket, ...)."""
    n, s = cache.shape[:2]
    bs, sweep = _block_sweep(s, block_tables.shape[1], kv_bucket)
    nbk = sweep // bs
    flat = cache.reshape((n * block_tables.shape[1], bs) + cache.shape[2:])
    view = flat[block_tables[:, :nbk].long()]            # (N, nbk, bs, ...)
    return view.reshape((n, nbk * bs) + cache.shape[2:])


def _dequant_views(k_cache, v_cache, k_scale, v_scale, block_tables,
                   kv_bucket):
    """Apply the bucket or block-table view to the caches (and to the scale
    leaves when quantized), then dequantize to f32."""
    leaves = [k_cache, v_cache] + ([k_scale, v_scale]
                                   if k_scale is not None else [])
    if block_tables is not None:
        leaves = [block_gather_view(x, block_tables, kv_bucket)
                  for x in leaves]
    else:
        leaves = [kv_bucket_view(x, kv_bucket) for x in leaves]
    if k_scale is None:
        return leaves
    k_cache, v_cache, k_scale, v_scale = leaves
    return (dequantize_kv(k_cache, k_scale, torch.float32),
            dequantize_kv(v_cache, v_scale, torch.float32))


def packed_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, token_slot: torch.Tensor,
                         lengths: torch.Tensor, *,
                         kv_bucket: Optional[int] = None,
                         block_tables: Optional[torch.Tensor] = None,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None,
                         logit_scale: Optional[float] = None
                         ) -> torch.Tensor:
    """Plain version.  q: (T, H, D); k_cache/v_cache: (N_slots, S, KV,
    D/Dv); token_slot, lengths: (T,) int.  Returns (T, H, Dv) in q's dtype;
    scores are scaled by ``logit_scale`` (default ``D ** -0.5``).

    ``block_tables`` ((N_slots, S // block_size) int): the caches are
    physical block storage, read through each slot's table; the sweep
    (``kv_bucket`` or S) is a multiple of the block size.
    ``k_scale``/``v_scale`` ((N_slots, S, KV) f32): the caches are int8 and
    dequantize as ``row * scale`` in f32.

    Scores are computed in f32 against *all* slots over the bucket rows and
    selected per token (N_slots is small, and each cache is then read once
    per einsum instead of once per token)."""
    k_cache, v_cache = _dequant_views(k_cache, v_cache, k_scale, v_scale,
                                      block_tables, kv_bucket)
    t, h, d = q.shape
    n, s, kv, _ = k_cache.shape
    dv = v_cache.shape[-1]
    group = h // kv
    scale = d ** -0.5 if logit_scale is None else logit_scale

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
                          kv_bucket: Optional[int] = None,
                          block_tables: Optional[torch.Tensor] = None,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None,
                          logit_scale: Optional[float] = None
                          ) -> torch.Tensor:
    """Launch the CUDA kernel (same contract as ``packed_attention_ref``,
    with ``d_v == d_qk``).
    The caches and scales are read in place through their (slot, row)
    strides; each row's (KV, D) block must be contiguous, and in
    block-table mode each leaf's flat row space must be uniform.  Raises on
    any input the kernel does not take and on a failed launch; counts the
    launches of each variant in ``packed_attention_cuda.launches``."""
    variant = VARIANTS[(block_tables is not None, k_scale is not None)]
    out = launch(variant, q, k_cache, v_cache, token_slot, lengths,
                 kv_bucket=kv_bucket, block_tables=block_tables,
                 k_scale=k_scale, v_scale=v_scale, logit_scale=logit_scale)
    packed_attention_cuda.launches[variant] += 1
    return out


def launch(target: str, q: torch.Tensor, k_cache: torch.Tensor,
           v_cache: torch.Tensor, token_slot: torch.Tensor,
           lengths: torch.Tensor, *, kv_bucket: Optional[int] = None,
           block_tables: Optional[torch.Tensor] = None,
           k_scale: Optional[torch.Tensor] = None,
           v_scale: Optional[torch.Tensor] = None,
           tq: Optional[int] = None,
           chunk: Optional[int] = None,
           logit_scale: Optional[float] = None) -> torch.Tensor:
    """Check the operands and launch build ``target`` of
    ``csrc/packed_attention.cu``, one of the four packed variants.  ``tq``
    and ``chunk`` override ``tile_plan``'s defaults
    (tools/packed_attention_probe.py sweeps them); ``logit_scale`` scales
    the scores (default ``D ** -0.5``)."""
    dev = q.device
    _check(dev.type == "cuda", "q is not a CUDA tensor")
    _check(token_slot is not None, "token_slot is required")
    quant = k_scale is not None
    _check((v_scale is not None) == quant, "k_scale and v_scale go together")
    blocked = block_tables is not None
    per_token = [("lengths", lengths), ("token_slot", token_slot)]
    named = [("k_cache", k_cache), ("v_cache", v_cache)] + per_token
    scales = [("k_scale", k_scale), ("v_scale", v_scale)] if quant else []
    if blocked:
        named.append(("block_tables", block_tables))
    for name, x in named + scales:
        _check(x.device == dev, f"{name} is on {x.device}, q on {dev}")
    _check(q.dtype in _DTYPES, f"dtype {q.dtype} (float32 or bfloat16)")
    kv_dtype = torch.int8 if quant else q.dtype
    _check(k_cache.dtype == kv_dtype and v_cache.dtype == kv_dtype,
           f"k_cache and v_cache must be {kv_dtype} for q {q.dtype}"
           + (" with scales" if quant else ""))
    _check(q.dim() == 3 and k_cache.dim() == 4 and v_cache.dim() == 4,
           "q (T, H, D), caches (N, S, KV, D)")
    t, h, d = q.shape
    n, s, kvh, dk = k_cache.shape
    _check(v_cache.shape[-1] == d, f"d_v != d_qk ({v_cache.shape[-1]} vs "
           f"{d}): absorbed MLA's latent attention is ops.mla_attention")
    _check(tuple(v_cache.shape) == (n, s, kvh, d) and dk == d,
           f"shapes q {tuple(q.shape)} k {tuple(k_cache.shape)} "
           f"v {tuple(v_cache.shape)}")
    check_heads(_check, h, kvh, d)
    _check(t < 65536, "at most 65535 tokens per launch")
    for name, x in per_token:
        _check(x.dtype == torch.int32 and tuple(x.shape) == (t,)
               and x.is_contiguous(), f"{name} must be contiguous int32 (T,)")
    _check(q.is_contiguous(), "q must be contiguous")
    for name, x in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check(x.stride(3) == 1 and x.stride(2) == d,
               f"{name} rows must hold contiguous (KV, D) blocks")
        # cp.async reads 16-byte pieces of every row
        _check(all(x.stride(i) * x.element_size() % 16 == 0
                   for i in (0, 1)) and x.data_ptr() % 16 == 0,
               f"{name} rows must be 16-byte aligned")
    _check(q.data_ptr() % 16 == 0, "q is not 16-byte aligned")
    s_strides = (0, 0)
    if quant:
        for name, x in scales:
            _check(x.dtype == torch.float32 and tuple(x.shape) == (n, s, kvh),
                   f"{name} must be float32 (N, S, KV) = {(n, s, kvh)}")
            _check(x.stride(2) == 1 and x.data_ptr() % 4 == 0,
                   f"{name} rows must hold contiguous, aligned KV scales")
        _check(k_scale.stride() == v_scale.stride(),
               "k_scale and v_scale must share strides")
        s_strides = (k_scale.stride(0), k_scale.stride(1))
    sweep = s if kv_bucket is None else min(int(kv_bucket), s)
    nb_cols = bs = 0
    if blocked:
        _check(block_tables.dtype == torch.int32 and block_tables.dim() == 2
               and block_tables.shape[0] == n
               and block_tables.is_contiguous(),
               f"block_tables must be contiguous int32 ({n}, S // bs)")
        nb_cols = block_tables.shape[1]
        bs, _ = _block_sweep(s, nb_cols, kv_bucket)
        for name, x in [("k_cache", k_cache), ("v_cache", v_cache)] + scales:
            _check(x.stride(0) == s * x.stride(1),
                   f"{name}: block-table mode needs a uniform flat row space "
                   "(stride(0) == S * stride(1))")
    out = torch.empty((t, h, d), dtype=q.dtype, device=dev)
    fn = build.build().fn(target)
    group = h // kvh
    part_ml = part_acc = None
    plan = tile_plan(t, group, sweep, tq=tq, chunk=chunk)
    if plan[2] > 1:
        part_ml = torch.empty(t * kvh * plan[2] * 2 * group,
                              dtype=torch.float32, device=dev)
        part_acc = torch.empty(t * kvh * plan[2] * group * d,
                               dtype=torch.float32, device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets = (split_kv_tickets(dev, stream, t * kvh)
                   if part_ml is not None else None)
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                ptr(k_scale), ptr(v_scale), token_slot.data_ptr(),
                lengths.data_ptr(), ptr(block_tables), out.data_ptr(),
                ptr(part_ml), ptr(part_acc), ptr(tickets),
                _DTYPES[q.dtype], int(quant), t, h, kvh, d, n, sweep,
                nb_cols, bs, *plan, k_cache.stride(0), k_cache.stride(1),
                v_cache.stride(0), v_cache.stride(1), *s_strides,
                float(d ** -0.5 if logit_scale is None else logit_scale),
                stream)
    if rc != 0:
        raise RuntimeError(f"{target} kernel launch failed: {rc}")
    return out


packed_attention_cuda.launches = dict.fromkeys(VARIANTS.values(), 0)
