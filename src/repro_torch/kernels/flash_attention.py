"""Causal GQA flash attention for the legacy step's prefill paths: the CUDA
kernel's wrapper, its schedule and its plain PyTorch version.

Query row i of batch row b attends keys ``[0, q_offset[b] + i]`` of its own
batch row (never past Skv).  The kernel (``csrc/flash_attention.cu``)
replaces the TPU kernel ``src/repro/kernels/flash_attention.py:
flash_attention`` and, unlike it, takes a per-row offset on the device.
Its bf16 build runs one CTA per item (64-row query tile, KV head, batch
row, key chunk); ``plan`` sizes the chunks from the shapes and the SM
count, never from the offset, and ``items`` replays how the kernel decodes
them.  ``flash_attention_ref`` ports ``src/repro/kernels/ref.py:
causal_qmask`` and ``flash_attention_ref`` and is what the CPU runs and
what the card's kernel is held against.

Training differentiates through ``FlashAttentionFn``: on the card its
forward launches the kernel with the rows' log-sum-exp as a second output
and its backward ``csrc/flash_attention_bwd.cu`` (in bf16 one key-major
pass with dQ summed in a fixed order); on the CPU it runs
``flash_attention_ref``, ``flash_attention_lse_ref`` and
``flash_attention_bwd_ref``, the plain versions the card's kernels are
held against.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Union

import torch

from repro_torch.kernels import build
from repro_torch.kernels.packed_attention import (NEG_INF, check_heads,
                                                  split_kv_tickets)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
Offset = Union[int, torch.Tensor]
# the bf16 kernel's tile: query rows (positions x the group's heads) and
# keys per K/V stage (a chunk is a whole number of stages); one CTA per SM
BLOCK_M = 64
BLOCK_N = 64
# the fewest 64-key stages in a chunk of a split tile: shorter chunks lost
# to one chunk at every measured range (tools/flash_probe.py, PERF.md)
MIN_CHUNK_TILES = 16
PART_THREADS = 128   # a split chunk's partial: (head_dim / 2 + 4) x 128 f32


class Item(NamedTuple):
    """One CTA of the bf16 grid: its tile and chunk, its keys [k0, k1)
    (none when k1 <= k0, and then it exits at once unless it is the only
    chunk of a tile with no keys), and how many chunks of its tile have
    keys (above 1 the tile's partials are merged in chunk order)."""
    cta: int
    b: int
    kvh: int
    qt: int
    chunk: int
    k0: int
    k1: int
    live: int


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


def _scores(q: torch.Tensor, k: torch.Tensor, q_offset: Offset,
            logit_scale: Optional[float]) -> torch.Tensor:
    """(B, KV, G, Sq, Skv) f32 scaled scores, NEG_INF where masked."""
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if logit_scale is None else logit_scale
    qg = q.reshape(b, sq, kv, h // kv, d).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    return scores.masked_fill(~causal_qmask(sq, skv, q_offset, q.device),
                              NEG_INF)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, q_offset: Offset = 0,
                        logit_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version.  q: (B, Sq, H, D); k, v: (B, Skv, KV, D/Dv) with
    H = KV · group.  Scores are scaled by ``logit_scale`` (default
    ``D ** -0.5``) and taken in f32; returns (B, Sq, H, Dv) in q's dtype.
    ``d_v != d_qk`` is taken, as in the JAX ref."""
    b, sq, h, _ = q.shape
    probs = torch.softmax(_scores(q, k, q_offset, logit_scale), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                            q_offset: Offset = 0,
                            logit_scale: Optional[float] = None
                            ) -> torch.Tensor:
    """The forward's second output on the card: each row's f32
    log-sum-exp of its scaled, masked scores, (B, H, Sq)."""
    b, sq, h, _ = q.shape
    lse = torch.logsumexp(_scores(q, k, q_offset, logit_scale), dim=-1)
    return lse.reshape(b, h, sq)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            q_offset: Offset = 0,
                            logit_scale: Optional[float] = None):
    """Plain backward: (dq, dk, dv) in the inputs' dtypes, from the
    forward's ``out`` and row log-sum-exp ``lse`` (B, H, Sq), all in f32:
    P = exp(s - lse), dV = P^T dO, dS = P (dO V^T - rowsum(dO O)),
    dQ = scale dS K and dK = scale dS^T Q, dK and dV summed over each KV
    head's group of query heads."""
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = d ** -0.5 if logit_scale is None else logit_scale
    qg = q.reshape(b, sq, kv, g, d).float()
    dog = dout.reshape(b, sq, kv, g, -1).float()
    mask = causal_qmask(sq, skv, q_offset, q.device)
    s = _scores(q, k, q_offset, logit_scale)
    p = torch.exp(s - lse.reshape(b, kv, g, sq, 1)).masked_fill(~mask, 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    delta = (dout.float() * out.float()).sum(-1)            # (B, Sq, H)
    delta = delta.reshape(b, sq, kv, g).permute(0, 2, 3, 1)[..., None]
    ds = p * (dp - delta)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def plan(b: int, sq: int, skv: int, n_kv: int, group: int,
         sms: int) -> tuple[int, int, int]:
    """(query tiles, keys per chunk, chunks) of the bf16 kernel: a tile is
    64 / group positions of one KV head and batch row, and one CTA runs on
    each SM.  A tile's keys split into chunks of at least
    ``MIN_CHUNK_TILES`` 64-key stages, and only as far as every chunk of
    every tile still has an SM of its own (tiles x chunks <= SMs): a
    second wave of CTAs, or a short chunk, costs more than the merge of
    f32 partials saves.  From the shapes alone: the grid holds every
    (tile, chunk) of an Skv-key range, whatever the device offset."""
    q_tiles = -(-sq // (BLOCK_M // group))
    tiles = max(1, q_tiles * n_kv * b)
    key_tiles = max(1, -(-skv // BLOCK_N))
    split = max(1, min(sms // tiles, key_tiles // MIN_CHUNK_TILES))
    chunk = -(-key_tiles // split) * BLOCK_N
    return q_tiles, chunk, max(1, -(-skv // chunk))


def items(sched: tuple[int, int, int], b: int, sq: int, skv: int, n_kv: int,
          group: int, offsets: Sequence[int]) -> list[Item]:
    """The bf16 grid as the kernel decodes it (``flash_bf16_kernel``): CTA
    i is chunk i // tiles, then, within a chunk, query tiles from the last
    (the most keys) down, then KV heads, then batch rows.  ``offsets`` are
    the rows' q_offset values (the kernel reads them on the device)."""
    q_tiles, chunk, n_chunks = sched
    pt = BLOCK_M // group
    tiles = q_tiles * n_kv * b
    out = []
    for cta in range(tiles * n_chunks):
        c, rest = divmod(cta, tiles)
        qt = q_tiles - 1 - rest // (n_kv * b)
        last_pos = min(qt * pt + pt, sq) - 1
        kend = max(0, min(skv, offsets[rest % b] + last_pos + 1))
        out.append(Item(cta, rest % b, rest // b % n_kv, qt, c, c * chunk,
                        min(kend, c * chunk + chunk), -(-kend // chunk)))
    return out


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention kernel: {what}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, q_offset: Offset = 0,
                         logit_scale: Optional[float] = None,
                         lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel (same contract as ``flash_attention_ref``,
    with ``d_v == d_qk``).  K and V are read in place through their (batch,
    row) strides — a slot's view of the serving cache — and each row's
    (KV, D) block must be contiguous; a tensor ``q_offset`` is read on the
    device (no host sync).  ``lse``, a contiguous (B, H, Sq) f32 tensor,
    receives each row's log-sum-exp (``flash_attention_lse_ref``).  Raises
    on any input the kernel does not take and on a failed launch; counts
    launches in ``flash_attention_cuda.launches``."""
    out = launch(q, k, v, q_offset, logit_scale=logit_scale, lse=lse)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offset: Offset = 0, sched=None,
           logit_scale: Optional[float] = None,
           lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``flash_attention_cuda`` without the count: checks, then one launch
    of the C entry.  bf16 runs ``sched`` (query tiles, chunk, chunks), by
    default ``plan``'s, and records (query tiles, chunk, chunks, CTAs) in
    ``launch.schedule``; ``tools/flash_probe.py`` passes others."""
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
    _check(v.shape[-1] == d, f"d_v != d_qk ({v.shape[-1]} vs {d}): "
           "absorbed MLA's latent attention is ops.mla_attention")
    _check(tuple(k.shape) == (b, skv, kvh, d) and v.shape == k.shape,
           f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
           f"v {tuple(v.shape)}")
    check_heads(_check, h, kvh, d)
    _check(b < 65536 and sq < 65536, "at most 65535 rows and queries")
    _check(q.is_contiguous(), "q must be contiguous")
    # bf16 moves 16-byte boxes (TMA's strides and bases); f32 loads
    # head_dim / 32 floats per lane
    bf16 = q.dtype == torch.bfloat16
    vec = 8 if bf16 else d // 32
    for name, x in (("k", k), ("v", v)):
        _check(x.stride(3) == 1 and x.stride(2) == d,
               f"{name} rows must hold contiguous (KV, D) blocks")
        _check(x.stride(0) % vec == 0 and x.stride(1) % vec == 0,
               f"{name} strides must keep rows vector-aligned")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(x.data_ptr() % (vec * x.element_size()) == 0,
               f"{name} is not aligned for vector loads")
    if lse is not None:
        _check(lse.device == dev and lse.dtype == torch.float32
               and tuple(lse.shape) == (b, h, sq) and lse.is_contiguous(),
               f"lse must be a contiguous f32 ({b}, {h}, {sq}) tensor")
    offsets, scalar = None, 0
    if isinstance(q_offset, torch.Tensor):
        _check(q_offset.device == dev and q_offset.dtype == torch.int32
               and tuple(q_offset.shape) == (b,)
               and q_offset.is_contiguous(),
               f"q_offset must be a contiguous int32 ({b},) tensor on {dev}")
        offsets = q_offset.data_ptr()
    else:
        scalar = int(q_offset)
    stream = torch.cuda.current_stream(dev).cuda_stream
    chunk, n_chunks, part, tickets = 0, 1, None, None
    if bf16:
        sched = sched or plan(b, sq, skv, kvh, h // kvh, _sms(dev.index))
        q_tiles, chunk, n_chunks = sched
        _check(chunk > 0 and chunk % BLOCK_N == 0
               and n_chunks == max(1, -(-skv // chunk)),
               f"schedule {sched} for Skv {skv}")
        tiles = q_tiles * kvh * b
        if n_chunks > 1:
            # held until the launch is enqueued: freed earlier, its block
            # could come back as ``out``
            part = torch.empty(tiles * n_chunks * (d // 2 + 4) * PART_THREADS,
                               dtype=torch.float32, device=dev)
            tickets = split_kv_tickets(dev, stream, tiles).data_ptr()
        launch.schedule = (q_tiles, chunk, n_chunks, tiles * n_chunks)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    fn = build.build().fn("flash_attention")
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), offsets,
                out.data_ptr(), None if lse is None else lse.data_ptr(),
                None if part is None else part.data_ptr(),
                tickets, _DTYPES[q.dtype], b, sq, skv,
                h, kvh, d, scalar, chunk, n_chunks, k.stride(0), k.stride(1),
                v.stride(0), v.stride(1),
                float(d ** -0.5 if logit_scale is None else logit_scale),
                stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: {rc}")
    return out


launch.schedule = None


# the backward kernels' head dims (csrc/flash_attention_bwd.cu)
BWD_HEAD_DIMS = (64, 128)


def bwd_scratch(b: int, s: int, n_kv: int, group: int,
                d: int) -> tuple[int, int, int]:
    """The bf16 backward's scratch, in elements: L log2(e) and D per packed
    query row (f32), the dQ sums (f32), and the order counters (int32: one
    per query tile, then the work counter).  A query tile is the forward's
    64 packed rows, 64 // group positions x the group's heads, of one
    (batch row, KV head)."""
    tiles = b * n_kv * -(-s // (BLOCK_M // group))
    return tiles * 2 * BLOCK_M, tiles * BLOCK_M * d, tiles + 1


def check_backward(q: torch.Tensor, k: torch.Tensor,
                   q_offset: Offset) -> None:
    """What the backward kernels take beyond the forward's contract:
    Sq == Skv, an int q_offset >= 0, head_dim 64 or 128.  Raises
    ValueError."""
    _check(q.shape[1] == k.shape[1],
           f"backward: Sq {q.shape[1]} != Skv {k.shape[1]}")
    _check(not isinstance(q_offset, torch.Tensor) and int(q_offset) >= 0,
           "backward: q_offset must be an int >= 0")
    _check(q.shape[-1] in BWD_HEAD_DIMS,
           f"backward: head_dim {q.shape[-1]} not in {BWD_HEAD_DIMS}")


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             q_offset: Offset = 0,
                             logit_scale: Optional[float] = None):
    """Launch the backward kernels (same contract as
    ``flash_attention_bwd_ref``) on the current stream: in bf16 the
    preprocess (rowsum(dO O) and L per packed row), the key-major kernel
    (dK, dV and dQ's f32 sums), then the postprocess that writes dQ
    (``bwd_scratch`` sizes their scratch; the order counters are
    ``split_kv_tickets``, left zero); in f32 dQ, which also stores
    rowsum(dO O), then dK/dV.  Every tensor contiguous on one card: q,
    out, dout (B, S, H, D), k, v (B, S, KV, D), lse (B, H, S) f32.
    Deterministic: two calls are bitwise equal.  Raises on any input the
    kernels do not take and on a failed launch; counts launches in
    ``flash_attention_bwd_cuda.launches``."""
    dev = q.device
    _check(dev.type == "cuda", "q is not a CUDA tensor")
    _check(q.dtype in _DTYPES, f"dtype {q.dtype} (float32 or bfloat16)")
    _check(q.dim() == 4 and k.dim() == 4, "q (B, S, H, D), k (B, S, KV, D)")
    b, s, h, d = q.shape
    kvh = k.shape[2]
    check_heads(_check, h, kvh, d)
    check_backward(q, k, q_offset)
    for name, x, shape in (("k", k, (b, s, kvh, d)), ("v", v, (b, s, kvh, d)),
                           ("out", out, (b, s, h, d)),
                           ("dout", dout, (b, s, h, d))):
        _check(x.device == dev and x.dtype == q.dtype
               and tuple(x.shape) == shape,
               f"{name} must be a {q.dtype} {shape} tensor on {dev}")
    _check(lse.device == dev and lse.dtype == torch.float32
           and tuple(lse.shape) == (b, h, s),
           f"lse must be f32 ({b}, {h}, {s})")
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout), ("lse", lse)):
        _check(x.is_contiguous(), f"{name} must be contiguous")
        _check(x.data_ptr() % 16 == 0, f"{name} is not 16-byte aligned")
    stream = torch.cuda.current_stream(dev).cuda_stream
    acc, counters = None, None
    if q.dtype == torch.bfloat16:
        ld_n, acc_n, ctr_n = bwd_scratch(b, s, kvh, h // kvh, d)
        # held until the launches are enqueued: freed earlier, a block
        # could come back as an output
        scratch = torch.empty(ld_n, dtype=torch.float32, device=dev)
        acc = torch.empty(acc_n, dtype=torch.float32, device=dev)
        counters = split_kv_tickets(dev, stream, ctr_n)
    else:
        scratch = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = build.build().fn("flash_attention_bwd")
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                None if acc is None else acc.data_ptr(),
                None if counters is None else counters.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype],
                b, s, h, kvh, d, int(q_offset),
                float(d ** -0.5 if logit_scale is None else logit_scale),
                stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward launch failed: {rc}")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable causal GQA attention: ``apply(q, k, v, q_offset,
    logit_scale)``.  On the card the forward kernel also stores the rows'
    log-sum-exp and the backward runs the backward kernels; on the CPU
    the plain versions.  q, k and v are made contiguous here (they may come
    from RoPE or a transposed view), as is the incoming dO."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, logit_scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if q.device.type == "cuda":
            check_backward(q, k, q_offset)
            lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                              dtype=torch.float32, device=q.device)
            out = flash_attention_cuda(q, k, v, q_offset=q_offset,
                                       logit_scale=logit_scale, lse=lse)
        else:
            out = flash_attention_ref(q, k, v, q_offset=q_offset,
                                      logit_scale=logit_scale)
            lse = flash_attention_lse_ref(q, k, q_offset=q_offset,
                                          logit_scale=logit_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.q_offset, ctx.logit_scale = q_offset, logit_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        fn = flash_attention_bwd_cuda if q.device.type == "cuda" \
            else flash_attention_bwd_ref
        dq, dk, dv = fn(q, k, v, out, lse, dout.contiguous(),
                        q_offset=ctx.q_offset, logit_scale=ctx.logit_scale)
        return dq, dk, dv, None, None
