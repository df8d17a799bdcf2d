"""The port's CUDA kernels and engine on the card, held against the plain
PyTorch versions.  Every test here needs a CUDA card and skips without one;
run them on the card with ``python -m pytest -q -m gpu
tests/test_torch_cuda.py``.  The file imports no JAX, so it runs where
only PyTorch is installed.

Tolerances: rtol 1e-5 / atol 2e-5 for f32 attention and 2e-2 in bf16 (as
for the JAX kernels); 1e-4 for f32 SwiGLU, as ``tests/test_kernels.py``
holds the Pallas SwiGLU; the selective scan at 1e-5 in f32 (the N states
summed in another order) and, with bf16 x, b and c, y at one output
rounding (1e-3 + 1e-2·|ref|) and the f32 final state at 1e-5; the fused
overlap's GEMM at 1e-4 in f32 (sums over K in another order) and 2e-2 in
bf16, its outputs bitwise equal across ``gemm_fraction``; packed attention
on the engine-shaped streams in bf16 at one output rounding (1e-3 +
1e-2·|ref|, as ``chip_smoke.py`` holds it).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import FFN_DENSE, get_config, scale_down
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.kernels import packed_attention as pa
from repro_torch.kernels import ssm_scan as ssm_scan_mod
from repro_torch.kernels.decode_attention import (
    decode_attention_cuda, decode_attention_ref, paged_decode_attention_cuda,
    paged_decode_attention_ref)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_ref)
from repro_torch.kernels.fused_overlap import (fused_overlap_cuda,
                                               fused_overlap_ref)
from repro_torch.kernels.packed_attention import (packed_attention_cuda,
                                                  packed_attention_ref)
from repro_torch.kernels.ssm_scan import ssm_scan_cuda, ssm_scan_ref
from repro_torch.kernels.swiglu import swiglu_cuda, swiglu_ref
from repro_torch.models import model
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.request import Request

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

pytestmark = pytest.mark.gpu


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-5, atol=2e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group,d", [(1, 64), (4, 128), (8, 128), (2, 256),
                                     (3, 128), (7, 128), (9, 128)])
def test_packed_attention_kernel(cuda, group, d, dtype):
    """33 tokens over 4 slots of 300 rows, ragged bucket of 257."""
    rng = np.random.default_rng(group + d)
    t, n, s, kv = 33, 4, 300, 2
    q = rng.normal(size=(t, kv * group, d))
    k = rng.normal(size=(n, s, kv, d))
    v = rng.normal(size=(n, s, kv, d))
    args = [torch.from_numpy(a.astype(np.float32)).to(cuda, TORCH[dtype])
            for a in (q, k, v)]
    args += [torch.from_numpy(rng.integers(0, n, t).astype(np.int32)).to(cuda),
             torch.from_numpy(rng.integers(1, 258, t).astype(np.int32)).to(cuda)]
    before = packed_attention_cuda.launches["packed_attention"]
    out = packed_attention_cuda(*args, kv_bucket=257)
    torch.cuda.synchronize()
    assert packed_attention_cuda.launches["packed_attention"] == before + 1
    want = packed_attention_ref(*args, kv_bucket=257)
    torch.testing.assert_close(out.float(), want.float(), **_tol(dtype))


def _variant_args(cuda, variant, group, d, t=33, n=4, s=320, kv=2, bs=16):
    """f32 q over caches of ``variant`` on the card: int8 codes with f32
    scales for the quantized variants, a shuffled physical-block table over
    the N·S rows for the block-table ones."""
    rng = np.random.default_rng(group * d)
    f32 = dict(device=cuda, dtype=torch.float32)
    q = torch.tensor(rng.normal(size=(t, kv * group, d)), **f32)
    kw = {}
    if "quant" in variant:
        k, v = (torch.tensor(rng.integers(-127, 128, (n, s, kv, d)),
                             dtype=torch.int8, device=cuda) for _ in range(2))
        kw["k_scale"], kw["v_scale"] = (
            torch.tensor(rng.uniform(1e-3, 2e-2, (n, s, kv)), **f32)
            for _ in range(2))
    else:
        k, v = (torch.tensor(rng.normal(size=(n, s, kv, d)), **f32)
                for _ in range(2))
    if "block" in variant:
        kw["block_tables"] = torch.tensor(
            rng.permutation(n * s // bs).reshape(n, s // bs),
            dtype=torch.int32, device=cuda)
    slot = torch.tensor(rng.integers(0, n, t), dtype=torch.int32, device=cuda)
    lens = torch.tensor(rng.integers(1, 289, t), dtype=torch.int32,
                        device=cuda)
    return (q, k, v, slot, lens), kw


@pytest.mark.parametrize("variant", ["packed_attention_quant",
                                     "packed_attention_block",
                                     "packed_attention_block_quant"])
@pytest.mark.parametrize("group,d", [(1, 64), (4, 128), (8, 128), (3, 128),
                                     (7, 128), (9, 128)])
def test_packed_attention_variant_kernels(cuda, variant, group, d):
    """The int8, block-table and block-table + int8 kernels against the
    plain version in f32 (dequantization is exact in f32, so only the
    summation order differs), 33 tokens over 4 slots, bucket 288 = 18
    blocks of 16."""
    args, kw = _variant_args(cuda, variant, group, d)
    before = packed_attention_cuda.launches[variant]
    out = packed_attention_cuda(*args, kv_bucket=288, **kw)
    torch.cuda.synchronize()
    assert packed_attention_cuda.launches[variant] == before + 1
    want = packed_attention_ref(*args, kv_bucket=288, **kw)
    torch.testing.assert_close(out, want, **_tol("float32"))


def test_packed_attention_wrapper_raises_instead_of_falling_back(cuda):
    """A scale leaf the kernel cannot read in place (KV heads not unit
    stride) and a block-table sweep that is not whole blocks raise, and
    nothing launches."""
    args, kw = _variant_args(cuda, "packed_attention_block_quant", 2, 64)
    before = dict(packed_attention_cuda.launches)
    ks = kw["k_scale"]
    strided = ks.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="k_scale rows"):
        packed_attention_cuda(*args, kv_bucket=288,
                              **dict(kw, k_scale=strided, v_scale=strided))
    with pytest.raises(ValueError, match="multiple of the block size"):
        packed_attention_cuda(*args, kv_bucket=280, **kw)
    quant = {k: kw[k] for k in ("k_scale", "v_scale")}
    with pytest.raises(ValueError, match="must be"):
        packed_attention_cuda(args[0], args[0].new_zeros(args[1].shape),
                              *args[2:], kv_bucket=288, **quant)
    assert packed_attention_cuda.launches == before


# Streams shaped as the engine packs them (decode tokens, then prefill
# chunks as runs of one slot), and the edges of the tile kernel's runs:
#   engine   5 decode tokens, a chunk of 2 * tq + 3 tokens at positions
#            149.. (its tiles cross the group boundaries), a chunk of
#            tq // 2 + 1 tokens from position 0 (stops short of one), then
#            the engine's padding (slot 0, length 1) after a chunk of slot 0
#   split    a run of one slot cut by another slot, then resumed
#   shuffled a run of one slot whose lengths are not consecutive
#   padding  tokens of an out-of-range slot (-1 and N) and of length 0,
#            inside and between runs
#   bucket   lengths past the sweep (kv_bucket 160 < lengths up to 300)
#   empty    T = 0
# Slots are in [0, 6) over 320-row caches; the sweep is 288 = 18 blocks of
# 16 rows except in ``bucket``.
SEGMENTED = ("engine", "split", "shuffled", "padding", "bucket", "empty")
SEG_SLOTS, SEG_ROWS, SEG_BLOCK = 6, 320, 16


def segmented_stream(case: str, group: int, seed: int = 0):
    """(token_slot, lengths, kv_bucket) of one case as int32 numpy arrays;
    ``tq`` (``tile_plan``'s: the largest power of two with tq x group <=
    64) is the tile kernel's tokens per group."""
    rng = np.random.default_rng(seed)
    tq = pa.tile_plan(1, group, 64)[0]
    slot, lens = [], []

    def run(sl, ls):
        slot.extend([sl] * len(ls))
        lens.extend(int(x) for x in ls)

    bucket = 288
    if case == "engine":
        for sl in range(5):
            run(sl, [int(rng.integers(200, 289))])
        n = 2 * tq + 3
        run(5, range(150, 150 + n))
        run(0, range(1, tq // 2 + 2))
        run(0, [1, 1, 1])
    elif case == "split":
        run(2, range(40, 43))
        run(1, [250])
        run(2, range(43, 47))
        run(3, range(1, 2 * tq))
        run(4, [7])
        run(3, range(2 * tq, 2 * tq + 5))
    elif case == "shuffled":
        run(1, [99])
        run(3, rng.permutation(np.arange(1, 2 * tq + 1)) * 2 + 17)
        run(2, [50, 7, 288, 1, 33])
    elif case == "padding":
        run(4, range(100, 100 + tq + 2))
        run(4, [0])
        run(-1, [5, 9])
        run(4, range(100 + tq + 2, 100 + tq + 6))
        run(SEG_SLOTS, [3])
        run(1, [0, 0])
        run(0, [260])
    elif case == "bucket":
        bucket = 160
        run(0, [300])
        run(1, [160])
        run(2, range(150, 150 + tq + 4))
        run(3, rng.integers(1, 301, 6))
    elif case != "empty":
        raise ValueError(case)
    return (np.asarray(slot, np.int32), np.asarray(lens, np.int32), bucket)


def segmented_operands(variant: str, group: int, d: int, seed: int = 0,
                       kv: int = 2):
    """Caches of one packed-attention variant as numpy arrays (f32, or
    int8 codes with f32 (N, S, KV) scales) and, for the block-table
    variants, a shuffled (N, S / 16) table over the N·S rows."""
    rng = np.random.default_rng(seed + 7 * group + d)
    n, s = SEG_SLOTS, SEG_ROWS
    kw = {}
    if "quant" in variant:
        k, v = (rng.integers(-127, 128, (n, s, kv, d)).astype(np.int8)
                for _ in range(2))
        kw["k_scale"], kw["v_scale"] = (
            rng.uniform(1e-3, 2e-2, (n, s, kv)).astype(np.float32)
            for _ in range(2))
    else:
        k, v = (rng.normal(size=(n, s, kv, d)).astype(np.float32)
                for _ in range(2))
    if "block" in variant:
        kw["block_tables"] = rng.permutation(n * s // SEG_BLOCK).astype(
            np.int32).reshape(n, s // SEG_BLOCK)
    return k, v, kw


def _segmented_case(cuda, case, variant, group, d, dtype, seed=0):
    slot, lens, bucket = segmented_stream(case, group, seed)
    k, v, kw = segmented_operands(variant, group, d, seed)
    rng = np.random.default_rng(seed + 1)
    q = rng.normal(size=(len(slot), 2 * group, d)).astype(np.float32)
    dt = TORCH[dtype]
    q = torch.from_numpy(q).to(cuda, dt)
    k, v = (torch.from_numpy(x).to(cuda) for x in (k, v))
    if k.dtype == torch.float32:
        k, v = k.to(dt), v.to(dt)
    kw = {name: torch.from_numpy(x).to(cuda) for name, x in kw.items()}
    args = (q, k, v, torch.from_numpy(slot).to(cuda),
            torch.from_numpy(lens).to(cuda))
    return args, kw, bucket


def _segmented_want(args, kw, bucket):
    """The plain version on the tokens it defines (slot in range, length
    >= 1); zeros for the others, as the kernel's contract says."""
    q, k, v, slot, lens = args
    want = torch.zeros_like(q)
    ok = (slot >= 0) & (slot < k.shape[0]) & (lens > 0)
    if bool(ok.any()):
        want[ok] = packed_attention_ref(q[ok], k, v, slot[ok], lens[ok],
                                        kv_bucket=bucket, **kw)
    return want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("variant", ["packed_attention",
                                     "packed_attention_quant",
                                     "packed_attention_block",
                                     "packed_attention_block_quant"])
@pytest.mark.parametrize("case", SEGMENTED)
def test_packed_attention_segmented_streams(cuda, case, variant, group, d,
                                            dtype):
    """Every variant on streams shaped as the engine packs them and on the
    tile kernel's edges (see ``segmented_stream``), against the plain
    version: bf16 q on the tensor cores (int8 caches stay int8 codes), f32
    q on the CUDA cores from the same tiles, chunks and merge."""
    args, kw, bucket = _segmented_case(cuda, case, variant, group, d, dtype)
    before = packed_attention_cuda.launches[variant]
    out = packed_attention_cuda(*args, kv_bucket=bucket, **kw)
    torch.cuda.synchronize()
    assert packed_attention_cuda.launches[variant] == before + 1
    assert out.shape == args[0].shape and out.dtype == args[0].dtype
    want = _segmented_want(args, kw, bucket)
    tol = dict(atol=1e-3, rtol=1e-2) if dtype == "bfloat16" else _tol(dtype)
    torch.testing.assert_close(out.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [3, 7, 9])
@pytest.mark.parametrize("variant", ["packed_attention",
                                     "packed_attention_quant",
                                     "packed_attention_block",
                                     "packed_attention_block_quant"])
@pytest.mark.parametrize("case", SEGMENTED)
def test_packed_attention_segmented_streams_groups_3_7_9(cuda, case, variant,
                                                         group, dtype):
    """The segmented streams at the groups built for head_dim 128 only,
    whose tiles hold tq = 16, 8 and 4 tokens (48, 56 and 36 of 64 rows)."""
    test_packed_attention_segmented_streams(cuda, case, variant, group, 128,
                                            dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["packed_attention",
                                     "packed_attention_quant",
                                     "packed_attention_block",
                                     "packed_attention_block_quant"])
def test_packed_attention_tiles_are_deterministic(cuda, variant, dtype):
    """Two launches of the tile kernel on the engine-shaped stream give
    bitwise-equal outputs: a tile's chunks merge in chunk order whichever
    CTA takes the last ticket, and every ticket is left 0."""
    args, kw, bucket = _segmented_case(cuda, "engine", variant, 4, 128,
                                       dtype, seed=3)
    first = packed_attention_cuda(*args, kv_bucket=bucket, **kw)
    second = packed_attention_cuda(*args, kv_bucket=bucket, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert int(da._TICKETS[(first.device, stream)].abs().sum()) == 0


def _normal(rng, cuda, dtype, *shape):
    return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                        device=cuda).to(TORCH[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group,d", [(1, 64), (4, 128), (8, 128), (2, 256),
                                     (3, 128), (7, 128), (9, 128)])
def test_flash_attention_kernel(cuda, group, d, dtype):
    """Per-row offsets 0, 100 and 250 for a 37-query chunk over the
    280-row slot views of a 4-slot cache (strided rows; the last chunk
    runs past the view), then the recompute shape (int offset 0, Sq ==
    Skv = 77), against the plain version."""
    rng = np.random.default_rng(group + d)
    kv = 2
    cache_k = _normal(rng, cuda, dtype, 4, 300, kv, d)
    cache_v = _normal(rng, cuda, dtype, 4, 300, kv, d)
    k, v = cache_k[1:, :280], cache_v[1:, :280]
    q = _normal(rng, cuda, dtype, 3, 37, kv * group, d)
    off = torch.tensor([0, 100, 250], dtype=torch.int32, device=cuda)
    before = flash_attention_cuda.launches
    out = flash_attention_cuda(q, k, v, q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    torch.testing.assert_close(out.float(), flash_attention_ref(
        q, k, v, q_offset=off).float(), **_tol(dtype))
    q, k, v = (_normal(rng, cuda, dtype, 2, 77, h, d)
               for h in (kv * group, kv, kv))
    torch.testing.assert_close(flash_attention_cuda(q, k, v).float(),
                               flash_attention_ref(q, k, v).float(),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_stale_rows_never_reach_the_output(cuda, dtype):
    """Rows of the slot views past each batch row's causal end hold NaN
    (another request's rows or uninitialised cache): the output is finite
    and equals the plain version on the clean views.  The causal ends
    (37 + offset) fall inside a 64-key stage, whose boxes TMA loads
    whole."""
    rng = np.random.default_rng(21)
    kv, d, group, sq = 2, 128, 4, 37
    cache_k = _normal(rng, cuda, dtype, 4, 300, kv, d)
    cache_v = _normal(rng, cuda, dtype, 4, 300, kv, d)
    q = _normal(rng, cuda, dtype, 3, sq, kv * group, d)
    offsets = [0, 100, 203]
    off = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    want = flash_attention_ref(q, cache_k[1:], cache_v[1:], q_offset=off)
    for i, o in enumerate(offsets):
        cache_k[1 + i, o + sq:] = float("nan")
        cache_v[1 + i, o + sq:] = float("nan")
    out = flash_attention_cuda(q, cache_k[1:], cache_v[1:], q_offset=off)
    torch.cuda.synchronize()
    assert bool(out.float().isfinite().all())
    torch.testing.assert_close(out.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_flash_attention_bf16_ragged_shapes(cuda, group, d):
    """Every bf16 instantiation at a ragged Sq (not a multiple of 64 /
    group positions), with offsets whose causal ends are not multiples of
    the 64-key stage, and with Skv below one stage, against the plain
    version."""
    rng = np.random.default_rng(group * 1000 + d)
    kv, sq = 2, 64 // group + 3
    k = _normal(rng, cuda, "bfloat16", 3, 330, kv, d)[:, :301]
    v = _normal(rng, cuda, "bfloat16", 3, 330, kv, d)[:, :301]
    q = _normal(rng, cuda, "bfloat16", 3, sq, kv * group, d)
    off = torch.tensor([5, 130, 301 - sq], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(
        flash_attention_cuda(q, k, v, q_offset=off).float(),
        flash_attention_ref(q, k, v, q_offset=off).float(),
        **_tol("bfloat16"))
    q, k, v = (_normal(rng, cuda, "bfloat16", 2, 29, h, d)
               for h in (kv * group, kv, kv))
    torch.testing.assert_close(flash_attention_cuda(q, k, v).float(),
                               flash_attention_ref(q, k, v).float(),
                               **_tol("bfloat16"))


@pytest.mark.parametrize("group", [3, 7, 9])
def test_flash_attention_bf16_ragged_shapes_groups_3_7_9(cuda, group):
    """The ragged shapes at the groups built for head_dim 128 only, whose
    tiles hold 21, 9 and 7 positions (63 of 64 rows: the last is never
    stored)."""
    test_flash_attention_bf16_ragged_shapes(cuda, group, 128)


@pytest.mark.parametrize("group,d", [(4, 128), (8, 256), (7, 128)])
def test_flash_attention_split_tiles_merge_in_order(cuda, group, d):
    """A 256-token chunk at device offset 1536 over a 2048-row view of one
    KV head: the plan splits each tile's keys into several chunks, merged
    by the last one; two calls are bitwise equal, each counts one launch,
    and the tickets are back at 0.  The first call runs on an emptied
    pool, where an output of 1 MB (group 8, head_dim 256) would be carved
    from the partials' block if the wrapper freed it before the launch."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(17)
    kv = 1
    k = _normal(rng, cuda, "bfloat16", 2, 2048, kv, d)[1:]
    v = _normal(rng, cuda, "bfloat16", 2, 2048, kv, d)[1:]
    q = _normal(rng, cuda, "bfloat16", 1, 256, kv * group, d)
    off = torch.tensor([1536], dtype=torch.int32, device=cuda)
    want = flash_attention_ref(q, k, v, q_offset=off)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = flash_attention_cuda.launches
    first = flash_attention_cuda(q, k, v, q_offset=off)
    assert flash_attention_cuda.launches == before + 1
    second = flash_attention_cuda(q, k, v, q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 2
    q_tiles, chunk, n_chunks, ctas = fa.launch.schedule
    assert n_chunks > 1 and ctas == q_tiles * kv * n_chunks
    live = [it for it in fa.items(fa.launch.schedule[:3], 1, 256, 2048, kv,
                                  group, [1536]) if it.k1 > it.k0]
    assert min(it.live for it in live) > 1
    assert torch.equal(first, second)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert int(da._TICKETS[(q.device, stream)].abs().sum()) == 0
    torch.testing.assert_close(first.float(), want.float(),
                               **_tol("bfloat16"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group,d", [(1, 64), (4, 128), (8, 128), (2, 256),
                                     (3, 128), (7, 128), (9, 128)])
def test_decode_attention_kernel(cuda, group, d, dtype):
    """5 slots of 300 rows with lengths 1, 299, 300 and S + 1 (a decode at
    a full slot attends all S rows) and 57, against the plain version."""
    rng = np.random.default_rng(group * d)
    kv = 2
    q = _normal(rng, cuda, dtype, 5, kv * group, d)
    k = _normal(rng, cuda, dtype, 5, 300, kv, d)
    v = _normal(rng, cuda, dtype, 5, 300, kv, d)
    clen = torch.tensor([1, 299, 300, 301, 57], dtype=torch.int32,
                        device=cuda)
    before = decode_attention_cuda.launches
    out = decode_attention_cuda(q, k, v, clen)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == before + 1
    torch.testing.assert_close(out.float(), decode_attention_ref(
        q, k, v, clen).float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group,d", [(1, 64), (4, 128), (8, 128), (2, 256),
                                     (3, 128), (7, 128), (9, 128)])
def test_decode_attention_chunk_edges(cuda, group, d, dtype):
    """Lengths at every edge of the split-KV chunks: 1, C - 1, C, C + 1, S
    and S + 1 over an S-row cache of several chunks, against the plain
    version; the launch covers B x KV x ceil(S / C) units."""
    c, s, kv = da.CHUNK, 300, 2
    rng = np.random.default_rng(group * d + 1)
    lens = [1, c - 1, c, c + 1, s, s + 1]
    q = _normal(rng, cuda, dtype, len(lens), kv * group, d)
    k = _normal(rng, cuda, dtype, len(lens), s, kv, d)
    v = _normal(rng, cuda, dtype, len(lens), s, kv, d)
    clen = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out = decode_attention_cuda(q, k, v, clen)
    torch.cuda.synchronize()
    assert da.launch.units == (len(lens) * kv * -(-s // c), c)
    torch.testing.assert_close(out.float(), decode_attention_ref(
        q, k, v, clen).float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_ticket_buffer_grows(cuda, dtype):
    """A launch over 64 rows after one over 2 needs more (row, KV head)
    tickets than the stream's buffer holds: it grows, and both launches and
    a third over 2 rows match the plain version (every ticket was left
    0)."""
    rng = np.random.default_rng(5)
    kv, s = 8, 700
    for b in (2, 64, 2):
        q = _normal(rng, cuda, dtype, b, kv * 4, 128)
        k = _normal(rng, cuda, dtype, b, s, kv, 128)
        v = _normal(rng, cuda, dtype, b, s, kv, 128)
        clen = torch.from_numpy(rng.integers(1, s + 1, b).astype(np.int32)
                                ).to(cuda)
        out = decode_attention_cuda(q, k, v, clen)
        torch.cuda.synchronize()
        stream = torch.cuda.current_stream(cuda).cuda_stream
        assert da._TICKETS[(q.device, stream)].numel() >= b * kv
        torch.testing.assert_close(out.float(), decode_attention_ref(
            q, k, v, clen).float(), **_tol(dtype))
    assert int(da._TICKETS[(q.device, stream)].abs().sum()) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_and_fused_share_one_ticket_buffer(cuda, dtype):
    """Decode and fused launches interleaved on one stream with no sync
    between them use the same per-stream tickets; each output still
    matches its plain version."""
    rng = np.random.default_rng(9)
    fused_args = _overlap_args(cuda, dtype, 70, 136, 200, b=5, s=1100)
    q, kc, vc = (_normal(rng, cuda, dtype, 6, 8, 128),
                 _normal(rng, cuda, dtype, 6, 500, 2, 128),
                 _normal(rng, cuda, dtype, 6, 500, 2, 128))
    clen = torch.tensor([1, 63, 64, 65, 499, 500], dtype=torch.int32,
                        device=cuda)
    outs = []
    for _ in range(3):
        outs.append(decode_attention_cuda(q, kc, vc, clen))
        outs.append(fused_overlap_cuda(*fused_args, gemm_fraction=0.25))
    torch.cuda.synchronize()
    want_d = decode_attention_ref(q, kc, vc, clen)
    want_g, want_a = fused_overlap_ref(*fused_args)
    gemm_tol = _tol(dtype) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4)
    for i in range(0, len(outs), 2):
        torch.testing.assert_close(outs[i].float(), want_d.float(),
                                   **_tol(dtype))
        go, ao = outs[i + 1]
        torch.testing.assert_close(go.float(), want_g.float(), **gemm_tol)
        torch.testing.assert_close(ao.float(), want_a.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_is_deterministic(cuda, dtype):
    """Two launches on the same inputs give bitwise-equal outputs: the
    chunks of a row merge in chunk order whichever CTA finishes last."""
    rng = np.random.default_rng(3)
    q = _normal(rng, cuda, dtype, 8, 32, 128)
    k = _normal(rng, cuda, dtype, 8, 1024, 8, 128)
    v = _normal(rng, cuda, dtype, 8, 1024, 8, 128)
    clen = torch.from_numpy(rng.integers(1, 1025, 8).astype(np.int32)
                            ).to(cuda)
    first = decode_attention_cuda(q, k, v, clen)
    second = decode_attention_cuda(q, k, v, clen)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_flash_and_decode_wrappers_raise_instead_of_falling_back(cuda):
    """d_v != d_qk, caches whose rows are not contiguous (KV, D) blocks, a
    host offset tensor and a decode over another number of slots raise,
    and nothing launches."""
    rng = np.random.default_rng(0)
    q = _normal(rng, cuda, "float32", 2, 9, 4, 64)
    k = _normal(rng, cuda, "float32", 2, 20, 2, 64)
    before = (flash_attention_cuda.launches, decode_attention_cuda.launches)
    with pytest.raises(ValueError, match="d_v != d_qk"):
        flash_attention_cuda(q, k, k[..., :32])
    with pytest.raises(ValueError, match="rows must hold"):
        flash_attention_cuda(q, k.transpose(2, 3).contiguous().transpose(
            2, 3), k)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention_cuda(q, k, k, q_offset=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="queries for"):
        decode_attention_cuda(q[:, 0], k[:1], k[:1],
                              torch.ones(2, dtype=torch.int32, device=cuda))
    assert (flash_attention_cuda.launches,
            decode_attention_cuda.launches) == before


def _paged_args(cuda, dtype, group, d, maxp, ps=16, kv=2, npages=40,
                seed=0):
    """5 rows over a shuffled pool of ``npages`` pages: lengths 1, one
    whole page, one row past a page edge, a partial last page and the full
    MAXP * PS (clipped to the table), distinct pages per row and -1 past
    each row's last page."""
    rng = np.random.default_rng(seed)
    q = _normal(rng, cuda, dtype, 5, kv * group, d)
    kp = _normal(rng, cuda, dtype, npages, ps, kv, d)
    vp = _normal(rng, cuda, dtype, npages, ps, kv, d)
    full = maxp * ps
    lens = [min(x, full) for x in (1, ps, ps + 1, full - ps // 2, full)]
    table = np.full((5, maxp), -1, np.int32)
    for i, n in enumerate(lens):
        used = -(-n // ps)
        table[i, :used] = rng.choice(npages, size=used, replace=False)
    return (q, kp, vp, torch.tensor(table, device=cuda),
            torch.tensor(lens, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("maxp", [1, 6])
@pytest.mark.parametrize("group,d", [(1, 64), (4, 128), (8, 128), (2, 256),
                                     (3, 128), (7, 128), (9, 128)])
def test_paged_decode_attention_kernel(cuda, group, d, maxp, dtype):
    """Ragged lengths, partial last pages and -1 padding, MAXP 1 and 6,
    against the plain version, through ``ops`` (the counter moves)."""
    args = _paged_args(cuda, dtype, group, d, maxp, seed=group * d + maxp)
    before = paged_decode_attention_cuda.launches
    out = ops.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert paged_decode_attention_cuda.launches == before + 1
    torch.testing.assert_close(out.float(), paged_decode_attention_ref(
        *args).float(), **_tol(dtype))


def test_paged_decode_attention_scale_hole_and_strides(cuda):
    """A ``logit_scale``, a -1 inside a row's length (reads page 0, as the
    JAX kernel does) and K and V pools read in place from one interleaved
    (NP, PS, 2, KV, D) buffer, against the plain version in f32."""
    q, kp, vp, table, lens = _paged_args(cuda, "float32", 4, 128, 6, seed=3)
    table[3, 1] = -1
    kvbuf = torch.stack([kp, vp], 2)
    kp, vp = kvbuf[:, :, 0], kvbuf[:, :, 1]
    assert not kp.is_contiguous()
    got = paged_decode_attention_cuda(q, kp, vp, table, lens,
                                      logit_scale=0.05)
    torch.testing.assert_close(got, paged_decode_attention_ref(
        q, kp, vp, table, lens, logit_scale=0.05), **_tol("float32"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group,d", [(1, 64), (4, 128), (8, 128), (2, 256),
                                     (3, 128), (7, 128), (9, 128)])
@pytest.mark.parametrize("ps,maxp", [(16, 10), (64, 4)])
def test_paged_decode_attention_page_edges(cuda, ps, maxp, group, d, dtype):
    """The unit's paged form: rows of exactly one page, of a page edge
    inside one stage of the unit (a stage holds 16-64 rows) and just past
    it, of a last page one row long, and of the whole table, through the
    split-KV launch of csrc/decode_attention.cu (units of 128 rows over
    MAXP * PS), against the plain version."""
    rng = np.random.default_rng(ps + group * d)
    kv, npages = 2, 60
    full = maxp * ps
    lens = [ps, ps + 1, 2 * ps - 1, 17, full - ps + 1, full]
    q = _normal(rng, cuda, dtype, len(lens), kv * group, d)
    kp = _normal(rng, cuda, dtype, npages, ps, kv, d)
    vp = _normal(rng, cuda, dtype, npages, ps, kv, d)
    table = np.full((len(lens), maxp), -1, np.int32)
    for i, n in enumerate(lens):
        used = -(-n // ps)
        table[i, :used] = rng.choice(npages, size=used, replace=False)
    args = (q, kp, vp, torch.tensor(table, device=cuda),
            torch.tensor(lens, dtype=torch.int32, device=cuda))
    before = paged_decode_attention_cuda.launches
    got = paged_decode_attention_cuda(*args)
    torch.cuda.synchronize()
    assert paged_decode_attention_cuda.launches == before + 1
    assert da.launch.units == (len(lens) * kv * -(-full // da.CHUNK),
                               da.CHUNK)
    torch.testing.assert_close(got.float(), paged_decode_attention_ref(
        *args).float(), **_tol(dtype))


def test_packed_attention_launch_takes_no_paged_decode(cuda):
    """Paged decode left csrc/packed_attention.cu: its launch refuses a
    stream without token slots, and nothing launches."""
    q, kp, vp, table, lens = _paged_args(cuda, "bfloat16", 4, 128, 6)
    before = dict(packed_attention_cuda.launches)
    for target in ("packed_attention_block", "packed_attention"):
        with pytest.raises(ValueError, match="token_slot"):
            pa.launch(target, q, kp, vp, None, lens, block_tables=table)
    assert packed_attention_cuda.launches == before


def _overlap_args(cuda, dtype, m, k, n, group=4, d=128, b=5, s=600, kv=2,
                  seed=0):
    """x (m, k) @ w (k, n) beside decode attention over 5 rows of an
    s-row cache: lengths 1, one chunk, one past a chunk edge, all s and
    one mid-chunk (units of 256 rows)."""
    rng = np.random.default_rng(seed)
    x = _normal(rng, cuda, dtype, m, k)
    w = (_normal(rng, cuda, "float32", k, n) / k ** 0.5).to(TORCH[dtype])
    q = _normal(rng, cuda, dtype, b, kv * group, d)
    kc = _normal(rng, cuda, dtype, b, s, kv, d)
    vc = _normal(rng, cuda, dtype, b, s, kv, d)
    lens = torch.tensor([1, 256, 257, s, 333][:b], dtype=torch.int32,
                        device=cuda)
    return x, w, q, kc, vc, lens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group,d", [(1, 64), (4, 128), (8, 128), (2, 256),
                                     (3, 128), (7, 128), (9, 128)])
@pytest.mark.parametrize("m,k,n", [(1, 8, 8), (70, 136, 200),
                                   (300, 264, 520)])
def test_fused_overlap_kernel(cuda, m, k, n, group, d, dtype):
    """Ragged M, N and K edges of the GEMM role's tiles (128 x 128 x 64
    in bf16, 64 x 64 x 16 in f32) beside multi-chunk attention rows,
    against the plain version, through ``ops`` (the counter moves)."""
    args = _overlap_args(cuda, dtype, m, k, n, group, d, seed=m + group)
    before = fused_overlap_cuda.launches
    go, ao = ops.fused_overlap(*args, gemm_fraction=0.5)
    torch.cuda.synchronize()
    assert fused_overlap_cuda.launches == before + 1
    want_g, want_a = fused_overlap_ref(*args)
    gemm_tol = _tol(dtype) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(go.float(), want_g.float(), **gemm_tol)
    torch.testing.assert_close(ao.float(), want_a.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_overlap_bitwise_across_fractions(cuda, dtype):
    """The outputs do not depend on the split: bitwise equal at every
    fraction, with one GEMM CTA or one attention CTA at the ends."""
    args = _overlap_args(cuda, dtype, 300, 264, 520, b=5, s=1100)
    first = None
    for frac in (0.125, 0.25, 0.5, 0.875, 1.0, 1e-6):
        outs = fused_overlap_cuda(*args, gemm_fraction=frac)
        n_ctas, n_gemm, _ = fused_overlap_cuda.schedule
        assert 1 <= n_gemm <= n_ctas - 1
        if first is None:
            first = outs
        for got, want in zip(outs, first):
            assert torch.equal(got, want), frac


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_overlap_one_side_empty(cuda, dtype):
    """With no attention rows every CTA takes GEMM tiles, with no GEMM
    rows every CTA takes attention units; each side still matches the
    plain version."""
    x, w, q, kc, vc, lens = _overlap_args(cuda, dtype, 70, 136, 200)
    go, ao = fused_overlap_cuda(x, w, q[:0], kc[:0], vc[:0], lens[:0])
    n_ctas, n_gemm, _ = fused_overlap_cuda.schedule
    assert n_gemm == n_ctas and ao.shape == (0,) + q.shape[1:]
    gemm_tol = _tol(dtype) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(go.float(), torch.matmul(
        x.float(), w.float()).to(x.dtype).float(), **gemm_tol)
    go, ao = fused_overlap_cuda(x[:0], w, q, kc, vc, lens)
    assert fused_overlap_cuda.schedule[1] == 0 and go.shape == (0, 200)
    torch.testing.assert_close(ao.float(), decode_attention_ref(
        q, kc, vc, lens).float(), **_tol(dtype))


def test_fused_overlap_wrapper_raises_instead_of_falling_back(cuda):
    """Mixed dtypes, a GEMM shape mismatch, bf16 K not a multiple of 8, a
    fraction outside (0, 1], a CPU operand and a wrong page table raise,
    and nothing launches."""
    x, w, q, kc, vc, lens = _overlap_args(cuda, "bfloat16", 16, 64, 64)
    before = (fused_overlap_cuda.launches, paged_decode_attention_cuda.launches)
    for bad in ((x.float(), w, q, kc, vc, lens),        # mixed dtypes
                (x, w[:32], q, kc, vc, lens),            # K mismatch
                (x[:, :60].contiguous(), w[:60].contiguous(), q, kc, vc,
                 lens),                                  # bf16 K % 8
                (x, w, q, kc, vc, lens.cpu()),
                (x, w, q, kc, vc, lens.long())):
        with pytest.raises(ValueError):
            fused_overlap_cuda(*bad)
    for frac in (0.0, 1.5):
        with pytest.raises(ValueError, match="gemm_fraction"):
            fused_overlap_cuda(x, w, q, kc, vc, lens, gemm_fraction=frac)
    pq, kp, vp, table, plens = _paged_args(cuda, "bfloat16", 4, 128, 6)
    for tbl in (table.long(), table[:4], table.t().contiguous()):
        with pytest.raises(ValueError, match="page_table"):
            paged_decode_attention_cuda(pq, kp, vp, tbl, plens)
    with pytest.raises(ValueError, match="must be"):
        paged_decode_attention_cuda(pq, kp.float(), vp, table, plens)
    with pytest.raises(ValueError, match="uniform flat row space"):
        paged_decode_attention_cuda(pq, kp[::2], vp[::2], table, plens)
    assert (fused_overlap_cuda.launches,
            paged_decode_attention_cuda.launches) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(1, 64, 64), (70, 136, 200),
                                   (257, 512, 96)])
def test_swiglu_kernel(cuda, m, k, n, dtype):
    rng = np.random.default_rng(m + k + n)
    x, wg, wu = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
                 .to(cuda) for sh in ((m, k), (k, n), (k, n)))
    x, wg, wu = (a.to(TORCH[dtype]).contiguous()
                 for a in (x, wg / k ** 0.5, wu / k ** 0.5))
    before = swiglu_cuda.launches
    out = swiglu_cuda(x, wg, wu)
    torch.cuda.synchronize()
    assert swiglu_cuda.launches == before + 1
    tol = _tol(dtype) if dtype == "bfloat16" else dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out.float(), swiglu_ref(x, wg, wu).float(),
                               **tol)


def _swiglu_args(cuda, m, k, n, dtype="bfloat16", seed=0):
    rng = np.random.default_rng(seed)
    x, wg, wu = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
                 .to(cuda) for sh in ((m, k), (k, n), (k, n)))
    return tuple(a.to(TORCH[dtype]).contiguous()
                 for a in (x, wg / k ** 0.5, wu / k ** 0.5))


@pytest.mark.parametrize("m", [1, 8, 16, 32, 63, 64, 65, 257])
@pytest.mark.parametrize("k,n", [(512, 384), (136, 200)])
def test_swiglu_bf16_rows_and_ragged_edges(cuda, m, k, n):
    """bf16 on the wgmma mainloop at every tile (the swap-AB tiles of 8,
    16, 32 and 64 rows up to M = 64, 128 x 128 above) and their edges; K =
    136 and N = 200 leave a partial K tile and a partial 64-column box of
    the swizzled MN-major weights, which TMA fills with zeros."""
    x, wg, wu = _swiglu_args(cuda, m, k, n, seed=m + k)
    out = swiglu_cuda(x, wg, wu)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), swiglu_ref(x, wg, wu).float(),
                               **_tol("bfloat16"))


def test_swiglu_bf16_every_row_count_a_serve_gives_it(cuda):
    """Every M the packed step's buckets, the legacy chunks and the
    recompute prefill give SwiGLU at Qwen3-8B's widths (1-300, then whole
    prompts), each against the plain version at one output rounding
    (chip_smoke's 1e-3 + 1e-2·|ref|)."""
    rng = np.random.default_rng(3)
    wg, wu = ((torch.from_numpy(rng.normal(size=(4096, 12288)).astype(
        np.float32)) / 64).to(cuda) for _ in range(2))
    wg16, wu16 = wg.to(torch.bfloat16), wu.to(torch.bfloat16)
    wg, wu = wg16.float(), wu16.float()
    xs = torch.from_numpy(rng.normal(size=(1024, 4096)).astype(
        np.float32)).to(cuda).to(torch.bfloat16)
    for m in list(range(1, 301)) + [384, 513, 545, 600, 1024]:
        x = xs[:m]
        got = swiglu_cuda(x, wg16, wu16).float()
        g, u = x.float() @ wg, x.float() @ wu
        want = (g * torch.sigmoid(g) * u).to(torch.bfloat16).float()
        bad = (got - want).abs() > 1e-3 + 1e-2 * want.abs()
        assert not bool(bad.any()), (m, float((got - want).abs().max()))


@pytest.mark.parametrize("m", [8, 256])
def test_swiglu_bf16_at_qwen3_8b_widths(cuda, m):
    """4096 -> 12288 at a decode batch (the swap-AB tile, 96 CTAs, one
    128-column strip each) and a prefill batch (48 groups of two CTAs, one
    per M tile, two strips each), twice in a row, bitwise the same both
    times."""
    x, wg, wu = _swiglu_args(cuda, m, 4096, 12288, seed=m)
    first = swiglu_cuda(x, wg, wu)
    again = swiglu_cuda(x, wg, wu)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    torch.testing.assert_close(first.float(), swiglu_ref(x, wg, wu).float(),
                               **_tol("bfloat16"))


def test_swiglu_wrapper_raises_instead_of_falling_back(cuda):
    """bf16 K or N not a multiple of 8, a misaligned base and K = 0 raise,
    and nothing launches."""
    x, wg, wu = _swiglu_args(cuda, 16, 64, 64)
    before = swiglu_cuda.launches
    flat = torch.empty(16 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    for bad in ((x[:, :60].contiguous(), wg[:60].contiguous(),
                 wu[:60].contiguous()),
                (x, wg[:, :60].contiguous(), wu[:, :60].contiguous()),
                (flat[1:].view(16, 64), wg, wu),
                (x[:, :0].contiguous(), wg[:0], wu[:0])):
        with pytest.raises(ValueError):
            swiglu_cuda(*bad)
    assert swiglu_cuda.launches == before


def test_fused_overlap_at_chip_smoke_shape_bitwise_across_fractions(cuda):
    """x (1024, 4096) @ w (4096, 4096), the O projection of a 1024-token
    nano-batch, beside decode attention: the wgmma GEMM role against the
    plain version, and both outputs bitwise equal at every fraction."""
    rng = np.random.default_rng(5)
    x = _normal(rng, cuda, "bfloat16", 1024, 4096)
    w = (_normal(rng, cuda, "float32", 4096, 4096) / 64).to(torch.bfloat16)
    _, _, q, kc, vc, lens = _overlap_args(cuda, "bfloat16", 8, 64, 64, group=4,
                                          d=128, b=5, s=1100, kv=8)
    args = (x, w, q, kc, vc, lens)
    first = None
    for frac in (0.125, 0.5, 0.75, 1.0):
        outs = fused_overlap_cuda(*args, gemm_fraction=frac)
        if first is None:
            first = outs
        for got, want in zip(outs, first):
            assert torch.equal(got, want), frac
    torch.cuda.synchronize()
    want_g, want_a = fused_overlap_ref(*args)
    torch.testing.assert_close(first[0].float(), want_g.float(),
                               **_tol("bfloat16"))
    torch.testing.assert_close(first[1].float(), want_a.float(),
                               **_tol("bfloat16"))


@pytest.mark.parametrize("prefix,kv_dtype", [(False, "bf16"),
                                             (False, "int8"),
                                             (True, "bf16"), (True, "int8")])
def test_engine_on_card_matches_cpu(cuda, prefix, kv_dtype):
    """tiny-toy in f32: the engine on the card (the KV mode's attention
    kernel and SwiGLU) serves the same greedy tokens as the engine on the
    CPU (plain versions), in each of the four KV modes."""
    cfg = dataclasses.replace(get_config("tiny-toy"), dtype="float32")
    params = model.init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, 20)]
               for _ in range(6)]
    outs = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        eng = ServeEngine(cfg, p, EngineConfig(
            max_slots=4, max_len=64, discrete_sizes=(32, 16, 8),
            avg_decode_len=4, kv_block_size=8, prefix_caching=prefix,
            kv_dtype=kv_dtype), device=dev)
        for i, pr in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=pr, max_new_tokens=6))
        outs[dev] = {r.rid: r.output for r in eng.run()}
        assert eng.stats.dispatches_per_iter == eng.stats.syncs_per_iter == 1.0
    assert outs["cuda"] == outs["cpu"] and len(outs["cpu"]) == 6


@pytest.mark.parametrize("mode", [dict(step_mode="legacy"),
                                  dict(prefill_mode="recompute")])
def test_legacy_engine_on_card_matches_cpu(cuda, mode):
    """tiny-toy in f32: the legacy step (incremental or recompute prefill)
    on the card, through the flash and decode attention kernels, serves
    the same greedy tokens as on the CPU, with slot reuse."""
    cfg = dataclasses.replace(get_config("tiny-toy"), dtype="float32")
    params = model.init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                             int(rng.integers(3, 40)))]
               for _ in range(6)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, _to(params, dev), EngineConfig(
            max_slots=2, max_len=64, discrete_sizes=(16, 8),
            avg_decode_len=4, **mode), device=dev)
        for i, pr in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=pr, max_new_tokens=6))
        before = (flash_attention_cuda.launches,
                  decode_attention_cuda.launches)
        outs[dev] = {r.rid: r.output for r in eng.run()}
        launched = (flash_attention_cuda.launches - before[0],
                    decode_attention_cuda.launches - before[1])
        assert (min(launched) > 0) == (dev == "cuda"), launched
        assert eng.stats.dispatches_per_iter > 1.0
    assert outs["cuda"] == outs["cpu"] and len(outs["cpu"]) == 6


def test_sampling_bits_on_card_equal_cpu(cuda):
    """The sampler's threefry bits depend on (seed, rid, pos, index)
    only: equal on the card and on the CPU, over a whole vocab and at
    gathered indices."""
    from repro_torch.serving import sampling
    keys = sampling.packed_keys(77, torch.arange(6).repeat_interleave(5),
                                torch.arange(5).repeat(6) + 1000, 2049)
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, 5003,
                                                             (30, 50)))
    for index in (5003, idx):
        dev_index = index if isinstance(index, int) else index.to(cuda)
        assert torch.equal(
            sampling.random_bits(keys.to(cuda), dev_index).cpu(),
            sampling.random_bits(keys, index))


@pytest.mark.parametrize("kw", [
    dict(async_depth=2, async_harvest=False),
    dict(spec_k=2),
    dict(spec_k=3, prefix_caching=True, kv_block_size=8),
    dict(spec_k=2, kv_dtype="int8"),
    dict(spec_k=2, prefix_caching=True, kv_block_size=8, kv_dtype="int8"),
    dict(temperature=0.8, top_k=8),
    dict(temperature=0.8, spec_k=2),
], ids=["depth2", "spec", "spec-prefix", "spec-int8", "spec-prefix-int8",
        "topk", "spec-sample"])
def test_engine_pipeline_spec_sampling_on_card_matches_cpu(cuda, kw):
    """tiny-toy in f32: the async pipeline, speculative decoding and
    sampling on the card serve the tokens the CPU serves, with one
    dispatch and one deferred copy an iteration and nothing in flight at
    exit."""
    cfg = dataclasses.replace(get_config("tiny-toy"), dtype="float32")
    params = model.init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [[5, 9, 3, 7] * 5] + [
        [int(t) for t in rng.integers(0, cfg.vocab_size,
                                      int(rng.integers(3, 30)))]
        for _ in range(4)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, _to(params, dev), EngineConfig(
            max_slots=2, max_len=64, discrete_sizes=(16, 8),
            avg_decode_len=4, **kw), device=dev)
        for i, pr in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=pr, max_new_tokens=8))
        outs[dev] = {r.rid: r.output for r in eng.run()}
        assert eng.stats.dispatches_per_iter == eng.stats.syncs_per_iter == 1.0
        assert eng.in_flight == 0
    assert outs["cuda"] == outs["cpu"] and len(outs["cpu"]) == 5


def _scan_args(cuda, dtype, bsz, s, ch, n=16, h0=True, seed=0):
    """Selective-scan inputs on the card at a Mamba layer's magnitudes:
    x, b and c in ``dtype``; dt, a, d and h0 in f32."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=cuda)
    x = f32(rng.normal(size=(bsz, s, ch))).to(TORCH[dtype])
    dt = f32(np.log1p(np.exp(rng.normal(-2.0, 1.0, (bsz, s, ch)))))
    a = f32(-np.exp(rng.uniform(0.0, np.log(n), (ch, n))))
    b = f32(rng.normal(size=(bsz, s, n))).to(TORCH[dtype])
    c = f32(rng.normal(size=(bsz, s, n))).to(TORCH[dtype])
    d = f32(rng.normal(size=(ch,)))
    h = f32(rng.normal(size=(bsz, ch, n))) if h0 else None
    return x, dt, a, b, c, d, h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h0", [True, False], ids=["h0", "zeros"])
@pytest.mark.parametrize("s", [1, 8, 37])
@pytest.mark.parametrize("ch,n", [(70, 16), (200, 32), (33, 64)])
def test_ssm_scan_kernel(cuda, ch, n, s, h0, dtype):
    """Two batch rows, ragged channel counts (the kernel's blocks hold 64,
    32 and 16 channels at N 16, 32, 64), S across a 32-token tile edge,
    from a given and from a zero state, against the plain version."""
    args = _scan_args(cuda, dtype, 2, s, ch, n, h0, seed=s + ch)
    before = ssm_scan_cuda.launches
    y, h = ssm_scan_cuda(*args)
    torch.cuda.synchronize()
    assert ssm_scan_cuda.launches == before + 1
    want_y, want_h = ssm_scan_ref(*args)
    assert y.dtype == TORCH[dtype] and h.dtype == torch.float32
    tol = dict(rtol=1e-2, atol=1e-3) if dtype == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(y.float(), want_y.float(), **tol)
    torch.testing.assert_close(h, want_h, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 7, 9, 67, 600])
def test_ssm_scan_kernel_token_edges(cuda, s, dtype):
    """S of one token, across the 8-token group (7, 9) and two 32-token
    tiles (67), and a 600-token sweep from a carried state, over 300
    channels (a ragged edge of the 64-channel blocks)."""
    args = _scan_args(cuda, dtype, 1, s, 300, 16, True, seed=s)
    y, h = ssm_scan_cuda(*args)
    want_y, want_h = ssm_scan_ref(*args)
    tol = dict(rtol=1e-2, atol=1e-3) if dtype == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(y.float(), want_y.float(), **tol)
    torch.testing.assert_close(h, want_h, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ch,n", [(45, 32), (100, 32), (45, 64), (100, 64)])
def test_ssm_scan_kernel_wide_states_ragged_channels(cuda, ch, n, dtype):
    """N 32 and 64 (8 and 16 lanes a channel: the transpose-reduce ends in
    a butterfly at 16) over channel counts that end mid-block, two batch
    rows, 45 tokens from a carried state."""
    args = _scan_args(cuda, dtype, 2, 45, ch, n, True, seed=ch + n)
    y, h = ssm_scan_cuda(*args)
    want_y, want_h = ssm_scan_ref(*args)
    tol = dict(rtol=1e-2, atol=1e-3) if dtype == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(y.float(), want_y.float(), **tol)
    torch.testing.assert_close(h, want_h, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_kernel_underflowing_factors(cuda, dtype):
    """dt up to 20 against a in [-16, -1]: exp(dt * a) underflows to 0 for
    most (token, state) pairs, so the state restarts from the input."""
    x, dt, a, b, c, d, h0 = _scan_args(cuda, dtype, 1, 70, 130, 16, True,
                                       seed=5)
    rng = np.random.default_rng(6)
    dt = torch.tensor(rng.uniform(0.0, 20.0, dt.shape), dtype=torch.float32,
                      device=cuda)
    y, h = ssm_scan_cuda(x, dt, a, b, c, d, h0)
    want_y, want_h = ssm_scan_ref(x, dt, a, b, c, d, h0)
    tol = dict(rtol=1e-2, atol=1e-3) if dtype == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(y.float(), want_y.float(), **tol)
    torch.testing.assert_close(h, want_h, rtol=1e-5, atol=1e-5)


def test_ssm_scan_kernel_reads_projection_slices(cuda):
    """b and c as column slices of one (B, S, R + 2N) projection, as
    ``mamba_full`` passes them, without a copy."""
    x, dt, a, _, _, d, h = _scan_args(cuda, "bfloat16", 2, 40, 96)
    proj = torch.randn(2, 40, 8 + 32, device=cuda).to(torch.bfloat16)
    b, c = proj[..., 8:24], proj[..., 24:]
    assert not b.is_contiguous()
    y, hf = ssm_scan_cuda(x, dt, a, b, c, d, h)
    want_y, want_h = ssm_scan_ref(x, dt, a, b, c, d, h)
    torch.testing.assert_close(y.float(), want_y.float(), rtol=1e-2,
                               atol=1e-3)
    torch.testing.assert_close(hf, want_h, rtol=1e-5, atol=1e-5)


def test_ssm_scan_wrapper_never_reaches_the_plain_version(cuda, monkeypatch):
    """``ops.ssm_scan`` sends a CUDA tensor to the kernel (the plain version
    is made to fail and is never called); inputs the kernel does not take
    raise and launch nothing."""
    def refuse(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")
    monkeypatch.setattr(ops, "ssm_scan_ref", refuse)
    monkeypatch.setattr(ssm_scan_mod, "ssm_scan_ref", refuse)
    args = _scan_args(cuda, "float32", 1, 5, 64)
    before = ssm_scan_cuda.launches
    ops.ssm_scan(*args)
    torch.cuda.synchronize()
    assert ssm_scan_cuda.launches == before + 1
    x, dt, a, b, c, d, h = args
    for bad in ((x, dt.to(torch.bfloat16), a, b, c, d, h),   # dt not f32
                (x, dt, a[:, :8].contiguous(), b[..., :8], c[..., :8], d,
                 h[..., :8].contiguous()),                       # N 8
                (x, dt, a, b.to(torch.bfloat16), c, d, h),
                (x, dt, a, b, c, d, h.cpu())):
        with pytest.raises(ValueError):
            ops.ssm_scan(*bad)
    assert ssm_scan_cuda.launches == before + 1


@pytest.mark.parametrize("mode", [dict(step_mode="legacy"),
                                  dict(prefill_mode="recompute"),
                                  dict(step_mode="packed")])
def test_hybrid_engine_on_card_matches_cpu(cuda, mode):
    """Jamba's layer pattern at scaled-down width (d_model 256, 4 heads of
    64: a head size the attention kernels take) with dense FFNs, f32: each
    step on the card (the scan kernel on the prefill dispatches of the
    legacy and recompute steps, none on the packed step) serves the same
    greedy tokens as on the CPU, with slot reuse."""
    cfg = scale_down(get_config("jamba-1.5-large-398b"), d_model=256,
                     n_heads=4)
    cfg = dataclasses.replace(
        cfg, moe=None, dtype="float32",
        block_pattern=tuple(dataclasses.replace(sp, ffn=FFN_DENSE)
                            for sp in cfg.block_pattern))
    params = model.init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                             int(rng.integers(3, 40)))]
               for _ in range(6)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, _to(params, dev), EngineConfig(
            max_slots=2, max_len=64, discrete_sizes=(16, 8),
            avg_decode_len=4, **mode), device=dev)
        for i, pr in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=pr, max_new_tokens=6))
        before = ssm_scan_cuda.launches
        outs[dev] = {r.rid: r.output for r in eng.run()}
        scans = ssm_scan_cuda.launches - before
        assert (scans > 0) == (dev == "cuda" and eng.step_mode == "legacy")
    assert outs["cuda"] == outs["cpu"] and len(outs["cpu"]) == 6


@pytest.mark.parametrize("mode", [dict(step_mode="packed"),
                                  dict(step_mode="legacy")])
def test_arctic_engine_on_card_matches_cpu(cuda, mode):
    """Arctic's layers (routed experts beside the dense residual) at
    scaled-down width with its GQA group 7 at head_dim 128 (14 / 2 heads,
    a shape the attention kernels take), f32, ``capacity_factor`` 16 (no
    (token, expert) pair dropped): the packed step (packed attention) and
    the legacy step (flash and decode attention) on the card serve the
    same greedy tokens as on the CPU, with slot reuse."""
    cfg = scale_down(get_config("arctic-480b"), d_model=256)
    cfg = dataclasses.replace(
        cfg, n_heads=14, n_kv_heads=2, head_dim=128, dtype="float32",
        moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    assert cfg.gqa_group == 7
    params = model.init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                             int(rng.integers(3, 40)))]
               for _ in range(6)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, _to(params, dev), EngineConfig(
            max_slots=2, max_len=64, discrete_sizes=(16, 8),
            avg_decode_len=4, **mode), device=dev)
        for i, pr in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=pr, max_new_tokens=6))
        before = (sum(packed_attention_cuda.launches.values()),
                  flash_attention_cuda.launches, swiglu_cuda.launches)
        outs[dev] = {r.rid: r.output for r in eng.run()}
        launched = (sum(packed_attention_cuda.launches.values()) - before[0],
                    flash_attention_cuda.launches - before[1],
                    swiglu_cuda.launches - before[2])
        want_packed = dev == "cuda" and eng.step_mode == "packed"
        assert (launched[0] > 0) == want_packed, launched
        assert (launched[1] > 0) == (dev == "cuda" and not want_packed)
        assert (launched[2] > 0) == (dev == "cuda"), launched
    assert outs["cuda"] == outs["cpu"] and len(outs["cpu"]) == 6


def test_attention_wrappers_refuse_groups_3_7_9_off_head_dim_128(cuda):
    """Groups 3, 7 and 9 are built at head_dim 128 only: at 64 each of the
    five wrappers raises, naming the rule, and nothing launches."""
    from repro_torch.kernels import fused_overlap as fo
    rng = np.random.default_rng(0)
    d, kv, group = 64, 2, 7
    q = _normal(rng, cuda, "bfloat16", 4, kv * group, d)
    k = _normal(rng, cuda, "bfloat16", 4, 64, kv, d)
    lens = torch.full((4,), 9, dtype=torch.int32, device=cuda)
    slot = torch.arange(4, dtype=torch.int32, device=cuda)
    table = torch.zeros((4, 4), dtype=torch.int32, device=cuda)
    x = _normal(rng, cuda, "bfloat16", 8, 64)
    calls = [lambda: packed_attention_cuda(q, k, k, slot, lens),
             lambda: decode_attention_cuda(q, k, k, lens),
             lambda: paged_decode_attention_cuda(q, k[:, :16], k[:, :16],
                                                 table, lens),
             lambda: flash_attention_cuda(q[None], k[:1], k[:1]),
             lambda: fo.fused_overlap_cuda(x, x.T.contiguous(), q, k, k,
                                           lens)]
    for call in calls:
        with pytest.raises(ValueError, match="head_dim 128 only"):
            call()


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# ---- absorbed MLA's latent attention (csrc/mla_attention.cu) ---------------
MLA_SCALE = 192 ** -0.5      # DeepSeek-V2's (qk_nope_dim + qk_rope_dim)^-0.5


def _mla_operands(cuda, dtype, t, h, n, s, seed=0):
    """q (T, H, 576) and the latent leaves c_kv (N, S, 512), k_rope (N, S,
    64) as views of one (N·S + 1)-row store each, as the cache builds
    them."""
    from repro_torch.kernels import mla_attention as mla
    rng = np.random.default_rng(seed)
    q = _normal(rng, cuda, dtype, t, h, mla.RANK + mla.ROPE)
    leaves = []
    for width in (mla.RANK, mla.ROPE):
        store = _normal(rng, cuda, dtype, n * s + 1, width)
        leaves.append(store[:n * s].view(n, s, width))
    return q, leaves[0], leaves[1]


def _mla_stream(use, t_dec=4, n=5, s=300, seed=0):
    """(slot, lengths, kv_bucket, N, S) of one of the kernel's three uses:
    ``packed`` decode tokens then a 40- and a 17-token chunk at bucket 257
    (lengths past it clamp, a partial last stage); ``decode`` one token
    per row, lengths 1 ... S; ``chunk`` two rows of 37 queries at offsets
    100 and 280 (lengths past S clamp)."""
    rng = np.random.default_rng(seed)
    if use == "packed":
        slot = [0, 1, 2, 3][:t_dec] + [4] * 40 + [1] * 17
        lens = list(rng.integers(1, 300, t_dec)) + list(range(201, 241)) \
            + list(range(1, 18))
        return slot, lens, 257, n, s
    if use == "decode":
        return list(range(6)), [1, 33, 128, 129, 299, 300], None, 6, s
    offs = [100, 280]
    slot = [b for b in range(2) for _ in range(37)]
    lens = [o + i + 1 for o in offs for i in range(37)]
    return slot, lens, None, 2, s


def _mla_call(cuda, slot, lens):
    as_t = [torch.tensor(np.asarray(a, np.int32), device=cuda)
            for a in (slot, lens)]
    return as_t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [64, 128])
@pytest.mark.parametrize("use", ["packed", "decode", "chunk"])
def test_mla_attention_kernel(cuda, use, h, dtype):
    """Rank 512, rope 64, at 64 and 128 heads: the kernel against its plain
    version in its three uses (the decode batch's few items split the
    sweep over the SMs and merge)."""
    from repro_torch.kernels import mla_attention as mla
    slot, lens, bucket, n, s = _mla_stream(use)
    q, c_kv, k_rope = _mla_operands(cuda, dtype, len(slot), h, n, s)
    slot_t, lens_t = _mla_call(cuda, slot, lens)
    before = mla.mla_attention_cuda.launches
    out = mla.mla_attention_cuda(q, c_kv, k_rope, slot_t, lens_t,
                                 logit_scale=MLA_SCALE, kv_bucket=bucket)
    torch.cuda.synchronize()
    assert mla.mla_attention_cuda.launches == before + 1
    if use == "decode":
        assert mla.launch.schedule[1] > 1
    want = mla.mla_attention_ref(q, c_kv, k_rope, slot_t, lens_t,
                                 logit_scale=MLA_SCALE, kv_bucket=bucket)
    torch.testing.assert_close(out.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bucket", [0, 31, 32, 33, 63, 64, 65, 128, 300])
def test_mla_attention_bucket_edges_and_zeros(cuda, bucket, dtype):
    """``kv_bucket`` at and around the f32 kernel's 32-row stages and the
    bf16 kernel's 64-row ones (partial last stages), with tokens of
    out-of-range slots (-1 and N) and of lengths 0 and -2, which give
    zeros, beside ordinary ones; every split schedule (one chunk, chunks
    of one stage: 32 rows in f32, 64 in bf16) gives the same."""
    from repro_torch.kernels import mla_attention as mla
    slot = [0, -1, 3, 1, 2, 0, 1, 2]
    lens = [5, 9, 4, 0, -2, 300, 33, 32]
    q, c_kv, k_rope = _mla_operands(cuda, dtype, len(slot), 128, 3, 300, 1)
    slot_t, lens_t = _mla_call(cuda, slot, lens)
    want = mla.mla_attention_ref(q, c_kv, k_rope, slot_t, lens_t,
                                 logit_scale=MLA_SCALE, kv_bucket=bucket)
    sweep = bucket
    stage = mla.STAGE if dtype == "bfloat16" else mla.F32_STAGE
    for sched in (None, (max(stage, -(-sweep // stage) * stage), 1),
                  (stage, max(1, -(-sweep // stage)))):
        out = mla.launch(q, c_kv, k_rope, slot_t, lens_t,
                         logit_scale=MLA_SCALE, kv_bucket=bucket, sched=sched)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), want.float(), **_tol(dtype))
        zero = torch.tensor([1, 2, 3, 4], device=cuda)   # the undefined ones
        assert not out[zero].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [64, 128])
@pytest.mark.parametrize("sched", ["one chunk", "two chunks", "the most"])
def test_mla_attention_stage_edges(cuda, sched, h, dtype):
    """Lengths at the stages' edges (1, 31, 32, 33, 63, 64, 65, sweep - 1,
    sweep and past the sweep), a token each over its own slot of
    (N·S + 1)-row stores at a ragged bucket, under a forced schedule (one
    chunk, two, and the most: chunks of one stage, 32 rows in f32 and 64 in
    bf16, every chunk with rows merged); every cache row past its token's length is NaN.  The
    output is finite, equal to the plain version's on the cache without
    the NaN rows, and the same bit for bit from two launches."""
    from repro_torch.kernels import mla_attention as mla
    s, bucket = 320, 257
    lens = [1, 31, 32, 33, 63, 64, 65, bucket - 1, bucket, bucket + 20]
    n = len(lens)
    q, c_kv, k_rope = _mla_operands(cuda, dtype, n, h, n, s, seed=3)
    slot_t, lens_t = _mla_call(cuda, list(range(n)), lens)
    want = mla.mla_attention_ref(q, c_kv, k_rope, slot_t, lens_t,
                                 logit_scale=MLA_SCALE, kv_bucket=bucket)
    for b, length in enumerate(lens):
        c_kv[b, length:] = float("nan")
        k_rope[b, length:] = float("nan")
    stage = mla.STAGE if dtype == "bfloat16" else mla.F32_STAGE
    chunk = {"one chunk": -(-bucket // stage) * stage,
             "two chunks": -(-bucket // (2 * stage)) * stage,
             "the most": stage}[sched]
    plan = (chunk, -(-bucket // chunk))
    assert plan[1] == {"one chunk": 1, "two chunks": 2,
                       "the most": -(-bucket // stage)}[sched]
    outs = [mla.launch(q, c_kv, k_rope, slot_t, lens_t, logit_scale=MLA_SCALE,
                       kv_bucket=bucket, sched=plan) for _ in range(2)]
    torch.cuda.synchronize()
    assert bool(outs[0].isfinite().all())
    assert torch.equal(outs[0], outs[1])
    torch.testing.assert_close(outs[0].float(), want.float(), **_tol(dtype))


def test_mla_attention_refuses_unbuilt_shapes(cuda):
    """Other ranks, rope dims and head counts, half precision, a
    misaligned leaf, GQA-shaped caches: each raises with its reason and
    nothing launches; the three GQA kernels refuse d_v != d_qk, naming
    ops.mla_attention."""
    from repro_torch.kernels import mla_attention as mla
    slot_t, lens_t = _mla_call(cuda, [0, 1], [3, 4])
    q, c_kv, k_rope = _mla_operands(cuda, "bfloat16", 2, 64, 2, 64)
    before = mla.mla_attention_cuda.launches
    bad = {
        "kv_lora_rank": (q[..., :-64], c_kv[..., :-64], k_rope),
        "qk_rope_dim": (q[..., :-32], c_kv, k_rope[..., :32]),
        "heads": (torch.cat([q, q[:, :32]], 1), c_kv, k_rope),
        "float32 or bfloat16": (q.half(), c_kv.half(), k_rope.half()),
        "16-byte aligned": (q, c_kv.new_zeros(2 * 64 * 512 + 8)
                            [4:4 + 2 * 64 * 512].view(2, 64, 512), k_rope),
    }
    for what, args in bad.items():
        with pytest.raises(ValueError, match=what):
            mla.mla_attention_cuda(args[0].contiguous(), *args[1:], slot_t,
                                   lens_t, logit_scale=MLA_SCALE)
    assert mla.mla_attention_cuda.launches == before
    k = c_kv.new_zeros(2, 64, 1, 576)
    v = c_kv[:, :, None]
    with pytest.raises(ValueError, match="ops.mla_attention"):
        packed_attention_cuda(q, k, v, slot_t, lens_t)
    with pytest.raises(ValueError, match="ops.mla_attention"):
        flash_attention_cuda(q[None], k[:1], v[:1])
    with pytest.raises(ValueError, match="ops.mla_attention"):
        decode_attention_cuda(q, k, v, lens_t)


def _mla_small_config(**kw):
    """DeepSeek-V2's layers at a width the MLA kernel takes (64 heads, the
    full latent rank 512 and rope 64, a 16-wide nope and value head), f32,
    ``capacity_factor`` 16."""
    from repro_torch.configs import MLAConfig
    cfg = scale_down(get_config("deepseek-v2-236b"), d_model=256, n_heads=64,
                     **kw)
    return dataclasses.replace(
        cfg, dtype="float32",
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=48, qk_nope_dim=16,
                      qk_rope_dim=64, v_head_dim=16),
        moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))


@pytest.mark.parametrize("mode", [dict(step_mode="packed"),
                                  dict(step_mode="packed", kv_dtype="int8",
                                       kv_block_size=8, prefix_caching=True),
                                  dict(step_mode="legacy"),
                                  dict(prefill_mode="recompute")])
def test_mla_engine_on_card_matches_cpu(cuda, mode):
    """DeepSeek-V2's dense layer 0 and MoE layer 1 with MLA at a shape the
    kernel takes, f32: the packed step (contiguous; int8 with prefix
    caching), the legacy step and recompute prefill on the card serve the
    same greedy tokens as on the CPU, with slot reuse; the MLA kernel
    launches on the card and no GQA attention kernel does."""
    from repro_torch.kernels.mla_attention import mla_attention_cuda
    cfg = _mla_small_config()
    params = model.init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                             int(rng.integers(3, 40)))]
               for _ in range(6)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, _to(params, dev), EngineConfig(
            max_slots=2, max_len=64, discrete_sizes=(16, 8),
            avg_decode_len=4, **mode), device=dev)
        for i, pr in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=pr, max_new_tokens=6))
        gqa = (packed_attention_cuda, flash_attention_cuda,
               decode_attention_cuda)
        before = [sum(packed_attention_cuda.launches.values()),
                  flash_attention_cuda.launches,
                  decode_attention_cuda.launches, mla_attention_cuda.launches]
        outs[dev] = {r.rid: r.output for r in eng.run()}
        after = [sum(packed_attention_cuda.launches.values()),
                 flash_attention_cuda.launches,
                 decode_attention_cuda.launches, mla_attention_cuda.launches]
        assert after[:len(gqa)] == before[:len(gqa)]
        assert (after[3] > before[3]) == (dev == "cuda")
    assert outs["cuda"] == outs["cpu"] and len(outs["cpu"]) == 6


# ---- the remaining model families (xLSTM, ungated MLP, tied embeddings,
# the vision and audio stubs) and int8 KV on the hybrid ---------------------
# family -> (config, change after scale_down(d_model 256, 4 heads)): each
# attention family at its own GQA group and a head dim the kernels take
FAMILIES = {"starcoder2": ("starcoder2-7b",
                           dict(n_heads=9, n_kv_heads=1, head_dim=128)),
            "minitron": ("minitron-4b",
                         dict(n_heads=6, n_kv_heads=2, head_dim=128)),
            "llava": ("llava-next-34b",
                      dict(n_heads=14, n_kv_heads=2, head_dim=128)),
            "musicgen": ("musicgen-medium", {}),
            "tied": ("tiny-toy", dict(tie_embeddings=True)),
            "xlstm": ("xlstm-1.3b", {})}
FAMILY_CASES = [(f, "packed") for f in sorted(FAMILIES)] + \
    [(f, m) for f in ("musicgen", "xlstm") for m in ("legacy", "recompute")]
FAMILY_MODES = {"packed": dict(step_mode="packed"),
                "legacy": dict(step_mode="legacy"),
                "recompute": dict(prefill_mode="recompute")}


def _family_config(family):
    name, change = FAMILIES[family]
    cfg = get_config(name)
    if name != "tiny-toy":
        cfg = scale_down(cfg, d_model=256, n_heads=4)
    return dataclasses.replace(cfg, dtype="float32", **change)


@pytest.mark.parametrize("family,mode", FAMILY_CASES)
def test_family_engine_on_card_matches_cpu(cuda, family, mode):
    """Each family, f32, on the card serves the same greedy tokens as on
    the CPU, with slot reuse: the attention kernel of the step (packed
    attention; flash and decode attention on the legacy step and
    recompute) launches on the card at the family's group (9, 3, 7, 1 at
    head_dim 64, and tiny-toy's 2), and none on xLSTM."""
    cfg = _family_config(family)
    params = model.init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                             int(rng.integers(3, 40)))]
               for _ in range(6)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, _to(params, dev), EngineConfig(
            max_slots=2, max_len=64, discrete_sizes=(16, 8),
            avg_decode_len=4, **FAMILY_MODES[mode]), device=dev)
        for i, pr in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=pr, max_new_tokens=6))
        before = (sum(packed_attention_cuda.launches.values()),
                  flash_attention_cuda.launches,
                  decode_attention_cuda.launches)
        outs[dev] = {r.rid: r.output for r in eng.run()}
        launched = (sum(packed_attention_cuda.launches.values()) - before[0],
                    flash_attention_cuda.launches - before[1],
                    decode_attention_cuda.launches - before[2])
        on_card = dev == "cuda" and family != "xlstm"
        packed = eng.step_mode == "packed"
        assert (launched[0] > 0) == (on_card and packed), launched
        assert (launched[1] > 0) == (launched[2] > 0) == \
            (on_card and not packed), launched
    assert outs["cuda"] == outs["cpu"] and len(outs["cpu"]) == 6


def test_int8_hybrid_engine_on_card_matches_cpu(cuda):
    """The Jamba layer pattern of ``test_hybrid_engine_on_card_matches_cpu``
    with int8 KV on the packed step: the int8 packed-attention build
    launches on the card, the tokens are the CPU's."""
    cfg = scale_down(get_config("jamba-1.5-large-398b"), d_model=256,
                     n_heads=4)
    cfg = dataclasses.replace(
        cfg, moe=None, dtype="float32",
        block_pattern=tuple(dataclasses.replace(sp, ffn=FFN_DENSE)
                            for sp in cfg.block_pattern))
    params = model.init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(6)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                             int(rng.integers(3, 40)))]
               for _ in range(6)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, _to(params, dev), EngineConfig(
            max_slots=2, max_len=64, discrete_sizes=(16, 8),
            avg_decode_len=4, kv_dtype="int8"), device=dev)
        for i, pr in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=pr, max_new_tokens=6))
        before = packed_attention_cuda.launches["packed_attention_quant"]
        outs[dev] = {r.rid: r.output for r in eng.run()}
        quant = packed_attention_cuda.launches["packed_attention_quant"] - \
            before
        assert (quant > 0) == (dev == "cuda")
    assert outs["cuda"] == outs["cpu"] and len(outs["cpu"]) == 6
