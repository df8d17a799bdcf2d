"""The port's kernel modules against the JAX package.

On the CPU the port's wrappers run their plain versions, so these hold
``packed_attention_ref`` and ``swiglu_ref`` against the JAX refs and the
Pallas kernels run in interpret mode, on the same numpy-seeded inputs.
``test_torch_cuda.py`` holds the CUDA kernels against the plain versions on
the card.

Tolerances: rtol 1e-5 / atol 2e-5 in f32 and 2e-2 in bf16, as
``tests/test_packed_attention.py:_tol`` states for the JAX kernels (the
two packages sum in different orders; bf16 outputs round at 2^-8).
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import packed_attention as jax_pa
from repro.kernels import ref as jax_ref
from repro.kernels import swiglu as jax_swiglu
from repro_torch.kernels import ops
from repro_torch.kernels.packed_attention import (packed_attention_cuda,
                                                  packed_attention_ref)
from repro_torch.kernels.swiglu import swiglu_cuda, swiglu_ref

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-5, atol=2e-5)


def _both(a, dtype):
    """The same numpy values as a JAX array and a torch tensor of dtype."""
    return jnp.asarray(a, JNP[dtype]), torch.from_numpy(a).to(TORCH[dtype])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _attn_case(seed, t, group, n=3, s=48, kv=2, d=32, bucket=40):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(t, kv * group, d)).astype(np.float32)
    k = rng.normal(size=(n, s, kv, d)).astype(np.float32)
    v = rng.normal(size=(n, s, kv, d)).astype(np.float32)
    slot = rng.integers(0, n, size=t).astype(np.int32)
    lens = rng.integers(1, bucket + 1, size=t).astype(np.int32)
    return q, k, v, slot, lens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 9, 33])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_packed_attention_ref_matches_jax(group, t, dtype):
    """Ragged bucket (40 rows of a 48-row cache, block_k 16): the last
    Pallas block is partial."""
    q, k, v, slot, lens = _attn_case(100 * group + t, t, group)
    jq, tq = _both(q, dtype)
    jk, tk = _both(k, dtype)
    jv, tv = _both(v, dtype)
    out = packed_attention_ref(tq, tk, tv, torch.from_numpy(slot),
                               torch.from_numpy(lens), kv_bucket=40)
    assert out.dtype == TORCH[dtype] and out.shape == q.shape
    want_ref = jax_ref.packed_attention_ref(jq, jk, jv, jnp.asarray(slot),
                                            jnp.asarray(lens), kv_bucket=40)
    want_pallas = jax_pa.packed_attention(jq, jk, jv, jnp.asarray(slot),
                                          jnp.asarray(lens), kv_bucket=40,
                                          block_k=16, interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(want_ref), **_tol(dtype))
    np.testing.assert_allclose(_f32(out), _f32(want_pallas), **_tol(dtype))


def _variant_case(seed, group, variant, t=9, n=3, s=48, kv=2, d=32, bs=8,
                  bucket=40):
    """Operands of one packed-attention variant as numpy arrays: int8 codes
    with f32 (N, S, KV) scales for the quantized variants, and for the
    block-table variants a shuffled physical-block table over the N·S rows
    (so a wrong table or scale index reads another request's rows)."""
    rng = np.random.default_rng(seed)
    q, k, v, slot, lens = _attn_case(seed, t, group, n, s, kv, d, bucket)
    ops_kw = {}
    if "quant" in variant:
        k = rng.integers(-127, 128, size=k.shape).astype(np.int8)
        v = rng.integers(-127, 128, size=v.shape).astype(np.int8)
        ops_kw["k_scale"] = rng.uniform(1e-3, 2e-2, (n, s, kv)).astype(
            np.float32)
        ops_kw["v_scale"] = rng.uniform(1e-3, 2e-2, (n, s, kv)).astype(
            np.float32)
    if "block" in variant:
        ops_kw["block_tables"] = rng.permutation(n * s // bs).astype(
            np.int32).reshape(n, s // bs)
    return (q, k, v, slot, lens), ops_kw


@pytest.mark.parametrize("variant", ["quant", "block", "block_quant"])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_packed_attention_variants_match_jax(group, variant):
    """The int8, block-table and block-table + int8 variants of the plain
    version against the JAX ref and the Pallas kernels in interpret mode
    (``_kernel_quant``, ``_kernel_block``, ``_kernel_block_quant``), f32 q,
    bucket 40 = 5 blocks of 8."""
    (q, k, v, slot, lens), kw = _variant_case(7 * group, group, variant)
    jargs = [jnp.asarray(a) for a in (q, k, v, slot, lens)]
    jkw = {name: jnp.asarray(a) for name, a in kw.items()}
    targs = [torch.from_numpy(a) for a in (q, k, v, slot, lens)]
    tkw = {name: torch.from_numpy(a) for name, a in kw.items()}
    out = packed_attention_ref(*targs, kv_bucket=40, **tkw)
    assert out.dtype == torch.float32 and out.shape == q.shape
    torch.testing.assert_close(
        ops.packed_attention(*targs, kv_bucket=40, **tkw), out, rtol=0, atol=0)
    want_ref = jax_ref.packed_attention_ref(*jargs, kv_bucket=40, **jkw)
    want_pallas = jax_pa.packed_attention(*jargs, kv_bucket=40, block_k=16,
                                          interpret=True, **jkw)
    np.testing.assert_allclose(_f32(out), _f32(want_ref), **_tol("float32"))
    np.testing.assert_allclose(_f32(out), _f32(want_pallas),
                               **_tol("float32"))


def test_block_sweep_must_be_whole_blocks():
    """Block-table mode sweeps whole blocks: a bucket that is not a
    multiple of the block size raises instead of reading a partial one."""
    (q, k, v, slot, lens), kw = _variant_case(1, 2, "block")
    args = [torch.from_numpy(a) for a in (q, k, v, slot, lens)]
    with pytest.raises(ValueError, match="multiple of the block size"):
        packed_attention_ref(*args, kv_bucket=36,
                             block_tables=torch.from_numpy(kw["block_tables"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(37, 40, 24), (8, 64, 48), (100, 24, 72)])
def test_swiglu_ref_matches_jax(m, k, n, dtype):
    """Ragged M, N and K against the Pallas block sizes (16)."""
    rng = np.random.default_rng(m * k + n)
    x, wg, wu = (rng.normal(size=sh).astype(np.float32)
                 for sh in ((m, k), (k, n), (k, n)))
    jx, tx = _both(x, dtype)
    jg, tg = _both(wg, dtype)
    ju, tu = _both(wu, dtype)
    out = swiglu_ref(tx, tg, tu)
    assert out.dtype == TORCH[dtype] and out.shape == (m, n)
    want_ref = jax_swiglu.swiglu_ref(jx, jg, ju)
    want_pallas = jax_swiglu.swiglu(jx, jg, ju, block_m=16, block_n=16,
                                    block_k=16, interpret=True)
    tol = _tol(dtype) if dtype == "bfloat16" else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_f32(out), _f32(want_ref), **tol)
    np.testing.assert_allclose(_f32(out), _f32(want_pallas), **tol)


def test_ops_choose_by_device():
    """A CPU tensor runs the plain version; an unknown impl raises; the
    CUDA wrappers refuse a CPU tensor instead of running it."""
    q, k, v, slot, lens = _attn_case(0, 5, 2)
    args = [torch.from_numpy(a) for a in (q, k, v, slot, lens)]
    launches = (dict(packed_attention_cuda.launches), swiglu_cuda.launches)
    got = ops.packed_attention(*args, kv_bucket=40)
    torch.testing.assert_close(got, packed_attention_ref(*args, kv_bucket=40),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.packed_attention(*args, impl="plain"),
                               packed_attention_ref(*args), rtol=0, atol=0)
    with pytest.raises(ValueError):
        ops.packed_attention(*args, impl="cuda")
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        packed_attention_cuda(*args)
    x = torch.ones(4, 8)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        swiglu_cuda(x, torch.ones(8, 8), torch.ones(8, 8))
    assert (packed_attention_cuda.launches, swiglu_cuda.launches) == launches


# ---- the streams of the card's tile-kernel tests -------------------------
# (tests/test_torch_cuda.py: decode tokens then prefill chunks as runs of
# one slot, runs cut by another slot, shuffled lengths, padding tokens, a
# sweep below some lengths, T = 0)
from test_torch_cuda import (SEG_SLOTS, SEGMENTED,  # noqa: E402
                             segmented_operands, segmented_stream)
from repro_torch.kernels import packed_attention as pa  # noqa: E402


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("variant", ["packed_attention",
                                     "packed_attention_quant",
                                     "packed_attention_block",
                                     "packed_attention_block_quant"])
@pytest.mark.parametrize("case", [c for c in SEGMENTED if c != "empty"])
def test_packed_attention_ref_on_segmented_streams(case, variant, group):
    """The card's oracle on exactly the card tests' streams: the plain
    version against the JAX ref in f32 (numpy-seeded, head dim 64), on the
    tokens both define (slot in range, length >= 1; the kernel's zeros for
    the others are checked on the card)."""
    slot, lens, bucket = segmented_stream(case, group)
    k, v, kw = segmented_operands(variant, group, 64)
    q = np.random.default_rng(1).normal(
        size=(len(slot), 2 * group, 64)).astype(np.float32)
    ok = (slot >= 0) & (slot < SEG_SLOTS) & (lens > 0)
    args = (q[ok], k, v, slot[ok], lens[ok])
    out = packed_attention_ref(*(torch.from_numpy(a) for a in args),
                               kv_bucket=bucket,
                               **{n: torch.from_numpy(a) for n, a in kw.items()})
    want = jax_ref.packed_attention_ref(*(jnp.asarray(a) for a in args),
                                        kv_bucket=bucket,
                                        **{n: jnp.asarray(a)
                                           for n, a in kw.items()})
    np.testing.assert_allclose(_f32(out), _f32(want), **_tol("float32"))


def _chip_smoke():
    """The root ``chip_smoke.py`` as a module (it imports torch only inside
    its functions)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("group", [1, 2, 4, 8, 3, 7, 9])
@pytest.mark.parametrize("case", SEGMENTED)
def test_tiles_cover_the_stream(case, group):
    """chip_smoke's host replay of the tile kernel's tiling, which its K/V
    megabytes are counted from: tiles cover the stream in order, stay
    inside one group of tq tokens and one slot, end where the slot
    changes, and carry their tokens' largest clamped length; the megabytes
    they stream lie between the distinct rows' and a per-token loop's."""
    cs = _chip_smoke()
    slot, lens, bucket = segmented_stream(case, group)
    tq, _, _ = pa.tile_plan(len(slot), group, bucket)
    # the largest power of two with tq x group <= 64: 64 // group for
    # groups 1, 2, 4 and 8, and 16, 8 and 4 for groups 3, 7 and 9
    assert tq & (tq - 1) == 0 and tq * group <= 64 < 2 * tq * group
    tiles = cs.tiles(slot, lens, SEG_SLOTS, bucket, tq)
    clamped = [min(max(int(x), 0), bucket) if 0 <= s < SEG_SLOTS else 0
               for s, x in zip(slot, lens)]
    t = 0
    for first, n, top in tiles:
        assert first == t and n >= 1
        assert first // tq == (first + n - 1) // tq
        assert len(set(slot[first:first + n].tolist())) == 1
        end = first + n
        assert end == len(slot) or end % tq == 0 or slot[end] != slot[first]
        assert top == max(clamped[first:end])
        t = end
    assert t == len(slot)
    k, _, _ = segmented_operands("packed_attention", group, 64)
    args = (torch.zeros(len(slot), 2 * group, 64), torch.from_numpy(k), None,
            torch.from_numpy(slot), torch.from_numpy(lens))
    mb = cs.kv_stream(args, {}, bucket)
    row = 2 * 64 * 2 * 4 / 1e6
    assert mb["tq"] == tq
    assert mb["tiled"] == pytest.approx(sum(top for _, _, top in tiles) * row)
    assert mb["per_token"] == pytest.approx(sum(clamped) * row)
    assert mb["distinct"] <= mb["tiled"] <= mb["per_token"]


@pytest.mark.parametrize("t,group,sweep", [(8, 4, 1024), (245, 4, 1024),
                                           (256, 1, 4096), (1024, 8, 1024),
                                           (4096, 2, 512), (0, 4, 64),
                                           (3, 2, 0), (256, 3, 1024),
                                           (245, 7, 2048), (8, 9, 4096)])
def test_tile_plan_sizes_the_scratch_from_shapes(t, group, sweep):
    """tile_plan's (tq, chunk, chunks): 64 rows per tile at groups 1, 2, 4
    and 8 (48, 56 and 36 at groups 3, 7 and 9: tq the largest power of
    two that fits), power-of-two chunks of at least CHUNK rows that cover
    the sweep, and split-KV scratch within SPLIT_BUDGET tokens x chunks
    (one chunk for a stream of that many tokens)."""
    tq, chunk, n = pa.tile_plan(t, group, sweep)
    assert tq * group == {3: 48, 7: 56, 9: 36}.get(group, pa.TILE_ROWS)
    assert chunk >= pa.CHUNK and chunk & (chunk - 1) == 0
    assert n >= 1 and n * chunk >= sweep
    assert t * n <= max(pa.SPLIT_BUDGET, t)
    if t >= pa.SPLIT_BUDGET:
        assert n == 1
    if t * -(-sweep // pa.CHUNK) <= pa.SPLIT_BUDGET:
        assert chunk == pa.CHUNK
    assert pa.tile_plan(t, group, sweep, tq=2, chunk=256)[:2] == (2, max(
        256, chunk))


@pytest.mark.parametrize("bad", [dict(tq=3), dict(tq=128), dict(chunk=96),
                                 dict(chunk=32), dict(chunk=0)])
def test_tile_plan_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        pa.tile_plan(16, 4, 1024, **bad)


@pytest.mark.parametrize("group,d,ok", [
    (1, 64, True), (8, 256, True), (3, 128, True), (7, 128, True),
    (9, 128, True), (7, 64, False), (9, 256, False), (3, 64, False),
    (5, 128, False), (16, 128, False), (4, 32, False)])
def test_attention_kernels_take_groups_3_7_9_at_head_dim_128(group, d, ok):
    """The (group, head dim) pairs the five attention kernels are built
    for: groups 1, 2, 4 and 8 at head dims 64, 128 and 256, groups 3, 7 and
    9 at 128 only; any other pair raises, naming the rule."""
    def check(cond, what):
        if not cond:
            raise ValueError(what)
    if ok:
        pa.check_heads(check, 2 * group, 2, d)
    else:
        with pytest.raises(ValueError, match="group|head_dim"):
            pa.check_heads(check, 2 * group, 2, d)
