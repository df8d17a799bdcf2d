"""The plain versions of paged decode attention and the fused GEMM +
decode-attention overlap against the JAX package: ``paged_decode_attention_ref``
and ``fused_overlap_ref`` vs the JAX refs (``repro.kernels.ref``) and the
Pallas kernels run in interpret mode, on the same numpy-seeded inputs, and
the ``ops`` entries' choice by device.  ``test_torch_cuda.py`` holds the
CUDA kernels against these plain versions on the card.

Tolerances: attention at rtol 1e-5 / atol 2e-5 in f32 and 2e-2 in bf16, as
``tests/test_kernels.py`` holds the Pallas kernels (the two packages sum in
different orders; bf16 outputs round at 2^-8); the GEMM at rtol 1e-4 /
atol 1e-3, as ``tests/test_kernels.py:test_fused_overlap`` holds it (sums
over K of unit normals, taken in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jax_da
from repro.kernels import fused_overlap as jax_fo
from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (paged_decode_attention_cuda,
                                                  paged_decode_attention_ref)
from repro_torch.kernels.fused_overlap import (fused_overlap_cuda,
                                               fused_overlap_ref)

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GEMM_TOL = dict(rtol=1e-4, atol=1e-3)


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


def _paged_case(seed, b, npages, ps, maxp, h, kv, d, hole=False):
    """``tests/test_kernels.py:test_paged_decode_attention``'s inputs: each
    row holds 1..MAXP distinct shuffled pages, its length inside its last
    page, and -1 past them; ``hole`` also sets a -1 inside row 0's length
    (the Pallas kernel and the JAX reference then read page 0)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp = rng.normal(size=(npages, ps, kv, d)).astype(np.float32)
    vp = rng.normal(size=(npages, ps, kv, d)).astype(np.float32)
    pt = np.full((b, maxp), -1, np.int32)
    clen = np.zeros(b, np.int32)
    for i in range(b):
        n = int(rng.integers(2 if hole and i == 0 else 1, maxp + 1))
        pt[i, :n] = rng.choice(npages, size=n, replace=False)
        clen[i] = rng.integers((n - 1) * ps + 1, n * ps + 1)
    if hole:
        pt[0, 0] = -1
    return q, kp, vp, pt, clen


PAGED_SHAPES = [(2, 16, 8, 6, 4, 2, 32), (3, 32, 16, 4, 8, 4, 16),
                (1, 8, 4, 8, 2, 1, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", PAGED_SHAPES, ids=str)
def test_paged_decode_attention_ref_matches_jax(shape, dtype):
    """The JAX test's three shapes against the JAX ref and the Pallas
    kernel in interpret mode."""
    q, kp, vp, pt, clen = _paged_case(sum(shape), *shape)
    jq, tq = _both(q, dtype)
    jk, tk = _both(kp, dtype)
    jv, tv = _both(vp, dtype)
    args_t = (tq, tk, tv, torch.from_numpy(pt), torch.from_numpy(clen))
    args_j = (jq, jk, jv, jnp.asarray(pt), jnp.asarray(clen))
    out = paged_decode_attention_ref(*args_t)
    assert out.dtype == TORCH[dtype] and out.shape == q.shape
    want_ref = jax_ref.paged_decode_attention_ref(*args_j)
    want_pallas = jax_da.paged_decode_attention(*args_j, interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(want_ref), **_tol(dtype))
    np.testing.assert_allclose(_f32(out), _f32(want_pallas), **_tol(dtype))


@pytest.mark.parametrize("case", ["logit_scale", "hole"])
def test_paged_decode_attention_ref_scale_and_holes(case):
    """A ``logit_scale`` of 0.3, and a -1 page id inside a row's length,
    which reads page 0 in the Pallas kernel and the JAX reference alike,
    in f32 against both."""
    shape = PAGED_SHAPES[0]
    q, kp, vp, pt, clen = _paged_case(7, *shape, hole=case == "hole")
    kw = dict(logit_scale=0.3) if case == "logit_scale" else {}
    out = paged_decode_attention_ref(
        *map(torch.from_numpy, (q, kp, vp, pt, clen)), **kw)
    args_j = tuple(map(jnp.asarray, (q, kp, vp, pt, clen)))
    np.testing.assert_allclose(
        _f32(out), _f32(jax_ref.paged_decode_attention_ref(*args_j, **kw)),
        **_tol("float32"))
    np.testing.assert_allclose(
        _f32(out), _f32(jax_da.paged_decode_attention(*args_j, interpret=True,
                                                      **kw)),
        **_tol("float32"))
    if case == "hole":
        page0 = pt.copy()
        page0[0, 0] = 0
        np.testing.assert_array_equal(
            _f32(out), _f32(paged_decode_attention_ref(
                *map(torch.from_numpy, (q, kp, vp, page0, clen)))))


def _overlap_case(seed, m, k, n, b, s, h, kv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(k, n)).astype(np.float32),
            rng.normal(size=(b, h, d)).astype(np.float32),
            rng.normal(size=(b, s, kv, d)).astype(np.float32),
            rng.normal(size=(b, s, kv, d)).astype(np.float32),
            rng.integers(1, s + 1, size=(b,)).astype(np.int32))


@pytest.mark.parametrize("frac", [0.25, 0.5, 1.0])
@pytest.mark.parametrize("shape", [(128, 64, 96, 2, 64, 4, 2, 32),
                                   (64, 32, 512, 1, 256, 4, 1, 64)], ids=str)
def test_fused_overlap_ref_matches_jax(shape, frac):
    """``tests/test_kernels.py:test_fused_overlap``'s shapes and fractions
    (block_n 64, block_s 32), f32, against the JAX ref and the Pallas kernel
    in interpret mode; the plain version takes no fraction."""
    arrays = _overlap_case(sum(shape), *shape)
    go, ao = fused_overlap_ref(*map(torch.from_numpy, arrays))
    jargs = tuple(map(jnp.asarray, arrays))
    rg, ra = jax_ref.fused_overlap_ref(*jargs)
    pg, pa = jax_fo.fused_overlap(*jargs, gemm_fraction=frac, block_n=64,
                                  block_s=32, interpret=True)
    assert go.shape == (shape[0], shape[2]) and ao.shape == arrays[2].shape
    for want_g, want_a in ((rg, ra), (pg, pa)):
        np.testing.assert_allclose(_f32(go), _f32(want_g), **GEMM_TOL)
        np.testing.assert_allclose(_f32(ao), _f32(want_a), **_tol("float32"))


def test_fused_overlap_ref_bf16_matches_jax():
    """bf16 inputs: the GEMM accumulated in f32 and rounded once, the
    attention in f32, against the JAX ref."""
    arrays = _overlap_case(3, 64, 48, 40, 3, 70, 8, 2, 32)
    torch_args = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays[:5]]
    jax_args = [jnp.asarray(a, jnp.bfloat16) for a in arrays[:5]]
    go, ao = fused_overlap_ref(*torch_args, torch.from_numpy(arrays[5]))
    rg, ra = jax_ref.fused_overlap_ref(*jax_args, jnp.asarray(arrays[5]))
    assert go.dtype == ao.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(go), _f32(rg), **_tol("bfloat16"))
    np.testing.assert_allclose(_f32(ao), _f32(ra), **_tol("bfloat16"))


def test_ops_choose_by_device():
    """A CPU tensor runs the plain version through the ``ops`` entries;
    the CUDA wrappers refuse a CPU tensor instead of running it, and
    nothing counts as launched."""
    q, kp, vp, pt, clen = map(torch.from_numpy,
                              _paged_case(0, *PAGED_SHAPES[0]))
    arrays = tuple(map(torch.from_numpy,
                       _overlap_case(0, 32, 16, 24, 2, 40, 4, 2, 32)))
    launches = (paged_decode_attention_cuda.launches,
                fused_overlap_cuda.launches)
    torch.testing.assert_close(
        ops.paged_decode_attention(q, kp, vp, pt, clen, logit_scale=0.5),
        paged_decode_attention_ref(q, kp, vp, pt, clen, logit_scale=0.5),
        rtol=0, atol=0)
    for got, want in zip(ops.fused_overlap(*arrays, gemm_fraction=0.25),
                         fused_overlap_ref(*arrays)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        ops.fused_overlap(*arrays, impl="cuda")
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        paged_decode_attention_cuda(q, kp, vp, pt, clen)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        fused_overlap_cuda(*arrays)
    assert (paged_decode_attention_cuda.launches,
            fused_overlap_cuda.launches) == launches
