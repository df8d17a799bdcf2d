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
    launches = (packed_attention_cuda.launches, swiglu_cuda.launches)
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
