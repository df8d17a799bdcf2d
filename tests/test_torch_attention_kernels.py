"""The plain versions of the legacy step's two attention kernels against the
JAX package: ``flash_attention_ref`` and ``decode_attention_ref`` vs the JAX
refs (``repro.kernels.ref``) and the Pallas kernels run in interpret mode,
on the same numpy-seeded inputs.  ``test_torch_cuda.py`` holds the CUDA
kernels against these plain versions on the card.

Tolerances: rtol 1e-5 / atol 2e-5 in f32 and 2e-2 in bf16, as
``tests/test_kernels.py:_tol`` states for the JAX kernels (the two packages
sum in different orders; bf16 outputs round at 2^-8).
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jax_da
from repro.kernels import flash_attention as jax_fa
from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_ref)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_ref)

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


def _qkv(seed, b, sq, skv, group, kv=2, d=32, dv=None):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, kv * group, d)).astype(np.float32),
            rng.normal(size=(b, skv, kv, d)).astype(np.float32),
            rng.normal(size=(b, skv, kv, dv or d)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [1, 9, 33])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_flash_attention_ref_matches_jax(group, sq, dtype):
    """A static offset (a chunk 12 rows into a ragged 45-row cache; rows
    past the cache are attended in full) against the JAX ref and the
    Pallas kernel in interpret mode (block_q 8, block_k 16: ragged last
    blocks on both axes)."""
    q, k, v = _qkv(10 * group + sq, 2, sq, 45, group)
    jq, tq = _both(q, dtype)
    jk, tk = _both(k, dtype)
    jv, tv = _both(v, dtype)
    out = flash_attention_ref(tq, tk, tv, q_offset=12)
    assert out.dtype == TORCH[dtype] and out.shape == q.shape
    want_ref = jax_ref.flash_attention_ref(jq, jk, jv, q_offset=12)
    want_pallas = jax_fa.flash_attention(jq, jk, jv, q_offset=12, block_q=8,
                                         block_k=16, interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(want_ref), **_tol(dtype))
    np.testing.assert_allclose(_f32(out), _f32(want_pallas), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_flash_attention_ref_per_row_offsets(group, dtype):
    """Per-row (B,) offsets, as the legacy step's chunks pass them — 0, a
    mid-cache prefix, and one whose chunk runs past the 40-row cache —
    against the JAX ref (the Pallas kernel takes a static offset only),
    and the int offset 0 against the recompute shape (Sq == Skv)."""
    q, k, v = _qkv(group, 3, 9, 40, group)
    offsets = np.array([0, 17, 35], np.int32)
    jq, tq = _both(q, dtype)
    jk, tk = _both(k, dtype)
    jv, tv = _both(v, dtype)
    out = flash_attention_ref(tq, tk, tv, q_offset=torch.from_numpy(offsets))
    want = jax_ref.flash_attention_ref(jq, jk, jv,
                                       q_offset=jnp.asarray(offsets))
    np.testing.assert_allclose(_f32(out), _f32(want), **_tol(dtype))
    q, k, v = _qkv(group + 7, 2, 40, 40, group)
    jq, tq = _both(q, dtype)
    jk, tk = _both(k, dtype)
    jv, tv = _both(v, dtype)
    np.testing.assert_allclose(
        _f32(flash_attention_ref(tq, tk, tv)),
        _f32(jax_ref.flash_attention_ref(jq, jk, jv)), **_tol(dtype))


def test_flash_attention_ref_value_dim():
    """d_v != d_qk (absorbed MLA's shapes) against the JAX ref."""
    q, k, v = _qkv(3, 2, 9, 20, 2, d=48, dv=32)
    out = flash_attention_ref(*map(torch.from_numpy, (q, k, v)), q_offset=5)
    want = jax_ref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                       q_offset=5)
    assert out.shape == (2, 9, 4, 32)
    np.testing.assert_allclose(_f32(out), _f32(want), **_tol("float32"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_decode_attention_ref_matches_jax(group, dtype):
    """Ragged lengths 1..S over a 44-row cache (block_k 16: a ragged last
    Pallas block) against the JAX ref and Pallas interpret; a length past
    S (a decode at a full slot) against the JAX ref."""
    rng = np.random.default_rng(group)
    b, s, kv, d = 4, 44, 2, 32
    q = rng.normal(size=(b, kv * group, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    clen = np.array([1, 17, 44, 30], np.int32)
    jq, tq = _both(q, dtype)
    jk, tk = _both(k, dtype)
    jv, tv = _both(v, dtype)
    out = decode_attention_ref(tq, tk, tv, torch.from_numpy(clen))
    assert out.dtype == TORCH[dtype] and out.shape == q.shape
    want_ref = jax_ref.decode_attention_ref(jq, jk, jv, jnp.asarray(clen))
    want_pallas = jax_da.decode_attention(jq, jk, jv, jnp.asarray(clen),
                                          block_k=16, interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(want_ref), **_tol(dtype))
    np.testing.assert_allclose(_f32(out), _f32(want_pallas), **_tol(dtype))
    full = np.array([s + 1, 5, s, 2], np.int32)
    np.testing.assert_allclose(
        _f32(decode_attention_ref(tq, tk, tv, torch.from_numpy(full))),
        _f32(jax_ref.decode_attention_ref(jq, jk, jv, jnp.asarray(full))),
        **_tol(dtype))


def test_ops_choose_by_device():
    """A CPU tensor runs the plain version; the CUDA wrappers refuse a CPU
    tensor instead of running it, and nothing counts as launched."""
    q, k, v = map(torch.from_numpy, _qkv(0, 2, 5, 12, 2))
    off = torch.tensor([0, 4], dtype=torch.int32)
    launches = (flash_attention_cuda.launches, decode_attention_cuda.launches)
    torch.testing.assert_close(ops.flash_attention(q, k, v, q_offset=off),
                               flash_attention_ref(q, k, v, q_offset=off),
                               rtol=0, atol=0)
    clen = torch.tensor([3, 12], dtype=torch.int32)
    torch.testing.assert_close(ops.decode_attention(q[:, 0], k, v, clen),
                               decode_attention_ref(q[:, 0], k, v, clen),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, 0], k, v, clen, impl="cuda")
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        flash_attention_cuda(q, k, v, q_offset=off)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        decode_attention_cuda(q[:, 0], k, v, clen)
    assert (flash_attention_cuda.launches,
            decode_attention_cuda.launches) == launches
