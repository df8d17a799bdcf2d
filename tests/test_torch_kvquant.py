"""The port's int8 KV quantization against the JAX package's
(``repro.serving.kvquant``): the int8 codes must be bit-equal (the same f32
ops in the same order, round half to even in both), the scales equal to
rtol 1e-6, on seeded numpy rows, including rows whose codes land exactly on
rounding ties.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import kvquant as jax_kvquant
from repro_torch.serving import kvquant


def _rows(dtype):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(7, 5, 3, 64)) * rng.uniform(0.01, 30, (7, 5, 3, 1))
         ).astype(np.float32)
    # max |x| = 127 gives scale 1 (+1e-12, below an f32 ulp): x/scale = x,
    # and the .5 entries are ties that must round to even
    x[0, 0, 0, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    x[0, 0, 1] = 0.0                                   # all-zero row
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal_to_jax(dtype):
    x = _rows(dtype)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16"
                                else torch.float32)
    want_q, want_s = jax_kvquant.quantize_kv(jx)
    got_q, got_s = kvquant.quantize_kv(tx)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert got_q.shape == x.shape and got_s.shape == x.shape[:-1]
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6,
                               atol=0)
    assert got_q[0, 0, 0, :6].tolist() == [127, 2, -4, 0, 0, 2]
    np.testing.assert_array_equal(
        kvquant.dequantize_kv(got_q, got_s, torch.float32).numpy(),
        np.asarray(jax_kvquant.dequantize_kv(want_q, want_s, jnp.float32)))
