"""The port's CUDA kernels and engine on the card, held against the plain
PyTorch versions.  Every test here needs a CUDA card and skips without one;
run them on the card with ``python -m pytest -q -m gpu
tests/test_torch_cuda.py``.  The file imports no JAX, so it runs where
only PyTorch is installed.

Tolerances: rtol 1e-5 / atol 2e-5 for f32 attention and 2e-2 in bf16 (as
for the JAX kernels); 1e-4 for f32 SwiGLU, as ``tests/test_kernels.py``
holds the Pallas SwiGLU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.packed_attention import (packed_attention_cuda,
                                                  packed_attention_ref)
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
@pytest.mark.parametrize("group,d", [(1, 64), (4, 128), (8, 128), (2, 256)])
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
    before = packed_attention_cuda.launches
    out = packed_attention_cuda(*args, kv_bucket=257)
    torch.cuda.synchronize()
    assert packed_attention_cuda.launches == before + 1
    want = packed_attention_ref(*args, kv_bucket=257)
    torch.testing.assert_close(out.float(), want.float(), **_tol(dtype))


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


def test_engine_on_card_matches_cpu(cuda):
    """tiny-toy in f32: the engine on the card (both kernels) serves the
    same greedy tokens as the engine on the CPU (plain versions)."""
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
            avg_decode_len=4), device=dev)
        for i, pr in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=pr, max_new_tokens=6))
        outs[dev] = {r.rid: r.output for r in eng.run()}
        assert eng.stats.dispatches_per_iter == eng.stats.syncs_per_iter == 1.0
    assert outs["cuda"] == outs["cpu"] and len(outs["cpu"]) == 6


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)
