"""The port's ``forward_packed`` against the JAX package's, f32 on the CPU.

Both packages run the same weights (the JAX ``model.init`` pytree,
converted with ``repro_torch.models.convert.from_jax_params``) on the same
two packed streams: first prefill chunks of three requests, then a stream
that mixes decode tokens, two further prefill chunks and padding rows
(``wpos == max_len``).  Logits and the scattered caches must agree to atol
1e-4 (f32; the packages sum in different orders).
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import scale_down as jax_scale_down
from repro.models import model as jax_model
from repro_torch.configs import get_config, scale_down
from repro_torch.models import model
from repro_torch.models.convert import from_jax_params

MAX_LEN, SLOTS, ATOL = 48, 4, 1e-4


def _configs(name):
    if name == "tiny-toy":
        return _f32(jax_get_config(name)), _f32(get_config(name))
    # qk-norm, theta 1e6, 16 heads over 8 KV heads: GQA group 2
    kw = dict(n_layers=2, d_model=256, n_heads=16)
    return (_f32(jax_scale_down(jax_get_config(name), **kw)),
            _f32(scale_down(get_config(name), **kw)))


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _streams(vocab):
    """Two packed iterations, as (tokens, slot, pos, wpos) int32 arrays."""
    rng = np.random.default_rng(11)
    prompts = {0: rng.integers(0, vocab, 13), 1: rng.integers(0, vocab, 21),
               2: rng.integers(0, vocab, 9)}
    first = [(2, 0, 8), (0, 0, 10), (1, 0, 12)]          # (slot, offset, len)
    # decode tokens for slots 2 and 0 (whose prompts finished / were cut at
    # 8 and 10), then the rest of slot 1's prompt, then a new request in
    # slot 3, then 5 padding rows
    toks, slot, pos = [], [], []
    for s, off, ln in first:
        toks += list(prompts[s][off:off + ln])
        slot += [s] * ln
        pos += list(range(off, off + ln))
    it1 = (toks, slot, pos, pos)
    toks = [int(prompts[2][8]), int(prompts[0][10])]
    slot = [2, 0]
    pos = [8, 10]
    toks += list(prompts[1][12:21]) + list(rng.integers(0, vocab, 6))
    slot += [1] * 9 + [3] * 6
    pos += list(range(12, 21)) + list(range(6))
    wpos = list(pos)
    toks += [0] * 5
    slot += [0] * 5
    pos += [0] * 5
    wpos += [MAX_LEN] * 5
    it2 = (toks, slot, pos, wpos)
    return [tuple(np.asarray(a, np.int32) for a in it) for it in (it1, it2)]


def _jax_cache_np(cfg, cache):
    """JAX per-group stacked caches -> per-layer (k, v) numpy pairs."""
    out = []
    for gi, (pattern, reps) in enumerate(cfg.layer_groups()):
        for r in range(reps):
            for i in range(len(pattern)):
                leaf = cache[gi][f"sub{i}"]
                out.append((np.asarray(leaf["k"][r]), np.asarray(leaf["v"][r])))
    return out


@pytest.mark.parametrize("name", ["tiny-toy", "qwen3-8b"])
def test_forward_packed_matches_jax(name):
    jcfg, tcfg = _configs(name)
    if name == "qwen3-8b":
        assert tcfg.qk_norm and tcfg.rope_theta == 1e6 and tcfg.gqa_group == 2
    jparams = jax_model.init(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    jcache = jax_model.init_cache(jcfg, 1, SLOTS, MAX_LEN)
    tcache = model.init_cache(tcfg, SLOTS, MAX_LEN, device="cpu")
    for toks, slot, pos, wpos in _streams(tcfg.vocab_size):
        active = wpos < MAX_LEN
        jlog, jcache = jax_model.forward_packed(
            jcfg, jparams, jnp.asarray(toks)[None], jcache, jnp.asarray(slot),
            jnp.asarray(pos), jnp.asarray(wpos), jnp.asarray(active),
            kv_bucket=32)
        tlog, tcache = model.forward_packed(
            tcfg, tparams, torch.from_numpy(toks)[None], tcache,
            torch.from_numpy(slot), torch.from_numpy(pos),
            torch.from_numpy(wpos), kv_bucket=32)
        assert tlog.shape == (1, len(toks), tcfg.vocab_size)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=0, atol=ATOL)
        for (jk, jv), tc in zip(_jax_cache_np(jcfg, jcache), tcache):
            np.testing.assert_allclose(tc["k"].numpy(), jk, rtol=0, atol=ATOL)
            np.testing.assert_allclose(tc["v"].numpy(), jv, rtol=0, atol=ATOL)


def test_init_shapes_and_scales():
    """The port's seeded init: the JAX layouts, norms at one, truncated
    normal weights with std 1/sqrt(fan_in) (a truncated unit normal has
    std ~0.88)."""
    cfg = get_config("tiny-toy")
    p = model.init(cfg, seed=3, device="cpu")
    layer = p["layers"][0]
    assert p["embed"].shape == (512, 256) and p["head"].shape == (256, 512)
    assert layer["mixer"]["wq"].shape == (256, 4, 64)
    assert layer["mixer"]["wo"].shape == (4, 64, 256)
    assert layer["ffn"]["w_down"].shape == (512, 256)
    assert torch.equal(layer["norm1"], torch.ones(256, dtype=torch.bfloat16))
    wo = layer["mixer"]["wo"].float()
    assert abs(wo.std().item() * 256 ** 0.5 - 0.88) < 0.03
    assert wo.abs().max().item() <= 2 / 256 ** 0.5 + 1e-3
    again = model.init(cfg, seed=3, device="cpu")
    assert torch.equal(again["layers"][3]["ffn"]["w_up"],
                       p["layers"][3]["ffn"]["w_up"])


def test_padding_rows_write_nothing():
    """Padding tokens (wpos == max_len) leave every cache row unchanged."""
    cfg = _f32(get_config("tiny-toy"))
    params = model.init(cfg, device="cpu")
    cache = model.init_cache(cfg, 2, 16, device="cpu")
    toks = torch.tensor([[5, 6, 7]], dtype=torch.int32)
    z = torch.zeros(3, dtype=torch.int32)
    model.forward_packed(cfg, params, toks, cache, z, z,
                         torch.full((3,), 16, dtype=torch.int32))
    assert all(not c[k].any() for c in cache for k in ("k", "v"))
