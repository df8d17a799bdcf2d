"""The port's int8 KV (DESIGN.md §15) and block-table forward (§12) against
the JAX package, f32 tiny-toy on the CPU.

* ``forward_packed`` through an int8 cache, a block-table cache (a
  shuffled physical-block table) and both: logits agree with JAX's at atol
  1e-4 and the scattered caches agree — int8 codes equal except at most
  0.1% off by one (an f32 K/V value a rounding ulp from a .5 tie), scales
  and native rows at 1e-4.
* The int8 engine is token-exact against the JAX int8 engine, with and
  without prefix caching, on ``tests/test_kv_int8_engine.py``'s workload.
  (int8 against bf16 is *not* a gate: ROADMAP fault C1.)
* At a fixed ``kv_budget_bytes`` the int8 engine gets >= 1.9x the pages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as jax_model
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro.serving.request import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.models import model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import ServeEngine, kv_bytes_per_token
from repro_torch.serving.request import Request

MAX_LEN, SLOTS, BS, ATOL = 32, 3, 8, 1e-4


@pytest.fixture(scope="module")
def toy():
    jcfg = dataclasses.replace(jax_get_config("tiny-toy"), dtype="float32")
    tcfg = dataclasses.replace(get_config("tiny-toy"), dtype="float32")
    jparams = jax_model.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, from_jax_params(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")


def _streams(vocab, tables):
    """Two packed iterations as (tokens, slot, pos, wpos, dst) int32 arrays:
    prefill chunks of slots 0-2, then decode tokens of slots 0 and 2, the
    rest of slot 1's prompt and 4 padding rows.  ``dst`` is each token's
    physical row through ``tables`` (N·S for padding)."""
    rng = np.random.default_rng(4)
    oob = SLOTS * MAX_LEN
    its = []
    for segs, pad in ((((0, 0, 9), (1, 0, 12), (2, 0, 5)), 0),
                      (((0, 9, 1), (2, 5, 1), (1, 12, 7)), 4)):
        slot = np.concatenate([np.full(ln, s) for s, _, ln in segs]
                              + [np.zeros(pad, int)])
        pos = np.concatenate([np.arange(off, off + ln) for _, off, ln in segs]
                             + [np.zeros(pad, int)])
        real = len(slot) - pad
        wpos = np.where(np.arange(len(slot)) < real, pos, MAX_LEN)
        dst = np.where(wpos < MAX_LEN,
                       tables[slot, pos // BS] * BS + pos % BS, oob)
        toks = rng.integers(0, vocab, len(slot))
        its.append(tuple(np.asarray(a, np.int32)
                         for a in (toks, slot, pos, wpos, dst)))
    return its


def _jax_layers(cfg, cache):
    """JAX per-group stacked caches -> per-layer dicts of numpy leaves."""
    out = []
    for gi, (pattern, reps) in enumerate(cfg.layer_groups()):
        for r in range(reps):
            for i in range(len(pattern)):
                leaf = cache[gi][f"sub{i}"]
                out.append({k: np.asarray(v[r]) for k, v in leaf.items()})
    return out


@pytest.mark.parametrize("quant,blocked", [(True, False), (False, True),
                                           (True, True)])
def test_forward_packed_matches_jax(toy, quant, blocked):
    jcfg, jparams, tcfg, tparams = toy
    kv_dtype = "int8" if quant else None
    rng = np.random.default_rng(9)
    tables = rng.permutation(SLOTS * MAX_LEN // BS).astype(np.int32) \
        .reshape(SLOTS, MAX_LEN // BS)
    jcache = jax_model.init_cache(jcfg, 1, SLOTS, MAX_LEN, kv_dtype)
    tcache = model.init_cache(tcfg, SLOTS, MAX_LEN, device="cpu",
                              kv_dtype=kv_dtype)
    for toks, slot, pos, wpos, dst in _streams(tcfg.vocab_size, tables):
        jblk = dict(token_dst=jnp.asarray(dst),
                    block_tables=jnp.asarray(tables)) if blocked else {}
        tblk = dict(token_dst=torch.from_numpy(dst),
                    block_tables=torch.from_numpy(tables)) if blocked else {}
        jlog, jcache = jax_model.forward_packed(
            jcfg, jparams, jnp.asarray(toks)[None], jcache, jnp.asarray(slot),
            jnp.asarray(pos), jnp.asarray(wpos),
            jnp.asarray(wpos < MAX_LEN), kv_bucket=MAX_LEN, **jblk)
        tlog, tcache = model.forward_packed(
            tcfg, tparams, torch.from_numpy(toks)[None], tcache,
            torch.from_numpy(slot), torch.from_numpy(pos),
            torch.from_numpy(wpos), kv_bucket=MAX_LEN, **tblk)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=ATOL)
        for want, got in zip(_jax_layers(jcfg, jcache), tcache):
            assert set(got) == set(want)
            for name, leaf in got.items():
                a, b = leaf.numpy(), want[name]
                if leaf.dtype == torch.int8:
                    diff = np.abs(a.astype(np.int32) - b)
                    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
                else:
                    np.testing.assert_allclose(a, b, rtol=ATOL, atol=ATOL)


def _serve(eng, request_cls, vocab):
    rng = np.random.default_rng(1)
    for i, n in enumerate([3, 11, 5, 9, 4]):
        eng.submit(request_cls(
            rid=i, prompt=list(map(int, rng.integers(0, vocab, size=n))),
            max_new_tokens=4))
    return {r.rid: tuple(r.output) for r in eng.run()}


@pytest.mark.parametrize("prefix", [False, True])
def test_int8_engine_token_exact_vs_jax(toy, prefix):
    jcfg, jparams, tcfg, tparams = toy
    kw = dict(max_slots=2, max_len=48, kv_block_size=8, discrete_sizes=(16, 8),
              avg_decode_len=4.0, async_depth=0, kv_dtype="int8",
              prefix_caching=prefix)
    jeng = JaxServeEngine(jcfg, jparams, JaxEngineConfig(**kw))
    teng = ServeEngine(tcfg, tparams, EngineConfig(**kw), device="cpu")
    want = _serve(jeng, JaxRequest, tcfg.vocab_size)
    got = _serve(teng, Request, tcfg.vocab_size)
    assert len(got) == 5 and got == want
    assert teng.cache[0]["k"].dtype == torch.int8
    s = teng.stats
    assert s.iterations == jeng.stats.iterations
    assert s.dispatches_per_iter == 1.0 and s.syncs_per_iter == 1.0
    assert s.kv_quant_bytes_saved == jeng.stats.kv_quant_bytes_saved > 0


def test_int8_pages_at_fixed_budget():
    """head_dim 128: an int8 row and its f32 scale take 132 of the bf16
    row's 256 bytes, so a fixed budget buys >= 1.9x the pages."""
    cfg = dataclasses.replace(get_config("tiny-toy"), head_dim=128)
    params = model.init(cfg, device="cpu")
    budget = kv_bytes_per_token(cfg) * 8 * 16    # 16 bf16 pages of 8 rows
    pages = {}
    for kv_dtype in ("bf16", "int8"):
        eng = ServeEngine(cfg, params, EngineConfig(
            max_slots=4, max_len=64, kv_block_size=8, kv_budget_bytes=budget,
            kv_dtype=kv_dtype), device="cpu")
        pages[kv_dtype] = eng.kv.stats.device_pages_total
    assert pages["int8"] >= 1.9 * pages["bf16"], pages
    assert kv_bytes_per_token(cfg, "int8") == 4 * 2 * 2 * (128 + 4)
