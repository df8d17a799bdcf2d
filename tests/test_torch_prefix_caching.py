"""The port's block-table KV with prefix caching (DESIGN.md §12) against the
JAX package.

* Allocator: the port's ``PagedKVManager(prefix_caching=True)`` and
  ``repro.serving.kvcache.PagedKVManager(prefix_caching=True)`` run the same
  seeded soup of allocate-with-token-ids / ensure+extend / free / drain ops
  over a tiny alphabet (so prompts collide and share) and must agree after
  every op: tables, cached tokens, queued copies and stats.
* Engine: ``tests/test_prefix_caching.py``'s two waves (a 10-token shared
  prefix that diverges inside a block of 8) on the port's f32 engine are
  token-exact against the JAX engine at ``async_depth=0``, with the same
  hit and copy-on-write counts (30 and 3), for native and int8 KV, and
  still one dispatch and one sync per iteration.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import model as jax_model
from repro.serving import kvcache as jax_kvcache
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro.serving.request import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import kvcache
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.request import Request


def _stats(kv):
    """The counters both packages keep (the port has no upload path)."""
    snap = kv.stats.snapshot()
    snap.pop("upload_bytes", None)
    return snap


def test_allocator_matches_jax_on_random_ops():
    mgrs = [m.PagedKVManager(total_pages=24, page_size=4, bytes_per_token=1,
                             avg_decode_len=4.0, prefix_caching=True)
            for m in (jax_kvcache, kvcache)]
    rng = np.random.default_rng(0)
    live: list[tuple[int, list[int]]] = []
    next_rid = 0
    for _ in range(300):
        op = int(rng.integers(0, 4))
        if op == 0 or not live:
            plen = int(rng.integers(1, 14))
            prompt = [int(t) for t in rng.integers(0, 3, size=plen)]
            ok = {m.allocate(next_rid, plen, token_ids=prompt) for m in mgrs}
            assert len(ok) == 1
            if ok.pop():
                live.append((next_rid, prompt))
                next_rid += 1
        elif op == 1:
            i = int(rng.integers(len(live)))
            rid, toks = live[i]
            toks = toks + [int(rng.integers(0, 3))]
            ok = {m.ensure(rid, len(toks)) for m in mgrs}
            assert len(ok) == 1
            if ok.pop():
                assert all(m.extend(rid, len(toks), token_ids=toks)
                           for m in mgrs)
                live[i] = (rid, toks)
        elif op == 2:
            rid, _ = live.pop(int(rng.integers(len(live))))
            for m in mgrs:
                m.free(rid)
        else:
            assert mgrs[0].take_pending_copies() == \
                mgrs[1].take_pending_copies()
        want, got = mgrs
        assert got.tables == want.tables
        assert {r: got.cached_tokens(r) for r in got.tables} == \
            {r: want.cached_tokens(r) for r in want.tables}
        assert sorted(got.free_pages) == sorted(want.free_pages)
        assert _stats(got) == _stats(want)
    want, got = mgrs
    assert got.take_pending_copies() == want.take_pending_copies()
    s = got.stats
    assert s.prefix_hit_tokens > 0 and s.cow_copies > 0
    assert s.evicted_blocks > 0 and s.extend_failures == 0


def test_allocate_counts_matched_cached_blocks_as_taken():
    """Blocks that a prompt matches in the evictor are not free for the
    rest of its table: with 3 pages, 2 of them cached, a 4-block prompt
    that matches the 2 is refused and nothing changes (the JAX allocator
    admits it and runs dry mid-allocation, ROADMAP C3)."""
    kv = kvcache.PagedKVManager(total_pages=3, page_size=4, bytes_per_token=1,
                                avg_decode_len=4.0, prefix_caching=True)
    p0 = list(range(1, 10))
    assert kv.allocate(0, 9, token_ids=p0)
    assert kv.extend(0, 9, token_ids=p0)           # registers blocks 0, 1
    kv.free(0)
    assert len(kv.evictor) == 2 and len(kv.free_pages) == 1
    assert not kv.allocate(1, 13, token_ids=p0[:8] + [20] * 5)
    assert len(kv.evictor) == 2 and len(kv.free_pages) == 1
    assert kv.stats.prefix_hit_tokens == 0 and kv.pages_used == 0


def test_no_prefix_mode_keeps_blocks_private():
    kv = kvcache.PagedKVManager(total_pages=8, page_size=4, bytes_per_token=1,
                                avg_decode_len=4.0)
    assert kv.allocate(0, 8, token_ids=[1] * 8)
    assert kv.extend(0, 8, token_ids=[1] * 8)
    assert kv.allocate(1, 8, token_ids=[1] * 8)
    assert kv.cached_tokens(1) == 0 and not set(kv.table(0)) & set(kv.table(1))
    assert kv.take_pending_copies() == []
    kv.free(0)
    kv.free(1)
    assert sorted(kv.free_pages) == list(range(8)) and kv.pages_used == 0


ENGINE = dict(max_slots=4, max_len=64, kv_block_size=8, discrete_sizes=(16, 8),
              avg_decode_len=4.0, async_depth=0, prefix_caching=True)
BASE = list(range(11, 21))                       # 10 shared prompt tokens
WAVES = ([(0, BASE + [30])], [(i, BASE + [30 + i]) for i in range(1, 4)])


@pytest.fixture(scope="module")
def toy():
    jcfg = dataclasses.replace(jax_get_config("tiny-toy"), dtype="float32")
    tcfg = dataclasses.replace(get_config("tiny-toy"), dtype="float32")
    jparams = jax_model.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, from_jax_params(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")


def _serve(eng, request_cls):
    outs = {}
    for wave in WAVES:
        for rid, prompt in wave:
            # 6 new tokens: the committed stream then fills and registers a
            # second block, which arms the partial-tail copy for wave 2
            eng.submit(request_cls(rid=rid, prompt=list(prompt),
                                   max_new_tokens=6))
        outs.update({r.rid: tuple(r.output) for r in eng.run()})
    return outs


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefix_engine_token_exact_vs_jax(toy, kv_dtype):
    jcfg, jparams, tcfg, tparams = toy
    jeng = JaxServeEngine(jcfg, jparams,
                          JaxEngineConfig(**ENGINE, kv_dtype=kv_dtype))
    teng = ServeEngine(tcfg, tparams, EngineConfig(**ENGINE, kv_dtype=kv_dtype),
                       device="cpu")
    want = _serve(jeng, JaxRequest)
    got = _serve(teng, Request)
    assert len(got) == 4 and got == want
    s = teng.kv.stats
    assert s.prefix_hit_tokens == 30                 # 3 requests x 10 tokens
    assert s.cow_copies == 3                         # one mid-block copy each
    assert _stats(teng.kv) == _stats(jeng.kv)
    assert teng.scheduler.prefix_hit_tokens == 30
    assert teng.stats.iterations == jeng.stats.iterations
    assert teng.stats.dispatches_per_iter == 1.0
    assert teng.stats.syncs_per_iter == 1.0
    assert teng.stats.kv_quant_bytes_saved == jeng.stats.kv_quant_bytes_saved
