"""The port's legacy step and recompute prefill against the JAX package,
f32 on the CPU.

Both packages run the same weights (the JAX ``model.init`` pytree,
converted with ``repro_torch.models.convert.from_jax_params``):
``forward_full(return_states=True)``, ``prefill``, ``forward_chunk`` and
``forward_decode`` must agree to atol 1e-4 (f32; the packages sum in
different orders) on tiny-toy and a 2-layer scaled Qwen3-8B, including the
clamped writes at the end of a slot; the legacy and the recompute engines
must be token-exact against the JAX engine in the same mode, stepped in
lock-step, with equal dispatch, sync and prefill-work counts.
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
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro.serving.request import Request as JaxRequest
from repro_torch.configs import get_config, scale_down
from repro_torch.models import model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.request import Request

ATOL = 1e-4


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _models(name):
    """(jax cfg, torch cfg, jax params, torch params) on the CPU, f32."""
    if name == "tiny-toy":
        jcfg, tcfg = _f32(jax_get_config(name)), _f32(get_config(name))
    else:
        # qk-norm, theta 1e6, 16 heads over 8 KV heads: GQA group 2
        kw = dict(n_layers=2, d_model=256, n_heads=16)
        jcfg = _f32(jax_scale_down(jax_get_config(name), **kw))
        tcfg = _f32(scale_down(get_config(name), **kw))
    jparams = jax_model.init(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _per_layer(cfg, stacked, leaf):
    """JAX per-group stacked trees -> per-layer numpy arrays of ``leaf``."""
    out = []
    for gi, (pattern, reps) in enumerate(cfg.layer_groups()):
        for r in range(reps):
            for i in range(len(pattern)):
                out.append(leaf(stacked[gi][f"sub{i}"], r))
    return out


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def _cache_close(jcfg, jcache, tcache):
    jleaves = _per_layer(jcfg, jcache, lambda c, r: (c["k"][r], c["v"][r]))
    for (jk, jv), tc in zip(jleaves, tcache):
        _close(tc["k"], jk)
        _close(tc["v"], jv)


@pytest.mark.parametrize("name", ["tiny-toy", "qwen3-8b"])
def test_forward_full_and_prefill_match_jax(name):
    """Two 13-token prompts: logits, aux and each layer's (k, v) states;
    then ``prefill`` into a 24-row cache: last logits, every cache row and
    ``cache_len``."""
    jcfg, tcfg, jparams, tparams = _models(name)
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 13)) \
        .astype(np.int32)
    jlog, jaux, jstates = jax_model.forward_full(
        jcfg, jparams, jnp.asarray(toks), return_states=True)
    tlog, taux, tstates = model.forward_full(
        tcfg, tparams, torch.from_numpy(toks), return_states=True)
    assert tlog.shape == (2, 13, tcfg.vocab_size) and float(taux) == 0.0
    _close(tlog, jlog)
    _close(taux, jaux)
    jkv = _per_layer(jcfg, jstates, lambda st, r: (st["kv"][0][r],
                                                   st["kv"][1][r]))
    assert len(jkv) == len(tstates) == tcfg.n_layers
    for (jk, jv), st in zip(jkv, tstates):
        _close(st["kv"][0], jk)
        _close(st["kv"][1], jv)

    jlast, jcache, jlen = jax_model.prefill(jcfg, jparams, jnp.asarray(toks),
                                            max_len=24)
    tlast, tcache, tlen = model.prefill(tcfg, tparams,
                                        torch.from_numpy(toks), max_len=24)
    _close(tlast, jlast)
    assert tcache[0]["k"].shape == (2, 24, tcfg.n_kv_heads,
                                    tcfg.resolved_head_dim)
    _cache_close(jcfg, jcache, tcache)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))


# (kind, length, cache_len per row) over 3 rows of a 16-row cache.  The
# second chunk writes row 2 at offset 14 with 4 tokens (past S: the write
# clamps to rows 12-15 while attention keeps q_offset 14); the first decode
# writes row 2 at cache_len == S (clamped to row 15; attention over S + 1
# rows reads all 16).
STEPS = [("chunk", 5, [0, 0, 0]), ("chunk", 4, [5, 3, 14]),
         ("decode", 1, [9, 7, 16]), ("chunk", 3, [10, 8, 5]),
         ("decode", 1, [13, 15, 8])]


@pytest.mark.parametrize("name", ["tiny-toy", "qwen3-8b"])
def test_chunk_and_decode_match_jax(name):
    """A cache filled chunk by chunk at per-row offsets, with decodes in
    between: logits and every cache row after each call, including the
    clamped writes at the end of the slot."""
    jcfg, tcfg, jparams, tparams = _models(name)
    rng = np.random.default_rng(7)
    jcache = jax_model.init_cache(jcfg, 1, 3, 16)
    tcache = model.init_cache(tcfg, 3, 16, device="cpu")
    for kind, length, clen in STEPS:
        toks = rng.integers(0, tcfg.vocab_size, (3, length)).astype(np.int32)
        clen = np.asarray(clen, np.int32)
        fn = (jax_model.forward_chunk, model.forward_chunk) if kind == "chunk" \
            else (jax_model.forward_decode, model.forward_decode)
        jlog, jcache = fn[0](jcfg, jparams, jnp.asarray(toks), jcache,
                             jnp.asarray(clen))
        tlog, tcache = fn[1](tcfg, tparams, torch.from_numpy(toks), tcache,
                             torch.from_numpy(clen))
        _close(tlog, jlog)
        _cache_close(jcfg, jcache, tcache)


def _reuse_workload(vocab):
    """tests/test_packed_step.py:135: 5 requests of 3-11 prompt tokens on 2
    slots (slots are reused), 3 new tokens each."""
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(0, vocab,
                                             size=int(rng.integers(3, 12)))]
               for _ in range(5)]
    return (dict(max_slots=2, max_len=48, discrete_sizes=(16, 8),
                 avg_decode_len=4), prompts, 3)


def _six_workload(vocab):
    """tests/test_packed_step.py:156: 6 requests of 20 prompt tokens on 4
    slots, 4 new tokens each."""
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, vocab, size=20)]
               for _ in range(6)]
    return (dict(max_slots=4, max_len=64, discrete_sizes=(32, 16, 8),
                 avg_decode_len=4), prompts, 4)


MODES = {"legacy": dict(step_mode="legacy"),
         "recompute": dict(prefill_mode="recompute")}
WORKLOADS = {"reuse": _reuse_workload, "six": _six_workload}


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_token_exact_vs_jax(mode, workload):
    """The JAX and the port's engines in the same mode, stepped in
    lock-step: per-slot ``cache_len`` after every iteration, the finished
    tokens, and the iteration, dispatch, sync and prefill-work counts."""
    jcfg, tcfg, jparams, tparams = _models("tiny-toy")
    engine, prompts, new = WORKLOADS[workload](tcfg.vocab_size)
    jeng = JaxServeEngine(jcfg, jparams,
                          JaxEngineConfig(**engine, **MODES[mode]))
    teng = ServeEngine(tcfg, tparams, EngineConfig(**engine, **MODES[mode]),
                       device="cpu")
    assert jeng.step_mode == teng.step_mode == "legacy"
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, prompt=list(p), max_new_tokens=new))
        teng.submit(Request(rid=i, prompt=list(p), max_new_tokens=new))
    want, got = {}, {}
    while True:
        jplan, tplan = jeng.scheduler.plan(), teng.scheduler.plan()
        assert (jplan is None) == (tplan is None)
        if jplan is None:
            break
        want.update({r.rid: r.output for r in jeng.step(jplan)})
        got.update({r.rid: r.output for r in teng.step(tplan)})
        np.testing.assert_array_equal(teng.cache_len.numpy(),
                                      np.asarray(jeng.cache_len))
    assert len(got) == len(prompts) and got == want
    j, t = jeng.stats, teng.stats
    for field in ("iterations", "model_dispatches", "host_syncs",
                  "prefill_model_tokens", "prefill_tokens", "decode_tokens"):
        assert getattr(t, field) == getattr(j, field) > 0, field
    assert t.dispatches_per_iter > 1.0 and t.syncs_per_iter > 1.0
    if mode == "recompute":
        assert t.prefill_expansion > 1.0


def test_packed_legacy_and_recompute_agree():
    """The port's three steps serve the same greedy tokens, with slot
    reuse (as ``test_engine_packed_matches_legacy`` asserts for JAX)."""
    cfg = _f32(get_config("tiny-toy"))
    params = model.init(cfg, seed=0, device="cpu")
    engine, prompts, new = _reuse_workload(cfg.vocab_size)
    outs = {}
    for mode, kw in dict(MODES, packed=dict(step_mode="packed")).items():
        eng = ServeEngine(cfg, params, EngineConfig(**engine, **kw),
                          device="cpu")
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=list(p), max_new_tokens=new))
        outs[mode] = {r.rid: r.output for r in eng.run()}
        assert len(outs[mode]) == len(prompts)
    assert outs["packed"] == outs["legacy"] == outs["recompute"]
