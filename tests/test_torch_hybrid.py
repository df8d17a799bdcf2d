"""The port's Mamba hybrid against the JAX package, f32 on the CPU.

The model is Jamba-1.5-Large's layer pattern at scaled-down widths
(``scale_down``: one 8-layer group, 7 Mamba layers and attention at index
4) with every FFN dense and no experts: a choice of this file, which
tests the Mamba paths apart from the experts (Jamba with its MoE layers
is held to JAX in ``tests/test_torch_moe.py`` and
``tests/test_torch_moe_engine.py``).  Both packages run the same weights
(the JAX ``model.init`` pytree, converted with ``from_jax_params``):
``forward_full(return_states=True)``, ``prefill``, ``forward_chunk``,
``forward_decode`` and ``forward_packed`` must agree to atol 1e-4 (the
packages sum in different orders), caches and recurrent states included;
the legacy-incremental, recompute and packed engines must be token-exact
against the JAX engine in the same mode, stepped in lock-step through slot
reuse, with equal dispatch, sync and prefill-work counts.
"""
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
from repro.serving.engine import kv_bytes_per_token as jax_kv_bytes
from repro.serving.request import Request as JaxRequest
from repro_torch.configs import ATTN, FFN_DENSE, get_config, scale_down
from repro_torch.models import model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import ServeEngine, kv_bytes_per_token
from repro_torch.serving.request import Request

ATOL = 1e-4
JAMBA = "jamba-1.5-large-398b"


def _dense(cfg, **kw):
    """No experts: every layer's FFN dense (``dataclasses.replace`` on
    either package's config)."""
    pattern = tuple(dataclasses.replace(s, ffn=FFN_DENSE)
                    for s in cfg.block_pattern)
    return dataclasses.replace(cfg, moe=None, block_pattern=pattern, **kw)


@pytest.fixture(scope="module")
def models():
    """(jax cfg, torch cfg, jax params, torch params) on the CPU, f32."""
    jcfg = _dense(jax_scale_down(jax_get_config(JAMBA)), dtype="float32")
    tcfg = _dense(scale_down(get_config(JAMBA)), dtype="float32")
    assert [s.mixer for s in tcfg.layer_specs()] == \
        ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    jparams = jax_model.init(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _per_layer(cfg, stacked):
    """JAX per-group stacked trees -> one dict of numpy leaves per layer."""
    out = []
    for gi, (pattern, reps) in enumerate(cfg.layer_groups()):
        for r in range(reps):
            for i in range(len(pattern)):
                out.append(jax.tree.map(lambda a, r=r: np.asarray(a)[r],
                                        stacked[gi][f"sub{i}"]))
    return out


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def _cache_close(jcfg, jcache, tcache):
    jl = _per_layer(jcfg, jcache)
    assert len(jl) == len(tcache)
    for j, t in zip(jl, tcache):
        assert set(j) == set(t)
        for name in t:
            _close(t[name], j[name])


def test_forward_full_and_prefill_match_jax(models):
    """Two 13-token prompts: logits and each layer's state (K/V for the
    attention layer, the final conv history and scan state for Mamba);
    then ``prefill`` into a 24-row cache."""
    jcfg, tcfg, jparams, tparams = models
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 13)) \
        .astype(np.int32)
    jlog, _, jstates = jax_model.forward_full(
        jcfg, jparams, jnp.asarray(toks), return_states=True)
    tlog, taux, tstates = model.forward_full(
        tcfg, tparams, torch.from_numpy(toks), return_states=True)
    _close(tlog, jlog)
    assert float(taux) == 0.0
    for spec, j, t in zip(tcfg.layer_specs(), _per_layer(jcfg, jstates),
                          tstates):
        if spec.mixer == ATTN:
            _close(t["kv"][0], j["kv"][0])
            _close(t["kv"][1], j["kv"][1])
        else:
            _close(t["conv"], j["conv"])
            _close(t["ssm"], j["ssm"])
    jlast, jcache, _ = jax_model.prefill(jcfg, jparams, jnp.asarray(toks),
                                         max_len=24)
    tlast, tcache, tlen = model.prefill(tcfg, tparams, torch.from_numpy(toks),
                                        max_len=24)
    _close(tlast, jlast)
    _cache_close(jcfg, jcache, tcache)
    assert tlen.tolist() == [13, 13]


# (kind, length, cache_len per row) over 3 rows of a 16-row cache; the
# 2-token chunk is shorter than d_conv - 1, so the carried conv history
# spans two chunks
STEPS = [("chunk", 5, [0, 0, 0]), ("chunk", 2, [5, 5, 5]),
         ("decode", 1, [7, 7, 7]), ("chunk", 4, [8, 8, 8]),
         ("decode", 1, [12, 12, 12])]


def test_chunk_and_decode_match_jax(models):
    """A cache filled chunk by chunk with decodes in between: logits and
    every cache leaf after each call.  ``forward_decode`` returns new
    Mamba states and leaves the given ones as they were."""
    jcfg, tcfg, jparams, tparams = models
    rng = np.random.default_rng(7)
    jcache = jax_model.init_cache(jcfg, 1, 3, 16)
    tcache = model.init_cache(tcfg, 3, 16, device="cpu")
    for kind, length, clen in STEPS:
        toks = rng.integers(0, tcfg.vocab_size, (3, length)).astype(np.int32)
        clen = np.asarray(clen, np.int32)
        if kind == "chunk":
            jlog, jcache = jax_model.forward_chunk(
                jcfg, jparams, jnp.asarray(toks), jcache, jnp.asarray(clen))
            tlog, tcache = model.forward_chunk(
                tcfg, tparams, torch.from_numpy(toks), tcache,
                torch.from_numpy(clen))
        else:
            jlog, jcache = jax_model.forward_decode(
                jcfg, jparams, jnp.asarray(toks), jcache, jnp.asarray(clen))
            before = [{k: v.clone() for k, v in c.items()} for c in tcache]
            tlog, new = model.forward_decode(
                tcfg, tparams, torch.from_numpy(toks), tcache,
                torch.from_numpy(clen))
            for spec, b, c, n in zip(tcfg.layer_specs(), before, tcache, new):
                if spec.mixer != ATTN:
                    assert n is not c
                    assert all(torch.equal(b[k], c[k]) for k in c)
            tcache = new
        _close(tlog, jlog)
        _cache_close(jcfg, jcache, tcache)


def test_forward_packed_matches_jax(models):
    """Two packed iterations over 3 slots: first a 6-token chunk of slot 0
    and a 3-token chunk of slot 2 with 3 padding tokens; then slot 0's
    decode token, slot 2's next 4-token chunk and slot 1's first 2 tokens,
    with 1 padding token.  Padding tokens sit on slot 1 and must not
    commit its state."""
    jcfg, tcfg, jparams, tparams = models
    rng = np.random.default_rng(9)
    max_len = 16
    jcache = jax_model.init_cache(jcfg, 1, 3, max_len)
    tcache = model.init_cache(tcfg, 3, max_len, device="cpu")
    streams = [([0] * 6 + [2] * 3 + [1] * 3,
                list(range(6)) + list(range(3)) + [0] * 3, 9),
               ([0] + [2] * 4 + [1] * 2 + [1],
                [6] + list(range(3, 7)) + [0, 1] + [0], 7)]
    for slot, pos, n_real in streams:
        slot = np.asarray(slot, np.int32)
        pos = np.asarray(pos, np.int32)
        active = np.arange(len(slot)) < n_real
        wpos = np.where(active, pos, max_len).astype(np.int32)
        toks = rng.integers(0, tcfg.vocab_size, len(slot)).astype(np.int32)
        jlog, jcache = jax_model.forward_packed(
            jcfg, jparams, jnp.asarray(toks)[None], jcache, jnp.asarray(slot),
            jnp.asarray(pos), jnp.asarray(wpos), jnp.asarray(active),
            kv_bucket=max_len)
        tlog, tcache = model.forward_packed(
            tcfg, tparams, torch.from_numpy(toks)[None], tcache,
            torch.from_numpy(slot), torch.from_numpy(pos),
            torch.from_numpy(wpos), torch.from_numpy(active),
            kv_bucket=max_len)
        _close(tlog[0, :n_real], np.asarray(jlog)[0, :n_real])
        _cache_close(jcfg, jcache, tcache)
    with pytest.raises(ValueError, match="token_active"):
        model.forward_packed(tcfg, tparams, torch.from_numpy(toks)[None],
                             tcache, torch.from_numpy(slot),
                             torch.from_numpy(pos), torch.from_numpy(wpos),
                             kv_bucket=max_len)


def _reuse_workload(vocab):
    """tests/test_chunked_prefill.py:227: 5 requests of 3-11 prompt tokens
    on 2 slots (slots are reused), ``max_len`` 48, 3 new tokens each."""
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(0, vocab,
                                             size=int(rng.integers(3, 12)))]
               for _ in range(5)]
    return (dict(max_slots=2, max_len=48, discrete_sizes=(16, 8),
                 avg_decode_len=4), prompts, 3)


MODES = {"legacy": dict(step_mode="legacy"),
         "recompute": dict(prefill_mode="recompute"),
         "packed": dict(step_mode="packed", async_depth=0)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_token_exact_vs_jax(models, mode):
    """The JAX and the port's engines in the same mode, stepped in
    lock-step: per-slot ``cache_len`` and every recurrent state after each
    iteration, the finished tokens, and the iteration, dispatch, sync and
    prefill-work counts."""
    jcfg, tcfg, jparams, tparams = models
    engine, prompts, new = _reuse_workload(tcfg.vocab_size)
    jeng = JaxServeEngine(jcfg, jparams,
                          JaxEngineConfig(**engine, **MODES[mode]))
    teng = ServeEngine(tcfg, tparams, EngineConfig(**engine, **MODES[mode]),
                       device="cpu")
    assert jeng.step_mode == teng.step_mode
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
        for spec, j, t in zip(tcfg.layer_specs(),
                              _per_layer(jcfg, jeng.cache), teng.cache):
            if spec.mixer != ATTN:
                _close(t["conv"], j["conv"])
                _close(t["ssm"], j["ssm"])
    assert len(got) == len(prompts) and got == want
    j, t = jeng.stats, teng.stats
    for field in ("iterations", "model_dispatches", "host_syncs",
                  "prefill_model_tokens", "prefill_tokens", "decode_tokens"):
        assert getattr(t, field) == getattr(j, field) > 0, field
    if mode == "packed":
        assert t.dispatches_per_iter == 1.0 and t.syncs_per_iter == 1.0
    else:
        assert t.dispatches_per_iter > 1.0


def test_kv_bytes_per_token_counts_attention_layers_only(models):
    """The one attention layer's rows, as JAX's function counts them, in
    both KV dtypes; at full Jamba width with dense FFNs, 8 layers, that is
    2 x 8 KV heads x 128 x 2 bytes = 4096 B/token in bf16."""
    jcfg, tcfg, _, _ = models
    for kv_dtype in (None, "int8"):
        assert kv_bytes_per_token(tcfg, kv_dtype) == \
            jax_kv_bytes(jcfg, kv_dtype) > 0
    full = _dense(get_config(JAMBA), n_layers=8)
    assert kv_bytes_per_token(full) == jax_kv_bytes(
        _dense(jax_get_config(JAMBA), n_layers=8)) == 4096


def test_engine_refuses_what_jax_refuses(models):
    """Prefix caching and speculative decoding on a model with recurrent
    layers: both engines refuse; int8 KV both take (its attention leaves
    go int8, ``tests/test_torch_xlstm_engine.py``)."""
    jcfg, tcfg, jparams, tparams = models
    with pytest.raises(ValueError, match="attention-only"):
        ServeEngine(tcfg, tparams, EngineConfig(prefix_caching=True),
                    device="cpu")
    with pytest.raises(AssertionError):
        JaxServeEngine(jcfg, jparams, JaxEngineConfig(prefix_caching=True))
    with pytest.raises(ValueError, match="attention-only"):
        ServeEngine(tcfg, tparams, EngineConfig(spec_k=2), device="cpu")
    with pytest.raises(AssertionError):
        JaxServeEngine(jcfg, jparams, JaxEngineConfig(spec_k=2))
    ServeEngine(tcfg, tparams, EngineConfig(kv_dtype="int8"), device="cpu")
    JaxServeEngine(jcfg, jparams, JaxEngineConfig(kv_dtype="int8"))
