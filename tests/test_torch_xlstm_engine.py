"""The port's engine on the xLSTM model and on the int8 Mamba hybrid
against the JAX engine, greedy, f32, on the CPU.

``scale_down(xlstm-1.3b)`` (7 mLSTM layers and an sLSTM layer, no
attention) on the packed step at async depths 0 and 1, the legacy step
and recompute prefill, stepped in lock-step with the JAX engine in the
same mode through slot reuse: per-slot ``cache_len`` and every state leaf
after each iteration, the finished tokens and the iteration, dispatch,
sync and prefill-work counts.  A model without attention caches nothing
per token: both engines rate it 0 KV bytes per token, and account for its
KV alike.  Then the Jamba hybrid of ``tests/test_torch_hybrid.py`` (one
attention layer, 7 Mamba layers, dense FFNs) with int8 KV on the packed
step, held to the JAX int8 hybrid engine (never to bf16: ROADMAP C1): the
attention leaves go int8 with their scales, the Mamba state keeps f32.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_serving import models as serving_models
from _torch_serving import run
from repro.configs import get_config as jax_get_config
from repro.configs import scale_down as jax_scale_down
from repro.models import model as jax_model
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro.serving.engine import kv_bytes_per_token as jax_kv_bytes
from repro.serving.request import Request as JaxRequest
from repro_torch.configs import ATTN, get_config, scale_down
from repro_torch.models.convert import from_jax_params
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import ServeEngine, kv_bytes_per_token
from repro_torch.serving.request import Request

XLSTM = "xlstm-1.3b"
ATOL = 1e-4
ENGINE = dict(max_slots=2, max_len=48, discrete_sizes=(16, 8),
              avg_decode_len=4)
MODES = {"legacy": dict(step_mode="legacy"),
         "recompute": dict(prefill_mode="recompute"),
         "packed-0": dict(step_mode="packed", async_depth=0),
         "packed-1": dict(step_mode="packed", async_depth=1,
                          async_harvest=False)}
COUNTS = ("iterations", "model_dispatches", "host_syncs",
          "prefill_model_tokens", "prefill_tokens", "decode_tokens")


@pytest.fixture(scope="module")
def models():
    """(jax cfg, torch cfg, jax params, torch params) on the CPU, f32."""
    jcfg = dataclasses.replace(jax_scale_down(jax_get_config(XLSTM)),
                               dtype="float32")
    tcfg = dataclasses.replace(scale_down(get_config(XLSTM)),
                               dtype="float32")
    jparams = jax_model.init(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _prompts(vocab):
    """tests/test_chunked_prefill.py:227: 5 requests of 3-11 prompt
    tokens on 2 slots (slots are reused), 3 new tokens each."""
    rng = np.random.default_rng(1)
    return [[int(t) for t in rng.integers(0, vocab,
                                          size=int(rng.integers(3, 12)))]
            for _ in range(5)]


def _per_layer(cfg, stacked):
    out = []
    for gi, (pattern, reps) in enumerate(cfg.layer_groups()):
        for r in range(reps):
            for i in range(len(pattern)):
                out.append(jax.tree.map(lambda a, r=r: np.asarray(a)[r],
                                        stacked[gi][f"sub{i}"]))
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_token_exact_vs_jax(models, mode):
    """Lock-step through slot reuse; at depth 1 the JAX engine and the
    port's each retire one iteration late, so the states are compared
    after every step, the launches in flight included."""
    jcfg, tcfg, jparams, tparams = models
    prompts = _prompts(tcfg.vocab_size)
    jeng = JaxServeEngine(jcfg, jparams, JaxEngineConfig(**ENGINE,
                                                         **MODES[mode]))
    teng = ServeEngine(tcfg, tparams, EngineConfig(**ENGINE, **MODES[mode]),
                       device="cpu")
    assert jeng.step_mode == teng.step_mode
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, prompt=list(p), max_new_tokens=3))
        teng.submit(Request(rid=i, prompt=list(p), max_new_tokens=3))
    want, got = {}, {}
    while True:
        jplan, tplan = jeng.scheduler.plan(), teng.scheduler.plan()
        assert (jplan is None) == (tplan is None)
        if jplan is None:
            if not jeng.in_flight:
                break
            want.update({r.rid: r.output for r in jeng.drain(1)})
            got.update({r.rid: r.output for r in teng.drain(1)})
            continue
        want.update({r.rid: r.output for r in jeng.step(jplan)})
        got.update({r.rid: r.output for r in teng.step(tplan)})
        np.testing.assert_array_equal(teng.cache_len.numpy(),
                                      np.asarray(jeng.cache_len))
        for j, t in zip(_per_layer(jcfg, jeng.cache), teng.cache):
            assert set(j) == set(t)
            for name in t:
                np.testing.assert_allclose(t[name].numpy(), j[name],
                                           rtol=0, atol=ATOL)
    assert teng.in_flight == jeng.in_flight == 0
    assert len(got) == len(prompts) and got == want
    for field in COUNTS:
        assert getattr(teng.stats, field) == getattr(jeng.stats, field) > 0, \
            field
    if teng.step_mode == "packed":
        assert teng.stats.dispatches_per_iter == 1.0
        assert teng.stats.syncs_per_iter == 1.0
    else:
        assert teng.stats.dispatches_per_iter > 1.0


def test_attention_free_model_caches_nothing_per_token(models):
    """0 KV bytes per token in both packages and KV dtypes, at the
    scaled-down and the full width.  Under a KV byte budget (which buys
    nothing at 0 bytes a token, and is not divided by them) the pool falls
    back to max_slots x max_len rows, as JAX's does; serving gives the same
    tokens and the same KV accounting, offloads of 1 byte a request
    included (nothing is cached per token)."""
    jcfg, tcfg, jparams, tparams = models
    for kv_dtype in (None, "int8"):
        assert kv_bytes_per_token(tcfg, kv_dtype) == \
            jax_kv_bytes(jcfg, kv_dtype) == 0
    assert kv_bytes_per_token(get_config(XLSTM)) == \
        jax_kv_bytes(jax_get_config(XLSTM)) == 0
    budget = dict(ENGINE, kv_budget_bytes=1 << 20, kv_block_size=8)
    jeng, want = run(True, jcfg, jparams, _prompts(tcfg.vocab_size)[:3],
                     max_new=2, **budget)
    teng, got = run(False, tcfg, tparams, _prompts(tcfg.vocab_size)[:3],
                    max_new=2, **budget)
    assert got == want
    tkv, jkv = teng.kv.stats.snapshot(), jeng.kv.stats.snapshot()
    assert tkv["device_pages_total"] == 2 * 48 // 8
    assert tkv["offload_bytes"] == 3
    assert {k: jkv[k] for k in tkv} == tkv


@pytest.mark.parametrize("depth", [0, 1])
def test_int8_hybrid_token_exact_vs_jax_int8(depth):
    """The Jamba hybrid with int8 KV on the packed step: the same tokens
    as the JAX int8 hybrid engine, the same counts and the same bytes
    saved; the attention layer's leaves are int8 with f32 scales, the
    Mamba state f32 as in the bf16 cache."""
    jcfg, tcfg, jparams, tparams = serving_models("hybrid")
    cfg = dict(ENGINE, step_mode="packed", async_depth=depth,
               async_harvest=False, kv_dtype="int8", kv_block_size=8)
    prompts = _prompts(tcfg.vocab_size)
    jeng, want = run(True, jcfg, jparams, prompts, max_new=3, **cfg)
    teng, got = run(False, tcfg, tparams, prompts, max_new=3, **cfg)
    assert got == want
    for field in COUNTS + ("kv_quant_bytes_saved",):
        assert getattr(teng.stats, field) == getattr(jeng.stats, field), \
            field
    assert teng.stats.kv_quant_bytes_saved > 0
    for spec, layer in zip(tcfg.layer_specs(), teng.cache):
        if spec.mixer == ATTN:
            assert {n: t.dtype for n, t in layer.items()} == {
                "k": torch.int8, "v": torch.int8, "k_s": torch.float32,
                "v_s": torch.float32}
        else:
            assert layer["ssm"].dtype == torch.float32
