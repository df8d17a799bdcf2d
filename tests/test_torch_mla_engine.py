"""The port's engine on DeepSeek-V2 (absorbed MLA, its dense layer 0 and
MoE layer 1) against the JAX engine, greedy, f32, on the CPU.

``scale_down(deepseek-v2-236b)`` at ``capacity_factor`` 16, as every JAX
engine test runs it (the steps cut the MoE dispatch groups differently, so
at 1.25 they may drop different pairs), with the same weights (the JAX
pytree converted) and requests in both: the packed step, the legacy step,
recompute prefill, prefix caching (two waves on a 10-token shared prefix),
int8 KV (held to the JAX int8 engine, never to bf16: ROADMAP C1) and
speculative decoding at spec_k 2 with the n-gram drafter on the JAX spec
test's prompts.  Outputs must be identical, with equal iteration,
dispatch, sync and prefill-work counts (and prefix-hit, copy-on-write and
speculation counters where they apply).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

from _torch_serving import run
from repro.configs import get_config as jax_get_config
from repro.configs import scale_down as jax_scale_down
from repro.models import model as jax_model
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro.serving.request import Request as JaxRequest
from repro_torch.configs import get_config, scale_down
from repro_torch.models.convert import from_jax_params
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.request import Request

DEEPSEEK = "deepseek-v2-236b"
ENGINE = dict(max_slots=2, max_len=48, discrete_sizes=(16, 8),
              avg_decode_len=4)
CASES = {"packed": dict(step_mode="packed", async_depth=0),
         "legacy": dict(step_mode="legacy"),
         "recompute": dict(prefill_mode="recompute"),
         "int8": dict(step_mode="packed", async_depth=0, kv_dtype="int8",
                      kv_block_size=8)}
COUNTS = ("iterations", "model_dispatches", "host_syncs",
          "prefill_model_tokens", "prefill_tokens", "decode_tokens")


@functools.lru_cache(maxsize=None)
def models():
    cfgs = []
    for cfg in (jax_scale_down(jax_get_config(DEEPSEEK)),
                scale_down(get_config(DEEPSEEK))):
        cfgs.append(dataclasses.replace(
            cfg, dtype="float32",
            moe=dataclasses.replace(cfg.moe, capacity_factor=16.0)))
    jcfg, tcfg = cfgs
    jparams = jax_model.init(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _same_counts(jeng, teng, fields=COUNTS):
    for field in fields:
        assert getattr(teng.stats, field) == getattr(jeng.stats, field), field


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_token_exact_vs_jax(case):
    """5 requests of 3-11 prompt tokens on 2 slots, 3 new tokens each."""
    jcfg, tcfg, jparams, tparams = models()
    mode = CASES[case]
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(0, tcfg.vocab_size,
                                             size=int(rng.integers(3, 12)))]
               for _ in range(5)]
    jeng, want = run(True, jcfg, jparams, prompts, max_new=3, **ENGINE,
                     **mode)
    teng, got = run(False, tcfg, tparams, prompts, max_new=3, **ENGINE,
                    **mode)
    assert got == want
    assert teng.step_mode == jeng.step_mode == mode.get("step_mode",
                                                         "legacy")
    _same_counts(jeng, teng)
    assert teng.stats.iterations > 0 and teng.stats.decode_tokens > 0
    if teng.step_mode == "packed":
        assert teng.stats.dispatches_per_iter == 1.0
        assert teng.stats.syncs_per_iter == 1.0
        assert teng.stats.kv_quant_bytes_saved == \
            jeng.stats.kv_quant_bytes_saved
    else:
        assert teng.stats.dispatches_per_iter > 1.0


BASE = list(range(11, 21))                       # 10 shared prompt tokens
WAVES = ([(0, BASE + [30])], [(i, BASE + [30 + i]) for i in range(1, 4)])


def test_prefix_caching_token_exact_vs_jax():
    """``tests/test_torch_prefix_caching.py``'s two waves on MLA's latent
    leaves (block size 8): the same outputs, prefix hits and copy-on-write
    copies as the JAX engine."""
    jcfg, tcfg, jparams, tparams = models()
    kw = dict(max_slots=4, max_len=64, kv_block_size=8,
              discrete_sizes=(16, 8), avg_decode_len=4.0, async_depth=0,
              prefix_caching=True)
    engines = (JaxServeEngine(jcfg, jparams, JaxEngineConfig(**kw)),
               ServeEngine(tcfg, tparams, EngineConfig(**kw), device="cpu"))
    outs = []
    for eng, request_cls in zip(engines, (JaxRequest, Request)):
        got = {}
        for wave in WAVES:
            for rid, prompt in wave:
                eng.submit(request_cls(rid=rid, prompt=list(prompt),
                                       max_new_tokens=6))
            got.update({r.rid: tuple(r.output) for r in eng.run()})
        outs.append(got)
    jeng, teng = engines
    assert len(outs[1]) == 4 and outs[1] == outs[0]
    assert teng.kv.stats.prefix_hit_tokens == \
        jeng.kv.stats.prefix_hit_tokens == 30
    assert teng.kv.stats.cow_copies == jeng.kv.stats.cow_copies == 3
    _same_counts(jeng, teng)
    assert teng.stats.dispatches_per_iter == teng.stats.syncs_per_iter == 1.0


def test_spec_decode_token_exact_vs_jax():
    """spec_k 2 at async depth 0, the n-gram drafter, on the JAX spec
    test's motif prompts and one random prompt
    (``tests/test_spec_decode.py:_prompts``): the same outputs and
    speculation counters as the JAX spec engine."""
    jcfg, tcfg, jparams, tparams = models()
    rng = np.random.default_rng(3)
    prompts = [[5, 9, 3, 7] * 5, ([2, 4] * 8)[:13],
               list(map(int, rng.integers(0, tcfg.vocab_size, size=7)))]
    kw = dict(max_slots=2, max_len=96, discrete_sizes=(16, 8),
              avg_decode_len=4.0, spec_k=2, async_depth=0,
              async_harvest=False)
    jeng, want = run(True, jcfg, jparams, prompts, max_new=12, **kw)
    teng, got = run(False, tcfg, tparams, prompts, max_new=12, **kw)
    assert got == want
    _same_counts(jeng, teng, COUNTS + ("spec_verify_segments",
                                       "spec_proposed_tokens",
                                       "spec_accepted_tokens"))
    assert teng.stats.spec_verify_segments > 0
    assert teng.stats.dispatches_per_iter == teng.stats.syncs_per_iter == 1.0
