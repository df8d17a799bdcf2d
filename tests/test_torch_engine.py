"""The port's serving engine against the JAX engine: greedy, f32, tiny-toy.

Same weights (converted from the JAX pytree), same requests, same engine
configuration with ``async_depth=0``: the token streams must be identical,
and each iteration must be one packed-step call and one device-to-host
copy.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

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
from repro.serving import sampling as jax_sampling
from repro.serving.request import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.models import model as torch_model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import sampling
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import ServeEngine, kv_bytes_per_token
from repro_torch.serving.request import Request

ENGINE = dict(max_slots=4, max_len=64, discrete_sizes=(32, 16, 8),
              avg_decode_len=4, async_depth=0)


def _prompts(vocab, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, size=20)]
            for _ in range(n)]


def test_engine_token_exact_vs_jax():
    """tests/test_packed_step.py's workload: 6 requests of 20 prompt tokens
    on 4 slots (so slots are reused), 4 new tokens each.  The two engines
    are stepped in lock-step; after every iteration the device state
    (per-slot ``cache_len`` and sampled-token buffer) must agree."""
    jcfg = dataclasses.replace(jax_get_config("tiny-toy"), dtype="float32")
    tcfg = dataclasses.replace(get_config("tiny-toy"), dtype="float32")
    jparams = jax_model.init(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    jeng = JaxServeEngine(jcfg, jparams, JaxEngineConfig(**ENGINE))
    teng = ServeEngine(tcfg, tparams, EngineConfig(**ENGINE), device="cpu")
    for i, p in enumerate(_prompts(tcfg.vocab_size)):
        jeng.submit(JaxRequest(rid=i, prompt=list(p), max_new_tokens=4))
        teng.submit(Request(rid=i, prompt=list(p), max_new_tokens=4))
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
        np.testing.assert_array_equal(teng.last_token.numpy(),
                                      np.asarray(jeng.last_token))
        np.testing.assert_array_equal(teng.accept_len.numpy(),
                                      np.asarray(jeng.accept_len))

    assert len(got) == 6 and got == want
    s = teng.stats
    assert s.iterations == jeng.stats.iterations > 0
    assert s.dispatches_per_iter == 1.0 and s.syncs_per_iter == 1.0
    assert s.dense_batch_hist == jeng.stats.dense_batch_hist
    assert s.kv_bucket_hist == jeng.stats.kv_bucket_hist
    assert s.packed_pad_tokens == jeng.stats.packed_pad_tokens
    assert s.prefill_expansion == 1.0
    assert teng.kv.stats.snapshot() == {
        k: v for k, v in jeng.kv.stats.snapshot().items()
        if k in teng.kv.stats.snapshot()}


def test_kv_bytes_per_token_from_cache_shapes():
    """2 leaves x KV heads x head_dim x itemsize, per attention layer; int8
    adds one f32 scale per leaf and KV head (0.516 of bf16 at Qwen3-8B)."""
    cfg = get_config("qwen3-8b")
    assert kv_bytes_per_token(cfg) == 36 * 2 * 8 * 128 * 2 == 147_456
    assert kv_bytes_per_token(cfg, "int8") == 36 * 2 * (8 * 128 + 8 * 4) \
        == 76_032
    toy = dataclasses.replace(get_config("tiny-toy"), dtype="float32")
    assert kv_bytes_per_token(toy) == 4 * 2 * 2 * 64 * 4


@pytest.mark.parametrize("kw,exc", [
    # the legacy step has no async pipeline and no speculation
    (dict(async_depth=1, step_mode="legacy"), ValueError),
    # tp > 1 needs a process group of tp ranks (none here)
    (dict(tp=2), RuntimeError),
    (dict(drafter="nope"), ValueError),
    # top-k sampling needs temperature > 0, and top_k >= 1
    (dict(top_k=5), ValueError),
    (dict(spec_k=2, step_mode="legacy"), ValueError),
    (dict(temperature=0.7, top_k=0), ValueError),
    # what the JAX config refuses on the legacy step raises ValueError
    (dict(step_mode="legacy", prefix_caching=True), ValueError),
    (dict(step_mode="legacy", kv_dtype="int8"), ValueError),
    # values the JAX config refuses whatever the step
    (dict(async_depth=-1), ValueError),
    (dict(temperature=-0.5), ValueError),
    (dict(spec_k=-1), ValueError),
    (dict(tp=0), ValueError),
])
def test_config_rejects_unported_features(kw, exc):
    """Values and combinations the JAX config refuses raise ValueError when
    the config is built; tp > 1 without a process group of tp ranks raises
    RuntimeError when the engine is built."""
    cfg = get_config("tiny-toy")
    with pytest.raises(exc):
        ServeEngine(cfg, torch_model.init(cfg, device="cpu"),
                    EngineConfig(**kw), device="cpu")


def test_config_step_modes():
    """The JAX rules: recompute prefill implies the legacy step; the packed
    step refuses it; the legacy step refuses tp > 1, the async pipeline and
    speculative decoding (prefix caching and int8 KV above)."""
    assert EngineConfig().resolved_step_mode == "packed"
    assert EngineConfig(step_mode="legacy").resolved_step_mode == "legacy"
    assert EngineConfig(prefill_mode="recompute").resolved_step_mode == \
        "legacy"
    for kw in (dict(step_mode="packed", prefill_mode="recompute"),
               dict(step_mode="legacy", tp=2),
               dict(prefill_mode="recompute", async_depth=1),
               dict(step_mode="legacy", spec_k=2),
               dict(step_mode="eager"), dict(prefill_mode="lazy")):
        with pytest.raises(ValueError):
            EngineConfig(**kw)


@pytest.mark.parametrize("kw", [
    dict(kv_dtype="fp8"),
    dict(prefix_caching=True, max_len=60, kv_block_size=16),
])
def test_config_validates_kv_modes(kw):
    """The JAX validations: a known KV dtype, and whole blocks per slot
    under prefix caching; the four KV modes themselves are accepted."""
    with pytest.raises(ValueError):
        EngineConfig(**kw)
    for prefix in (False, True):
        for kv_dtype in ("bf16", "int8"):
            EngineConfig(prefix_caching=prefix, kv_dtype=kv_dtype)


def test_sampling_feedback_matches_jax():
    """substitute_last / scatter_last against the JAX versions on the
    per-slot buffer, with out-of-bounds sample slots dropped."""
    rng = np.random.default_rng(5)
    last = rng.integers(0, 100, 4).astype(np.int32)
    tokens = rng.integers(0, 100, (1, 9)).astype(np.int32)
    slot = rng.integers(0, 4, 9).astype(np.int32)
    from_last = rng.integers(0, 2, 9).astype(bool)
    sample_slot = np.array([4, 1, 4, 3, 4, 4, 0, 4, 4], np.int32)
    sampled = rng.integers(0, 100, 9).astype(np.int32)
    got = sampling.substitute_last(torch.from_numpy(tokens),
                                   torch.from_numpy(last),
                                   torch.from_numpy(slot),
                                   torch.from_numpy(from_last))
    want = jax_sampling.substitute_last(jnp.asarray(tokens), jnp.asarray(last),
                                        jnp.asarray(slot),
                                        jnp.asarray(from_last))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = sampling.scatter_last(torch.from_numpy(last),
                                torch.from_numpy(sample_slot),
                                torch.from_numpy(sampled))
    want = jax_sampling.scatter_last(jnp.asarray(last),
                                     jnp.asarray(sample_slot),
                                     jnp.asarray(sampled))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0]])
    assert sampling.greedy(logits).tolist() == [1]       # first index on ties
