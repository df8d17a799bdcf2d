"""The port's speculative decoding (DESIGN.md §13) against the JAX engine:
f32 on the CPU, tiny-toy, the same converted weights and prompts.

The cases of ``tests/test_spec_decode.py`` (:90, :106, :132, :153, :162,
:233): greedy spec decode at spec_k 2 and 4, async depths 0 and 1, is
token-exact against the JAX spec engine and the port's plain engine, with
the three ``spec_*`` counters equal to JAX's and one dispatch and one sync
an iteration; a replay drafter is accepted above 0.6 and needs fewer
iterations; spec decode composes with prefix caching and with int8 KV
(each held to the JAX engine in the same mode); the hybrid is refused; the
config and the n-gram drafter behave as JAX's.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import functools

import numpy as np
import pytest

from _torch_serving import models, run
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.draft import Drafter, NgramDrafter, make_drafter
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.request import Request

SIZES = (16, 8)
SPEC = ("spec_verify_segments", "spec_proposed_tokens",
        "spec_accepted_tokens")


def _prompts(vocab):
    """Repetitive motifs (the n-gram drafter's home turf) and one random
    prompt (tests/test_spec_decode.py:_prompts)."""
    rng = np.random.default_rng(3)
    return [[5, 9, 3, 7] * 5, ([2, 4] * 8)[:13],
            list(map(int, rng.integers(0, vocab, size=7)))]


@functools.lru_cache(maxsize=None)
def _cached_both(spec_k, depth, kw_items):
    return _both(spec_k, depth, **dict(kw_items))


def _both(spec_k, depth, *, max_new=12, drafter=None, **kw):
    """(JAX engine, JAX outputs, port engine, port outputs) of one spec
    configuration, harvesting off (the deterministic lag); a run without
    its own drafter is made once and shared (``_cached_both``)."""
    jcfg, tcfg, jparams, tparams = models("tiny-toy")
    cfg = dict(max_slots=2, max_len=96, discrete_sizes=SIZES,
               avg_decode_len=4.0, spec_k=spec_k, async_depth=depth,
               async_harvest=False, max_new=max_new, **kw)
    prompts = _prompts(tcfg.vocab_size)
    jeng, want = run(True, jcfg, jparams, prompts, drafter=drafter, **cfg)
    teng, got = run(False, tcfg, tparams, prompts, drafter=drafter, **cfg)
    return jeng, want, teng, got


def _plain(depth, *, max_new=12, **kw):
    _, tcfg, _, tparams = models("tiny-toy")
    return run(False, tcfg, tparams, _prompts(tcfg.vocab_size),
               max_slots=2, max_len=96, discrete_sizes=SIZES,
               avg_decode_len=4.0, async_depth=depth, async_harvest=False,
               max_new=max_new, **kw)


def _same_spec_counts(jeng, teng):
    for field in SPEC + ("iterations", "decode_tokens"):
        assert getattr(teng.stats, field) == getattr(jeng.stats, field), field
    assert teng.scheduler.dropped_tokens == jeng.scheduler.dropped_tokens


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("spec_k", [2, 4])
def test_greedy_spec_decode_token_exact(spec_k, depth):
    """test_spec_decode.py:90, plus the JAX spec engine itself."""
    jeng, want, teng, got = _cached_both(spec_k, depth, ())
    _, plain = _plain(depth)
    assert got == want == plain, (spec_k, depth)
    _same_spec_counts(jeng, teng)
    st = teng.stats
    assert st.dispatches_per_iter == 1.0 and st.syncs_per_iter == 1.0
    assert st.spec_verify_segments > 0
    assert st.spec_proposed_tokens == st.spec_verify_segments * spec_k
    assert 0 <= st.spec_accepted_tokens <= st.spec_proposed_tokens
    assert st.spec_accepted_per_verify >= 1.0


def test_spec_launch_shapes_bounded():
    """test_spec_decode.py:106: spec_k swaps the decode-only floor bucket
    for max_active x (spec_k + 1): still within (|T buckets| + 1) x |kv
    buckets| shapes, as many as the JAX engine compiles."""
    jeng, _, teng, _ = _cached_both(2, 1, ())
    assert len(teng.launch_shapes) == jeng._packed_step._cache_size()
    assert len(teng.launch_shapes) <= (len(SIZES) + 1) * len(teng.kv_buckets)
    # the floor bucket: 2 slots x 3 tokens, below the smallest size 8
    assert 2 * 3 in {t for t, _ in teng.launch_shapes}


class _ReplayDrafter:
    """Proposes the known continuation of each request."""

    def __init__(self, targets):
        self.targets = targets

    def propose(self, req, k):
        tgt = self.targets.get(req.rid, [])
        return tgt[len(req.output):len(req.output) + k]


def test_replay_drafter_acceptance_and_iteration_count():
    """test_spec_decode.py:132: a drafter that replays the plain run's
    tokens is accepted above 0.6 and finishes in fewer verify segments
    than half the plain decode steps."""
    plain_eng, base = _plain(0)
    replay = _ReplayDrafter({rid: list(out) for rid, out in base.items()})
    assert isinstance(replay, Drafter)
    jeng, want, teng, got = _both(3, 0, drafter=replay)
    assert got == want == base
    _same_spec_counts(jeng, teng)
    st = teng.stats
    assert st.spec_acceptance_rate > 0.6, st.spec_acceptance_rate
    assert st.spec_accepted_per_verify > 2.0
    assert st.spec_verify_segments < plain_eng.stats.decode_tokens / 2
    assert st.iterations < plain_eng.stats.iterations


def test_spec_requires_attention_only():
    """test_spec_decode.py:153: the hybrid's recurrent state cannot roll
    back rejected drafts, so both engines refuse it."""
    _, tcfg, _, tparams = models("hybrid")
    with pytest.raises(ValueError, match="attention-only"):
        ServeEngine(tcfg, tparams, EngineConfig(max_slots=2, max_len=64,
                                                spec_k=2), device="cpu")


@pytest.mark.parametrize("mode", [
    dict(prefix_caching=True, kv_block_size=8),
    dict(kv_dtype="int8"),
    dict(prefix_caching=True, kv_block_size=8, kv_dtype="int8"),
])
def test_spec_composes_with_kv_modes(mode):
    """test_spec_decode.py:162 and its int8 forms: verify writes go through
    the block tables on the device and quantize like any row; the port
    equals the JAX spec engine and its own plain engine in the same KV
    mode."""
    jeng, want, teng, got = _both(2, 1, **mode)
    _, plain = _plain(1, **mode)
    assert got == want == plain
    _same_spec_counts(jeng, teng)
    assert teng.stats.dispatches_per_iter == 1.0
    assert teng.stats.spec_verify_segments > 0


def test_config_validation():
    """test_spec_decode.py:233, with ValueError where JAX asserts."""
    for kw in (dict(spec_k=-1), dict(step_mode="legacy", spec_k=2),
               dict(max_len=8, spec_k=8), dict(drafter="nope"),
               dict(top_k=5), dict(temperature=-0.1)):
        with pytest.raises(ValueError):
            EngineConfig(**kw)
    assert EngineConfig(spec_k=2).resolved_drafter == "ngram"
    assert EngineConfig().resolved_drafter is None
    assert EngineConfig(drafter="ngram").resolved_drafter is None
    assert EngineConfig().resolved_async_depth == 1
    assert EngineConfig(step_mode="legacy").resolved_async_depth == 0


def test_ngram_drafter_lookup():
    """test_spec_decode.py's drafter cases on the port's copy."""
    d = make_drafter("ngram")
    assert isinstance(d, NgramDrafter)
    with pytest.raises(ValueError):
        make_drafter("nope")
    r = Request(rid=0, prompt=[5, 9, 3, 7, 1, 2, 3, 7], max_new_tokens=4)
    assert d.propose(r, 3) == [1, 2, 3]
    r2 = Request(rid=1, prompt=[4, 4], max_new_tokens=4)
    r2.output = [8, 6, 4, 4]
    assert d.propose(r2, 2) == [8, 6]
    r3 = Request(rid=2, prompt=[1, 2, 3, 4], max_new_tokens=4)
    assert d.propose(r3, 3) == []
