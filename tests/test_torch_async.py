"""The port's async pipeline (DESIGN.md §10) against the JAX engine: f32 on
the CPU, the same converted weights and numpy-made prompts, on tiny-toy and
the dense-FFN Jamba hybrid.

The cases of ``tests/test_async_pipeline.py`` (:78, :98, :116, :152,
:173): depth 1 is token-exact after the EOS strip against the JAX engine
at depth 1 and against the port at depth 0; the lag-k overshoot with
harvesting off (the worst-case lag) launches and drops exactly what JAX's
does at depths 1-3; a deep pipeline never launches past
``max_new_tokens``; depth 0 and depth 1 launch the same (T bucket, kv
bucket) shapes, within (|T buckets| + 1) x |kv buckets|.  On the CPU every
payload is ready when it is retired, so harvesting retires at once: the
deferred cases turn it off.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import numpy as np
import pytest

from _torch_serving import models, probe_eos, run

ENGINE = dict(max_slots=2, max_len=32, discrete_sizes=(16, 8),
              avg_decode_len=4)


@pytest.fixture(scope="module", params=["tiny-toy", "hybrid"])
def family(request):
    return models(request.param)


def test_async_matches_eager_with_eos_strip(family):
    """test_async_pipeline.py:78: 5 requests through slot reuse and an EOS
    hit; the port at depth 1 (harvesting on and off) equals the JAX engine
    at depth 1 and the port at depth 0, one dispatch and one sync an
    iteration."""
    jcfg, tcfg, jparams, tparams = family
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(0, tcfg.vocab_size,
                                          size=int(rng.integers(3, 12)))))
               for _ in range(5)]
    eos = probe_eos(tcfg, tparams, prompts[0])
    kw = dict(ENGINE, max_new=4, eos_id=eos)
    _, want = run(True, jcfg, jparams, prompts, async_depth=1, **kw)
    _, eager = run(False, tcfg, tparams, prompts, async_depth=0, **kw)
    assert want[0][-1] == eos            # rid 0 took the EOS path
    assert eager == want, tcfg.name
    for harvest in (True, False):
        eng, got = run(False, tcfg, tparams, prompts, async_depth=1,
                       async_harvest=harvest, **kw)
        assert got == want, (tcfg.name, harvest)
        assert eng.async_depth == 1
        assert eng.stats.model_dispatches == eng.stats.iterations
        assert eng.stats.host_syncs == eng.stats.iterations


def test_depth0_is_lockstep(family):
    """test_async_pipeline.py:98: depth 0 retires each iteration at once:
    one dispatch and one sync an iteration, nothing left in flight on any
    request, nothing dropped."""
    _, tcfg, _, tparams = family
    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(0, tcfg.vocab_size, size=9)))
               for _ in range(4)]
    eng, _ = run(False, tcfg, tparams, prompts, async_depth=0, max_new=4,
                 **ENGINE)
    assert eng.async_depth == 0
    assert eng.stats.model_dispatches == eng.stats.iterations
    assert eng.stats.host_syncs == eng.stats.iterations
    assert eng.scheduler.dropped_tokens == 0
    assert all(r.inflight == 0 for r in eng.scheduler.active)


@pytest.fixture(scope="module")
def overshoot(family):
    """The lag-k overshoot request of one family, shared by its depths:
    the prompt, the engine settings with EOS as the first sample, and the
    port's depth-0 output."""
    _, tcfg, _, tparams = family
    prompt = [5, 9, 11]
    kw = dict(ENGINE, max_new=6,
              eos_id=probe_eos(tcfg, tparams, prompt), async_harvest=False)
    _, eager = run(False, tcfg, tparams, [prompt], async_depth=0, **kw)
    return prompt, kw, eager


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_lag_k_eos_overshoot_matches_jax(family, overshoot, depth):
    """test_async_pipeline.py:116 at depths 1-3, harvesting off: EOS is the
    first sample, so the pipeline launches ``depth`` decodes before its
    commit lands; one is the §5.3 extra, ``depth - 1`` arrive late and are
    dropped.  Outputs, drops and decode counts equal JAX's and the depth-0
    run's, and the slot and KV pages are retired despite the late EOS."""
    jcfg, tcfg, jparams, tparams = family
    prompt, kw, eager = overshoot
    jeng, want = run(True, jcfg, jparams, [prompt], async_depth=depth, **kw)
    teng, got = run(False, tcfg, tparams, [prompt], async_depth=depth, **kw)
    assert got == want == eager and got[0][-1] == kw["eos_id"]
    assert teng.scheduler.dropped_tokens == jeng.scheduler.dropped_tokens \
        == depth - 1
    assert teng.stats.decode_tokens == jeng.stats.decode_tokens == depth
    assert teng.kv.pages_used == 0
    assert len(teng.slot_free) == 2


@pytest.mark.parametrize("depth", [2, 4])
def test_speculation_respects_max_new_tokens(depth):
    """test_async_pipeline.py:152: the launch-side cap keeps a deep
    pipeline from launching past max_new_tokens: nothing dropped."""
    _, tcfg, _, tparams = models("tiny-toy")
    rng = np.random.default_rng(2)
    prompt = list(map(int, rng.integers(0, tcfg.vocab_size, size=7)))
    eng, out = run(False, tcfg, tparams, [prompt], async_depth=depth,
                   async_harvest=False, max_new=3,
                   **ENGINE)
    assert len(out[0]) == 3
    assert eng.stats.decode_tokens == 2    # the prefill samples token 1
    assert eng.scheduler.dropped_tokens == 0


def test_async_launch_shapes_bounded(family):
    """test_async_pipeline.py:173: the ring adds no launch shape: depth 0
    and depth 1 launch the same (T bucket, kv bucket) set, within
    (|T buckets| + 1) x |kv buckets| (tests/test_torch_spec_decode.py
    holds the set's size to the JAX engine's compile count)."""
    _, tcfg, _, tparams = family
    sizes = (32, 16, 8)
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(0, tcfg.vocab_size,
                                          size=int(rng.integers(3, 40)))))
               for _ in range(8)]
    kw = dict(max_slots=4, max_len=64, discrete_sizes=sizes,
              avg_decode_len=4, max_new=3, async_harvest=False)
    shapes = {}
    for depth in (0, 1):
        eng, _ = run(False, tcfg, tparams, prompts, async_depth=depth, **kw)
        shapes[depth] = eng.launch_shapes
    assert shapes[0] == shapes[1]
    assert len(shapes[1]) <= (len(sizes) + 1) * len(eng.kv_buckets)
