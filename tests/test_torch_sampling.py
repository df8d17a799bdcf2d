"""The port's packed-step sampling against the JAX package and its
properties, f32 on the CPU.

The cases of ``tests/test_sampling.py`` and the sampling cases of
``tests/test_spec_decode.py`` (:196, :215): the ring operations
``substitute_last`` / ``scatter_last`` agree with JAX's on the same
arrays; ``temperature == 0`` and ``top_k=1`` are greedy; draws are
reproducible, confined to the top k, and in an engine do not depend on
the async depth; stochastic spec decode is token-exact against plain
stochastic decode.  The generator is JAX's threefry2x32 in torch integer
ops: its bits are held to Random123's known answer and to
``jax.random.bits`` under ``packed_keys``' keys, its draws to JAX's
``sample_tokens`` token for token (one and four codebooks, with and
without top-k) and to the softmax by a chi-square test over 20,000
draws, and the stochastic engine to the JAX engine token for token.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from _torch_serving import models, run
from repro.serving import sampling as jax_sampling
from repro_torch.serving import sampling
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.request import Request

I32 = np.int32


def _t(x, dt=I32):
    return torch.from_numpy(np.asarray(x, dt))


# ---------------------------------------------------------------------------
# ring operations against JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("width", [1, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_substitute_last_matches_jax(width, seed):
    """The 1-D buffer and the (n_slots, W) ring, with accept_len inside,
    below (clipped to column 0) and above (clipped to the last column) the
    ring, and without accept_len (column 0)."""
    rng = np.random.default_rng(seed)
    n, t = 4, 11
    tokens = rng.integers(0, 100, (1, t)).astype(I32)
    ring = rng.integers(0, 100, (n, width)).astype(I32)
    slot = rng.integers(0, n, t).astype(I32)
    from_last = rng.integers(0, 2, t).astype(bool)
    for buf in (ring[:, 0], ring):
        for acc in (None, rng.integers(-1, width + 2, n).astype(I32)):
            got = sampling.substitute_last(
                _t(tokens), _t(buf), _t(slot), _t(from_last, bool),
                accept_len=None if acc is None else _t(acc))
            want = jax_sampling.substitute_last(
                jnp.asarray(tokens), jnp.asarray(buf), jnp.asarray(slot),
                jnp.asarray(from_last),
                accept_len=None if acc is None else jnp.asarray(acc))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("width", [1, 3])
def test_scatter_last_matches_jax(width):
    """Column 0 only of a ring, out-of-bounds sample slots dropped, the
    input left untouched; an all-out-of-bounds scatter is a no-op."""
    rng = np.random.default_rng(7)
    n = 4
    ring = rng.integers(0, 100, (n, width)).astype(I32)
    sampled = rng.integers(0, 100, 9).astype(I32)
    for sample_slot in (np.array([4, 1, 4, 3, 4, 4, 0, 4, 4], I32),
                        np.full(9, n, I32)):
        for buf in (ring[:, 0].copy(), ring.copy()):
            before = buf.copy()
            src = _t(buf)
            got = sampling.scatter_last(src, _t(sample_slot), _t(sampled))
            want = jax_sampling.scatter_last(jnp.asarray(buf),
                                             jnp.asarray(sample_slot),
                                             jnp.asarray(sampled))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            np.testing.assert_array_equal(src.numpy(), before)


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------
def test_threefry_known_answers():
    """Random123's kat_vectors for threefry2x32 with 20 rounds (the
    answers JAX's tests hold its ``threefry_2x32`` to)."""
    cases = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
             ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 2, (0x1CB996FC, 0xBB002BE7)),
             ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
              (0xC4923A9C, 0x483DF7A0))]
    for key, ctr, want in cases:
        got = sampling.threefry2x32(
            tuple(torch.tensor([k], dtype=torch.int64) for k in key),
            tuple(torch.tensor([c], dtype=torch.int64) for c in ctr))
        assert [int(g) for g in got] == list(want)


@pytest.mark.parametrize("seed", [0, 11, 2**31 - 1])
def test_keys_and_bits_match_jax(seed):
    """``packed_keys`` equals JAX's (``fold_in`` of rid x stride + pos,
    wrapping past 2^32), and each key's words are ``jax.random.bits`` of a
    (4, 37) draw, flattened."""
    rng = np.random.default_rng(seed)
    rid = rng.integers(0, 2**31 - 1, 6).astype(I32)
    pos = rng.integers(0, 1024, 6).astype(I32)
    jkeys = jax_sampling.packed_keys(jax.random.PRNGKey(seed),
                                     jnp.asarray(rid), jnp.asarray(pos), 1025)
    keys = sampling.packed_keys(seed, _t(rid), _t(pos), 1025)
    np.testing.assert_array_equal(keys.numpy(),
                                  np.asarray(jkeys).astype(np.int64))
    want = jax.vmap(lambda k: jax.random.bits(k, (4, 37)))(jkeys)
    np.testing.assert_array_equal(
        sampling.random_bits(keys, 4 * 37).reshape(6, 4, 37).numpy(),
        np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("shape", [(40, 97), (40, 4, 97)], ids=str)
@pytest.mark.parametrize("topk", [None, 1, 8])
def test_sample_tokens_match_jax(shape, topk):
    """The draws of one and of four codebooks, over the whole vocab and
    over the top k, are JAX's token for token at temperature 0.8."""
    rng = np.random.default_rng(5)
    logits = rng.normal(size=shape).astype(np.float32) * 2
    rid = rng.integers(0, 1000, shape[0]).astype(I32)
    pos = rng.integers(0, 96, shape[0]).astype(I32)
    jkeys = jax_sampling.packed_keys(jax.random.PRNGKey(3), jnp.asarray(rid),
                                     jnp.asarray(pos), 97)
    want = jax_sampling.sample_tokens(jnp.asarray(logits), jkeys, 0.8, topk)
    got = sampling.sample_tokens(torch.from_numpy(logits),
                                 sampling.packed_keys(3, _t(rid), _t(pos),
                                                      97), 0.8, topk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_packed_keys_distinct_and_bits_consistent():
    """Distinct (rid, pos) draw distinct bits; a row's bits at a vocab
    index are the same whether asked alone, with others or for every
    index (top-k and the full draw share them); the seed enters."""
    rid = _t([0, 0, 1, 1])
    pos = _t([0, 1, 0, 1])
    keys = sampling.packed_keys(5, rid, pos, 97)
    bits = sampling.random_bits(keys, 37)
    assert bits.shape == (4, 37) and int(bits.min()) >= 0 \
        and int(bits.max()) < 2 ** 32
    assert len({tuple(row.tolist()) for row in bits}) == 4
    pick = torch.tensor([[36, 3, 17], [0, 1, 2], [5, 5, 9], [33, 12, 4]])
    torch.testing.assert_close(sampling.random_bits(keys, pick),
                               bits.gather(1, pick))
    every = torch.arange(37).expand(4, 37)
    torch.testing.assert_close(sampling.random_bits(keys, every), bits)
    other = sampling.random_bits(sampling.packed_keys(6, rid, pos, 97), 37)
    assert not torch.equal(other, bits)


def test_gumbel_noise_finite_at_extreme_bits():
    """The words at both ends (and at the edges of the bits the map
    drops) give finite noise, ordered as the words: u stays inside
    (0, 1), so no index gets -inf or +inf noise whatever its logit, and
    equal to ``jax.random.gumbel``'s map of the same words."""
    bits = torch.tensor([0, 1, 0x1FF, 0x200, 1 << 31, 0xFFFFFDFF,
                         0xFFFFFE00, 0xFFFFFF00, 0xFFFFFFFF],
                        dtype=torch.int64)
    noise = sampling.gumbel_from_bits(bits)
    assert noise.dtype == torch.float32
    assert bool(torch.isfinite(noise).all()), noise
    assert bool((noise[1:] >= noise[:-1]).all()), noise
    # u in [tiny, 1 - 2^-23]: -log(-log(tiny)) <= noise <= 15.94
    assert -4.48 < float(noise[0]) and float(noise[-1]) < 15.95, noise
    u = jnp.maximum(jnp.float32(np.finfo(np.float32).tiny),
                    (jnp.asarray(bits.numpy() >> 9, jnp.float32)
                     * 2.0 ** -23))
    np.testing.assert_allclose(noise.numpy(),
                               np.asarray(-jnp.log(-jnp.log(u))),
                               rtol=1e-6)


@pytest.mark.parametrize("topk", [None, 6])
def test_top_word_does_not_win_the_draw(monkeypatch, topk):
    """A row whose bits hold the largest word (0xFFFFFFFF) at an index
    with a far lower logit still samples from the softmax: the favoured
    index 0 wins on every row.  Noise that reached +inf at the top word
    would hand that index the draw, a uniform floor of about V / 2^24
    over a whole vocab.  Over the top k the noise is indexed by rank, and
    the lower logit ranks second."""
    n, vocab, top = 4, 64, [5, 17, 63, 1]
    real_bits = sampling.random_bits

    def bits_with_top_word(keys, index):
        out = real_bits(keys, index).clone()
        cols = torch.arange(out.shape[1]).expand(n, out.shape[1])
        at = torch.tensor(top)[:, None] if out.shape[1] == vocab else 1
        return torch.where(cols == at, torch.full_like(out, 0xFFFFFFFF),
                           out)

    monkeypatch.setattr(sampling, "random_bits", bits_with_top_word)
    logits = torch.full((n, vocab), -50.0)
    logits[:, 0] = 0.0
    logits[torch.arange(n), torch.tensor(top)] = -40.0   # inside the top k
    keys = sampling.packed_keys(9, torch.arange(n), torch.zeros(n), 97)
    drawn = sampling.sample_tokens(logits, keys, 1.0, topk)
    assert drawn.tolist() == [0] * n


def test_sample_tokens_greedy_cases():
    """temperature 0 (no keys needed) and top_k = 1 are greedy."""
    logits = torch.from_numpy(
        np.random.default_rng(1).normal(size=(6, 9)).astype(np.float32))
    greedy = sampling.greedy(logits)
    torch.testing.assert_close(sampling.sample_tokens(logits, None, 0.0),
                               greedy)
    keys = sampling.packed_keys(3, torch.arange(6), torch.zeros(6), 97)
    torch.testing.assert_close(
        sampling.sample_tokens(logits, keys, 1.0, topk=1), greedy)


def test_sample_tokens_deterministic_and_in_top_k():
    logits = torch.from_numpy(
        np.random.default_rng(2).normal(size=(8, 13)).astype(np.float32))
    keys = sampling.packed_keys(5, torch.arange(8), torch.full((8,), 3),
                                97)
    a = sampling.sample_tokens(logits, keys, 0.7, topk=4)
    b = sampling.sample_tokens(logits, keys, 0.7, topk=4)
    torch.testing.assert_close(a, b)
    assert a.dtype == torch.int32
    top4 = torch.topk(logits, 4, dim=-1).indices
    assert all(int(a[i]) in top4[i].tolist() for i in range(8))


@pytest.mark.parametrize("topk", [None, 5])
def test_draw_frequencies_chi_square(topk):
    """20,000 draws of one row of fixed logits, each under its own
    (rid, pos), against softmax(logits / T) (over the top k when given):
    chi-square p > 1e-3."""
    n, temp = 20_000, 0.8
    logits = np.random.default_rng(11).normal(size=12).astype(np.float32)
    keys = sampling.packed_keys(1234, torch.arange(n) % 97,
                                torch.arange(n) // 97, 1025)
    drawn = sampling.sample_tokens(
        torch.from_numpy(np.tile(logits, (n, 1))), keys, temp, topk)
    counts = np.bincount(drawn.numpy(), minlength=12)
    support = np.argsort(-logits)[:topk] if topk else np.arange(12)
    assert counts[np.setdiff1d(np.arange(12), support)].sum() == 0
    z = logits[support].astype(np.float64) / temp
    p = np.exp(z - z.max())
    p /= p.sum()
    res = scipy.stats.chisquare(counts[support], p * n)
    assert res.pvalue > 1e-3, (res, counts)


# ---------------------------------------------------------------------------
# the engine (tests/test_spec_decode.py:196, :215)
# ---------------------------------------------------------------------------
def _serve(depth, spec_k=0, reverse=False, **kw):
    """tests/test_spec_decode.py's three prompts on 2 slots; ``reverse``
    submits them last first (same rids), so they take other slots."""
    _, tcfg, _, tparams = models("tiny-toy")
    rng = np.random.default_rng(3)
    prompts = [[5, 9, 3, 7] * 5, ([2, 4] * 8)[:13],
               list(map(int, rng.integers(0, tcfg.vocab_size, size=7)))]
    order = [2, 1, 0] if reverse else [0, 1, 2]
    eng = ServeEngine(tcfg, tparams, EngineConfig(
        max_slots=2, max_len=96, discrete_sizes=(16, 8), avg_decode_len=4.0,
        spec_k=spec_k, async_depth=depth, async_harvest=False, **kw),
        device="cpu")
    for i in order:
        eng.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=12))
    done = eng.run()
    assert len(done) == 3 and eng.in_flight == 0
    return eng, {r.rid: tuple(r.output) for r in done}


def test_stochastic_sampling_deterministic_and_depth_invariant():
    """Draws are keyed on (rid, pos) only: a run repeats exactly, and is
    the same at depths 0, 1 and 2 and with the requests submitted in the
    other order (so in other slots); it differs from greedy, and a tiny
    temperature with top_k 1 is greedy."""
    kw = dict(temperature=0.8, top_k=8)
    _, a = _serve(0, **kw)
    _, b = _serve(0, **kw)
    _, c = _serve(1, **kw)
    _, d = _serve(2, **kw)
    _, e = _serve(1, reverse=True, **kw)
    assert a == b == c == d == e
    _, greedy = _serve(0)
    assert a != greedy
    _, one = _serve(1, temperature=1e-3, top_k=1)
    assert one == greedy


@pytest.mark.parametrize("depth", [0, 1])
def test_stochastic_spec_decode_token_exact(depth):
    """A re-verified rejected position repeats its draw, so point-mass
    speculation commits exactly the plain stochastic run."""
    kw = dict(temperature=0.8)
    _, base = _serve(depth, **kw)
    eng, out = _serve(depth, spec_k=2, **kw)
    assert out == base
    st = eng.stats
    assert st.spec_verify_segments > 0
    assert st.spec_proposed_tokens == st.spec_verify_segments * 2
    assert st.spec_accepted_tokens <= st.spec_proposed_tokens


@pytest.mark.parametrize("topk", [None, 8])
@pytest.mark.parametrize("depth", [0, 1])
def test_stochastic_engine_token_exact_vs_jax(depth, topk):
    """The three prompts on the stochastic packed engine, temperature 0.8,
    at depths 0 and 1: the JAX engine's tokens."""
    jcfg, tcfg, jparams, tparams = models("tiny-toy")
    rng = np.random.default_rng(3)
    prompts = [[5, 9, 3, 7] * 5, ([2, 4] * 8)[:13],
               list(map(int, rng.integers(0, tcfg.vocab_size, size=7)))]
    cfg = dict(max_slots=2, max_len=96, discrete_sizes=(16, 8),
               avg_decode_len=4.0, async_depth=depth, async_harvest=False,
               temperature=0.8, top_k=topk, seed=5)
    _, want = run(True, jcfg, jparams, prompts, max_new=12, **cfg)
    _, got = run(False, tcfg, tparams, prompts, max_new=12, **cfg)
    assert got == want
