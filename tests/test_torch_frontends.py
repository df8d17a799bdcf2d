"""The port's remaining model features against the JAX package, f32 on the
CPU: the ungated GELU MLP (StarCoder2-7B, Minitron-4B; MusicGen's too),
tied embeddings, the vision stub (LLaVA-NeXT-34B) and the audio stub
(MusicGen-medium), all at ``scale_down`` widths with the JAX ``model.init``
pytree converted.

The forwards agree at atol 1e-4 (logits of (…, K, vocab) for audio); the
engines are token-exact against the JAX engine in the same mode: the
packed step for every config (LLaVA served text-only, as JAX serves it),
MusicGen's legacy step and recompute prefill too, with its fed-back
tokens repeated across the 4 codebooks and codebook 0 kept, and its
stochastic packed engine (temperature 0.8, with top-k 50 at depth 0 and
without at depth 1: one (4, V) Gumbel draw per key, as JAX draws it).  The
draws of the 4 codebooks differ from each other and each follows its
codebook's softmax.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from _torch_serving import run
from repro.configs import get_config as jax_get_config
from repro.configs import scale_down as jax_scale_down
from repro.models import model as jax_model
from repro_torch.configs import get_config, scale_down
from repro_torch.models import layers, model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import sampling

ATOL = 1e-4
ENGINE = dict(max_slots=2, max_len=48, discrete_sizes=(16, 8),
              avg_decode_len=4)
# name -> (config, change applied to both packages' scale_down)
CONFIGS = {"starcoder2": ("starcoder2-7b", {}),
           "minitron": ("minitron-4b", {}),
           "tied": ("tiny-toy", dict(tie_embeddings=True)),
           "llava": ("llava-next-34b", {}),
           "musicgen": ("musicgen-medium", {})}


@functools.lru_cache(maxsize=None)
def models(key):
    """(jax cfg, torch cfg, jax params, torch params) on the CPU, f32;
    tiny-toy is already small and is not scaled down."""
    name, change = CONFIGS[key]
    out = []
    for get, scale in ((jax_get_config, jax_scale_down),
                       (get_config, scale_down)):
        cfg = get(name)
        if name != "tiny-toy":
            cfg = scale(cfg)
        out.append(dataclasses.replace(cfg, dtype="float32", **change))
    jcfg, tcfg = out
    jparams = jax_model.init(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def _tokens(cfg, rng, shape):
    if cfg.frontend == "audio":
        shape = shape + (cfg.num_codebooks,)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


def test_gelu_matches_jax():
    """The tanh approximation, as ``jax.nn.gelu`` computes it by default,
    in f32 over [-8, 8] and at the extremes, within 1e-6: the largest
    gap is in the negative tail, where JAX's f32 tanh rounds to -1 and
    gives 0 while torch keeps the value (-5.8e-7 at x = -4.876)."""
    x = np.concatenate([np.linspace(-8, 8, 4001, dtype=np.float32),
                        np.float32([-40, -1e-6, 0, 1e-6, 40])])
    np.testing.assert_allclose(layers.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=2.5e-7, atol=1e-6)


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_param_tree_matches_jax(key):
    """The port defines the JAX leaves, no more and no fewer: no
    ``w_gate`` in an ungated FFN, no ``head`` with tied embeddings, the
    audio ``embed (K, V, D)`` and ``head (D, K, V)``, the vision
    ``patch_proj``."""
    jcfg, tcfg, jparams, tparams = models(key)
    for name in ("embed", "head", "patch_proj"):
        assert (name in tparams) == (name in jparams), name
        if name in tparams:
            assert tuple(tparams[name].shape) == jparams[name].shape
    assert ("w_gate" in tparams["layers"][0]["ffn"]) == tcfg.ffn_gated
    if key == "musicgen":
        assert tparams["embed"].shape == (4, tcfg.vocab_size, tcfg.d_model)
        assert tparams["head"].shape == (tcfg.d_model, 4, tcfg.vocab_size)


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_forward_full_and_prefill_match_jax(key):
    """Two 9-token prompts (4 codebook streams for audio, 8 patch
    embeddings ahead of the text for LLaVA): logits, and ``prefill``'s
    last logits and cache length."""
    jcfg, tcfg, jparams, tparams = models(key)
    rng = np.random.default_rng(3)
    toks = _tokens(tcfg, rng, (2, 9))
    jkw, tkw = {}, {}
    if tcfg.frontend == "vision":
        assert tcfg.num_patch_tokens == 8
        patches = rng.normal(size=(2, 8, tcfg.d_model)).astype(np.float32)
        jkw, tkw = (dict(patches=jnp.asarray(patches)),
                    dict(patches=torch.from_numpy(patches)))
    jlog, _ = jax_model.forward_full(jcfg, jparams, jnp.asarray(toks), **jkw)
    tlog, _ = model.forward_full(tcfg, tparams, torch.from_numpy(toks), **tkw)
    assert tlog.shape == jlog.shape
    _close(tlog, jlog)
    jlast, _, jlen = jax_model.prefill(jcfg, jparams, jnp.asarray(toks),
                                       max_len=24, **jkw)
    tlast, _, tlen = model.prefill(tcfg, tparams, torch.from_numpy(toks),
                                   max_len=24, **tkw)
    _close(tlast, jlast)
    assert tlen.tolist() == np.asarray(jlen).tolist() == \
        [9 + (8 if tkw else 0)] * 2


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_forward_packed_and_decode_match_jax(key):
    """A packed iteration of two slots' chunks and 2 padding tokens ((1,
    T, 4) streams for audio), then one decode token per slot: logits and
    K/V after each."""
    jcfg, tcfg, jparams, tparams = models(key)
    rng = np.random.default_rng(5)
    max_len = 16
    jcache = jax_model.init_cache(jcfg, 1, 2, max_len)
    tcache = model.init_cache(tcfg, 2, max_len, device="cpu")
    slot = np.asarray([0] * 5 + [1] * 3 + [1] * 2, np.int32)
    pos = np.asarray(list(range(5)) + list(range(3)) + [0, 0], np.int32)
    active = np.arange(10) < 8
    wpos = np.where(active, pos, max_len).astype(np.int32)
    toks = _tokens(tcfg, rng, (1, 10))
    jlog, jcache = jax_model.forward_packed(
        jcfg, jparams, jnp.asarray(toks), jcache, jnp.asarray(slot),
        jnp.asarray(pos), jnp.asarray(wpos), jnp.asarray(active),
        kv_bucket=max_len)
    tlog, tcache = model.forward_packed(
        tcfg, tparams, torch.from_numpy(toks), tcache,
        torch.from_numpy(slot), torch.from_numpy(pos),
        torch.from_numpy(wpos), torch.from_numpy(active), kv_bucket=max_len)
    assert tlog.shape == jlog.shape
    _close(tlog[0, :8], np.asarray(jlog)[0, :8])
    clen = np.asarray([5, 3], np.int32)
    dtoks = _tokens(tcfg, rng, (2, 1))
    jlog, jcache = jax_model.forward_decode(jcfg, jparams, jnp.asarray(dtoks),
                                            jcache, jnp.asarray(clen))
    tlog, tcache = model.forward_decode(tcfg, tparams,
                                        torch.from_numpy(dtoks), tcache,
                                        torch.from_numpy(clen))
    _close(tlog, jlog)
    for gi, (pattern, reps) in enumerate(jcfg.layer_groups()):
        assert pattern == (pattern[0],) and len(tcache) == reps
        for r in range(reps):
            for name in ("k", "v"):
                _close(tcache[r][name],
                       np.asarray(jcache[gi]["sub0"][name])[r])


def _prompts(vocab):
    rng = np.random.default_rng(1)
    return [[int(t) for t in rng.integers(0, vocab,
                                          size=int(rng.integers(3, 12)))]
            for _ in range(5)]


ENGINE_CASES = [(key, "packed") for key in sorted(CONFIGS)] + \
    [("musicgen", "legacy"), ("musicgen", "recompute")]
MODES = {"packed": dict(step_mode="packed", async_depth=0),
         "legacy": dict(step_mode="legacy"),
         "recompute": dict(prefill_mode="recompute")}


@pytest.mark.parametrize("key,mode", ENGINE_CASES)
def test_engine_token_exact_vs_jax(key, mode):
    """5 requests of 3-11 prompt tokens on 2 slots (reused), 3 new tokens
    each: identical tokens and iteration, dispatch, sync and prefill-work
    counts."""
    jcfg, tcfg, jparams, tparams = models(key)
    prompts = _prompts(tcfg.vocab_size)
    jeng, want = run(True, jcfg, jparams, prompts, max_new=3, **ENGINE,
                     **MODES[mode])
    teng, got = run(False, tcfg, tparams, prompts, max_new=3, **ENGINE,
                    **MODES[mode])
    assert got == want
    for field in ("iterations", "model_dispatches", "host_syncs",
                  "prefill_model_tokens", "prefill_tokens", "decode_tokens"):
        assert getattr(teng.stats, field) == getattr(jeng.stats, field), \
            field


@pytest.mark.parametrize("depth,topk", [(0, 50), (1, None)])
def test_musicgen_stochastic_engine_token_exact_vs_jax(depth, topk):
    """Temperature 0.8 at K = 4, with top-k 50 at depth 0 and over the
    whole vocab at depth 1: the JAX engine's tokens, which differ from the
    greedy ones."""
    jcfg, tcfg, jparams, tparams = models("musicgen")
    cfg = dict(ENGINE, step_mode="packed", async_depth=depth,
               async_harvest=False, temperature=0.8, top_k=topk, seed=7)
    prompts = _prompts(tcfg.vocab_size)
    _, want = run(True, jcfg, jparams, prompts, max_new=6, **cfg)
    _, got = run(False, tcfg, tparams, prompts, max_new=6, **cfg)
    assert got == want
    assert got != run(False, tcfg, tparams, prompts, max_new=6,
                      **ENGINE)[1]


@pytest.mark.parametrize("topk", [None, 5])
def test_codebook_draws_independent_and_from_softmax(topk):
    """(n, 4, V) logits: each codebook draws its own slice of the row's
    (4, V) noise (4 different draws from 4 equal rows), every codebook's
    20,000 draws follow softmax(logits / T) (over the top k when given;
    chi-square p > 1e-3 each), and codebook 0's draws are the one-codebook
    draws of the same keys."""
    n, k, temp = 20_000, 4, 0.8
    logits = np.random.default_rng(11).normal(size=12).astype(np.float32)
    keys = sampling.packed_keys(99, torch.arange(n) % 97,
                                torch.arange(n) // 97, 1025)
    lg = torch.from_numpy(np.tile(logits, (n, k, 1)))
    drawn = sampling.sample_tokens(lg, keys, temp, topk)
    assert drawn.shape == (n, k) and drawn.dtype == torch.int32
    torch.testing.assert_close(drawn[:, 0], sampling.sample_tokens(
        lg[:, 0], keys, temp, topk))
    assert (drawn[:, 1:] != drawn[:, :1]).any(dim=0).all()
    support = np.argsort(-logits)[:topk] if topk else np.arange(12)
    z = logits[support].astype(np.float64) / temp
    p = np.exp(z - z.max())
    p /= p.sum()
    for cb in range(k):
        counts = np.bincount(drawn[:, cb].numpy(), minlength=12)
        assert counts[np.setdiff1d(np.arange(12), support)].sum() == 0
        res = scipy.stats.chisquare(counts[support], p * n)
        assert res.pvalue > 1e-3, (cb, res, counts)
