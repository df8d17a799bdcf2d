"""The port's Mixture-of-Experts FFN and the models that carry it, against
the JAX package, f32 on the CPU.

``route_topk`` and ``moe_ffn`` run on the same seeded numpy inputs and
weights in both packages and must agree to atol 1e-5 (the routed experts
alone, DeepSeek-V2's shared experts, Arctic's dense residual; a skewed
router at ``capacity_factor`` 1.25 that drops pairs, and a token count
that is not a multiple of the dispatch group).  The forwards
(``forward_full`` with its balance loss, ``forward_chunk``,
``forward_decode``, ``forward_packed``, caches included) must agree on
``scale_down`` of Arctic, of Jamba with its MoE layers, of LLaMA-2-70B and
of Qwen3-4B, and on a group-7 Arctic (14 / 2 heads: ``scale_down`` alone
gives group 1), with the JAX ``model.init`` pytree converted by
``from_jax_params``: to atol 1e-4 without experts (the packages sum in
other orders; the measured gap is under 3e-6), and to atol 1e-2 with
them.  The MoE FFN rounds its f32 input to bf16 before the dispatch, as
JAX does; where the two packages' f32 activations (1e-6 apart) straddle a
bf16 rounding boundary, an expert input differs by one bf16 ulp (2^-8
relative), which moves the logits by up to 3.5e-3 in these cases, while
the same input gives the same MoE output to 1e-6
(``test_moe_ffn_matches_jax``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import scale_down as jax_scale_down
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro.models.param import init_params as jax_init_params
from repro_torch.configs import (ATTN, FFN_MOE, FFN_MOE_DENSE, MoEConfig,
                                 get_config, scale_down)
from repro_torch.kernels import packed_attention as pa
from repro_torch.models import model
from repro_torch.models import moe
from repro_torch.models.convert import from_jax_params

ATOL_FN = 1e-5
ATOL = 1e-4
ATOL_MOE = 1e-2     # one bf16 ulp of an expert input (see above)


def _both(name, **kw):
    """(jax cfg, torch cfg): ``scale_down`` of ``name`` in f32 with the
    same replacements in both packages."""
    jcfg = dataclasses.replace(jax_scale_down(jax_get_config(name)),
                               dtype="float32", **kw)
    tcfg = dataclasses.replace(scale_down(get_config(name)),
                               dtype="float32", **kw)
    return jcfg, tcfg


def _tree(a, fn):
    if isinstance(a, dict):
        return {k: _tree(v, fn) for k, v in a.items()}
    return fn(a)


def _ffn_params(jcfg, dense_residual, skew=0.0):
    """The JAX ``moe_defs`` leaves drawn by the JAX init, as numpy; ``skew``
    is added to the router's expert-0 column."""
    defs = jax_moe.moe_defs(jcfg, dense_residual=dense_residual)
    p = _tree(jax_init_params(defs, jax.random.PRNGKey(1)), np.asarray)
    p["router"] = p["router"].copy()
    p["router"][:, 0] += skew
    return p


# name -> (config to take the MoEConfig from, dense residual, capacity
# factor, router skew, (B, S)); scale_down's dispatch group is 64
FFN_CASES = {
    "routed": ("arctic-480b", False, 16.0, 0.0, (2, 64)),
    "shared": ("deepseek-v2-236b", False, 1.25, 0.0, (2, 64)),
    "dense_residual": ("arctic-480b", True, 1.25, 0.0, (2, 64)),
    "drops": ("arctic-480b", True, 1.25, 0.05, (2, 64)),
    "padding": ("jamba-1.5-large-398b", False, 1.25, 0.0, (3, 50)),
}


@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_matches_jax(case):
    """y and the balance loss of one MoE FFN, and the routing under it
    (gates, experts, loss of ``route_topk`` on the group's logits)."""
    name, dense_residual, factor, skew, (b, s) = FFN_CASES[case]
    jcfg = jax_scale_down(jax_get_config(name))
    jcfg = dataclasses.replace(jcfg, dtype="float32", moe=dataclasses.replace(
        jcfg.moe, capacity_factor=factor))
    tcfg = dataclasses.replace(scale_down(get_config("arctic-480b")),
                               dtype="float32",
                               moe=MoEConfig(**dataclasses.asdict(jcfg.moe)),
                               d_ff=jcfg.d_ff)
    p = _ffn_params(jcfg, dense_residual, skew)
    rng = np.random.default_rng(len(case))
    x = rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    if skew:
        x += 1.0      # every token's logit for expert 0 rises by ~6
    jy, jaux = jax_moe.moe_ffn(jcfg, _tree(p, jnp.asarray), jnp.asarray(x),
                               dense_residual=dense_residual)
    ty, taux = moe.moe_ffn(tcfg, _tree(p, torch.from_numpy),
                           torch.from_numpy(x), dense_residual=dense_residual)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=ATOL_FN)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=ATOL_FN)

    sg = min(tcfg.moe.dispatch_group, b * s)
    g = -(-b * s // sg)
    xs = np.zeros((g * sg, x.shape[-1]), np.float32)
    xs[:b * s] = x.reshape(b * s, -1)
    logits = xs.reshape(g, sg, -1) @ p["router"]
    jg, ji, ja = jax_moe.route_topk(jcfg.moe, jnp.asarray(logits))
    tg, ti, ta = moe.route_topk(tcfg.moe, torch.from_numpy(logits))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=ATOL_FN)
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=ATOL_FN)
    # (token, expert) pairs past their expert's capacity in their group
    counts = np.stack([np.bincount(ti[i].numpy().ravel(), minlength=4)
                       for i in range(g)])
    dropped = np.maximum(counts - moe.capacity(tcfg.moe, sg), 0).sum()
    if case in ("drops", "routed"):
        assert (dropped > 0) == (case == "drops"), counts
    assert (g * sg > b * s) == (case == "padding")


def test_route_topk_breaks_ties_as_jax():
    """Equal probabilities: the lower expert comes first, as
    ``jax.lax.top_k`` orders them."""
    m = MoEConfig(num_experts=6, top_k=2)
    logits = np.asarray([[[1, 3, 3, 0, 3, 1], [2, 2, 2, 2, 2, 2],
                          [0, 0, 5, 5, 0, 0]]], np.float32)
    jg, ji, ja = jax_moe.route_topk(m, jnp.asarray(logits))
    tg, ti, ta = moe.route_topk(m, torch.from_numpy(logits))
    assert ti.tolist() == np.asarray(ji).tolist() == [[[1, 2], [0, 1],
                                                       [2, 3]]]
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=ATOL_FN)
    np.testing.assert_allclose(float(ta), float(ja), atol=ATOL_FN)


ARCTIC = "arctic-480b"
JAMBA = "jamba-1.5-large-398b"
MODELS = {
    "arctic": (ARCTIC, dict(n_layers=2)),
    "arctic-g7": (ARCTIC, dict(n_layers=2, n_heads=14, n_kv_heads=2)),
    "jamba-moe": (JAMBA, {}),
    "llama2-70b": ("llama2-70b", dict(n_layers=2)),
    "qwen3-4b": ("qwen3-4b", dict(n_layers=2)),
}


@functools.lru_cache(maxsize=None)
def models(key):
    """(jax cfg, torch cfg, jax params, torch params) of one of MODELS."""
    name, kw = MODELS[key]
    jcfg, tcfg = _both(name, **kw)
    jparams = jax_model.init(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_configs_are_the_jax_configs():
    """The port's copies of the new configurations, and their scale-downs,
    equal the JAX package's field by field; the group-7 variant has group
    7, and Arctic's group 7 is built at its head_dim 128."""
    for name in (ARCTIC, "llama2-70b", "qwen3-4b", JAMBA):
        j, t = jax_get_config(name), get_config(name)
        for cj, ct in ((j, t), (jax_scale_down(j), scale_down(t))):
            for f in dataclasses.fields(ct):
                want = getattr(cj, f.name)
                got = getattr(ct, f.name)
                if dataclasses.is_dataclass(want):   # moe, mamba
                    want = dataclasses.asdict(want)
                    got = dataclasses.asdict(got)
                elif f.name in ("block_pattern", "first_layers"):
                    want = [(s.mixer, s.ffn) for s in want]
                    got = [(s.mixer, s.ffn) for s in got]
                assert got == want, (name, f.name)
    name, kw = MODELS["arctic-g7"]
    assert _both(name, **kw)[1].gqa_group == 7
    full = get_config(ARCTIC)
    assert full.gqa_group == 7 and full.resolved_head_dim == 128
    pa.check_heads(lambda ok, what: None if ok else pytest.fail(what),
                   full.n_heads, full.n_kv_heads, full.resolved_head_dim)
    specs = {s.ffn for s in scale_down(get_config(JAMBA)).layer_specs()}
    assert FFN_MOE in specs and \
        scale_down(full).layer_specs()[0].ffn == FFN_MOE_DENSE


def _per_layer(cfg, stacked):
    out = []
    for gi, (pattern, reps) in enumerate(cfg.layer_groups()):
        for r in range(reps):
            for i in range(len(pattern)):
                out.append(jax.tree.map(lambda a, r=r: np.asarray(a)[r],
                                        stacked[gi][f"sub{i}"]))
    return out


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def _cache_close(jcfg, jcache, tcache, atol):
    jl = _per_layer(jcfg, jcache)
    assert len(jl) == len(tcache)
    for j, t in zip(jl, tcache):
        assert set(j) == set(t)
        for name in t:
            _close(t[name], j[name], atol)


@pytest.mark.parametrize("key", sorted(MODELS))
def test_forward_full_chunk_and_decode_match_jax(key):
    """``forward_full`` on two 13-token prompts (logits and the balance
    loss summed over layers), then a 16-row cache filled by a 5- and a
    2-token chunk and a decode over 3 rows: logits and every cache leaf
    after each call."""
    jcfg, tcfg, jparams, tparams = models(key)
    atol = ATOL if tcfg.moe is None else ATOL_MOE
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab_size, (2, 13)).astype(np.int32)
    jlog, jaux = jax_model.forward_full(jcfg, jparams, jnp.asarray(toks))
    tlog, taux = model.forward_full(tcfg, tparams, torch.from_numpy(toks))
    _close(tlog, jlog, atol)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=ATOL)
    assert (float(taux) > 0) == (tcfg.moe is not None)
    jcache = jax_model.init_cache(jcfg, 1, 3, 16)
    tcache = model.init_cache(tcfg, 3, 16, device="cpu")
    for kind, length, clen in (("chunk", 5, [0, 0, 0]),
                               ("chunk", 2, [5, 5, 5]),
                               ("decode", 1, [7, 7, 7])):
        toks = rng.integers(0, tcfg.vocab_size, (3, length)).astype(np.int32)
        clen = np.asarray(clen, np.int32)
        fn = (jax_model.forward_chunk, model.forward_chunk) \
            if kind == "chunk" else \
            (jax_model.forward_decode, model.forward_decode)
        jlog, jcache = fn[0](jcfg, jparams, jnp.asarray(toks), jcache,
                             jnp.asarray(clen))
        tlog, tcache = fn[1](tcfg, tparams, torch.from_numpy(toks), tcache,
                             torch.from_numpy(clen))
        _close(tlog, jlog, atol)
        _cache_close(jcfg, jcache, tcache, atol)


@pytest.mark.parametrize("key", sorted(MODELS))
def test_forward_packed_matches_jax(key):
    """Two packed iterations over 3 slots (as ``tests/test_torch_hybrid.py``
    packs them), padding included: every padded row is routed, as in JAX."""
    jcfg, tcfg, jparams, tparams = models(key)
    atol = ATOL if tcfg.moe is None else ATOL_MOE
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
        _close(tlog[0, :n_real], np.asarray(jlog)[0, :n_real], atol)
        _cache_close(jcfg, jcache, tcache, atol)


def test_prefill_states_match_jax():
    """``forward_full(return_states=True)`` on Jamba with its MoE layers:
    the attention layer's K/V and each Mamba layer's state."""
    jcfg, tcfg, jparams, tparams = models("jamba-moe")
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 9)) \
        .astype(np.int32)
    _, jaux, jstates = jax_model.forward_full(
        jcfg, jparams, jnp.asarray(toks), return_states=True)
    _, taux, tstates = model.forward_full(
        tcfg, tparams, torch.from_numpy(toks), return_states=True)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=ATOL)
    for spec, j, t in zip(tcfg.layer_specs(), _per_layer(jcfg, jstates),
                          tstates):
        pairs = [(t["kv"][i], j["kv"][i]) for i in range(2)] \
            if spec.mixer == ATTN else [(t[n], j[n]) for n in ("conv", "ssm")]
        for got, want in pairs:
            _close(got, want, ATOL_MOE)
