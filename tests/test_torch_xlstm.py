"""The port's xLSTM mixers against the JAX package, f32 on the CPU.

The recurrences first, on the same random inputs in both packages: the
sequential mLSTM (``mlstm_chunk_ref``) and its one-step form
(``mlstm_step_ref``), with and without an initial state; the
chunkwise-parallel form (``mlstm_chunkwise``) against JAX's and against
the sequential one, with a sequence that is not a multiple of the chunk;
and the sLSTM scan (``_slstm_scan``).  Then the model on
``scale_down(xlstm-1.3b)`` (one 8-layer group: 7 mLSTM layers and an
sLSTM layer at index 7, no FFNs), with the JAX ``model.init`` pytree
converted: ``forward_full(return_states=True)``, ``prefill``,
``forward_chunk``, ``forward_decode`` and ``forward_packed``, logits and
every state leaf at atol 1e-4 (the packages sum in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import scale_down as jax_scale_down
from repro.kernels import ref as jax_ref
from repro.models import model as jax_model
from repro.models import xlstm as jax_xlstm
from repro_torch.configs import MLSTM, SLSTM, get_config, scale_down
from repro_torch.models import model, xlstm
from repro_torch.models.convert import from_jax_params
from repro_torch.models.param import map_defs

ATOL = 1e-4
XLSTM = "xlstm-1.3b"


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _gates(rng, b, s, h):
    """Log input gates around 0 and log-sigmoid forget gates."""
    ig = rng.normal(size=(b, s, h)).astype(np.float32)
    fg = np.log(1 / (1 + np.exp(-rng.normal(2.0, 1.0, size=(b, s, h)))))
    return ig, fg.astype(np.float32)


def _mlstm_inputs(seed, b=2, s=11, h=3, dqk=8, dv=6, initial=False):
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(b, s, h, dqk)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(b, s, h, dv)).astype(np.float32)
    ig, fg = _gates(rng, b, s, h)
    st = None
    if initial:
        st = (rng.normal(size=(b, h, dqk, dv)).astype(np.float32),
              rng.normal(size=(b, h, dqk)).astype(np.float32),
              rng.normal(size=(b, h)).astype(np.float32))
    return (q, k, v, ig, fg), st


def _t(tree):
    return tuple(torch.from_numpy(a) for a in tree) if tree is not None \
        else None


def _j(tree):
    return tuple(jnp.asarray(a) for a in tree) if tree is not None else None


@pytest.mark.parametrize("initial", [False, True])
def test_mlstm_chunk_ref_matches_jax(initial):
    """Outputs and the final (c, n, m); without a state m starts at
    -inf in both."""
    args, st = _mlstm_inputs(1, initial=initial)
    jy, jst = jax_ref.mlstm_chunk_ref(*_j(args), initial=_j(st))
    ty, tst = xlstm.mlstm_chunk_ref(*_t(args), initial=_t(st))
    _close(ty, jy)
    for a, b in zip(tst, jst):
        _close(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_mlstm_step_ref_matches_jax(seed):
    """Three chained steps from a cache-style state (m = -1e30) and from
    a random one."""
    (q, k, v, ig, fg), st = _mlstm_inputs(seed, s=3, initial=bool(seed))
    if st is None:
        b, _, h, dqk = q.shape
        st = (np.zeros((b, h, dqk, v.shape[-1]), np.float32),
              np.zeros((b, h, dqk), np.float32),
              np.full((b, h), -1e30, np.float32))
    jst, tst = _j(st), _t(st)
    for t in range(3):
        step = (q[:, t], k[:, t], v[:, t], ig[:, t], fg[:, t])
        jy, jst = jax_ref.mlstm_step_ref(*_j(step), jst)
        ty, tst = xlstm.mlstm_step_ref(*_t(step), tst)
        _close(ty, jy)
        for a, b in zip(tst, jst):
            _close(a, b)


@pytest.mark.parametrize("s,chunk", [(13, 4), (16, 8), (5, 64)])
@pytest.mark.parametrize("initial", [False, True])
def test_mlstm_chunkwise_matches_jax(s, chunk, initial):
    """JAX's chunkwise form and the port's on the same inputs, S a
    multiple of the chunk or not (13 = 3 x 4 + 1, padded) and shorter
    than it; both also agree with the sequential form."""
    args, st = _mlstm_inputs(2, s=s, initial=initial)
    jy, jst = jax_xlstm.mlstm_chunkwise(*_j(args), chunk=chunk,
                                        initial=_j(st))
    ty, tst = xlstm.mlstm_chunkwise(*_t(args), chunk=chunk, initial=_t(st))
    _close(ty, jy)
    for a, b in zip(tst, jst):
        _close(a, b)
    sy, sst = xlstm.mlstm_chunk_ref(*_t(args), initial=_t(st))
    _close(ty, sy)
    for a, b in zip(tst, sst):
        _close(a, b)


def _jax_cfg(**kw):
    return dataclasses.replace(jax_scale_down(jax_get_config(XLSTM)),
                               dtype="float32", **kw)


def _torch_cfg(**kw):
    return dataclasses.replace(scale_down(get_config(XLSTM)),
                               dtype="float32", **kw)


@pytest.fixture(scope="module")
def models():
    """(jax cfg, torch cfg, jax params, torch params) on the CPU, f32."""
    jcfg, tcfg = _jax_cfg(), _torch_cfg()
    assert [s.mixer for s in tcfg.layer_specs()] == [MLSTM] * 7 + [SLSTM]
    jparams = jax_model.init(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("seed", [0, 1])
def test_slstm_scan_matches_jax(models, seed):
    """The sLSTM layer's recurrence over 9 steps of random gate inputs,
    from zeros with m = -1e30 and from a random state whose normaliser n
    is positive, as every state the recurrence reaches (n = f n + i)."""
    jcfg, tcfg, jparams, tparams = models
    p_t = tparams["layers"][7]["mixer"]
    p_j = jax.tree.map(lambda a: a[0], jparams["group0"]["sub7"]["mixer"])
    rng = np.random.default_rng(seed)
    b, d = 2, tcfg.d_model
    xg = rng.normal(size=(b, 9, 4 * d)).astype(np.float32)
    if seed:
        c, n, h, m = (rng.normal(size=(b, d)).astype(np.float32)
                      for _ in range(4))
        st = (c, np.abs(n) + 0.5, h, m)
    else:
        st = (np.zeros((b, d), np.float32),) * 3 + \
            (np.full((b, d), -1e30, np.float32),)
    jy, jst = jax_xlstm._slstm_scan(jcfg, p_j, jnp.asarray(xg), _j(st))
    ty, tst = xlstm._slstm_scan(tcfg, p_t, torch.from_numpy(xg), _t(st))
    _close(ty, jy)
    for a, b_ in zip(tst, jst):
        _close(a, b_)


def _per_layer(cfg, stacked):
    """JAX per-group stacked trees -> one dict of numpy leaves per layer."""
    out = []
    for gi, (pattern, reps) in enumerate(cfg.layer_groups()):
        for r in range(reps):
            for i in range(len(pattern)):
                out.append(jax.tree.map(lambda a, r=r: np.asarray(a)[r],
                                        stacked[gi][f"sub{i}"]))
    return out


def _states_close(jcfg, jstates, tstates):
    jl = _per_layer(jcfg, jstates)
    assert len(jl) == len(tstates)
    for j, t in zip(jl, tstates):
        assert set(j) == set(t)
        for name in t:
            assert t[name].dtype == torch.float32
            _close(t[name], j[name])


def test_init_cache_matches_jax(models):
    """The leaves, shapes and initial values (m at -1e30) of the slot
    state."""
    jcfg, tcfg, _, _ = models
    jc = _per_layer(jcfg, jax_model.init_cache(jcfg, 1, 3, 16))
    tc = model.init_cache(tcfg, 3, 16, device="cpu")
    for j, t in zip(jc, tc):
        assert set(j) == set(t)
        for name in t:
            assert tuple(t[name].shape) == j[name].shape
            np.testing.assert_array_equal(t[name].numpy(), j[name])


def test_forward_full_and_prefill_match_jax(models):
    """Two 13-token prompts: logits and every layer's final state, then
    ``prefill`` into a 24-row cache."""
    jcfg, tcfg, jparams, tparams = models
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 13)) \
        .astype(np.int32)
    jlog, _, jstates = jax_model.forward_full(
        jcfg, jparams, jnp.asarray(toks), return_states=True)
    tlog, taux, tstates = model.forward_full(
        tcfg, tparams, torch.from_numpy(toks), return_states=True)
    _close(tlog, jlog)
    assert float(taux) == 0.0
    _states_close(jcfg, jstates, tstates)
    jlast, jcache, _ = jax_model.prefill(jcfg, jparams, jnp.asarray(toks),
                                         max_len=24)
    tlast, tcache, tlen = model.prefill(tcfg, tparams, torch.from_numpy(toks),
                                        max_len=24)
    _close(tlast, jlast)
    _states_close(jcfg, jcache, tcache)
    assert tlen.tolist() == [13, 13]


# (kind, length) over 3 rows; the 2-token chunk is shorter than the conv
# kernel's history (3 rows), so the carried history spans two chunks
STEPS = [("chunk", 5), ("chunk", 2), ("decode", 1), ("chunk", 4),
         ("decode", 1)]


def test_chunk_and_decode_match_jax(models):
    """A state carried chunk by chunk with decodes in between: logits and
    every state leaf after each call.  ``forward_decode`` returns new
    states and leaves the given ones as they were."""
    jcfg, tcfg, jparams, tparams = models
    rng = np.random.default_rng(7)
    jcache = jax_model.init_cache(jcfg, 1, 3, 16)
    tcache = model.init_cache(tcfg, 3, 16, device="cpu")
    clen = np.zeros(3, np.int32)
    for kind, length in STEPS:
        toks = rng.integers(0, tcfg.vocab_size, (3, length)).astype(np.int32)
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
            for b, c, n in zip(before, tcache, new):
                assert n is not c
                assert all(torch.equal(b[k], c[k]) for k in c)
            tcache = new
        _close(tlog, jlog)
        _states_close(jcfg, jcache, tcache)
        clen = clen + length


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
        _states_close(jcfg, jcache, tcache)
    with pytest.raises(ValueError, match="token_active"):
        model.forward_packed(tcfg, tparams, torch.from_numpy(toks)[None],
                             tcache, torch.from_numpy(slot),
                             torch.from_numpy(pos), torch.from_numpy(wpos),
                             kv_bucket=max_len)


def test_init_draws_jax_shapes_and_scales():
    """The port's seeded init of the xLSTM leaves: the JAX shapes and
    dtypes, the f32 gates at 0.02 std (a truncated unit normal has std
    ~0.88), the forget bias at ones, the input bias at zeros; the
    per-head q/k/v scaled by their per-head fan-in."""
    tcfg = dataclasses.replace(get_config(XLSTM), n_layers=8)
    jshapes = jax_model.shapes(dataclasses.replace(jax_get_config(XLSTM),
                                                   n_layers=8))
    defs = map_defs(lambda _path, d: (d.shape, d.dtype),
                    model.model_defs(tcfg))
    for i, layer in enumerate(defs["layers"]):
        want = jax.tree.map(lambda s: (tuple(s.shape[1:]), str(s.dtype)),
                            jshapes["group0"][f"sub{i}"],
                            is_leaf=lambda x: hasattr(x, "shape"))
        assert layer == want, i
    small = scale_down(get_config(XLSTM))
    p = model.init(small, seed=2, device="cpu")["layers"][0]["mixer"]
    assert p["w_i"].dtype == torch.float32
    assert abs(p["w_f"].std().item() / 0.02 - 0.88) < 0.1
    assert torch.equal(p["b_f"], torch.ones_like(p["b_f"]))
    assert not p["b_i"].any()
    dh = p["w_q"].shape[1]
    assert abs(p["w_q"].float().std().item() * dh ** 0.5 - 0.88) < 0.05
