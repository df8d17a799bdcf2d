"""The port's absorbed MLA (DeepSeek-V2) against the JAX package, f32 on the
CPU.

* ``ops.mla_attention``'s plain version against the JAX
  ``ops.packed_attention`` on the concatenated key ``[c_kv | k_rope]`` with
  value ``c_kv`` (one KV head), through its XLA reference and through the
  Pallas body in interpret mode, with a ``logit_scale`` that is not
  d_qk ** -0.5: ragged lengths, ``kv_bucket`` edges (lengths below, at and
  past the bucket), an out-of-range slot and a length of 0 (zeros in the
  port; the Pallas body gives zeros at length 0 too, and JAX's answer for
  an out-of-range slot is undefined).  At atol 1e-5.
* ``logit_scale`` on the three GQA plain versions against the JAX
  references, at atol 1e-5.
* ``mla_packed`` (contiguous, block-table, int8, both), ``mla_decode``,
  ``mla_prefill_chunk`` and ``mla_full`` against JAX at atol 1e-5, caches
  included (the int8 latent codes equal to JAX's).
* ``forward_packed`` in the four KV modes, ``forward_full``,
  ``forward_chunk``, ``forward_decode`` and ``prefill`` against JAX on
  ``scale_down(deepseek-v2-236b)`` (its layer-1 MoE FFN routes a
  bf16-rounded input: atol 1e-2, as ``tests/test_torch_moe.py`` finds) and
  on a dense variant whose ``kv_lora_rank`` (48) differs from
  ``qk_nope_dim`` (32), so that a scale of d_qk ** -0.5 in place of
  (nope + rope) ** -0.5 shows (at ``scale_down`` widths rank = nope and
  the two coincide): atol 1e-4 (1e-2 through an int8 cache, whose codes
  may be one off JAX's; see ``test_forward_packed_matches_jax``).
* ``kv_bytes_per_token`` against the JAX engine's at full width.
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
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import attention as jax_attn
from repro.models import model as jax_model
from repro.models.param import init_params as jax_init_params
from repro.serving.engine import kv_bytes_per_token as jax_kv_bytes
from repro_torch.configs import FFN_DENSE, MLAConfig, get_config, scale_down
from repro_torch.kernels import mla_attention as mla_kernel
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_ref
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.mla_attention import (mla_attention_cuda,
                                               mla_attention_ref)
from repro_torch.kernels.packed_attention import packed_attention_ref
from repro_torch.models import attention as attn
from repro_torch.models import model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving.engine import kv_bytes_per_token
from test_torch_moe import _cache_close, _close, _per_layer, _tree

DEEPSEEK = "deepseek-v2-236b"
ATOL_FN = 1e-5
ATOL = 1e-4
ATOL_MOE = 1e-2


def _configs(key):
    """(jax cfg, torch cfg) in f32: ``scale_down(deepseek-v2-236b)``, or its
    dense variant at latent rank 48 (nope 32), made the same way in both
    packages."""
    jcfg = dataclasses.replace(jax_scale_down(jax_get_config(DEEPSEEK)),
                               dtype="float32")
    tcfg = dataclasses.replace(scale_down(get_config(DEEPSEEK)),
                               dtype="float32")
    if key == "r48":
        out = []
        for cfg in (jcfg, tcfg):
            first = tuple(dataclasses.replace(s, ffn=FFN_DENSE)
                          for s in cfg.first_layers)
            pattern = tuple(dataclasses.replace(s, ffn=FFN_DENSE)
                            for s in cfg.block_pattern)
            out.append(dataclasses.replace(
                cfg, moe=None, first_layers=first, block_pattern=pattern,
                mla=dataclasses.replace(cfg.mla, kv_lora_rank=48)))
        jcfg, tcfg = out
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def models(key):
    jcfg, tcfg = _configs(key)
    jparams = jax_model.init(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_configs_are_the_jax_configs():
    """DeepSeek-V2 and its scale-down equal the JAX package's field by
    field; the variant's scale is not d_qk ** -0.5."""
    j, t = jax_get_config(DEEPSEEK), get_config(DEEPSEEK)
    for cj, ct in ((j, t), (jax_scale_down(j), scale_down(t))):
        for f in dataclasses.fields(ct):
            want, got = getattr(cj, f.name), getattr(ct, f.name)
            if dataclasses.is_dataclass(want):          # moe, mla
                want, got = dataclasses.asdict(want), dataclasses.asdict(got)
            elif f.name in ("block_pattern", "first_layers"):
                want = [(s.mixer, s.ffn) for s in want]
                got = [(s.mixer, s.ffn) for s in got]
            assert got == want, f.name
    assert t.mla == MLAConfig(512, 1536, 128, 64, 128)
    m = _configs("r48")[1].mla
    assert m.kv_lora_rank != m.qk_nope_dim
    assert attn._mla_scale(_configs("r48")[1]) != \
        (m.kv_lora_rank + m.qk_rope_dim) ** -0.5


# ---- ops.mla_attention -----------------------------------------------------
def _latent_case(case, t=9, h=4, n=3, s=40, rank=32, rope=8):
    """(q, c_kv, k_rope, slot, lengths, kv_bucket) as numpy, and the
    tokens both packages define (slot in range, length >= 1)."""
    rng = np.random.default_rng(len(case))
    q = rng.normal(size=(t, h, rank + rope)).astype(np.float32)
    c_kv = rng.normal(size=(n, s, rank)).astype(np.float32)
    k_rope = rng.normal(size=(n, s, rope)).astype(np.float32)
    slot = rng.integers(0, n, t).astype(np.int32)
    lens = rng.integers(1, s + 1, t).astype(np.int32)
    bucket = None
    if case == "bucket":     # below, at and past the bucket, and S itself
        bucket = 24
        lens[:5] = [23, 24, 25, 40, 1]
    elif case == "full_bucket":
        bucket = s
        lens[:2] = [s, s - 1]
    elif case == "edges":    # slots -1 and N, a length of 0 and one < 0
        slot[:2] = [-1, n]
        lens[2:4] = [0, -3]
    ok = (slot >= 0) & (slot < n) & (lens > 0)
    return (q, c_kv, k_rope, slot, lens, bucket), ok


@pytest.mark.parametrize("impl", ["ref", "interpret"])
@pytest.mark.parametrize("case", ["ragged", "bucket", "full_bucket", "edges"])
def test_mla_attention_plain_matches_jax(case, impl):
    (q, c_kv, k_rope, slot, lens, bucket), ok = _latent_case(case)
    scale = 0.17
    got = ops.mla_attention(*(torch.from_numpy(a) for a in
                              (q, c_kv, k_rope, slot, lens)),
                            logit_scale=scale, kv_bucket=bucket).numpy()
    key = np.concatenate([c_kv, k_rope], -1)[:, :, None]
    want = np.asarray(jax_ops.packed_attention(
        jnp.asarray(q), jnp.asarray(key), jnp.asarray(c_kv[:, :, None]),
        jnp.asarray(slot), jnp.asarray(lens), logit_scale=scale,
        kv_bucket=bucket, impl=impl))
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=ATOL_FN)
    assert not got[~ok].any()
    if impl == "interpret":    # the Pallas body: zeros at length 0 as well
        zero = (lens == 0) & (slot >= 0) & (slot < len(c_kv))
        assert not want[zero].any()


def test_mla_attention_cuda_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only, launches nothing for
    a CPU tensor, and the ops entry picks the plain version on the CPU."""
    (q, c_kv, k_rope, slot, lens, _), _ = _latent_case("ragged")
    args = [torch.from_numpy(a) for a in (q, c_kv, k_rope, slot, lens)]
    before = mla_attention_cuda.launches
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        mla_attention_cuda(*args, logit_scale=0.1)
    torch.testing.assert_close(ops.mla_attention(*args, logit_scale=0.1),
                               mla_attention_ref(*args, logit_scale=0.1),
                               rtol=0, atol=0)
    assert mla_attention_cuda.launches == before


@pytest.mark.parametrize("t,h,sweep", [(8, 128, 1024), (1, 64, 100),
                                       (245, 128, 1024), (2, 128, 0),
                                       (33, 64, 513), (60, 128, 1024),
                                       (3, 64, 64), (5, 128, 65)])
def test_split_plan_covers_the_sweep(t, h, sweep):
    """Chunks are whole 64-row stages that cover the sweep; a stream whose
    (token, 64-head block) items fill the 132 SMs is not split, and a
    split takes chunks of at least MIN_CHUNK rows, no more of them than
    bring the CTAs up to the SMs.  The plan takes no length, and the host
    replay of the grid (``items``, as the kernel decodes it) covers every
    (token, head block, attended row) exactly once, at random lengths,
    lengths at stage edges, past the sweep and none."""
    chunk, splits = mla_kernel.plan(t, h, sweep, 132)
    assert chunk % mla_kernel.STAGE == 0 and chunk > 0
    assert splits == max(1, -(-sweep // chunk))
    assert (splits - 1) * chunk < max(sweep, 1) <= splits * chunk
    items = t * h // 64
    if items >= 132:
        assert splits == 1
    if splits > 1:
        assert chunk >= mla_kernel.MIN_CHUNK
        assert (splits - 1) * items < 132
    rng = np.random.default_rng(t + h + sweep)
    edges = [1, 31, 32, 33, 63, 64, 65, sweep - 1, sweep, sweep + 7, 0, -3]
    n = 4
    slots = [int(x) for x in rng.integers(-1, n + 1, t)]
    for lens in ([int(x) for x in rng.integers(0, sweep + 9, t)],
                 [edges[i % len(edges)] for i in range(t)]):
        grid = mla_kernel.items((chunk, splits), h, n, sweep, slots, lens)
        assert len(grid) == items * splits
        assert [it.cta for it in grid] == list(range(len(grid)))
        seen = {}
        for it in grid:
            if it.k1 > it.k0:
                assert it.k0 % mla_kernel.STAGE == 0
                for r in range(it.k0, it.k1):
                    key = (it.token, it.hb, r)
                    assert key not in seen
                    seen[key] = it.chunk
        want = {(tok, hb, r) for tok in range(t) for hb in range(h // 64)
                if 0 <= slots[tok] < n
                for r in range(max(0, min(lens[tok], sweep)))}
        assert set(seen) == want
        # the chunks of an item with rows are its first ``live`` ones, the
        # only ones that write a partial and take a ticket
        for it in grid:
            assert (it.k1 > it.k0) == (it.chunk < it.live)


# ---- logit_scale on the GQA entries -----------------------------------------
def test_gqa_entries_take_logit_scale():
    """The packed, flash and decode plain versions against the JAX
    references at a logit_scale that is not D ** -0.5 (d_v != d_qk too),
    and their default against D ** -0.5."""
    rng = np.random.default_rng(7)
    scale = 0.3
    q = rng.normal(size=(6, 4, 24)).astype(np.float32)
    k = rng.normal(size=(2, 10, 2, 24)).astype(np.float32)
    v = rng.normal(size=(2, 10, 2, 16)).astype(np.float32)
    slot = np.asarray([0, 1, 1, 0, 1, 0], np.int32)
    lens = np.asarray([1, 10, 4, 7, 9, 3], np.int32)
    t = [torch.from_numpy(a) for a in (q, k, v, slot, lens)]
    j = [jnp.asarray(a) for a in (q, k, v, slot, lens)]
    for fn in (ops.packed_attention, packed_attention_ref):
        _close(fn(*t, logit_scale=scale),
               jax_ref.packed_attention_ref(*j, logit_scale=scale), ATOL_FN)
    _close(ops.packed_attention(*t),
           packed_attention_ref(*t, logit_scale=24 ** -0.5), 0)
    qb = rng.normal(size=(2, 5, 4, 24)).astype(np.float32)
    off = np.asarray([3, 5], np.int32)
    for fn in (ops.flash_attention, flash_attention_ref):
        _close(fn(torch.from_numpy(qb), t[1], t[2],
                  q_offset=torch.from_numpy(off), logit_scale=scale),
               jax_ref.flash_attention_ref(jnp.asarray(qb), j[1], j[2],
                                           q_offset=jnp.asarray(off),
                                           logit_scale=scale), ATOL_FN)
    cl = np.asarray([4, 10], np.int32)
    for fn in (ops.decode_attention, decode_attention_ref):
        _close(fn(t[0][:2], t[1], t[2], torch.from_numpy(cl),
                  logit_scale=scale),
               jax_ref.decode_attention_ref(j[0][:2], j[1], j[2],
                                            jnp.asarray(cl),
                                            logit_scale=scale), ATOL_FN)


# ---- the MLA attention functions ---------------------------------------------
SLOTS, MAX_LEN, BS = 3, 16, 4


def _mla_params(jcfg):
    defs = jax_attn.mla_defs(jcfg, 1)
    return _tree(jax_init_params(defs, jax.random.PRNGKey(2)), np.asarray)


def _packed_streams(tables):
    """Two packed iterations as (slot, pos, wpos, dst) int32 arrays: prefill
    chunks of slots 0-2, then decode tokens of slots 0 and 2, the rest of
    slot 1's prompt and 2 padding rows; ``dst`` through ``tables``."""
    its = []
    for segs, pad in ((((0, 0, 5), (1, 0, 6), (2, 0, 3)), 0),
                      (((0, 5, 1), (2, 3, 1), (1, 6, 7)), 2)):
        slot = np.concatenate([np.full(ln, s) for s, _, ln in segs]
                              + [np.zeros(pad, int)])
        pos = np.concatenate([np.arange(off, off + ln) for _, off, ln in segs]
                             + [np.zeros(pad, int)])
        real = len(slot) - pad
        wpos = np.where(np.arange(len(slot)) < real, pos, MAX_LEN)
        dst = np.where(wpos < MAX_LEN,
                       tables[slot, pos // BS] * BS + pos % BS,
                       SLOTS * MAX_LEN)
        its.append(tuple(np.asarray(a, np.int32)
                         for a in (slot, pos, wpos, dst)))
    return its


def _leaves_equal(tcache, jcache, atol):
    assert set(tcache) == set(jcache)
    for name, leaf in tcache.items():
        want = np.asarray(jcache[name])
        if leaf.dtype == torch.int8:
            np.testing.assert_array_equal(leaf.numpy(), want)
        else:
            np.testing.assert_allclose(leaf.numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("mode", ["contiguous", "block", "int8",
                                  "block_int8"])
@pytest.mark.parametrize("key", ["deepseek", "r48"])
def test_mla_packed_matches_jax(key, mode):
    """Two iterations of ``mla_packed`` on one layer's cache: outputs and
    the scattered latents (int8 codes equal, scales at 1e-5)."""
    jcfg, tcfg = _configs(key)
    p = _mla_params(jcfg)
    jp, tp = _tree(p, jnp.asarray), _tree(p, torch.from_numpy)
    kv_dtype = "int8" if "int8" in mode else None
    blocked = "block" in mode
    rng = np.random.default_rng(5)
    tables = rng.permutation(SLOTS * MAX_LEN // BS).astype(np.int32) \
        .reshape(SLOTS, MAX_LEN // BS)
    jcache = jax_attn.mla_init_cache(jcfg, 1, SLOTS, MAX_LEN, kv_dtype)
    tcache = attn.mla_init_cache(tcfg, SLOTS, MAX_LEN, torch.device("cpu"),
                                 kv_dtype)
    for bucket, (slot, pos, wpos, dst) in zip((8, 16),
                                              _packed_streams(tables)):
        x = rng.normal(size=(1, len(slot), jcfg.d_model)).astype(np.float32)
        jkw = dict(token_dst=jnp.asarray(dst),
                   block_tables=jnp.asarray(tables)) if blocked else {}
        tkw = dict(token_dst=torch.from_numpy(dst),
                   block_tables=torch.from_numpy(tables)) if blocked else {}
        jy, jcache = jax_attn.mla_packed(
            jcfg, jp, jnp.asarray(x), jnp.asarray(pos)[None], jcache,
            jnp.asarray(slot), jnp.asarray(wpos), kv_bucket=bucket, **jkw)
        ty, tcache = attn.mla_packed(
            tcfg, tp, torch.from_numpy(x), torch.from_numpy(pos)[None],
            tcache, torch.from_numpy(slot), torch.from_numpy(wpos),
            kv_bucket=bucket, **tkw)
        n_real = int((wpos < MAX_LEN).sum())
        _close(ty[:, :n_real], np.asarray(jy)[:, :n_real], ATOL_FN)
        _leaves_equal(tcache, jcache, ATOL_FN)


@pytest.mark.parametrize("key", ["deepseek", "r48"])
def test_mla_legacy_paths_match_jax(key):
    """``mla_full`` (at q_offset 0 and 3, with its latents), then a 3-row
    cache filled by a 5- and a 2-token ``mla_prefill_chunk`` at per-row
    offsets and a ``mla_decode``: outputs and caches."""
    jcfg, tcfg = _configs(key)
    p = _mla_params(jcfg)
    jp, tp = _tree(p, jnp.asarray), _tree(p, torch.from_numpy)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 7, jcfg.d_model)).astype(np.float32)
    for off in (0, 3):
        pos = np.broadcast_to(np.arange(off, off + 7, dtype=np.int32), (2, 7))
        jy, (jc, jr) = jax_attn.mla_full(jcfg, jp, jnp.asarray(x),
                                         jnp.asarray(pos), q_offset=off,
                                         return_kv=True)
        ty, (tc, tr) = attn.mla_full(tcfg, tp, torch.from_numpy(x),
                                     torch.from_numpy(pos.copy()),
                                     q_offset=off, return_kv=True)
        for got, want in ((ty, jy), (tc, jc), (tr, jr)):
            _close(got, want, ATOL_FN)
    jcache = jax_attn.mla_init_cache(jcfg, 1, 3, MAX_LEN)
    tcache = attn.mla_init_cache(tcfg, 3, MAX_LEN, torch.device("cpu"))
    for kind, length, clen in (("chunk", 5, [0, 2, 4]),
                               ("chunk", 2, [5, 7, 9]),
                               ("decode", 1, [7, 9, 11])):
        clen = np.asarray(clen, np.int32)
        x = rng.normal(size=(3, length, jcfg.d_model)).astype(np.float32)
        pos = (clen[:, None] + np.arange(length)).astype(np.int32)
        fns = (jax_attn.mla_prefill_chunk, attn.mla_prefill_chunk) \
            if kind == "chunk" else (jax_attn.mla_decode, attn.mla_decode)
        jy, jcache = fns[0](jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                            jcache, jnp.asarray(clen))
        ty, tcache = fns[1](tcfg, tp, torch.from_numpy(x),
                            torch.from_numpy(pos), tcache,
                            torch.from_numpy(clen))
        _close(ty, jy, ATOL_FN)
        _leaves_equal(tcache, jcache, ATOL_FN)


# ---- the model -------------------------------------------------------------
def _atol(tcfg):
    return ATOL if tcfg.moe is None else ATOL_MOE


@pytest.mark.parametrize("key", ["deepseek", "r48"])
def test_forward_full_chunk_and_decode_match_jax(key):
    """``forward_full`` on two 13-token prompts, then a 16-row cache
    filled by a 5- and a 2-token chunk and a decode over 3 rows: logits
    and every cache leaf after each call."""
    jcfg, tcfg, jparams, tparams = models(key)
    atol = _atol(tcfg)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab_size, (2, 13)).astype(np.int32)
    jlog, jaux = jax_model.forward_full(jcfg, jparams, jnp.asarray(toks))
    tlog, taux = model.forward_full(tcfg, tparams, torch.from_numpy(toks))
    _close(tlog, jlog, atol)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=ATOL)
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


@pytest.mark.parametrize("mode", ["contiguous", "block", "int8",
                                  "block_int8"])
@pytest.mark.parametrize("key", ["deepseek", "r48"])
def test_forward_packed_matches_jax(key, mode):
    """Two packed iterations over 3 slots, padding included, in each KV
    mode (block tables: a shuffled physical-block table of 4-row blocks):
    the logits of the real tokens and the caches.  With int8 KV a code may
    be one off JAX's (the packages' f32 latents differ in the last ulp,
    which a value at a .5 tie carries into the code), and one code of a
    latent row (1/127 of its largest value) moves the later logits of its
    slot by up to ~1e-3 (1.04e-3 measured here for one such code in
    layer 1 of ``r48``): atol 1e-2 for the logits there."""
    jcfg, tcfg, jparams, tparams = models(key)
    atol = _atol(tcfg) if "int8" not in mode else ATOL_MOE
    kv_dtype = "int8" if "int8" in mode else None
    blocked = "block" in mode
    rng = np.random.default_rng(9)
    tables = rng.permutation(SLOTS * MAX_LEN // BS).astype(np.int32) \
        .reshape(SLOTS, MAX_LEN // BS)
    jcache = jax_model.init_cache(jcfg, 1, SLOTS, MAX_LEN, kv_dtype)
    tcache = model.init_cache(tcfg, SLOTS, MAX_LEN, device="cpu",
                              kv_dtype=kv_dtype)
    for slot, pos, wpos, dst in _packed_streams(tables):
        toks = rng.integers(0, tcfg.vocab_size, len(slot)).astype(np.int32)
        jkw = dict(token_dst=jnp.asarray(dst),
                   block_tables=jnp.asarray(tables)) if blocked else {}
        tkw = dict(token_dst=torch.from_numpy(dst),
                   block_tables=torch.from_numpy(tables)) if blocked else {}
        jlog, jcache = jax_model.forward_packed(
            jcfg, jparams, jnp.asarray(toks)[None], jcache, jnp.asarray(slot),
            jnp.asarray(pos), jnp.asarray(wpos), jnp.asarray(wpos < MAX_LEN),
            kv_bucket=MAX_LEN, **jkw)
        tlog, tcache = model.forward_packed(
            tcfg, tparams, torch.from_numpy(toks)[None], tcache,
            torch.from_numpy(slot), torch.from_numpy(pos),
            torch.from_numpy(wpos), kv_bucket=MAX_LEN, **tkw)
        n_real = int((wpos < MAX_LEN).sum())
        _close(tlog[0, :n_real], np.asarray(jlog)[0, :n_real], atol)
        for want, got in zip(_per_layer(jcfg, jcache), tcache):
            assert set(got) == set(want)
            for name, leaf in got.items():
                if leaf.dtype == torch.int8:
                    diff = np.abs(leaf.numpy().astype(np.int32) - want[name])
                    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
                else:
                    _close(leaf, want[name], atol)


@pytest.mark.parametrize("key", ["deepseek", "r48"])
def test_prefill_matches_jax(key):
    """``prefill`` of two 11-token prompts into a 16-row cache: the last
    logits, the latent cache (rows past the prompt zero) and the
    lengths."""
    jcfg, tcfg, jparams, tparams = models(key)
    atol = _atol(tcfg)
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 11)) \
        .astype(np.int32)
    jlast, jcache, jlen = jax_model.prefill(jcfg, jparams, jnp.asarray(toks),
                                            max_len=16)
    tlast, tcache, tlen = model.prefill(tcfg, tparams,
                                        torch.from_numpy(toks), max_len=16)
    _close(tlast, jlast, atol)
    _cache_close(jcfg, jcache, tcache, atol)
    assert tlen.tolist() == np.asarray(jlen).tolist() == [11, 11]
    assert set(tcache[0]) == {"c_kv", "k_rope"}
    assert not tcache[0]["c_kv"][:, 11:].any()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_kv_bytes_per_token_matches_jax(kv_dtype):
    """Full width, on ``meta``: 1152 B a layer in bf16 (512 + 64 latent
    values), 584 in int8 (+ two f32 scales), over 60 layers."""
    want = {None: 69_120, "int8": 35_040}[kv_dtype]
    got = kv_bytes_per_token(get_config(DEEPSEEK), kv_dtype)
    assert got == jax_kv_bytes(jax_get_config(DEEPSEEK), kv_dtype) == want
