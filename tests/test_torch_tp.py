"""The port's tensor-parallel layout and helpers (``repro_torch.distributed
.tp``, ``collective_matmul``, ``launch.mesh``) against the JAX package's
(``repro.distributed.tp``; DESIGN.md §11).

Without a process group: every parameter and cache leaf's rank-r shard
equals the numpy cut of the JAX manual layout (``param_pspecs_tp`` with
``_interleave_halves``, ``cache_pspecs_tp`` with and without int8) on
tiny-toy and the scale-downs of DeepSeek-V2, xLSTM-1.3B and Jamba;
``validate_tp`` and ``collective_bytes_per_iter`` agree with JAX's; a
sharded ``model.init`` is the full init's cut.  Over one spawned pair of
gloo ranks: every helper and collective matmul against the plain product,
f32 at 1e-5 relative.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import scale_down as jax_scale_down
from repro.distributed import tp as jax_tp
from repro.models import model as jax_model
from repro_torch.configs import get_config, scale_down
from repro_torch.distributed import tp
from repro_torch.launch import mesh
from repro_torch.models import model
from repro_torch.models.convert import from_jax_params

import _torch_tp_ranks

FAMILIES = ["tiny-toy", "deepseek-v2-236b", "xlstm-1.3b",
            "jamba-1.5-large-398b"]
TP = 2
REL = 1e-5


def _cfgs(name):
    if name == "tiny-toy":
        return jax_get_config(name), get_config(name)
    return jax_scale_down(jax_get_config(name)), scale_down(get_config(name))


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    jcfg, tcfg = [dataclasses.replace(c, dtype="float32")
                  for c in _cfgs(request.param)]
    jparams = jax.tree.map(np.asarray,
                           jax_model.init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, jparams


def _spec_axis(spec):
    """The axis a JAX PartitionSpec puts on the mesh, or None."""
    for i, ax in enumerate(spec):
        if ax == "model":
            return i
    return None


def _jax_cut(leaf, spec, path, r, p):
    """Rank r's block of a stacked JAX leaf under the manual layout."""
    if jax_tp._needs_half_interleave(path):
        leaf = jax_tp._interleave_halves(leaf, p)
    axis = _spec_axis(spec)
    if axis is None:
        return leaf
    n = leaf.shape[axis] // p
    return np.take(leaf, np.arange(r * n, (r + 1) * n), axis=axis)


def _map_jax(tree, specs, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_jax(tree[k], specs[k], fn, path + (k,)) for k in tree}
    if isinstance(tree, list):
        return [_map_jax(t, s, fn, path + (str(i),))
                for i, (t, s) in enumerate(zip(tree, specs))]
    return fn(tree, specs, path)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


@pytest.mark.parametrize("r", range(TP))
def test_param_shards_equal_jax_layout(family, r):
    """Each leaf of ``tp.shard_params`` equals the JAX layout's cut of the
    same weights (the fused halves re-interleaved first), and at least the
    sharded mixers' leaves are cut."""
    jcfg, tcfg, jparams = family
    specs = jax_tp.param_pspecs_tp(jcfg)
    want = from_jax_params(tcfg, _map_jax(
        jparams, specs, lambda a, s, path: _jax_cut(a, s, path, r, TP)),
        device="cpu")
    full = from_jax_params(tcfg, jparams, device="cpu")
    got = tp.shard_params(tcfg, full, r, TP)
    want_leaves, cut = dict(_leaves(want)), 0
    for path, leaf in _leaves(got):
        assert torch.equal(leaf, want_leaves[path]), path
        cut += leaf.shape != _get(full, path).shape
    assert cut > 0
    # a shard passes through unchanged
    again = tp.shard_params(tcfg, got, r, TP)
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(_leaves(again), _leaves(got)))


def _get(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def test_sharded_init_is_the_full_init_cut(family):
    """``model.init(..., shard=(r, p))`` draws the full init's values and
    keeps the rank's cut."""
    _, tcfg, _ = family
    full = model.init(tcfg, seed=3, device="cpu")
    for r in range(TP):
        got = model.init(tcfg, seed=3, device="cpu", shard=(r, TP))
        want = tp.shard_params(tcfg, full, r, TP)
        for (pa, a), (pb, b) in zip(_leaves(got), _leaves(want)):
            assert pa == pb and torch.equal(a, b), pa


def _unstack_cache(cfg, groups):
    """A JAX-layout cache (per group, ``sub{i}`` leaves with a leading
    reps axis) as the port's per-layer list."""
    layers = []
    for gi, (pattern, reps) in enumerate(cfg.layer_groups()):
        for rep in range(reps):
            for i in range(len(pattern)):
                layers.append({k: torch.from_numpy(np.ascontiguousarray(
                    v[rep])) for k, v in groups[gi][f"sub{i}"].items()})
    return layers


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_cache_shards_equal_jax_layout(family, kv_dtype):
    """``tp.cache_axes`` is JAX's ``cache_pspecs_tp`` without the layer
    stack; a random full cache's shards equal the JAX cut; a rank's
    ``init_cache`` allocates exactly the shard's shapes."""
    jcfg, tcfg, _ = family
    n, s = 2, 8
    jcache = jax.tree.map(np.asarray, jax_model.init_cache(
        jcfg, 1, n, s, kv_dtype))
    specs = jax_tp.cache_pspecs_tp(jcfg, kv_dtype)
    rng = np.random.default_rng(1)
    jcache = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32)
        if a.dtype != np.int8 else rng.integers(-5, 5, a.shape, np.int8),
        jcache)
    full = _unstack_cache(tcfg, jcache)
    layer_specs = tcfg.layer_specs()
    li = 0
    for gi, (pattern, reps) in enumerate(tcfg.layer_groups()):
        for _ in range(reps):
            for i in range(len(pattern)):
                jspec = specs[gi][f"sub{i}"]
                axes = tp.cache_axes(tcfg, layer_specs[li], kv_dtype)
                assert set(axes) == set(jspec)
                for name, ax in axes.items():
                    j = _spec_axis(jspec[name])
                    assert ax == (None if j is None else j - 1), (li, name)
                li += 1
    for r in range(TP):
        got = tp.shard_cache(tcfg, full, r, TP, kv_dtype)
        want = _unstack_cache(tcfg, _map_jax(
            jcache, specs, lambda a, sp, path: _jax_cut(a, sp, path, r, TP)))
        local = model.init_cache(tcfg, n, s, device="cpu",
                                 kv_dtype=kv_dtype, world=TP)
        for gl, wl, ll in zip(got, want, local):
            assert set(gl) == set(wl) == set(ll)
            for name in gl:
                assert torch.equal(gl[name], wl[name]), name
                assert ll[name].shape == gl[name].shape, name


def _variants(cfg, name):
    """The config and widths that cannot shard at every tp."""
    out = [cfg, dataclasses.replace(cfg, d_model=cfg.d_model + 2)]
    if name != "xlstm-1.3b":
        out.append(dataclasses.replace(cfg, n_heads=3, n_kv_heads=3,
                                       head_dim=cfg.resolved_head_dim))
    if cfg.d_ff:
        out.append(dataclasses.replace(cfg, d_ff=cfg.d_ff + 1))
    if cfg.moe is not None:
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=3, shared_d_ff=cfg.moe.shared_d_ff + 1)))
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_validate_tp_matches_jax(name):
    """The same configs raise at the same tp, with the same message."""
    jcfg, tcfg = _cfgs(name)
    for jv, tv in zip(_variants(jcfg, name), _variants(tcfg, name)):
        for n in (1, 2, 3, 4):
            try:
                jax_tp.validate_tp(jv, n)
                want = None
            except ValueError as e:
                want = str(e)
            try:
                tp.validate_tp(tv, n)
                got = None
            except ValueError as e:
                got = str(e)
            assert got == want, (n, got, want)


@pytest.mark.parametrize("name", FAMILIES)
def test_collective_bytes_match_jax(name):
    jcfg, tcfg = _cfgs(name)
    for t in (1, 7, 64):
        for n in (1, 2, 4):
            for itemsize in (2, 4):
                assert tp.collective_bytes_per_iter(tcfg, t, n, itemsize) \
                    == jax_tp.collective_bytes_per_iter(jcfg, t, n, itemsize)


def test_helpers_outside_a_context_are_single_device():
    """tp = 1: no group, every helper the plain computation."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
    g = torch.ones(8)
    assert tp.active() is None and tp.world() == 1
    assert tp.psum(x) is x and tp.shard_block(x) is x
    assert torch.equal(tp.row_parallel(x, w), x @ w)
    from repro_torch.models.layers import rmsnorm
    assert torch.equal(tp.rmsnorm_sharded(x, g, 1e-5), rmsnorm(x, g, 1e-5))


def test_nccl_with_fewer_cards_than_ranks_raises():
    """No quiet fallback: nccl needs a card per rank, and nothing turns to
    gloo or to the CPU on its own."""
    with pytest.raises(RuntimeError, match="nccl"):
        mesh.spawn_tp(2, _torch_tp_ranks.helpers, device="cuda",
                      backend="nccl")
    with pytest.raises(RuntimeError, match="nccl"):
        mesh.spawn_tp(2, _torch_tp_ranks.helpers, device="cpu",
                      backend="nccl")


@pytest.fixture(scope="module")
def pair():
    return mesh.spawn_tp(TP, _torch_tp_ranks.helpers, device="cpu",
                         timeout_s=120)


@pytest.mark.parametrize("case", [
    "psum", "shard_block", "row_parallel", "row_parallel_n_odd",
    "row_parallel_uncovered", "out_project", "rmsnorm_sharded",
    "matmul_allreduce", "allgather_matmul", "matmul_reduce_scatter"])
def test_helpers_over_two_gloo_ranks(pair, case):
    assert pair[case] <= REL, (case, pair[case])


def test_group_errors_over_two_gloo_ranks(pair):
    """A wrong world size and a backend the group does not run raise
    RuntimeError naming them."""
    assert "process group of 4 ranks" in pair["errors"]["world"]
    assert "nccl" in pair["errors"]["backend"]
