"""The port's training substrate against the JAX package's, on the CPU.

Data streams batch for batch; the warmup-cosine schedule and AdamW over
five steps with clipping on and off (rel 1e-6: both run the same f32
arithmetic, summing the global norm in other orders); ``make_train_step``
over three steps on f32 tiny-toy with ``grad_accum`` 1 and 2 (rel 1e-4 per
parameter leaf, as the gradients); the driver's crash/restart equal to an
uninterrupted run bit for bit; checkpoints (round trip, retention, restore
onto named devices, and each package reading the other's files); the int8
all-reduce with error feedback over four gloo ranks; and the train CLI.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.distributed import checkpoint as jax_ckpt
from repro.distributed import compression as jax_compression
from repro.models import model as jax_model
from repro.training import data as jax_data
from repro.training import optimizer as jax_opt
from repro.training import trainer as jax_trainer
from repro_torch.configs import get_config
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import compression
from repro_torch.launch import mesh
from repro_torch.launch import train as train_cli
from repro_torch.models.convert import from_jax_params
from repro_torch.training import data, optimizer
from repro_torch.training.trainer import (DriverConfig, TrainConfig, Trainer,
                                          batch_to_device, make_train_step)

import _torch_tp_ranks as ranks


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


@functools.lru_cache(maxsize=None)
def toy():
    """(jax cfg, torch cfg, jax params) of f32 tiny-toy."""
    jcfg = dataclasses.replace(jax_get_config("tiny-toy"), dtype="float32")
    tcfg = dataclasses.replace(get_config("tiny-toy"), dtype="float32")
    return jcfg, tcfg, jax_model.init(jcfg, jax.random.PRNGKey(0))


def _port(tree):
    return from_jax_params(toy()[1], jax.tree.map(np.asarray, tree),
                           device="cpu")


def _assert_trees(got, want_jax, rel):
    want = dict(optimizer.tree_leaves(_port(want_jax)))
    got = dict(optimizer.tree_leaves(got))
    assert set(got) == set(want)
    worst = max((_rel(got[k].numpy(), want[k].numpy()), k) for k in got)
    assert worst[0] <= rel, worst


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def test_synthetic_stream_matches_jax():
    for host in (0, 1):
        cfg = dict(batch=3, seq_len=10, vocab_size=97, seed=4, host_id=host,
                   n_hosts=2)
        mine = data.synthetic_stream(data.DataConfig(**cfg))
        theirs = jax_data.synthetic_stream(jax_data.DataConfig(**cfg))
        for _ in range(3):
            a, b = next(mine), next(theirs)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(a[k], b[k])
                assert a[k].dtype == np.int32


def test_memmap_stream_matches_jax_over_two_hosts(tmp_path):
    path = str(tmp_path / "corpus.bin")
    tokens = np.random.default_rng(0).integers(0, 5000, 2000)
    data.write_corpus(path, tokens)
    seen = []
    for host in (0, 1):
        cfg = dict(batch=4, seq_len=15, vocab_size=5000, path=path, seed=2,
                   host_id=host, n_hosts=2)
        mine = data.make_stream(data.DataConfig(**cfg))
        theirs = jax_data.make_stream(jax_data.DataConfig(**cfg))
        for _ in range(3):
            a, b = next(mine), next(theirs)
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            np.testing.assert_array_equal(a["labels"], b["labels"])
            np.testing.assert_array_equal(a["tokens"][:, 1:],
                                          a["labels"][:, :-1])
            seen.append({tuple(r) for r in a["tokens"]})
    # the hosts read disjoint windows
    assert not (set().union(*seen[:3]) & set().union(*seen[3:]))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def test_warmup_cosine_matches_jax():
    cfg = optimizer.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=11)
    jcfg = jax_opt.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=11)
    for step in range(0, 14):
        got = float(optimizer.warmup_cosine(cfg, torch.tensor(step)))
        want = float(jax_opt.warmup_cosine(jcfg, jnp.asarray(step)))
        assert _rel(got, want) <= 1e-6, step


@pytest.mark.parametrize("clip", [1e-3, 1e9], ids=["clipped", "unclipped"])
def test_adamw_five_steps_match_jax(clip):
    """Five updates with large lr and decay, so that the decayed leaves
    (every per-layer leaf, JAX's layers being stacked) show."""
    kw = dict(lr=1e-2, weight_decay=0.5, clip_norm=clip, warmup_steps=2,
              total_steps=5)
    jparams = toy()[2]
    jstate = jax_opt.adamw_init(jparams)
    params = _port(jparams)
    state = optimizer.adamw_init(params)
    rng = np.random.default_rng(1)
    for _ in range(5):
        jgrads = jax.tree.map(lambda p: jnp.asarray(
            rng.normal(size=p.shape).astype(np.float32)), jparams)
        jparams, jstate, jm = jax_opt.adamw_update(
            jax_opt.AdamWConfig(**kw), jparams, jgrads, jstate)
        params, state, m = optimizer.adamw_update(
            optimizer.AdamWConfig(**kw), params, _port(jgrads), state)
        assert _rel(float(m["grad_norm"]), float(jm["grad_norm"])) <= 1e-6
        assert _rel(float(m["lr"]), float(jm["lr"])) <= 1e-6
    assert int(state["step"]) == int(jstate["step"]) == 5
    assert state["step"].dtype == torch.int32
    _assert_trees(params, jparams, 1e-6)
    _assert_trees(state["mu"], jstate["mu"], 1e-6)
    _assert_trees(state["nu"], jstate["nu"], 1e-6)


def test_decay_follows_the_jax_layout():
    params = _port(toy()[2])
    rules = {path: optimizer.decays(path, p)
             for path, p in optimizer.tree_leaves(params)}
    assert rules[("embed",)] and not rules[("final_norm",)]
    assert rules[("layers", 0, "norm1")]          # (L, D) in JAX
    assert rules[("layers", 1, "mixer", "wq")]


def test_sgd_update_matches_jax():
    jparams = toy()[2]
    jgrads = jax.tree.map(jnp.ones_like, jparams)
    want = jax_opt.sgd_update(jparams, jgrads, 0.1)
    got = optimizer.sgd_update(_port(jparams), _port(jgrads), 0.1)
    _assert_trees(got, want, 1e-7)


# ---------------------------------------------------------------------------
# train step and driver
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_three_steps_match_jax(accum):
    """AdamW's eps is 1e-4 here: at the default 1e-8 an update is
    sign(g) · lr wherever |g| >> 1e-8, so a gradient element near 0 that
    the two packages' f32 sums put on opposite sides of 0 moves its weight
    by 2 lr (measured: one element of a wv leaf, 3.7e-3 of its largest
    weight).  The step's arithmetic is the same either way."""
    jcfg, tcfg, jparams = toy()
    opt = dict(lr=3e-3, warmup_steps=1, total_steps=3, eps=1e-4)
    jstep = jax.jit(jax_trainer.make_train_step(jcfg, jax_trainer.TrainConfig(
        grad_accum=accum, opt=jax_opt.AdamWConfig(**opt))))
    step = make_train_step(tcfg, TrainConfig(
        grad_accum=accum, opt=optimizer.AdamWConfig(**opt)))
    jstate = jax_opt.adamw_init(jparams)
    params = _port(jparams)
    state = optimizer.adamw_init(params)
    stream = data.synthetic_stream(data.DataConfig(
        batch=4, seq_len=16, vocab_size=tcfg.vocab_size, seed=3))
    for _ in range(3):
        batch = next(stream)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    jax.tree.map(jnp.asarray, batch))
        params, state, m = step(params, state,
                                batch_to_device(batch, torch.device("cpu")))
        for key in ("loss", "xent", "aux", "lr", "grad_norm"):
            assert abs(float(m[key]) - float(jm[key])) <= \
                1e-4 * max(abs(float(jm[key])), 1e-6), key
    _assert_trees(params, jparams, 1e-4)


def _train(tmp, name, steps, inject=None, params=None):
    cfg = get_config("tiny-toy")
    tc = TrainConfig(opt=optimizer.AdamWConfig(lr=1e-3, total_steps=steps,
                                               warmup_steps=2))
    dc = DriverConfig(steps=steps, ckpt_dir=str(tmp / name), ckpt_every=2,
                      inject_failure_at=inject)
    return Trainer(cfg, tc, dc, params=params, seed=1, device="cpu")


def _stream(skip=0):
    stream = data.synthetic_stream(data.DataConfig(
        batch=2, seq_len=16, vocab_size=get_config("tiny-toy").vocab_size,
        seed=3))
    for _ in range(skip):
        next(stream)
    return stream


def test_trainer_crash_restart_is_bitwise(tmp_path):
    """Injected failure at step 3 of 6, restart from the step-2 checkpoint
    (bf16 weights, f32 moments) == the uninterrupted run, bit for bit."""
    ref = _train(tmp_path, "ref", 6)
    out = ref.fit(_stream())
    assert out["final_step"] == 6
    tr = _train(tmp_path, "ft", 6, inject=3)
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        tr.fit(_stream())
    tr2 = _train(tmp_path, "ft", 6, inject=3)
    assert tr2.start_step == 2
    tr2.dc.inject_failure_at = None
    tr2.fit(_stream(skip=tr2.start_step))
    for (path, a), (_, b) in zip(
            optimizer.tree_leaves(ref._state()),
            optimizer.tree_leaves(tr2._state())):
        assert torch.equal(a, b), path
    assert ckpt.latest_step(str(tmp_path / "ft")) == 6


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_checkpoint_round_trip_and_named_devices(tmp_path):
    params = _train(tmp_path, "x", 1).params
    tree = {"params": params, "opt": optimizer.adamw_init(params)}
    ckpt.save(tree, str(tmp_path / "c"), 7)
    assert os.path.isfile(tmp_path / "c" / "step_00000007" / "METADATA.json")
    for devices in (None, torch.device("cpu"), "cpu",
                    optimizer.tree_map(lambda _: "cpu", tree)):
        back, step = ckpt.restore(str(tmp_path / "c"), tree, devices=devices)
        assert step == 7
        for (path, a), (_, b) in zip(optimizer.tree_leaves(tree),
                                     optimizer.tree_leaves(back)):
            assert a.dtype == b.dtype and a.device == b.device, path
            assert torch.equal(a, b), path


def test_checkpoint_retention_and_latest(tmp_path):
    tree = {"x": torch.ones(4)}
    for s in (10, 20, 30, 40):
        ckpt.save(tree, str(tmp_path), s)
    os.makedirs(tmp_path / "step_00000050.tmp")     # an unfinished save
    ckpt.retain(str(tmp_path), keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 40
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000030", "step_00000040", "step_00000050.tmp"]
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), tree, step=10)
    manager = ckpt.CheckpointManager(str(tmp_path / "m"), every=3, keep=1)
    assert manager.restore_or_none(tree) is None
    assert [manager.maybe_save(tree, s) for s in range(7)] == \
        [False, False, False, True, False, False, True]
    assert manager.restore_or_none(tree)[1] == 6


def _flat_numpy():
    rng = np.random.default_rng(3)
    return {"a": rng.normal(size=(3, 5)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(ml_dtypes.bfloat16),
            "n": np.int32(7),
            "l": [rng.integers(0, 9, (2, 2)).astype(np.int32)]}


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A flat tree of f32, bf16 and int32 leaves: JAX's save read by the
    port's restore, and the port's save read by JAX's restore."""
    flat = _flat_numpy()
    jax_ckpt.save(jax.tree.map(jnp.asarray, flat), str(tmp_path / "j"), 3)
    template = {"a": torch.zeros(3, 5), "b": torch.zeros(4,
                                                         dtype=torch.bfloat16),
                "n": torch.zeros((), dtype=torch.int32),
                "l": [torch.zeros(2, 2, dtype=torch.int32)]}
    back, step = ckpt.restore(str(tmp_path / "j"), template)
    assert step == 3 and back["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["a"].numpy(), flat["a"])
    np.testing.assert_array_equal(
        back["b"].view(torch.int16).numpy().view(np.uint16),
        flat["b"].view(np.uint16))
    assert int(back["n"]) == 7 and back["n"].dtype == torch.int32
    np.testing.assert_array_equal(back["l"][0].numpy(), flat["l"][0])

    ckpt.save(back, str(tmp_path / "t"), 4)
    jback, jstep = jax_ckpt.restore(str(tmp_path / "t"),
                                    jax.tree.map(jnp.asarray, flat))
    assert jstep == 4
    for k in ("a", "b", "n"):
        assert np.asarray(jback[k]).dtype == np.asarray(flat[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(jback[k]), flat[k])
    np.testing.assert_array_equal(np.asarray(jback["l"][0]), flat["l"][0])


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------
def test_quantize_matches_jax():
    rng = np.random.default_rng(5)
    for x in (rng.normal(size=(64,)).astype(np.float32) * 3,
              np.float32([0.5, -0.5, 1.5, 2.5, -127.4, 0.0])):
        q, s = compression._quantize(torch.from_numpy(x))
        jq, js = jax_compression._quantize(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert q.dtype == torch.int8
        assert float(s) == float(js)


def test_compressed_all_reduce_over_four_gloo_ranks():
    """Four ranks, rank r holding row r of a (4, 64) gradient, eight
    exchanges: each step's mean equals JAX's compressed_psum arithmetic
    (JAX's _quantize of each rank's row plus residual, the dequantized
    rows summed), and the accumulated means track the true mean within
    0.05, as JAX's test holds its own."""
    g = np.random.default_rng(0).normal(size=(4, 64)).astype(np.float32)
    res = mesh.spawn_tp(4, ranks.compressed_steps, g, 8, device="cpu")
    np.testing.assert_allclose(res["plain"], g.mean(axis=0), atol=1e-6)
    jres = np.zeros_like(g)
    acc_c, acc_t = 0.0, 0.0
    for out in res["outs"]:
        x = g + jres
        deq = np.stack([np.asarray(q, np.float32) * float(s) for q, s in
                        (jax_compression._quantize(jnp.asarray(r))
                         for r in x)])
        jres = x - deq
        np.testing.assert_allclose(out, deq.sum(axis=0) / 4, atol=1e-6)
        acc_c += out
        acc_t += g.mean(axis=0)
    np.testing.assert_allclose(np.stack(res["res"]), jres, atol=1e-6)
    err = np.abs(acc_c - acc_t).max() / (np.abs(acc_t).max() + 1e-9)
    assert err < 0.05, err


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def test_train_cli_runs_crashes_and_restarts(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    argv = ["--arch", "tiny-toy", "--steps", "6", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-every", "2"]
    train_cli.main(argv + ["--ckpt-dir", str(tmp_path / "plain")])
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("done at step 6 (")
    assert out[0].startswith("step     6  loss ")
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        train_cli.main(argv + ["--ckpt-dir", ck, "--inject-failure", "3"])
    assert ckpt.latest_step(ck) == 2
    train_cli.main(argv + ["--ckpt-dir", ck])     # restores, then finishes
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("done at step 6 (")
    assert ckpt.latest_step(ck) == 6
