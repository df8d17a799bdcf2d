"""The port's loss and gradients against the JAX package's, f32 on the CPU.

``repro_torch.models.model.loss_fn`` differentiated by the port's autograd
(through ``FlashAttentionFn`` and ``SwiGLUFn``, whose CPU path is the
plain forward and backward) against ``jax.value_and_grad`` of
``repro.models.model.loss_fn`` on the same weights (the JAX init,
converted with ``from_jax_params``) and the same batch: the loss, its
xent and aux, and every gradient leaf within max|a - b| / max|b| <= 1e-4
(the two sum in different orders).  MoE configs run dropless
(``capacity_factor`` 16) so that routing cannot flip.  The MoE FFN rounds
its f32 input to bf16 before the dispatch, as JAX does; where the two
packages' f32 activations (1e-6 apart) straddle a bf16 rounding boundary
an expert input differs by one bf16 ulp (2^-8 relative), in the forward
and in the gradient that flows back through that cast, so a whole model
with experts is held to 1e-2, as ``test_torch_moe.py`` holds its
forwards; the MoE FFN's own gradients on one input are held to 1e-4
(``test_moe_ffn_vjp_matches_jax``).  Then the remat
policies against ``none``, and the two backward kernels' plain versions
against ``jax.vjp`` of the JAX refs and against autograd of the port's
plain forwards.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import scale_down as jax_scale_down
from repro.kernels import ref as jax_ref
from repro.kernels import swiglu as jax_swiglu
from repro.models import model as jax_model
from repro_torch.configs import get_config, scale_down
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_bwd_ref,
                                                 flash_attention_lse_ref,
                                                 flash_attention_ref)
from repro_torch.kernels.swiglu import swiglu_bwd_ref, swiglu_ref
from repro_torch.models import model
from repro_torch.models.convert import from_jax_params
from repro_torch.training.optimizer import rebuild, tree_leaves

REL = 1e-4
REL_MOE = 1e-2     # one bf16 ulp of an expert input (module docstring)
FAMILIES = ("qwen3-8b", "arctic-480b", "deepseek-v2-236b",
            "jamba-1.5-large-398b", "xlstm-1.3b", "llava-next-34b",
            "musicgen-medium")
B, S = 2, 12


def _f32(cfg):
    cfg = dataclasses.replace(cfg, dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    return cfg


@functools.lru_cache(maxsize=None)
def models(name):
    """(jax cfg, torch cfg, jax params, torch params), f32 ``scale_down``
    (tiny-toy as it is)."""
    jcfg, tcfg = jax_get_config(name), get_config(name)
    if name != "tiny-toy":
        jcfg, tcfg = jax_scale_down(jcfg), scale_down(tcfg)
    jcfg, tcfg = _f32(jcfg), _f32(tcfg)
    jparams = jax_model.init(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _batch(cfg, seed=5):
    """{tokens, labels[, patches]} as numpy: labels are the next tokens
    with two masked (-1) positions; LLaVA also gets its patch prefix."""
    rng = np.random.default_rng(seed)
    shape = (B, S + 1) + ((cfg.num_codebooks,) if cfg.frontend == "audio"
                          else ())
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, 3] = -1
    batch["labels"][1, -1] = -1
    if cfg.frontend == "vision":
        batch["patches"] = rng.normal(
            size=(B, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _port_grads(cfg, params, batch, remat="none"):
    leaves = {path: p.detach().clone().requires_grad_(True)
              for path, p in tree_leaves(params)}
    tree = rebuild(params, leaves)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = model.loss_fn(cfg, tree, tb, remat=remat)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        dict(zip(leaves, grads))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_match_jax(name):
    jcfg, tcfg, jparams, tparams = models(name)
    batch = _batch(tcfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        functools.partial(jax_model.loss_fn, jcfg), has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    loss, metrics, grads = _port_grads(tcfg, tparams, batch)
    rel = REL if tcfg.moe is None else REL_MOE
    assert _rel(float(loss), float(jloss)) <= REL
    assert _rel(float(metrics["xent"]), float(jmet["xent"])) <= REL
    assert abs(float(metrics["aux"]) - float(jmet["aux"])) <= \
        REL * max(abs(float(jmet["aux"])), 1.0)
    want = from_jax_params(tcfg, jax.tree.map(np.asarray, jgrads),
                           device="cpu")
    want = dict(tree_leaves(want))
    assert set(want) == set(grads)
    worst = max((_rel(grads[k].numpy(), want[k].numpy()), k) for k in grads)
    assert worst[0] <= rel, worst


@pytest.mark.parametrize("name,dense_residual",
                         [("arctic-480b", True), ("deepseek-v2-236b", False),
                          ("jamba-1.5-large-398b", False)])
def test_moe_ffn_vjp_matches_jax(name, dense_residual):
    """The MoE FFN's gradients (input, router, experts, shared experts or
    dense residual) on one input and cotangent, against jax.vjp of the JAX
    ``moe_ffn``: the same bf16 roundings in the same places."""
    from repro.models import moe as jax_moe
    from repro_torch.models import moe
    jcfg, tcfg, jparams, tparams = models(name)
    layer = next(i for i, s in enumerate(tcfg.layer_specs())
                 if s.ffn != "dense" and s.ffn != "none")
    tp = tparams["layers"][layer]["ffn"]
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    ct = rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    jp = jax.tree.map(np.asarray, tree_like(tp))
    (_, jaux), vjp = jax.vjp(lambda x_, p_: jax_moe.moe_ffn(
        jcfg, p_, x_, dense_residual=dense_residual), jnp.asarray(x), jp)
    jgx, jgp = vjp((jnp.asarray(ct), jnp.ones((), jnp.float32)))
    tx = torch.from_numpy(x).requires_grad_(True)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in tree_leaves(tp)}
    y, aux = moe.moe_ffn(tcfg, rebuild(tp, leaves), tx,
                         dense_residual=dense_residual)
    got = torch.autograd.grad((y * torch.from_numpy(ct)).sum() + aux,
                              [tx] + list(leaves.values()))
    assert _rel(got[0].numpy(), jgx) <= REL
    want = dict(tree_leaves(jgp))
    for k, g in zip(leaves, got[1:]):
        assert _rel(g.numpy(), np.asarray(want[k])) <= REL, k


def tree_like(tree):
    """A port parameter subtree as the nested dicts of numpy arrays JAX
    takes."""
    if isinstance(tree, dict):
        return {k: tree_like(v) for k, v in tree.items()}
    return tree.detach().numpy()


@pytest.mark.parametrize("name", ["tiny-toy", "arctic-480b"])
@pytest.mark.parametrize("remat", ["full", "dots", "dots_no_batch"])
def test_remat_policies_give_the_same_grads(name, remat):
    """Recomputing a layer in the backward gives the gradients of
    ``remat="none"``: the same ops on the same inputs."""
    _, tcfg, _, tparams = models(name)
    batch = _batch(tcfg, seed=9)
    loss0, _, g0 = _port_grads(tcfg, tparams, batch)
    loss1, _, g1 = _port_grads(tcfg, tparams, batch, remat=remat)
    assert float(loss1) == float(loss0)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-7)


def test_remat_rejects_an_unknown_policy_and_states():
    _, tcfg, _, tparams = models("tiny-toy")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="remat"):
        model.forward_full(tcfg, tparams, toks, remat="some")
    with pytest.raises(ValueError, match="states"):
        model.forward_full(tcfg, tparams, toks, remat="full",
                           return_states=True)


# (B, S, H, KV, D, q_offset): groups 2, 3, 1, 9, 7 (the packed rows of
# groups 3, 7 and 9 leave a row of every 64 unused), offsets, two positions
FLASH = [(2, 13, 4, 2, 16, 0), (1, 9, 6, 2, 8, 3), (2, 7, 3, 3, 16, 0),
         (1, 15, 9, 1, 16, 0), (2, 10, 14, 2, 8, 5), (1, 12, 6, 2, 16, 7),
         (1, 2, 8, 1, 16, 0)]


def _flash_inputs(b, s, h, kv, d, seed=1):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=shape).astype(np.float32) for shape in
                   ((b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d)))
    return q, k, v, do


@pytest.mark.parametrize("case", FLASH, ids=str)
def test_flash_bwd_ref_matches_jax_vjp(case):
    b, s, h, kv, d, qo = case
    q, k, v, do = _flash_inputs(b, s, h, kv, d)
    out, vjp = jax.vjp(lambda q_, k_, v_: jax_ref.flash_attention_ref(
        q_, k_, v_, q_offset=qo), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    tout = flash_attention_ref(tq, tk, tv, q_offset=qo)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), atol=1e-5)
    lse = flash_attention_lse_ref(tq, tk, q_offset=qo)
    got = flash_attention_bwd_ref(tq, tk, tv, tout, lse, tdo, q_offset=qo)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= REL


@pytest.mark.parametrize("case", FLASH, ids=str)
def test_flash_function_matches_autograd_of_the_plain_forward(case):
    """``ops.flash_attention`` under grad (the Function, plain on the CPU)
    against autograd through ``flash_attention_ref``'s own ops."""
    b, s, h, kv, d, qo = case
    q, k, v, do = map(torch.from_numpy, _flash_inputs(b, s, h, kv, d, 2))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    out = ops.flash_attention(q, k, v, q_offset=qo)
    got = torch.autograd.grad(out, (q, k, v), do)
    out_plain = ops.flash_attention(q, k, v, q_offset=qo, impl="plain")
    want = torch.autograd.grad(out_plain, (q, k, v), do)
    assert torch.equal(out.detach(), out_plain.detach())
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w.numpy()) <= REL


def _swiglu_inputs(m=11, kd=24, n=40, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, kd)).astype(np.float32),
            (rng.normal(size=(kd, n)) / kd ** 0.5).astype(np.float32),
            (rng.normal(size=(kd, n)) / kd ** 0.5).astype(np.float32),
            rng.normal(size=(m, n)).astype(np.float32))


def test_swiglu_bwd_ref_matches_jax_vjp():
    """dg and du of the plain backward, taken through the weights' products
    (dx = dg w_g^T + du w_u^T, dw = x^T d), against jax.vjp of the JAX
    package's ``swiglu_ref``."""
    x, wg, wu, dh = _swiglu_inputs()
    _, vjp = jax.vjp(jax_swiglu.swiglu_ref, jnp.asarray(x), jnp.asarray(wg),
                     jnp.asarray(wu))
    want = vjp(jnp.asarray(dh))
    tx, twg, twu, tdh = map(torch.from_numpy, (x, wg, wu, dh))
    dg, du = swiglu_bwd_ref(tx, twg, twu, tdh)
    got = (dg @ twg.T + du @ twu.T, tx.T @ dg, tx.T @ du)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= REL


def test_swiglu_function_matches_autograd_of_the_plain_forward():
    x, wg, wu, dh = map(torch.from_numpy, _swiglu_inputs(seed=4))
    x, wg, wu = (t.requires_grad_(True) for t in (x, wg, wu))
    got = torch.autograd.grad(ops.swiglu(x, wg, wu), (x, wg, wu), dh)
    want = torch.autograd.grad(swiglu_ref(x, wg, wu), (x, wg, wu), dh)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w.numpy()) <= REL
