"""The port's engine on the models of ``tests/test_torch_moe.py`` against
the JAX engine, greedy, f32, on the CPU.

Arctic (its MoE FFN beside the dense residual) on the packed and legacy
steps and with recompute prefill, Jamba with its MoE layers on the packed step, and the two dense
configurations the port added with it, LLaMA-2-70B and Qwen3-4B, on the
packed step; all at ``scale_down`` widths.  The MoE configs run at
``capacity_factor`` 16, as every JAX engine test does: the packed step,
decode and recompute cut the dispatch groups differently (t = T, B or
B·S), so at the published 1.25 the steps may drop different (token,
expert) pairs.  Same weights (the JAX pytree converted), same requests
(slots reused): the outputs must be identical, with equal iteration,
dispatch, sync and prefill-work counts.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import dataclasses

import jax
import numpy as np
import pytest

from _torch_serving import run
from test_torch_moe import MODELS, _both
from repro.models import model as jax_model
from repro_torch.models.convert import from_jax_params

ENGINE = dict(max_slots=2, max_len=48, discrete_sizes=(16, 8),
              avg_decode_len=4)
CASES = {"arctic-packed": ("arctic-g7", dict(step_mode="packed",
                                             async_depth=0)),
         "arctic-legacy": ("arctic-g7", dict(step_mode="legacy")),
         "arctic-recompute": ("arctic-g7", dict(prefill_mode="recompute")),
         "jamba-moe-packed": ("jamba-moe", dict(step_mode="packed",
                                                async_depth=0)),
         "llama2-70b-packed": ("llama2-70b", dict(step_mode="packed",
                                                  async_depth=0)),
         "qwen3-4b-packed": ("qwen3-4b", dict(step_mode="packed",
                                              async_depth=0))}


def _engine_models(key):
    """``tests/test_torch_moe.py``'s model ``key`` with no (token, expert)
    pair dropped."""
    name, kw = MODELS[key]
    jcfg, tcfg = _both(name, **kw)
    if tcfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=16.0))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=16.0))
    jparams = jax_model.init(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_token_exact_vs_jax(case):
    """5 requests of 3-11 prompt tokens on 2 slots, 3 new tokens each."""
    key, mode = CASES[case]
    jcfg, tcfg, jparams, tparams = _engine_models(key)
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(0, tcfg.vocab_size,
                                             size=int(rng.integers(3, 12)))]
               for _ in range(5)]
    jeng, want = run(True, jcfg, jparams, prompts, max_new=3, **ENGINE,
                     **mode)
    teng, got = run(False, tcfg, tparams, prompts, max_new=3, **ENGINE,
                    **mode)
    assert got == want
    assert teng.step_mode == jeng.step_mode == mode.get("step_mode",
                                                         "legacy")
    j, t = jeng.stats, teng.stats
    for field in ("iterations", "model_dispatches", "host_syncs",
                  "prefill_model_tokens", "prefill_tokens", "decode_tokens"):
        assert getattr(t, field) == getattr(j, field) > 0, field
    if teng.step_mode == "packed":
        assert t.dispatches_per_iter == 1.0 and t.syncs_per_iter == 1.0
    else:
        assert t.dispatches_per_iter > 1.0
