"""Shared by the port's serving-loop tests (``test_torch_async.py``,
``test_torch_spec_decode.py``, ``test_torch_sampling.py``): the same f32
model in both packages, and one engine run in either.

``models(name)`` gives (jax cfg, torch cfg, jax params, torch params):
the JAX ``model.init(cfg, PRNGKey(0))`` pytree and its conversion.  The
names are ``tiny-toy`` and ``hybrid``, the dense-FFN scale-down of
Jamba-1.5-Large that ``tests/test_torch_hybrid.py`` uses (7 Mamba layers
and one attention layer, no experts); each is built once a process."""
import dataclasses
import functools

import jax
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import scale_down as jax_scale_down
from repro.models import model as jax_model
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro.serving.request import Request as JaxRequest
from repro_torch.configs import FFN_DENSE, get_config, scale_down
from repro_torch.models import model as torch_model
from repro_torch.models.convert import from_jax_params
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.request import Request

JAMBA = "jamba-1.5-large-398b"


def _dense(cfg):
    pattern = tuple(dataclasses.replace(s, ffn=FFN_DENSE)
                    for s in cfg.block_pattern)
    return dataclasses.replace(cfg, moe=None, block_pattern=pattern)


@functools.lru_cache(maxsize=None)
def models(name: str):
    if name == "tiny-toy":
        jcfg, tcfg = jax_get_config(name), get_config(name)
    else:
        jcfg = _dense(jax_scale_down(jax_get_config(JAMBA)))
        tcfg = _dense(scale_down(get_config(JAMBA)))
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    tcfg = dataclasses.replace(tcfg, dtype="float32")
    jparams = jax_model.init(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def probe_eos(tcfg, tparams, prompt) -> int:
    """A token the model emits: the greedy continuation of ``prompt`` (by
    the port's eager forward, which compiles nothing), so a request with
    it as ``eos_id`` hits EOS at its first sample.  Callers assert that
    the JAX engine's output ends in it too."""
    logits, _ = torch_model.forward_full(
        tcfg, tparams, torch.tensor([list(prompt)], dtype=torch.int32))
    return int(torch.argmax(logits[0, -1]))


def run(jax_side: bool, cfg, params, prompts, *, max_new: int,
        eos_id=None, drafter=None, **config):
    """Serve ``prompts`` (rids 0..n-1) on the JAX engine or the port's (on
    the CPU); returns (engine, {rid: output tuple}).  ``drafter`` replaces
    the engine's drafter.  Every request must finish and nothing may stay
    in flight."""
    if jax_side:
        eng = JaxServeEngine(cfg, params, JaxEngineConfig(**config))
        req = JaxRequest
    else:
        eng = ServeEngine(cfg, params, EngineConfig(**config), device="cpu")
        req = Request
    if drafter is not None:
        eng.drafter = eng.scheduler.drafter = drafter
    for i, p in enumerate(prompts):
        eng.submit(req(rid=i, prompt=list(p), max_new_tokens=max_new,
                       eos_id=eos_id))
    done = eng.run()
    assert len(done) == len(prompts)
    assert eng.in_flight == 0
    return eng, {r.rid: tuple(r.output) for r in done}
