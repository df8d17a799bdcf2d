"""The train step and the fault-tolerant training driver (port of
``repro.training.trainer``): gradient accumulation, remat, AdamW, and the
driver's checkpoint/restart, failure injection and straggler-aware
shares.

Gradients come from autograd through ``models.model.loss_fn``: on the card
the flash-attention and SwiGLU kernels and their backward kernels
(``kernels.ops``), the other ops as PyTorch differentiates them.  A model
whose path reaches a kernel without a backward (the selective scan, MLA's
latent attention) raises on the card (ROADMAP A14).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.elastic import StragglerMitigator
from repro_torch.models import model as model_lib
from repro_torch.training import optimizer as opt_lib


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    remat: str = "none"              # none | full | dots | dots_no_batch
    grad_accum: int = 1
    aux_weight: float = 0.01
    opt: opt_lib.AdamWConfig = dataclasses.field(
        default_factory=opt_lib.AdamWConfig)


def make_train_step(cfg: ModelConfig, tc: TrainConfig) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), as
    JAX's: ``metrics`` holds loss, xent, aux, lr and grad_norm (0-dim
    tensors).  ``batch`` is a dict of tensors on the params' device.  With
    ``grad_accum`` a > 1 the batch splits into a micro-batches along axis
    0, whose gradients are summed in f32 and divided by a (the metrics'
    xent is then the mean loss and aux 0, as in JAX)."""

    def grads_of(params, batch):
        leaves = opt_lib.tree_leaves(params)
        live = {path: p.detach().requires_grad_(True) for path, p in leaves}
        tree = opt_lib.rebuild(params, live)
        loss, metrics = model_lib.loss_fn(cfg, tree, batch, remat=tc.remat,
                                          aux_weight=tc.aux_weight)
        grads = torch.autograd.grad(loss, list(live.values()))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            dict(zip(live, grads))

    def grads_accum(params, batch):
        a = tc.grad_accum
        if a <= 1:
            loss, metrics, grads = grads_of(params, batch)
            return loss, metrics, opt_lib.rebuild(params, grads)
        micro = [{k: v.reshape((a, v.shape[0] // a) + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()} for i in range(a)]
        gsum, loss_sum = None, 0.0
        for mb in micro:
            loss, _, grads = grads_of(params, mb)
            grads = {k: g.float() for k, g in grads.items()}
            gsum = grads if gsum is None else \
                {k: gsum[k] + grads[k] for k in gsum}
            loss_sum = loss_sum + loss
        grads = opt_lib.rebuild(params, {k: g / a for k, g in gsum.items()})
        loss = loss_sum / a
        return loss, {"xent": loss, "aux": torch.zeros(
            (), dtype=torch.float32, device=loss.device)}, grads

    def train_step(params, opt_state, batch):
        loss, metrics, grads = grads_accum(params, batch)
        params, opt_state, opt_metrics = opt_lib.adamw_update(
            tc.opt, params, grads, opt_state)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """A stream's numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# fault-tolerant driver
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DriverConfig:
    steps: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 20
    keep: int = 2
    log_every: int = 10
    inject_failure_at: Optional[int] = None     # simulate a crash at step N
    n_sim_hosts: int = 4                        # straggler simulation


class Trainer:
    """Checkpoint/restart training loop.

    Failure model: ``inject_failure_at`` raises mid-run; calling ``fit``
    again (or building a new Trainer on the same ``ckpt_dir``) restores
    from the last committed checkpoint and continues — the final params
    equal an uninterrupted run's bit for bit when the data order is the
    same (the kernels are deterministic).  ``params=None`` draws
    ``model.init(cfg, seed, device)``; the run is on ``cuda`` unless
    ``device`` names another."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, dc: DriverConfig,
                 params=None, seed: int = 0, device=None):
        self.cfg, self.tc, self.dc = cfg, tc, dc
        self.device = resolve_device(device)
        self.step_fn = make_train_step(cfg, tc)
        self.ckpt = CheckpointManager(dc.ckpt_dir, every=dc.ckpt_every,
                                      keep=dc.keep)
        self.params = params if params is not None \
            else model_lib.init(cfg, seed, self.device)
        self.opt_state = opt_lib.adamw_init(self.params)
        self.start_step = 0
        self.straggler = StragglerMitigator(dc.n_sim_hosts)
        restored = self.ckpt.restore_or_none(
            {"params": self.params, "opt": self.opt_state},
            devices=self.device)
        if restored is not None:
            tree, step = restored
            self.params, self.opt_state = tree["params"], tree["opt"]
            self.start_step = step
        self._failed = False

    def _state(self) -> dict:
        return {"params": self.params, "opt": self.opt_state}

    def fit(self, stream: Iterator[dict],
            step_time_cb: Optional[Callable] = None) -> dict:
        """Runs steps from ``start_step`` to ``dc.steps``, taking one batch
        of ``stream`` per step.  Returns {"history": [{step, loss,
        grad_norm, sec}, ...] every ``log_every`` steps and at the last,
        "final_step"}.  ``step_time_cb(sec)`` gives the simulated hosts'
        step times for the straggler mitigator."""
        history = []
        step = self.start_step
        saved = False       # whether the state at ``step`` is on disk
        while step < self.dc.steps:
            batch = next(stream)
            t0 = time.perf_counter()
            if self.dc.inject_failure_at is not None \
                    and step == self.dc.inject_failure_at and not self._failed:
                self._failed = True
                raise RuntimeError(f"injected failure at step {step}")
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state,
                batch_to_device(batch, self.device))
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            dt = time.perf_counter() - t0
            step += 1
            saved = self.ckpt.maybe_save(self._state(), step)
            if step_time_cb is not None:
                self.straggler.observe(step_time_cb(dt))
            if step % self.dc.log_every == 0 or step == self.dc.steps:
                history.append({"step": step, "loss": loss,
                                "grad_norm": gnorm, "sec": dt})
        if not saved:       # JAX saves the last step a second time
            self.ckpt.maybe_save(self._state(), step, force=True)
        self.start_step = step
        return {"history": history, "final_step": step}
