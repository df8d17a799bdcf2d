"""AdamW, SGD, global-norm clipping and the warmup-cosine schedule (port of
``repro.training.optimizer``) over the port's parameter tree: nested dicts
and lists of tensors, ``params["layers"]`` a list of per-layer dicts.

JAX's arithmetic is kept: f32 moments ``mu`` and ``nu``, an int32
``step``, bias correction from the step, the update taken in f32 and
written back in the parameter's dtype.  The JAX package stacks each
group's layers (``scan`` over layers), so a per-layer vector such as a
norm's weight is 2-D there and its ``ndim >= 2`` rule decays it; the port
decays the same leaves (``decays``), so that its trajectory is JAX's.
Plain tensor code on every device: JAX has no kernel here.  Every
function returns new tensors and leaves its inputs as they were.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def tree_leaves(tree: Any, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs of a tree of dicts (keys sorted, as JAX flattens
    them), lists and tuples; a path holds dict keys and list indices."""
    if isinstance(tree, dict):
        return [pl for key in sorted(tree)
                for pl in tree_leaves(tree[key], path + (key,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, item in enumerate(tree)
                for pl in tree_leaves(item, path + (i,))]
    return [(path, tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the congruent ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def decays(path: tuple, p: torch.Tensor) -> bool:
    """Whether weight decay applies: the leaf has ndim >= 2 in the JAX
    layout, where every per-layer leaf carries the stacked layer axis."""
    stacked = 1 if path and path[0] == "layers" else 0
    return p.dim() + stacked >= 2


def warmup_cosine(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio * cfg.lr + (1 - cfg.min_lr_ratio) * cfg.lr \
        * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: Any) -> dict:
    """Zero f32 moments congruent with ``params`` and an int32 step 0, on
    the parameters' device."""
    leaves = tree_leaves(params)
    dev = leaves[0][1].device if leaves else torch.device("cpu")
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.float())) for _, g in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def clip_by_global_norm(grads: Any, max_norm: float):
    """(grads scaled so that their global norm is at most ``max_norm``,
    the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def adamw_update(cfg: AdamWConfig, params: Any, grads: Any, state: dict):
    """Returns (new_params, new_state, metrics {lr, grad_norm})."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = warmup_cosine(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf

    def upd(path, p, g, mu, nu):
        g32 = g.float()
        mu = cfg.b1 * mu + (1 - cfg.b1) * g32
        nu = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g32)
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        if cfg.weight_decay and decays(path, p):
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), mu, nu

    out = {path: upd(path, p, g, mu, nu) for (path, p), (_, g), (_, mu), (_, nu)
           in zip(tree_leaves(params), tree_leaves(grads),
                  tree_leaves(state["mu"]), tree_leaves(state["nu"]))}
    pick = lambda i: rebuild(params, {k: v[i] for k, v in out.items()})
    return (pick(0), {"mu": pick(1), "nu": pick(2), "step": step},
            {"lr": lr, "grad_norm": gnorm})


def sgd_update(params: Any, grads: Any, lr: float) -> Any:
    return tree_map(lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
                    params, grads)


def rebuild(template: Any, by_path: dict, path: tuple = ()) -> Any:
    """``template``'s structure with the leaf at each path replaced by
    ``by_path[path]`` (paths as ``tree_leaves`` gives them)."""
    if isinstance(template, dict):
        return {k: rebuild(v, by_path, path + (k,))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [rebuild(v, by_path, path + (i,))
               for i, v in enumerate(template)]
        return type(template)(out) if isinstance(template, tuple) else out
    return by_path[path]
