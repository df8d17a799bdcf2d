"""Tensor-parallel runtime for the packed serving step (port of
``repro.distributed.tp``; DESIGN.md §11).

tp = N runs as N SPMD ranks of a ``torch.distributed`` group
(``launch.mesh``).  Every rank runs the same host loop on replicated
inputs and holds its shard of the weights and of the KV / state cache;
the model code names its few reduction points by calling the helpers
here.  Outside a TP context (``tp_ctx``) every helper is the exact
single-device computation, so tp = 1 is the unsharded code path and needs
no group.  The context is thread-local, as JAX's, so the model functions
keep their signatures.

Layout (one shard axis per leaf; the table of DESIGN.md §11), in the
port's per-layer (unstacked) parameter and cache layouts:

  * GQA      — q/k/v/o projections and the K/V slot cache sharded along
               (kv-)heads; attention is per-head local; the output
               projection is row-parallel.
  * MLA      — the latent path (``c_kv``/``k_rope`` cache and their
               projections) is replicated; the absorbed per-head
               projections (``wuq``/``wuk``/``wuv``/``wo``) are sharded
               along heads; output projection row-parallel.
  * Mamba    — the inner width ``d_in`` is sharded (contiguous channel
               blocks); dt/B/C come from a row-parallel projection (a
               psum); ``w_out`` row-parallel.
  * mLSTM    — sharded along heads (= contiguous ``d_in`` blocks); the
               (C, n, m) memory is head-sharded; the i/f gates are psum'd
               then cut back to the local heads; the out-norm reduces over
               the full width; ``w_down`` row-parallel.
  * sLSTM    — the recurrence runs replicated; only the GLU FFN after it
               is column/row-parallel.
  * MoE      — experts sharded; routing replicated; each rank combines its
               local experts and the combine is psum'd.  Shared and
               dense-residual FFNs are column/row-parallel.
  * embed / head / norms / router / sampled tokens — replicated.

Fused projections whose columns are later split in half (Mamba ``w_in``
and mLSTM ``w_up``: x‖z; sLSTM ``w_ffn_up``: u‖g) are cut so that each
rank's block holds the matching halves (JAX re-interleaves the columns,
then cuts contiguously: the same shard).

Every reduction sums in f32 and casts back to the activations' dtype.
``row_parallel`` issues one all-reduce per nano-batch group of the packed
stream, each asynchronous, so that group i's all-reduce runs beside group
i + 1's GEMM (paper §4.3); JAX expresses the same freedom as ring
collective matmuls per group.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import (ATTN, FFN_DENSE, FFN_MOE,
                                      FFN_MOE_DENSE, MAMBA, MLSTM, SLSTM,
                                      LayerSpec, ModelConfig)
from repro_torch.distributed.collective_matmul import (
    matmul_allreduce, matmul_allreduce_start)
from repro_torch.models.layers import rmsnorm

# ---------------------------------------------------------------------------
# context
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TPContext:
    group: Any                      # the torch.distributed process group
    rank: int
    size: int
    nano: tuple[int, ...] = ()      # nano-batch split of the packed T axis


class _State(threading.local):
    ctx: Optional[TPContext] = None


_STATE = _State()


@contextlib.contextmanager
def tp_ctx(group, nano: tuple[int, ...] = ()):
    """Activate the TP helpers over ``group`` for the body (the packed
    step's forward).  ``group=None`` deactivates: the helpers become the
    single-device computation."""
    prev = _STATE.ctx
    _STATE.ctx = None if group is None else TPContext(
        group, dist.get_rank(group), dist.get_world_size(group),
        tuple(nano))
    try:
        yield
    finally:
        _STATE.ctx = prev


def active() -> Optional[TPContext]:
    return _STATE.ctx


def world() -> int:
    return _STATE.ctx.size if _STATE.ctx is not None else 1


# ---------------------------------------------------------------------------
# collective helpers (the single-device computation outside a TP context)
# ---------------------------------------------------------------------------
def psum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the group, taken in f32, in x's dtype."""
    ctx = _STATE.ctx
    if ctx is None:
        return x
    s = x.to(torch.float32, copy=True)
    dist.all_reduce(s, group=ctx.group)
    return s.to(x.dtype)


def shard_block(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """This rank's contiguous block of a replicated full tensor along
    ``axis`` (the psum'd mLSTM gates cut back to the local heads)."""
    ctx = _STATE.ctx
    if ctx is None:
        return x
    blk = x.shape[axis] // ctx.size
    return x.narrow(axis, ctx.rank * blk, blk)


def row_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., k_local) @ w (k_local, n)`` summed over the group.

    Under TP the rows of the flattened x are cut by the nano-batch split
    (when it covers them; else one group): each group's f32 partial GEMM
    is enqueued and its all-reduce issued asynchronously before the next
    group's GEMM, then all are waited for, concatenated and cast.  Outside
    a TP context this is ``torch.matmul``."""
    ctx = _STATE.ctx
    if ctx is None:
        return torch.matmul(x, w)
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    m = xf.shape[0]
    if w.shape[-1] % ctx.size:
        # JAX's ring reduce-scatter needs n % p == 0 and falls back to a
        # plain psum; the port keeps the same split rule
        sizes = (m,)
    else:
        sizes = ctx.nano if (len(ctx.nano) > 1 and sum(ctx.nano) == m) \
            else (m,)
    if len(sizes) == 1:
        return matmul_allreduce(xf, w, ctx.group).reshape(*lead, w.shape[-1])
    parts, start = [], 0
    for s in sizes:
        parts.append(matmul_allreduce_start(xf[start:start + s], w,
                                            ctx.group))
        start += s
    for _, work in parts:
        work.wait()
    y = torch.cat([p for p, _ in parts])
    return y.to(x.dtype).reshape(*lead, w.shape[-1])


def out_project(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """Attention output projection ``(..., h, k), (h, k, d) -> (..., d)``
    as one GEMM over the flattened heads: row-parallel over the
    head-sharded contraction under TP."""
    lead = out.shape[:-2]
    return row_parallel(out.reshape(*lead, -1), wo.reshape(-1, wo.shape[-1]))


def rmsnorm_sharded(x: torch.Tensor, weight: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """RMSNorm over a last axis that is TP-sharded: the mean square is
    summed over the full width (psum); ``weight`` is the local shard.
    Outside a TP context this is exactly ``models.layers.rmsnorm``."""
    ctx = _STATE.ctx
    if ctx is None:
        return rmsnorm(x, weight, eps)
    x32 = x.float()
    ss = psum(x32.square().sum(dim=-1, keepdim=True))
    var = ss / (x.shape[-1] * ctx.size)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight


# ---------------------------------------------------------------------------
# layout: which axis of each leaf is cut, as functions of (rank, world)
# ---------------------------------------------------------------------------
# the shard axis of each mixer's leaves, by mixer kind (absent: replicated)
_GQA = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
_MLA = {"wuq": 1, "wuk": 1, "wuv": 1, "wo": 0}
_MIXER_AXES = {
    MAMBA: {"w_in": 1, "conv_w": 0, "conv_b": 0, "w_x": 0, "w_dt": 1,
            "dt_bias": 0, "a_log": 0, "d_skip": 0, "w_out": 0},
    # q/k/v are per-head block-diagonal: whole heads go to a rank; the
    # gate inputs' rows are local and their full-H outputs psum'd
    MLSTM: {"w_up": 1, "conv_w": 0, "conv_b": 0, "w_q": 0, "w_k": 0,
            "w_v": 0, "w_i": 0, "w_f": 0, "out_norm": 0, "w_down": 0},
    SLSTM: {"w_ffn_up": 1, "w_ffn_down": 0},
}
_FFN = {"w_up": 1, "w_gate": 1, "w_down": 0}        # column / row parallel
_EXPERTS = {"w_gate": 0, "w_up": 0, "w_down": 0}    # the router replicated


def needs_half_interleave(path: tuple[str, ...]) -> bool:
    """Fused projections whose output columns are later split in half:
    Mamba ``w_in`` / mLSTM ``w_up`` (x‖z) and sLSTM ``w_ffn_up`` (u‖g).
    (The FFN's ``w_up`` is not fused.)"""
    return (path[-1] == "w_ffn_up"
            or (path[-1] in ("w_in", "w_up") and "mixer" in path))


def param_axis(cfg: ModelConfig, path: tuple[str, ...]) -> Optional[int]:
    """The shard axis of the parameter leaf at ``path`` in the port's
    layout (``("layers", "3", "mixer", "wq")``, ...), or None when it is
    replicated (everything outside the layers)."""
    if path[0] != "layers" or len(path) < 4:
        return None
    spec: LayerSpec = cfg.layer_specs()[int(path[1])]
    part, name = path[2], path[-1]
    if part == "mixer":
        if spec.mixer == ATTN:
            return (_MLA if cfg.mla is not None else _GQA).get(name)
        return _MIXER_AXES[spec.mixer].get(name)
    if part == "ffn":
        if spec.ffn == FFN_DENSE or path[3] in ("shared", "dense"):
            return _FFN.get(name)
        return _EXPERTS.get(name)
    return None


def cut(full: torch.Tensor, axis: Optional[int], rank: int, world: int,
        interleave: bool = False) -> torch.Tensor:
    """Rank ``rank``'s shard of ``full`` along ``axis`` (a copy, so the
    full tensor can be freed; ``full`` itself when replicated).  With
    ``interleave`` the last axis is two fused halves, and the shard is the
    rank's block of each half, side by side."""
    if axis is None or world == 1:
        return full
    if interleave:
        c = full.shape[-1] // 2
        blk = c // world
        return torch.cat([full[..., rank * blk:(rank + 1) * blk],
                          full[..., c + rank * blk:c + (rank + 1) * blk]],
                         dim=-1)
    blk = full.shape[axis] // world
    return full.narrow(axis, rank * blk, blk).clone()


def cut_param(cfg: ModelConfig, path: tuple[str, ...], full: torch.Tensor,
              rank: int, world: int) -> torch.Tensor:
    """The rank's shard of one parameter leaf (``model.init`` cuts each
    leaf as it is drawn)."""
    return cut(full, param_axis(cfg, path), rank, world,
               needs_half_interleave(path))


def shard_params(cfg: ModelConfig, params: dict, rank: int,
                 world: int) -> dict:
    """Cut a parameter tree to the rank's shard.  A leaf that already has
    its shard's shape is kept, so params drawn sharded pass through; any
    other shape raises."""
    from repro_torch.models.model import model_defs
    from repro_torch.models.param import map_defs

    def leaf(path, d):
        t = _get(params, path)
        axis = param_axis(cfg, path)
        if tuple(t.shape) == tuple(d.shape):
            return cut(t, axis, rank, world, needs_half_interleave(path))
        local = list(d.shape)
        if axis is not None:
            local[axis] //= world
        if tuple(t.shape) != tuple(local):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)} is "
                             f"neither {d.shape} nor its shard {local}")
        return t
    return map_defs(leaf, model_defs(cfg))


def _get(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def cache_axes(cfg: ModelConfig, spec: LayerSpec,
               kv_dtype: Optional[str] = None) -> dict:
    """The shard axis of each cache leaf of a layer (None: replicated), in
    the port's per-layer layout: GQA's K/V (N, S, KV, hd) and their int8
    scales (N, S, KV) on the kv-head axis; MLA's latent and its scales
    replicated; Mamba's conv (N, K-1, d_in) and ssm (N, d_in, n) on
    ``d_in``; the mLSTM's conv on ``d_in`` and c, n, m on heads; the sLSTM
    replicated."""
    if spec.mixer == ATTN:
        if cfg.mla is not None:
            names = ("c_kv", "k_rope")
            axis = None
        else:
            names, axis = ("k", "v"), 2
        out = dict.fromkeys(names, axis)
        if kv_dtype == "int8":
            out.update(dict.fromkeys((f"{n}_s" for n in names), axis))
        return out
    if spec.mixer == MAMBA:
        return {"conv": 2, "ssm": 1}
    if spec.mixer == MLSTM:
        return {"conv": 2, "c": 1, "n": 1, "m": 1}
    if spec.mixer == SLSTM:
        return dict.fromkeys(("conv", "c", "n", "h", "m"))
    raise ValueError(spec.mixer)


def shard_cache(cfg: ModelConfig, cache: list, rank: int, world: int,
                kv_dtype: Optional[str] = None) -> list:
    """Cut a full per-layer cache to the rank's shard (copies)."""
    return [{name: cut(leaf, cache_axes(cfg, spec, kv_dtype)[name], rank,
                       world)
             for name, leaf in layer.items()}
            for spec, layer in zip(cfg.layer_specs(), cache)]


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------
def validate_tp(cfg: ModelConfig, tp: int) -> None:
    """The layout shards whole heads / channel blocks / experts: every
    sharded width must divide by ``tp`` (JAX's messages)."""
    errs = []

    def div(n, v, what):
        if v % n:
            errs.append(f"{what}={v} not divisible by tp={n}")

    div(tp, cfg.d_model, "d_model")
    for spec in set(cfg.layer_specs()):
        if spec.mixer == ATTN:
            div(tp, cfg.n_heads, "n_heads")
            if cfg.mla is None:
                div(tp, cfg.n_kv_heads, "n_kv_heads")
        elif spec.mixer == MAMBA:
            from repro_torch.models.ssm import _dims
            d_in, _, _ = _dims(cfg)
            div(tp, d_in, "mamba d_in")
        elif spec.mixer == MLSTM:
            from repro_torch.models.xlstm import _mlstm_dims
            d_in, h, _ = _mlstm_dims(cfg)
            div(tp, h, "mlstm heads")
            div(tp, d_in, "mlstm d_in")
        elif spec.mixer == SLSTM:
            div(tp, cfg.d_model, "slstm d_model")
        if spec.ffn == FFN_DENSE:
            div(tp, cfg.d_ff, "d_ff")
        elif spec.ffn in (FFN_MOE, FFN_MOE_DENSE):
            m = cfg.moe
            div(tp, m.num_experts, "num_experts")
            if m.num_shared_experts:
                div(tp, m.shared_d_ff, "shared_d_ff")
            if spec.ffn == FFN_MOE_DENSE:
                div(tp, cfg.d_ff, "d_ff (dense residual)")
    if errs:
        raise ValueError(f"config {cfg.name!r} cannot shard at tp={tp}: "
                         + "; ".join(errs))


# ---------------------------------------------------------------------------
# collective-traffic model
# ---------------------------------------------------------------------------
def collective_bytes_per_iter(cfg: ModelConfig, t: int, tp: int,
                              itemsize: int) -> int:
    """JAX's wire-byte model of one packed iteration's TP collectives: each
    all-reduce moves ~``2(p-1)/p × payload`` per rank (ring), counting the
    output projections, the MoE combine, the Mamba dt/B/C psum and the
    mLSTM gate and norm psums.  A model, not a measurement."""
    if tp <= 1:
        return 0
    d = cfg.d_model
    payload = 0
    for spec in cfg.layer_specs():
        if spec.mixer == ATTN:
            payload += t * d                       # wo all-reduce
        elif spec.mixer == MAMBA:
            from repro_torch.models.ssm import _dims
            _, dt_rank, n = _dims(cfg)
            payload += t * d + t * (dt_rank + 2 * n)   # w_out + dt/B/C
        elif spec.mixer == MLSTM:
            payload += t * d + t * (2 * cfg.n_heads + 1)  # w_down + gates
        elif spec.mixer == SLSTM:
            payload += t * d                       # w_ffn_down
        if spec.ffn == FFN_DENSE:
            payload += t * d
        elif spec.ffn in (FFN_MOE, FFN_MOE_DENSE):
            payload += t * d                       # combine psum
            if cfg.moe.num_shared_experts:
                payload += t * d
            if spec.ffn == FFN_MOE_DENSE:
                payload += t * d
    return int(2 * (tp - 1) / tp * payload * itemsize)
