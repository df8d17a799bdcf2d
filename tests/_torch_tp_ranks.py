"""Rank functions of the port's tensor-parallel tests
(``test_torch_tp.py``, ``test_torch_tp_engine.py``), run on every rank of
a spawned gloo group by ``repro_torch.launch.mesh.spawn_tp``.  A spawned
rank imports this module by name, so it imports only torch and the port
(never JAX): the tests compute the JAX side in their own process and hand
the ranks numpy weights."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import collective_matmul as cm
from repro_torch.distributed import tp
from repro_torch.launch import mesh, serve
from repro_torch.models import model
from repro_torch.models.convert import from_jax_params
from repro_torch.models.layers import rmsnorm
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import ServeEngine


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, the worst over the ranks."""
    err = torch.tensor([float((got - want).abs().max()
                              / want.abs().max().clamp(min=1e-30))])
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    return float(err)


def helpers() -> dict:
    """Each helper and collective matmul under the group against the plain
    product of the full tensors (made from one numpy seed on every rank):
    the worst relative error over the ranks, by case; and what
    ``make_tp_group`` raises on a wrong world size or backend."""
    rank, p = dist.get_rank(), dist.get_world_size()
    group = mesh.make_tp_group(p, "cpu")
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def blk(x, axis):
        n = x.shape[axis] // p
        return x.narrow(axis, rank * n, n)

    out = {}
    parts = t(p, 5, 6)                  # every rank's own summand
    x, w, w_odd = t(24, 16), t(16, 12), t(16, 7)
    attn, wo = t(10, 4, 8), t(4, 8, 12)
    h, g = t(6, 16), t(16)
    with tp.tp_ctx(group, nano=(8, 16)):
        out["psum"] = _rel(tp.psum(parts[rank]), parts.sum(0))
        out["shard_block"] = _rel(tp.shard_block(x, axis=1), blk(x, 1))
        out["row_parallel"] = _rel(tp.row_parallel(blk(x, 1), blk(w, 0)),
                                   x @ w)
        # n % p != 0: one plain all-reduce, no nano split
        out["row_parallel_n_odd"] = _rel(
            tp.row_parallel(blk(x, 1), blk(w_odd, 0)), x @ w_odd)
        out["out_project"] = _rel(tp.out_project(blk(attn, 1), blk(wo, 0)),
                                  torch.einsum("thk,hkd->td", attn, wo))
        out["rmsnorm_sharded"] = _rel(
            tp.rmsnorm_sharded(blk(h, 1), blk(g, 0), 1e-5),
            blk(rmsnorm(h, g, 1e-5), 1))
    with tp.tp_ctx(group, nano=(8, 8, 8)):
        # a split that does not cover the rows: one group
        out["row_parallel_uncovered"] = _rel(
            tp.row_parallel(blk(x, 1), blk(w, 0)), x @ w)
    out["matmul_allreduce"] = _rel(
        cm.matmul_allreduce(blk(x, 1), blk(w, 0), group), x @ w)
    out["allgather_matmul"] = _rel(
        cm.allgather_matmul(blk(x, 1), blk(w, 1), group), blk(x @ w, 1))
    out["matmul_reduce_scatter"] = _rel(
        cm.matmul_reduce_scatter(blk(x, 1), blk(w, 0), group), blk(x @ w, 1))
    errors = {}
    for what, call in (("world", lambda: mesh.make_tp_group(p * 2, "cpu")),
                       ("backend", lambda: mesh.make_tp_group(
                           p, "cpu", backend="nccl"))):
        try:
            call()
        except RuntimeError as e:
            errors[what] = str(e)
    out["errors"] = errors
    return out


class _Pending:
    """A staged copy's completion event that reports the copy as not
    landed until the engine stages the next one (``late_stage``)."""

    def __init__(self):
        self.landed = False

    def query(self) -> bool:
        return self.landed

    def synchronize(self) -> None:
        self.landed = True


def late_stage(stage):
    """Wrap ``ServeEngine._stage`` so that the newest in-flight iteration's
    payload never counts as landed (``_ready``) while it is the newest:
    on the CPU every copy lands at once, so this is the only way a rank's
    own ready count can lag another's, as it can on the card."""
    def staged(self, result):
        host, _ = stage(self, result)
        prev = getattr(self, "_newest_pending", None)
        if prev is not None:
            prev.landed = True
        self._newest_pending = _Pending()
        return host, self._newest_pending
    return staged


def serve_cases(cases: list, wrong_world_cfg=None) -> dict:
    """``serve.serve_rank`` on each case ``(name, cfg, numpy params, engine
    config kwargs, waves)``, the params converted on this rank; results by
    name (rank 0's, with ``ranks_agree`` over the ranks).  A case's kwargs
    may name a ``late_rank``, on which the newest payload lags
    (``late_stage``).  With ``wrong_world_cfg`` (a config that shards at
    2 x the group's size), also what an engine at that tp raises, under
    ``"wrong_world"``."""
    out = {}
    stage = ServeEngine._stage
    for name, cfg, np_params, kw, waves in cases:
        kw = dict(kw)
        late = kw.pop("late_rank", None) == dist.get_rank()
        params = from_jax_params(cfg, np_params, device="cpu")
        ServeEngine._stage = late_stage(stage) if late else stage
        try:
            out[name] = serve.serve_rank(cfg, EngineConfig(**kw), waves,
                                         params=params, device="cpu")
        finally:
            ServeEngine._stage = stage
    if wrong_world_cfg is not None:
        tp_bad = 2 * dist.get_world_size()
        try:
            ServeEngine(wrong_world_cfg,
                        model.init(wrong_world_cfg, device="cpu"),
                        EngineConfig(tp=tp_bad, max_len=32), device="cpu")
        except RuntimeError as e:
            out["wrong_world"] = str(e)
    return out


def compressed_steps(g: np.ndarray, steps: int) -> dict:
    """Rank r of the group holds row r of ``g`` as its gradient and runs
    ``steps`` int8 all-reduces with error feedback
    (``distributed.compression``); returns each step's reduced row and the
    residuals after the last, gathered from every rank, and the plain
    mean."""
    from repro_torch.distributed import compression
    rank = dist.get_rank()
    grads = {"w": torch.from_numpy(g[rank].copy())}
    res = compression.compress_state_init(grads)
    outs = []
    for _ in range(steps):
        out, res = compression.compressed_all_reduce(grads, res)
        outs.append(out["w"].numpy().copy())
    gathered = [torch.zeros_like(res["w"]) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, res["w"])
    plain = compression.plain_all_reduce(grads)["w"].numpy()
    return {"outs": outs, "res": [r.numpy() for r in gathered],
            "plain": plain}
