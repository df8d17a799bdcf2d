"""Serving entry point (port of ``repro.launch.serve``): an offline batch, or
an online run with Poisson arrivals, on one engine or on a replica pool.

  python -m repro_torch.launch.serve --arch qwen3-8b --requests 8 --max-len 1024
  python -m repro_torch.launch.serve --arch tiny-toy --online --rate 4 --duration 10
  python -m repro_torch.launch.serve --arch tiny-toy --replicas 2 --fault-plan kill@3:r1
  python -m repro_torch.launch.serve --arch tiny-toy --device cpu
  python -m repro_torch.launch.serve --arch tiny-toy --tp 2 --device cpu

Weights are seeded random (``model.init`` with ``--seed``), drawn on the
device.  It runs on ``cuda`` unless ``--device`` names another and raises
where there is no card.  ``--replicas > 1`` or a ``--fault-plan`` serves
through ``ReplicaPool`` (DESIGN.md §14).  ``--tp N`` (DESIGN.md §11)
spawns N ranks (``launch.mesh.spawn_tp``: nccl on ``cuda``, one card a
rank; gloo on the CPU), each drawing its shard of the same seeded weights
and serving the same requests; rank 0 prints the lines.  The offline batch
only: an online run's arrivals follow each rank's clock, and the pool
serves tp = 1 replicas (ROADMAP).

``serve_rank`` is the rank function for callers that want the results
back (``spawn_tp`` returns rank 0's): tokens, the plan of every
iteration, the stats, and on the card the kernels' launches and the peak
device memory.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import get_config, scale_down
from repro_torch.distributed import tp as tp_lib
from repro_torch.kernels import ops
from repro_torch.launch import mesh
from repro_torch.models import model as model_lib
from repro_torch.serving.config import EngineConfig, PoolConfig
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.pool import ReplicaPool
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import BatchPlan


def make_requests(n: int, vocab: int, seed: int = 0, p_mean: int = 24,
                  d_mean: int = 16) -> list[Request]:
    """The JAX CLI's workload: exponential prompt (<= 96) and decode
    (<= 64) lengths, uniform token ids, from numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = max(2, int(rng.exponential(p_mean)))
        dlen = max(2, int(rng.exponential(d_mean)))
        out.append(Request(
            rid=i, prompt=[int(t) for t in
                           rng.integers(0, vocab, size=min(plen, 96))],
            max_new_tokens=min(dlen, 64)))
    return out


def device_label(device: torch.device) -> str:
    """The device a run's numbers were taken on, by name."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def serve_pool(args, cfg, params, pcfg, reqs, device) -> None:
    """Multi-replica path (DESIGN.md §14): N engines on the same weights
    behind the router, driven by the pool's event loop, with optional
    fault injection."""
    ecfg = EngineConfig.from_args(args, seed=args.seed)

    def mk_engine():
        return ServeEngine(cfg, params, ecfg, device=device)

    pool = ReplicaPool([mk_engine() for _ in range(pcfg.replicas)], pcfg,
                       engine_factory=mk_engine)
    rng = np.random.default_rng(args.seed)
    if args.online:
        offsets = list(np.cumsum(
            rng.exponential(1.0 / args.rate, size=len(reqs))))
    else:
        offsets = [0.0] * len(reqs)
    t0 = time.perf_counter()
    results = pool.run_online(reqs, offsets, duration=args.duration
                              if args.online else None)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    snap = pool.snapshot()
    n_tok = sum(h.engine.stats.total_tokens
                for h in pool.router.replicas if h.engine is not None)
    print(f"pool[{pcfg.replicas} replicas]: finished {len(results)}"
          f"/{len(reqs)} requests, {snap['shed_requests']} shed, "
          f"{n_tok} tokens in {wall*1e3:.0f} ms "
          f"({n_tok / max(wall, 1e-9):.1f} tok/s on {device_label(device)})")
    print(f"fault tolerance: {snap['faults_injected']} faults injected, "
          f"{snap['redispatched_requests']} requests re-dispatched "
          f"({snap['redispatched_tokens']} committed tokens replayed), "
          f"{snap['retries']} retries, {snap['timeouts']} timeouts, "
          f"{snap['slo_violations']} SLO violations")
    for rep in snap["replicas"]:
        state = "alive" if rep["alive"] else "dead"
        if rep["suspect"]:
            state += "/suspect"
        print(f"  r{rep['replica']} [{state}]: depth {rep['queue_depth']}, "
              f"queued {rep['queued_tokens']} tok, in-flight "
              f"{rep['inflight_tokens']} tok, KV {rep['kv_used_frac']:.0%}")
    done = list(results.values())
    lat = [r.finished_at - r.arrival for r in done
           if r.finished_at is not None]
    if lat and args.online:
        print(f"latency: p50 {np.percentile(lat, 50)*1e3:.1f} ms "
              f"p99 {np.percentile(lat, 99)*1e3:.1f} ms")
    for r in pool.shed[:5]:
        print(f"  shed rid={r.rid}: {r.reject_reason}")


def serve_online(args, eng: ServeEngine, reqs: list[Request]) -> list:
    """One engine under Poisson arrivals at ``--rate`` for ``--duration``
    seconds of wall time, then until every admitted request is done."""
    rng = np.random.default_rng(args.seed)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, size=len(reqs)))
    t0, done, i = time.perf_counter(), [], 0
    while time.perf_counter() - t0 < args.duration or eng.scheduler.n_active:
        now = time.perf_counter() - t0
        while i < len(reqs) and arrivals[i] <= now:
            # absolute stamp, as the commit stamps are
            reqs[i].arrival = t0 + arrivals[i]
            eng.submit(reqs[i])
            i += 1
        plan = eng.scheduler.plan()
        if plan is None:
            # the oldest in-flight commit may unblock planning (§10):
            # retire one and plan again at once if it did
            if eng.in_flight:
                done += eng.drain(max_retire=1)
                continue
            if i >= len(reqs) and not eng.scheduler.n_active:
                break
            time.sleep(0.005)
            continue
        done += eng.step(plan)
    done += eng.drain()
    # run() accounts wall_time itself; this loop must do it
    eng.stats.wall_time += time.perf_counter() - t0
    return done


def report(args, eng: ServeEngine, done: list, n_reqs: int) -> None:
    """The single-engine run's lines, from the ``snapshot()`` schemas
    shared with the JAX CLI."""
    st = eng.stats.snapshot()
    kv = eng.kv.stats.snapshot()
    print(f"finished {len(done)}/{n_reqs} requests in "
          f"{st['iterations']} iters")
    print(f"tokens: prefill {st['prefill_tokens']} decode "
          f"{st['decode_tokens']} total {st['total_tokens']}")
    print(f"throughput {st['throughput']:.1f} tok/s "
          f"(on {device_label(eng.device)})")
    print(f"step={eng.step_mode}: {st['dispatches_per_iter']:.2f} "
          f"dispatches/iter, {st['syncs_per_iter']:.2f} host syncs/iter, "
          f"{st['packed_pad_tokens']} pad tokens")
    print(f"async depth {eng.async_depth}: "
          f"{st['blocking_syncs']}/{st['host_syncs']} blocking syncs "
          f"({st['blocking_syncs_per_iter']:.2f}/iter), "
          f"blocked {st['blocked_sync_time']*1e3:.0f} ms, "
          f"host {st['host_time']*1e3:.0f} ms, "
          f"dispatch {st['dispatch_time']*1e3:.0f} ms "
          f"(wall {st['wall_time']*1e3:.0f} ms), "
          f"{eng.scheduler.dropped_tokens} overshoot tokens dropped")
    if eng.tp > 1:
        print(f"tp={eng.tp}: "
              f"~{st['tp_collective_bytes_per_iter'] / 1e3:.1f} KB "
              f"modeled collective traffic/iter "
              f"({st['tp_collective_bytes'] / 1e6:.2f} MB total)")
    print("dense batch histogram: "
          f"{dict(sorted(st['dense_batch_hist'].items()))}")
    if st["kv_bucket_hist"]:
        swept = sum(b * n for b, n in st["kv_bucket_hist"].items())
        dense = args.max_len * sum(st["kv_bucket_hist"].values())
        print(f"kv bucket histogram: "
              f"{dict(sorted(st['kv_bucket_hist'].items()))}"
              f" (attention sweep {swept / max(dense, 1):.2f}x of max_len)")
    if eng.spec_k > 0:
        rate = st["spec_acceptance_rate"]
        print(f"spec decode k={eng.spec_k} "
              f"({eng.config.resolved_drafter}): "
              f"{st['spec_verify_segments']} verify segments, "
              f"{st['spec_accepted_tokens']}/"
              f"{st['spec_proposed_tokens']} drafts accepted "
              f"({rate:.0%} acceptance, "
              f"{st['spec_accepted_per_verify']:.2f} committed "
              f"tokens/verify)")
    if eng.config.kv_dtype == "int8":
        drift = st["kv_quant_drift"]
        print(f"kv dtype int8: {st['kv_quant_bytes_saved']/1e6:.2f} MB of "
              f"cache writes saved vs {eng.cfg.dtype} storage "
              f"({eng.kv.bytes_per_token} B/token vs "
              f"{eng._kv_bytes_native} B/token)"
              + (f", max logit drift {drift:.4f}" if drift is not None
                 else ""))
    if eng.prefix_caching:
        total_prompt = sum(r.prompt_len for r in done)
        print(f"prefix caching: {kv['prefix_hit_tokens']} prompt tokens "
              f"served from shared blocks "
              f"({kv['prefix_hit_tokens'] / max(total_prompt, 1):.0%} of "
              f"prompt), {kv['cow_copies']} CoW block copies, "
              f"{kv['evicted_blocks']} cached blocks evicted")
    print(f"kv offload: {kv['offload_bytes']/1e6:.2f} MB aggregated in "
          f"{kv['aggregated_copies']} copies")
    lat = [(r.finished_at or 0) - r.arrival for r in done if r.finished_at]
    if lat and args.online:
        norm = [l / max(len(r.output), 1) for l, r in zip(lat, done)]
        print(f"normalized latency: p50 {np.percentile(norm, 50)*1e3:.1f} "
              f"ms/tok p99 {np.percentile(norm, 99)*1e3:.1f} ms/tok")


def plan_signature(plan: BatchPlan) -> tuple:
    """What an iteration planned: its decode requests and its prefill
    chunks (rid, offset, length)."""
    return (tuple(r.rid for r in plan.decode),
            tuple((c.req.rid, c.offset, c.length) for c in plan.prefill))


def serve_rank(cfg, config: EngineConfig, waves: list, *, seed: int = 0,
               params: Optional[dict] = None, device=None) -> dict:
    """Serve ``waves`` (lists of ``(rid, prompt, max_new_tokens)``; each
    wave is submitted, then run to its end) on one engine: at
    ``config.tp > 1`` this process's rank of the group.  ``params`` (full
    or the rank's shard, on ``device``) default to ``model.init(cfg,
    seed)``, drawn as the rank's shard.  Returns the outputs ``{rid:
    tokens}``, ``plans`` (``plan_signature`` of every iteration), the
    engine's and the KV manager's stats snapshots, the wall, the local
    widths, the kernels' launches (counted from 0 at engine construction;
    none on the CPU) and on the card the peak device memory; at tp > 1 also
    ``ranks_agree`` (every rank served the same tokens and plans) and
    ``ranks``, every rank's result but its tokens and plans."""
    device = resolve_device(device)
    world = config.tp
    rank = dist.get_rank() if world > 1 else 0
    if params is None:
        params = model_lib.init(cfg, seed=seed, device=device,
                                shard=(rank, world) if world > 1 else None)
    cuda = device.type == "cuda"
    ops.zero_launch_counts()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    eng = ServeEngine(cfg, params, config, device=device)
    plans: list = []
    plan = eng.scheduler.plan

    def recorded():
        p = plan()
        if p is not None:
            plans.append(plan_signature(p))
        return p
    eng.scheduler.plan = recorded
    outputs: dict = {}
    t0 = time.perf_counter()
    for wave in waves:
        for rid, prompt, max_new in wave:
            eng.submit(Request(rid=rid, prompt=list(prompt),
                               max_new_tokens=max_new))
        for r in eng.run():
            outputs[r.rid] = tuple(r.output)
    if cuda:
        torch.cuda.synchronize(device)
    layer = eng.params["layers"][0]
    out = {"rank": rank, "stats": eng.stats.snapshot(),
           "kv": eng.kv.stats.snapshot(),
           "wall": time.perf_counter() - t0,
           "shapes": {f"{part}/{name}": tuple(leaf.shape)
                      for part in ("mixer", "ffn")
                      for name, leaf in layer.get(part, {}).items()
                      if isinstance(leaf, torch.Tensor)},
           "cache_shapes": {name: tuple(leaf.shape)
                            for name, leaf in eng.cache[0].items()},
           "launches": ops.launch_counts(),
           "peak_mem": torch.cuda.max_memory_allocated(device)
           if cuda else None}
    eng.release()
    if world > 1:
        seen = [None] * world
        dist.all_gather_object(seen, (outputs, plans, out),
                               group=mesh.host_group())
        out = dict(out, ranks=[s[2] for s in seen], ranks_agree=all(
            s[:2] == seen[0][:2] for s in seen))
    return dict(out, outputs=outputs, plans=plans)


def serve_rank_cases(cases: list, device=None) -> list:
    """``serve_rank(**case)`` for each case in turn (a rank function of
    ``spawn_tp`` for a caller with several models to serve: each case's
    engine is released before the next)."""
    out = []
    for case in cases:
        out.append(serve_rank(**case, device=device))
        if resolve_device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv: Optional[Sequence[str]] = None) -> Optional[dict]:
    """Run the serving CLI; returns the finished requests' tokens ``{rid:
    tokens}`` of a single-engine run (at tp > 1, rank 0's; None on the pool
    path)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-toy")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    EngineConfig.add_args(ap)
    PoolConfig.add_args(ap)
    ap.add_argument("--online", action="store_true")
    ap.add_argument("--rate", type=float, default=4.0, help="req/s (poisson)")
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cpu: the plain PyTorch "
                         "path, no kernels)")
    args = ap.parse_args(argv)
    pcfg = PoolConfig.from_args(args)
    ecfg = EngineConfig.from_args(args, seed=args.seed)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = scale_down(cfg)
    rank = 0
    if ecfg.tp > 1:
        tp_lib.validate_tp(cfg, ecfg.tp)
        if pcfg.replicas > 1 or pcfg.fault_plan or args.online:
            raise ValueError("--tp > 1 serves the offline batch on one "
                             "engine: no --replicas, --fault-plan or "
                             "--online")
        if not (dist.is_available() and dist.is_initialized()):
            argv = list(sys.argv[1:] if argv is None else argv)
            # each rank runs this function again, inside the group
            return mesh.spawn_tp(ecfg.tp, main, argv, device=args.device)
        rank = dist.get_rank()

    device = resolve_device(args.device)
    params = model_lib.init(cfg, seed=args.seed, device=device,
                            shard=(rank, ecfg.tp) if ecfg.tp > 1 else None)
    reqs = make_requests(args.requests, cfg.vocab_size, args.seed)

    if pcfg.replicas > 1 or pcfg.fault_plan:
        serve_pool(args, cfg, params, pcfg, reqs, device)
        return None
    eng = ServeEngine(cfg, params, ecfg, device=device)
    if args.online:
        done = serve_online(args, eng, reqs)
    else:
        for r in reqs:
            eng.submit(r)
        done = eng.run()
    if rank == 0:
        report(args, eng, done, len(reqs))
    return {r.rid: tuple(r.output) for r in done}


if __name__ == "__main__":
    main()
