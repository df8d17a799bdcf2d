#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught):
  1. card    — print the card's name and power limit (nvidia-smi); TF32 off.
  2. build   — compile the CUDA kernels from src/repro_torch/kernels/csrc.
  3. kernels — each kernel against its plain PyTorch version at Qwen3-8B
               shapes in bf16 (packed attention also in f32), with its time, the plain version's time, the
               time of one PyTorch library call of the same function (where
               there is one) and the card's bound for the same work.
  4. forward — ``forward_packed`` at full width, 4 layers, through the
               kernels and through the plain versions: logits must agree.
  5. serve   — Qwen3-8B at full width and all 36 layers (seeded random bf16
               weights) serves 8 requests; both kernels must have launched,
               and the greedy tokens must agree with a teacher-forced
               forward through the plain versions.
  6. profile — the same requests again under torch.profiler: device busy
               share and the kernels that take the device time.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# (memory bytes/s, dense bf16 tensor-core flop/s), from NVIDIA's data sheets
PEAKS = {"H100 PCIe": (2.0e12, 756e12), "H100 NVL": (3.9e12, 835e12),
         "H100": (3.35e12, 989e12), "H200": (4.8e12, 989e12)}
# kernel vs plain: |a - b| <= atol + rtol * |b|.  Both sides accumulate in
# f32 from the same inputs, so in bf16 they differ by at most one output
# rounding (<= |b| / 128); in f32 only by summation order.
BF16_TOL = (1e-3, 1e-2)
F32_TOL = (2e-5, 1e-5)      # as tests/test_packed_attention.py:_tol
LIB_TOL = (2e-2, 2e-2)      # the SDPA yardstick may round in bf16 inside
FWD_LOGIT_ATOL = 0.1    # whole forward, kernels vs plain, bf16 logits
FWD_ARGMAX_MIN = 0.9    # share of tokens whose greedy argmax agrees
SERVE_AGREE_MIN = 0.9   # served tokens vs teacher-forced plain forward


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info(torch) -> tuple[str, float, float]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    line = smi.stdout.strip().splitlines()[0]
    log(line)
    name = torch.cuda.get_device_name(0)
    for key, peaks in PEAKS.items():        # most specific name first
        if key in name:
            log(f"peaks for {name!r}: {peaks[0] / 1e12} TB/s, "
                f"{peaks[1] / 1e12} bf16 TFLOP/s ({key} data sheet)")
            return name, peaks[0], peaks[1]
    raise RuntimeError(f"no peak rates on record for {name!r}")


class Timer:
    """Median device time of one call, each call after an L2 flush (the
    real caller finds each layer's weights and cache cold)."""

    def __init__(self, torch, reps: int = 20):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(self.reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in events]))


def check_close(name: str, got, want, tol=BF16_TOL) -> float:
    atol, rtol = tol
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    max_err = float(err.max())
    if not bool(got.float().isfinite().all()) or bool(bad.any()):
        raise AssertionError(f"{name}: max abs err {max_err} exceeds "
                             f"{atol} + {rtol}·|ref| or output not finite")
    return max_err


def attention_case(torch, cfg, bucket: int, seed: int, dtype):
    """8 decode tokens (slots 0-7) plus a 200-token prefill chunk (slot 8,
    positions 300-499) and a 37-token chunk (slot 9, positions 0-36), over
    10 slots of 1024 rows at Qwen3-8B's heads."""
    rng = np.random.default_rng(seed)
    n, s = 10, 1024
    kv, hd, h = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_heads
    slot = list(range(8)) + [8] * 200 + [9] * 37
    lens = list(rng.integers(bucket // 2, bucket + 1, 8)) + \
        list(range(301, 501)) + list(range(1, 38))
    t = len(slot)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q, k, v = randn(t, h, hd), randn(n, s, kv, hd), randn(n, s, kv, hd)
    slot_t = torch.tensor(slot, dtype=torch.int32, device=dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    rows = {}
    for sl, ln in zip(slot, lens):
        rows[sl] = max(rows.get(sl, 0), ln)
    item = q.element_size()
    nbytes = (sum(rows.values()) * kv * hd * 2 * item   # K and V rows read
              + 2 * q.numel() * item + 2 * t * 4)       # q, out, slot+lengths
    flops = sum(lens) * h * hd * 4                      # QK^T and PV
    return (q, k, v, slot_t, lens_t), nbytes, flops


def sdpa_inputs(torch, args, bucket: int):
    """The same attention as one ``scaled_dot_product_attention`` call: all
    slots' bucket rows as one key sequence, with a boolean mask that lets
    token t see rows [0, lengths[t]) of its own slot."""
    q, k, v, slot, lens = args
    n, kv, hd = k.shape[0], k.shape[2], k.shape[3]
    kk = k[:, :bucket].reshape(n * bucket, kv, hd).permute(1, 0, 2)[None]
    vv = v[:, :bucket].reshape(n * bucket, kv, hd).permute(1, 0, 2)[None]
    row = torch.arange(n * bucket, device=q.device)
    mask = (row[None] // bucket == slot[:, None].long()) & \
        (row[None] % bucket < lens[:, None].long())
    return (q.permute(1, 0, 2)[None].contiguous(), kk.contiguous(),
            vv.contiguous(), mask[None, None])


def phase_kernels(torch, cfg, timer, bw, peak):
    from repro_torch.kernels.packed_attention import (packed_attention_cuda,
                                                      packed_attention_ref)
    from repro_torch.kernels.swiglu import swiglu_cuda, swiglu_ref
    F = torch.nn.functional
    record = {}

    # ---- packed attention --------------------------------------------------
    for bucket in (1000, 1024):
        # f32 at the same shapes: a masking or bucket error at full length
        # shows far above the f32 tolerance
        args32, _, _ = attention_case(torch, cfg, bucket, bucket, torch.float32)
        err32 = check_close(f"packed_attention f32 bucket {bucket}",
                            packed_attention_cuda(*args32, kv_bucket=bucket),
                            packed_attention_ref(*args32, kv_bucket=bucket),
                            F32_TOL)
        log(f"packed_attention f32 T={args32[0].shape[0]} bucket={bucket}: "
            f"max_abs_err {err32:.3e} (tol {F32_TOL[0]} + {F32_TOL[1]}·|ref|)")
        del args32
        args, nbytes, flops = attention_case(torch, cfg, bucket, bucket,
                                             torch.bfloat16)
        got = packed_attention_cuda(*args, kv_bucket=bucket)
        want = packed_attention_ref(*args, kv_bucket=bucket)
        torch.cuda.synchronize()
        err = check_close(f"packed_attention bucket {bucket}", got, want)
        sq, sk, sv, mask = sdpa_inputs(torch, args, bucket)

        def lib():
            return F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask,
                                                  enable_gqa=True)
        lib_out = lib()[0].permute(1, 0, 2)
        check_close(f"sdpa yardstick bucket {bucket}", lib_out, want, LIB_TOL)
        ms = timer(lambda: packed_attention_cuda(*args, kv_bucket=bucket))
        plain_ms = timer(lambda: packed_attention_ref(*args, kv_bucket=bucket))
        lib_ms = timer(lib)
        t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
        log(f"packed_attention T={args[0].shape[0]} bucket={bucket}: max_abs_err "
            f"{err:.3e} (tol {BF16_TOL[0]} + {BF16_TOL[1]}·|ref|)  kernel_ms {ms:.4f}  "
            f"plain_ms {plain_ms:.4f}  sdpa_ms {lib_ms:.4f}  bound_ms "
            f"{max(t_bytes, t_ops):.4f} ({nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP)")
        if bucket == 1024:
            record["packed_attention"] = dict(
                shape=f"T={args[0].shape[0]} (8 decode + 200 + 37 prefill), "
                      f"H=32 KV=8 D=128, kv_bucket={bucket}, bf16",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=lib_ms)

    # ---- SwiGLU ------------------------------------------------------------
    d, ff = cfg.d_model, cfg.d_ff
    gen = torch.Generator(device="cuda").manual_seed(7)
    wg = (torch.randn(d, ff, generator=gen, device="cuda") / d ** 0.5) \
        .to(torch.bfloat16)
    wu = (torch.randn(d, ff, generator=gen, device="cuda") / d ** 0.5) \
        .to(torch.bfloat16)
    for t in (8, 64, 256, 257):
        x = torch.randn(t, d, generator=gen, device="cuda").to(torch.bfloat16)
        got = swiglu_cuda(x, wg, wu)
        want = swiglu_ref(x, wg, wu)
        torch.cuda.synchronize()
        err = check_close(f"swiglu T={t}", got, want)
        ms = timer(lambda: swiglu_cuda(x, wg, wu))
        plain_ms = timer(lambda: swiglu_ref(x, wg, wu))
        nbytes = (t * d + 2 * d * ff + t * ff) * 2
        flops = 4 * t * d * ff
        t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
        log(f"swiglu T={t} ({d}x{ff}): max_abs_err {err:.3e} (tol {BF16_TOL[0]}"
            f" + {BF16_TOL[1]}·|ref|)  kernel_ms {ms:.4f}  plain_ms {plain_ms:.4f}  "
            f"bound_ms {max(t_bytes, t_ops):.4f} ({nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP)  {flops / ms / 1e9:.1f} TFLOP/s")
        if t == 256:
            record["swiglu"] = dict(
                shape=f"x ({t},{d}) x ({d},{ff}) twice, bf16",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)
    return record


def phase_forward(torch, cfg):
    """Full width, 4 layers: a prefill stream of 8 x 25 tokens padded to
    256, then 8 decode tokens, through the kernels and the plain versions,
    each with its own cache."""
    from repro_torch.models import model
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    params = model.init(cfg4, seed=0, device="cuda")
    rng = np.random.default_rng(1)
    pre_slot = np.repeat(np.arange(8), 25)
    pre_pos = np.tile(np.arange(25), 8)
    pad = 256 - len(pre_slot)
    streams = [
        (rng.integers(0, cfg.vocab_size, 256), np.r_[pre_slot, np.zeros(pad)],
         np.r_[pre_pos, np.zeros(pad)], np.r_[pre_pos, np.full(pad, 64)]),
        (rng.integers(0, cfg.vocab_size, 8), np.arange(8), np.full(8, 25),
         np.full(8, 25)),
    ]
    logits = {}
    for impl in (None, "plain"):
        cache = model.init_cache(cfg4, 8, 64, device="cuda")
        outs = []
        for toks, slot, pos, wpos in streams:
            as_t = [torch.tensor(np.asarray(a), dtype=torch.int32, device="cuda")
                    for a in (toks, slot, pos, wpos)]
            lg, cache = model.forward_packed(cfg4, params, as_t[0][None], cache,
                                             as_t[1], as_t[2], as_t[3],
                                             kv_bucket=64, impl=impl)
            outs.append(lg[0, :len(pre_slot)] if len(toks) == 256 else lg[0])
        logits[impl] = torch.cat(outs).float()
    torch.cuda.synchronize()
    a, b = logits[None], logits["plain"]
    if not bool(a.isfinite().all()):
        raise AssertionError("forward: non-finite logits")
    diff = float((a - b).abs().max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    log(f"forward (4 layers, full width): logits max-abs diff {diff:.4f} "
        f"(tol {FWD_LOGIT_ATOL}), |logits| max {float(b.abs().max()):.3f}, "
        f"greedy argmax agreement {agree:.4f} (tol >= {FWD_ARGMAX_MIN})")
    if diff > FWD_LOGIT_ATOL or agree < FWD_ARGMAX_MIN:
        raise AssertionError("forward: kernels and plain versions disagree")
    del params, logits
    torch.cuda.empty_cache()


def phase_serve(torch, cfg):
    from repro_torch.kernels.packed_attention import packed_attention_cuda
    from repro_torch.kernels.swiglu import swiglu_cuda
    from repro_torch.models import model
    from repro_torch.models.param import count_params
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.request import Request

    t0 = time.perf_counter()
    params = model.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"serve: {cfg.name} {count_params(model.model_defs(cfg)) / 1e9:.3f}B "
        f"params, seeded init {time.perf_counter() - t0:.1f} s")
    eng = ServeEngine(cfg, params, EngineConfig(max_slots=8, max_len=1024,
                                                async_depth=0))
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 601, 8)
    prompts = [[int(x) for x in rng.integers(0, cfg.vocab_size, n)]
               for n in lens]
    # the main path's run: counts from 0
    packed_attention_cuda.launches = 0
    swiglu_cuda.launches = 0
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=32))
    done = eng.run()
    torch.cuda.synchronize()
    launches = {"packed_attention": packed_attention_cuda.launches,
                "swiglu": swiglu_cuda.launches}
    s = eng.stats
    log(f"serve: prompts {lens.tolist()}, {len(done)}/8 finished, "
        f"{s.iterations} iterations, {s.total_tokens} tokens in "
        f"{s.wall_time:.3f} s = {s.throughput:.1f} tok/s, "
        f"{s.dispatches_per_iter} dispatch/iter, {s.syncs_per_iter} sync/iter, "
        f"KV {eng.kv.bytes_per_token} B/token, dense batches "
        f"{s.dense_batch_hist}, kv buckets {s.kv_bucket_hist}, "
        f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log(f"serve: wall split: host {s.host_time:.3f} s, step enqueue "
        f"{s.dispatch_time:.3f} s, blocked on the payload copy "
        f"{s.blocked_sync_time:.3f} s ({s.blocking_syncs} blocking syncs)")
    log(f"serve: kernel launches {launches} "
        f"({launches['packed_attention'] / s.iterations:.0f} and "
        f"{launches['swiglu'] / s.iterations:.0f} per iteration)")
    if len(done) != 8 or any(len(r.output) != 32 for r in done):
        raise AssertionError("serve: not every request finished 32 tokens")
    if s.dispatches_per_iter != 1.0 or s.syncs_per_iter != 1.0:
        raise AssertionError("serve: not one dispatch and one sync per iter")
    if min(launches.values()) <= 0:
        raise AssertionError(f"serve: a kernel never launched: {launches}")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.output):
        raise AssertionError("serve: token id out of range")

    # reference: teacher-forced plain forward of request 0's whole stream
    r0 = min(done, key=lambda r: r.rid)
    seq = r0.prompt + r0.output[:-1]
    n = len(seq)
    pos = torch.arange(n, dtype=torch.int32, device="cuda")
    cache = model.init_cache(cfg, 1, 1024, device="cuda")
    lg, _ = model.forward_packed(
        cfg, params, torch.tensor([seq], dtype=torch.int32, device="cuda"),
        cache, torch.zeros(n, dtype=torch.int32, device="cuda"), pos, pos,
        kv_bucket=1024, impl="plain")
    ref = lg[0, r0.prompt_len - 1:].argmax(-1).tolist()
    agree = float(np.mean(np.asarray(ref) == np.asarray(r0.output)))
    log(f"serve: request 0 ({r0.prompt_len} prompt tokens) greedy tokens vs "
        f"teacher-forced plain forward: agreement {agree:.4f} "
        f"(tol >= {SERVE_AGREE_MIN})")
    if agree < SERVE_AGREE_MIN:
        raise AssertionError("serve: tokens disagree with the plain forward")
    return launches, params, prompts, s.wall_time


def phase_profile(torch, cfg, params, prompts, serve_wall: float):
    """Where the serve phase's device time goes: the same requests on a
    fresh engine under ``torch.profiler``, summing the device's own events
    (kernels and copies).  The profiler stretches the host's wall clock, so
    the busy share is also given against the unprofiled serve's wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.request import Request
    eng = ServeEngine(cfg, params, EngineConfig(max_slots=8, max_len=1024,
                                                async_depth=0))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=32))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in events)
    wall_us = eng.stats.wall_time * 1e6
    if dev_us == 0:
        log("profile: the profiler saw no device time")
        return
    log(f"profile: device busy {dev_us / 1e3:.1f} ms over "
        f"{eng.stats.iterations} iterations: {dev_us / wall_us:.3f} of the "
        f"profiled wall ({wall_us / 1e3:.1f} ms), {dev_us / 1e6 / serve_wall:.3f}"
        f" of the unprofiled serve's wall ({serve_wall * 1e3:.1f} ms); "
        f"{sum(e.count for e in events) / eng.stats.iterations:.0f} device "
        f"events per iteration")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"profile:   {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.self_device_time_total / dev_us:6.3f}  x{e.count:<6d} "
            f"{e.key[:90]}")


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    name, bw, peak = card_info(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    libs = build.build()
    log(f"build: {libs.build_seconds:.1f} s")
    for line in libs.ptxas_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("---"):
            log("  " + line.strip())

    cfg = get_config("qwen3-8b")
    timer = Timer(torch)
    record = phase_kernels(torch, cfg, timer, bw, peak)
    del timer
    phase_forward(torch, cfg)
    launches, params, prompts, serve_wall = phase_serve(torch, cfg)
    phase_profile(torch, cfg, params, prompts, serve_wall)

    sources = {"packed_attention": ("src/repro_torch/kernels/csrc/"
                                    "packed_attention.cu",
                                    "src/repro/kernels/packed_attention.py:135"),
               "swiglu": ("src/repro_torch/kernels/csrc/swiglu.cu",
                          "src/repro/kernels/swiglu.py:45")}
    kernels = []
    for kname, (src, replaces) in sources.items():
        rec = record[kname]
        kernels.append(dict(name=kname, route="cuda", source=src,
                            replaces=replaces, launches=launches[kname],
                            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                            bound_by=rec["bound_by"],
                            library_ms=rec["library_ms"], shape=rec["shape"]))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
