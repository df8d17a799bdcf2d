#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught):
  1. card    — print the card's name and power limit (nvidia-smi); TF32 off.
  2. build   — compile the CUDA kernels from src/repro_torch/kernels/csrc.
  3. kernels — each kernel against its plain PyTorch version at Qwen3-8B
               shapes in bf16 (the attention kernels also in f32),
               with its time, the plain version's time, the time of one
               PyTorch library call of the same function (where there is
               one) and the card's bound for the same work.  The four
               packed-attention variants: contiguous, int8 KV, block-table
               (shuffled table, block 16) and block-table + int8, each with
               the K/V megabytes its tile kernel streams beside what a
               per-token loop reads and the distinct rows; flash
               attention at the legacy chunk's and the recompute prefill's
               shapes (each with its launch's schedule: CTAs, key chunks,
               CTAs with keys; its TFLOP/s and the host's microseconds per
               call); decode attention over 8 slots of 1024 rows (with
               its TB/s and the split-KV units and chunk size); the
               selective scan (f32 and bf16) at Jamba-1.5-Large's 16384
               channels and 16 states, on a 256-token chunk from a carried
               state and a 513-token prompt from zero state; SwiGLU (bf16)
               at Qwen3-8B's widths for T = 8, 64, 256, 257 and for T = 8,
               256 at Jamba-1.5-Large's (8192 -> 24576), Arctic's dense
               residual's (7168 -> 4864), LLaMA-2-70B's (8192 -> 28672) and
               LLaVA-NeXT-34B's (7168 -> 20480), each with its tiles and
               CTA groups, beside the library pair (two torch.matmul, then
               F.silu(g) * u).
     groups  — the attention kernels at the other GQA shapes the served
               models give them, against their plain versions in f32 and
               bf16 at the shapes above: at group 7 (Arctic's 56 / 8
               heads) packed attention in its four builds, decode, paged
               decode, flash (the chunk shape) and the fused op's
               attention role, each timed beside its plain version, its
               bound and masked SDPA where one call computes it; at groups
               3 (24 / 8), 9 (36 / 4) and 1 (MusicGen-medium's 24 / 24 at
               head_dim 64) packed attention, decode and flash; at group 8
               (Jamba's 64 / 8) the int8 build of packed attention.
     paged   — paged decode attention through ``ops.paged_decode_attention``
               (its only caller) at Qwen3-8B's heads: 8 rows of the serve
               phase's lengths + 16 over a shuffled pool of 16-row pages,
               tables padded with -1; kernel (the split-KV unit's paged
               form, csrc/decode_attention.cu's second C entry, with its
               units and chunk) vs plain in bf16 and f32.
     overlap — the fused GEMM + decode-attention op through
               ``ops.fused_overlap``: x (1024, 4096) @ w (4096, 4096) beside
               decode attention of 64 rows over (64, 1024, 8, 128) caches;
               kernel vs plain in bf16 and f32, outputs bitwise equal over
               the gemm_fraction sweep 0.125 ... 1.0 (CTAs, GEMM CTAs, CTAs
               per SM and ms at each), beside both bounds, the library pair
               (torch.matmul, then masked SDPA), the port's decode
               attention alone and each role of the fused kernel alone,
               the attention role's TB/s, units and chunk size, and whether
               the sweep's minimum falls below the two roles back to back.
               Each of the two is launched once from 0 counts, through its
               ``ops`` entry; no serve phase may launch them.
  4. forward — ``forward_packed`` at full width, 4 layers, through the
               kernels and through the plain versions: logits must agree.
  5. serve   — Qwen3-8B at full width and all 36 layers (seeded random bf16
               weights) serves 8 requests; contiguous packed attention and
               SwiGLU must have launched, and the greedy tokens must agree
               with a teacher-forced forward through the plain versions.
  6. profile — the same requests again under torch.profiler: device busy
               share, packed attention's, SwiGLU's, the library GEMMs'
               (cuBLAS) and flash attention's shares of the busy time and
               the kernels that take
               the device time, summed from the trace's
               device events; once per kind of engine (this one, block
               tables in the shared-prefix phase, the legacy step in the
               hybrid phase) the sum must agree with ``key_averages``
               within 1%.
  7. legacy  — the serve phase's requests on the legacy step, once with
               incremental and once with recompute prefill (profiled as in
               6): flash and decode attention launch 36 times per dispatch
               and no packed-attention variant launches; every request
               finishes 32 tokens; tokens agree with the packed serve's and
               between the two prefill modes.
  8. shared-prefix — the same model serves one request with a 600-token
               prompt prefix, then seven more that share it, in each of the
               four KV modes (prefix caching off/on x bf16/int8 KV): every
               run launches its own attention variant; the prefix runs hit
               4200 cached tokens with 7 copy-on-write block copies and
               agree with the runs without prefix caching; an int8 request
               agrees with a teacher-forced plain forward through an int8
               cache.  Each mode's run is then profiled as in 6.
  9. async   — the serve phase's 8 requests at the default async depth
               (1) and at depth 0, in turns (1, 0, 0, 1): one dispatch and
               one sync per iteration, nothing in flight at exit, tokens
               that agree (the share of token-identical requests printed),
               each run's blocking syncs per iteration and wall split; the
               depth-1 serve is then profiled as in 6.
 10. spec    — greedy speculative decoding at spec_k 4 in the contiguous
               and the prefix-caching modes: with f32 weights, a replay
               drafter built from a plain serve of the 8 requests (depth 0)
               must be accepted above 0.6, need fewer iterations than that
               serve and agree with its tokens; on the bf16 model, the
               n-gram drafter on 8 motif prompts (the default depth) must
               agree with a plain run of them and be accepted above 0.5.
 11. sampling — temperature 0.8, top_k 50: the sampler's threefry bits on
               the card equal the CPU's over the whole vocab and at
               gathered indices; the whole-vocab Gumbel noise is finite and
               4096 rows whose index 0 outweighs each other index by e^30
               all draw it (no uniform floor); the sampling pass's device
               time (greedy,
               whole-vocab Gumbel, top-k) at the serve's 16 sampled rows;
               two serves with the same seed give identical tokens at depth
               0, and two at depth 1 (harvesting off).
               Every run of phases 9-11 sets the kernels' counts to 0
               before it and fails unless its attention variant and SwiGLU
               launched and no ops-only kernel did.
 12. hybrid  — Qwen3-8B's weights freed, Jamba-1.5-Large at full width cut
               to one 8-layer group (7 Mamba + 1 attention) with dense FFNs
               (its 4 MoE layers would make the group ~45B params, ~90 GB):
               a two-chunk ``forward_chunk`` through the kernels against the
               plain versions, then the serve phase's 8 prompt lengths on
               the legacy, recompute and packed steps: every request
               finishes 32 tokens; the scan launches 7 times per prefill
               dispatch on legacy and recompute and never on the packed
               step; each attention kernel once per dispatch of its kind,
               SwiGLU 8 times; tokens agree between the steps and with a
               teacher-forced plain ``forward_full``; then the packed step
               with int8 KV (the attention layer's leaves int8, the Mamba
               state f32; the legacy step refuses int8, as JAX's does): the
               int8 build of packed attention once per iteration, tokens
               agree with a teacher-forced plain forward through an int8
               cache (the int8 run's checked run is its profiled run);
               the four runs are profiled (the legacy and recompute
               lines with the scan's device ms, launches and share of the
               busy time).  Then one line per profiled packed serve
               (Qwen3-8B, the four shared-prefix modes, the hybrid): packed
               attention's device time and share of the busy time, then
               one line per profiled serve (the legacy runs too) with
               SwiGLU's and the library GEMMs' shares.
 13. llama   — LLaMA-2-70B (the paper's evaluation model) at full width
               cut to 8 of its 80 layers: the serve phase's 8 requests on
               the packed step (packed attention and SwiGLU once per layer
               and iteration, tokens agree with a teacher-forced plain
               forward), then profiled as in 6.
 14. moe     — Snowflake Arctic at full width cut to 2 of its 35 layers
               (128 experts top-2 beside a dense residual, GQA group 7):
               ``forward_packed`` through the kernels against the plain
               versions at capacity E / k = 64, where nothing can drop
               (the share of equal (token, k)
               expert choices; the logits of tokens whose context was
               routed alike in every layer within the forward phase's
               tolerance); the 8 requests on the packed
               step at the published capacity factor 1.25 with the share
               of (token, expert) pairs dropped, then profiled (busy time,
               idle share, the device time of the expert products and of
               the dispatch and combine); at 64 (checked: nothing dropped;
               the least factor these choices needed printed; 16.0, the JAX
               tests' factor, drops pairs under these random weights), on
               the packed and legacy steps: tokens agree between them and
               with a teacher-forced plain forward.  Every
               run is counted from 0 and fails unless group-7 packed
               attention (packed), flash and decode attention (legacy) and
               SwiGLU (the dense residual) launched once per layer and
               forward.
 15. mla     — DeepSeek-V2 (absorbed MLA) at full width cut to 2 of its
               60 layers (layer 0's dense FFN, layer 1's 160 experts top-6
               and 2 shared; ~5.4B params): the MLA latent-attention kernel
               (csrc/mla_attention.cu) against its plain version in f32
               and bf16 at 128 heads, rank 512 + rope 64, on the kernels
               phase's mixed stream, 8 decode rows (the sweep split over
               the SMs), a 256-token chunk at device offset 512 and a
               513-token recompute, each timed beside its plain version,
               masked SDPA over the concatenated key and its bound;
               ``forward_packed`` through the kernels against the plain
               versions at capacity E / k = 26.67 (nothing drops); the 8
               requests at E / k on the packed step (contiguous, prefix
               caching, int8 KV), the legacy step and recompute prefill,
               each counted from 0: the MLA kernel and SwiGLU once per
               layer and forward and no other kernel, every request
               finishes, tokens agree between the steps and with a
               teacher-forced plain forward (through an int8 cache for
               int8); the contiguous serve profiled (the MLA kernel's
               share of the busy time); the packed serve at the published
               capacity 1.25 with its dropped share.
  16. families — the JAX package's remaining model families at full
               width, cut in depth (``FAMILIES``): xLSTM-1.3B (one 8-layer
               group: 7 mLSTM + 1 sLSTM, no attention, no FFN),
               StarCoder2-7B (8 of 32; GQA group 9, GELU MLP), Minitron-4B
               (8 of 32; group 3, GELU MLP), LLaVA-NeXT-34B (4 of 60; group
               7, SwiGLU, served text-only as JAX serves it) and
               MusicGen-medium (8 of 48; group 1 at head_dim 64, GELU MLP,
               4 codebook streams, codebook 0 fed back).  Each serves the
               serve phase's 8 prompt lengths (ids in its vocab) on the
               packed step, the legacy step and recompute prefill, counted
               from 0 and profiled (the checked run is the profiled one,
               its walls stretched by the profiler; xLSTM's runs are not
               profiled, for time): the kernels launch
               as the dispatches say (xLSTM none at all; MusicGen packed
               attention at group 1, head_dim 64); tokens agree with a
               teacher-forced plain forward of the step's formulas
               (packed: ``forward_packed``; legacy, recompute:
               ``prefill`` + ``forward_decode``) and between the steps.
               xLSTM's packed and prefill formulas round apart in bf16
               (its recurrent conv steps token by token on the packed
               step and as shifted multiply-adds in a prefill), so a
               witness teacher-forces request 0 through both in bf16 and
               f32: in f32 their logits agree within 1e-2, in bf16 the
               served tokens agree with ``forward_full`` at >= 0.5 and
               with the legacy engine's at >= 0.65 where contexts agree.
               The JSON gives packed, flash and decode attention their
               launches by group here.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

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
# xLSTM in bf16, its packed step's tokens vs the prefill's formulas, which
# round apart (``xlstm_witness``): request 0 vs a teacher-forced
# forward_full (18 of 32 measured), the packed vs the legacy engine where
# contexts agree (0.680 measured); in f32 the two formulas' logits differ
# by 1e-4 at most (measured)
XLSTM_SERVED_AGREE_MIN = 0.5
XLSTM_ENGINES_AGREE_MIN = 0.65
XLSTM_F32_GAP_MAX = 1e-2
# packed-attention kernel -> (block tables, int8 KV), the TPU kernel it
# replaces (the function that reaches pl.pallas_call, or its kernel body)
_TPU_PA = "src/repro/kernels/packed_attention.py"
ATTENTION = {
    "packed_attention": ((False, False), f"{_TPU_PA}:135"),
    "packed_attention_quant": ((False, True), f"{_TPU_PA}:111"),
    "packed_attention_block": ((True, False), f"{_TPU_PA}:240"),
    "packed_attention_block_quant": ((True, True), f"{_TPU_PA}:126"),
}
KV_BLOCK = 16           # block size of the block-table cases and serves
# the legacy step's kernels -> (source, the TPU kernel each replaces)
_CSRC = "src/repro_torch/kernels/csrc"
LEGACY = {
    "flash_attention": (f"{_CSRC}/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:73"),
    "decode_attention": (f"{_CSRC}/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:70"),
}
LEGACY_MODES = {"legacy": dict(step_mode="legacy"),
                "recompute": dict(prefill_mode="recompute")}
# the selective scan: source, the TPU kernel it replaces, and its tolerance
# in f32 (the N states summed in another order; the recurrence contracts,
# so the difference does not grow with S)
SSM_SCAN = (f"{_CSRC}/ssm_scan.cu", "src/repro/kernels/ssm_scan.py:61")
SCAN_F32_TOL = (1e-5, 1e-5)
# the two kernels that only their ``ops`` entries call: source and the TPU
# kernel each replaces; no serve phase may launch them
OPS_ONLY = {
    "paged_decode_attention": (f"{_CSRC}/decode_attention.cu",
                               "src/repro/kernels/decode_attention.py:154"),
    "fused_overlap": (f"{_CSRC}/fused_overlap.cu",
                      "src/repro/kernels/fused_overlap.py:89"),
}
PAGE = 16               # rows per page of the paged phase
# device-kernel names of PyTorch's library GEMMs (cuBLAS, cuBLASLt) in a
# profile, and names of the port's own kernels, which are never counted so
LIBRARY_GEMMS = ("nvjet", "gemm", "xmma", "cutlass")
OUR_KERNELS = ("packed_attention", "flash", "swiglu", "ssm_scan",
               "decode_attention", "fused_overlap", "mla_")
OVERLAP_FRACTIONS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)
# the fused GEMM in f32 against torch.matmul: 4096-term sums in another order
GEMM_F32_TOL = (1e-4, 1e-4)
# special-function-unit exponentials per clock per SM (CUDA C++ programming
# guide, arithmetic instruction throughput, compute capability 9.0) and the
# float32 rate outside the tensor cores (NVIDIA H100 SXM data sheet)
SFU_PER_CLOCK_SM = 16
F32_PEAK = 67e12
JAMBA = "jamba-1.5-large-398b"
MUSICGEN = "musicgen-medium"
LLAVA = "llava-next-34b"
ARCTIC = "arctic-480b"
LLAMA = "llama2-70b"
LLAMA_LAYERS = 8        # of 80: ~7.4B params, ~14.7 GB in bf16
MOE_LAYERS = 2          # of 35: ~27.7B params, ~55.4 GB in bf16
DEEPSEEK = "deepseek-v2-236b"
MLA_LAYERS = 2          # of 60: layer 0 (dense FFN) and 1 (MoE), ~5.4B
# absorbed MLA's latent attention: source, the TPU kernel it replaces (the
# packed-attention Pallas kernel in its KV = 1, d_v != d_qk form)
MLA = (f"{_CSRC}/mla_attention.cu", f"{_TPU_PA}:135")
HYBRID_LAYERS = 8       # one pattern group: 7 Mamba + 1 attention layer
HYBRID_MODES = {"legacy": dict(step_mode="legacy"),
                "recompute": dict(prefill_mode="recompute"),
                "packed": dict(step_mode="packed", async_depth=0),
                # the attention layer's K/V int8, the Mamba state f32 (the
                # legacy step refuses int8 KV, as JAX's does)
                "packed int8": dict(step_mode="packed", async_depth=0,
                                    kv_dtype="int8")}
# the families phase: the JAX package's remaining model families at full
# width, each cut to this many layers (xLSTM's: its 8-layer pattern group,
# 7 mLSTM + 1 sLSTM), on the three steps of the hybrid phase
FAMILIES = {"xlstm-1.3b": 8, "starcoder2-7b": 8, "minitron-4b": 8,
            LLAVA: 4, MUSICGEN: 8}
FAMILY_MODES = {mode: HYBRID_MODES[mode]
                for mode in ("packed", "legacy", "recompute")}
# every kernel an attention-free model (xLSTM) must not launch
NOT_ON_XLSTM = (*ATTENTION, *LEGACY, "mla_attention", "ssm_scan", "swiglu")
SPEC_K = 4              # drafts per verify segment in the spec phase
SPEC_ACCEPT_MIN = 0.6   # the replay drafter's acceptance must exceed it
SPEC_NGRAM_ACCEPT_MIN = 0.5  # the n-gram drafter's on the motif prompts
SAMPLING = dict(temperature=0.8, top_k=50)


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
    real caller finds each layer's weights and cache cold).  A spin kernel
    after the flush keeps the device busy while the host enqueues the call,
    so the events time the device's work, not the wrapper's host time."""

    SPIN_CYCLES = 2_000_000     # ~1 ms at the H100's clocks

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
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in events]))


def host_us(torch, call, n: int = 400) -> float:
    """Host microseconds per call of ``call`` (a kernel's wrapper) while the
    device sleeps through the loop: the enqueue cost alone."""
    call()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)          # ~0.1 s at the SM clock
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def flash_schedule(torch, kernel) -> str:
    """The bf16 flash launch's schedule (``flash_attention.launch.schedule``
    and the host replay of its items at the case's offsets)."""
    from repro_torch.kernels import flash_attention as fa
    kernel()
    q_tiles, chunk, n_chunks, ctas = fa.launch.schedule
    q, k, _ = kernel.args
    off = kernel.keywords.get("q_offset")
    offs = off.tolist() if off is not None else [0] * q.shape[0]
    live = sum(1 for it in fa.items(fa.launch.schedule[:3], q.shape[0],
                                    q.shape[1], k.shape[1], k.shape[2],
                                    q.shape[2] // k.shape[2], offs)
               if it.k1 > it.k0)
    return (f"{ctas} CTAs ({q_tiles} query tiles x {k.shape[2]} KV heads x "
            f"{q.shape[0]} rows x {n_chunks} chunks of {chunk} keys), {live} "
            f"with keys")


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


def variant_case(torch, cfg, seed: int, q_dtype, blocked: bool, quant: bool):
    """``attention_case``'s mixed stream at bucket 1024 for one variant:
    int8 caches with f32 scales (quantized from the random caches) for the
    int8 variants, and for the block-table variants a shuffled table over
    the 10 x 1024 rows in blocks of 16, so a wrong table or scale index
    reads another slot's rows.  Returns (args, kwargs, bytes, flops); the
    bytes count each attended row, scale and table entry once."""
    from repro_torch.serving.kvquant import quantize_kv
    args, _, flops = attention_case(torch, cfg, 1024, seed, torch.float32)
    q, k, v, slot, lens = args
    kw = {}
    if quant:
        k, kw["k_scale"] = quantize_kv(k)
        v, kw["v_scale"] = quantize_kv(v)
    else:
        k, v = k.to(q_dtype), v.to(q_dtype)
    q = q.to(q_dtype)
    n, s, kv, hd = k.shape
    if blocked:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        kw["block_tables"] = torch.randperm(
            n * s // KV_BLOCK, generator=gen, device="cuda"
        ).to(torch.int32).view(n, s // KV_BLOCK)
    rows = {}
    for sl, ln in zip(slot.tolist(), lens.tolist()):
        rows[sl] = max(rows.get(sl, 0), ln)
    row_bytes = kv * hd * 2 * k.element_size() + (kv * 2 * 4 if quant else 0)
    nbytes = (sum(rows.values()) * row_bytes + 2 * q.numel() * q.element_size()
              + 2 * q.shape[0] * 4 + (n * s // KV_BLOCK * 4 if blocked else 0))
    return (q, k, v, slot, lens), kw, nbytes, flops


def tiles(token_slot, lengths, n_slots: int, sweep: int, tq: int) -> list:
    """The packed-attention kernel's tiles replayed on the host, for the
    accounting below: ``(first token, tokens, largest clamped length)`` of
    each run of one slot inside each group of ``tq`` tokens.  A token with
    an out-of-range slot or a non-positive length counts as length 0."""
    slot = [int(x) for x in token_slot]
    lens = [min(max(int(x), 0), sweep) if 0 <= s < n_slots else 0
            for s, x in zip(slot, lengths)]
    out = []
    for g0 in range(0, len(slot), tq):
        a, end = g0, min(g0 + tq, len(slot))
        while a < end:
            b = a + 1
            while b < end and slot[b] == slot[a]:
                b += 1
            out.append((a, b - a, max(lens[a:b])))
            a = b
    return out


def kv_stream(args, kw, bucket: int, tq=None) -> dict:
    """K/V megabytes of a packed case: what the tile kernel streams (each
    tile reads rows [0, its largest length) once, whatever its chunks) at
    ``tq`` tokens per group (``tile_plan``'s by default), what a per-token
    loop reads (one CTA per token and KV head), and the distinct rows the
    bound counts;
    with the plan's ``tq``, ``chunk`` and ``n_chunks``."""
    from repro_torch.kernels import packed_attention as pa
    q, k, _, slot, lens = args
    n, s, kv, d = k.shape
    sweep = min(bucket, s)
    row = kv * d * 2 * k.element_size() + (kv * 8 if "k_scale" in kw else 0)
    plan = pa.tile_plan(q.shape[0], q.shape[1] // kv, sweep, tq=tq)
    sl, ln = slot.tolist(), lens.tolist()
    clamped = [min(max(x, 0), sweep) if 0 <= a < n else 0
               for a, x in zip(sl, ln)]
    distinct = {}
    for a, x in zip(sl, clamped):
        distinct[a] = max(distinct.get(a, 0), x)
    streamed = sum(top for _, _, top in tiles(sl, ln, n, sweep, plan[0]))
    return dict(zip(("tq", "chunk", "n_chunks"), plan),
                tiled=streamed * row / 1e6, per_token=sum(clamped) * row / 1e6,
                distinct=sum(distinct.values()) * row / 1e6)


def streamed_mb(args, kw, bucket: int) -> str:
    """``kv_stream`` as a line of the log."""
    x = kv_stream(args, kw, bucket)
    group = args[0].shape[1] // args[1].shape[2]
    return (f"K/V streamed by the tiles ({x['tq']} tokens x {group} heads, "
            f"chunks of {x['chunk']} rows, {x['n_chunks']} chunks) "
            f"{x['tiled']:.1f} MB, by a per-token loop {x['per_token']:.1f} "
            f"MB, distinct rows {x['distinct']:.1f} MB")


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


def flash_case(torch, cfg, case: str, dtype, seed: int = 11):
    """The legacy step's two flash-attention shapes at Qwen3-8B's heads:
    ``chunk`` is a 256-token chunk at offset 512 (a per-row device offset)
    over slot 3's 1024-row view of an 8-slot cache, ``recompute`` a
    513-token prompt attending itself from offset 0.  Returns (args,
    kwargs, SDPA mask, bytes, flops, description): the bytes count q, out
    and the K/V rows the causal limit reaches once each, the flops QK^T
    and PV over the keys each query sees."""
    kv, hd, h = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_heads
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    if case == "chunk":
        sq, off = 256, 512
        k = randn(8, 1024, kv, hd)[3:4]
        v = randn(8, 1024, kv, hd)[3:4]
        kw = dict(q_offset=torch.tensor([off], dtype=torch.int32,
                                        device="cuda"))
        desc = (f"q (1, {sq}, {h}, {hd}) at q_offset [{off}] (device) over "
                f"slot 3's (1, 1024, {kv}, {hd}) view of an 8-slot cache")
    else:
        sq, off = 513, 0
        k, v = randn(1, sq, kv, hd), randn(1, sq, kv, hd)
        kw = {}
        desc = f"q (1, {sq}, {h}, {hd}), k/v (1, {sq}, {kv}, {hd}), offset 0"
    q = randn(1, sq, h, hd)
    item = q.element_size()
    nbytes = 2 * q.numel() * item + (off + sq) * kv * hd * 2 * item
    flops = sum(off + i + 1 for i in range(sq)) * h * hd * 4
    kpos = torch.arange(k.shape[1], device="cuda")
    mask = kpos[None, :] <= off + torch.arange(sq, device="cuda")[:, None]
    return (q, k, v), kw, mask, nbytes, flops, desc


def decode_case(torch, cfg, dtype, seed: int = 13):
    """One decode token for each of 8 slots of 1024 rows at Qwen3-8B's
    heads, with the serve phase's prompt lengths plus 16 (mid-decode).
    Returns (args, SDPA mask, bytes, flops, description)."""
    kv, hd, h = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_heads
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    lens = np.random.default_rng(0).integers(16, 601, 8) + 16
    q, k, v = randn(8, h, hd), randn(8, 1024, kv, hd), randn(8, 1024, kv, hd)
    clen = torch.tensor(lens, dtype=torch.int32, device="cuda")
    item = q.element_size()
    nbytes = (int(lens.sum()) * kv * hd * 2 * item + 2 * q.numel() * item
              + 8 * 4)
    flops = int(lens.sum()) * h * hd * 4
    mask = torch.arange(1024, device="cuda")[None, :] < clen[:, None].long()
    desc = (f"q (8, {h}, {hd}), k/v (8, 1024, {kv}, {hd}), cache_len "
            f"{lens.tolist()}")
    return (q, k, v, clen), mask[:, None, None, :], nbytes, flops, desc


def legacy_case(torch, cfg, case: str, dtype):
    """One case of the legacy step's kernels as callables: (kernel, plain,
    SDPA yardstick, SDPA output in the kernel's layout, bytes, flops,
    description)."""
    from functools import partial
    from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                      decode_attention_ref)
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_ref)
    if case == "decode":
        args, mask, nbytes, flops, desc = decode_case(torch, cfg, dtype)
        q, k, v, _ = args
        fns, kw = (decode_attention_cuda, decode_attention_ref), {}
        lib_in = [q[:, :, None]] + [x.transpose(1, 2).contiguous()
                                    for x in (k, v)]

        def lib_out(x):
            return x[:, :, 0]
    else:
        args, kw, mask, nbytes, flops, desc = flash_case(torch, cfg, case,
                                                         dtype)
        fns = (flash_attention_cuda, flash_attention_ref)
        lib_in = [x.transpose(1, 2).contiguous() for x in args]

        def lib_out(x):
            return x.transpose(1, 2)

    def lib():
        return torch.nn.functional.scaled_dot_product_attention(
            *lib_in, attn_mask=mask, enable_gqa=True)
    return (partial(fns[0], *args, **kw), partial(fns[1], *args, **kw), lib,
            lib_out, nbytes, flops, desc)


def split_units(torch, cfg, kernel) -> str:
    """The units and chunk size of decode attention's last launch, and the
    units that had rows to read (from the lengths, on the host)."""
    from repro_torch.kernels import decode_attention as da
    kernel()
    units, chunk = da.launch.units
    lens = kernel.args[3].tolist()
    live = sum(max(1, -(-n // chunk)) for n in lens) * cfg.n_kv_heads
    return f"{units} units of {chunk} rows launched, {live} with rows to read"


def phase_legacy_kernels(torch, cfg, timer, bw, peak) -> dict:
    """Flash attention (chunk and recompute shapes) and decode attention
    against their plain versions in f32 and bf16, timed in bf16 beside
    their plain versions and a masked ``scaled_dot_product_attention`` (the
    yardstick; the port never calls it)."""
    record = {}
    for kname, case in (("flash_attention", "chunk"),
                        ("flash_attention", "recompute"),
                        ("decode_attention", "decode")):
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            kernel, plain, lib, lib_out, nbytes, flops, desc = legacy_case(
                torch, cfg, case, dtype)
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            errs[dtype] = check_close(
                f"{kname} [{case}] {dtype}", got, want,
                F32_TOL if dtype == torch.float32 else BF16_TOL)
        check_close(f"sdpa yardstick {kname} [{case}]", lib_out(lib()), want,
                    LIB_TOL)
        ms, plain_ms, lib_ms = timer(kernel), timer(plain), timer(lib)
        t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
        if kname == "flash_attention":
            log(f"flash_attention [{case}] schedule: "
                f"{flash_schedule(torch, kernel)}; {flops / ms / 1e9:.1f} "
                f"TFLOP/s achieved; host {host_us(torch, kernel):.2f} us per "
                f"call (the wrapper, device kept busy)")
        if kname == "decode_attention":
            units = split_units(torch, cfg, kernel)
            log(f"decode_attention split-KV: {units}; {nbytes / ms / 1e9:.3f}"
                f" TB/s achieved ({nbytes / 1e6:.1f} MB in {ms:.4f} ms; SDPA "
                f"{lib_ms:.4f} ms)")
        log(f"{kname} [{case}] {desc}: max_abs_err f32 "
            f"{errs[torch.float32]:.3e} (tol {F32_TOL[0]} + {F32_TOL[1]}·"
            f"|ref|), bf16 {errs[torch.bfloat16]:.3e} (tol {BF16_TOL[0]} + "
            f"{BF16_TOL[1]}·|ref|)  kernel_ms {ms:.4f}  plain_ms "
            f"{plain_ms:.4f}  sdpa_ms {lib_ms:.4f}  bound_ms "
            f"{max(t_bytes, t_ops):.4f} ({nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP)")
        # the chunk shape stands for flash attention in the kernels line
        if case != "recompute":
            record[kname] = dict(
                shape=desc + ", bf16", max_abs_err=errs[torch.bfloat16],
                max_abs_err_f32=errs[torch.float32], ms=ms,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=lib_ms)
        del kernel, plain, lib, got, want
    return record


def sfu_rate(torch) -> float:
    """Exponentials per second on the card's special-function units: 16 per
    clock per SM at the SM clock's maximum (nvidia-smi)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"special-function units: {SFU_PER_CLOCK_SM}/clock/SM x {sms} SMs x "
        f"{mhz:.0f} MHz (clocks.max.sm)")
    return SFU_PER_CLOCK_SM * sms * mhz * 1e6


def scan_case(torch, cfg, s: int, carried: bool, dtype, seed: int = 17):
    """Selective-scan inputs at a Mamba layer's widths (C = expand x
    d_model, N = d_state) for one slot: x, b, c in ``dtype``, dt = softplus
    of N(-2, 1), a = -(1..N) per channel, d = 1, and for ``carried`` a
    random f32 state.  Returns (args, bytes, exponentials, f32 flops): the
    bytes count x, dt, y, a, b, c, d, h0 and h_final once each."""
    mc = cfg.mamba
    ch, n = mc.expand * cfg.d_model, mc.d_state
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, mean=0.0):
        return torch.randn(shape, generator=gen, device="cuda") + mean
    x = randn(1, s, ch).to(dtype)
    dt = torch.nn.functional.softplus(randn(1, s, ch, mean=-2.0))
    a = -torch.arange(1, n + 1, dtype=torch.float32, device="cuda") \
        .expand(ch, n).contiguous()
    b, c = randn(1, s, n).to(dtype), randn(1, s, n).to(dtype)
    d = torch.ones(ch, device="cuda")
    h0 = randn(1, ch, n) if carried else None
    item = x.element_size()
    nbytes = (2 * s * ch * item + s * ch * 4 + 2 * s * n * item
              + ch * n * 4 * (3 if carried else 2) + ch * 4)
    # per (token, channel, state): dt*a, exp, da*h, (dt*x)*b, +, *c, +
    return (x, dt, a, b, c, d, h0), nbytes, s * ch * n, s * ch * (6 * n + 3)


def phase_ssm_kernels(torch, cfg, timer, bw, sfu) -> dict:
    """The selective scan against its plain version in f32 and bf16 at
    Jamba's widths, timed in bf16; no one PyTorch call computes it."""
    from functools import partial
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda, ssm_scan_ref
    record = {}
    for case, s, carried in (("chunk", 256, True), ("prompt", 513, False)):
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            args, nbytes, exps, flops = scan_case(torch, cfg, s, carried,
                                                  dtype)
            y, h = ssm_scan_cuda(*args)
            want_y, want_h = ssm_scan_ref(*args)
            torch.cuda.synchronize()
            errs[dtype] = check_close(
                f"ssm_scan [{case}] {dtype}", y, want_y,
                SCAN_F32_TOL if dtype == torch.float32 else BF16_TOL)
            check_close(f"ssm_scan [{case}] {dtype} h_final", h, want_h,
                        SCAN_F32_TOL)
        ms = timer(partial(ssm_scan_cuda, *args))
        plain_ms = timer(partial(ssm_scan_ref, *args))
        t_bytes, t_sfu, t_f32 = (nbytes / bw * 1e3, exps / sfu * 1e3,
                                 flops / F32_PEAK * 1e3)
        bound = max(t_bytes, t_sfu, t_f32)
        ch, n = args[2].shape
        desc = (f"x (1, {s}, {ch}), N {n}, "
                + ("carried f32 state" if carried else "zero state"))
        log(f"ssm_scan [{case}] {desc}: max_abs_err f32 "
            f"{errs[torch.float32]:.3e} (tol {SCAN_F32_TOL[0]} + "
            f"{SCAN_F32_TOL[1]}·|ref|), bf16 {errs[torch.bfloat16]:.3e} (tol "
            f"{BF16_TOL[0]} + {BF16_TOL[1]}·|ref|)  kernel_ms {ms:.4f}  "
            f"plain_ms {plain_ms:.4f}  bound_ms {bound:.4f} (bytes "
            f"{nbytes / 1e6:.1f} MB {t_bytes:.4f} ms, exponentials "
            f"{exps / 1e6:.1f} M {t_sfu:.4f} ms, f32 {flops / 1e9:.3f} GFLOP "
            f"{t_f32:.4f} ms)")
        # the chunk shape stands for the scan in the kernels line
        if case == "chunk":
            record["ssm_scan"] = dict(
                shape=desc + ", bf16 x/b/c", max_abs_err=errs[torch.bfloat16],
                max_abs_err_f32=errs[torch.float32], ms=ms, plain_ms=plain_ms,
                bound_ms=bound,
                bound_by="bytes" if t_bytes >= max(t_sfu, t_f32)
                else "operations", library_ms=None)
        del args, y, h, want_y, want_h
    return record


def paged_case(torch, cfg, dtype, seed: int = 19):
    """``decode_case``'s 8 rows (the serve phase's prompt lengths + 16) read
    through a page table: a pool of 8 x 64 pages of 16 rows, each row's
    pages drawn without repeats from a shuffled pool (numpy seed), tables
    (8, 64) padded with -1.  Returns (args, bytes, flops, description): the
    bytes count q, out, the attended K/V rows, the tables and lengths."""
    kv, hd, h = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_heads
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    lens = np.random.default_rng(0).integers(16, 601, 8) + 16
    maxp = 1024 // PAGE
    pool = np.random.default_rng(seed).permutation(8 * maxp)
    table = np.full((8, maxp), -1, np.int32)
    used = 0
    for i, n in enumerate(-(-lens // PAGE)):
        table[i, :n] = pool[used:used + n]
        used += n
    q = randn(8, h, hd)
    kp, vp = randn(8 * maxp, PAGE, kv, hd), randn(8 * maxp, PAGE, kv, hd)
    args = (q, kp, vp, torch.tensor(table, device="cuda"),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))
    item = q.element_size()
    nbytes = (int(lens.sum()) * kv * hd * 2 * item + 2 * q.numel() * item
              + table.size * 4 + 8 * 4)
    desc = (f"q (8, {h}, {hd}), pools ({8 * maxp}, {PAGE}, {kv}, {hd}), "
            f"tables (8, {maxp}) with -1 padding, cache_len {lens.tolist()}")
    return args, nbytes, int(lens.sum()) * h * hd * 4, desc


def phase_paged(torch, cfg, timer, bw, peak) -> tuple[dict, int]:
    """Paged decode attention: one launch through ``ops`` from 0 counts,
    then the kernel against its plain version in f32 and bf16, timed in
    bf16 beside it.  No one PyTorch call gathers through a page table.
    Returns (record, launches)."""
    from functools import partial
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention_cuda, paged_decode_attention_ref)
    args, nbytes, flops, desc = paged_case(torch, cfg, torch.bfloat16)
    zero_counts()
    ops.paged_decode_attention(*args)
    torch.cuda.synchronize()
    launches = read_counts()["paged_decode_attention"]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        args, nbytes, flops, desc = paged_case(torch, cfg, dtype)
        got = paged_decode_attention_cuda(*args)
        want = paged_decode_attention_ref(*args)
        torch.cuda.synchronize()
        errs[dtype] = check_close(
            f"paged_decode_attention {dtype}", got, want,
            F32_TOL if dtype == torch.float32 else BF16_TOL)
    ms = timer(partial(paged_decode_attention_cuda, *args))
    plain_ms = timer(partial(paged_decode_attention_ref, *args))
    t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
    units, chunk = da.launch.units
    log(f"paged_decode_attention route: the split-KV unit's paged form "
        f"(csrc/attn_decode.cuh through csrc/decode_attention.cu's "
        f"repro_paged_decode_attention), {units} units of {chunk} rows")
    log(f"paged_decode_attention {desc}: launches through ops {launches}, "
        f"max_abs_err f32 {errs[torch.float32]:.3e} (tol {F32_TOL[0]} + "
        f"{F32_TOL[1]}·|ref|), bf16 {errs[torch.bfloat16]:.3e} (tol "
        f"{BF16_TOL[0]} + {BF16_TOL[1]}·|ref|)  kernel_ms {ms:.4f}  plain_ms "
        f"{plain_ms:.4f}  bound_ms {max(t_bytes, t_ops):.4f} "
        f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    if launches != 1:
        raise AssertionError(f"paged: ops launched the kernel {launches} "
                             "times, not once")
    return dict(shape=desc + ", bf16", max_abs_err=errs[torch.bfloat16],
                max_abs_err_f32=errs[torch.float32], ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None), launches


def overlap_case(torch, cfg, dtype, seed: int = 23):
    """The O projection of a 1024-token nano-batch, x (1024, d_model) @ w
    (d_model, d_model), beside decode attention of 64 rows over (64, 1024,
    KV, D) caches, lengths uniform in [1, 1024] (numpy seed).  Returns
    (args, gemm (bytes, flops), attention (bytes, flops), description)."""
    kv, hd, h, dm = (cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_heads,
                     cfg.d_model)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)
    m, b, s = 1024, 64, 1024
    lens = np.random.default_rng(seed).integers(1, s + 1, b)
    x, w = randn(m, dm), randn(dm, dm, scale=dm ** -0.5)
    q, k, v = randn(b, h, hd), randn(b, s, kv, hd), randn(b, s, kv, hd)
    args = (x, w, q, k, v,
            torch.tensor(lens, dtype=torch.int32, device="cuda"))
    item = x.element_size()
    gemm = ((m * dm + dm * dm + m * dm) * item, 2 * m * dm * dm)
    attn = (int(lens.sum()) * kv * hd * 2 * item + 2 * q.numel() * item
            + b * 4, int(lens.sum()) * h * hd * 4)
    desc = (f"x ({m}, {dm}) @ w ({dm}, {dm}) beside q ({b}, {h}, {hd}) over "
            f"caches ({b}, {s}, {kv}, {hd}), {int(lens.sum())} rows attended")
    return args, gemm, attn, desc


def phase_overlap(torch, cfg, timer, bw, peak) -> tuple[dict, int]:
    """The fused op: one launch through ``ops`` from 0 counts; the kernel
    against its plain version in f32 and bf16; the gemm_fraction sweep in
    bf16 (outputs bitwise equal at every fraction; CTAs and time at each);
    the bounds by arithmetic; the library pair and the port's decode
    attention alone on the same inputs.  Returns (record, launches)."""
    from functools import partial
    from repro_torch.kernels import fused_overlap as fo
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.fused_overlap import (fused_overlap_cuda,
                                                   fused_overlap_ref)
    F = torch.nn.functional
    args, gemm, attn, desc = overlap_case(torch, cfg, torch.bfloat16)
    zero_counts()
    ops.fused_overlap(*args, gemm_fraction=0.5)
    torch.cuda.synchronize()
    launches = read_counts()["fused_overlap"]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        args, gemm, attn, desc = overlap_case(torch, cfg, dtype)
        (go, ao), (wg, wa) = fused_overlap_cuda(*args), fused_overlap_ref(*args)
        torch.cuda.synchronize()
        f32 = dtype == torch.float32
        errs[dtype] = (
            check_close(f"fused_overlap gemm {dtype}", go, wg,
                        GEMM_F32_TOL if f32 else BF16_TOL),
            check_close(f"fused_overlap attention {dtype}", ao, wa,
                        F32_TOL if f32 else BF16_TOL))
        del go, ao, wg, wa
        if f32:
            del args
            torch.cuda.empty_cache()
    first, sweep = None, []
    for frac in OVERLAP_FRACTIONS:
        outs = fused_overlap_cuda(*args, gemm_fraction=frac)
        sched = fused_overlap_cuda.schedule
        if first is None:
            first = outs
        if not all(torch.equal(a, b) for a, b in zip(outs, first)):
            raise AssertionError(f"fused_overlap: outputs at gemm_fraction "
                                 f"{frac} differ from {OVERLAP_FRACTIONS[0]}")
        ms = timer(partial(fused_overlap_cuda, *args, gemm_fraction=frac))
        sweep.append((frac, sched, ms))
        log(f"fused_overlap sweep: gemm_fraction {frac}: {sched[0]} CTAs "
            f"({sched[2]} per SM), {sched[1]} GEMM + {sched[0] - sched[1]} "
            f"attention, kernel_ms {ms:.4f}, outputs bitwise equal")
    x, w, q, k, v, clen = args
    mask = torch.arange(k.shape[1], device="cuda")[None, :] < clen[:, None]
    lib_q, lib_k, lib_v = (q[:, :, None], k.transpose(1, 2).contiguous(),
                           v.transpose(1, 2).contiguous())

    def sdpa():
        return F.scaled_dot_product_attention(
            lib_q, lib_k, lib_v, attn_mask=mask[:, None, None, :],
            enable_gqa=True)

    def library():
        return torch.matmul(x, w), sdpa()
    lg, la = library()
    check_close("library pair gemm", lg, first[0], LIB_TOL)
    check_close("library pair attention", la[:, :, 0], first[1], LIB_TOL)
    lib_ms = timer(library)
    mm_ms, sdpa_ms = timer(partial(torch.matmul, x, w)), timer(sdpa)
    decode_ms = timer(partial(decode_attention_cuda, q, k, v, clen))
    # each role alone on every CTA of the same kernel: the other side empty
    gemm_only = (x, w, q[:0], k[:0], v[:0], clen[:0])
    attn_only = (x[:0], w, q, k, v, clen)
    gemm_only_ms = timer(partial(fused_overlap_cuda, *gemm_only))
    attn_only_ms = timer(partial(fused_overlap_cuda, *attn_only))
    fused_overlap_cuda(*attn_only)
    units, chunk = fo.launch.units
    plain_ms = timer(partial(fused_overlap_ref, *args))
    ms = dict((f, t) for f, _, t in sweep)[0.5]
    t_gemm = max(gemm[0] / bw, gemm[1] / peak) * 1e3
    t_attn = max(attn[0] / bw, attn[1] / peak) * 1e3
    t_bytes = (gemm[0] + attn[0]) / bw * 1e3
    t_ops = (gemm[1] + attn[1]) / peak * 1e3
    best = min(sweep, key=lambda r: r[2])
    log(f"fused_overlap {desc}: launches through ops {launches}; max_abs_err "
        f"f32 gemm {errs[torch.float32][0]:.3e} (tol {GEMM_F32_TOL[0]} + "
        f"{GEMM_F32_TOL[1]}·|ref|) attention {errs[torch.float32][1]:.3e} (tol"
        f" {F32_TOL[0]} + {F32_TOL[1]}·|ref|), bf16 gemm "
        f"{errs[torch.bfloat16][0]:.3e} attention {errs[torch.bfloat16][1]:.3e}"
        f" (tol {BF16_TOL[0]} + {BF16_TOL[1]}·|ref|)")
    log(f"fused_overlap: kernel_ms {ms:.4f} at gemm_fraction 0.5, best "
        f"{best[2]:.4f} at {best[0]}; plain_ms {plain_ms:.4f}; bound_ms "
        f"overlapped {max(t_bytes, t_ops):.4f} (bytes {t_bytes:.4f}: GEMM "
        f"{gemm[0] / 1e6:.1f} MB + attention {attn[0] / 1e6:.1f} MB; "
        f"operations {t_ops:.4f}: {(gemm[1] + attn[1]) / 1e9:.2f} GFLOP), "
        f"sequential {t_gemm + t_attn:.4f} (GEMM {t_gemm:.4f} + attention "
        f"{t_attn:.4f}); library pair (torch.matmul then masked SDPA, one "
        f"stream) {lib_ms:.4f} = matmul {mm_ms:.4f} + sdpa {sdpa_ms:.4f} "
        f"alone; the port's decode attention alone {decode_ms:.4f}; the "
        f"fused kernel's GEMM role alone (B = 0, all CTAs) {gemm_only_ms:.4f}, "
        f"its attention role alone (M = 0, all CTAs) {attn_only_ms:.4f}")
    roles = gemm_only_ms + attn_only_ms
    log(f"fused_overlap attention role alone: {units} units of {chunk} rows, "
        f"{attn[0] / attn_only_ms / 1e9:.3f} TB/s achieved "
        f"({attn[0] / 1e6:.1f} MB in {attn_only_ms:.4f} ms; SDPA alone "
        f"{attn[0] / sdpa_ms / 1e9:.3f} TB/s by the same bytes); sweep "
        f"minimum {best[2]:.4f} at {best[0]} vs the roles alone back to back "
        f"{roles:.4f} ({gemm_only_ms:.4f} + {attn_only_ms:.4f}): "
        + ("below, the overlap pays" if best[2] < roles
           else "not below, no overlap"))
    if launches != 1:
        raise AssertionError(f"overlap: ops launched the kernel {launches} "
                             "times, not once")
    return dict(shape=desc + ", bf16, gemm_fraction 0.5",
                max_abs_err=max(errs[torch.bfloat16]),
                max_abs_err_f32=max(errs[torch.float32]), ms=ms,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=lib_ms), launches


def group_configs():
    """The attention shapes the served models give the kernels beyond
    Qwen3-8B's group 4: (group, config whose heads the attention cases
    read, its head_dim, the kernels held there).  Group 7 at Arctic's
    heads (56 / 8, the port's copy of its config) in every kernel; groups
    3 (24 / 8) and 9 (36 / 4) on Qwen3-8B's other fields, and group 1 at
    MusicGen-medium's heads (24 / 24, head_dim 64), in packed, flash and
    decode attention; group 8 at Jamba's attention layer (64 / 8) in the
    int8 build of packed attention (the hybrid's int8 KV)."""
    from repro_torch.configs import get_config
    qwen = get_config("qwen3-8b")
    steps = ("packed_attention", "flash_attention", "decode_attention")
    return [(7, get_config(ARCTIC), 128,
             (*ATTENTION, "flash_attention", "decode_attention",
              "paged_decode_attention", "fused_overlap")),
            (3, dataclasses.replace(qwen, n_heads=24, n_kv_heads=8), 128,
             steps),
            (9, dataclasses.replace(qwen, n_heads=36, n_kv_heads=4), 128,
             steps),
            (1, get_config(MUSICGEN), 64, steps),
            (8, get_config(JAMBA), 128, ("packed_attention_quant",))]


def phase_groups(torch, timer, bw, peak) -> dict:
    """The attention kernels at ``group_configs``' shapes against their
    plain versions in f32 and bf16, at the kernels phase's shapes: at
    group 7 (Arctic's heads) packed attention in its four builds, decode,
    paged decode, flash (the chunk shape) and the fused op's attention
    role, each timed in bf16 beside its plain version, its bound and
    (where one call computes it) masked SDPA; at groups 3, 9 and 1
    (head_dim 64) packed attention, decode and flash; at group 8 the int8
    build of packed attention.  Returns {kernel: groups held}."""
    from functools import partial
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention_cuda, paged_decode_attention_ref)
    from repro_torch.kernels.fused_overlap import (fused_overlap_cuda,
                                                   fused_overlap_ref)
    from repro_torch.kernels.packed_attention import (packed_attention_cuda,
                                                      packed_attention_ref)
    F = torch.nn.functional
    held = {}

    def report(kname, g, desc, errs, timed=None):
        held.setdefault(kname, []).append(g)
        line = (f"group {g} {kname} {desc}: max_abs_err f32 "
                f"{errs[torch.float32]:.3e} (tol {F32_TOL[0]} + "
                f"{F32_TOL[1]}·|ref|), bf16 {errs[torch.bfloat16]:.3e} (tol "
                f"{BF16_TOL[0]} + {BF16_TOL[1]}·|ref|)")
        if timed is not None:
            kernel, plain, lib, nbytes, flops = timed
            ms, plain_ms = timer(kernel), timer(plain)
            lib_ms = timer(lib) if lib is not None else None
            t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
            line += (f"  kernel_ms {ms:.4f}  plain_ms {plain_ms:.4f}  "
                     + (f"sdpa_ms {lib_ms:.4f}  " if lib is not None else "")
                     + f"bound_ms {max(t_bytes, t_ops):.4f} "
                     f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        log(line)

    def tol(dtype):
        return F32_TOL if dtype == torch.float32 else BF16_TOL

    for g, gcfg, hd, kernels in group_configs():
        if gcfg.gqa_group != g or gcfg.resolved_head_dim != hd:
            raise AssertionError(f"group {g}: config {gcfg.name} has group "
                                 f"{gcfg.gqa_group}, head_dim "
                                 f"{gcfg.resolved_head_dim}")
        heads = f"H={gcfg.n_heads} KV={gcfg.n_kv_heads} D={hd}"
        # packed attention, contiguous: the kernels phase's mixed stream
        if "packed_attention" in kernels:
            errs = {}
            for dtype in (torch.float32, torch.bfloat16):
                args, nbytes, flops = attention_case(torch, gcfg, 1024, 1024,
                                                     dtype)
                errs[dtype] = check_close(
                    f"group {g} packed_attention {dtype}",
                    packed_attention_cuda(*args, kv_bucket=1024),
                    packed_attention_ref(*args, kv_bucket=1024), tol(dtype))
            timed = None
            if g == 7:
                sq, sk, sv, mask = sdpa_inputs(torch, args, 1024)

                def lib():
                    return F.scaled_dot_product_attention(
                        sq, sk, sv, attn_mask=mask, enable_gqa=True)
                check_close("group 7 sdpa yardstick",
                            lib()[0].permute(1, 0, 2),
                            packed_attention_ref(*args, kv_bucket=1024),
                            LIB_TOL)
                timed = (partial(packed_attention_cuda, *args,
                                 kv_bucket=1024),
                         partial(packed_attention_ref, *args,
                                 kv_bucket=1024), lib, nbytes, flops)
            report("packed_attention", g, f"T={args[0].shape[0]} {heads} "
                   f"kv_bucket=1024; {streamed_mb(args, {}, 1024)}", errs,
                   timed)
            del args
        # the other three builds (timed at group 7)
        for kname, ((blocked, quant), _) in ATTENTION.items():
            if kname not in kernels or not (blocked or quant):
                continue
            errs = {}
            for dtype in (torch.float32, torch.bfloat16):
                args, kw, nbytes, flops = variant_case(torch, gcfg, 1024,
                                                       dtype, blocked, quant)
                errs[dtype] = check_close(
                    f"group {g} {kname} {dtype}",
                    packed_attention_cuda(*args, kv_bucket=1024, **kw),
                    packed_attention_ref(*args, kv_bucket=1024, **kw),
                    tol(dtype))
            report(kname, g, f"T={args[0].shape[0]} {heads} kv_bucket=1024",
                   errs, (partial(packed_attention_cuda, *args,
                                  kv_bucket=1024, **kw),
                          partial(packed_attention_ref, *args,
                                  kv_bucket=1024, **kw), None, nbytes,
                          flops) if g == 7 else None)
            del args, kw
        # flash (the chunk shape) and decode attention
        for kname, case in (("flash_attention", "chunk"),
                            ("decode_attention", "decode")):
            if kname not in kernels:
                continue
            errs = {}
            for dtype in (torch.float32, torch.bfloat16):
                kernel, plain, lib, lib_out, nbytes, flops, desc = \
                    legacy_case(torch, gcfg, case, dtype)
                want = plain()
                errs[dtype] = check_close(f"group {g} {kname} {dtype}",
                                          kernel(), want, tol(dtype))
            timed = None
            if g == 7:
                check_close(f"group 7 sdpa yardstick {kname}",
                            lib_out(lib()), want, LIB_TOL)
                timed = (kernel, plain, lib, nbytes, flops)
            extra = (f"; schedule {flash_schedule(torch, kernel)}"
                     if kname == "flash_attention" else
                     f"; {split_units(torch, gcfg, kernel)}")
            report(kname, g, desc + extra, errs, timed)
            del kernel, plain, lib, want
        if g != 7:
            continue
        # paged decode and the fused op's attention role at group 7
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            args, nbytes, flops, desc = paged_case(torch, gcfg, dtype)
            errs[dtype] = check_close(
                f"group 7 paged_decode_attention {dtype}",
                paged_decode_attention_cuda(*args),
                paged_decode_attention_ref(*args), tol(dtype))
        report("paged_decode_attention", g, desc, errs,
               (partial(paged_decode_attention_cuda, *args),
                partial(paged_decode_attention_ref, *args), None, nbytes,
                flops))
        del args
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            args, _, attn, desc = overlap_case(torch, gcfg, dtype)
            (go, ao), (wg, wa) = (fused_overlap_cuda(*args),
                                  fused_overlap_ref(*args))
            check_close(f"group 7 fused_overlap gemm {dtype}", go, wg,
                        GEMM_F32_TOL if dtype == torch.float32 else BF16_TOL)
            errs[dtype] = check_close(f"group 7 fused_overlap attention "
                                      f"{dtype}", ao, wa, tol(dtype))
            del go, ao, wg, wa
        # the attention role alone (M = 0, every CTA), against decode
        # attention's plain version on the same rows
        x, w, q, k, v, clen = args
        from repro_torch.kernels.decode_attention import decode_attention_ref
        report("fused_overlap", g, desc + " (timed: the attention role "
               "alone, M = 0)", errs,
               (partial(fused_overlap_cuda, x[:0], w, q, k, v, clen),
                partial(decode_attention_ref, q, k, v, clen), None,
                attn[0], attn[1]))
        del args, x, w, q, k, v
        torch.cuda.empty_cache()
    return held


def phase_kernels(torch, cfg, timer, bw, peak):
    from repro_torch.kernels.packed_attention import (packed_attention_cuda,
                                                      packed_attention_ref)
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
        log(f"packed_attention bucket={bucket}: {streamed_mb(args, {}, bucket)}")
        if bucket == 1024:
            record["packed_attention"] = dict(
                shape=f"T={args[0].shape[0]} (8 decode + 200 + 37 prefill), "
                      f"H=32 KV=8 D=128, kv_bucket={bucket}, bf16",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=lib_ms)

    # ---- the int8, block-table and block-table + int8 variants --------------
    for kname, ((blocked, quant), _) in ATTENTION.items():
        if not (blocked or quant):
            continue
        # f32 q (and f32 caches, or the same int8 caches): a table, scale or
        # masking error shows far above the f32 tolerance
        args32, kw32, _, _ = variant_case(torch, cfg, 1024, torch.float32,
                                          blocked, quant)
        err32 = check_close(f"{kname} f32",
                            packed_attention_cuda(*args32, kv_bucket=1024,
                                                  **kw32),
                            packed_attention_ref(*args32, kv_bucket=1024,
                                                 **kw32), F32_TOL)
        del args32, kw32
        args, kw, nbytes, flops = variant_case(torch, cfg, 1024,
                                               torch.bfloat16, blocked, quant)
        got = packed_attention_cuda(*args, kv_bucket=1024, **kw)
        want = packed_attention_ref(*args, kv_bucket=1024, **kw)
        torch.cuda.synchronize()
        err = check_close(f"{kname} bf16", got, want)
        ms = timer(lambda: packed_attention_cuda(*args, kv_bucket=1024, **kw))
        plain_ms = timer(lambda: packed_attention_ref(*args, kv_bucket=1024,
                                                      **kw))
        t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
        log(f"{kname} T={args[0].shape[0]} bucket=1024: max_abs_err f32 "
            f"{err32:.3e} (tol {F32_TOL[0]} + {F32_TOL[1]}·|ref|), bf16 q "
            f"{err:.3e} (tol {BF16_TOL[0]} + {BF16_TOL[1]}·|ref|)  kernel_ms "
            f"{ms:.4f}  plain_ms {plain_ms:.4f}  bound_ms "
            f"{max(t_bytes, t_ops):.4f} ({nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP)")
        log(f"{kname}: {streamed_mb(args, kw, 1024)}")
        record[kname] = dict(
            shape=f"T={args[0].shape[0]} (8 decode + 200 + 37 prefill), H=32 "
                  f"KV=8 D=128, kv_bucket=1024, bf16 q, "
                  + ("int8 K/V + f32 scales" if quant else "bf16 K/V")
                  + (f", shuffled block table (block {KV_BLOCK})"
                     if blocked else ""),
            max_abs_err=err, max_abs_err_f32=err32, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None)
        del args, kw, got, want

    # ---- SwiGLU ------------------------------------------------------------
    record["swiglu"] = phase_swiglu(torch, cfg, timer, bw, peak)
    return record


def swiglu_case(torch, d: int, ff: int, seed: int = 7):
    """SwiGLU's weights at (d, ff), seeded on the card, and the library pair
    (``torch.matmul`` twice, then ``F.silu(g) * u``, on one stream): the
    yardstick one PyTorch call per piece gives for the same function."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(seed)
    wg = (torch.randn(d, ff, generator=gen, device="cuda") / d ** 0.5) \
        .to(torch.bfloat16)
    wu = (torch.randn(d, ff, generator=gen, device="cuda") / d ** 0.5) \
        .to(torch.bfloat16)

    def library(x):
        return F.silu(torch.matmul(x, wg)) * torch.matmul(x, wu)
    return gen, wg, wu, library


def phase_swiglu(torch, cfg, timer, bw, peak) -> dict:
    """SwiGLU (bf16) at Qwen3-8B's widths for T = 8, 64, 256 and 257, and
    for T = 8 and 256 at Jamba-1.5-Large's (8192 -> 24576), Arctic's dense
    residual's (7168 -> 4864), LLaMA-2-70B's (8192 -> 28672) and
    LLaVA-NeXT-34B's (7168 -> 20480): kernel
    against plain, its schedule (``swiglu.plan``), its time beside the
    plain version's, the library pair's and the bound.  Returns the record
    at Qwen3-8B's T = 256."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import swiglu as sw
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    record = None
    widths = [((cfg.d_model, cfg.d_ff), (8, 64, 256, 257))] + [
        ((c.d_model, c.d_ff), (8, 256))
        for c in (get_config(n) for n in (JAMBA, ARCTIC, LLAMA, LLAVA))]
    for i, ((d, ff), ts) in enumerate(widths):
        gen, wg, wu, library = swiglu_case(torch, d, ff)
        for t in ts:
            x = torch.randn(t, d, generator=gen, device="cuda") \
                .to(torch.bfloat16)
            got = sw.swiglu_cuda(x, wg, wu)
            want = sw.swiglu_ref(x, wg, wu)
            torch.cuda.synchronize()
            err = check_close(f"swiglu T={t} ({d}x{ff})", got, want)
            check_close(f"swiglu library pair T={t} ({d}x{ff})", library(x),
                        want, LIB_TOL)
            ms = timer(lambda: sw.swiglu_cuda(x, wg, wu))
            plain_ms = timer(lambda: sw.swiglu_ref(x, wg, wu))
            lib_ms = timer(lambda: library(x))
            nbytes = (t * d + 2 * d * ff + t * ff) * 2
            flops = 4 * t * d * ff
            t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
            bm, bn, groups = sw.plan(t, ff, sms)
            log(f"swiglu T={t} ({d}x{ff}): max_abs_err {err:.3e} (tol "
                f"{BF16_TOL[0]} + {BF16_TOL[1]}·|ref|)  kernel_ms {ms:.4f}  "
                f"plain_ms {plain_ms:.4f}  library_ms {lib_ms:.4f} (2 matmul "
                f"+ silu·mul)  bound_ms {max(t_bytes, t_ops):.4f} "
                f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)  "
                f"{nbytes / ms / 1e9:.3f} TB/s, {flops / ms / 1e9:.1f} TFLOP/s;"
                f" {bm}x{bn} tiles{' (swap AB)' if bm < 128 else ''}, "
                f"{groups} groups x {-(-t // bm)} CTAs (whole strips of {bn} "
                f"columns)")
            if (i, t) == (0, 256):
                record = dict(
                    shape=f"x ({t},{d}) x ({d},{ff}) twice, bf16",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    library_ms=lib_ms)
            del x, got, want
        del wg, wu, library
        torch.cuda.empty_cache()
    return record


def forward_streams(cfg) -> tuple[list, np.ndarray, np.ndarray]:
    """The forward checks' two packed streams, (tokens, slot, position,
    write row) each: a prefill stream of 8 x 25 tokens padded to 256 (its
    padding written to row 64, past a 64-row cache), then 8 decode
    tokens; with the slot and position of the 208 real tokens."""
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
    return (streams, np.r_[pre_slot, np.arange(8)],
            np.r_[pre_pos, np.full(8, 25)])


def phase_forward(torch, cfg):
    """Full width, 4 layers: ``forward_streams`` through the kernels and
    the plain versions, each with its own cache."""
    from repro_torch.models import model
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    params = model.init(cfg4, seed=0, device="cuda")
    streams, _, _ = forward_streams(cfg)
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
            outs.append(lg[0, :200] if len(toks) == 256 else lg[0])
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


def _counted():
    from repro_torch.kernels.decode_attention import (
        decode_attention_cuda, paged_decode_attention_cuda)
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.fused_overlap import fused_overlap_cuda
    from repro_torch.kernels.mla_attention import mla_attention_cuda
    from repro_torch.kernels.packed_attention import packed_attention_cuda
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda
    from repro_torch.kernels.swiglu import swiglu_cuda
    return (packed_attention_cuda, {"swiglu": swiglu_cuda,
                                    "flash_attention": flash_attention_cuda,
                                    "decode_attention": decode_attention_cuda,
                                    "ssm_scan": ssm_scan_cuda,
                                    "paged_decode_attention":
                                        paged_decode_attention_cuda,
                                    "fused_overlap": fused_overlap_cuda,
                                    "mla_attention": mla_attention_cuda})


def zero_counts() -> None:
    """Set every kernel's launch count to 0 (before a main-path run)."""
    packed, single = _counted()
    for kname in packed.launches:
        packed.launches[kname] = 0
    for fn in single.values():
        fn.launches = 0


def read_counts() -> dict:
    packed, single = _counted()
    return dict(packed.launches,
                **{kname: fn.launches for kname, fn in single.items()})


def check_off_path(tag: str, counts: dict, also=()) -> None:
    """The kernels that only their ``ops`` entries call never launch on a
    serve path, nor do the kernels named in ``also``."""
    if any(counts[kname] for kname in (*OPS_ONLY, *also)):
        raise AssertionError(f"{tag}: a kernel off this path launched: "
                             f"{counts}")


def phase_serve(torch, cfg):
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
    prompts = serve_prompts(cfg)
    lens = [len(p) for p in prompts]
    # the main path's run: counts from 0
    zero_counts()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=32))
    done = eng.run()
    torch.cuda.synchronize()
    counts = read_counts()
    check_off_path("serve", counts)
    launches = {k: counts[k] for k in ("packed_attention", "swiglu")}
    s = eng.stats
    log(f"serve: prompts {lens}, {len(done)}/8 finished, "
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

    outs = {r.rid: r.output for r in done}
    check_teacher_forced(torch, "serve", cfg, params, outs, prompts)
    return launches, params, prompts, s.wall_time, outs


def phase_profile(torch, cfg, params, prompts, serve_wall: float,
                  tag: str = "profile", waves: int = 1,
                  cross_check: bool = False, **engine_kw):
    """Where a serve's device time goes: the same requests on a fresh
    engine (``engine_kw`` on top of the serve's configuration) under
    ``torch.profiler``, summing the device's own events (kernels and
    copies).  The profiler stretches the host's wall clock, so the busy
    share is also given against the unprofiled serve's wall.  ``waves=2``
    serves the first request alone, then the rest (the shared-prefix
    phase); ``cross_check`` also sums the device time through the
    profiler's public ``key_averages`` (~45 s for 250k events) and fails
    unless the two sums agree within 1%.  Returns (device busy ms, packed
    attention's, SwiGLU's and the library GEMMs' ms), or None when the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.request import Request
    eng = ServeEngine(cfg, params, EngineConfig(
        **dict(dict(max_slots=8, max_len=1024, async_depth=0), **engine_kw)))
    batches = [prompts[:1], prompts[1:]] if waves == 2 else [prompts]
    # device activity only: the host's op events would multiply the
    # profiler's post-processing, and the busy share needs none of them
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rid = 0
        for batch in batches:
            for p in batch:
                eng.submit(Request(rid=rid, prompt=p, max_new_tokens=32))
                rid += 1
            eng.run()
        torch.cuda.synchronize()
        t_stop = time.perf_counter()
    return device_time(prof, t_stop, eng.stats, tag, serve_wall, cross_check)


def device_time(prof, t_stop: float, stats, tag: str,
                serve_wall: Optional[float] = None,
                cross_check: bool = False):
    """``phase_profile``'s sums over a finished profile ``prof`` of a serve
    whose engine stats are ``stats``: the device's busy time, its share of
    the profiled wall (and of ``serve_wall``, an unprofiled run's, when
    given), device events per iteration, the port's kernels' and cuBLAS's
    shares and the costliest kernels, logged under ``tag``.  Returns what
    ``phase_profile`` returns."""
    from torch.autograd import DeviceType
    # the device's events straight from the trace (a private attribute of
    # the profiler), summed by name: building the profiler's per-event
    # objects for ~250k events takes most of a minute, so ``cross_check``
    # does it once per kind of engine
    totals = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            us, n = totals.get(e.name(), (0.0, 0))
            totals[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    log(f"{tag}: profiler stop and post-processing "
        f"{time.perf_counter() - t_stop:.1f} s")
    dev_us = sum(us for us, _ in totals.values())
    if cross_check:
        ka = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        log(f"{tag}: the same device time through key_averages: "
            f"{ka / 1e3:.1f} ms (trace events {dev_us / 1e3:.1f} ms)")
        if abs(ka - dev_us) > 0.01 * max(ka, dev_us):
            raise AssertionError(f"{tag}: the trace's device time "
                                 f"{dev_us / 1e3:.1f} ms disagrees with "
                                 f"key_averages' {ka / 1e3:.1f} ms")
    wall_us = stats.wall_time * 1e6
    if dev_us == 0:
        log(f"{tag}: the profiler saw no device time")
        return None
    pa_us = sum(us for name, (us, _) in totals.items()
                if "packed_attention" in name)
    sw_us = sum(us for name, (us, _) in totals.items() if "swiglu" in name)
    fa_us = sum(us for name, (us, _) in totals.items()
                if "flash_bf16_kernel" in name)
    lib_us = sum(us for name, (us, _) in totals.items()
                 if any(k in name.lower() for k in LIBRARY_GEMMS)
                 and not any(k in name for k in OUR_KERNELS))
    mla_us = sum(us for name, (us, _) in totals.items() if "mla_" in name)
    scan = [(us, n) for name, (us, n) in totals.items()
            if "ssm_scan" in name]
    scan_us, scan_n = sum(us for us, _ in scan), sum(n for _, n in scan)
    log(f"{tag}: device busy {dev_us / 1e3:.1f} ms over "
        f"{stats.iterations} iterations: {dev_us / wall_us:.3f} of the "
        f"profiled wall ({wall_us / 1e3:.1f} ms, idle share "
        f"{1 - dev_us / wall_us:.3f})"
        + (f", {dev_us / 1e6 / serve_wall:.3f} of the unprofiled serve's "
           f"wall ({serve_wall * 1e3:.1f} ms)" if serve_wall else "")
        + "; "
        f"{sum(n for _, n in totals.values()) / stats.iterations:.0f} device "
        f"events per iteration; packed attention {pa_us / 1e3:.1f} ms = "
        f"{pa_us / dev_us:.3f} of the busy time; SwiGLU {sw_us / 1e3:.1f} ms "
        f"= {sw_us / dev_us:.3f}; library GEMMs (cuBLAS) {lib_us / 1e3:.1f} "
        f"ms = {lib_us / dev_us:.3f}; flash attention (bf16) "
        f"{fa_us / 1e3:.1f} ms = {fa_us / dev_us:.3f}"
        + (f"; MLA latent attention {mla_us / 1e3:.1f} ms = "
           f"{mla_us / dev_us:.3f}" if mla_us else "")
        + (f"; ssm_scan {scan_us / 1e3:.3f} ms = {scan_us / dev_us:.4f} of "
           f"the busy time over {scan_n} launches "
           f"({scan_us / scan_n:.1f} us each)" if scan_n else ""))
    # the twelve costliest, and the port's own kernels wherever they rank
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][0])
    ours = ("packed_attention", "flash_bf16_kernel", "swiglu_bf16",
            "ssm_scan_kernel", "decode_attention", "mla_")
    for name, (us, n) in ranked[:12] + [
            kv for kv in ranked[12:] if any(k in kv[0] for k in ours)]:
        log(f"{tag}:   {us / 1e3:9.2f} ms {us / dev_us:6.3f}  x{n:<6d} "
            f"{name[:90]}")
    return dev_us / 1e3, pa_us / 1e3, sw_us / 1e3, lib_us / 1e3


def stream_ids(torch, cfg, seq: list):
    """A token stream as the engine feeds it: (1, n) int32 ids on the card,
    the audio stub's repeated across its codebooks, (1, n, K)."""
    ids = torch.tensor([seq], dtype=torch.int32, device="cuda")
    if cfg.frontend == "audio":
        ids = ids[..., None].expand(*ids.shape, cfg.num_codebooks)
    return ids


def kept_logits(cfg, lg):
    """Logits (..., V) of the token the engine keeps: the audio stub's
    codebook 0 of (..., K, V)."""
    return lg[..., 0, :] if cfg.frontend == "audio" else lg


def teacher_forced(torch, cfg, params, seq: list, kv_dtype=None):
    """Plain-version forward of one whole token stream through a fresh
    one-slot cache (int8 for ``kv_dtype="int8"``): logits (len(seq), V)."""
    from repro_torch.models import model
    n = len(seq)
    pos = torch.arange(n, dtype=torch.int32, device="cuda")
    cache = model.init_cache(cfg, 1, 1024, device="cuda", kv_dtype=kv_dtype)
    lg, _ = model.forward_packed(
        cfg, params, stream_ids(torch, cfg, seq), cache,
        torch.zeros(n, dtype=torch.int32, device="cuda"), pos, pos,
        torch.ones(n, dtype=torch.bool, device="cuda"), kv_bucket=1024,
        impl="plain")
    return kept_logits(cfg, lg[0]).float()


# the plain forwards a served request is teacher-forced through, by the
# step whose formulas they share: the packed step's (``forward_packed``
# through a one-slot cache), the prefill's (``forward_full``: a recurrent
# layer's conv as shifted multiply-adds, where the steps run it token by
# token) and the legacy step's (``prefill`` of the prompt, then one
# ``forward_decode`` per served token)
FORMULAS = {"packed": "forward", "full": "forward_full",
            "steps": "prefill + decode"}


def served_logits(torch, cfg, params, prompt: list, out: list,
                  formulas: str = "packed", kv_dtype=None):
    """Plain-version logits (len(out), V) in f32 that predict a served
    request's tokens ``out`` after ``prompt``, teacher-forced through the
    ``FORMULAS`` entry ``formulas``."""
    from repro_torch.models import model
    if formulas == "packed":
        seq = prompt + out[:-1]
        return teacher_forced(torch, cfg, params, seq,
                              kv_dtype)[len(prompt) - 1:]
    if formulas == "full":
        lg, _ = model.forward_full(cfg, params,
                                   stream_ids(torch, cfg, prompt + out[:-1]),
                                   impl="plain")
        return kept_logits(cfg, lg[0, len(prompt) - 1:]).float()
    lg, cache, clen = model.prefill(cfg, params,
                                    stream_ids(torch, cfg, prompt),
                                    max_len=1024, impl="plain")
    rows = [lg[0]]
    for tok in out[:-1]:
        lg, cache = model.forward_decode(cfg, params,
                                         stream_ids(torch, cfg, [tok]), cache,
                                         clen, impl="plain")
        clen = clen + 1
        rows.append(lg[0])
    return kept_logits(cfg, torch.stack(rows)).float()


def serve_prompts(cfg) -> list:
    """The serve phase's 8 prompt lengths and seed, token ids in the
    config's vocab."""
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 601, 8)
    return [[int(x) for x in rng.integers(0, cfg.vocab_size, n)]
            for n in lens]


def check_agreement(tag: str, what: str, lg, out: list,
                    bound: float = SERVE_AGREE_MIN) -> float:
    """Request 0's served tokens ``out`` against the argmax of logits
    ``lg`` (len(out), V) that ``what`` gave; fails under ``bound``."""
    ref = lg.argmax(-1).tolist()
    agree = float(np.mean(np.asarray(ref) == np.asarray(out)))
    log(f"{tag}: request 0 greedy tokens vs {what}: agreement {agree:.4f} "
        f"(tol >= {bound})")
    if agree < bound:
        raise AssertionError(f"{tag}: tokens disagree with {what}")
    return agree


def check_teacher_forced(torch, tag: str, cfg, params, done: dict,
                         prompts: list, kv_dtype=None,
                         formulas: str = "packed") -> float:
    """Request 0's served tokens against a teacher-forced plain forward of
    its whole stream through the step formulas ``formulas``
    (``served_logits``; through an int8 cache for ``kv_dtype="int8"``);
    fails under SERVE_AGREE_MIN."""
    lg = served_logits(torch, cfg, params, prompts[0], done[0], formulas,
                       kv_dtype)
    return check_agreement(tag, f"a teacher-forced plain {FORMULAS[formulas]}"
                           f" ({len(prompts[0])} prompt tokens)", lg, done[0])


def context_agreement(a: dict, b: dict):
    """Two runs' greedy tokens per request: (agreement over the positions
    whose earlier tokens agree in both runs, agreement over all positions,
    first differing position per request or None).  The first is the
    per-token agreement given the same context; after one flipped near-tie
    the runs decode different contexts, which the second counts too."""
    same = total = same_ctx = n_ctx = 0
    first = {}
    for rid in sorted(a):
        first[rid] = None
        for i, (x, y) in enumerate(zip(a[rid], b[rid])):
            same += x == y
            total += 1
            if first[rid] is None:
                n_ctx += 1
                same_ctx += x == y
                if x != y:
                    first[rid] = i
    return same_ctx / n_ctx, same / total, first


def phase_legacy(torch, cfg, params, prompts, packed: dict) -> dict:
    """The serve phase's 8 requests on the legacy step, with incremental
    and with recompute prefill, each run counted from 0 and profiled
    after: each must launch flash and decode attention 36 times per
    dispatch and no packed-attention variant, and finish 32 tokens per
    request; the tokens must agree with the packed serve's (``packed``)
    and between the two modes.  Returns the incremental run's counts."""
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.request import Request
    outs, counts = {}, {}
    for mode, kw in LEGACY_MODES.items():
        eng = ServeEngine(cfg, params, EngineConfig(max_slots=8, max_len=1024,
                                                    **kw))
        zero_counts()
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=32))
        done = eng.run()
        torch.cuda.synchronize()
        c = counts[mode] = read_counts()
        check_off_path(mode, c)
        s = eng.stats
        log(f"{mode}: {len(done)}/8 finished, {s.iterations} iterations, "
            f"{s.total_tokens} tokens in {s.wall_time:.3f} s = "
            f"{s.throughput:.1f} tok/s, {s.model_dispatches} dispatches "
            f"({s.dispatches_per_iter:.3f}/iter), {s.host_syncs} syncs "
            f"({s.syncs_per_iter:.3f}/iter), prefill work "
            f"{s.prefill_model_tokens} tokens ({s.prefill_expansion:.3f}x)")
        log(f"{mode}: wall split: host {s.host_time:.3f} s, step enqueue "
            f"{s.dispatch_time:.3f} s, blocked on result copies "
            f"{s.blocked_sync_time:.3f} s ({s.blocking_syncs} blocking "
            f"syncs); launches {c}")
        if len(done) != 8 or any(len(r.output) != 32 for r in done):
            raise AssertionError(f"{mode}: not every request finished 32 "
                                 "tokens")
        if s.dispatches_per_iter <= 1.0 or s.syncs_per_iter <= 1.0:
            raise AssertionError(f"{mode}: expected more than one dispatch "
                                 "and sync per iteration")
        for kname in LEGACY:
            if c[kname] <= 0 or c[kname] % cfg.n_layers:
                raise AssertionError(f"{mode}: {kname} launched {c[kname]} "
                                     f"times, not {cfg.n_layers} per "
                                     "dispatch")
        if any(c[kname] for kname in ATTENTION) or c["swiglu"] <= 0:
            raise AssertionError(f"{mode}: a packed-attention variant "
                                 f"launched, or swiglu did not: {c}")
        if any(not 0 <= t < cfg.vocab_size for r in done for t in r.output):
            raise AssertionError(f"{mode}: token id out of range")
        outs[mode] = {r.rid: r.output for r in done}
        # not cross-checked: the legacy engine's kind is, on the hybrid's
        # legacy step (~53k events; here ~400k took ~80 s on a slow host)
        phase_profile(torch, cfg, params, prompts, s.wall_time,
                      tag=f"{mode} profile", **kw)
        del eng
        torch.cuda.empty_cache()
    for a, b, bound in (("legacy", "packed", True),
                        ("legacy", "recompute", True),
                        ("recompute", "packed", False)):
        same_ctx, raw, first = context_agreement(
            outs[a], packed if b == "packed" else outs[b])
        log(f"legacy: tokens {a} vs {b}: agreement {same_ctx:.4f} at the "
            f"positions whose earlier tokens agree"
            + (f" (tol >= {SERVE_AGREE_MIN})" if bound else " (no bound)")
            + f"; {raw:.4f} at all positions; first differing position per "
            f"request {first}")
        if bound and same_ctx < SERVE_AGREE_MIN:
            raise AssertionError(f"legacy: {a} and {b} tokens disagree")
    return counts["legacy"]


def phase_shared_prefix(torch, cfg, params, busy: dict) -> dict:
    """A shared system prompt, in each of the four KV modes: wave 1 is one
    request (600 shared tokens + a 10-token suffix); wave 2, after it
    finished, is seven requests with the same 600 tokens and their own
    suffixes (first suffix tokens all distinct), 32 greedy tokens each.
    With prefix caching each wave-2 request finds 37 full blocks of 16
    cached and 8 more tokens in wave 1's 38th block, which it copies:
    7 x 600 = 4200 hit tokens and 7 copies.  Each mode's run is then
    profiled on a fresh engine, into ``busy``.  Returns each attention
    variant's launches in the run of its KV mode."""
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(5)
    shared = [int(x) for x in rng.integers(0, cfg.vocab_size, 600)]
    firsts = rng.choice(cfg.vocab_size, 8, replace=False)
    prompts = [shared + [int(f)] + [int(x) for x in
                                    rng.integers(0, cfg.vocab_size, 9)]
               for f in firsts]
    outs, launches = {}, {}
    for (blocked, quant) in ((False, False), (False, True), (True, False),
                             (True, True)):
        kv_dtype = "int8" if quant else "bf16"
        kname = next(k for k, (mode, _) in ATTENTION.items()
                     if mode == (blocked, quant))
        eng = ServeEngine(cfg, params, EngineConfig(
            max_slots=8, max_len=1024, kv_block_size=KV_BLOCK,
            async_depth=0, prefix_caching=blocked, kv_dtype=kv_dtype))
        zero_counts()
        eng.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=32))
        done = eng.run()
        for i in range(1, 8):
            eng.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=32))
        done += eng.run()
        torch.cuda.synchronize()
        counts = read_counts()
        check_off_path("shared-prefix", counts)
        s, kvs = eng.stats, eng.kv.stats
        tag = (f"shared-prefix [prefix caching {'on' if blocked else 'off'}, "
               f"{kv_dtype} KV]")
        served = sum(r.prompt_len + len(r.output) for r in done)
        log(f"{tag}: {len(done)}/8 finished, {s.iterations} iterations, "
            f"{s.total_tokens} tokens through the model in {s.wall_time:.3f} s "
            f"= {s.throughput:.1f} tok/s ({served / s.wall_time:.1f} prompt + "
            f"generated tok/s), {s.dispatches_per_iter} dispatch/iter, "
            f"{s.syncs_per_iter} sync/iter, KV {eng.kv.bytes_per_token} "
            f"B/token, {kvs.device_pages_total} pages, prefix hits "
            f"{kvs.prefix_hit_tokens} tokens, copy-on-write {kvs.cow_copies}")
        log(f"{tag}: wall split: host {s.host_time:.3f} s, step enqueue "
            f"{s.dispatch_time:.3f} s, blocked on the payload copy "
            f"{s.blocked_sync_time:.3f} s ({s.blocking_syncs} blocking syncs);"
            f" launches {counts}")
        if len(done) != 8 or any(len(r.output) != 32 for r in done):
            raise AssertionError(f"{tag}: not every request finished 32 tokens")
        if s.dispatches_per_iter != 1.0 or s.syncs_per_iter != 1.0:
            raise AssertionError(f"{tag}: not one dispatch and one sync per iter")
        if counts[kname] <= 0 or counts["swiglu"] <= 0:
            raise AssertionError(f"{tag}: {kname} or swiglu never launched")
        if any(not 0 <= t < cfg.vocab_size for r in done for t in r.output):
            raise AssertionError(f"{tag}: token id out of range")
        if blocked and (kvs.prefix_hit_tokens != 4200 or kvs.cow_copies != 7):
            raise AssertionError(f"{tag}: expected 4200 hit tokens and 7 "
                                 "copy-on-write copies")
        launches[kname] = counts[kname]
        outs[(blocked, quant)] = {r.rid: r.output for r in done}
        wall = s.wall_time
        del eng
        torch.cuda.empty_cache()
        busy[tag] = phase_profile(
            torch, cfg, params, prompts, wall, tag=f"{tag} profile", waves=2,
            cross_check=blocked and not quant, kv_block_size=KV_BLOCK,
            prefix_caching=blocked, kv_dtype=kv_dtype)

    for quant in (False, True):
        same_ctx, raw, first = context_agreement(outs[(True, quant)],
                                                 outs[(False, quant)])
        log(f"shared-prefix: {'int8' if quant else 'bf16'} KV, tokens with "
            f"prefix caching vs without: agreement {same_ctx:.4f} at the "
            f"positions whose earlier tokens agree (tol >= {SERVE_AGREE_MIN})"
            f"; {raw:.4f} at all positions (no bound: one flipped near-tie "
            f"changes every later context); first differing position per "
            f"request {first}")
        if same_ctx < SERVE_AGREE_MIN:
            raise AssertionError("shared-prefix: prefix caching changed the "
                                 "tokens")
    out = outs[(True, True)][1]
    seq = prompts[1] + out[:-1]
    lg8 = teacher_forced(torch, cfg, params, seq, "int8")
    ref = lg8[len(prompts[1]) - 1:].argmax(-1).tolist()
    agree = float(np.mean(np.asarray(ref) == np.asarray(out)))
    log(f"shared-prefix: request 1 (int8 KV, prefix caching) vs a "
        f"teacher-forced plain forward through an int8 cache: agreement "
        f"{agree:.4f} (tol >= {SERVE_AGREE_MIN})")
    if agree < SERVE_AGREE_MIN:
        raise AssertionError("shared-prefix: int8 tokens disagree with the "
                             "plain forward")
    lg16 = teacher_forced(torch, cfg, params, seq)
    drift = (lg8 - lg16).abs()
    log(f"shared-prefix: teacher-forced logit drift, int8 vs bf16 KV, over "
        f"{len(seq)} positions: max {float(drift.max()):.4f}, mean "
        f"{float(drift.mean()):.5f} (|logits| max "
        f"{float(lg16.abs().max()):.3f}; no bound)")
    if not bool(lg8.isfinite().all()):
        raise AssertionError("shared-prefix: non-finite int8 logits")
    return launches


class ReplayDrafter:
    """Proposes each request's tokens of an earlier run, from its committed
    output on: near-perfect drafts where the runs agree."""

    def __init__(self, targets: dict):
        self.targets = targets

    def propose(self, req, k: int) -> list:
        tgt = self.targets.get(req.rid, [])
        return tgt[len(req.output):len(req.output) + k]


def serve_run(torch, cfg, params, prompts, tag: str, kname: str,
              drafter=None, **engine_kw):
    """One serve of ``prompts`` (32 new tokens each) on a fresh engine
    (``engine_kw`` on top of 8 slots x 1024 rows; ``drafter`` replaces the
    engine's), with every kernel's count set to 0 just before and read just
    after.  Fails unless every request finished 32 tokens in range, with one
    dispatch and one sync per iteration, nothing left in flight, and the
    attention variant ``kname`` and SwiGLU launched.  Returns (engine,
    tokens by rid, counts)."""
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.request import Request
    eng = ServeEngine(cfg, params, EngineConfig(max_slots=8, max_len=1024,
                                                **engine_kw))
    if drafter is not None:
        eng.drafter = eng.scheduler.drafter = drafter
    zero_counts()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=32))
    done = eng.run()
    torch.cuda.synchronize()
    counts = read_counts()
    check_off_path(tag, counts)
    s = eng.stats
    log(f"{tag}: async depth {eng.async_depth}, {len(done)}/{len(prompts)} "
        f"finished, {s.iterations} iterations, {s.total_tokens} tokens in "
        f"{s.wall_time:.3f} s = {s.throughput:.1f} tok/s, "
        f"{s.dispatches_per_iter} dispatch/iter, {s.syncs_per_iter} sync/iter,"
        f" {s.blocking_syncs_per_iter:.3f} blocking syncs/iter; wall split: "
        f"host {s.host_time:.3f} s, step enqueue {s.dispatch_time:.3f} s, "
        f"blocked on the payload copy {s.blocked_sync_time:.3f} s "
        f"({s.blocking_syncs} blocking syncs); launches {counts}")
    if len(done) != len(prompts) or any(len(r.output) != 32 for r in done):
        raise AssertionError(f"{tag}: not every request finished 32 tokens")
    if s.dispatches_per_iter != 1.0 or s.syncs_per_iter != 1.0:
        raise AssertionError(f"{tag}: not one dispatch and one sync per iter")
    if eng.in_flight:
        raise AssertionError(f"{tag}: {eng.in_flight} iterations in flight "
                             "at exit")
    if counts[kname] <= 0 or counts["swiglu"] <= 0:
        raise AssertionError(f"{tag}: {kname} or swiglu never launched")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.output):
        raise AssertionError(f"{tag}: token id out of range")
    return eng, {r.rid: r.output for r in done}, counts


def agreement(tag: str, a: dict, b: dict,
              bound: Optional[float] = SERVE_AGREE_MIN) -> float:
    """Log two runs' token agreement (``context_agreement``) and the share
    of requests whose tokens are identical; fail under ``bound`` (None:
    no bound) at the positions whose earlier tokens agree."""
    same_ctx, raw, first = context_agreement(a, b)
    exact = float(np.mean([a[rid] == b[rid] for rid in a]))
    log(f"{tag}: agreement {same_ctx:.4f} at the positions whose earlier "
        f"tokens agree" + (f" (tol >= {bound})" if bound is not None
                           else " (no bound)")
        + f"; {raw:.4f} at all positions; requests token-identical "
        f"{exact:.3f}; first differing position per request {first}")
    if bound is not None and same_ctx < bound:
        raise AssertionError(f"{tag}: tokens disagree")
    return same_ctx


def phase_async(torch, cfg, params, prompts, busy: dict) -> None:
    """The serve phase's 8 requests at the default async depth (1) and at
    depth 0, in turns (1, 0, 0, 1), each counted from 0 (``serve_run``):
    the tokens agree, the ring is empty at exit, and each run prints its
    blocking syncs per iteration and its wall split.  The depth-1 serve is
    then profiled."""
    runs = []
    for depth in (1, 0, 0, 1):
        eng, out, _ = serve_run(
            torch, cfg, params, prompts, f"async depth {depth}",
            "packed_attention", **({} if depth else dict(async_depth=0)))
        if eng.async_depth != depth:
            raise AssertionError(f"async: depth {eng.async_depth}, not "
                                 f"{depth} (the default is 1)")
        runs.append((depth, eng.stats, out))
        del eng
    for i in (1, 2, 3):
        agreement(f"async: tokens depth {runs[0][0]} (run 1) vs depth "
                  f"{runs[i][0]} (run {i + 1})", runs[0][2], runs[i][2])
    walls = {d: [s.wall_time for dd, s, _ in runs if dd == d] for d in (0, 1)}
    log(f"async: walls in turns (depth 1, 0, 0, 1): "
        f"{[round(s.wall_time, 3) for _, s, _ in runs]} s; depth 0 / depth "
        f"1 = {sum(walls[0]) / sum(walls[1]):.3f}; blocking syncs per "
        f"iteration {[round(s.blocking_syncs_per_iter, 3) for _, s, _ in runs]}"
        f"; step enqueue {[round(s.dispatch_time, 3) for _, s, _ in runs]} s;"
        f" blocked {[round(s.blocked_sync_time, 3) for _, s, _ in runs]} s")
    torch.cuda.empty_cache()
    busy["async depth 1"] = phase_profile(
        torch, cfg, params, prompts, runs[-1][1].wall_time,
        tag="async depth 1 profile", async_depth=1)


def motif_prompts(cfg, n: int = 8) -> list:
    """Prompts that repeat a random motif of 3-8 tokens up to 64-320 tokens
    (numpy seed 9): the n-gram drafter's home ground."""
    rng = np.random.default_rng(9)
    out = []
    for _ in range(n):
        motif = [int(x) for x in rng.integers(0, cfg.vocab_size,
                                              int(rng.integers(3, 9)))]
        length = int(rng.integers(64, 321))
        out.append((motif * (length // len(motif) + 1))[:length])
    return out


def phase_spec(torch, cfg, params, prompts) -> dict:
    """Greedy speculative decoding at spec_k = SPEC_K in the contiguous and
    the prefix-caching native-dtype modes.  A replay drafter proposes the
    tokens of a plain serve of the same requests at depth 0; it must be
    accepted above SPEC_ACCEPT_MIN, need fewer iterations and agree with
    them.  This runs in f32 weights (seed 0): with random bf16 weights the
    logits' near-ties flip at 5-8% of the positions between launch shapes
    (the legacy and shared-prefix agreements), and a replay drafter then
    misses everything after its request's first flip.  The n-gram drafter
    runs the bf16 model on motif prompts at the default depth and must
    agree with a plain run of them and be accepted above
    SPEC_NGRAM_ACCEPT_MIN.  Returns the spec stats by run."""
    from repro_torch.models import model
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = model.init(cfg32, seed=0, device="cuda")
    eng, plain32, _ = serve_run(torch, cfg32, params32, prompts,
                                "spec plain (f32)", "packed_attention",
                                async_depth=0)
    plain_iters = eng.stats.iterations
    del eng
    motifs = motif_prompts(cfg)
    _, plain_motif, _ = serve_run(torch, cfg, params, motifs,
                                  "spec plain (bf16, motif prompts)",
                                  "packed_attention")
    stats = {}
    for drafter in ("replay", "n-gram"):
        for blocked in (False, True):
            kname = "packed_attention_block" if blocked else "packed_attention"
            mode = "prefix caching" if blocked else "contiguous"
            kw = dict(spec_k=SPEC_K, prefix_caching=blocked,
                      kv_block_size=KV_BLOCK)
            if drafter == "replay":
                tag = f"spec replay [f32, {mode}, spec_k {SPEC_K}]"
                eng, out, _ = serve_run(torch, cfg32, params32, prompts, tag,
                                        kname, drafter=ReplayDrafter(plain32),
                                        async_depth=0, **kw)
                want = plain32
            else:
                tag = f"spec n-gram [bf16, {mode}, spec_k {SPEC_K}]"
                eng, out, _ = serve_run(torch, cfg, params, motifs, tag,
                                        kname, **kw)
                want = plain_motif
            s = eng.stats
            bound = SPEC_ACCEPT_MIN if drafter == "replay" \
                else SPEC_NGRAM_ACCEPT_MIN
            log(f"{tag}: {s.spec_verify_segments} verify segments, "
                f"{s.spec_proposed_tokens} drafts, {s.spec_accepted_tokens} "
                f"accepted = {s.spec_acceptance_rate:.3f} (tol > {bound}), "
                f"{s.spec_accepted_per_verify:.3f} tokens per verify segment"
                + (f"; {s.iterations} iterations vs the plain serve's "
                   f"{plain_iters}" if drafter == "replay" else ""))
            agreement(f"{tag}: tokens vs the plain run", out, want)
            if s.spec_acceptance_rate <= bound or (
                    drafter == "replay" and s.iterations >= plain_iters):
                raise AssertionError(f"{tag}: acceptance "
                                     f"{s.spec_acceptance_rate:.3f} or "
                                     f"{s.iterations} iterations")
            stats[tag] = (s.spec_acceptance_rate, s.spec_accepted_per_verify,
                          s.iterations, s.wall_time)
            del eng
            torch.cuda.empty_cache()
        if drafter == "replay":
            del params32
            torch.cuda.empty_cache()
    return stats


def phase_sampling(torch, cfg, params, prompts, plain: dict) -> None:
    """Stochastic sampling (``SAMPLING``): the generator's bits on the card
    equal the CPU's for a block of (rid, pos) rows over the whole vocab and
    at top-k-like index sets; the sampling pass is timed at the serve's
    shape; two serves with the same seed give identical tokens at depth 0,
    and two at depth 1 (their agreement with each other and with the
    greedy serve's tokens, ``plain``, is printed without a bound)."""
    from repro_torch.serving import sampling
    rid = torch.arange(8).repeat_interleave(16)
    pos = torch.arange(100, 116).repeat(8)
    keys = sampling.packed_keys(1234, rid, pos, 1025)
    idx = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (128, 64)))
    for what, index in ((f"{cfg.vocab_size} vocab indices",
                         cfg.vocab_size), ("64 random indices", idx)):
        cpu = sampling.random_bits(keys, index)
        dev = sampling.random_bits(
            keys.cuda(), index if isinstance(index, int) else index.cuda())
        same = bool(torch.equal(dev.cpu(), cpu))
        log(f"sampling: generator bits on the card vs the CPU, 128 (rid, "
            f"pos) rows x {what}: {'equal' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError("sampling: the card's bits differ from the "
                                 "CPU's")
    # no uniform floor over the whole vocab: index 0 outweighs each other
    # index by e^30, more than the noise's spread (20.4), so every row must
    # draw it (noise that reached +inf at the top word would give ~V / 2^24
    # of the rows a uniform index)
    floor_rows, chunk, strays, finite = 4096, 256, 0, True
    for start in range(0, floor_rows, chunk):
        r = torch.arange(start, start + chunk, device="cuda")
        kk = sampling.packed_keys(7, r, torch.zeros_like(r), 1025)
        finite &= bool(torch.isfinite(
            sampling.gumbel(kk, cfg.vocab_size)).all())
        lg = torch.full((chunk, cfg.vocab_size), -30.0, device="cuda")
        lg[:, 0] = 0.0
        strays += int((sampling.sample_tokens(lg, kk, 1.0) != 0).sum())
    log(f"sampling: whole-vocab Gumbel noise over {floor_rows} rows x "
        f"{cfg.vocab_size}: {'finite' if finite else 'NOT FINITE'}; rows "
        f"that drew another index than the e^30-favoured one: {strays} "
        f"(tol 0)")
    if not finite or strays:
        raise AssertionError("sampling: the whole-vocab draw has infinite "
                             "noise or a uniform floor")
    del lg, kk
    torch.cuda.empty_cache()
    # the sampling pass at the serve's shape: each slot's single sample
    # point and (spec_k 0) no verify rows, 2 x 8 rows of bf16 logits
    rows = 16
    g = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn((rows, cfg.vocab_size), generator=g,
                         device="cuda").to(torch.bfloat16)
    k = sampling.packed_keys(0, torch.arange(rows, device="cuda"),
                             torch.full((rows,), 500, device="cuda"), 1025)
    passes = {"greedy": lambda: sampling.greedy(logits),
              "temperature 0.8 (Gumbel noise over the whole vocab)":
                  lambda: sampling.sample_tokens(logits, k, 0.8),
              "temperature 0.8, top_k 50":
                  lambda: sampling.sample_tokens(logits, k, 0.8, 50)}
    # a pass is a few hundred small launches: the spin must outlast their
    # enqueue for the events to time the device alone
    timer = Timer(torch)
    timer.SPIN_CYCLES = 40_000_000
    times = {name: (timer(fn), host_us(torch, fn, n=10) / 1e3)
             for name, fn in passes.items()}
    del timer
    torch.cuda.empty_cache()
    log(f"sampling: {rows} rows x {cfg.vocab_size} bf16 logits, device ms "
        f"(median of 20, cold L2) / host ms to enqueue: "
        + "; ".join(f"{name} {dev:.4f} / {host:.3f}"
                    for name, (dev, host) in times.items()))
    # harvesting off: the depth-1 schedule (and with it the launch shapes
    # and their bf16 sums) then does not depend on when payloads land
    outs = {}
    for depth in (0, 1):
        for rep in (0, 1):
            _, outs[(depth, rep)], _ = serve_run(
                torch, cfg, params, prompts,
                f"sampling {SAMPLING} depth {depth} run {rep}",
                "packed_attention", async_depth=depth, async_harvest=False,
                **SAMPLING)
        if outs[(depth, 0)] != outs[(depth, 1)]:
            agreement(f"sampling depth {depth}: run 0 vs run 1",
                      outs[(depth, 0)], outs[(depth, 1)], bound=None)
            raise AssertionError(f"sampling: two runs at depth {depth} with "
                                 "the same seed differ")
        log(f"sampling depth {depth}: two runs with the same seed give "
            "identical tokens")
    agreement("sampling: tokens depth 0 vs depth 1", outs[(0, 0)],
              outs[(1, 0)], bound=None)
    agreement("sampling: tokens vs the greedy serve's", outs[(0, 0)], plain,
              bound=None)


def hybrid_config():
    """Jamba-1.5-Large at full width, cut to what one card holds: one
    8-layer pattern group and a dense SwiGLU FFN in every layer
    (``dataclasses.replace`` on the port's copy of the config).  The port
    runs the MoE layers, but the group's 4 of them (16 experts of 3 x 8192
    x 24576) would make it ~45B params, ~90 GB in bf16; Arctic's phase
    runs the MoE FFN on the card."""
    from repro_torch.configs import FFN_DENSE, get_config
    full = get_config(JAMBA)
    cfg = dataclasses.replace(
        full, name=full.name + "-8l-dense", n_layers=HYBRID_LAYERS, moe=None,
        block_pattern=tuple(dataclasses.replace(sp, ffn=FFN_DENSE)
                            for sp in full.block_pattern))
    log(f"hybrid: {full.name} ({full.citation}) cut: n_layers "
        f"{full.n_layers} -> {cfg.n_layers}, moe {full.moe} -> None, "
        f"FFN_MOE -> FFN_DENSE (d_ff {cfg.d_ff}); kept d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads, vocab "
        f"{cfg.vocab_size}, {cfg.mamba}; layers "
        f"{[sp.mixer for sp in cfg.layer_specs()]}")
    return cfg


def phase_hybrid_forward(torch, cfg, params):
    """Two slots: a 64-token chunk, then a 37-token chunk that resumes
    their states, through ``forward_chunk`` with the kernels and with the
    plain versions, each with its own cache; the logits must agree and the
    scan must have launched 7 times per chunk."""
    from repro_torch.models import model
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda
    rng = np.random.default_rng(2)
    chunks = [rng.integers(0, cfg.vocab_size, (2, n)) for n in (64, 37)]
    n_mamba = sum(sp.mixer != "attn" for sp in cfg.layer_specs())
    logits = {}
    for impl in (None, "plain"):
        cache = model.init_cache(cfg, 2, 128, device="cuda")
        clen = torch.zeros(2, dtype=torch.int32, device="cuda")
        before = ssm_scan_cuda.launches
        outs = []
        for toks in chunks:
            lg, cache = model.forward_chunk(
                cfg, params, torch.tensor(toks, dtype=torch.int32,
                                          device="cuda"), cache, clen,
                impl=impl)
            outs.append(lg.reshape(-1, cfg.vocab_size))
            clen = clen + toks.shape[1]
        launched = ssm_scan_cuda.launches - before
        if launched != (n_mamba * len(chunks) if impl is None else 0):
            raise AssertionError(f"hybrid forward: ssm_scan launched "
                                 f"{launched} times with impl={impl}")
        logits[impl] = torch.cat(outs).float()
    torch.cuda.synchronize()
    a, b = logits[None], logits["plain"]
    if not bool(a.isfinite().all()):
        raise AssertionError("hybrid forward: non-finite logits")
    diff = float((a - b).abs().max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    log(f"hybrid forward (forward_chunk, 2 slots x (64 + 37) tokens): logits "
        f"max-abs diff {diff:.4f} (tol {FWD_LOGIT_ATOL}), |logits| max "
        f"{float(b.abs().max()):.3f}, greedy argmax agreement {agree:.4f} "
        f"(tol >= {FWD_ARGMAX_MIN})")
    if diff > FWD_LOGIT_ATOL or agree < FWD_ARGMAX_MIN:
        raise AssertionError("hybrid forward: kernels and plain versions "
                             "disagree")


def check_step_counts(tag: str, mode: str, cfg, c: dict, s,
                      kname: str = "packed_attention") -> None:
    """Each kernel launched as often as the step's dispatches say: on
    legacy and recompute the scan once per Mamba layer and flash attention
    once per attention layer and
    prefill dispatch, decode attention once per decode dispatch (the
    remaining dispatches are the incremental mode's slot resets, one per
    request); on the packed step the packed-attention build ``kname`` once
    per attention layer and iteration and no scan; SwiGLU once per gated
    dense FFN (a layer's own or Arctic's residual) of every forward.  A
    model without attention (xLSTM) launches no attention kernel, and one
    without a gated FFN (the ungated MLP, xLSTM) no SwiGLU."""
    specs = cfg.layer_specs()
    n_mamba = sum(sp.mixer == "mamba" for sp in specs)
    n_attn = sum(sp.mixer == "attn" for sp in specs)
    n_swiglu = sum(sp.ffn in ("dense", "moe+dense") for sp in specs) \
        if cfg.ffn_gated else 0
    others = [k for k in ATTENTION if not (mode == "packed" and k == kname)]
    resets = 8 if mode == "legacy" else 0
    if mode == "packed":
        forwards = s.iterations
        ok = (s.iterations > 0 and c[kname] == n_attn * s.iterations
              and c["ssm_scan"] == c["flash_attention"]
              == c["decode_attention"] == 0)
    elif n_attn:
        chunks = c["flash_attention"] // n_attn
        decodes = c["decode_attention"] // n_attn
        forwards = chunks + decodes
        ok = (chunks > 0 and decodes > 0
              and c["ssm_scan"] == n_mamba * chunks
              and c["flash_attention"] == n_attn * chunks
              and c["decode_attention"] == n_attn * decodes
              and forwards + resets == s.model_dispatches)
    else:
        forwards = s.model_dispatches - resets
        ok = (forwards > 0 and c["flash_attention"] == c["decode_attention"]
              == c["ssm_scan"] == 0)
    ok = ok and c["swiglu"] == n_swiglu * forwards \
        and not any(c[k] for k in others)
    if not ok:
        raise AssertionError(f"{tag}: launches {c} do not match "
                             f"{s.iterations} iterations and "
                             f"{s.model_dispatches} dispatches")


def phase_hybrid(torch, busy: dict) -> dict:
    """The hybrid model on the three steps, and on the packed step with
    int8 KV (see the module docstring); each run is profiled into
    ``busy``.  Returns the scan's launches in the legacy run."""
    from repro_torch.models import model
    from repro_torch.models.param import count_params
    cfg = hybrid_config()
    t0 = time.perf_counter()
    params = model.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"hybrid: {count_params(model.model_defs(cfg)) / 1e9:.3f}B params, "
        f"seeded init {time.perf_counter() - t0:.1f} s")
    phase_hybrid_forward(torch, cfg, params)

    prompts = serve_prompts(cfg)
    lens = [len(p) for p in prompts]
    outs, counts = {}, {}
    for mode, kw in HYBRID_MODES.items():
        step = "packed" if kw.get("step_mode") == "packed" else mode
        int8 = kw.get("kv_dtype") == "int8"
        # the int8 run's checked run is its profiled run (for time)
        eng, done, c, res = counted_serve(torch, cfg, params, prompts,
                                          f"hybrid {mode}", int8, **kw)
        if int8:
            busy[f"hybrid {mode}"] = res
        counts[mode] = c
        check_off_path(f"hybrid {mode}", c)
        s = eng.stats
        log(f"hybrid {mode}: prompts {lens}, {len(done)}/8 finished, "
            f"{s.iterations} iterations, {s.total_tokens} tokens in "
            f"{s.wall_time:.3f} s{' (profiled)' if int8 else ''} = "
            f"{s.throughput:.1f} tok/s, "
            f"{s.model_dispatches} dispatches ({s.dispatches_per_iter:.3f}/"
            f"iter), {s.host_syncs} syncs ({s.syncs_per_iter:.3f}/iter), "
            f"prefill work {s.prefill_model_tokens} tokens "
            f"({s.prefill_expansion:.3f}x), KV {eng.kv.bytes_per_token} "
            f"B/token, peak mem "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        log(f"hybrid {mode}: wall split: host {s.host_time:.3f} s, step "
            f"enqueue {s.dispatch_time:.3f} s, blocked on result copies "
            f"{s.blocked_sync_time:.3f} s ({s.blocking_syncs} blocking "
            f"syncs); launches {c}")
        if len(done) != 8 or any(len(r.output) != 32 for r in done):
            raise AssertionError(f"hybrid {mode}: not every request finished "
                                 "32 tokens")
        if any(not 0 <= t < cfg.vocab_size for r in done for t in r.output):
            raise AssertionError(f"hybrid {mode}: token id out of range")
        if step == "packed" and (s.dispatches_per_iter != 1.0
                                 or s.syncs_per_iter != 1.0):
            raise AssertionError(f"hybrid {mode}: not one dispatch and one "
                                 "sync per iteration")
        check_step_counts(f"hybrid {mode}", step, cfg, c, s,
                          "packed_attention_quant" if int8
                          else "packed_attention")
        outs[mode] = {r.rid: r.output for r in done}
        if int8:
            # through an int8 cache: never held to the bf16 tokens (C1)
            check_teacher_forced(torch, f"hybrid {mode}", cfg, params,
                                 outs[mode], prompts, kv_dtype="int8")
        else:
            check_teacher_forced(torch, f"hybrid {mode}", cfg, params,
                                 outs[mode], prompts, formulas="full")
        wall = s.wall_time
        del eng
        torch.cuda.empty_cache()
        if int8:
            continue
        # cross-checked: the legacy step, for the legacy engine's kind
        # (~53k events); the packed runs are the packed engine's kind,
        # cross-checked in the profile phase (at ~390k events a second
        # cross-check here took ~90 s on a slow host)
        busy[f"hybrid {mode}"] = phase_profile(
            torch, cfg, params, prompts, wall, tag=f"hybrid {mode} profile",
            cross_check=mode == "legacy", **kw)
    agreement("hybrid: tokens packed vs packed int8", outs["packed"],
              outs["packed int8"], bound=None)
    for a, b in (("legacy", "packed"), ("legacy", "recompute"),
                 ("recompute", "packed")):
        same_ctx, raw, first = context_agreement(outs[a], outs[b])
        log(f"hybrid: tokens {a} vs {b}: agreement {same_ctx:.4f} at the "
            f"positions whose earlier tokens agree (tol >= {SERVE_AGREE_MIN})"
            f"; {raw:.4f} at all positions; first differing position per "
            f"request {first}")
        if same_ctx < SERVE_AGREE_MIN:
            raise AssertionError(f"hybrid: {a} and {b} tokens disagree")
    del params
    torch.cuda.empty_cache()
    return counts["legacy"]["ssm_scan"]


def llama_config():
    """LLaMA-2-70B at full width cut to LLAMA_LAYERS of its 80 layers (the
    whole model is ~138 GB in bf16)."""
    from repro_torch.configs import get_config
    full = get_config(LLAMA)
    cfg = dataclasses.replace(full, name=f"{full.name}-{LLAMA_LAYERS}l",
                              n_layers=LLAMA_LAYERS)
    log(f"llama: {full.name} ({full.citation}) cut: n_layers "
        f"{full.n_layers} -> {cfg.n_layers}; kept d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads (group "
        f"{cfg.gqa_group}), head_dim {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}")
    return cfg


def phase_llama(torch, busy: dict) -> None:
    """LLaMA-2-70B, the paper's evaluation model, at full width and 8 of
    its 80 layers (seeded random bf16 weights): the serve phase's 8
    requests on the packed step, counted from 0 (``serve_run``): packed
    attention and SwiGLU launch once per layer and iteration, and request
    0's tokens agree with a teacher-forced plain forward; then the serve
    is profiled into ``busy``."""
    from repro_torch.models import model
    from repro_torch.models.param import count_params
    cfg = llama_config()
    t0 = time.perf_counter()
    params = model.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"llama: {count_params(model.model_defs(cfg)) / 1e9:.3f}B params, "
        f"seeded init {time.perf_counter() - t0:.1f} s, memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    prompts = serve_prompts(cfg)
    eng, out, c = serve_run(torch, cfg, params, prompts, "llama serve",
                            "packed_attention", async_depth=0)
    s = eng.stats
    check_step_counts("llama packed", "packed", cfg, c, s)
    check_teacher_forced(torch, "llama serve", cfg, params, out, prompts)
    wall = s.wall_time
    del eng
    busy["llama"] = phase_profile(torch, cfg, params, prompts, wall,
                                  tag="llama profile")
    del params
    torch.cuda.empty_cache()


class RouteRecorder:
    """While active, records each routing of the MoE FFN
    (``models.moe.route_topk``, patched in the module): the chosen experts
    (G, S, K) and the group's capacity C.  ``dropped()`` counts the (token,
    expert) pairs past their expert's C rows in their group, as
    ``moe_ffn`` drops them (padding rows are routed, and counted, too)."""

    def __init__(self):
        from repro_torch.models import moe as moe_mod
        self.mod = moe_mod
        self.calls = []

    def __enter__(self):
        self.orig = self.mod.route_topk

        def route(m, logits):
            gates, idx, aux = self.orig(m, logits)
            self.calls.append((idx, self.mod.capacity(m, logits.shape[1]),
                               m.num_experts))
            return gates, idx, aux
        self.mod.route_topk = route
        return self

    def __exit__(self, *exc):
        self.mod.route_topk = self.orig

    def dropped(self) -> tuple[int, int, float]:
        """(pairs dropped, pairs routed, the least capacity factor above
        which these choices would drop nothing: a group of S tokens, top k
        of E, whose fullest expert took n of its pairs needs
        ``max(4, ceil(S k / E f)) >= n``, so ``f > (n - 1) E / (S k)``)."""
        import torch
        drop = pairs = 0
        least = 0.0
        for idx, c, e in self.calls:
            counts = torch.nn.functional.one_hot(
                idx.flatten(1), e).sum(1)                       # (G, E)
            drop += int((counts - c).clamp(min=0).sum())
            pairs += idx.numel()
            n = int(counts.max())
            if n > 4:
                least = max(least, (n - 1) * e / (idx.shape[1] * idx.shape[2]))
        return drop, pairs, least


def arctic_config(capacity_factor: float):
    """Snowflake Arctic at full width cut to MOE_LAYERS of its 35 layers
    (the whole model is ~960 GB in bf16), at ``capacity_factor``."""
    from repro_torch.configs import get_config
    full = get_config(ARCTIC)
    return dataclasses.replace(
        full, name=f"{full.name}-{MOE_LAYERS}l", n_layers=MOE_LAYERS,
        moe=dataclasses.replace(full.moe, capacity_factor=capacity_factor))


def phase_moe_forward(torch, cfg, params, tag: str = "moe forward") -> None:
    """``forward_packed`` through the kernels and through the plain
    versions on ``forward_streams``, at a capacity that drops nothing: the
    share of equal (token, k) expert choices (bf16 near-ties of the
    router's logits flip between the two), the logits within
    FWD_LOGIT_ATOL for every token whose context (itself and the earlier
    tokens of its slot, which it attends) was routed alike in every layer,
    and greedy argmax agreement over every token."""
    from repro_torch.models import model
    streams, tok_slot, tok_pos = forward_streams(cfg)
    logits, routes = {}, {}
    for impl in (None, "plain"):
        cache = model.init_cache(cfg, 8, 64, device="cuda")
        outs = []
        with RouteRecorder() as rec:
            for toks, slot, pos, wpos in streams:
                as_t = [torch.tensor(np.asarray(a), dtype=torch.int32,
                                     device="cuda")
                        for a in (toks, slot, pos, wpos)]
                lg, cache = model.forward_packed(
                    cfg, params, as_t[0][None], cache, as_t[1], as_t[2],
                    as_t[3], kv_bucket=64, impl=impl)
                outs.append(lg[0, :200] if len(toks) == 256 else lg[0])
        logits[impl] = torch.cat(outs).float()
        # per stream, its MoE layers' choices of the real tokens: (L, T, K)
        n = sum(sp.ffn != "dense" for sp in cfg.layer_specs())
        routes[impl] = torch.cat([
            torch.stack([idx.reshape(-1, idx.shape[-1])[:len(o)]
                         for idx, _, _ in rec.calls[i * n:(i + 1) * n]])
            for i, o in enumerate(outs)], dim=1)
    torch.cuda.synchronize()
    a, b = logits[None], logits["plain"]
    if not bool(a.isfinite().all()):
        raise AssertionError(f"{tag}: non-finite logits")
    same = routes[None] == routes["plain"]                     # (L, T, K)
    alike = same.all(-1).all(0).cpu().numpy()                  # (T,)
    alike = torch.tensor([all(alike[(tok_slot == tok_slot[t])
                                    & (tok_pos <= tok_pos[t])])
                          for t in range(len(tok_slot))], device="cuda")
    diff = float((a - b).abs()[alike].max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    log(f"{tag} ({cfg.n_layers} layers, full width, capacity "
        f"{cfg.moe.capacity_factor}): equal (token, k) expert choices "
        f"{float(same.float().mean()):.4f}; tokens whose context was routed "
        f"alike in every layer {int(alike.sum())}/{len(alike)}: logits "
        f"max-abs diff "
        f"{diff:.4f} (tol {FWD_LOGIT_ATOL}); all tokens: max-abs diff "
        f"{float((a - b).abs().max()):.4f} (no bound), |logits| max "
        f"{float(b.abs().max()):.3f}, greedy argmax agreement {agree:.4f} "
        f"(tol >= {FWD_ARGMAX_MIN})")
    if diff > FWD_LOGIT_ATOL or agree < FWD_ARGMAX_MIN:
        raise AssertionError(f"{tag}: kernels and plain versions disagree")


def moe_profile(torch, cfg, params, prompts, wall: float) -> None:
    """The capacity-1.25 serve again under ``torch.profiler`` with host ops:
    the device's busy time and idle share, and the device time of the MoE
    FFN's einsums, told apart by their ``aten::bmm``'s operands: the three
    expert products batch over the E experts, the router's product has E
    columns, and the dispatch follows the router, the combine the expert
    products; any other einsum counts as "other"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.request import Request
    eng = ServeEngine(cfg, params, EngineConfig(max_slots=8, max_len=1024,
                                                async_depth=0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=32))
        eng.run()
        torch.cuda.synchronize()
    dev_us = sum(e.duration_ns() / 1e3
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0)
    einsums = sorted((e for e in prof.events() if e.name == "aten::einsum"),
                     key=lambda e: e.time_range.start)
    e_num = cfg.moe.num_experts
    parts = dict.fromkeys(("router", "dispatch", "experts", "combine",
                           "other"), 0.0)
    calls = dict.fromkeys(parts, 0)
    prev = None
    for e in einsums:
        bmm = [c.input_shapes for c in e.cpu_children if c.name == "aten::bmm"]
        a, b = bmm[0] if bmm else ([0], [0])
        if a[0] == e_num:
            part = "experts"
        elif b[-1] == e_num:
            part = "router"
        elif prev == "router":
            part = "dispatch"
        elif prev == "experts":
            part = "combine"
        else:
            part = "other"
        parts[part] += e.device_time_total
        calls[part] += 1
        prev = part
    if not calls["router"] or calls["experts"] != 3 * calls["router"] or \
            not calls["dispatch"] == calls["combine"] == calls["router"]:
        raise AssertionError(f"moe profile: einsum calls {calls} are not the "
                             "MoE FFN's six a call")
    wall_us = eng.stats.wall_time * 1e6
    it = eng.stats.iterations
    log(f"moe profile: device busy {dev_us / 1e3:.1f} ms over {it} "
        f"iterations ({dev_us / 1e3 / it:.2f} ms each): {dev_us / wall_us:.3f}"
        f" of the profiled wall ({wall_us / 1e3:.1f} ms, idle share "
        f"{1 - dev_us / wall_us:.3f}), {dev_us / 1e6 / wall:.3f} of the "
        f"unprofiled serve's wall ({wall * 1e3:.1f} ms, idle share "
        f"{1 - dev_us / 1e6 / wall:.3f}); {calls['router']} MoE FFN calls")
    for part, us in parts.items():
        log(f"moe profile: {part} einsums {us / 1e3:.1f} ms = "
            f"{us / dev_us:.3f} of the busy time over {calls[part]} calls")


def phase_moe(torch) -> None:
    """Snowflake Arctic at full width, 2 of its 35 layers (seeded random
    bf16 weights): ``phase_moe_forward`` at E / k = 64; the serve phase's 8
    requests on the packed step at the published
    ``capacity_factor`` 1.25, with the share of (token, expert) pairs
    dropped, then profiled (``moe_profile``); at E / k = 64, where no pair
    can drop (checked, with the least factor these choices needed), on the
    packed and the legacy step: tokens agree between the steps and with a
    teacher-forced plain forward.  Every run
    is counted from 0 and fails unless group-7 packed attention (packed),
    flash and decode attention (legacy) and SwiGLU (the dense residual)
    launched once per layer and forward."""
    from repro_torch.models import model
    from repro_torch.models.param import count_params
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.request import Request
    cfg = arctic_config(1.25)
    full = dataclasses.replace(cfg, n_layers=35)
    log(f"moe: {ARCTIC} ({cfg.citation}) cut: n_layers 35 -> "
        f"{cfg.n_layers}; kept d_model {cfg.d_model}, {cfg.n_heads} heads / "
        f"{cfg.n_kv_heads} KV heads (group {cfg.gqa_group}), head_dim "
        f"{cfg.resolved_head_dim}, dense residual d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.moe}; the whole model "
        f"{count_params(model.model_defs(full)) / 1e9:.1f}B params")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"moe: {count_params(model.model_defs(cfg)) / 1e9:.3f}B params, "
        f"seeded init {time.perf_counter() - t0:.1f} s, memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    # E / k: a group's C rows then hold every token, so nothing can drop
    # (16.0, the JAX tests' factor, drops pairs under these random weights)
    dropless = arctic_config(cfg.moe.num_experts / cfg.moe.top_k)
    phase_moe_forward(torch, dropless, params)
    prompts = serve_prompts(cfg)

    with RouteRecorder() as rec:
        eng, out125, c = serve_run(torch, cfg, params, prompts,
                                   "moe serve (capacity 1.25)",
                                   "packed_attention", async_depth=0)
    check_step_counts("moe packed (capacity 1.25)", "packed", cfg, c,
                      eng.stats)
    drop, pairs, _ = rec.dropped()
    log(f"moe serve (capacity 1.25): {drop} of {pairs} routed (token, "
        f"expert) pairs dropped = {drop / pairs:.4f} (padding rows "
        f"included); peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f}"
        f" GiB")
    wall = eng.stats.wall_time
    del eng, rec
    moe_profile(torch, cfg, params, prompts, wall)

    outs = {}
    for mode, kw in (("packed", dict(step_mode="packed", async_depth=0)),
                     ("legacy", dict(step_mode="legacy"))):
        tag = f"moe {mode} (capacity {dropless.moe.capacity_factor})"
        eng = ServeEngine(dropless, params, EngineConfig(max_slots=8,
                                                      max_len=1024, **kw))
        zero_counts()
        with RouteRecorder() as rec:
            for i, p in enumerate(prompts):
                eng.submit(Request(rid=i, prompt=p, max_new_tokens=32))
            done = eng.run()
            torch.cuda.synchronize()
        c = read_counts()
        check_off_path(tag, c)
        s = eng.stats
        drop, pairs, least = rec.dropped()
        log(f"{tag}: {len(done)}/8 finished, {s.iterations} iterations, "
            f"{s.total_tokens} tokens in {s.wall_time:.3f} s = "
            f"{s.throughput:.1f} tok/s, {s.model_dispatches} dispatches; "
            f"{drop} of {pairs} (token, expert) pairs dropped; these choices "
            f"drop nothing at any capacity factor above {least:.2f}; "
            f"launches {c}")
        if len(done) != 8 or any(len(r.output) != 32 for r in done):
            raise AssertionError(f"{tag}: not every request finished 32 "
                                 "tokens")
        if drop:
            raise AssertionError(f"{tag}: {drop} pairs dropped")
        if any(not 0 <= t < cfg.vocab_size for r in done for t in r.output):
            raise AssertionError(f"{tag}: token id out of range")
        check_step_counts(tag, mode, dropless, c, s)
        outs[mode] = {r.rid: r.output for r in done}
        check_teacher_forced(torch, tag, dropless, params, outs[mode],
                             prompts)
        del eng, rec, done
    agreement(f"moe: tokens packed vs legacy (capacity "
              f"{dropless.moe.capacity_factor})", outs["packed"],
              outs["legacy"])
    agreement(f"moe: tokens at capacity 1.25 vs "
              f"{dropless.moe.capacity_factor} (packed)", out125,
              outs["packed"], bound=None)
    del params
    torch.cuda.empty_cache()


def mla_case(torch, use: str, dtype, seed: int = 29):
    """One of the MLA kernel's four shapes at DeepSeek-V2's full width (128
    heads, latent rank 512, rope 64): ``packed`` the kernels phase's mixed
    stream (8 decode tokens of slots 0-7, a 200-token chunk of slot 8 at
    positions 300-499 and a 37-token chunk of slot 9, over 10 slots of 1024
    rows, bucket 1024), ``decode`` 8 rows of the serve's prompt lengths
    + 16 over (8, 1024) leaves, ``chunk`` a 256-token chunk at offset 512
    (its lengths built on the device) over slot 3's 1024-row view of an
    8-slot cache, ``recompute`` a 513-token prompt over its own latents.
    The leaves are views of (N·S + 1)-row stores, as the cache makes them.
    Returns (args, kwargs, SDPA inputs, bytes, flops, description): the
    bytes count q, out, the slot and length words and each attended latent
    row (1152 B in bf16) once; the flops 2·H·(576 + 512) per attended
    (token, row)."""
    from repro_torch.kernels import mla_attention as mla
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn
    h, rank, rope = 128, mla.RANK, mla.ROPE
    d = rank + rope
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    bucket = None
    if use == "packed":
        n, s, bucket = 10, 1024, 1024
        slot = list(range(8)) + [8] * 200 + [9] * 37
        lens = list(np.random.default_rng(seed).integers(512, 1025, 8)) + \
            list(range(301, 501)) + list(range(1, 38))
    elif use == "decode":
        n, s = 8, 1024
        slot = list(range(8))
        lens = list(np.random.default_rng(0).integers(16, 601, 8) + 16)
    elif use == "chunk":
        n, s = 8, 1024
        slot = [0] * 256
        lens = [512 + i + 1 for i in range(256)]
    else:
        n, s = 1, 513
        slot = [0] * 513
        lens = [i + 1 for i in range(513)]
    c_kv = randn(n * s + 1, rank)[:n * s].view(n, s, rank)
    k_rope = randn(n * s + 1, rope)[:n * s].view(n, s, rope)
    if use == "chunk":
        c_kv, k_rope = c_kv[3:4], k_rope[3:4]
        n = 1
    q = randn(len(slot), h, d)
    slot_t = torch.tensor(slot, dtype=torch.int32, device="cuda")
    if use == "chunk":      # as the chunk path builds it: offset + i + 1
        lens_t = torch.tensor([512], dtype=torch.int32, device="cuda") + \
            torch.arange(1, 257, dtype=torch.int32, device="cuda")
    else:
        lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    sweep = bucket or c_kv.shape[1]
    kw = dict(logit_scale=attn._mla_scale(get_config(DEEPSEEK)),
              kv_bucket=bucket)
    rows = {}
    for sl, ln in zip(slot, lens):
        rows[sl] = max(rows.get(sl, 0), min(int(ln), sweep))
    item = q.element_size()
    nbytes = (sum(rows.values()) * d * item + q.numel() * item
              + len(slot) * h * rank * item + 2 * len(slot) * 4)
    flops = sum(min(int(ln), sweep) for ln in lens) * 2 * h * (d + rank)
    # the same function as one masked SDPA call: every slot's swept rows as
    # one key sequence (the concatenation is made before the timed call)
    key = torch.cat([c_kv[:, :sweep], k_rope[:, :sweep]], -1)
    row = torch.arange(n * sweep, device="cuda")
    mask = (row[None] // sweep == slot_t[:, None].long()) & \
        (row[None] % sweep < lens_t[:, None].long())
    sdpa = (q.permute(1, 0, 2)[None].contiguous(),
            key.reshape(1, 1, n * sweep, d).contiguous(),
            c_kv[:, :sweep].reshape(1, 1, n * sweep, rank).contiguous(),
            mask[None, None])
    desc = (f"q ({len(slot)}, {h}, {d}) over c_kv {tuple(c_kv.shape)}, "
            f"k_rope {tuple(k_rope.shape)}"
            + (f", kv_bucket {bucket}" if bucket else ""))
    return ((q, c_kv, k_rope, slot_t, lens_t), kw, sdpa, nbytes, flops,
            desc)


def mla_schedule(args, kw) -> str:
    """The last MLA launch's schedule (``mla_attention.launch.schedule``,
    what the wrapper launched) and, for the log only, the host replay of
    its bf16 grid (``mla_attention.items``) at the case's slots and
    lengths: CTAs, those with rows, and the f32 partials that split items
    write and their last CTAs read back in the same launch.  The kernel
    runs no cluster."""
    from repro_torch.kernels import mla_attention as mla
    q, c_kv, _, slot, lens = args
    s = c_kv.shape[1]
    bucket = kw.get("kv_bucket")
    sweep = s if bucket is None else max(0, min(int(bucket), s))
    chunk, chunks = mla.launch.schedule
    grid = mla.items((chunk, chunks), q.shape[1], c_kv.shape[0], sweep,
                     slot.tolist(), lens.tolist())
    busy = sum(1 for it in grid if it.k1 > it.k0)
    parts = sum(1 for it in grid if it.live > 1 and it.k1 > it.k0)
    return (f"schedule {chunks} chunk(s) of {chunk} rows, no cluster; host "
            f"replay: {len(grid)} CTAs ({q.shape[0]} tokens x "
            f"{q.shape[1] // mla.HEAD_BLOCK} head blocks x {chunks}), "
            f"{busy} with rows, {parts} split partials, "
            f"{parts * mla.PART * 4 / 1e6:.1f} MB f32 written and read back")


def phase_mla_kernels(torch, timer, bw, peak) -> dict:
    """The MLA kernel against its plain version at ``mla_case``'s four
    shapes in f32 and bf16, two launches of each bit-equal, each timed
    (bf16) beside its plain version, masked SDPA
    (``scaled_dot_product_attention`` with ``enable_gqa`` over the
    concatenated key, checked against the plain version) and its bound,
    with its schedule (``mla_schedule``) and TFLOP/s.  Returns the
    kernel's record (the mixed stream's numbers, the other shapes under
    ``cases``)."""
    from repro_torch.kernels import mla_attention as mla
    F = torch.nn.functional
    cases = {}
    for use in ("packed", "decode", "chunk", "recompute"):
        args32, kw, _, _, _, _ = mla_case(torch, use, torch.float32)
        got32 = mla.mla_attention_cuda(*args32, **kw)
        err32 = check_close(f"mla_attention f32 {use}", got32,
                            mla.mla_attention_ref(*args32, **kw), F32_TOL)
        if not torch.equal(got32, mla.mla_attention_cuda(*args32, **kw)):
            raise AssertionError(f"mla_attention f32 {use}: two launches "
                                 "differ")
        del args32, got32
        args, kw, sdpa, nbytes, flops, desc = mla_case(torch, use,
                                                       torch.bfloat16)
        got = mla.mla_attention_cuda(*args, **kw)
        want = mla.mla_attention_ref(*args, **kw)
        torch.cuda.synchronize()
        err = check_close(f"mla_attention bf16 {use}", got, want)
        if not torch.equal(got, mla.mla_attention_cuda(*args, **kw)):
            raise AssertionError(f"mla_attention bf16 {use}: two launches "
                                 "differ")
        sched_desc = mla_schedule(args, kw)
        sched = mla.launch.schedule
        sq, sk, sv, mask = sdpa

        def lib():
            return F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask, enable_gqa=True,
                scale=kw["logit_scale"])
        check_close(f"mla sdpa yardstick {use}",
                    lib()[0].permute(1, 0, 2), want, LIB_TOL)
        ms = timer(lambda: mla.mla_attention_cuda(*args, **kw))
        plain_ms = timer(lambda: mla.mla_attention_ref(*args, **kw))
        lib_ms = timer(lib)
        t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
        log(f"mla_attention {use}: {desc}; {sched_desc}; two launches "
            f"bit-equal; max_abs_err f32 {err32:.3e} (tol {F32_TOL[0]} + "
            f"{F32_TOL[1]}·|ref|), bf16 {err:.3e} (tol {BF16_TOL[0]} + "
            f"{BF16_TOL[1]}·|ref|)  kernel_ms {ms:.4f}  plain_ms "
            f"{plain_ms:.4f}  sdpa_ms "
            f"{lib_ms:.4f}  bound_ms {max(t_bytes, t_ops):.4f} ("
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; "
            f"{flops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e9:.3f} TB/s)")
        cases[use] = dict(
            shape=f"{desc}, bf16", max_abs_err=err, max_abs_err_f32=err32,
            ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=lib_ms, schedule=list(sched))
        del args, sdpa, got, want
        torch.cuda.empty_cache()
    rec = dict(cases["packed"])
    rec["shape"] = ("T=245 (8 decode + 200 + 37 prefill), H=128, latent "
                    "rank 512 + rope 64, kv_bucket=1024, bf16")
    rec["library"] = ("masked scaled_dot_product_attention (enable_gqa) over "
                      "the concatenated key")
    rec["cases"] = {k: v for k, v in cases.items() if k != "packed"}
    return rec


def deepseek_config(capacity_factor: float):
    """DeepSeek-V2 at full width cut to MLA_LAYERS of its 60 layers (layer
    0 with its dense FFN, layer 1 with 160 experts top-6 and 2 shared), at
    ``capacity_factor``."""
    from repro_torch.configs import get_config
    full = get_config(DEEPSEEK)
    return dataclasses.replace(
        full, name=f"{full.name}-{MLA_LAYERS}l", n_layers=MLA_LAYERS,
        moe=dataclasses.replace(full.moe, capacity_factor=capacity_factor))


def check_mla_counts(tag: str, mode: str, cfg, c: dict, s) -> None:
    """An MLA model's launches: the MLA kernel once per layer of every
    forward (on the packed step one forward an iteration; on the legacy
    step one a dispatch besides the 8 slot resets, on recompute one a
    dispatch), SwiGLU as often (layer 0's dense FFN and layer 1's shared
    experts), and no other kernel."""
    n = cfg.n_layers
    if mode == "packed":
        forwards = s.iterations
    else:
        forwards = c["mla_attention"] // n
        if forwards + (8 if mode == "legacy" else 0) != s.model_dispatches:
            raise AssertionError(f"{tag}: launches {c} do not match "
                                 f"{s.model_dispatches} dispatches")
    others = [k for k in c if k not in ("mla_attention", "swiglu")]
    if not (c["mla_attention"] == n * forwards > 0
            and c["swiglu"] == n * forwards) or any(c[k] for k in others):
        raise AssertionError(f"{tag}: launches {c} do not match "
                             f"{s.iterations} iterations and "
                             f"{s.model_dispatches} dispatches")


def phase_mla(torch, timer, bw, peak, busy: dict) -> tuple[dict, int]:
    """DeepSeek-V2 (absorbed MLA) at full width, 2 of its 60 layers
    (seeded random bf16 weights): the MLA kernel's checks and times
    (``phase_mla_kernels``); ``forward_packed`` through the kernels against
    the plain versions at capacity E / k, where nothing can drop; the
    serve phase's 8 requests at E / k on the packed step (contiguous,
    prefix caching, int8 KV), the legacy step and recompute prefill, each
    counted from 0 (``check_mla_counts``): every request finishes, tokens
    agree between the steps and with a teacher-forced plain forward; the
    contiguous packed serve profiled into ``busy``; then the packed serve
    at the published capacity factor 1.25 with its dropped share.  Returns
    (the kernel's record, its launches in the packed serve)."""
    from repro_torch.models import model
    from repro_torch.models.param import count_params
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.request import Request
    record = phase_mla_kernels(torch, timer, bw, peak)
    cfg = deepseek_config(1.25)
    full = dataclasses.replace(cfg, n_layers=60)
    m = cfg.mla
    log(f"mla: {DEEPSEEK} ({cfg.citation}) cut: n_layers 60 -> "
        f"{cfg.n_layers} (layer 0 dense FFN {cfg.d_ff}, layer 1 MoE); kept "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads, MLA rank "
        f"{m.kv_lora_rank} + rope {m.qk_rope_dim} (q rank {m.q_lora_rank}, "
        f"nope {m.qk_nope_dim}, v {m.v_head_dim}), vocab {cfg.vocab_size}, "
        f"{cfg.moe}; the whole model "
        f"{count_params(model.model_defs(full)) / 1e9:.1f}B params")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"mla: {count_params(model.model_defs(cfg)) / 1e9:.3f}B params, "
        f"seeded init {time.perf_counter() - t0:.1f} s, memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    dropless = deepseek_config(cfg.moe.num_experts / cfg.moe.top_k)
    phase_moe_forward(torch, dropless, params, tag="mla forward")
    prompts = serve_prompts(cfg)
    runs = {"packed": dict(step_mode="packed", async_depth=0),
            "prefix caching": dict(step_mode="packed", async_depth=0,
                                   prefix_caching=True,
                                   kv_block_size=KV_BLOCK),
            "int8": dict(step_mode="packed", async_depth=0, kv_dtype="int8"),
            "legacy": dict(step_mode="legacy"),
            "recompute": dict(prefill_mode="recompute")}
    outs, walls, launches = {}, {}, 0
    for name, kw in runs.items():
        tag = f"mla {name} (capacity {dropless.moe.capacity_factor:.2f})"
        mode = name if name in LEGACY_MODES else "packed"
        eng = ServeEngine(dropless, params, EngineConfig(max_slots=8,
                                                      max_len=1024, **kw))
        zero_counts()
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=32))
        done = eng.run()
        torch.cuda.synchronize()
        c = read_counts()
        s = eng.stats
        log(f"{tag}: {len(done)}/8 finished, {s.iterations} iterations, "
            f"{s.total_tokens} tokens in {s.wall_time:.3f} s = "
            f"{s.throughput:.1f} tok/s, {s.model_dispatches} dispatches, "
            f"{s.dispatches_per_iter} dispatch/iter, KV "
            f"{eng.kv.bytes_per_token} B/token; launches {c}")
        if len(done) != 8 or any(len(r.output) != 32 for r in done):
            raise AssertionError(f"{tag}: not every request finished 32 "
                                 "tokens")
        if any(not 0 <= t < cfg.vocab_size for r in done for t in r.output):
            raise AssertionError(f"{tag}: token id out of range")
        check_off_path(tag, c)
        check_mla_counts(tag, mode, dropless, c, s)
        outs[name] = {r.rid: r.output for r in done}
        walls[name] = s.wall_time
        if name == "packed":
            launches = c["mla_attention"]
        check_teacher_forced(torch, tag, dropless, params, outs[name],
                             prompts, "int8" if name == "int8" else None)
        del eng, done
    for name in ("prefix caching", "legacy", "recompute"):
        agreement(f"mla: tokens packed vs {name}", outs["packed"],
                  outs[name])
    agreement("mla: tokens int8 vs bf16 KV (packed)", outs["packed"],
              outs["int8"], bound=None)
    busy["mla"] = phase_profile(torch, dropless, params, prompts,
                                walls["packed"], tag="mla profile")
    with RouteRecorder() as rec:
        eng, out125, c = serve_run(torch, cfg, params, prompts,
                                   "mla serve (capacity 1.25)",
                                   "mla_attention", async_depth=0)
    check_mla_counts("mla packed (capacity 1.25)", "packed", cfg, c,
                     eng.stats)
    drop, pairs, least = rec.dropped()
    log(f"mla serve (capacity 1.25): {drop} of {pairs} routed (token, "
        f"expert) pairs dropped = {drop / pairs:.4f} (padding rows "
        f"included); these choices drop nothing above capacity factor "
        f"{least:.2f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    agreement(f"mla: tokens at capacity 1.25 vs "
              f"{dropless.moe.capacity_factor:.2f} (packed)", out125,
              outs["packed"], bound=None)
    del eng, rec, params
    torch.cuda.empty_cache()
    return record, launches


def family_config(name: str, layers: int):
    """A config of the families phase, cut to ``layers`` (the whole model
    would not fit or would take longer than the phase's share)."""
    from repro_torch.configs import get_config
    full = get_config(name)
    cfg = dataclasses.replace(full, name=f"{full.name}-{layers}l",
                              n_layers=layers)
    attn = any(sp.mixer == "attn" for sp in cfg.layer_specs())
    log(f"families: {full.name} ({full.citation}) cut: n_layers "
        f"{full.n_layers} -> {layers}; kept d_model {cfg.d_model}, "
        + (f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads (group "
           f"{cfg.gqa_group}), head_dim {cfg.resolved_head_dim}, "
           if attn else f"{cfg.n_heads} heads, {cfg.xlstm}, ")
        + (f"d_ff {cfg.d_ff} ({'SwiGLU' if cfg.ffn_gated else 'GELU MLP'}), "
           if cfg.d_ff else "no FFN, ")
        + f"vocab {cfg.vocab_size}, frontend {cfg.frontend}"
        + (f" ({cfg.num_codebooks} codebooks)" if cfg.frontend == "audio"
           else "") + f"; layers {[sp.mixer for sp in cfg.layer_specs()]}")
    return cfg


def counted_serve(torch, cfg, params, prompts, tag: str, trace: bool,
                  **engine_kw):
    """A run whose checked run is its profiled one (the families phase, the
    hybrid's int8 run): a fresh engine serves ``prompts``
    (32 tokens each) with the kernels' counts set to 0 just before and
    read just after, under the profiler when ``trace`` (the device's busy
    time summed as ``phase_profile`` sums it; the wall is the profiled
    one).  Returns (engine, finished requests, counts, ``device_time``'s
    result or None)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.request import Request
    eng = ServeEngine(cfg, params, EngineConfig(max_slots=8, max_len=1024,
                                                **engine_kw))
    with (profile(activities=[ProfilerActivity.CUDA]) if trace
          else contextlib.nullcontext()) as prof:
        zero_counts()
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=32))
        done = eng.run()
        torch.cuda.synchronize()
        counts = read_counts()
        t_stop = time.perf_counter()
    res = device_time(prof, t_stop, eng.stats, f"{tag} profile") if trace \
        else None
    return eng, done, counts, res


def xlstm_witness(torch, cfg, params, prompts, packed: dict) -> None:
    """Why xLSTM's packed and legacy tokens part in bf16: request 0's
    packed tokens, teacher-forced through the packed step's formulas
    (``forward_packed``) and through the prefill's (``forward_full``), in
    bf16 and again in f32 (the same weights, cast).  The served tokens
    must agree with the packed formulas in bf16 (SERVE_AGREE_MIN: the
    families' packed check) and with the prefill's, a route independent
    of the step that served them (XLSTM_SERVED_AGREE_MIN); in f32 the two
    formulas' logits must differ by at most XLSTM_F32_GAP_MAX."""
    tag = f"families {cfg.name} packed"
    out = packed[0]

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(cast(v) for v in tree)
        return tree.float() if tree.is_floating_point() else tree
    for name, c, p in (("bf16", cfg, params),
                       ("f32", dataclasses.replace(cfg, dtype="float32"),
                        cast(params))):
        lp = served_logits(torch, c, p, prompts[0], out, "packed")
        lf = served_logits(torch, c, p, prompts[0], out, "full")
        gap = float((lp - lf).abs().max())
        log(f"{tag}: request 0 teacher-forced in {name}, the packed step's "
            f"formulas vs the prefill's: argmax agreement "
            f"{float((lp.argmax(-1) == lf.argmax(-1)).float().mean()):.4f}, "
            f"largest logit gap {gap:.3e} (|logits| max "
            f"{float(lf.abs().max()):.3f})"
            + (f" (tol <= {XLSTM_F32_GAP_MAX})" if name == "f32" else ""))
        if name == "f32" and gap > XLSTM_F32_GAP_MAX:
            raise AssertionError(f"{tag}: the packed and prefill formulas "
                                 "disagree in f32")
        if name == "bf16":
            check_agreement(tag, "a teacher-forced plain forward", lp, out)
            check_agreement(tag, "a teacher-forced plain forward_full", lf,
                            out, XLSTM_SERVED_AGREE_MIN)
        del lp, lf, p
    torch.cuda.empty_cache()


def phase_families(torch, busy: dict) -> dict:
    """Each config of ``FAMILIES`` (seeded random bf16 weights, drawn on
    the card) serves the serve phase's 8 prompt lengths (ids in its own
    vocab) on the packed step, the legacy step and recompute prefill
    (``counted_serve``: each run counted from 0 and, but xLSTM's, profiled
    into ``busy``): every request finishes 32 tokens; the kernels launch
    as the step's dispatches say (``check_step_counts``: SwiGLU only for
    LLaVA's gated FFN; xLSTM no attention kernel, scan or SwiGLU at all,
    ``check_off_path``); MusicGen runs packed attention at group 1 and
    head_dim 64; request 0's tokens agree with a teacher-forced plain
    forward of the step's own formulas (packed: ``forward_packed``;
    legacy, recompute: ``prefill`` + ``forward_decode``), and the steps'
    tokens with each other (xLSTM's packed and legacy at least
    XLSTM_ENGINES_AGREE_MIN, after ``xlstm_witness``).  Returns each attention
    kernel's launches by (group, head dim): packed attention from the
    packed runs, flash and decode attention from the legacy runs."""
    from repro_torch.models import model
    from repro_torch.models.param import count_params
    by_group: dict = {"packed_attention": {}, "flash_attention": {},
                      "decode_attention": {}}
    for name, layers in FAMILIES.items():
        t_cfg = time.perf_counter()
        cfg = family_config(name, layers)
        params = model.init(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        log(f"families {cfg.name}: "
            f"{count_params(model.model_defs(cfg)) / 1e9:.3f}B params, "
            f"seeded init {time.perf_counter() - t_cfg:.1f} s")
        attn = any(sp.mixer == "attn" for sp in cfg.layer_specs())
        group = f"G {cfg.gqa_group}, head_dim {cfg.resolved_head_dim}"
        if cfg.frontend == "audio" and (cfg.gqa_group, cfg.resolved_head_dim,
                                        attn) != (1, 64, True):
            raise AssertionError(f"families {cfg.name}: not group 1 at "
                                 "head_dim 64")
        prompts = serve_prompts(cfg)
        outs = {}
        for mode, kw in FAMILY_MODES.items():
            tag = f"families {cfg.name} {mode}"
            # not xLSTM's: its packed, legacy and recompute runs' ~670k,
            # ~320k and ~1.1M device events would take the profiler ~45,
            # ~20 and ~40 s on a slow host
            trace = attn
            eng, done, c, busy[f"{cfg.name} {mode}"] = counted_serve(
                torch, cfg, params, prompts, tag, trace, **kw)
            check_off_path(tag, c, () if attn else NOT_ON_XLSTM)
            s = eng.stats
            log(f"{tag}: {len(done)}/8 finished, {s.iterations} iterations, "
                f"{s.total_tokens} tokens in {s.wall_time:.3f} s"
                + (" (profiled)" if trace else "")
                + f" = {s.throughput:.1f} tok/s, {s.model_dispatches} "
                f"dispatches, {s.host_syncs} syncs, prefill work "
                f"{s.prefill_model_tokens} tokens ({s.prefill_expansion:.3f}"
                f"x), KV {eng.kv.bytes_per_token} B/token; wall split: host "
                f"{s.host_time:.3f} s, step enqueue {s.dispatch_time:.3f} s, "
                f"blocked {s.blocked_sync_time:.3f} s; peak mem "
                f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
                f"launches {c}")
            if len(done) != 8 or any(len(r.output) != 32 for r in done):
                raise AssertionError(f"{tag}: not every request finished 32 "
                                     "tokens")
            if any(not 0 <= t < cfg.vocab_size for r in done
                   for t in r.output):
                raise AssertionError(f"{tag}: token id out of range")
            if mode == "packed" and (s.dispatches_per_iter != 1.0
                                     or s.syncs_per_iter != 1.0):
                raise AssertionError(f"{tag}: not one dispatch and one sync "
                                     "per iteration")
            check_step_counts(tag, mode, cfg, c, s)
            for kname in by_group:
                if c[kname]:
                    by_group[kname][group] = \
                        by_group[kname].get(group, 0) + c[kname]
            outs[mode] = {r.rid: r.output for r in done}
            del eng
            torch.cuda.empty_cache()
            # each step against the plain forward of its own formulas
            # (xLSTM's packed step in ``xlstm_witness``)
            if attn or mode != "packed":
                check_teacher_forced(torch, tag, cfg, params, outs[mode],
                                     prompts, formulas="packed"
                                     if mode == "packed" else "steps")
        if not attn:
            xlstm_witness(torch, cfg, params, prompts, outs["packed"])
        agreement(f"families {cfg.name}: tokens packed vs legacy",
                  outs["packed"], outs["legacy"],
                  SERVE_AGREE_MIN if attn else XLSTM_ENGINES_AGREE_MIN)
        agreement(f"families {cfg.name}: tokens legacy vs recompute",
                  outs["legacy"], outs["recompute"])
        log(f"families {cfg.name}: {time.perf_counter() - t_cfg:.1f} s")
        del params
        torch.cuda.empty_cache()
    log(f"families: attention launches by group {by_group}")
    return by_group


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
    phases = {}

    def lap(phase: str) -> None:
        phases[phase] = round(time.perf_counter() - t_start
                              - sum(phases.values()), 1)
    name, bw, peak = card_info(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    libs = build.build()
    log(f"build: {libs.build_seconds:.1f} s")
    # each kernel's registers, stack and spills, under its library
    fn = ""
    for line in libs.ptxas_log.splitlines():
        if line.startswith("---"):
            log("  " + line.strip())
        elif "Function properties for" in line:
            fn = line.split(" for ", 1)[1].strip()
        elif "registers" in line or "spill" in line:
            log(f"  {fn}: {line.strip()}")
    lap("build")

    cfg = get_config("qwen3-8b")
    timer = Timer(torch)
    record = phase_kernels(torch, cfg, timer, bw, peak)
    record.update(phase_legacy_kernels(torch, cfg, timer, bw, peak))
    record.update(phase_ssm_kernels(torch, get_config(JAMBA), timer, bw,
                                    sfu_rate(torch)))
    lap("kernels")
    # every attention kernel at Qwen3-8B's group 4, then at 3, 7 and 9
    groups = {kname: [cfg.gqa_group] + g
              for kname, g in phase_groups(torch, timer, bw, peak).items()}
    lap("groups")
    # the two ops-only kernels: each phase's own launch through ``ops``
    ops_only = {}
    record["paged_decode_attention"], ops_only["paged_decode_attention"] = \
        phase_paged(torch, cfg, timer, bw, peak)
    lap("paged")
    record["fused_overlap"], ops_only["fused_overlap"] = \
        phase_overlap(torch, cfg, timer, bw, peak)
    del timer
    torch.cuda.empty_cache()
    lap("overlap")
    phase_forward(torch, cfg)
    lap("forward")
    launches, params, prompts, serve_wall, packed = phase_serve(torch, cfg)
    lap("serve")
    busy = {"packed": phase_profile(torch, cfg, params, prompts, serve_wall,
                                    cross_check=True)}
    lap("profile")
    # the serve phase's counts stand for the kernels it drives; the legacy
    # phase's incremental run gives flash and decode attention's, and the
    # shared-prefix runs those of the other packed-attention variants
    legacy = phase_legacy(torch, cfg, params, prompts, packed)
    for kname in LEGACY:
        launches[kname] = legacy[kname]
    lap("legacy")
    for kname, n in phase_shared_prefix(torch, cfg, params, busy).items():
        launches.setdefault(kname, n)
    lap("shared-prefix")
    phase_async(torch, cfg, params, prompts, busy)
    lap("async")
    phase_spec(torch, cfg, params, prompts)
    lap("spec")
    phase_sampling(torch, cfg, params, prompts, packed)
    lap("sampling")
    # the hybrid's legacy run gives the scan's count
    del params
    torch.cuda.empty_cache()
    launches["ssm_scan"] = phase_hybrid(torch, busy)
    lap("hybrid")
    phase_llama(torch, busy)
    lap("llama")
    phase_moe(torch)
    lap("moe")
    record["mla_attention"], launches["mla_attention"] = phase_mla(
        torch, Timer(torch), bw, peak, busy)
    lap("mla")
    families = phase_families(torch, busy)
    lap("families")
    for tag, got in busy.items():
        if got is not None and not any(k in tag for k in LEGACY_MODES):
            log(f"packed attention in the {tag} serve: {got[1]:.1f} ms of "
                f"{got[0]:.1f} ms device busy = {got[1] / got[0]:.3f}")
    for tag, got in busy.items():
        if got is not None:
            log(f"SwiGLU in the {tag} serve: {got[2]:.1f} ms of {got[0]:.1f} "
                f"ms device busy = {got[2] / got[0]:.3f}; library GEMMs "
                f"(cuBLAS) {got[3]:.1f} ms = {got[3] / got[0]:.3f}")
    launches.update(ops_only)

    sources = {kname: (f"{_CSRC}/packed_attention.cu", replaces)
               for kname, (_, replaces) in ATTENTION.items()}
    sources.update(LEGACY)
    sources["swiglu"] = (f"{_CSRC}/swiglu.cu",
                         "src/repro/kernels/swiglu.py:45")
    sources["ssm_scan"] = SSM_SCAN
    sources.update(OPS_ONLY)
    sources["mla_attention"] = MLA
    kernels = []
    for kname, (src, replaces) in sources.items():
        rec = record[kname]
        kernels.append(dict(name=kname, route="cuda", source=src,
                            replaces=replaces, launches=launches[kname],
                            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                            bound_by=rec["bound_by"],
                            library_ms=rec["library_ms"], shape=rec["shape"],
                            **({"groups": groups[kname]} if kname in groups
                               else {}),
                            **({"family_launches": families[kname]}
                               if kname in families else {}),
                            **{k: rec[k] for k in ("library", "cases")
                               if k in rec}))
    log(f"total {time.perf_counter() - t_start:.1f} s; by phase (s) {phases}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
