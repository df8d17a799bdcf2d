#!/usr/bin/env python3
"""Where flash attention's bf16 kernel spends its time, on one NVIDIA card.

    python3 tools/flash_probe.py [--parent DIR]   # 1-5 (, 6, 7)
    python3 tools/flash_probe.py --ptxas          # 8
    python3 tools/flash_probe.py --serve --parent DIR   # 9

At chip_smoke's two flash shapes (``chip_smoke.flash_case``: Qwen3-8B's
32/8 heads of 128, a 256-token chunk at device offset 512 over slot 3's
1024-row view of an 8-slot cache, and a 513-token prompt from offset 0):

1. The mma.sync kernel of the commit before the redesign (its copy is
   ``OLD_KERNEL`` below, built here) in three modes: the cp.async ring
   alone (loads and barriers, no arithmetic), plus S = Q K^T, and in
   full; with each CTA's number of 64-key tiles, in grid order, as the
   kernel itself counted them.
2. This tree's kernel (csrc/flash_attention.cu) with its plan, each CTA's
   keys from the host replay (``flash_attention.items``), TFLOP/s over the
   causal work, the plan's time without the L2 flush, the plan's chunk
   swept over every multiple of 64 keys up to Skv (every chunk checked
   against the plain version), and the launch floor: one query over one
   key.
3. Splits where the plan makes them: the legacy serve's chunk tails (1,
   59 and 132 tokens at offsets 512 and 256 over a 1024-row view) and
   16- and 64-token chunks at offset 1536 over a 2048-row view, each
   swept from one chunk to twice as many CTAs as SMs, checked and timed.
4. Variants of this tree's source, each a copy with one edit (``EDITS``),
   timed in turns with the tree's build (tree, variant, variant, tree)
   at both shapes: the ring alone (loads and barriers, no products or
   softmax) and one K/V stage per warpgroup instead of two.
5. The host's microseconds per call while the device sleeps: the C entry
   alone (its three tensor-map encodings included) and the Python wrapper
   (``flash_attention_cuda``).
6. With ``--parent DIR`` (an unpacked tree of an earlier commit): DIR's
   flash_attention.cu built here and timed in turns with this tree's
   (parent, tree, tree, parent), and the host's microseconds per call of
   either C entry and either wrapper (DIR's, its library call routed to
   DIR's build), in turns.
7. With ``--parent DIR``: ``cuobjdump -sass`` of every library of both
   trees: HGMMA, UTMALDG (TMA loads) and HMMA counted in each bf16 flash
   kernel, every other library compared function by function.
8. ``--ptxas``: registers, stack and spills of each flash kernel, and
   ptxas's C75xx notes, from this run's build (start from an empty build/).
9. ``--serve --parent DIR`` (alone): chip_smoke's legacy and recompute
   serves on full Qwen3-8B with DIR's flash and this tree's in turns
   (``serve_walls``), ~3 min.

Each time is the median of 20 calls after an L2 flush and a spin
(chip_smoke's ``Timer``).  Prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import importlib.util
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402  (Timer, card_info, flash_case, host_us)
from packed_attention_probe import nvcc_build, sass_functions  # noqa: E402

CSRC = ROOT / "src/repro_torch/kernels/csrc"
OUT_DIR = ROOT / "build" / "flash_probe"
CASES = ("chunk", "recompute")
MODES = ("ring alone", "+ S = QK^T", "full")
# label -> the (anchor, replacement) edits of csrc/flash_attention.cu that
# make the variant (each anchor must occur once); a ring without products
# is not checked (its output is zeros)
_ENTRY = "    return;\n"
EDITS = {
    "ring alone": (
        ("void scores(uint32_t q, uint32_t k) {\n",
         "void scores(uint32_t q, uint32_t k) {\n" + _ENTRY),
        ("void pv(uint32_t v) {\n", "void pv(uint32_t v) {\n" + _ENTRY),
        ("bool masked, float sl2,\n                                          "
         "float (&alpha)[2]) {\n",
         "bool masked, float sl2,\n                                          "
         "float (&alpha)[2]) {\n    alpha[0] = alpha[1] = 1.f;\n" + _ENTRY)),
    "one K/V stage a warpgroup": (
        ("static constexpr int STAGES = 2 * WGS;",
         "static constexpr int STAGES = WGS;"),),
}
# (Sq, offset, Skv) at Qwen3-8B's heads where the plan splits
SPLIT_SHAPES = ((1, 512, 1024), (59, 256, 1024), (132, 256, 1024),
                (16, 1536, 2048), (64, 1536, 2048))
# the C entry of the kernel before the redesign: no scratch, tickets or plan
PARENT_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
               + [ctypes.c_longlong] * 4 + [ctypes.c_float, ctypes.c_void_p])

# The bf16 kernel before the redesign (group 4, head_dim 128 only), with
# MODE: 0 loads and barriers only, 1 also S = Q K^T, 2 the whole kernel; it
# writes each CTA's number of key tiles to `tiles`.
OLD_KERNEL = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
namespace {
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BM = 64, THREADS = 128, G = 4, D = 128, BN = 64;
struct Params {
  const void *q, *k, *v; const int32_t* q_offset; void* out; int* tiles;
  int sq, skv, n_heads, n_kv; long long k_sb, k_ss, v_sb, v_ss; float scale;
};
__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void ldm(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(saddr(p)));
}
__device__ __forceinline__ void ldmt(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(saddr(p)));
}
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void split(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
template <int MODE>
__global__ void __launch_bounds__(THREADS) old_flash(const Params p) {
  constexpr int PT = BM / G, LD = D + 8, NT = BN / 8, OT = D / 8, CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + BM * LD;
  __nv_bfloat16* sv = sk + 2 * BN * LD;
  const int pos0 = blockIdx.x * PT, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int off = p.q_offset[b];
  const int last_pos = min(pos0 + PT, p.sq) - 1;
  const int kend = max(0, min(p.skv, off + last_pos + 1));
  const int n_kt = (kend + BN - 1) / BN;
  const int min_lim = min(p.skv, off + pos0 + 1);
  if (tid == 0)
    p.tiles[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = n_kt;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * D;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * D;
  for (int c = tid; c < BM * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 8, pos = pos0 + r / G;
    const bool ok = pos < p.sq;
    cp16(sq + r * LD + col,
         ok ? q + (((long long)b * p.sq + pos) * p.n_heads + kvh * G + r % G) * D + col : q, ok);
  }
  auto load_kv = [&](int stage, int kt) {
    for (int c = tid; c < BN * CH; c += THREADS) {
      const int r = c / CH, col = (c % CH) * 8, key = kt * BN + r;
      const bool ok = key < kend;
      cp16(sk + (stage * BN + r) * LD + col, ok ? kb + key * p.k_ss + col : kb, ok);
      cp16(sv + (stage * BN + r) * LD + col, ok ? vb + key * p.v_ss + col : vb, ok);
    }
  };
  if (n_kt > 0) load_kv(0, 0);
  asm volatile("cp.async.commit_group;\n" ::);
  const int r0 = warp * 16 + (lane >> 2);
  int lim[2];
  for (int h = 0; h < 2; ++h) lim[h] = min(p.skv, off + pos0 + (r0 + h * 8) / G + 1);
  const float sl2 = p.scale * LOG2E;
  float o[OT][4];
#pragma unroll
  for (int t = 0; t < OT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) load_kv((kt + 1) & 1, kt + 1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const __nv_bfloat16* skt = sk + (kt & 1) * BN * LD;
    const __nv_bfloat16* svt = sv + (kt & 1) * BN * LD;
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if (MODE >= 1) {
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t a[4];
        ldm(a, sq + (warp * 16 + (lane & 15)) * LD + kk + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bk[4];
          ldm(bk, skt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk + ((lane >> 3) & 1) * 8);
          mma(s[2 * np], a, bk[0], bk[1]);
          mma(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }
    }
    if (MODE == 1) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] += s[n][e];
    }
    if (MODE == 2) {
      const bool masked = (kt + 1) * BN > min_lim;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float x = s[n][e] * sl2;
          if (masked && kt * BN + n * 8 + (lane & 3) * 2 + (e & 1) >= lim[h]) x = NEG_INF;
          s[n][e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = exp2f(m[h] - mx[h]);
        m[h] = mx[h];
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2f(s[n][e] - mx[e >> 1]);
          s[n][e] = pe;
          rs[e >> 1] += pe;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
      for (int t = 0; t < OT; ++t) {
        o[t][0] *= alpha[0]; o[t][1] *= alpha[0];
        o[t][2] *= alpha[1]; o[t][3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t ah[4], al[4];
        split(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
        split(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
        split(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
        split(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
        const int vrow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int dp = 0; dp < OT / 2; ++dp) {
          uint32_t bv[4];
          ldmt(bv, svt + vrow * LD + dp * 16 + (lane >> 4) * 8);
          mma(o[2 * dp], ah, bv[0], bv[1]);
          mma(o[2 * dp], al, bv[0], bv[1]);
          mma(o[2 * dp + 1], ah, bv[2], bv[3]);
          mma(o[2 * dp + 1], al, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    const float inv = 1.f / fmaxf(lh, 1e-30f);
    const int r = r0 + h * 8, pos = pos0 + r / G;
    if (pos >= p.sq) continue;
    __nv_bfloat16* dst = out + (((long long)b * p.sq + pos) * p.n_heads + kvh * G + r % G) * D;
#pragma unroll
    for (int t = 0; t < OT; ++t)
      *reinterpret_cast<__nv_bfloat162*>(dst + t * 8 + (lane & 3) * 2) =
          __floats2bfloat162_rn(o[t][2 * h] * inv, o[t][2 * h + 1] * inv);
  }
}
template <int MODE>
int run(const Params& p, int batch, cudaStream_t stream) {
  constexpr int bytes = (BM + 4 * BN) * (D + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(old_flash<MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  old_flash<MODE><<<dim3((p.sq + BM / G - 1) / (BM / G), p.n_kv, batch), THREADS,
                    bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace
// q (B, Sq, 32, 128), k/v (B, Skv, 8, 128) strided, q_offset (B,) int32 on
// the device; tiles: one int per CTA.
extern "C" int old_flash_mode(const void* q, const void* k, const void* v,
                              const void* q_offset, void* out, void* tiles,
                              int mode, int batch, int sq, int skv,
                              long long k_sb, long long k_ss, long long v_sb,
                              long long v_ss, float scale, void* stream) {
  Params p{q, k, v, static_cast<const int32_t*>(q_offset), out,
           static_cast<int*>(tiles), sq, skv, 32, 8, k_sb, k_ss, v_sb, v_ss,
           scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return run<0>(p, batch, s);
  if (mode == 1) return run<1>(p, batch, s);
  return run<2>(p, batch, s);
}
"""
OLD_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 4 + [ctypes.c_float, ctypes.c_void_p])


def case_inputs(torch, cfg, case: str):
    """chip_smoke's flash case in bf16, with a device (B,) offset for both
    (the old kernel reads one): (q, k, v, offsets, plain output, flops,
    description)."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    (q, k, v), kw, _, _, flops, desc = chip_smoke.flash_case(
        torch, cfg, case, torch.bfloat16)
    off = kw.get("q_offset", torch.zeros(1, dtype=torch.int32, device="cuda"))
    return q, k, v, off, flash_attention_ref(q, k, v, q_offset=off), flops, desc


def old_modes(torch, timer, cfg) -> None:
    src = OUT_DIR / "old_flash.cu"
    src.write_text(OLD_KERNEL)
    fn = ctypes.CDLL(str(nvcc_build(src, (), OUT_DIR / "old_flash.so",
                                    cubin=False))).old_flash_mode
    fn.argtypes, fn.restype = OLD_ARGS, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for case in CASES:
        q, k, v, off, want, flops, desc = case_inputs(torch, cfg, case)
        out = torch.empty_like(q)
        grid = -(-q.shape[1] // 16) * k.shape[2] * q.shape[0]
        tiles = torch.zeros(grid, dtype=torch.int32, device="cuda")

        def call(mode):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), off.data_ptr(),
                    out.data_ptr(), tiles.data_ptr(), mode, q.shape[0],
                    q.shape[1], k.shape[1], k.stride(0), k.stride(1),
                    v.stride(0), v.stride(1), q.shape[-1] ** -0.5, stream)
            if rc != 0:
                raise RuntimeError(f"old flash mode {mode}: {rc}")
            return out
        chip_smoke.check_close(f"old flash [{case}]", call(2), want)
        ms = [timer(partial(call, mode)) for mode in range(3)]
        counts = tiles.tolist()
        print(f"old kernel [{case}] {desc}: " + ", ".join(
            f"{name} {t:.4f} ms" for name, t in zip(MODES, ms))
            + f"; {grid} CTAs of 128 threads, {sum(counts)} key tiles, "
            f"{ms[2] / max(counts) * 1e3:.2f} us per tile of the longest CTA",
            flush=True)
        print(f"old kernel [{case}] key tiles per CTA (grid order): "
              f"{' '.join(map(str, counts))}", flush=True)


def tree_kernel(torch, timer, cfg) -> None:
    from repro_torch.kernels import flash_attention as fa
    warm = chip_smoke.Timer(torch)
    warm.flush = torch.empty(1, dtype=torch.uint8, device="cuda")
    for case in CASES:
        q, k, v, off, want, flops, desc = case_inputs(torch, cfg, case)
        b, sq, h, d = q.shape
        skv, kvh = k.shape[1], k.shape[2]
        sched = fa.plan(b, sq, skv, kvh, h // kvh,
                        torch.cuda.get_device_properties(0).multi_processor_count)
        its = fa.items(sched, b, sq, skv, kvh, h // kvh, off.tolist())
        live = [it.k1 - it.k0 for it in its if it.k1 > it.k0]
        split = sum(1 for it in its if it.k1 > it.k0 and it.live > 1)
        for chunk in range(fa.BLOCK_N, -(-skv // fa.BLOCK_N) * fa.BLOCK_N + 1,
                           fa.BLOCK_N):
            s = (sched[0], chunk, -(-skv // chunk))
            call = partial(fa.launch, q, k, v, off, s)
            chip_smoke.check_close(f"flash [{case}] chunk {chunk}", call(), want)
            ms = timer(call)
            warm_ms = warm(call) if s == sched else None
            n = sum(1 for it in fa.items(s, b, sq, skv, kvh, h // kvh,
                                         off.tolist()) if it.k1 > it.k0)
            print(f"tree kernel [{case}] chunk {chunk}: {ms:.4f} ms, "
                  f"{s[0] * kvh * b * s[2]} CTAs, {n} with keys, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s"
                  + (f"  <- plan; {warm_ms:.4f} ms without the L2 flush"
                     if s == sched else ""), flush=True)
        if case == CASES[0]:
            one = [torch.randn(1, 1, n, d, device="cuda").to(q.dtype)
                   for n in (h, kvh, kvh)]
            print(f"tree kernel launch floor (q (1, 1, {h}, {d}) over one "
                  f"key): {timer(partial(fa.launch, *one)):.4f} ms",
                  flush=True)
        print(f"tree kernel [{case}] {desc}: plan {sched} (query tiles, "
              f"chunk, chunks), {len(its)} CTAs, {len(live)} with keys, "
              f"{split} of them in split tiles; 64-key tiles per CTA with "
              f"keys (grid order): "
              f"{' '.join(str(-(-n // fa.BLOCK_N)) for n in live)}", flush=True)


def lib_fn(so: Path, argtypes):
    fn = getattr(ctypes.CDLL(str(so)), "repro_flash_attention")
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def split_sweep(torch, timer, cfg) -> None:
    """At each of ``SPLIT_SHAPES``: every distinct chunk from all Skv keys
    down to as many chunks as make twice the SMs' CTAs, each checked
    against the plain version and timed, the plan's marked."""
    from repro_torch.kernels import flash_attention as fa
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(5)
    for sq, off, skv in SPLIT_SHAPES:
        q, k, v = (torch.randn(1, n, heads, d, generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for n, heads in ((sq, h), (skv, kvh), (skv, kvh)))
        offs = torch.tensor([off], dtype=torch.int32, device="cuda")
        want = fa.flash_attention_ref(q, k, v, q_offset=offs)
        sched = fa.plan(1, sq, skv, kvh, h // kvh, sms)
        tiles = sched[0] * kvh
        key_tiles = -(-skv // fa.BLOCK_N)
        chunks = sorted({-(-key_tiles // n) * fa.BLOCK_N for n in
                         range(1, min(key_tiles, 2 * sms // tiles) + 1)},
                        reverse=True)
        line = []
        for chunk in chunks:
            s = (sched[0], chunk, -(-skv // chunk))
            call = partial(fa.launch, q, k, v, offs, s)
            chip_smoke.check_close(f"split [{sq} at {off}] chunk {chunk}",
                                   call(), want)
            line.append(f"{chunk}: {timer(call):.4f}"
                        + (" <- plan" if s == sched else ""))
        print(f"split [Sq {sq} at offset {off} over {skv} rows, {tiles} "
              f"tiles, {-(-(off + sq) // fa.BLOCK_N)} 64-key stages reached]"
              f" ms by chunk: " + ", ".join(line), flush=True)


def variants(torch, timer, cfg) -> None:
    """Each of ``EDITS`` as a copy of this tree's source, built here and
    timed in turns with the tree's build at both shapes."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    text = (CSRC / "flash_attention.cu").read_text()

    def make(i_label):
        i, label = i_label
        src = text
        for old, new in EDITS[label]:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {label!r}: anchor {old!r} "
                                   f"found {src.count(old)} times")
            src = src.replace(old, new)
        path = OUT_DIR / f"variant-{i}.cu"
        path.write_text(src)
        return nvcc_build(path, (f"-I{CSRC}",), OUT_DIR / f"variant-{i}.so",
                          cubin=False)
    with ThreadPoolExecutor(len(EDITS)) as ex:
        sos = list(ex.map(make, enumerate(EDITS)))
    libs = build.build()
    tree = libs.fn("flash_attention")
    for label, so in zip(EDITS, sos):
        fn = lib_fn(so, build.SIGNATURES["flash_attention"][1])
        for case in CASES:
            q, k, v, off, want, _, _ = case_inputs(torch, cfg, case)
            run = partial(fa.launch, q, k, v, off)
            ms = []
            for lib in (tree, fn, fn, tree):
                libs._fns["flash_attention"] = lib
                if lib is tree or label != "ring alone":
                    chip_smoke.check_close(
                        f"{label} [{case}] "
                        f"{'tree' if lib is tree else 'variant'}", run(), want)
                ms.append(timer(run))
            libs._fns["flash_attention"] = tree
            print(f"A/B {label} [{case}] ms (tree, variant, variant, tree): "
                  f"tree {ms[0]:.4f} / {ms[3]:.4f}, variant {ms[1]:.4f} / "
                  f"{ms[2]:.4f}", flush=True)


def c_entry(torch, q, k, v, off):
    """This tree's C entry on the case's inputs, as one call (the
    wrapper's arguments built once)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(q)
    b, sq, h, d = q.shape
    q_tiles, chunk, n_chunks = fa.plan(
        b, sq, k.shape[1], k.shape[2], h // k.shape[2],
        torch.cuda.get_device_properties(0).multi_processor_count)
    tiles = q_tiles * k.shape[2] * b
    part = torch.empty(tiles * n_chunks * (d // 2 + 4) * fa.PART_THREADS,
                       device="cuda")
    tickets = fa.split_kv_tickets(q.device, stream, tiles)
    return partial(build.build().fn("flash_attention"), q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), off.data_ptr(),
                   out.data_ptr(), part.data_ptr(), tickets.data_ptr(), 1, b,
                   sq, k.shape[1], h, k.shape[2], d, 0, chunk, n_chunks,
                   k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                   d ** -0.5, stream), (out, part)


def host_cost(torch, cfg) -> None:
    from repro_torch.kernels import flash_attention as fa
    for case in CASES:
        q, k, v, off, _, _, _ = case_inputs(torch, cfg, case)
        call, _keep = c_entry(torch, q, k, v, off)
        c_us = chip_smoke.host_us(torch, call)
        w_us = chip_smoke.host_us(torch, partial(
            fa.flash_attention_cuda, q, k, v, q_offset=off))
        print(f"host [{case}]: C entry {c_us:.2f} us per call, "
              f"flash_attention_cuda {w_us:.2f} us per call", flush=True)


def load_parent(parent: Path):
    """DIR's flash_attention.cu built here: (its C entry, DIR's wrapper
    with its library call routed to that build)."""
    src = parent / "src/repro_torch/kernels/csrc/flash_attention.cu"
    so = nvcc_build(src, (), OUT_DIR / "parent-flash.so", cubin=False)
    pfn = lib_fn(so, PARENT_ARGS)
    spec = importlib.util.spec_from_file_location(
        "parent_flash", parent / "src/repro_torch/kernels/flash_attention.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build = SimpleNamespace(build=lambda: SimpleNamespace(
        fn=lambda name: pfn))
    return pfn, mod.flash_attention_cuda


def parent_ab(torch, timer, cfg, parent: Path) -> None:
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    pfn, wrapper = load_parent(parent)
    stream = torch.cuda.current_stream().cuda_stream
    for case in CASES:
        q, k, v, off, want, _, _ = case_inputs(torch, cfg, case)
        out = torch.empty_like(q)
        b, sq, h, d = q.shape
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), off.data_ptr(),
                out.data_ptr(), 1, b, sq, k.shape[1], h, k.shape[2], d, 0,
                k.stride(0), k.stride(1), v.stride(0), v.stride(1), d ** -0.5,
                stream)

        def old():
            rc = pfn(*args)
            if rc != 0:
                raise RuntimeError(f"parent flash: {rc}")
            return out
        new = partial(flash_attention_cuda, q, k, v, q_offset=off)
        chip_smoke.check_close(f"parent flash [{case}]", old(), want)
        chip_smoke.check_close(f"flash [{case}]", new(), want)
        ms = [timer(old), timer(new), timer(new), timer(old)]
        print(f"A/B flash [{case}]: parent {ms[0]:.4f} / {ms[3]:.4f} ms, "
              f"this tree {ms[1]:.4f} / {ms[2]:.4f} ms (parent, tree, tree, "
              f"parent); {min(ms[1:3]) / min(ms[0], ms[3]):.3f} of the "
              f"parent's time", flush=True)
        call, _keep = c_entry(torch, q, k, v, off)
        host = []
        for pair in ((old, call), (partial(wrapper, q, k, v, q_offset=off),
                                   new)):
            host.append([chip_smoke.host_us(torch, pair[i])
                         for i in (0, 1, 1, 0)])
        print(f"host [{case}] us per call in turns (parent, tree, tree, "
              f"parent): C entry {' / '.join(f'{x:.2f}' for x in host[0])}"
              f"; wrapper {' / '.join(f'{x:.2f}' for x in host[1])}",
              flush=True)


def serve_walls(torch, cfg, parent: Path) -> None:
    """chip_smoke's 8 requests (its prompts, 32 new tokens each) on full
    Qwen3-8B with seeded random weights, on the legacy step with
    incremental and with recompute prefill, each run with DIR's flash
    wrapper and kernel and with this tree's in turns (after one warm run):
    the wall, its step-enqueue part and the tokens of each run against the
    first's.  Nothing else differs between the runs, so the walls compare
    the two flash kernels' host and device cost inside the serve."""
    import numpy as np
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.request import Request
    _, wrapper = load_parent(parent)
    tree_launch = fa.launch

    def parent_launch(q, k, v, q_offset=0, sched=None):
        return wrapper(q, k, v, q_offset=q_offset)
    params = model.init(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [[int(x) for x in rng.integers(0, cfg.vocab_size, n)]
               for n in rng.integers(16, 601, 8)]
    for mode, kw in chip_smoke.LEGACY_MODES.items():
        walls, enqueue, outs = [], [], []
        for which in ("tree", "parent", "tree", "tree", "parent"):
            fa.launch = tree_launch if which == "tree" else parent_launch
            eng = ServeEngine(cfg, params, EngineConfig(
                max_slots=8, max_len=1024, **kw))
            for i, p in enumerate(prompts):
                eng.submit(Request(rid=i, prompt=p, max_new_tokens=32))
            done = eng.run()
            torch.cuda.synchronize()
            walls.append(eng.stats.wall_time)
            enqueue.append(eng.stats.dispatch_time)
            outs.append([t for r in sorted(done, key=lambda r: r.rid)
                         for t in r.output])
            del eng
        fa.launch = tree_launch
        same = [float(np.mean(np.asarray(o) == np.asarray(outs[1])))
                for o in outs[2:]]
        print(f"serve [{mode}] wall s after a warm run (parent, tree, tree, "
              f"parent): {' / '.join(f'{w:.3f}' for w in walls[1:])}; step "
              f"enqueue s {' / '.join(f'{e:.3f}' for e in enqueue[1:])}; "
              f"tokens equal to the first parent run's "
              f"{' / '.join(f'{x:.4f}' for x in same)}", flush=True)


def compare_sass(parent: Path) -> None:
    from repro_torch.kernels import build

    def cubins(tree: Path, tag: str) -> dict:
        def one(target):
            source, defines = build.TARGETS[target]
            return target, sass_functions(nvcc_build(
                tree / f"src/repro_torch/kernels/csrc/{source}.cu", defines,
                OUT_DIR / f"{tag}-{target}.cubin", cubin=True))
        with ThreadPoolExecutor(len(build.TARGETS)) as ex:
            return dict(ex.map(one, build.TARGETS))
    old, new = cubins(parent, "parent"), cubins(ROOT, "tree")
    for tag, funcs in (("this tree", new["flash_attention"]),
                       ("parent", old["flash_attention"])):
        for name, lines in sorted(funcs.items()):
            if "bf16" in name:
                text = "\n".join(lines)
                print(f"SASS flash_attention ({tag}) {name[:70]}: "
                      f"{len(re.findall(r'HGMMA', text))} HGMMA, "
                      f"{len(re.findall(r'UTMALDG', text))} UTMALDG, "
                      f"{len(re.findall(r'HMMA', text))} HMMA", flush=True)
    for target in build.TARGETS:
        if target == "flash_attention":
            continue
        a, b = old[target], new[target]
        same = [f for f in a if a[f] == b.get(f)]
        print(f"SASS {target}: {len(a)} functions in the parent, {len(b)} in "
              f"this tree, {len(same)} identical instruction for instruction"
              + ("" if len(same) == len(a) == len(b) else
                 f"; differ: {sorted(set(a) ^ set(same))[:4]}"), flush=True)
        if len(same) != len(a):
            # the same parent source built again: do its builds differ too?
            source, defines = build.TARGETS[target]
            again = sass_functions(nvcc_build(
                parent / f"src/repro_torch/kernels/csrc/{source}.cu", defines,
                OUT_DIR / f"parent2-{target}.cubin", cubin=True))
            diff = sorted(f for f in a if a[f] != again.get(f))
            print(f"SASS {target}: a second build of the parent's source "
                  f"differs from its first in {len(diff)} functions; of this "
                  f"tree's differences, {len(set(a) - set(same) - set(diff))}"
                  f" are not among them", flush=True)


def sass_mix(name: str = "bf16_kernelILi4ELi128E") -> None:
    """Opcodes of one bf16 kernel (group 4, head_dim 128: Qwen3-8B's) in
    this tree's build, most frequent first."""
    funcs = sass_functions(nvcc_build(
        ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu", (),
        OUT_DIR / "tree-flash.cubin", cubin=True))
    for fname, lines in funcs.items():
        if name not in fname:
            continue
        ops = {}
        for line in lines:
            m = re.match(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                         line)
            if m:
                ops[m.group(1)] = ops.get(m.group(1), 0) + 1
        top = sorted(ops.items(), key=lambda kv: -kv[1])
        print(f"SASS mix {fname[:60]}: {sum(ops.values())} instructions; "
              + ", ".join(f"{k} {v}" for k, v in top[:24]), flush=True)


def ptxas_table() -> None:
    from repro_torch.kernels import build
    target = fn = None
    stack = ""
    for line in build.build().ptxas_log.splitlines():
        if line.startswith("--- "):
            target = line[4:]
        if target != "flash_attention":
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            stack = f"{m.group(1)} B stack, {m.group(2)} B spilled"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            print(f"ptxas flash_attention {fn[-60:]}: {m.group(1)} registers,"
                  f" {stack}", flush=True)
        if "C75" in line:
            print(f"ptxas flash_attention: {line.strip()[:200]}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    chip_smoke.card_info(torch)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cfg = get_config("qwen3-8b")
    parent = None
    if "--parent" in sys.argv:
        parent = Path(sys.argv[sys.argv.index("--parent") + 1]).resolve()
    if "--serve" in sys.argv:
        if parent is None:
            print("flash_probe: --serve needs --parent DIR", file=sys.stderr)
            return 2
        serve_walls(torch, cfg, parent)
        return 0
    timer = chip_smoke.Timer(torch)
    if "--ptxas" not in sys.argv:
        old_modes(torch, timer, cfg)     # needs none of this tree's kernels
    build.build()
    if "--ptxas" in sys.argv:
        ptxas_table()
        sass_mix()
        return 0
    tree_kernel(torch, timer, cfg)
    split_sweep(torch, timer, cfg)
    variants(torch, timer, cfg)
    host_cost(torch, cfg)
    if parent is not None:
        parent_ab(torch, timer, cfg, parent)
        compare_sass(parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
