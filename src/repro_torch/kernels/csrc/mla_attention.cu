// Latent attention of absorbed MLA (DeepSeek-V2) over the token-packed
// stream, for Hopper (sm_90a), with a plain C interface loaded through
// ctypes.
//
// Replaces the TPU kernel src/repro/kernels/packed_attention.py
// `packed_attention` in the form absorbed MLA runs it (`_kernel`, KV = 1,
// d_v != d_qk): token t attends rows [0, min(lengths[t], sweep)) of slot
// token_slot[t].  Key row r is [c_kv[slot, r] | k_rope[slot, r]] (rank +
// rope = 576 columns), read in place from the two cache leaves through
// their own strides; the value row is c_kv[slot, r], the key's first 512
// columns, so one shared-memory stage serves both products and no
// concatenated key exists in device memory.  All H query heads share the
// one latent KV head (group = H).  Same constants as the TPU kernel: scores
// in f32 scaled by `scale` (the wrapper passes MLA's (nope + rope) ** -0.5,
// not d_qk ** -0.5), masked scores NEG_INF = -1e30, the softmax denominator
// clamped to 1e-30.  A token whose slot is out of range or whose length is
// not positive gives zeros.
//
// What bounds it on the card: at a decode token, bytes (each attended row
// is 1152 bytes in bf16 and is read once per 64-head block); at a prefill
// chunk, operations (2 * H * (576 + 512) flops per attended (token, row)),
// since every token of a chunk re-reads its slot's rows.
//
// Design (simple first; wgmma/TMA, a tile of several tokens and the block
// table and int8 in the kernel are later work):
//   * A CTA is one (token, block of 64 heads, chunk of key rows): the heads
//     are the M side of the MMA, so group 128 and one KV head fill the
//     tensor cores' rows without the GQA tile kernel's tq * group <= 64.
//     The wrapper splits the sweep into chunks only when the (token, head
//     block) items alone cannot fill the SMs (a decode batch); a split
//     CTA writes f32 partials (m, l, unnormalized O) and a second kernel
//     merges each (token, head) over its chunks in chunk order.
//   * bf16: 8 warps.  q's 64 x 576 tile sits in shared memory (74,752 B
//     with a 16-byte row pad); keys stream through a two-stage cp.async
//     ring of 32-row stages (37,376 B each).  S = Q K^T on mma.sync
//     m16n8k16: warp (r, c) scores rows 16r..16r+15 against keys
//     16c..16c+15 of the stage and the two halves meet in a 64 x 32 f32
//     buffer, so each warp then holds its 16 rows x all 32 keys for the
//     online softmax.  O += P V: warp (r, c) owns output columns
//     256c..256c+255 of its rows (128 f32 accumulator registers a thread;
//     4 warps of 512 columns would need 256, past the 255 limit), with P as
//     bf16 hi + lo (csrc/attn_decode.cuh's primitives) and V^T read from
//     the key stage by ldmatrix.trans.
//   * f32 (for the card's exact checks): 16 heads a CTA, 32-row stages in
//     shared memory, CUDA-core FMAs; a warp scores two heads, lane = key.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_decode.cuh"

namespace {
namespace mla {

using attn_decode::cp_async16;
using attn_decode::cp_async_commit;
using attn_decode::cp_async_wait;
using attn_decode::ldmatrix_x4;
using attn_decode::ldmatrix_x4_trans;
using attn_decode::mma_bf16;
using attn_decode::split_bf16;
using attn_decode::warp_sum;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int RANK = 512;           // kv_lora_rank: c_kv, and the value
constexpr int ROPE = 64;            // qk_rope_dim: k_rope
constexpr int D = RANK + ROPE;      // the latent key
constexpr int THREADS = 256;
constexpr int NK = 32;              // key rows per stage

// bf16 path
constexpr int HEADS = 64;           // query heads per CTA
constexpr int STAGES = 2;           // the cp.async ring's depth
constexpr int LD = D + 8;           // shared row pitch (bf16): 1168 bytes
constexpr int SLD = NK + 4;         // score buffer pitch (f32)
constexpr int Q_BYTES = HEADS * LD * 2;
constexpr int STAGE_BYTES = NK * LD * 2;
constexpr int SMEM_BF16 = Q_BYTES + STAGES * STAGE_BYTES + HEADS * SLD * 4;
constexpr int CHUNKS_ROW = D / 8;   // 16-byte pieces of a key row
constexpr int CKV_CHUNKS = RANK / 8;

// f32 path
constexpr int F_HEADS = 16;
constexpr int F_LDK = D + 1;        // odd pitch: lane-per-key reads hit 32 banks
constexpr int SMEM_F32 = (F_HEADS * D + NK * F_LDK + F_HEADS * NK +
                          3 * F_HEADS) * 4;

struct Args {
  const void* q;
  const void* ckv;
  const void* krope;
  const int32_t* slot;
  const int32_t* len;
  void* out;
  float* part_ml;       // (T, H, splits, 2): m (log2 units), l
  float* part_acc;      // (T, H, splits, RANK): O unnormalized
  int t, h, n, sweep, chunk, splits;
  long long ck_s0, ck_s1, kr_s0, kr_s1;
  float sl2;            // scale * log2(e)
};

// The CTA's token, head block and key range [k0, k1); false when it has no
// key (out-of-range slot, non-positive length, or a chunk past the length).
struct Work {
  int t, hb, split, slot, k0, k1;
};

__device__ __forceinline__ bool find_work(const Args& a, int heads, Work& w) {
  const int hblocks = a.h / heads;
  int b = blockIdx.x;
  w.split = b % a.splits;
  b /= a.splits;
  w.hb = b % hblocks;
  w.t = b / hblocks;
  w.slot = a.slot[w.t];
  const int lim = min(a.len[w.t], a.sweep);
  w.k0 = w.split * a.chunk;
  w.k1 = min(lim, w.k0 + a.chunk);
  return w.slot >= 0 && w.slot < a.n && w.k1 > w.k0;
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS, 1) mla_bf16_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem + Q_BYTES);
  float* ss = reinterpret_cast<float*>(smem + Q_BYTES + STAGES * STAGE_BYTES);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp & 3, wc = warp >> 2;   // rows 16wr.., columns / keys wc
  Work w;
  const bool busy = find_work(a, HEADS, w);
  const int head0 = w.hb * HEADS;
  const size_t row_t = (size_t)w.t * a.h + head0;   // (token, first head)

  if (!busy) {
    if (a.splits == 1) {   // zeros: 64 rows x 512 columns of the output
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.out) + row_t * RANK;
      for (int i = tid; i < HEADS * RANK / 2; i += THREADS)
        store2(o + 2 * i, 0.f, 0.f);
    } else if (tid < HEADS) {
      float* ml = a.part_ml + ((row_t + tid) * a.splits + w.split) * 2;
      ml[0] = NEG_INF;
      ml[1] = 0.f;
    }
    return;
  }

  const __nv_bfloat16* ckv = static_cast<const __nv_bfloat16*>(a.ckv) +
                             (long long)w.slot * a.ck_s0;
  const __nv_bfloat16* krope = static_cast<const __nv_bfloat16*>(a.krope) +
                               (long long)w.slot * a.kr_s0;
  const int n_stages = (w.k1 - w.k0 + NK - 1) / NK;

  auto load_stage = [&](int st) {
    __nv_bfloat16* dst = sk + (st % STAGES) * (NK * LD);
    const int base = w.k0 + st * NK;
#pragma unroll
    for (int i = tid; i < NK * CHUNKS_ROW; i += THREADS) {
      const int r = i / CHUNKS_ROW, c = i % CHUNKS_ROW;
      const int row = base + r;
      const bool ok = row < w.k1;
      const __nv_bfloat16* src =
          c < CKV_CHUNKS ? ckv + (ok ? row * a.ck_s1 : 0) + c * 8
                         : krope + (ok ? row * a.kr_s1 : 0) + (c - CKV_CHUNKS) * 8;
      cp_async16(dst + r * LD + c * 8, src, ok);
    }
  };

  // q's tile, then the first stage, as one group
  {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + row_t * D;
#pragma unroll
    for (int i = tid; i < HEADS * CHUNKS_ROW; i += THREADS) {
      const int r = i / CHUNKS_ROW, c = i % CHUNKS_ROW;
      cp_async16(sq + r * LD + c * 8, q + (size_t)r * D + c * 8, true);
    }
  }
  load_stage(0);
  cp_async_commit();

  float o[32][4];
#pragma unroll
  for (int n = 0; n < 32; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int st = 0; st < n_stages; ++st) {
    // stage st has landed, and past the barrier every warp is done with
    // stage st - 1, whose buffer the next stage's copies then fill
    cp_async_wait<0>();
    __syncthreads();
    if (st + 1 < n_stages) {
      load_stage(st + 1);
      cp_async_commit();
    }
    const __nv_bfloat16* kt = sk + (st % STAGES) * (NK * LD);
    const int kbase = w.k0 + st * NK;

    // S half: rows 16wr.., keys 16wc..16wc+15 of the stage
    {
      float s[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t af[4], bk[4];
        ldmatrix_x4(af, sq + (wr * 16 + (lane & 15)) * LD + kk + (lane >> 4) * 8);
        ldmatrix_x4(bk, kt + (wc * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                            kk + ((lane >> 3) & 1) * 8);
        mma_bf16(s[0], af, bk[0], bk[1]);
        mma_bf16(s[1], af, bk[2], bk[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = wr * 16 + (lane >> 2) + hh * 8;
          const int key = wc * 16 + n * 8 + (lane & 3) * 2;
          store2(ss + row * SLD + key, s[n][2 * hh] * a.sl2,
                 s[n][2 * hh + 1] * a.sl2);
        }
    }
    __syncthreads();

    // the warp's 16 rows x 32 keys, in the MMA accumulator layout
    float p[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = wr * 16 + (lane >> 2) + hh * 8;
        const float2 x = *reinterpret_cast<const float2*>(
            ss + row * SLD + n * 8 + (lane & 3) * 2);
        p[n][2 * hh] = x.x;
        p[n][2 * hh + 1] = x.y;
      }
    // online softmax in log2 units; keys at or past k1 are masked
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kbase + n * 8 + (lane & 3) * 2 + (e & 1);
        const float x = key < w.k1 ? p[n][e] : NEG_INF;
        p[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      alpha[hh] = exp2f(m[hh] - mx[hh]);
      m[hh] = mx[hh];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kbase + n * 8 + (lane & 3) * 2 + (e & 1);
        const float pe = key < w.k1 ? exp2f(p[n][e] - mx[e >> 1]) : 0.f;
        rs[e >> 1] += pe;
        p[n][e] = pe;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + rs[hh];
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // O += P V over the warp's 256 columns; V^T from the key stage
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      uint32_t ah[4], al[4];
      split_bf16(p[2 * kk][0], p[2 * kk][1], ah[0], al[0]);
      split_bf16(p[2 * kk][2], p[2 * kk][3], ah[1], al[1]);
      split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], ah[2], al[2]);
      split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], ah[3], al[3]);
      const int vrow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const __nv_bfloat16* vt = kt + vrow * LD + wc * 256 + (lane >> 4) * 8;
#pragma unroll
      for (int dp = 0; dp < 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vt + dp * 16);
        mma_bf16(o[2 * dp], ah, bv[0], bv[1]);
        mma_bf16(o[2 * dp], al, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], ah, bv[2], bv[3]);
        mma_bf16(o[2 * dp + 1], al, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  const int col0 = wc * 256 + (lane & 3) * 2;
  if (a.splits == 1) {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float inv = 1.f / fmaxf(l[hh], 1e-30f);
      __nv_bfloat16* orow =
          out + (row_t + wr * 16 + (lane >> 2) + hh * 8) * RANK + col0;
#pragma unroll
      for (int n = 0; n < 32; ++n)
        store2(orow + n * 8, o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
    }
  } else {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const size_t hrow = (row_t + wr * 16 + (lane >> 2) + hh * 8) * a.splits +
                          w.split;
      if (wc == 0 && (lane & 3) == 0) {
        a.part_ml[hrow * 2] = m[hh];
        a.part_ml[hrow * 2 + 1] = l[hh];
      }
      float* arow = a.part_acc + hrow * RANK + col0;
#pragma unroll
      for (int n = 0; n < 32; ++n)
        store2(arow + n * 8, o[n][2 * hh], o[n][2 * hh + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) mla_f32_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);           // F_HEADS x D
  float* sk = sq + F_HEADS * D;                         // NK x F_LDK
  float* sp = sk + NK * F_LDK;                          // F_HEADS x NK
  float* salpha = sp + F_HEADS * NK;                    // F_HEADS
  float* sm = salpha + F_HEADS;
  float* sl = sm + F_HEADS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Work w;
  const bool busy = find_work(a, F_HEADS, w);
  const size_t row_t = (size_t)w.t * a.h + w.hb * F_HEADS;

  if (!busy) {
    if (a.splits == 1) {
      float* o = static_cast<float*>(a.out) + row_t * RANK;
      for (int i = tid; i < F_HEADS * RANK; i += THREADS) o[i] = 0.f;
    } else if (tid < F_HEADS) {
      float* ml = a.part_ml + ((row_t + tid) * a.splits + w.split) * 2;
      ml[0] = NEG_INF;
      ml[1] = 0.f;
    }
    return;
  }

  const float* q = static_cast<const float*>(a.q) + row_t * D;
  for (int i = tid; i < F_HEADS * D; i += THREADS) sq[i] = q[i];
  const float* ckv = static_cast<const float*>(a.ckv) +
                     (long long)w.slot * a.ck_s0;
  const float* krope = static_cast<const float*>(a.krope) +
                       (long long)w.slot * a.kr_s0;

  float acc[F_HEADS][2];
#pragma unroll
  for (int hh = 0; hh < F_HEADS; ++hh) acc[hh][0] = acc[hh][1] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int kb = w.k0; kb < w.k1; kb += NK) {
    for (int i = tid; i < NK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int row = kb + r;
      float x = 0.f;
      if (row < w.k1)
        x = d < RANK ? ckv[row * a.ck_s1 + d] : krope[row * a.kr_s1 + d - RANK];
      sk[r * F_LDK + d] = x;
    }
    __syncthreads();
    // warp: heads 2 warp, 2 warp + 1; lane: the key
    const bool valid = kb + lane < w.k1;
    const float* q0 = sq + (2 * warp) * D;
    const float* q1 = q0 + D;
    const float* kr = sk + lane * F_LDK;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float k = kr[d];
      s0 = fmaf(q0[d], k, s0);
      s1 = fmaf(q1[d], k, s1);
    }
    float s[2] = {valid ? s0 * a.sl2 : NEG_INF, valid ? s1 * a.sl2 : NEG_INF};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = s[hh];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[hh], mx);
      const float pe = valid ? exp2f(s[hh] - m_new) : 0.f;
      const float alpha = exp2f(m[hh] - m_new);
      l[hh] = l[hh] * alpha + warp_sum(pe);
      m[hh] = m_new;
      sp[(2 * warp + hh) * NK + lane] = pe;
      if (lane == 0) salpha[2 * warp + hh] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < F_HEADS; ++hh) {
      const float al = salpha[hh];
      float a0 = acc[hh][0] * al, a1 = acc[hh][1] * al;
#pragma unroll 8
      for (int key = 0; key < NK; ++key) {
        const float pe = sp[hh * NK + key];
        a0 = fmaf(pe, sk[key * F_LDK + tid], a0);
        a1 = fmaf(pe, sk[key * F_LDK + tid + THREADS], a1);
      }
      acc[hh][0] = a0;
      acc[hh][1] = a1;
    }
    __syncthreads();
  }
  if (lane == 0) {
    sm[2 * warp] = m[0];
    sm[2 * warp + 1] = m[1];
    sl[2 * warp] = l[0];
    sl[2 * warp + 1] = l[1];
  }
  __syncthreads();
  if (a.splits == 1) {
    float* out = static_cast<float*>(a.out) + row_t * RANK;
#pragma unroll
    for (int hh = 0; hh < F_HEADS; ++hh) {
      const float inv = 1.f / fmaxf(sl[hh], 1e-30f);
      out[hh * RANK + tid] = acc[hh][0] * inv;
      out[hh * RANK + tid + THREADS] = acc[hh][1] * inv;
    }
  } else {
#pragma unroll
    for (int hh = 0; hh < F_HEADS; ++hh) {
      const size_t hrow = (row_t + hh) * a.splits + w.split;
      if (tid == 0) {
        a.part_ml[hrow * 2] = sm[hh];
        a.part_ml[hrow * 2 + 1] = sl[hh];
      }
      a.part_acc[hrow * RANK + tid] = acc[hh][0];
      a.part_acc[hrow * RANK + tid + THREADS] = acc[hh][1];
    }
  }
}

// ---------------------------------------------------------------------------
// the split chunks' merge: one CTA per (token, head), in chunk order
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(128) mla_merge_kernel(const Args a) {
  const size_t hrow = blockIdx.x;                 // token * H + head
  const float* ml = a.part_ml + hrow * a.splits * 2;
  float mmax = NEG_INF;
  for (int s = 0; s < a.splits; ++s)
    if (ml[2 * s + 1] > 0.f) mmax = fmaxf(mmax, ml[2 * s]);
  float acc[4] = {0.f, 0.f, 0.f, 0.f}, l = 0.f;
  const int col = threadIdx.x * 4;
  for (int s = 0; s < a.splits; ++s) {
    if (!(ml[2 * s + 1] > 0.f)) continue;
    const float f = exp2f(ml[2 * s] - mmax);
    l += f * ml[2 * s + 1];
    const float4 x = *reinterpret_cast<const float4*>(
        a.part_acc + (hrow * a.splits + s) * RANK + col);
    acc[0] += f * x.x;
    acc[1] += f * x.y;
    acc[2] += f * x.z;
    acc[3] += f * x.w;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* out = static_cast<T*>(a.out) + hrow * RANK + col;
  store2(out, acc[0] * inv, acc[1] * inv);
  store2(out + 2, acc[2] * inv, acc[3] * inv);
}

}  // namespace mla
}  // namespace

// Returns a CUDA error code (0 on success).  dtype: 0 float32, 1 bfloat16
// (q, c_kv, k_rope and out share it).  c_kv (N, S, 512) and k_rope (N, S,
// 64) are read through their (slot, row) element strides.  The sweep is cut
// into `splits` chunks of `chunk` rows (a multiple of 32); with splits > 1,
// part_ml (T * H * splits * 2) and part_acc (T * H * splits * 512) f32
// scratch hold the partials the merge reads.
extern "C" int repro_mla_attention(
    const void* q, const void* c_kv, const void* k_rope,
    const int32_t* token_slot, const int32_t* lengths, void* out,
    float* part_ml, float* part_acc, int dtype, int t, int h, int n,
    int sweep, int chunk, int splits, long long ck_s0, long long ck_s1,
    long long kr_s0, long long kr_s1, float scale, void* stream) {
  using namespace mla;
  if (t <= 0) return 0;
  if ((dtype != 0 && dtype != 1) || h <= 0 || splits < 1 || chunk <= 0 ||
      chunk % NK || (splits > 1 && (!part_ml || !part_acc)))
    return cudaErrorInvalidValue;
  const int heads = dtype == 1 ? HEADS : F_HEADS;
  if (h % heads) return cudaErrorInvalidValue;
  Args a{q, c_kv, k_rope, token_slot, lengths, out, part_ml, part_acc,
         t, h, n, sweep, chunk, splits, ck_s0, ck_s1, kr_s0, kr_s1,
         scale * LOG2E};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)t * (unsigned)(h / heads) * (unsigned)splits;
  cudaError_t err;
  if (dtype == 1) {
    err = cudaFuncSetAttribute(mla_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BF16);
    if (err != cudaSuccess) return err;
    mla_bf16_kernel<<<grid, THREADS, SMEM_BF16, st>>>(a);
  } else {
    err = cudaFuncSetAttribute(mla_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_F32);
    if (err != cudaSuccess) return err;
    mla_f32_kernel<<<grid, THREADS, SMEM_F32, st>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const unsigned rows = (unsigned)t * (unsigned)h;
  if (dtype == 1)
    mla_merge_kernel<__nv_bfloat16><<<rows, RANK / 4, 0, st>>>(a);
  else
    mla_merge_kernel<float><<<rows, RANK / 4, 0, st>>>(a);
  return cudaGetLastError();
}
