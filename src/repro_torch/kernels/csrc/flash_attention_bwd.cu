// The backward of causal GQA flash attention, for Hopper (sm_90a), with a
// plain C interface loaded through ctypes.
//
// Replaces no TPU kernel: the JAX package differentiates its attention
// through XLA (src/repro/kernels/flash_attention.py `flash_attention` has no
// backward Pallas kernel).  It is the gradient of the port's forward kernel
// (csrc/flash_attention.cu), which training on the card runs, so that
// dQ, dK and dV come from the same scores the forward took.
//
// Given q (B, S, H, D), k and v (B, S, KV, D), the forward's output O and
// its row log-sum-exp L (B, H, S) f32 of the scaled scores, and dO (B, S,
// H, D): with s = scale q.k, P = exp(s - L) (causal: query i sees keys
// j <= i + q_offset), D_i = sum_d dO_i O_i,
//   dV = P^T dO,  dS = P (dO V^T - D),  dQ = scale dS K,  dK = scale dS^T Q,
// dK and dV summed over the group's query heads.
//
// What bounds it on the card: operations.  At training's shapes (Qwen3-8B,
// B 2, S 2048, 32 heads over 8, head_dim 128) it does seven causal S x S x
// D products per head (S, dP, dQ in one pass; S, dP, dV, dK in the other),
// ~240 GFLOP against ~50 MB of operands, far above the card's ridge.
//
// What the design does about it (a simple kernel that is right first;
// TMA, wgmma and warp specialisation are for a later change):
//   * Two kernels, both deterministic: no atomics, every sum taken by one
//     thread in a fixed order, so two calls are bitwise equal.
//     - dQ: one CTA per (64-query tile, query head, batch row), the tiles
//       with the most keys first.  Its prologue computes D for its rows
//       (one warp a row, a fixed shuffle tree) and stores it for the other
//       kernel; it then sweeps the tile's causal key tiles.
//     - dK/dV: one CTA per (64-key tile, KV head, batch row), key tile 0
//       (the most queries) first.  It sweeps every query head of the GQA
//       group and each head's causal 32-query tiles, summing dK and dV in
//       f32 registers: the group's reduction needs no atomics.  It runs
//       after dQ on the stream and reads D from it.
//   * Products: four warps, each owning 16 rows of the tile's output.
//     Every product reads both operands from shared memory with the
//     reduction axis contiguous (the wrapper-side layouts of Q, K, V and
//     dO give S and dP; K, Q and dO are also stored transposed for dQ, dK
//     and dV; P and dS go through a warp's own rows of shared memory).
//     bf16 runs mma.sync m16n8k16 with f32 sums (P and dS rounded to bf16,
//     as the products' A); f32 runs the same tiles as FMAs on the CUDA
//     cores, kept for exact checks.  Rows are padded by 16 bytes so that
//     a fragment's eight rows fall in distinct banks.
//   * Loads: 16-byte vector loads into shared memory, rows past S zeroed;
//     every causal and ragged element is masked to 0 before P and dS.
// Takes what training gives: Sq == Skv, an int q_offset >= 0, d_v ==
// d_qk, head_dim 64 or 128, any group (the wrapper holds it to the
// forward's pairs), float32 or bfloat16.  Head dim 256 returns -1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;   // four warps
constexpr int BQ = 64;         // dQ: query rows per CTA
constexpr int BKEY = 64;       // keys per tile (both kernels)
constexpr int BQ2 = 32;        // dK/dV: query rows per inner tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;   // (B, H, S)
  float* delta;       // (B, H, S): written by dQ, read by dK/dV
  void* dq;
  void* dk;
  void* dv;
  int batch, s, n_heads, n_kv, q_offset;
  float scale;
};

template <typename T>
struct Pad;
template <>
struct Pad<__nv_bfloat16> {
  static constexpr int V = 8;   // 16 bytes
};
template <>
struct Pad<float> {
  static constexpr int V = 4;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c (16 x 8, f32) += a (16 x 16, row-major) b (16 x 8, column-major), bf16
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's tile product c (16 x 8 NT) += A (16 x K) B^T, where A's row r is
// at a + r lda and B's row n (an output column) at b + n ldb, both with the
// reduction axis contiguous.  c is in mma's accumulator layout: c[nt][i] is
// row gid + 8 (i / 2), column 8 nt + 2 tig + i % 2 (gid = lane / 4, tig =
// lane % 4).
template <int NT>
__device__ __forceinline__ void tile_mma(float (&c)[NT][4],
                                         const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* b, int ldb,
                                         int k) {
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  for (int k0 = 0; k0 < k; k0 += 16) {
    uint32_t af[4];
    af[0] = ld32(a + gid * lda + k0 + 2 * tig);
    af[1] = ld32(a + (gid + 8) * lda + k0 + 2 * tig);
    af[2] = ld32(a + gid * lda + k0 + 8 + 2 * tig);
    af[3] = ld32(a + (gid + 8) * lda + k0 + 8 + 2 * tig);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* bp = b + (nt * 8 + gid) * ldb + k0 + 2 * tig;
      mma16816(c[nt], af, ld32(bp), ld32(bp + 8));
    }
  }
}

// The same product in f32 on the CUDA cores, each thread summing its own
// accumulator elements over k in order.
template <int NT>
__device__ __forceinline__ void tile_mma(float (&c)[NT][4], const float* a,
                                         int lda, const float* b, int ldb,
                                         int k) {
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* ar = a + (gid + 8 * (i >> 1)) * lda;
      const float* br = b + (nt * 8 + 2 * tig + (i & 1)) * ldb;
      float acc = c[nt][i];
      for (int kk = 0; kk < k; ++kk) acc = fmaf(ar[kk], br[kk], acc);
      c[nt][i] = acc;
    }
}

// Rows [row0, row0 + n) of head h of a (B, S, heads, D) tensor into dst
// (n rows of ld), rows past S as zeros; with dt, also transposed into dt
// (D rows of ldt, dt[d][r]).
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, int ld, T* dt, int ldt,
                                          const T* src, int b, int row0,
                                          int n, int s, int heads, int h) {
  constexpr int V = 16 / sizeof(T);
  for (int idx = threadIdx.x; idx < n * (D / V); idx += THREADS) {
    const int r = idx / (D / V);
    const int c = (idx % (D / V)) * V;
    const int pos = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (pos < s)
      val = *reinterpret_cast<const uint4*>(
          src + (((long long)b * s + pos) * heads + h) * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    if (dt != nullptr) {
      const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int j = 0; j < V; ++j) dt[(c + j) * ldt + r] = e[j];
    }
  }
}

// Whether query position pos sees key `key`.
__device__ __forceinline__ bool visible(const Params& p, int pos, int key) {
  return pos < p.s && key < p.s && key <= pos + p.q_offset;
}

// ---------------------------------------------------------------------------
// dQ (and D): one CTA per (64-query tile, query head, batch row)
// ---------------------------------------------------------------------------
template <typename T, int D>
struct DqLayout {
  static constexpr int LD = D + Pad<T>::V;      // Q, dO, K, V rows
  static constexpr int LDT = BKEY + Pad<T>::V;  // K^T and dS rows
  static constexpr int BYTES =
      (2 * BQ * LD + 2 * BKEY * LD + D * LDT + BQ * LDT) * (int)sizeof(T) +
      2 * BQ * (int)sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const Params p) {
  using L = DqLayout<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sdo = sq + BQ * L::LD;
  T* sk = sdo + BQ * L::LD;
  T* sv = sk + BKEY * L::LD;
  T* skt = sv + BKEY * L::LD;
  T* sds = skt + D * L::LDT;
  float* slse = reinterpret_cast<float*>(sds + BQ * L::LDT);
  float* sdelta = slse + BQ;

  const int qt = gridDim.x - 1 - blockIdx.x;   // the most keys first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.n_heads / p.n_kv);
  const int q0 = qt * BQ;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* o = static_cast<const T*>(p.out);
  const T* dout = static_cast<const T*>(p.dout);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;
  const int tig = lane & 3;

  load_rows<T, D>(sq, L::LD, nullptr, 0, q, b, q0, BQ, p.s, p.n_heads, h);
  load_rows<T, D>(sdo, L::LD, nullptr, 0, dout, b, q0, BQ, p.s, p.n_heads, h);
  // D = rowsum(dO O) and L for the tile's rows (0 past S)
  for (int r = warp; r < BQ; r += THREADS / 32) {
    const int pos = q0 + r;
    float acc = 0.f;
    if (pos < p.s) {
      const long long base = (((long long)b * p.s + pos) * p.n_heads + h) * D;
      for (int d = lane; d < D; d += 32)
        acc = fmaf(to_f(dout[base + d]), to_f(o[base + d]), acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      const long long li = ((long long)b * p.n_heads + h) * p.s + pos;
      sdelta[r] = acc;
      slse[r] = pos < p.s ? p.lse[li] : 0.f;
      if (pos < p.s) p.delta[li] = acc;
    }
  }

  const int r_lo = warp * 16;   // this warp's rows of the tile
  float dq[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[nd][i] = 0.f;
  const int last_q = min(p.s - 1, q0 + BQ - 1);
  const int kend = max(0, min(p.s, last_q + p.q_offset + 1));   // keys [0, kend)
  const int n_kt = (kend + BKEY - 1) / BKEY;
  T* ds_w = sds + r_lo * L::LDT;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BKEY;
    __syncthreads();   // the previous tile's K, V and dS reads are done
    load_rows<T, D>(sk, L::LD, skt, L::LDT, k, b, k0, BKEY, p.s, p.n_kv, kvh);
    load_rows<T, D>(sv, L::LD, nullptr, 0, v, b, k0, BKEY, p.s, p.n_kv, kvh);
    __syncthreads();
    float s[BKEY / 8][4], dp[BKEY / 8][4];
#pragma unroll
    for (int nt = 0; nt < BKEY / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
    tile_mma(s, sq + r_lo * L::LD, L::LD, sk, L::LD, D);
    tile_mma(dp, sdo + r_lo * L::LD, L::LD, sv, L::LD, D);
#pragma unroll
    for (int nt = 0; nt < BKEY / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = gid + 8 * (i >> 1);
        const int c = nt * 8 + 2 * tig + (i & 1);
        float ds = 0.f;
        if (visible(p, q0 + r_lo + r, k0 + c)) {
          const float pr = expf(fmaf(s[nt][i], p.scale, -slse[r_lo + r]));
          ds = pr * (dp[nt][i] - sdelta[r_lo + r]);
        }
        ds_w[r * L::LDT + c] = from_f<T>(ds);
      }
    __syncwarp();
    tile_mma(dq, ds_w, L::LDT, skt, L::LDT, BKEY);
  }
  T* dq_out = static_cast<T*>(p.dq);
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = q0 + r_lo + gid + 8 * (i >> 1);
      const int d = nd * 8 + 2 * tig + (i & 1);
      if (pos < p.s)
        dq_out[(((long long)b * p.s + pos) * p.n_heads + h) * D + d] =
            from_f<T>(dq[nd][i] * p.scale);
    }
}

// ---------------------------------------------------------------------------
// dK and dV: one CTA per (64-key tile, KV head, batch row)
// ---------------------------------------------------------------------------
template <typename T, int D>
struct DkvLayout {
  static constexpr int LD = D + Pad<T>::V;     // K, V, Q, dO rows
  static constexpr int LDT = BQ2 + Pad<T>::V;  // Q^T, dO^T, P and dS rows
  static constexpr int BYTES =
      (2 * BKEY * LD + 2 * BQ2 * LD + 2 * D * LDT + 2 * BKEY * LDT) *
          (int)sizeof(T) +
      2 * BQ2 * (int)sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const Params p) {
  using L = DkvLayout<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + BKEY * L::LD;
  T* sq = sv + BKEY * L::LD;
  T* sdo = sq + BQ2 * L::LD;
  T* sqt = sdo + BQ2 * L::LD;
  T* sdot = sqt + D * L::LDT;
  T* sp = sdot + D * L::LDT;
  T* sds = sp + BKEY * L::LDT;
  float* slse = reinterpret_cast<float*>(sds + BKEY * L::LDT);
  float* sdelta = slse + BQ2;

  const int kt = blockIdx.x;   // key tile 0 (the most queries) first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = p.n_heads / p.n_kv;
  const int k0 = kt * BKEY;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int r_lo = warp * 16;   // this warp's keys of the tile

  load_rows<T, D>(sk, L::LD, nullptr, 0, k, b, k0, BKEY, p.s, p.n_kv, kvh);
  load_rows<T, D>(sv, L::LD, nullptr, 0, v, b, k0, BKEY, p.s, p.n_kv, kvh);
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[nd][i] = dv[nd][i] = 0.f;
  // the first query tile with a position that sees key k0
  const int first = max(0, k0 - p.q_offset) / BQ2;
  const int n_qt = (p.s + BQ2 - 1) / BQ2;
  T* p_w = sp + r_lo * L::LDT;
  T* ds_w = sds + r_lo * L::LDT;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    for (int qt = first; qt < n_qt; ++qt) {
      const int q0 = qt * BQ2;
      __syncthreads();   // the previous tile's reads are done
      load_rows<T, D>(sq, L::LD, sqt, L::LDT, q, b, q0, BQ2, p.s, p.n_heads,
                      h);
      load_rows<T, D>(sdo, L::LD, sdot, L::LDT, dout, b, q0, BQ2, p.s,
                      p.n_heads, h);
      if (threadIdx.x < BQ2) {
        const int pos = q0 + threadIdx.x;
        const long long li = ((long long)b * p.n_heads + h) * p.s + pos;
        slse[threadIdx.x] = pos < p.s ? p.lse[li] : 0.f;
        sdelta[threadIdx.x] = pos < p.s ? p.delta[li] : 0.f;
      }
      __syncthreads();
      // S^T and dP^T: this warp's 16 keys x the tile's 32 queries
      float st[BQ2 / 8][4], dpt[BQ2 / 8][4];
#pragma unroll
      for (int nt = 0; nt < BQ2 / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[nt][i] = dpt[nt][i] = 0.f;
      tile_mma(st, sk + r_lo * L::LD, L::LD, sq, L::LD, D);
      tile_mma(dpt, sv + r_lo * L::LD, L::LD, sdo, L::LD, D);
#pragma unroll
      for (int nt = 0; nt < BQ2 / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = gid + 8 * (i >> 1);
          const int c = nt * 8 + 2 * tig + (i & 1);
          float pr = 0.f, ds = 0.f;
          if (visible(p, q0 + c, k0 + r_lo + r)) {
            pr = expf(fmaf(st[nt][i], p.scale, -slse[c]));
            ds = pr * (dpt[nt][i] - sdelta[c]);
          }
          p_w[r * L::LDT + c] = from_f<T>(pr);
          ds_w[r * L::LDT + c] = from_f<T>(ds);
        }
      __syncwarp();
      tile_mma(dv, p_w, L::LDT, sdot, L::LDT, BQ2);
      tile_mma(dk, ds_w, L::LDT, sqt, L::LDT, BQ2);
    }
  }
  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + r_lo + gid + 8 * (i >> 1);
      const int d = nd * 8 + 2 * tig + (i & 1);
      if (key < p.s) {
        const long long at = (((long long)b * p.s + key) * p.n_kv + kvh) * D + d;
        dk_out[at] = from_f<T>(dk[nd][i] * p.scale);
        dv_out[at] = from_f<T>(dv[nd][i]);
      }
    }
}

// Sets both kernels' shared-memory sizes once per device, then launches
// dQ (which stores D) and dK/dV on the stream, in that order.
template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  auto kq = flash_bwd_dq_kernel<T, D>;
  auto kkv = flash_bwd_dkv_kernel<T, D>;
  constexpr int QB = DqLayout<T, D>::BYTES;
  constexpr int KVB = DkvLayout<T, D>::BYTES;
  static int sized = -1;   // the device whose attributes are set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sized != dev) {
    err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               QB);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(
        kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, KVB);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = dev;
  }
  kq<<<dim3((p.s + BQ - 1) / BQ, p.n_heads, p.batch), THREADS, QB, stream>>>(
      p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kkv<<<dim3((p.s + BKEY - 1) / BKEY, p.n_kv, p.batch), THREADS, KVB,
        stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout, dq, dk and dv).
// q, out, dout and dq are contiguous (B, S, H, D); k, v, dk and dv
// contiguous (B, S, KV, D); lse the forward's (B, H, S) f32 log-sum-exp
// rows; delta (B, H, S) f32 scratch.  Query i sees keys [0, i + q_offset].
// Returns -1 for a shape this build does not take (head_dim other than 64
// or 128, H not a multiple of KV, q_offset < 0, B or H over 65535), else
// the launches' CUDA error code.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int dtype, int batch, int s, int n_heads, int n_kv,
    int head_dim, int q_offset, float scale, void* stream) {
  if (batch == 0 || s == 0) return 0;
  if (n_kv <= 0 || n_heads % n_kv || q_offset < 0 || batch > 65535 ||
      n_heads > 65535)
    return -1;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.batch = batch;
  p.s = s;
  p.n_heads = n_heads;
  p.n_kv = n_kv;
  p.q_offset = q_offset;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && head_dim == 64) return launch<__nv_bfloat16, 64>(p, st);
  if (dtype == 1 && head_dim == 128) return launch<__nv_bfloat16, 128>(p, st);
  if (dtype == 0 && head_dim == 64) return launch<float, 64>(p, st);
  if (dtype == 0 && head_dim == 128) return launch<float, 128>(p, st);
  return -1;
}
