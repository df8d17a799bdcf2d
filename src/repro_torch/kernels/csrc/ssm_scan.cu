// Mamba-1 selective scan for Hopper (sm_90a), with a plain C interface
// loaded through ctypes:
//   h_t = exp(dt_t * a) * h_{t-1} + dt_t * x_t * b_t
//   y_t = h_t . c_t + d * x_t
// per channel, with an (N,) state per (batch row, channel).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py `ssm_scan`
// (`_kernel`).  What it keeps: the (C, N) state stays on chip (in
// registers) for the whole sequence sweep, so device-memory traffic is the
// inputs and outputs only.  What it leaves: on the TPU the sequence is the
// minor, sequential grid axis and a (Cb, N) VMEM scratch carries the state
// from one grid step to the next; here blocks run in no order, so the
// sequence becomes a loop inside the block, and channels, which are
// independent, are the parallel axis.
//
// What bounds it on the card: the C * N exponentials of every token on the
// special-function units (16 per clock per SM on compute capability 9.0);
// its bytes (x, dt, y, a, h0, h_final) are ~37 MB for a 256-token chunk at
// Jamba's C = 16384, N = 16, which the HBM moves in less time.  At ~8 issue
// slots per (token, state) the schedulers are nearly as busy as the
// special-function units, so the design spends few instructions per
// exponential and keeps many of them in flight.  Measured
// (tools/scan_probe.py, PERF.md §6) it runs at ~0.36 of both rates: with 4
// warps a scheduler no one part bounds it (the ring, the y reduction and
// the loads of b, c, dt and x each take 10-18%, the exponentials 2%).  The
// design:
//   * Each lane holds SPL = 4 states of one channel in registers; L = N / 4
//     neighbouring lanes share a channel (65536 lanes at C = 16384, N =
//     16).
//   * Tokens go in groups of U = 8, fully unrolled.  The U x SPL factors
//     exp(dt * a) of a group do not depend on the state, so they are all
//     issued first; only the h = da * h + dt * x * b chain is serial.  Each
//     factor is one ex2.approx.ftz of dt * (a * log2 e), with a * log2 e
//     formed once per lane.  A group past the last token runs on zeros
//     (dt = 0 gives da = 1 and no input: h is unchanged), so a remainder
//     needs no second loop.
//   * y of a group is reduced across the L lanes of a channel in one
//     transpose-reduce: at each of log2(L) shuffle steps a lane keeps half
//     of its tokens and sends the other half, so each lane ends with U / L
//     whole sums (6 shuffles a lane for 8 tokens at L = 4, against 16 for
//     a butterfly per token, and every lane stores).  d * x joins on lane
//     0.
//   * Tiles of TS = 32 tokens stream through a STAGES-deep ring in shared
//     memory: x and dt by 16-byte cp.async (coalesced along the channels;
//     a piece past the ragged channel edge or an unaligned input is copied
//     element by element), b and c (shared by every channel of the batch
//     row) through registers into f32 rows, all issued STAGES - 1 tiles
//     before the tile is scanned.  y goes back through shared memory and
//     is written coalesced while the next tile is scanned.  One barrier a
//     tile.
//   * Everything is accumulated in f32; y is rounded once, to x's dtype.
//     Dead lanes past the channel edge compute on zeros and store nothing;
//     any S, S = 1 included, runs without padding; h0 == NULL starts from
//     zeros.
// A time-parallel (chunked) form would double the exponentials; at the
// port's shapes the channels alone give 15-16 warps on every SM, and more
// lanes per channel (SPL 2) ran slower in proportion to their extra
// instructions, so it is left out.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SPL = 4;      // states per lane
constexpr int U = 8;        // tokens per unrolled group
constexpr int TS = 32;      // tokens per staged tile
constexpr int STAGES = 2;   // tiles in the ring
constexpr float LOG2E = 1.4426950408889634f;
static_assert(TS % U == 0, "a tile is whole groups");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 zero-fills the 16 destination bytes without reading src
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0));
}

// SPL consecutive f32 of shared memory (16- or 8-byte aligned)
__device__ __forceinline__ void lds(const float* p, float (&v)[SPL]) {
  if constexpr (SPL % 4 == 0) {
#pragma unroll
    for (int j = 0; j < SPL; j += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + j);
      v[j] = f.x, v[j + 1] = f.y, v[j + 2] = f.z, v[j + 3] = f.w;
    }
  } else if constexpr (SPL == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x, v[1] = f.y;
  } else {
#pragma unroll
    for (int j = 0; j < SPL; ++j) v[j] = p[j];
  }
}

// The transpose-reduce of U per-token partial sums across the L lanes of a
// channel (lane r = lane % L): at step OFF a lane keeps the upper half of
// its CNT values when bit OFF of r is set, else the lower half, and adds
// its partner's copy of them.  With L <= U lane r ends with the sums of
// tokens r * U / L + [0, U / L) in p[0 ..]; with L > U the last steps are a
// butterfly and lanes r, r ^ 1, ... hold token r * U / L's sum.
template <int OFF, int CNT>
__device__ __forceinline__ void transpose_reduce(float (&p)[U], int r) {
  if constexpr (OFF >= 1) {
    if constexpr (CNT > 1) {
      constexpr int HALF = CNT / 2;
      const bool up = (r & OFF) != 0;
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const float send = up ? p[i] : p[i + HALF];
        const float keep = up ? p[i + HALF] : p[i];
        p[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
    } else {
      p[0] += __shfl_xor_sync(0xffffffffu, p[0], OFF);
    }
    transpose_reduce<OFF / 2, (CNT > 1 ? CNT / 2 : 1)>(p, r);
  }
}

// Everything a launch reads; row r = bb * S + t of x, dt, b and c starts at
// element r * s{x,dt,b,c}; y is contiguous (B, S, C); a, h0 and h_out are
// contiguous (C, N) / (B, C, N).  vec_*: the rows of x, dt and y may be
// copied in 16-byte pieces (base and row pitch 16-byte aligned).
template <typename T>
struct Args {
  const T* x;
  const float* dt;
  const float* a;
  const T* b;
  const T* c;
  const float* d;
  const float* h0;
  T* y;
  float* h_out;
  int S, C;
  long long sx, sdt, sb, sc;
  int vec_x, vec_dt, vec_y;
};

template <typename T, int N>
struct Shape {
  static constexpr int L = N / SPL;          // lanes per channel
  static constexpr int CH = THREADS / L;     // channels per block
  static constexpr int YLD = CH + 16 / (int)sizeof(T);   // ys row pitch
  static constexpr int BCN = TS * N / THREADS;   // b (and c) values a lane stages
  // dynamic shared memory: dts [STAGES][TS][CH] f32, bc [STAGES][TS][2][N]
  // f32, xs [STAGES][TS][CH] T, ys [2][TS][YLD] T
  static constexpr int DTS = STAGES * TS * CH;
  static constexpr int BC = STAGES * TS * 2 * N;
  static constexpr int XS = STAGES * TS * CH;
  static constexpr int YS = 2 * TS * YLD;
  static constexpr int SMEM = (DTS + BC) * 4 + (XS + YS) * (int)sizeof(T);
  static_assert(N % SPL == 0 && 32 % L == 0, "N / SPL lanes must divide a warp");
  static_assert(TS * N % THREADS == 0, "every lane stages as many b, c values");
  static_assert(CH * sizeof(T) % 16 == 0 && CH * 4 % 16 == 0,
                "a block's channels are whole 16-byte pieces");
};

// x or dt rows [t0, t0 + nt) of batch row bb, channels [c0, c0 + CH), into
// dst [TS][CH] (rows past nt and channels past C zero-filled)
template <typename E, int CH>
__device__ __forceinline__ void stage_rows(E* dst, const E* src,
                                           long long stride, long long row0,
                                           int nt, int c0, int C, bool vec) {
  constexpr int PER = 16 / (int)sizeof(E);
  constexpr int PPR = CH / PER;
  for (int i = threadIdx.x; i < TS * PPR; i += THREADS) {
    const int t = i / PPR;
    const int k = (i % PPR) * PER;
    E* d = dst + t * CH + k;
    const E* s = src + (row0 + t) * stride + c0 + k;
    const int valid = t < nt ? min(PER, C - c0 - k) : 0;
    if (vec && (valid == PER || valid <= 0)) {
      cp_async16(d, valid > 0 ? s : src, valid > 0);
    } else {
#pragma unroll
      for (int e = 0; e < PER; ++e) d[e] = e < valid ? s[e] : from_f32<E>(0.f);
    }
  }
}

// grid (ceil(C / CH), B), THREADS lanes: lane `tid` runs states
// [n0, n0 + SPL) of channel c0 + tid / L.
template <typename T, int N>
__global__ void __launch_bounds__(THREADS, 2)
    ssm_scan_kernel(const Args<T> a) {
  using Sh = Shape<T, N>;
  constexpr int L = Sh::L, CH = Sh::CH, YLD = Sh::YLD, BCN = Sh::BCN;
  extern __shared__ __align__(16) unsigned char smem[];
  float* dts = reinterpret_cast<float*>(smem);
  float* bc = dts + Sh::DTS;
  T* xs = reinterpret_cast<T*>(bc + Sh::BC);
  T* ys = xs + Sh::XS;

  const int tid = threadIdx.x;
  const int bb = blockIdx.y;
  const int c0 = blockIdx.x * CH;
  const int ch = tid / L;
  const int r = tid % L;
  const int n0 = r * SPL;
  const int cg = c0 + ch;
  const bool live = cg < a.C;
  const long long row0 = (long long)bb * a.S;

  float a2[SPL], h[SPL];
  float dl = 0.f;    // d on the channel's lane 0: y's d * x joins there
#pragma unroll
  for (int j = 0; j < SPL; ++j) a2[j] = h[j] = 0.f;
  if (live) {
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      a2[j] = a.a[(long long)cg * N + n0 + j] * LOG2E;
      if (a.h0 != nullptr) h[j] = a.h0[((long long)bb * a.C + cg) * N + n0 + j];
    }
    if (r == 0) dl = a.d[cg];
  }

  // b and c of a tile through registers: value i of this lane is (token
  // (tid + i * THREADS) / N, state (tid + i * THREADS) % N)
  float rb[BCN], rc[BCN];
  auto load_bc = [&](int t0, int nt) {
#pragma unroll
    for (int i = 0; i < BCN; ++i) {
      const int idx = tid + i * THREADS;
      const int t = idx / N, n = idx % N;
      const long long row = row0 + t0 + t;
      rb[i] = t < nt ? to_f32(a.b[row * a.sb + n]) : 0.f;
      rc[i] = t < nt ? to_f32(a.c[row * a.sc + n]) : 0.f;
    }
  };
  auto store_bc = [&](int buf) {
#pragma unroll
    for (int i = 0; i < BCN; ++i) {
      const int idx = tid + i * THREADS;
      const int t = idx / N, n = idx % N;
      bc[((buf * TS + t) * 2) * N + n] = rb[i];
      bc[((buf * TS + t) * 2 + 1) * N + n] = rc[i];
    }
  };
  // tile t0's y rows, out of ys[buf], 16-byte pieces along the channels
  auto write_y = [&](int buf, int t0) {
    constexpr int PER = 16 / (int)sizeof(T);
    constexpr int PPR = CH / PER;
    const int nt = min(TS, a.S - t0);
    const T* yb = ys + buf * TS * YLD;
    for (int i = tid; i < TS * PPR; i += THREADS) {
      const int t = i / PPR;
      const int k = (i % PPR) * PER;
      const int valid = min(PER, a.C - c0 - k);
      if (t >= nt || valid <= 0) continue;
      T* dst = a.y + (row0 + t0 + t) * a.C + c0 + k;
      if (a.vec_y && valid == PER) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(yb + t * YLD + k);
      } else {
        for (int e = 0; e < valid; ++e) dst[e] = yb[t * YLD + k + e];
      }
    }
  };

  auto stage = [&](int slot, int t0, int nt) {
    stage_rows<T, CH>(xs + slot * TS * CH, a.x, a.sx, row0 + t0, nt, c0, a.C,
                      a.vec_x);
    stage_rows<float, CH>(dts + slot * TS * CH, a.dt, a.sdt, row0 + t0, nt,
                          c0, a.C, a.vec_dt);
  };
  const int n_tiles = (a.S + TS - 1) / TS;
  // the ring's first STAGES - 1 tiles; one commit group a tile, empty or not
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < n_tiles) {
      const int nt = min(TS, a.S - k * TS);
      load_bc(k * TS, nt);
      store_bc(k);
      stage(k, k * TS, nt);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int k = 0; k < n_tiles; ++k) {
    const int slot = k % STAGES;
    const int t0 = k * TS;
    const int nt = min(TS, a.S - t0);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    // tile k's rows are in; tile k - 1's scan is done, so its y rows are
    // whole and its ring slot is free for tile k + STAGES - 1
    __syncthreads();
    const int ahead = k + STAGES - 1;
    if (ahead < n_tiles) {
      const int na = min(TS, a.S - ahead * TS);
      stage(ahead % STAGES, ahead * TS, na);
      load_bc(ahead * TS, na);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    if (k > 0) write_y((k - 1) & 1, t0 - TS);

    const float* dtb = dts + slot * TS * CH;
    const T* xb = xs + slot * TS * CH;
    const float* bcb = bc + slot * TS * 2 * N;
    T* yb = ys + (k & 1) * TS * YLD;
    const int groups = (nt + U - 1) / U;
    for (int g = 0; g < groups; ++g) {
      const int tg = g * U;
      float dtv[U], xv[U], da[U][SPL];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        dtv[u] = dtb[(tg + u) * CH + ch];
        xv[u] = to_f32(xb[(tg + u) * CH + ch]);
      }
      // the group's factors first: none depends on the state
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < SPL; ++j) da[u][j] = ex2(dtv[u] * a2[j]);
      float p[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float bv[SPL], cv[SPL];
        lds(bcb + (tg + u) * 2 * N + n0, bv);
        lds(bcb + ((tg + u) * 2 + 1) * N + n0, cv);
        const float dtx = dtv[u] * xv[u];
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          h[j] = fmaf(da[u][j], h[j], dtx * bv[j]);
          acc = fmaf(h[j], cv[j], acc);
        }
        p[u] = fmaf(dl, xv[u], acc);
      }
      transpose_reduce<L / 2, U>(p, r);
      constexpr int TPL = U >= L ? U / L : 1;     // token sums a lane holds
      if ((r * U) % L == 0) {
        const int first = tg + r * U / L;
#pragma unroll
        for (int i = 0; i < TPL; ++i) yb[(first + i) * YLD + ch] = from_f32<T>(p[i]);
      }
    }
    if (ahead < n_tiles) store_bc(ahead % STAGES);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  if (n_tiles > 0) {
    __syncthreads();
    write_y((n_tiles - 1) & 1, (n_tiles - 1) * TS);
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < SPL; ++j)
      a.h_out[((long long)bb * a.C + cg) * N + n0 + j] = h[j];
  }
}

template <typename T, int N>
int launch(const Args<T>& a, int B, cudaStream_t s) {
  using Sh = Shape<T, N>;
  auto kernel = ssm_scan_kernel<T, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.C + Sh::CH - 1) / Sh::CH, B);
  kernel<<<grid, THREADS, Sh::SMEM, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p, long long pitch_bytes) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && pitch_bytes % 16 == 0;
}

template <typename T>
int dispatch(int N, const void* x, const void* dt, const void* a,
             const void* b, const void* c, const void* d, const void* h0,
             void* y, void* h_out, int B, int S, int C, long long sx,
             long long sdt, long long sb, long long sc, cudaStream_t s) {
  Args<T> args;
  args.x = static_cast<const T*>(x);
  args.dt = static_cast<const float*>(dt);
  args.a = static_cast<const float*>(a);
  args.b = static_cast<const T*>(b);
  args.c = static_cast<const T*>(c);
  args.d = static_cast<const float*>(d);
  args.h0 = static_cast<const float*>(h0);
  args.y = static_cast<T*>(y);
  args.h_out = static_cast<float*>(h_out);
  args.S = S;
  args.C = C;
  args.sx = sx;
  args.sdt = sdt;
  args.sb = sb;
  args.sc = sc;
  args.vec_x = aligned16(x, sx * (long long)sizeof(T));
  args.vec_dt = aligned16(dt, sdt * 4);
  args.vec_y = aligned16(y, (long long)C * sizeof(T));
  switch (N) {
    case 16:
      return launch<T, 16>(args, B, s);
    case 32:
      return launch<T, 32>(args, B, s);
    case 64:
      return launch<T, 64>(args, B, s);
    default:
      return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, b, c and y); dt, a, d, h0 and h_out
// are float32.  x, dt: (B, S, C) and b, c: (B, S, N) with row r = bb * S +
// t at element r * s{x,dt,b,c} and the last axis contiguous; a (C, N), d
// (C,), h0 and h_out (B, C, N) and y (B, S, C) contiguous; h0 may be NULL
// (zeros).  N in {16, 32, 64}.  Returns -1 for an input this build does not
// take, else cudaGetLastError() after the launch.
extern "C" int repro_ssm_scan(const void* x, const void* dt, const void* a,
                              const void* b, const void* c, const void* d,
                              const void* h0, void* y, void* h_out, int dtype,
                              int B, int S, int C, int N, long long sx,
                              long long sdt, long long sb, long long sc,
                              void* stream) {
  if (B == 0 || C == 0) return 0;
  if (B > 65535 || S < 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(N, x, dt, a, b, c, d, h0, y, h_out, B, S,
                                   C, sx, sdt, sb, sc, s);
  if (dtype == 0)
    return dispatch<float>(N, x, dt, a, b, c, d, h0, y, h_out, B, S, C, sx,
                           sdt, sb, sc, s);
  return -1;
}
