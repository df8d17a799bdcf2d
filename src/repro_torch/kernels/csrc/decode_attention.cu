// Decode attention over slot caches for Hopper (sm_90a), with a plain C
// interface loaded through ctypes.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// `decode_attention`, the legacy step's batched decode: row b's one query per
// head attends rows [0, cache_len[b]) of its own cache row, query head h
// reading KV head h // group.  The Pallas kernel walks a row's cache blocks
// as a sequential grid axis with its softmax state in scratch, which suits
// one TPU core; here the rows are split into chunks that run as separate
// CTAs, so that a few slots over long caches still fill all 132 SMs.
//
// What bounds it on the card: bytes (each attended K and V row read once,
// ~4 flops per byte).  The work of a CTA is csrc/attn_decode.cuh's unit:
// a cp.async ring of K/V tiles, bf16 scores and P V on mma.sync, and the
// split-KV merge of a pair's chunks in chunk order by the CTA that takes the
// pair's last ticket.
//
// The grid is one CTA per (row, KV head, chunk) over B x KV x ceil(S /
// chunk), sized from S so that no host read of cache_len is needed; a unit
// past its row's length exits before it reads anything.  Units are numbered
// chunk-major, so the first chunks of every pair, which always have work,
// are scheduled first.
//
// The second C entry, `repro_paged_decode_attention`, replaces the TPU
// kernel src/repro/kernels/decode_attention.py `paged_decode_attention`
// (`_paged_kernel`): decode through a (B, MAXP) page table over (NP, PS, KV,
// D) page pools, read in place (the TPU wrapper's (KV, NP, PS, D) transpose
// is not made).  It runs the same unit in its paged form (PAGED = true),
// with S = MAXP * PS sizing the grid.
#include "attn_decode.cuh"

namespace {

using attn_decode::Args;
using attn_decode::THREADS;

template <typename T, int G, int D>
__global__ void __launch_bounds__(THREADS, 2)
decode_attention_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  attn_decode::unit<T, G, D>(a, blockIdx.x, smem);
}

template <typename T, int G, int D>
__global__ void __launch_bounds__(THREADS, 2)
paged_decode_attention_kernel(const attn_decode::PagedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  attn_decode::unit<T, G, D, true>(a, blockIdx.x, smem);
}

template <typename T, int G, int D>
int launch(const Args& a, int n_units, cudaStream_t stream) {
  constexpr int SMEM = attn_decode::smem_bytes<T, G, D>();
  auto kernel = decode_attention_kernel<T, G, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_units, THREADS, SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G, int D>
int launch(const attn_decode::PagedArgs& a, int n_units, cudaStream_t stream) {
  constexpr int SMEM = attn_decode::paged_smem_bytes<T, G, D>();
  auto kernel = paged_decode_attention_kernel<T, G, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_units, THREADS, SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// A: Args or PagedArgs (the paged form)
template <typename T, typename A>
int dispatch(int group, int head_dim, const A& a, int n_units,
             cudaStream_t s) {
#define REPRO_DA_CASE(G, D) \
  if (group == G && head_dim == D) return launch<T, G, D>(a, n_units, s);
#define REPRO_DA_CASES(G) REPRO_DA_CASE(G, 64) REPRO_DA_CASE(G, 128) REPRO_DA_CASE(G, 256)
  REPRO_DA_CASES(1)
  REPRO_DA_CASES(2)
  REPRO_DA_CASES(4)
  REPRO_DA_CASES(8)
  // groups 3, 7 and 9 (minitron, Arctic and LLaVA, StarCoder2) at head dim
  // 128 only, the one head dim of every configuration with them
  REPRO_DA_CASE(3, 128)
  REPRO_DA_CASE(7, 128)
  REPRO_DA_CASE(9, 128)
#undef REPRO_DA_CASES
#undef REPRO_DA_CASE
  return -1;
}

// Fills the fields the two entries share; S is the rows a unit may reach.
// Returns the units to launch (one per (row, KV head, chunk)), or -1.
int prepare(Args& a, const void* q, const void* k, const void* v,
            const void* cache_len, void* out, void* part_ml, void* part_acc,
            void* tickets, int dtype, int B, int n_heads, int n_kv, int S,
            int chunk, long long k_stride_b, long long k_stride_s,
            long long v_stride_b, long long v_stride_s, float scale,
            void* sched) {
  if (n_kv <= 0 || n_heads % n_kv || chunk <= 0 ||
      chunk % attn_decode::CHUNK_MULTIPLE || (dtype != 0 && dtype != 1))
    return -1;
  a.q = q;
  a.k = k;
  a.v = v;
  a.cache_len = static_cast<const int32_t*>(cache_len);
  a.out = out;
  a.part_ml = static_cast<float*>(part_ml);
  a.part_acc = static_cast<float*>(part_acc);
  a.tickets = static_cast<int32_t*>(tickets);
  a.B = B;
  a.n_kv = n_kv;
  a.S = S;
  a.chunk = chunk;
  a.n_chunks = (S + chunk - 1) / chunk;
  a.k_sb = k_stride_b;
  a.k_ss = k_stride_s;
  a.v_sb = v_stride_b;
  a.v_ss = v_stride_s;
  a.scale = scale;
  // S == 0 still runs one unit per pair, which writes zeros
  const int n_units = B * n_kv * (a.n_chunks > 0 ? a.n_chunks : 1);
  int* out_sched = static_cast<int*>(sched);
  out_sched[0] = n_units;
  out_sched[1] = chunk;
  return n_units;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, the caches and out).  q and out (B,
// H, D) are contiguous; the caches are (B, S, KV, D) with unit stride over
// (KV, D), 16-byte aligned rows and the given element strides over B and S;
// cache_len is (B,) int32.  `chunk` (a positive multiple of 64) is the
// cache rows per unit.  part_ml holds B * KV * n_chunks * 2 * G floats,
// part_acc B * KV * n_chunks * G * D (n_chunks = ceil(S / chunk)), tickets
// B * KV int32 zeros, left zero by the launch.  sched receives (units
// launched, chunk).  Returns -1 for a shape or chunk this build does not
// take, else the CUDA error of the launch.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* cache_len,
    void* out, void* part_ml, void* part_acc, void* tickets, int dtype, int B,
    int n_heads, int n_kv, int head_dim, int S, int chunk,
    long long k_stride_b, long long k_stride_s, long long v_stride_b,
    long long v_stride_s, float scale, void* sched, void* stream) {
  Args a;
  const int n_units = prepare(a, q, k, v, cache_len, out, part_ml, part_acc,
                              tickets, dtype, B, n_heads, n_kv, S, chunk,
                              k_stride_b, k_stride_s, v_stride_b, v_stride_s,
                              scale, sched);
  if (n_units <= 0) return n_units;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = n_heads / n_kv;
  if (dtype == 1) return dispatch<__nv_bfloat16>(group, head_dim, a, n_units, s);
  return dispatch<float>(group, head_dim, a, n_units, s);
}

// Decode through a page table.  q and out (B, H, D) are contiguous; the
// pools are (NP, PS, KV, D) with unit stride over (KV, D), 16-byte aligned
// rows and a uniform flat row space (page stride = PS x row stride, the row
// strides given in elements); page_table is (B, max_pages) int32,
// contiguous, entries in [-1, NP) (-1 inside the length reads page 0);
// cache_len (B,) int32 in [1, max_pages * PS].  chunk, part_ml, part_acc,
// tickets and sched as for repro_decode_attention with S = max_pages * PS.
extern "C" int repro_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* cache_len, void* out, void* part_ml,
    void* part_acc, void* tickets, int dtype, int B, int n_heads, int n_kv,
    int head_dim, int max_pages, int page_size, int chunk,
    long long k_stride_row, long long v_stride_row, float scale, void* sched,
    void* stream) {
  if (max_pages <= 0 || page_size <= 0) return -1;
  attn_decode::PagedArgs a;
  const int n_units = prepare(a, q, k_pages, v_pages, cache_len, out, part_ml,
                              part_acc, tickets, dtype, B, n_heads, n_kv,
                              max_pages * page_size, chunk, 0, k_stride_row,
                              0, v_stride_row, scale, sched);
  if (n_units <= 0) return n_units;
  a.table = static_cast<const int32_t*>(page_table);
  a.max_pages = max_pages;
  a.page_size = page_size;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = n_heads / n_kv;
  if (dtype == 1) return dispatch<__nv_bfloat16>(group, head_dim, a, n_units, s);
  return dispatch<float>(group, head_dim, a, n_units, s);
}
