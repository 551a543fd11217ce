// Backward of the MARS-sorted embedding gather for Hopper (sm_90a),
// plain C interface.
//
// Replaces the reference's `embedding_grad_scatter`
// (src/repro/kernels/mars_gather/ops.py:50; plain jnp, no Pallas kernel):
// the table's gradient `zeros(V, d).at[ids].add(g)`, with the ids sorted
// by row first so that each row's contributions are contiguous.  The
// caller stable-sorts the ids with torch.argsort (as the reference's
// jnp.argsort) and hands this kernel the sorted ids and the permutation;
// out must be zeroed beforehand (rows no id names stay 0).  Each run of
// equal ids sums its gradient rows (g[perm[j]], token order within the
// run) in f32 and writes its output row once, rounded to g's dtype.  No
// atomics: the result is the same bit for bit from run to run, and equal
// to a sequential f32 sum in sorted order.  (The reference adds in g's
// dtype; summing in f32 and rounding once is a deliberate departure.)
//
// Bound: bytes.  Reading g (T x d) and the ids and writing the rows the
// ids name; for 8 x 512 tokens of qwen1.5-0.5b (d 1024, bf16) that is 8.4
// MB of g, a few MB of rows, 3 us at 3.35 TB/s (the zeroing of the whole
// (V, d) output, 311 MB, is the wrapper's and not counted).
//
// Design.  One warp an item of (sorted position, column chunk of up to
// 256 columns, 8 a lane); a warp whose position does not start a run
// returns at once.  The run's warp reads 32 sorted ids and their
// permutation entries at a time (one coalesced load each), finds where
// the run ends with a ballot, and adds the rows in order, each lane its
// columns.  A run is one warp's serial walk: with TokenStream's zipf ids
// (id 1 takes about a quarter of the tokens) one warp a column chunk
// adds about a thousand rows while the others add a few -- right first;
// splitting long runs over warps with a fixed-order merge is a later
// PR's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = 8;                  // columns a lane sums
constexpr int kChunk = 32 * kPerLane;        // columns a warp sums

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
embedding_grad_scatter_kernel(const int64_t* __restrict__ sorted_ids,
                              const int64_t* __restrict__ perm,
                              const T* __restrict__ g, T* __restrict__ out,
                              long long n, long long V, long long d) {
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;
  const long long id = sorted_ids[i];
  if ((i > 0 && sorted_ids[i - 1] == id) || id < 0 || id >= V) return;
  const int lane = threadIdx.x & 31;
  const long long c0 = (long long)blockIdx.y * kChunk + lane;
  float acc[kPerLane];
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) acc[t] = 0.f;
  for (long long j = i;; j += 32) {
    const long long jj = j + lane;
    const bool in = jj < n && sorted_ids[jj] == id;
    const long long row = in ? perm[jj] : 0;
    const unsigned same = __ballot_sync(0xffffffffu, in);
    // sorted: the run is a prefix of these 32 positions
    const int m = same == 0xffffffffu ? 32 : __ffs(~same) - 1;
    for (int u = 0; u < m; ++u) {
      const T* src = g + __shfl_sync(0xffffffffu, row, u) * d;
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) {
        const long long c = c0 + 32 * t;
        if (c < d) acc[t] += to_f(src[c]);
      }
    }
    if (m < 32) break;
  }
  T* dst = out + id * d;
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    const long long c = c0 + 32 * t;
    if (c < d) dst[c] = from_f<T>(acc[t]);
  }
}

template <typename T>
int launch(const void* sorted_ids, const void* perm, const void* g,
           void* out, long long n, long long V, long long d,
           cudaStream_t s) {
  const long long blocks = (n + kWarps - 1) / kWarps;
  const long long chunks = (d + kChunk - 1) / kChunk;
  if (blocks > 0x7fffffffLL || chunks > 65535) return -1;
  embedding_grad_scatter_kernel<T>
      <<<dim3((unsigned)blocks, (unsigned)chunks), kThreads, 0, s>>>(
          static_cast<const int64_t*>(sorted_ids),
          static_cast<const int64_t*>(perm), static_cast<const T*>(g),
          static_cast<T*>(out), n, V, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  sorted_ids, perm: int64 (n,), the
// ids stable-sorted and the permutation that sorts them; g (n, d) in
// token order; out (V, d) zeroed.  Ids outside [0, V) add nothing.
// Returns 0 on success, -1 for an unsupported argument, else the
// cudaError_t of the launch.
int mars_embedding_grad_scatter(int dtype, const void* sorted_ids,
                                const void* perm, const void* g, void* out,
                                long long n, long long V, long long d,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || d <= 0) return 0;
  if (dtype == 0)
    return launch<float>(sorted_ids, perm, g, out, n, V, d, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(sorted_ids, perm, g, out, n, V, d, s);
  return -1;
}

const char* mars_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
