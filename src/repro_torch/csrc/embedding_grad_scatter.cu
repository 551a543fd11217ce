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
// (V, d) output, 311 MB, is the wrapper's; it is 0.093 of the 0.095 ms
// bound of the call).
//
// Design.  One warp a (sorted position, chunk of 256 columns); the
// warp first reads, in one round trip, the ids and permutation entries
// of its own and the next 31 positions and the ids of the 8 before it,
// so it knows whether it is among the first 8 positions of its run (t,
// its offset from the run's start) and whether the run is short (fewer
// than 8 positions) or long.  Every other warp returns at once.
//   * a short run is summed by its first warp alone: a lane owns 8
//     contiguous columns of the chunk (one 16-byte load a row in bf16
//     and where d is a multiple of 8), and the loads of all the run's
//     rows are issued before they are added in order: two round trips
//     a run (the ids, the rows), as few warps as 256-column chunks;
//   * a long run is summed by its first 8 warps side by side, warp t
//     over the 32 columns 32 t .. of the chunk, one a lane (qwen's d
//     1024: 32 warps), each walking the whole run: it reads the run's
//     ids and permutation entries 32 positions at a time (the next 32
//     load while this batch's rows do), issues the loads of the batch's
//     rows, then adds them in order, so a batch of 32 rows costs one
//     memory round trip and a few instructions a row, not one round trip
//     a row.
// Columns are independent sums, so no cut by columns changes any sum's
// order: each output row is the f32 sum of its rows in sorted order,
// bit for bit the twin's.  With TokenStream's zipf ids (id 1 takes
// about a quarter of 4096 tokens) the longest run is 34 batches deep.
// The launch plan (16-byte loads or not, chunks, blocks) is
// `mars_gather.scatter_plan`, from n, d and the dtype alone.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;                  // columns of a grid-y chunk
constexpr int kSlices = 8;                   // warps that share a long run
constexpr int kLong = kSlices;               // rows of the shortest long run
constexpr int kBatch = 32;                   // rows in flight a warp
constexpr int kPer = kChunk / 32;            // a short run: columns a lane

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

// The 8 columns c .. c + 7 of a row: with WIDE (d a multiple of 8, rows
// 16-byte aligned) as 16-byte loads, else one value at a time below d.
template <typename T, bool WIDE>
struct Eight {
  static constexpr int kWords = WIDE ? 8 * sizeof(T) / 16 : 1;
  uint4 w[WIDE ? kWords : 1];
  T x[WIDE ? 1 : kPer];
  __device__ __forceinline__ void load(const T* row, long long c,
                                       long long d) {
    if constexpr (WIDE) {
#pragma unroll
      for (int k = 0; k < kWords; ++k)
        w[k] = reinterpret_cast<const uint4*>(row + c)[k];
    } else {
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        if (c + k < d) x[k] = row[c + k];
    }
  }
  __device__ __forceinline__ void add(float (&acc)[kPer]) const {
    if constexpr (WIDE) {
      const T* v = reinterpret_cast<const T*>(w);
#pragma unroll
      for (int k = 0; k < kPer; ++k) acc[k] += to_f(v[k]);
    } else {
#pragma unroll
      for (int k = 0; k < kPer; ++k) acc[k] += to_f(x[k]);
    }
  }
  // the sums rounded to T into the row's 8 columns: with WIDE as 16-byte
  // stores, so a warp writes its 256 columns in whole sectors
  static __device__ __forceinline__ void store(T* row, long long c,
                                               long long d,
                                               const float (&acc)[kPer]) {
    if constexpr (WIDE) {
      uint4 w[kWords];
      T* v = reinterpret_cast<T*>(w);
#pragma unroll
      for (int k = 0; k < kPer; ++k) v[k] = from_f<T>(acc[k]);
#pragma unroll
      for (int k = 0; k < kWords; ++k)
        reinterpret_cast<uint4*>(row + c)[k] = w[k];
    } else {
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        if (c + k < d) row[c + k] = from_f<T>(acc[k]);
    }
  }
};

template <typename T, bool WIDE>
__global__ void __launch_bounds__(kThreads)
embedding_grad_scatter_kernel(const int64_t* __restrict__ sorted_ids,
                              const int64_t* __restrict__ perm,
                              const T* __restrict__ g, T* __restrict__ out,
                              long long n, long long V, long long d) {
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;
  const int lane = threadIdx.x & 31;
  // one round trip: positions i .. i + 31 (id, row) and the 8 before i
  const long long fpos = i + lane, bpos = i - 1 - lane;
  const bool fin = fpos < n, bin = lane < kSlices && bpos >= 0;
  const int64_t fid = fin ? sorted_ids[fpos] : 0;
  const int frow = fin ? (int)perm[fpos] : 0;
  const int64_t bid = bin ? sorted_ids[bpos] : 0;
  const int64_t id = __shfl_sync(0xffffffffu, fid, 0);
  if (id < 0 || id >= V) return;
  const unsigned fw = __ballot_sync(0xffffffffu, fin && fid == id);
  const int mf = fw == 0xffffffffu ? kBatch : __ffs(~fw) - 1;
  const int t = __ffs(~__ballot_sync(0xffffffffu, bin && bid == id)) - 1;
  if (t >= kSlices) return;                  // not among the run's first 8
  const long long c0 = (long long)blockIdx.y * kChunk;

  if (t + mf < kLong) {                      // a short run: fewer than 8
    if (t > 0) return;
    const long long c = c0 + kPer * lane;
    const bool mine = c < d;
    Eight<T, WIDE> rows[kLong - 1];
#pragma unroll
    for (int u = 0; u < kLong - 1; ++u) {
      const int r = __shfl_sync(0xffffffffu, frow, u);   // every lane
      if (u < mf && mine)
        rows[u].load(g + (unsigned long long)(unsigned)r * d, c, d);
    }
    if (!mine) return;
    float acc[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) acc[k] = 0.f;
#pragma unroll
    for (int u = 0; u < kLong - 1; ++u)
      if (u < mf) rows[u].add(acc);          // in sorted order
    Eight<T, WIDE>::store(out + id * d, c, d, acc);
    return;
  }

  // a long run: warp t sums the columns c0 + 32 t + lane over the whole
  // run, from its start s = i - t, 32 positions a batch
  const long long col = c0 + 32 * t + lane;
  const bool mine = col < d;
  // this lane's column of row r: one 32 x 32 + 64-bit multiply-add
  const char* gc = reinterpret_cast<const char*>(g + (mine ? col : 0));
  const unsigned row_bytes = (unsigned)(d * sizeof(T));
  long long j = i - t;
  bool in = fin && fid == id;
  int row = frow;
  if (t > 0) {                               // ids and rows in one trip
    const long long pos = j + lane;
    const bool ok = pos < n;
    const int64_t pid = ok ? sorted_ids[pos] : -1;
    row = ok ? (int)perm[pos] : 0;
    in = ok && pid == id;
  }
  float acc = 0.f;
  for (;;) {
    const unsigned same = __ballot_sync(0xffffffffu, in);
    // sorted: the run is a prefix of these 32 positions
    const int m = same == 0xffffffffu ? kBatch : __ffs(~same) - 1;
    // the next batch's ids and rows load while this one's rows do: both
    // issued here, neither waited for until the batch is added
    const long long jn = j + kBatch + lane;
    const bool more = m == kBatch && jn < n;
    const int64_t id_next = more ? sorted_ids[jn] : -1;
    const int64_t row_next = more ? perm[jn] : 0;
    T raw[kBatch];
    if (m == kBatch) {                       // a whole batch: one predicate
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const unsigned r = __shfl_sync(0xffffffffu, row, u);
        if (mine)
          raw[u] = *reinterpret_cast<const T*>(
              gc + (unsigned long long)r * row_bytes);
      }
      if (mine) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) acc += to_f(raw[u]);  // in order
      }
    } else {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const unsigned r = __shfl_sync(0xffffffffu, row, u);
        if (u < m && mine)
          raw[u] = *reinterpret_cast<const T*>(
              gc + (unsigned long long)r * row_bytes);
      }
      if (mine) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (u < m) acc += to_f(raw[u]);    // in sorted order
      }
    }
    if (m < kBatch) break;
    j += kBatch;
    in = id_next == id;
    row = (int)row_next;
  }
  if (mine) out[id * d + col] = from_f<T>(acc);
}

template <typename T, bool WIDE>
int launch(const void* sorted_ids, const void* perm, const void* g,
           void* out, long long n, long long V, long long d,
           long long chunks, long long blocks, cudaStream_t s) {
  if (blocks * kWarps < n || chunks * kChunk < d || blocks > 0x7fffffffLL ||
      chunks > 65535 || n > 0x7fffffffLL ||
      d * (long long)sizeof(T) > 0xffffffffLL)
    return -1;
  embedding_grad_scatter_kernel<T, WIDE>
      <<<dim3((unsigned)blocks, (unsigned)chunks), kThreads, 0, s>>>(
          static_cast<const int64_t*>(sorted_ids),
          static_cast<const int64_t*>(perm), static_cast<const T*>(g),
          static_cast<T*>(out), n, V, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wide(int wide, const void* sorted_ids, const void* perm,
                const void* g, void* out, long long n, long long V,
                long long d, long long chunks, long long blocks,
                cudaStream_t s) {
  if (!wide)
    return launch<T, false>(sorted_ids, perm, g, out, n, V, d, chunks,
                            blocks, s);
  if (d % kPer == 0)
    return launch<T, true>(sorted_ids, perm, g, out, n, V, d, chunks, blocks,
                           s);
  return -1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  sorted_ids, perm: int64 (n,), the
// ids stable-sorted and the permutation that sorts them; g (n, d) in
// token order; out (V, d) zeroed.  The plan (`scatter_plan`): wide, 1 for
// 16-byte loads (d a multiple of 8, g and out 16-byte aligned), else 0;
// chunks of 256 columns along the grid's y (at least d / 256), blocks of
// 4 positions along its x (at least n / 4).  Ids outside [0, V) add
// nothing.  Returns 0 on success, -1 for an unsupported argument, else
// the cudaError_t of the launch.
int mars_embedding_grad_scatter(int dtype, int wide, const void* sorted_ids,
                                const void* perm, const void* g, void* out,
                                long long n, long long V, long long d,
                                long long chunks, long long blocks,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || d <= 0) return 0;
  if (dtype == 0)
    return launch_wide<float>(wide, sorted_ids, perm, g, out, n, V, d,
                              chunks, blocks, s);
  if (dtype == 1)
    return launch_wide<__nv_bfloat16>(wide, sorted_ids, perm, g, out, n, V,
                                      d, chunks, blocks, s);
  return -1;
}

const char* mars_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
