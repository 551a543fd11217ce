// Row gather by MARS-sorted ids for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_kernel` / `gather_rows` in
// src/repro/kernels/mars_gather/mars_gather.py: output row i is a bitwise
// copy of table row sorted_ids[i].  The caller sorts the ids so that
// consecutive rows read neighbouring table pages (the MARS reorder) and
// unsorts the result; this kernel is the copy in between.
//
// Bound: no arithmetic at all -- the floor is reading N rows and writing
// N rows (plus the ids) over 3.35 TB/s on an H100 SXM.
//
// Design.  On the TPU a scalar-prefetched id stream drives the BlockSpec
// index map, one grid step a row, with Pallas pipelining the next row's
// DMA behind the current copy.  On Hopper the work is (row, column
// chunk) items, one warp an item, four warps a 128-thread block: a row
// is cut into chunks of `chunk_vecs` vectors (32, 64 or 128 vectors of
// `vec` bytes: 512 B to 2 KB at 16 bytes), and each lane issues all its
// loads of the chunk (up to 4 of 16 bytes) before its stores, so they are
// in flight together.  The host sizes the chunk from n and the row
// (`grid_plan` in the wrapper): the widest chunk whose items still give
// one block an SM, down to one vector a lane -- so a few long rows
// (arctic's 24 ids of 14 336 bytes: 672 items, 168 blocks) spread over
// the card instead of queueing 28 copies a lane on 24 warps, while many
// rows keep 2 KB a warp.  Vectors are 16 bytes where the row length and
// both base pointers allow it, so a lane's loads coalesce with its
// neighbours'.  Sorted ids make neighbouring warps read neighbouring
// rows.  The copy never converts a value, so any dtype gathers bitwise.
// An id outside [0, V) reads nothing and writes a zero row (the wrapper
// documents that ids must lie in the table).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;             // loads a lane keeps in flight

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ table, const I* __restrict__ ids,
                   V* __restrict__ out, long long n_rows_table,
                   long long row_vecs, long long n, long long chunk_vecs,
                   long long n_chunks) {
  const long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= n * n_chunks) return;
  const long long row = item / n_chunks;
  const long long c0 = (item - row * n_chunks) * chunk_vecs;
  const long long c1 = c0 + chunk_vecs < row_vecs ? c0 + chunk_vecs
                                                  : row_vecs;
  const int lane = threadIdx.x & 31;
  const long long id = (long long)ids[row];
  V* dst = out + row * row_vecs;
  if (id < 0 || id >= n_rows_table) {
    const V zero{};
    for (long long i = c0 + lane; i < c1; i += 32) dst[i] = zero;
    return;
  }
  const V* src = table + id * row_vecs;
  for (long long i0 = c0 + lane; i0 < c1; i0 += 32 * kUnroll) {
    V buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i0 + 32 * u < c1) buf[u] = src[i0 + 32 * u];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i0 + 32 * u < c1) dst[i0 + 32 * u] = buf[u];
  }
}

template <typename V>
int launch_idx(int idx_dtype, const void* table, const void* ids, void* out,
               long long V_rows, long long row_bytes, long long n,
               long long chunk_vecs, cudaStream_t s) {
  const long long row_vecs = row_bytes / (long long)sizeof(V);
  const long long n_chunks = (row_vecs + chunk_vecs - 1) / chunk_vecs;
  const long long blocks = (n * n_chunks + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return -1;
  if (idx_dtype == 0)
    gather_rows_kernel<V, int32_t><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const V*>(table), static_cast<const int32_t*>(ids),
        static_cast<V*>(out), V_rows, row_vecs, n, chunk_vecs, n_chunks);
  else if (idx_dtype == 1)
    gather_rows_kernel<V, int64_t><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const V*>(table), static_cast<const int64_t*>(ids),
        static_cast<V*>(out), V_rows, row_vecs, n, chunk_vecs, n_chunks);
  else
    return -1;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// idx_dtype: 0 = int32, 1 = int64.  vec: bytes a lane moves at once (16,
// 8, 4, 2 or 1); row_bytes must be a multiple of it and both base
// pointers aligned to it.  chunk_vecs: vectors a warp copies (a multiple
// of 32, at most 128).  Returns 0 on success, -1 for an unsupported
// argument, else the cudaError_t of the launch.
int mars_gather_rows(int idx_dtype, int vec, const void* table,
                     const void* ids, void* out, long long V_rows,
                     long long row_bytes, long long n, long long chunk_vecs,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (vec <= 0 || row_bytes % vec != 0) return -1;
  if (chunk_vecs < 32 || chunk_vecs > 32 * kUnroll || chunk_vecs % 32)
    return -1;
  switch (vec) {
    case 16: return launch_idx<uint4>(idx_dtype, table, ids, out, V_rows,
                                      row_bytes, n, chunk_vecs, s);
    case 8: return launch_idx<uint2>(idx_dtype, table, ids, out, V_rows,
                                     row_bytes, n, chunk_vecs, s);
    case 4: return launch_idx<uint32_t>(idx_dtype, table, ids, out, V_rows,
                                        row_bytes, n, chunk_vecs, s);
    case 2: return launch_idx<uint16_t>(idx_dtype, table, ids, out, V_rows,
                                        row_bytes, n, chunk_vecs, s);
    case 1: return launch_idx<uint8_t>(idx_dtype, table, ids, out, V_rows,
                                       row_bytes, n, chunk_vecs, s);
    default: return -1;
  }
}

const char* mars_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
