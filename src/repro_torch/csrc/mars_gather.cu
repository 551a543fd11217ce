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
// DMA behind the current copy.  On Hopper one warp copies one row: its
// lanes move the row in vectors of `vec` bytes (16 where the row length
// and both base pointers allow it, so a 3200-byte bf16 row of hymba's
// 1600-wide table is 200 coalesced 16-byte loads), eight rows a
// 256-thread block, as many blocks as rows need.  Sorted ids make
// neighbouring warps read neighbouring rows.  The copy never converts a
// value, so any dtype gathers bitwise.  An id outside [0, V) reads
// nothing and writes a zero row (the wrapper documents that ids must lie
// in the table).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ table, const I* __restrict__ ids,
                   V* __restrict__ out, long long n_rows_table,
                   long long row_vecs, long long n) {
  const long long row = (long long)blockIdx.x * kRowsPerBlock +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const long long id = (long long)ids[row];
  V* dst = out + row * row_vecs;
  if (id < 0 || id >= n_rows_table) {
    const V zero{};
    for (long long i = lane; i < row_vecs; i += 32) dst[i] = zero;
    return;
  }
  const V* src = table + id * row_vecs;
  for (long long i = lane; i < row_vecs; i += 32) dst[i] = src[i];
}

template <typename V>
int launch_idx(int idx_dtype, const void* table, const void* ids, void* out,
               long long V_rows, long long row_bytes, long long n,
               cudaStream_t s) {
  const long long row_vecs = row_bytes / (long long)sizeof(V);
  const unsigned blocks =
      (unsigned)((n + kRowsPerBlock - 1) / kRowsPerBlock);
  if (idx_dtype == 0)
    gather_rows_kernel<V, int32_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const V*>(table), static_cast<const int32_t*>(ids),
        static_cast<V*>(out), V_rows, row_vecs, n);
  else if (idx_dtype == 1)
    gather_rows_kernel<V, int64_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const V*>(table), static_cast<const int64_t*>(ids),
        static_cast<V*>(out), V_rows, row_vecs, n);
  else
    return -1;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// idx_dtype: 0 = int32, 1 = int64.  vec: bytes a lane moves at once (16,
// 8, 4, 2 or 1); row_bytes must be a multiple of it and both base
// pointers aligned to it.  Returns 0 on success, -1 for an unsupported
// argument, else the cudaError_t of the launch.
int mars_gather_rows(int idx_dtype, int vec, const void* table,
                     const void* ids, void* out, long long V_rows,
                     long long row_bytes, long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (vec <= 0 || row_bytes % vec != 0) return -1;
  switch (vec) {
    case 16: return launch_idx<uint4>(idx_dtype, table, ids, out, V_rows,
                                      row_bytes, n, s);
    case 8: return launch_idx<uint2>(idx_dtype, table, ids, out, V_rows,
                                     row_bytes, n, s);
    case 4: return launch_idx<uint32_t>(idx_dtype, table, ids, out, V_rows,
                                        row_bytes, n, s);
    case 2: return launch_idx<uint16_t>(idx_dtype, table, ids, out, V_rows,
                                        row_bytes, n, s);
    case 1: return launch_idx<uint8_t>(idx_dtype, table, ids, out, V_rows,
                                       row_bytes, n, s);
    default: return -1;
  }
}

const char* mars_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
