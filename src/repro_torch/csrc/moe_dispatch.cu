// MARS-sorted grouped GEMM for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_kernel` / `grouped_matmul` in
// src/repro/kernels/moe_dispatch/moe_dispatch.py:
//   out[r] = x[r] @ w[tile_group[r / bm]]
// with x (M, K) holding token rows sorted by expert (the MARS "page") and
// each expert's segment padded to a multiple of bm rows, so every row
// tile of bm rows belongs to one expert; w (G, K, N); tile_group int32
// (M / bm,).  Sums in f32, output in x's dtype (float32 or bfloat16, one
// dtype for x, w and out).  `n_used` (a device int32 scalar, or null for
// "all") is the number of row tiles in use: tiles at or past it, or
// whose group lies outside [0, G), read no weights and write zeros --
// the caller sizes its buffers by a bound and never reads the count back
// to the host.
//
// Bound: bytes.  At decode a few rows reach each expert (arctic-480b: 8
// lanes x top-2 = 16 assignments over 128 experts), so the floor is
// reading every used expert's (K, N) matrix once: 16 x 7168 x 4864 x 2 B
// = 1.12 GB per product, 0.33 ms at 3.35 TB/s on an H100 SXM, against
// 1.1 GFLOP of real work.
//
// Design.  On the TPU the grid is (row tile, N tile, K tile) with an f32
// VMEM accumulator carried along the sequential K axis, and the weight
// BlockSpec's index map reads tile_group through scalar prefetch.  Here
// one block owns one (row tile, 128-column stripe) and walks K itself, so
// each used expert's weight columns are read from device memory once per
// row tile (tiles of bm <= 128 rows; a larger bm is walked in chunks of
// 128 rows, each reading the stripe again).  The weights are (K, N) with
// N contiguous, so a 32-row K step of the stripe is 32 coalesced 256-byte
// rows, moved with 16-byte cp.async (cache-global: streamed past L1) into
// a 4-stage shared-memory ring that keeps three steps in flight behind
// the one being multiplied.  bf16 products run on the tensor cores with
// mma.sync m16n8k16 (fragments loaded with ldmatrix; rows of the x and w
// tiles padded by 16 bytes so its eight row reads hit distinct banks);
// each of the 4 warps owns 32 columns and up to 8 m16 row fragments.
// The row-fragment count is a template (1, 2, 4 or 8) picked from bm, so
// the decode tiles (bm = 16) carry 16 accumulators a thread, not 128.
// float32 runs a plain CUDA-core tiling (16 x 64 outputs per 256 threads
// and row fragment, K in steps of 16) -- it serves the exact float32
// checks, not the bf16 serve path.  K and N edges are masked: a 16-byte
// chunk that crosses an edge, or any chunk when K or N is not a multiple
// of 8 or a base pointer is not 16-byte aligned, is loaded element by
// element with zeros past the edge.  Padding rows are zero, so the result
// does not depend on bm.  Later work (ROADMAP): wgmma and TMA, and tiles
// that do not multiply 15 padding rows at decode.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- bfloat16: tensor cores -------------------------------------------------
constexpr int kThreads = 128;          // 4 warps
constexpr int kBN = 128;               // output columns a block owns
constexpr int kBK = 32;                // K rows a pipeline stage holds
constexpr int kStages = 4;
constexpr int kXPitch = kBK + 8;       // bf16 a smem row of x (80 B)
constexpr int kWPitch = kBN + 8;       // bf16 a smem row of w (272 B)
constexpr int kMaxRows = 128;          // rows a block multiplies at once

// ---- float32: CUDA cores ----------------------------------------------------
constexpr int kFThreads = 256;
constexpr int kFBN = 64;
constexpr int kFBK = 16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Eight bf16 from global to shared: one 16-byte cp.async when the chunk
// lies inside the edge (`avail` elements remain) and `vec` allows it,
// else element loads with zeros past the edge.
__device__ __forceinline__ void copy8(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, int avail,
                                      bool vec) {
  if (vec && avail >= 8) {
    cp_async16(dst, src);
  } else if (avail <= 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      dst[i] = i < avail ? src[i] : __float2bfloat16(0.f);
  }
}

// Which rows of which tile a block owns, and whether the tile is in use.
struct TileRows {
  int tile, row0, rows, group;
  bool live;
};

__device__ __forceinline__ TileRows tile_rows(const int32_t* tile_group,
                                              const int32_t* n_used, int M,
                                              int G, int bm, int chunks,
                                              int rows_per_block) {
  TileRows t;
  t.tile = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  t.row0 = t.tile * bm + chunk * rows_per_block;
  t.rows = min(rows_per_block, bm - chunk * rows_per_block);
  const int used = n_used ? *n_used : M / bm;
  t.group = tile_group[t.tile];
  t.live = t.tile < used && t.group >= 0 && t.group < G;
  return t;
}

__device__ __forceinline__ void set_zero(float& v) { v = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16& v) {
  v = __float2bfloat16(0.f);
}

template <typename T>
__device__ void write_zeros(T* out, int row0, int rows, int col0, int bn,
                            int N) {
  T zero;
  set_zero(zero);
  for (int idx = threadIdx.x; idx < rows * bn; idx += blockDim.x) {
    const int r = idx / bn, c = idx % bn;
    if (col0 + c < N) out[(size_t)(row0 + r) * N + col0 + c] = zero;
  }
}

template <int MF>
__global__ void __launch_bounds__(kThreads)
grouped_mm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const int32_t* __restrict__ tile_group,
                       const int32_t* __restrict__ n_used,
                       __nv_bfloat16* __restrict__ out, int M, int K, int N,
                       int G, int bm, int chunks, int rows_per_block,
                       int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ws = xs + kStages * MF * 16 * kXPitch;

  const TileRows t = tile_rows(tile_group, n_used, M, G, bm, chunks,
                               rows_per_block);
  const int col0 = blockIdx.y * kBN;
  if (!t.live) {
    write_zeros(out, t.row0, t.rows, col0, kBN, N);
    return;
  }
  const int mf = t.rows / 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const __nv_bfloat16* xr = x + (size_t)t.row0 * K;
  const __nv_bfloat16* wg = w + (size_t)t.group * K * N;
  const bool v = vec != 0;

  auto load_stage = [&](int stage, int k0) {
    __nv_bfloat16* xd = xs + stage * MF * 16 * kXPitch;
    __nv_bfloat16* wd = ws + stage * kBK * kWPitch;
    for (int c = tid; c < t.rows * (kBK / 8); c += kThreads) {
      const int r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
      copy8(xd + r * kXPitch + kc, xr + (size_t)r * K + k0 + kc,
            K - (k0 + kc), v);
    }
    for (int c = tid; c < kBK * (kBN / 8); c += kThreads) {
      const int kr = c / (kBN / 8), nc = (c % (kBN / 8)) * 8;
      const int kk = k0 + kr;
      copy8(wd + kr * kWPitch + nc, wg + (size_t)kk * N + col0 + nc,
            kk < K ? N - (col0 + nc) : 0, v);
    }
  };

  float acc[MF][4][4];
#pragma unroll
  for (int mi = 0; mi < MF; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int nk = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s * kBK);
    cp_async_commit();
  }
  const int m = lane >> 3;               // ldmatrix: which 8x8 matrix
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();        // stage kt has landed
    __syncthreads();                     // ... for every thread; kt-1 done
    const int nxt = kt + kStages - 1;    // refill the buffer kt-1 used
    if (nxt < nk) load_stage(nxt % kStages, nxt * kBK);
    cp_async_commit();
    const __nv_bfloat16* xd = xs + (kt % kStages) * MF * 16 * kXPitch;
    const __nv_bfloat16* wd = ws + (kt % kStages) * kBK * kWPitch;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int krow = kk + (m & 1) * 8 + (lane & 7);
        const int ncol = warp * 32 + p * 16 + (m >> 1) * 8;
        ldmatrix_x4_trans(b[2 * p][0], b[2 * p][1], b[2 * p + 1][0],
                          b[2 * p + 1][1], wd + krow * kWPitch + ncol);
      }
#pragma unroll
      for (int mi = 0; mi < MF; ++mi) {
        if (mi < mf) {
          uint32_t a[4];
          const int row = mi * 16 + (m & 1) * 8 + (lane & 7);
          ldmatrix_x4(a[0], a[1], a[2], a[3],
                      xd + row * kXPitch + kk + (m >> 1) * 8);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a, b[ni]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // accumulator (mi, ni): rows mi*16 + lane/4 (+8), columns
  // warp*32 + ni*8 + 2*(lane%4) (+1)
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MF; ++mi) {
    if (mi >= mf) continue;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = col0 + warp * 32 + ni * 8 + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat16* o = out + (size_t)(t.row0 + mi * 16 + g + 8 * h) * N;
        if (col < N) o[col] = __float2bfloat16(acc[mi][ni][2 * h]);
        if (col + 1 < N) o[col + 1] = __float2bfloat16(acc[mi][ni][2 * h + 1]);
      }
    }
  }
}

template <int MF>
__global__ void __launch_bounds__(kFThreads)
grouped_mm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const int32_t* __restrict__ tile_group,
                      const int32_t* __restrict__ n_used,
                      float* __restrict__ out, int M, int K, int N, int G,
                      int bm, int chunks, int rows_per_block) {
  __shared__ float xs[MF * 16][kFBK + 1];
  __shared__ __align__(16) float ws[kFBK][kFBN];
  const TileRows t = tile_rows(tile_group, n_used, M, G, bm, chunks,
                               rows_per_block);
  const int col0 = blockIdx.y * kFBN;
  if (!t.live) {
    write_zeros(out, t.row0, t.rows, col0, kFBN, N);
    return;
  }
  const int mf = t.rows / 16;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* xr = x + (size_t)t.row0 * K;
  const float* wg = w + (size_t)t.group * K * N;
  float acc[MF][4];
#pragma unroll
  for (int mi = 0; mi < MF; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[mi][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kFBK) {
    for (int i = tid; i < t.rows * kFBK; i += kFThreads) {
      const int r = i / kFBK, kk = i % kFBK;
      xs[r][kk] = k0 + kk < K ? xr[(size_t)r * K + k0 + kk] : 0.f;
    }
    for (int i = tid; i < kFBK * kFBN; i += kFThreads) {
      const int kr = i / kFBN, c = i % kFBN;
      ws[kr][c] = (k0 + kr < K && col0 + c < N)
                      ? wg[(size_t)(k0 + kr) * N + col0 + c]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      const float4 wv = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
#pragma unroll
      for (int mi = 0; mi < MF; ++mi) {
        if (mi < mf) {
          const float xv = xs[mi * 16 + ty][kk];
          acc[mi][0] += xv * wv.x;
          acc[mi][1] += xv * wv.y;
          acc[mi][2] += xv * wv.z;
          acc[mi][3] += xv * wv.w;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int mi = 0; mi < MF; ++mi) {
    if (mi >= mf) continue;
    float* o = out + (size_t)(t.row0 + mi * 16 + ty) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col < N) o[col] = acc[mi][j];
    }
  }
}

inline size_t bf16_smem_bytes(int mf) {
  return (size_t)kStages * (mf * 16 * kXPitch + kBK * kWPitch) *
         sizeof(__nv_bfloat16);
}

template <int MF>
int launch_bf16(const void* x, const void* w, const void* tg,
                const void* n_used, void* out, int M, int K, int N, int G,
                int bm, int chunks, int rows_per_block, int vec,
                cudaStream_t s) {
  static bool attr_set = false;
  const size_t smem = bf16_smem_bytes(MF);
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        grouped_mm_bf16_kernel<MF>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((unsigned)((M / bm) * chunks),
                  (unsigned)((N + kBN - 1) / kBN));
  grouped_mm_bf16_kernel<MF><<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const int32_t*>(tg), static_cast<const int32_t*>(n_used),
      static_cast<__nv_bfloat16*>(out), M, K, N, G, bm, chunks,
      rows_per_block, vec);
  return (int)cudaGetLastError();
}

template <int MF>
int launch_f32(const void* x, const void* w, const void* tg,
               const void* n_used, void* out, int M, int K, int N, int G,
               int bm, int chunks, int rows_per_block, cudaStream_t s) {
  const dim3 grid((unsigned)((M / bm) * chunks),
                  (unsigned)((N + kFBN - 1) / kFBN));
  grouped_mm_f32_kernel<MF><<<grid, kFThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const int32_t*>(tg), static_cast<const int32_t*>(n_used),
      static_cast<float*>(out), M, K, N, G, bm, chunks, rows_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and out alike).  vec: 1 when K
// and N are multiples of 8 and x and w are 16-byte aligned (bf16 16-byte
// loads).  n_used: device int32 scalar or null.  bm: a multiple of 16
// that divides M.  Returns 0 on success, -1 for an unsupported argument,
// else the cudaError_t of the launch.
int mars_grouped_matmul(int dtype, int vec, const void* x, const void* w,
                        const void* tile_group, const void* n_used, void* out,
                        int M, int K, int N, int G, int bm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm <= 0 || bm % 16 != 0 || M % bm != 0 || K <= 0 || N <= 0 || G <= 0)
    return -1;
  if (M == 0) return 0;
  const int rows_per_block = bm < kMaxRows ? bm : kMaxRows;
  const int chunks = (bm + rows_per_block - 1) / rows_per_block;
  const int mf = rows_per_block / 16;
  if (dtype == 1) {
    if (mf <= 1)
      return launch_bf16<1>(x, w, tile_group, n_used, out, M, K, N, G, bm,
                            chunks, rows_per_block, vec, s);
    if (mf <= 2)
      return launch_bf16<2>(x, w, tile_group, n_used, out, M, K, N, G, bm,
                            chunks, rows_per_block, vec, s);
    if (mf <= 4)
      return launch_bf16<4>(x, w, tile_group, n_used, out, M, K, N, G, bm,
                            chunks, rows_per_block, vec, s);
    return launch_bf16<8>(x, w, tile_group, n_used, out, M, K, N, G, bm,
                          chunks, rows_per_block, vec, s);
  }
  if (dtype == 0) {
    if (mf <= 1)
      return launch_f32<1>(x, w, tile_group, n_used, out, M, K, N, G, bm,
                           chunks, rows_per_block, s);
    if (mf <= 2)
      return launch_f32<2>(x, w, tile_group, n_used, out, M, K, N, G, bm,
                           chunks, rows_per_block, s);
    if (mf <= 4)
      return launch_f32<4>(x, w, tile_group, n_used, out, M, K, N, G, bm,
                           chunks, rows_per_block, s);
    return launch_f32<8>(x, w, tile_group, n_used, out, M, K, N, G, bm,
                         chunks, rows_per_block, s);
  }
  return -1;
}

const char* mars_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
