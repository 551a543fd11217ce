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
// reading every used expert's (K, N) matrix once: about 13 x 7168 x 4864
// x 2 B = 0.9 GB per product, 0.27 ms at 3.35 TB/s on an H100 SXM,
// against 1.1 GFLOP of real work.  So the design is about keeping the
// device memory streaming: enough bytes in flight on every SM, in runs
// long enough for the memory to serve them well, and nothing else read
// or written in bulk.
//
// Design (bfloat16, K and N multiples of 8, 16-byte aligned operands:
// the serve path).  On the TPU the grid is (row tile, N tile, K tile)
// with an f32 VMEM accumulator carried along the sequential K axis.  Here
// a work unit is (row tile, column span, K slab):
//   * Long runs.  A unit owns a span of 512 columns (1 KB of each weight
//     row; 256 or 128 when a tile has 32 or 64 rows, to bound the
//     accumulators) and one slab of K rows, so every weight row it reads
//     is a 1 KB run, and the spans of one slab sit next to each other in
//     the grid (span is the fastest index), so the blocks that run
//     together read whole rows of one expert.
//   * K split across the card.  The host's `split_plan` cuts K into
//     slabs from the shapes and the SM count alone (never the live tile
//     count, which only the device knows), so that tiles x spans x slabs
//     fill about two waves of one block an SM.  Each unit writes its f32
//     partial to scratch and counts itself on its output tile's arrival
//     counter; the last unit to arrive sums the slabs' partials in slab
//     order, writes the tile in bf16 and sets the counter back to 0 for
//     the next call: one launch a call.  With one slab the unit writes
//     the tile directly.
//   * TMA ring.  One producer warp keeps a 4-stage ring full with TMA
//     loads (a stage: 32 K rows of the span, 32 KB, as 64-column boxes in
//     the 128-byte swizzle, plus the x tile's 32 columns in the 64-byte
//     swizzle), each stage's arrival an mbarrier with its byte count and
//     its release an mbarrier the four consumer warps arrive at: about
//     100 KB in flight on each SM (one block of 133 KB an SM; in
//     exploratory runs on an H100 this was at least as fast as three
//     stages with two blocks an SM or six with one, and an L2
//     evict-first hint on the weights did not help).  The tensor maps
//     are 3-D over w (N, K, G), so a box
//     never reads past its expert's last K row: rows past K, and columns
//     past N, arrive as zeros.
//   * The product.  At decode a 16-row tile holds one to three real rows,
//     and compute is not the bound (the tensor cores are busy for a few
//     percent of a stage's arrival time), so the consumers run mma.sync
//     m16n8k16 on the landed stages: x fragments with ldmatrix, weight
//     fragments with ldmatrix.trans, both at swizzled addresses, so the
//     eight rows of each read hit distinct banks.  Each consumer warp owns
//     a quarter of the span.
//   * Dead tiles (past n_used, or a group outside [0, G)): the slab-0
//     unit writes the tile's zeros; the others return at once.  No weight
//     is read and no counter is touched.
// What is left: a unit carries one 16-row tile, so an expert with
// several tiles (prefills of many tokens) has its weights read once per
// tile; only the device knows which consecutive tiles share an expert,
// and folding them into one unit would need the grid to depend on it.
//
// Other operands (float32, which serves the exact float32 checks, or
// bfloat16 whose K or N is not a multiple of 8 or whose base is not
// 16-byte aligned): a plain CUDA-core tiling, 16 x 64 outputs per 256
// threads and row fragment, K in steps of 16, every load masked at the K
// and N edges.  Padding rows are zero, so the result does not depend on
// bm.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 128;          // rows a CUDA-core block multiplies

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Which rows of which tile a block owns, and whether the tile is in use.
struct TileRows {
  int tile, row0, rows, group;
  bool live;
};

__device__ __forceinline__ TileRows tile_rows(int tile, int chunk,
                                              const int32_t* tile_group,
                                              const int32_t* n_used, int M,
                                              int G, int bm,
                                              int rows_per_unit) {
  TileRows t;
  t.tile = tile;
  t.row0 = tile * bm + chunk * rows_per_unit;
  t.rows = min(rows_per_unit, bm - chunk * rows_per_unit);
  const int used = n_used ? *n_used : M / bm;
  t.group = tile_group[tile];
  t.live = tile < used && t.group >= 0 && t.group < G;
  return t;
}

template <typename T>
__device__ void write_zeros(T* out, int row0, int rows, int col0, int bn,
                            int N) {
  const T zero = from_f32<T>(0.f);
  for (int idx = threadIdx.x; idx < rows * bn; idx += blockDim.x) {
    const int r = idx / bn, c = idx % bn;
    if (col0 + c < N) out[(size_t)(row0 + r) * N + col0 + c] = zero;
  }
}

// ---- bfloat16: TMA ring, K split over the card ------------------------------
namespace tma {

constexpr int kBK = 32;                // K rows a ring stage holds
constexpr int kStages = 4;
constexpr int kConsumerWarps = 4;
constexpr int kThreads = 32 * kConsumerWarps + 32;   // + the producer warp

// A unit of 16 MF rows owns 512 / MF columns: MF x (columns a warp / 8)
// x 4 = 64 f32 accumulators a consumer thread whatever MF.  A ring stage
// holds the span's 32 K rows as 64-column boxes of 32 x 128 bytes
// (128-byte swizzle), then the x tile's 32 columns (64-byte rows, 64-byte
// swizzle); the mbarriers (full[stage], empty[stage]) follow; 1 KB of
// slack aligns the base to the 128-byte swizzle's 1024-byte period.
template <int MF>
struct Geo {
  static constexpr int kRows = 16 * MF;
  static constexpr int kBN = 512 / MF;
  static constexpr int kBoxes = kBN / 64;
  static constexpr int kWN = kBN / kConsumerWarps;
  static constexpr int kNF = kWN / 8;
  static constexpr int kBoxBytes = kBK * 128;
  static constexpr int kWStage = kBoxes * kBoxBytes;
  static constexpr int kXStage = kRows * kBK * 2;
  static constexpr int kXOff = kStages * kWStage;
  static constexpr int kBarOff = kXOff + kStages * kXStage;
  static constexpr int kSmem = kBarOff + 8 * 2 * kStages + 1024;
  static_assert(kXStage % 512 == 0, "x stages keep the 64-byte swizzle");
  static_assert(kSmem <= 227 * 1024, "fits a block");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait until the phase of parity `parity` has completed.  A phase that
// never completes (a lost transaction) traps after about ten seconds
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  for (int spin = 0;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) t0 = clock64();
    else if ((spin & 1023) == 0 && clock64() - t0 > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Shared address of the 16-byte chunk (row, chunk) of a swizzled tile:
// 128-byte rows swap chunk c for c ^ (row % 8), 64-byte rows for
// c ^ ((row / 2) % 4), as TMA wrote them.
__device__ __forceinline__ uint32_t sw128(uint32_t base, int row, int chunk) {
  return base + row * 128 + ((chunk ^ (row & 7)) << 4);
}
__device__ __forceinline__ uint32_t sw64(uint32_t base, int row, int chunk) {
  return base + row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4);
}

// Called by every thread once the consumers wrote the unit's partial:
// counts the unit on its output tile's arrival counter; the last of the
// tile's n_split units sums the partials in slab order, writes the tile
// in bf16 and sets the counter back to 0.
template <int ROWS, int BN>
__device__ void merge_if_last(const float* part, int* counters,
                              long long otile, int n_split,
                              __nv_bfloat16* out, int row0, int col0,
                              int N) {
  __shared__ int last;
  __threadfence();                 // this unit's partial, before its count
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counters + otile, 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();                 // the others' partials, after their counts
  const float* rec = part + otile * n_split * (long long)(ROWS * BN);
  for (int e = threadIdx.x; e < ROWS * BN / 4; e += blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < n_split; ++sp) {
      const float4 a = __ldcg(reinterpret_cast<const float4*>(
          rec + sp * (long long)(ROWS * BN)) + e);
      acc.x += a.x;
      acc.y += a.y;
      acc.z += a.z;
      acc.w += a.w;
    }
    const int r = (4 * e) / BN, col = col0 + (4 * e) % BN;
    if (col < N) {             // N % 8 == 0: the four columns lie inside
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
          out + (size_t)(row0 + r) * N + col);
      o[0] = __floats2bfloat162_rn(acc.x, acc.y);
      o[1] = __floats2bfloat162_rn(acc.z, acc.w);
    }
  }
  if (threadIdx.x == 0) counters[otile] = 0;   // armed for the next call
}

// Unit u = ((tile * chunks + chunk) * n_split + split) * n_span + span.
template <int MF>
__global__ void __launch_bounds__(kThreads, 1)
grouped_mm_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const int32_t* __restrict__ tile_group,
                      const int32_t* __restrict__ n_used,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ part, int* __restrict__ counters,
                      int M, int K, int N, int G, int bm, int n_span,
                      int n_split, int k_per_split) {
  using Gm = Geo<MF>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sx = base + Gm::kXOff;
  const uint32_t full0 = base + Gm::kBarOff, empty0 = full0 + 8 * kStages;

  const int chunks = bm / Gm::kRows;
  int u = blockIdx.x;
  const int span = u % n_span;
  u /= n_span;
  const int split = u % n_split;
  u /= n_split;
  const TileRows t = tile_rows(u / chunks, u % chunks, tile_group, n_used,
                               M, G, bm, Gm::kRows);
  const int col0 = span * Gm::kBN;
  if (!t.live) {
    if (split == 0) write_zeros(out, t.row0, Gm::kRows, col0, Gm::kBN, N);
    return;
  }
  const int k0 = split * k_per_split;
  const int nsteps = (min(K, k0 + k_per_split) - k0 + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[MF][Gm::kNF][4];
#pragma unroll
  for (int mi = 0; mi < MF; ++mi)
#pragma unroll
    for (int ni = 0; ni < Gm::kNF; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  if (warp == kConsumerWarps) {        // the producer warp: TMA loads only
    if (lane == 0) {
      for (int i = 0; i < nsteps; ++i) {
        const int s = i % kStages, round = i / kStages;
        if (round > 0) mbar_wait(empty0 + 8 * s, (round - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, Gm::kWStage + Gm::kXStage);
        const int k = k0 + i * kBK;
        tma_load_2d(sx + s * Gm::kXStage, &xmap, full, k, t.row0);
        for (int b = 0; b < Gm::kBoxes; ++b)
          tma_load_3d(base + s * Gm::kWStage + b * Gm::kBoxBytes, &wmap,
                      full, col0 + 64 * b, k, t.group);
      }
    }
  } else {                             // consumers
    const int m = lane >> 3;           // ldmatrix: which 8x8 matrix
    for (int i = 0; i < nsteps; ++i) {
      const int s = i % kStages;
      mbar_wait(full0 + 8 * s, (i / kStages) & 1);
      const uint32_t xs = sx + s * Gm::kXStage;
      const uint32_t ws = base + s * Gm::kWStage;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t b[Gm::kNF][2];
        const int krow = kk + (m & 1) * 8 + (lane & 7);
#pragma unroll
        for (int p = 0; p < Gm::kNF / 2; ++p) {
          const int col = warp * Gm::kWN + p * 16 + (m >> 1) * 8;
          ldmatrix_x4_trans(b[2 * p][0], b[2 * p][1], b[2 * p + 1][0],
                            b[2 * p + 1][1],
                            sw128(ws + (col >> 6) * Gm::kBoxBytes, krow,
                                  (col & 63) >> 3));
        }
#pragma unroll
        for (int mi = 0; mi < MF; ++mi) {
          uint32_t a[4];
          const int row = mi * 16 + (m & 1) * 8 + (lane & 7);
          ldmatrix_x4(a, sw64(xs, row, (kk >> 3) + (m >> 1)));
#pragma unroll
          for (int ni = 0; ni < Gm::kNF; ++ni) mma_bf16(acc[mi][ni], a, b[ni]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }
  }

  // accumulator (mi, ni): rows mi*16 + lane/4 (+8), columns
  // warp*kWN + ni*8 + 2*(lane%4) (+1)
  const int g = lane >> 2, q = lane & 3;
  const long long otile = (long long)blockIdx.x / (n_split * n_span) *
                              n_span + span;
  if (n_split == 1) {
    if (warp == kConsumerWarps) return;
#pragma unroll
    for (int mi = 0; mi < MF; ++mi)
#pragma unroll
      for (int ni = 0; ni < Gm::kNF; ++ni) {
        const int col = col0 + warp * Gm::kWN + ni * 8 + 2 * q;
        if (col >= N) continue;        // N % 8 == 0: col + 1 < N too
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<__nv_bfloat162*>(
              out + (size_t)(t.row0 + mi * 16 + g + 8 * h) * N + col) =
              __floats2bfloat162_rn(acc[mi][ni][2 * h],
                                    acc[mi][ni][2 * h + 1]);
      }
    return;
  }
  if (warp < kConsumerWarps) {
    float* rec = part + (otile * n_split + split) * (long long)(Gm::kRows *
                                                                Gm::kBN);
#pragma unroll
    for (int mi = 0; mi < MF; ++mi)
#pragma unroll
      for (int ni = 0; ni < Gm::kNF; ++ni) {
        const int col = warp * Gm::kWN + ni * 8 + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          __stcg(reinterpret_cast<float2*>(
                     rec + (mi * 16 + g + 8 * h) * Gm::kBN + col),
                 make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]));
      }
  }
  merge_if_last<Gm::kRows, Gm::kBN>(part, counters, otile, n_split, out,
                                    t.row0, col0, N);
}

}  // namespace tma

// ---- any dtype, any alignment: CUDA cores -----------------------------------
namespace cores {

constexpr int kThreads = 256;
constexpr int kBN = 64;
constexpr int kBK = 16;

template <typename T, int MF>
__global__ void __launch_bounds__(kThreads)
grouped_mm_cores_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const int32_t* __restrict__ tile_group,
                        const int32_t* __restrict__ n_used,
                        T* __restrict__ out, int M, int K, int N, int G,
                        int bm, int chunks, int rows_per_block) {
  __shared__ float xs[MF * 16][kBK + 1];
  __shared__ __align__(16) float ws[kBK][kBN];
  const TileRows t = tile_rows(blockIdx.x / chunks, blockIdx.x % chunks,
                               tile_group, n_used, M, G, bm,
                               rows_per_block);
  const int col0 = blockIdx.y * kBN;
  if (!t.live) {
    write_zeros(out, t.row0, t.rows, col0, kBN, N);
    return;
  }
  const int mf = t.rows / 16;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* xr = x + (size_t)t.row0 * K;
  const T* wg = w + (size_t)t.group * K * N;
  float acc[MF][4];
#pragma unroll
  for (int mi = 0; mi < MF; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[mi][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < t.rows * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      xs[r][kk] = k0 + kk < K ? to_f32(xr[(size_t)r * K + k0 + kk]) : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int kr = i / kBN, c = i % kBN;
      ws[kr][c] = (k0 + kr < K && col0 + c < N)
                      ? to_f32(wg[(size_t)(k0 + kr) * N + col0 + c])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
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
    T* o = out + (size_t)(t.row0 + mi * 16 + ty) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col < N) o[col] = from_f32<T>(acc[mi][j]);
    }
  }
}

template <typename T, int MF>
int launch(const void* x, const void* w, const void* tg, const void* n_used,
           void* out, int M, int K, int N, int G, int bm, int chunks,
           int rows_per_block, cudaStream_t s) {
  const dim3 grid((unsigned)((M / bm) * chunks),
                  (unsigned)((N + kBN - 1) / kBN));
  grouped_mm_cores_kernel<T, MF><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int32_t*>(tg), static_cast<const int32_t*>(n_used),
      static_cast<T*>(out), M, K, N, G, bm, chunks, rows_per_block);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any(const void* x, const void* w, const void* tg,
               const void* n_used, void* out, int M, int K, int N, int G,
               int bm, cudaStream_t s) {
  const int rows = bm < kMaxRows ? bm : kMaxRows;
  const int chunks = (bm + rows - 1) / rows;
  const int mf = rows / 16;
  if (mf <= 1)
    return launch<T, 1>(x, w, tg, n_used, out, M, K, N, G, bm, chunks, rows,
                        s);
  if (mf <= 2)
    return launch<T, 2>(x, w, tg, n_used, out, M, K, N, G, bm, chunks, rows,
                        s);
  if (mf <= 4)
    return launch<T, 4>(x, w, tg, n_used, out, M, K, N, G, bm, chunks, rows,
                        s);
  return launch<T, 8>(x, w, tg, n_used, out, M, K, N, G, bm, chunks, rows,
                      s);
}

}  // namespace cores

// cuTensorMapEncodeTiled from the libcuda.so.1 the process has loaded
// (found at run time, so the library links against the runtime alone).
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first, strides in bytes for
// dims 1..), boxes of `box`; what lies outside the tensor reads as zero.
bool tensor_map(CUtensorMap* map, const void* ptr, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kNoTensorMap = -2;

template <int MF>
int launch_tma(const void* x, const void* w, const void* tg,
               const void* n_used, void* out, int M, int K, int N, int G,
               int bm, int n_span, int n_split, int k_per_split, float* part,
               int* counters, cudaStream_t s) {
  using Gm = tma::Geo<MF>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        tma::grouped_mm_tma_kernel<MF>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::kSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  CUtensorMap xm, wm;
  const cuuint64_t xdims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t xstrides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xbox[2] = {tma::kBK, Gm::kRows};
  const cuuint64_t wdims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)G};
  const cuuint64_t wstrides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t wbox[3] = {64, tma::kBK, 1};
  if (!tensor_map(&xm, x, 2, xdims, xstrides, xbox,
                  CU_TENSOR_MAP_SWIZZLE_64B) ||
      !tensor_map(&wm, w, 3, wdims, wstrides, wbox,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return kNoTensorMap;
  const long long units =
      (long long)(M / bm) * (bm / Gm::kRows) * n_split * n_span;
  tma::grouped_mm_tma_kernel<MF><<<(unsigned)units, tma::kThreads, Gm::kSmem,
                                   s>>>(
      xm, wm, static_cast<const int32_t*>(tg),
      static_cast<const int32_t*>(n_used), static_cast<__nv_bfloat16*>(out),
      part, counters, M, K, N, G, bm, n_span, n_split, k_per_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and out alike).  path: 0 = CUDA
// cores (any dtype, alignment and shape); 1 = the bf16 TMA kernel, which
// needs K and N multiples of 8, x and w 16-byte aligned, and takes units
// of `rows` rows (16, 32 or 64, dividing bm) by 512 * 16 / rows columns
// (n_span spans cover N) by n_split slabs of k_per_split K rows (a
// multiple of 32; the last slab may be shorter).  With n_split > 1, part
// holds (M / rows) * n_span * n_split * rows * (512 * 16 / rows) floats
// and counters (M / rows) * n_span ints that are 0 before the launch and
// 0 again after it.  n_used: device int32 scalar or null.  bm: a multiple
// of 16 that divides M.  Returns 0 on success, -1 for an unsupported
// argument, -2 when no tensor map can be encoded, else the cudaError_t of
// the launch.
int mars_grouped_matmul(int dtype, int path, const void* x, const void* w,
                        const void* tile_group, const void* n_used, void* out,
                        int M, int K, int N, int G, int bm, int rows,
                        int n_span, int n_split, int k_per_split, float* part,
                        int* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm <= 0 || bm % 16 != 0 || M % bm != 0 || K <= 0 || N <= 0 || G <= 0)
    return -1;
  if (M == 0) return 0;
  if (path == 0) {
    if (dtype == 0)
      return cores::launch_any<float>(x, w, tile_group, n_used, out, M, K, N,
                                      G, bm, s);
    if (dtype == 1)
      return cores::launch_any<__nv_bfloat16>(x, w, tile_group, n_used, out,
                                              M, K, N, G, bm, s);
    return -1;
  }
  if (path != 1 || dtype != 1 || K % 8 != 0 || N % 8 != 0 ||
      bm % rows != 0 || n_split < 1 || k_per_split < tma::kBK ||
      k_per_split % tma::kBK != 0 ||
      (long long)(n_split - 1) * k_per_split >= K ||
      (long long)n_split * k_per_split < K ||
      (n_split > 1 && (part == nullptr || counters == nullptr)))
    return -1;
  const int span = 512 * 16 / rows;
  if ((long long)n_span * span < N || (long long)(n_span - 1) * span >= N)
    return -1;
  switch (rows) {
    case 16:
      return launch_tma<1>(x, w, tile_group, n_used, out, M, K, N, G, bm,
                           n_span, n_split, k_per_split, part, counters, s);
    case 32:
      return launch_tma<2>(x, w, tile_group, n_used, out, M, K, N, G, bm,
                           n_span, n_split, k_per_split, part, counters, s);
    case 64:
      return launch_tma<4>(x, w, tile_group, n_used, out, M, K, N, G, bm,
                           n_span, n_split, k_per_split, part, counters, s);
    default:
      return -1;
  }
}

const char* mars_cuda_error_string(int err) {
  if (err == kNoTensorMap)
    return "cuTensorMapEncodeTiled is unavailable or refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
