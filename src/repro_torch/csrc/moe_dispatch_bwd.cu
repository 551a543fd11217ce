// Backward of the MARS-sorted grouped GEMM (B4) for Hopper (sm_90a), plain
// C interface.
//
// Replaces no Pallas kernel: the JAX trainer differentiates the
// reference's `lax.ragged_dot` (src/repro/models/moe.py:77-89) with
// jax.value_and_grad.  This is the backward of K4 (csrc/moe_dispatch.cu):
// for out = x @ w[tile_group[r / bm]] over expert-sorted, tile-padded rows
// (x (M, K), w (G, K, N), out (M, N)), given dout (M, N):
//   dx[tile i] = dout[tile i] @ w[g_i]^T                  (M, K)
//   dw[g]      = sum over live tiles i of g of x[tile i]^T @ dout[tile i]
// summed in f32, dx rounded to x's dtype and dw to w's once.  Tiles at or
// past `n_used` (a device int32 scalar, or null for "all"), or whose
// group lies outside [0, G), get zeros in dx and add nothing to dw; an
// expert with no live tile gets exact zeros.  No float atomics: every sum
// has one owner and a fixed order, so two calls agree bit for bit.
//
// Bound: bytes.  At arctic-480b's training step (8 x 512 tokens top-2 =
// 8192 rows over 128 experts, w_in 7168 x 4864) dw writes every expert's
// (K, N) matrix, 8.93 GB in bf16 (2.66 ms at 3.35 TB/s), and dx reads the
// same bytes of w once (2.66 ms), against 0.57 TFLOP each (0.58 ms at 989
// TFLOP/s).
//
// Design (bf16, K and N multiples of 8, 16-byte aligned operands: the
// training path).  Both products run on bf16 mma.sync m16n8k16 with f32
// accumulators, their operands staged by cp.async (16 bytes a thread,
// zero-filled past the K and N edges) in a ring of padded shared-memory
// tiles whose row pitch keeps each ldmatrix read free of bank conflicts.
//   * dx: a unit is (128 rows, 128 output columns of K), 8 warps.  At
//     training an expert holds 4 or 5 row tiles of 16, so a unit per
//     tile would read each expert's weight rows 4 or 5 times over (from
//     L2).  Here each 16-row group of the unit lies in one tile, and the
//     unit runs one pass over N for each distinct live expert among its
//     groups: that expert's weight rows (contiguous along N: the B
//     operand by ldmatrix without .trans) against the dout rows of its
//     groups alone, so a row accumulates only in its own expert's pass.
//     A stage holds 64 columns (128-byte runs of each weight row), 3 in a
//     ring, two blocks an SM (the fastest of the stage sizes and depths
//     tried on an H100, PERF.md).  Row units are the fastest grid index,
//     so the units that run together read the same weight rows.  Dead
//     tiles write zeros and read nothing.
//   * dw: a block owns (expert g, 128 rows of K, one slab of g's row
//     tiles) and `walk` 128-column tiles of N (`bwd_plan`: 4 where the
//     (expert, K band) pairs alone fill 16 waves of the card, else 1).  It
//     lists, in ascending order, the tiles of its slab (the block reads 256
//     entries of tile_group at a time, a ballot a warp; no assumption that
//     groups are sorted), then walks (N tile, 32 rows) steps in one
//     pipeline: x's rows transposed by ldmatrix.trans (A, K x rows) against
//     dout's rows by ldmatrix.trans (B, rows x N), each output tile written
//     as its last rows land, so a walk pays the list and the pipeline's
//     start once for its tiles.  An expert with no tile writes zeros, in
//     the same launch.
//   * The row split is decided on the device, from the routing: an expert
//     whose live tiles are many (at least 2 split_tiles; the host picks
//     split_tiles from shapes: few rows where the blocks alone would not
//     fill the card, else up to 16384 rows over a block's walk, since on
//     an H100 a cut of a 4096-row expert at full width cost more in
//     partials than it saved) is cut into slabs of rank ranges, run by
//     extra blocks at the front of the grid (see Slab).  Each slab's block writes its f32 partial of each output
//     tile to the slab's slot and counts itself on the tile's arrival
//     counter; the last to arrive sums the partials in slab order from
//     zero, writes the tile and sets the counter back to 0 (K4's scheme).
//     The twin `grouped_matmul_bwd_plain` cuts the same slabs and sums each
//     slab's tiles in ascending order and the slabs in order, as here.
//
// Other operands (float32, or bf16 whose K or N is not a multiple of 8 or
// whose base is not 16-byte aligned): the same units and slabs on CUDA
// cores, f32 in shared memory, every load masked at the edges.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

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

// Experts the row split's per-expert counts hold (shared memory: the dw
// kernels' stages before they fill).
constexpr int kMaxSplitGroups = 1024;

__device__ __forceinline__ int used_tiles(const int32_t* n_used, int T) {
  return n_used ? min(max(*n_used, 0), T) : T;
}

// Whether row tile `tile` is in use and its group is in [0, G).
__device__ __forceinline__ bool live_tile(int tile, int g, int used,
                                          int G) {
  return tile < used && g >= 0 && g < G;
}

// out[row0 .. row0 + rows)[col0 .. col0 + bc) = 0, columns past ncols
// left alone.
template <typename T>
__device__ void write_zeros(T* out, long long row0, int rows, int col0,
                            int bc, int ncols) {
  const T zero = from_f32<T>(0.f);
  for (int idx = threadIdx.x; idx < rows * bc; idx += blockDim.x) {
    const int r = idx / bc, c = idx % bc;
    if (col0 + c < ncols) out[(row0 + r) * ncols + col0 + c] = zero;
  }
}

// Lists the tiles t of [*cursor, t_hi) with tile_group[t] == g whose rank
// among g's tiles (*seen of them lie before *cursor) is in [r_lo, r_hi),
// in ascending order, into list[0 ..) while it has room for a whole round
// of kThreads more; advances *cursor past the tiles read (to t_hi once
// rank r_hi is reached) and *seen past g's tiles among them.  Returns the
// list's length.  Every thread calls it and gets the same values.
template <int kThreads>
__device__ int collect_tiles(const int32_t* __restrict__ tile_group, int g,
                             int* cursor, int* seen, int t_hi, int r_lo,
                             int r_hi, int* list, int cap, int* warp_counts) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int cur = *cursor, sn = *seen;
  const int first = max(r_lo, sn);     // the rank list[0] holds
  while (cur < t_hi && sn < r_hi && max(0, sn - first) + kThreads <= cap) {
    const int t = cur + tid;
    const bool hit = t < t_hi && tile_group[t] == g;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int base = sn, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) base += warp_counts[w];
      total += warp_counts[w];
    }
    const int rank = base + __popc(ballot & ((1u << lane) - 1u));
    if (hit && rank >= r_lo && rank < r_hi) list[rank - first] = t;
    __syncthreads();                   // every thread read the counts
    sn += total;
    cur += kThreads;
  }
  *cursor = sn >= r_hi ? t_hi : cur;
  *seen = sn;
  return max(0, min(sn, r_hi) - first);
}

// ---- the row split: an expert's many row tiles cut across blocks -----------
// An expert with c live tiles asks for req = min(max_split, c / split_tiles)
// slabs where that is 2 or more; in expert order a request is granted
// while the requests so far, granted or not, fit the `slots` partial slots
// (so the granted experts come first).  Granted expert g's slab s takes its
// tiles of rank [c s / req, c (s + 1) / req) and partial slot base_g + s
// (base_g: the requests before g); slab 0 runs on g's own blocks, slabs
// 1 .. req - 1 on the extra blocks at the front of the grid, numbered in
// expert order.  Any other expert is one slab, written directly.  The
// plain twin `grouped_matmul_bwd_plain` makes the same choices.
struct Slab {
  int g, s, n, slot, count;
};

// counts[0 .. G) (shared) = the live tiles of each expert, one atomic a
// warp for each expert among its 32 tiles (sorted tiles would otherwise
// serialize on one counter).  Every thread calls it.
__device__ void count_experts(const int32_t* __restrict__ tile_group,
                              int used, int G, int* counts) {
  for (int i = threadIdx.x; i < G; i += blockDim.x) counts[i] = 0;
  __syncthreads();
  for (int t0 = 0; t0 < used; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    int g = t < used ? tile_group[t] : -1;
    if (g >= G) g = -1;
    const unsigned peers = __match_any_sync(0xffffffffu, g);
    if (g >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(counts + g, __popc(peers));
  }
  __syncthreads();
}

// From counts (count_experts), the slab of extra block `extra` (out->g =
// -1 where no granted request has it) or, with extra < 0, expert g_own's
// slab count and slot base.  Warp 0 scans the requests 32 experts at a
// time; every thread calls it and out (shared) is set on return.
__device__ void find_slab(const int* counts, int G, int split_tiles,
                          int max_split, int slots, int g_own, int extra,
                          Slab* out) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    if (lane == 0)
      *out = Slab{extra >= 0 ? -1 : g_own, 0, 1, 0,
                  extra >= 0 ? 0 : counts[g_own]};
    __syncwarp();
    int base = 0, nreq = 0;            // requests and requesters so far
    for (int g0 = 0; g0 < G && base + 2 <= slots; g0 += 32) {
      const int g = g0 + lane;
      const int c = g < G ? counts[g] : 0;
      int req = min(max_split, c / split_tiles);
      if (req < 2) req = 0;
      int inc = req, who = req > 0;    // inclusive scans over the lanes
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int a = __shfl_up_sync(0xffffffffu, inc, off);
        const int b = __shfl_up_sync(0xffffffffu, who, off);
        if (lane >= off) inc += a, who += b;
      }
      const int my_base = base + inc - req;
      if (req > 0 && my_base + req <= slots) {
        const int first_extra = my_base - (nreq + who - 1);
        if (extra < 0 && g == g_own) out->n = req, out->slot = my_base;
        if (extra >= first_extra && extra < first_extra + req - 1)
          *out = Slab{g, extra - first_extra + 1, req, my_base, c};
      }
      base += __shfl_sync(0xffffffffu, inc, 31);
      nreq += __shfl_sync(0xffffffffu, who, 31);
    }
  }
  __syncthreads();
}

// The block's slab, and its first list of tiles: an extra block (extra >=
// 0) finds its slab from every expert's count; a block of expert g lists
// g's tiles, and only where g asks for a split does it count every
// expert's to learn whether the split is granted.  On return list[0 ..
// *n_list) holds the slab's first tiles, and *cursor / *seen where the
// next list starts (*cursor == used: the list is the whole slab); false
// for an extra block with no slab.  counts: G ints of shared memory apart
// from the list.  Every thread calls it and gets the same values.
template <int kThreads>
__device__ bool block_slab(const int32_t* __restrict__ tile_group, int used,
                           int G, int split_tiles, int max_split, int slots,
                           int extra, int g, int* counts, int* list, int cap,
                           int* warp_counts, Slab* sl, Slab* mine,
                           int* cursor, int* seen, int* n_list) {
  *cursor = 0, *seen = 0;
  if (extra < 0) {
    *n_list = collect_tiles<kThreads>(tile_group, g, cursor, seen, used, 0,
                                      INT_MAX, list, cap, warp_counts);
    int c = *seen;
    if (*cursor < used) {              // more than the list holds: count
      int cur = *cursor;
      collect_tiles<kThreads>(tile_group, g, &cur, &c, used, INT_MAX,
                              INT_MAX, list, cap, warp_counts);
    }
    *mine = Slab{g, 0, 1, 0, c};
    if (slots < 2 || min(max_split, c / split_tiles) < 2) return true;
  }
  count_experts(tile_group, used, G, counts);
  find_slab(counts, G, split_tiles, max_split, slots, g, extra, sl);
  *mine = *sl;
  __syncthreads();                     // every thread read sl
  if (mine->g < 0) return false;
  *cursor = 0, *seen = 0;
  const int c = mine->count, s = mine->s, n = mine->n;
  *n_list = collect_tiles<kThreads>(
      tile_group, mine->g, cursor, seen, used, (int)((long long)c * s / n),
      (int)((long long)c * (s + 1) / n), list, cap, warp_counts);
  return true;
}

// Called by every thread once the block wrote its f32 partial (slab s of
// n, at rec0 + s * stride): counts the block on the output tile's arrival
// counter; the last of the n sums the partials in slab order from zero,
// writes the tile (rows past nrows, columns past ncols left alone) and
// sets the counter back to 0.
template <typename T, int BR, int BC>
__device__ void merge_if_last(const float* rec0, long long stride,
                              int* counter, int n, T* out, int row0,
                              int col0, int nrows, int ncols) {
  __shared__ int last;
  __threadfence();                 // this block's partial, before its count
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == n - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();                 // the others' partials, after their counts
  for (int e = threadIdx.x; e < BR * BC; e += blockDim.x) {
    const int r = e / BC, c = e % BC;
    if (row0 + r >= nrows || col0 + c >= ncols) continue;
    float acc = 0.f;
    for (int sp = 0; sp < n; ++sp) acc += __ldcg(rec0 + sp * stride + e);
    out[(long long)(row0 + r) * ncols + col0 + c] = from_f32<T>(acc);
  }
  if (threadIdx.x == 0) *counter = 0;   // armed for the next call
}

// ---- bfloat16: mma.sync on cp.async stages ----------------------------------
namespace mma {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(smem)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(smem)));
}
// c (16 x 8, f32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- dx: a unit is (128 rows, 128 columns of K) ------------------------------
constexpr int kDxThreads = 256;        // 8 warps: 2 over rows, 4 over columns
constexpr int kDxRows = 128;           // rows a unit covers (one or more tiles)
constexpr int kDxCols = 128;           // K columns a unit writes
constexpr int kDxGroups = kDxRows / 16;
constexpr int kDxStep = 64;            // N columns a stage holds
constexpr int kDxChunks = kDxStep / 8;     // 16-byte chunks of a stage row
constexpr int kDxPitch = kDxStep + 8;      // padded bf16 row
constexpr int kDxStages = 3;
constexpr int kDxStageElems = (kDxRows + kDxCols) * kDxPitch;  // dout, w
constexpr int kDxSmem = kDxStages * kDxStageElems * 2;
static_assert(kDxSmem <= 227 * 1024, "fits a block");
static_assert(kDxStep % 16 == 0 && kDxStages >= 2, "whole k-steps, a ring");

// Unit u = ob * row_units + ru: rows [128 ru, 128 ru + 128), K columns
// [128 ob, 128 ob + 128).  Each 16-row group of the unit lies in one row
// tile (bm is a multiple of 16); the unit runs one pass over N for each
// distinct expert among its live groups, that expert's weight rows
// against the dout rows of its groups alone, so a row accumulates only
// in its own expert's pass, in the same order as alone.
__global__ void __launch_bounds__(kDxThreads)
grouped_bwd_dx_mma_kernel(const __nv_bfloat16* __restrict__ dout,
                          const __nv_bfloat16* __restrict__ w,
                          const int32_t* __restrict__ tile_group,
                          const int32_t* __restrict__ n_used,
                          __nv_bfloat16* __restrict__ dx, int M, int K, int N,
                          int G, int bm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __shared__ int s_grp[kDxGroups];     // group of each 16 rows; -1 dead,
                                       // -2 past M
  __shared__ int s_pass[kDxGroups];    // the passes' experts
  __shared__ unsigned s_mask[kDxGroups];   // the 16-row groups of a pass
  __shared__ int s_np;
  const int row_units = (M + kDxRows - 1) / kDxRows;
  const long long r0 = (long long)(blockIdx.x % row_units) * kDxRows;
  const int o0 = (int)(blockIdx.x / row_units) * kDxCols;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mat = lane >> 3, wr = warp >> 2, wc = warp & 3;
  if (tid < kDxGroups) {
    const long long r = r0 + 16 * tid;
    int e = -2;
    if (r < M) {
      const int T = M / bm, tile = (int)(r / bm), g = tile_group[tile];
      e = live_tile(tile, g, used_tiles(n_used, T), G) ? g : -1;
    }
    s_grp[tid] = e;
  }
  __syncthreads();
  if (tid == 0) {
    int np = 0;
    for (int i = 0; i < kDxGroups; ++i) {
      const int e = s_grp[i];
      if (e < 0) continue;
      int p = 0;
      while (p < np && s_pass[p] != e) ++p;
      if (p == np) s_pass[np] = e, s_mask[np++] = 0u;
      s_mask[p] |= 1u << i;
    }
    s_np = np;
  }
  __syncthreads();
  const int nsteps = (N + kDxStep - 1) / kDxStep;
  const int total = s_np * nsteps;

  auto load = [&](int t, int slot) {
    __nv_bfloat16* Ds = sm + slot * kDxStageElems;
    __nv_bfloat16* Ws = Ds + kDxRows * kDxPitch;
    const int p = t / nsteps, c0 = (t - p * nsteps) * kDxStep;
    const int e = s_pass[p];
    const unsigned mask = s_mask[p];
    for (int i = tid; i < (kDxRows + kDxCols) * kDxChunks;
         i += kDxThreads) {
      const int r = i / kDxChunks, cc = (i % kDxChunks) * 8, c = c0 + cc;
      if (r < kDxRows) {
        if (!((mask >> (r >> 4)) & 1u)) continue;   // not read this pass
        const bool ok = c < N;
        cp_async16(Ds + r * kDxPitch + cc,
                   ok ? dout + (r0 + r) * N + c : dout, ok);
      } else {
        const int o = r - kDxRows;
        const bool ok = c < N && o0 + o < K;
        cp_async16(Ws + o * kDxPitch + cc,
                   ok ? w + ((long long)e * K + o0 + o) * N + c : w, ok);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kDxStages - 1; ++st) {
    if (st < total) load(st, st);
    cp_async_commit();
  }
  for (int t = 0; t < total; ++t) {
    cp_async_wait<kDxStages - 2>();
    __syncthreads();           // step t landed; slot (t - 1) is free
    if (t + kDxStages - 1 < total)
      load(t + kDxStages - 1, (t + kDxStages - 1) % kDxStages);
    cp_async_commit();
    const __nv_bfloat16* Ds = sm + (t % kDxStages) * kDxStageElems;
    const __nv_bfloat16* Ws = Ds + kDxRows * kDxPitch;
    const unsigned mask = s_mask[t / nsteps];
#pragma unroll
    for (int kk = 0; kk < kDxStep; kk += 16) {
      // B: rows o of w[e] (contiguous along the contracted N) are the
      // columns of the col-major B operand: ldmatrix without .trans
      uint32_t b[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r[4];
        const int o = wc * 32 + p * 16 + (mat >> 1) * 8 + (lane & 7);
        ldsm_x4(r, Ws + o * kDxPitch + kk + (mat & 1) * 8);
        b[2 * p][0] = r[0], b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2], b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int rg = wr * 4 + mi;
        if (!((mask >> rg) & 1u)) continue;
        uint32_t a[4];
        const int row = rg * 16 + (mat & 1) * 8 + (lane & 7);
        ldsm_x4(a, Ds + row * kDxPitch + kk + (mat >> 1) * 8);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a, b[ni][0], b[ni][1]);
      }
    }
  }
  cp_async_wait<0>();
  // accumulator (mi, ni): rows 64 wr + 16 mi + lane/4 (+8), columns
  // 32 wc + 8 ni + 2 (lane%4) (+1); dead groups write their zeros
  const int gq = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int rg = wr * 4 + mi;
    if (s_grp[rg] == -2) continue;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = o0 + wc * 32 + ni * 8 + 2 * q;
      if (col >= K) continue;          // K % 8 == 0: col + 1 < K too
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(
            dx + (r0 + rg * 16 + gq + 8 * h) * K + col) =
            __floats2bfloat162_rn(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
    }
  }
}

// -- dw: a block is (expert, 128 rows of K, a walk of N tiles, slab) ---------
constexpr int kDwThreads = 256;        // 8 warps: 4 over K by 2 over N
constexpr int kDwTile = 128;           // K rows and N columns of an output tile
constexpr int kDwRows = 32;            // token rows a stage holds
constexpr int kDwPitch = kDwTile + 8;  // padded bf16 row: 272 bytes
constexpr int kDwStages = 3;
constexpr int kListCap = 1024;         // tiles listed at once
constexpr int kDwStageElems = 2 * kDwRows * kDwPitch;       // x, then dout
constexpr int kDwListOff = kDwStages * kDwStageElems * 2;   // bytes
constexpr int kDwSmem = kDwListOff + (kListCap + 8) * 4;
static_assert(kDwListOff >= kMaxSplitGroups * 4, "the counts fit the stages");
static_assert(kDwSmem <= 227 * 1024, "fits a block");

// Extra block u < (slots - 1) * per (per = n_kb * n_walks) takes extra
// slab u / per; block u after them takes slab 0 of expert (u - (slots - 1)
// per) / per; either way u % per = kb * n_walks + wi, the K band and the
// N tiles [wi * walk, wi * walk + walk).  A block lists its slab's tiles
// once and walks (N tile, 32 rows) steps in one cp.async pipeline,
// writing each 128 x 128 output tile (or its f32 partial) as its last
// rows land; where the slab has more tiles than the list holds, it lists
// them chunk by chunk for each N tile.
__global__ void __launch_bounds__(kDwThreads)
grouped_bwd_dw_mma_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ dout,
                          const int32_t* __restrict__ tile_group,
                          const int32_t* __restrict__ n_used,
                          __nv_bfloat16* __restrict__ dw,
                          float* __restrict__ part, int* __restrict__ counters,
                          int M, int K, int N, int G, int bm, int n_kb,
                          int n_nb, int walk, int split_tiles, int max_split,
                          int slots) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  int* list = reinterpret_cast<int*>(smem_raw + kDwListOff);
  int* warp_counts = list + kListCap;
  __shared__ Slab s_slab;
  const int n_walks = (n_nb + walk - 1) / walk, per = n_kb * n_walks;
  const long long n_extra_blocks =
      (long long)(slots > 1 ? slots - 1 : 0) * per;
  long long u = blockIdx.x;
  int extra = -1, g = 0;
  if (u < n_extra_blocks) {
    extra = (int)(u / per);
  } else {
    u -= n_extra_blocks;
    g = (int)(u / per);
  }
  const int kb = (int)(u % per) / n_walks, wi = (int)(u % per) % n_walks;
  const int nb_lo = wi * walk, nb_hi = min(n_nb, nb_lo + walk);
  const int k0 = kb * kDwTile;
  const int T = M / bm, used = used_tiles(n_used, T), rg_per_tile = bm / 16;
  Slab sl;
  int cursor, seen, n_list;
  // every expert's count, before the stages are used
  if (!block_slab<kDwThreads>(tile_group, used, G, split_tiles, max_split,
                              slots, extra, g, reinterpret_cast<int*>(sm),
                              list, kListCap, warp_counts, &s_slab, &sl,
                              &cursor, &seen, &n_list))
    return;
  g = sl.g;
  const int r_lo = (int)((long long)sl.count * sl.s / sl.n);
  const int r_hi = (int)((long long)sl.count * (sl.s + 1) / sl.n);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mat = lane >> 3, wk = warp & 3, wn = warp >> 2;
  const int gq = lane >> 2, q = lane & 3;
  __nv_bfloat16* out = dw + (long long)g * K * N;
  const long long tile_elems = (long long)kDwTile * kDwTile;
  const long long slot_elems = (long long)n_kb * n_nb * tile_elems;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  // accumulator (mi, ni) element e: K row wk*32 + mi*16 + lane/4 + 8 (e/2),
  // N column wn*64 + ni*8 + 2*(lane%4) + e%2 of output tile nb; written,
  // then zeroed for the next tile
  auto emit = [&](int nb) {
    const int n0 = nb * kDwTile;
    if (sl.n == 1) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int col = n0 + wn * 64 + ni * 8 + 2 * q;
          if (col >= N) continue;      // N % 8 == 0: col + 1 < N too
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = k0 + wk * 32 + mi * 16 + gq + 8 * h;
            if (row < K)
              *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * N +
                                                 col) =
                  __floats2bfloat162_rn(acc[mi][ni][2 * h],
                                        acc[mi][ni][2 * h + 1]);
          }
        }
    } else {
      const int otile = kb * n_nb + nb;
      float* rec0 = part + sl.slot * slot_elems + otile * tile_elems;
      float* rec = rec0 + sl.s * slot_elems;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int col = wn * 64 + ni * 8 + 2 * q;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            __stcg(reinterpret_cast<float2*>(
                       rec + (wk * 32 + mi * 16 + gq + 8 * h) * kDwTile +
                       col),
                   make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]));
        }
      merge_if_last<__nv_bfloat16, kDwTile, kDwTile>(
          rec0, slot_elems,
          counters + (long long)sl.slot * n_kb * n_nb + otile, sl.n, out, k0,
          n0, K, N);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  };

  // One listed chunk of the slab's tiles at a time: the whole slab when
  // the list holds it (then every N tile of the walk in one pipeline),
  // else for each N tile in turn, chunk by chunk.  A step is (N tile nb0 +
  // t / nsteps, rows 32 (t % nsteps) ..); a chunk with no row still takes
  // one step of zeros, so every output tile is written from one place.
  int nb0 = nb_lo, nsteps = 1;
  const bool whole = cursor >= used;
  auto load = [&](int t, int slot) {
    __nv_bfloat16* Xs = sm + slot * kDwStageElems;
    __nv_bfloat16* Ds = Xs + kDwRows * kDwPitch;
    const int nb = nb0 + t / nsteps, step = t % nsteps;
    const int n_rg = n_list * rg_per_tile;
    for (int i = tid; i < 2 * kDwRows * 16; i += kDwThreads) {
      const int which = i / (kDwRows * 16), j = i % (kDwRows * 16);
      const int r = j >> 4, ch = j & 15;
      const int rg = 2 * step + (r >> 4);
      bool ok = rg < n_rg;
      long long row = 0;
      if (ok)
        row = (long long)list[rg / rg_per_tile] * bm +
              (rg % rg_per_tile) * 16 + (r & 15);
      if (which == 0) {
        const int c = k0 + ch * 8;
        ok = ok && c < K;
        cp_async16(Xs + r * kDwPitch + ch * 8, ok ? x + row * K + c : x, ok);
      } else {
        const int c = nb * kDwTile + ch * 8;
        ok = ok && c < N;
        cp_async16(Ds + r * kDwPitch + ch * 8, ok ? dout + row * N + c : dout,
                   ok);
      }
    }
  };
  for (;;) {
    nsteps = max(1, (n_list * rg_per_tile + 1) / 2);
    const int total = whole ? (nb_hi - nb_lo) * nsteps : nsteps;
    const bool last_chunk = cursor >= used;
#pragma unroll
    for (int st = 0; st < kDwStages - 1; ++st) {
      if (st < total) load(st, st);
      cp_async_commit();
    }
    for (int t = 0; t < total; ++t) {
      cp_async_wait<kDwStages - 2>();
      __syncthreads();
      if (t + kDwStages - 1 < total)
        load(t + kDwStages - 1, (t + kDwStages - 1) % kDwStages);
      cp_async_commit();
      const __nv_bfloat16* Xs = sm + (t % kDwStages) * kDwStageElems;
      const __nv_bfloat16* Ds = Xs + kDwRows * kDwPitch;
#pragma unroll
      for (int kk = 0; kk < kDwRows; kk += 16) {
        // A = x^T (K rows x token rows): x's stage is rows x K, so .trans
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldsm_x4_t(a[mi], Xs + (kk + (mat >> 1) * 8 + (lane & 7)) * kDwPitch +
                               wk * 32 + mi * 16 + (mat & 1) * 8);
        // B = dout (token rows x N), row-major: .trans gives col fragments
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t r[4];
          ldsm_x4_t(r, Ds + (kk + (mat & 1) * 8 + (lane & 7)) * kDwPitch +
                           wn * 64 + p * 16 + (mat >> 1) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(acc[mi][2 * p], a[mi], r[0], r[1]);
            mma_bf16(acc[mi][2 * p + 1], a[mi], r[2], r[3]);
          }
        }
      }
      if (last_chunk && t % nsteps == nsteps - 1) emit(nb0 + t / nsteps);
    }
    cp_async_wait<0>();
    __syncthreads();           // the stages and the list are reused
    if (whole) return;
    if (cursor >= used) {      // this N tile is done: the next one
      if (++nb0 >= nb_hi) return;
      cursor = 0, seen = 0;
    }
    n_list = collect_tiles<kDwThreads>(tile_group, g, &cursor, &seen, used,
                                       r_lo, r_hi, list, kListCap,
                                       warp_counts);
  }
}

}  // namespace mma

// ---- any dtype, any alignment: CUDA cores -----------------------------------
namespace cores {

constexpr int kThreads = 256;          // a 16 x 16 grid of threads
constexpr int kCols = 64;              // output columns a block owns
constexpr int kStep = 16;              // contracted indices a stage
constexpr int kMaxRows = 128;          // rows a dx block multiplies
constexpr int kListCap = 1024;
static_assert(16 * (kCols + 1) >= kMaxSplitGroups, "the counts fit xs");

// dx rows [row0, row0 + rows) x K columns [o0, o0 + 64): dout's rows
// against w[g]'s rows o, N in steps of 16.
template <typename T, int MF>
__global__ void __launch_bounds__(kThreads)
grouped_bwd_dx_cores_kernel(const T* __restrict__ dout,
                            const T* __restrict__ w,
                            const int32_t* __restrict__ tile_group,
                            const int32_t* __restrict__ n_used,
                            T* __restrict__ dx, int M, int K, int N, int G,
                            int bm, int rows_per_block) {
  __shared__ float ds[MF * 16][kStep + 1];
  __shared__ __align__(16) float ws[kStep][kCols];
  const int T_ = M / bm, chunks = bm / rows_per_block;
  const int tile = blockIdx.x / chunks;
  const long long row0 =
      (long long)tile * bm + (blockIdx.x % chunks) * rows_per_block;
  const int o0 = blockIdx.y * kCols;
  const int g = tile_group[tile];
  if (!live_tile(tile, g, used_tiles(n_used, T_), G)) {
    write_zeros(dx, row0, rows_per_block, o0, kCols, K);
    return;
  }
  const int mf = rows_per_block / 16;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* drow = dout + row0 * N;
  const T* wg = w + (long long)g * K * N;
  float acc[MF][4];
#pragma unroll
  for (int mi = 0; mi < MF; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[mi][j] = 0.f;
  for (int c0 = 0; c0 < N; c0 += kStep) {
    for (int i = tid; i < rows_per_block * kStep; i += kThreads) {
      const int r = i / kStep, cc = i % kStep;
      ds[r][cc] = c0 + cc < N ? to_f32(drow[(long long)r * N + c0 + cc])
                              : 0.f;
    }
    for (int i = tid; i < kStep * kCols; i += kThreads) {
      const int o = i / kStep, cc = i % kStep;
      ws[cc][o] = (c0 + cc < N && o0 + o < K)
                      ? to_f32(wg[(long long)(o0 + o) * N + c0 + cc])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < kStep; ++cc) {
      const float4 wv = *reinterpret_cast<const float4*>(&ws[cc][tx * 4]);
#pragma unroll
      for (int mi = 0; mi < MF; ++mi) {
        if (mi < mf) {
          const float dv = ds[mi * 16 + ty][cc];
          acc[mi][0] += dv * wv.x;
          acc[mi][1] += dv * wv.y;
          acc[mi][2] += dv * wv.z;
          acc[mi][3] += dv * wv.w;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int mi = 0; mi < MF; ++mi) {
    if (mi >= mf) continue;
    T* o = dx + (row0 + mi * 16 + ty) * K;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = o0 + tx * 4 + j;
      if (col < K) o[col] = from_f32<T>(acc[mi][j]);
    }
  }
}

// dw[g] rows [k0, k0 + 64) x columns [n0, n0 + 64), over the tiles of
// the block's slab, 16 token rows a stage.  Extra block u < (slots - 1) *
// per (per = n_kb * n_nb) takes extra slab u / per; block u after them
// takes slab 0 of expert (u - (slots - 1) per) / per; either way u % per
// = kb * n_nb + nb.  Three blocks an SM: unbounded, the slab's set-up
// takes the kernel to 101 registers and two blocks an SM.
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
grouped_bwd_dw_cores_kernel(const T* __restrict__ x,
                            const T* __restrict__ dout,
                            const int32_t* __restrict__ tile_group,
                            const int32_t* __restrict__ n_used,
                            T* __restrict__ dw, float* __restrict__ part,
                            int* __restrict__ counters, int M, int K, int N,
                            int G, int bm, int n_kb, int n_nb,
                            int split_tiles, int max_split, int slots) {
  __shared__ float xs[16][kCols + 1];  // before the slab is found: counts
  __shared__ __align__(16) float ds[16][kCols];
  __shared__ int list[kListCap];
  __shared__ int warp_counts[kThreads / 32];
  __shared__ Slab s_slab;
  const int per = n_kb * n_nb;
  const long long n_extra_blocks =
      (long long)(slots > 1 ? slots - 1 : 0) * per;
  long long u = blockIdx.x;
  int extra = -1, g = 0;
  if (u < n_extra_blocks) {
    extra = (int)(u / per);
  } else {
    u -= n_extra_blocks;
    g = (int)(u / per);
  }
  const int otile = (int)(u % per), kb = otile / n_nb, nb = otile % n_nb;
  const int k0 = kb * kCols, n0 = nb * kCols;
  const int T_ = M / bm, used = used_tiles(n_used, T_);
  const int rg_per_tile = bm / 16;
  Slab sl;
  int cursor, seen, n_list;
  if (!block_slab<kThreads>(tile_group, used, G, split_tiles, max_split,
                            slots, extra, g, reinterpret_cast<int*>(xs),
                            list, kListCap, warp_counts, &s_slab, &sl,
                            &cursor, &seen, &n_list))
    return;
  g = sl.g;
  const int r_hi = (int)((long long)sl.count * (sl.s + 1) / sl.n);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (;;) {
    const int n_rg = n_list * rg_per_tile;
    for (int rg = 0; rg < n_rg; ++rg) {
      const long long row0 =
          (long long)list[rg / rg_per_tile] * bm + (rg % rg_per_tile) * 16;
      for (int i = tid; i < 16 * kCols; i += kThreads) {
        const int r = i / kCols, c = i % kCols;
        xs[r][c] = k0 + c < K ? to_f32(x[(row0 + r) * K + k0 + c]) : 0.f;
        ds[r][c] = n0 + c < N ? to_f32(dout[(row0 + r) * N + n0 + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float4 dv = *reinterpret_cast<const float4*>(&ds[r][tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xv = xs[r][ty + 16 * i];
          acc[i][0] = fmaf(xv, dv.x, acc[i][0]);
          acc[i][1] = fmaf(xv, dv.y, acc[i][1]);
          acc[i][2] = fmaf(xv, dv.z, acc[i][2]);
          acc[i][3] = fmaf(xv, dv.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
    if (cursor >= used) break;
    n_list = collect_tiles<kThreads>(
        tile_group, g, &cursor, &seen, used,
        (int)((long long)sl.count * sl.s / sl.n), r_hi, list, kListCap,
        warp_counts);
  }
  T* out = dw + (long long)g * K * N;
  if (sl.n == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = k0 + ty + 16 * i;
      if (row >= K) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx * 4 + j;
        if (col < N) out[(long long)row * N + col] = from_f32<T>(acc[i][j]);
      }
    }
    return;
  }
  const long long tile_elems = kCols * kCols;
  const long long slot_elems = (long long)per * tile_elems;
  float* rec0 = part + sl.slot * slot_elems + otile * tile_elems;
  float* rec = rec0 + sl.s * slot_elems;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      __stcg(rec + (ty + 16 * i) * kCols + tx * 4 + j, acc[i][j]);
  merge_if_last<T, kCols, kCols>(rec0, slot_elems,
                                 counters + (long long)sl.slot * per + otile,
                                 sl.n, out, k0, n0, K, N);
}

template <typename T, int MF>
int launch_dx(const void* dout, const void* w, const void* tg,
              const void* n_used, void* dx, int M, int K, int N, int G,
              int bm, int rows, cudaStream_t s) {
  const dim3 grid((unsigned)((M / bm) * (bm / rows)),
                  (unsigned)((K + kCols - 1) / kCols));
  grouped_bwd_dx_cores_kernel<T, MF><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(dout), static_cast<const T*>(w),
      static_cast<const int32_t*>(tg), static_cast<const int32_t*>(n_used),
      static_cast<T*>(dx), M, K, N, G, bm, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dx_any(const void* dout, const void* w, const void* tg,
                  const void* n_used, void* dx, int M, int K, int N, int G,
                  int bm, int rows, cudaStream_t s) {
  if (rows <= 16)
    return launch_dx<T, 1>(dout, w, tg, n_used, dx, M, K, N, G, bm, rows, s);
  if (rows <= 32)
    return launch_dx<T, 2>(dout, w, tg, n_used, dx, M, K, N, G, bm, rows, s);
  if (rows <= 64)
    return launch_dx<T, 4>(dout, w, tg, n_used, dx, M, K, N, G, bm, rows, s);
  return launch_dx<T, 8>(dout, w, tg, n_used, dx, M, K, N, G, bm, rows, s);
}

template <typename T>
int launch_dw(const void* x, const void* dout, const void* tg,
              const void* n_used, void* dw, int M, int K, int N, int G,
              int bm, int split_tiles, int max_split, int slots, float* part,
              int* counters, cudaStream_t s) {
  const int n_kb = (K + kCols - 1) / kCols, n_nb = (N + kCols - 1) / kCols;
  const long long blocks =
      ((long long)G + (slots > 1 ? slots - 1 : 0)) * n_kb * n_nb;
  grouped_bwd_dw_cores_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dout),
      static_cast<const int32_t*>(tg), static_cast<const int32_t*>(n_used),
      static_cast<T*>(dw), part, counters, M, K, N, G, bm, n_kb, n_nb,
      split_tiles, max_split, slots);
  return (int)cudaGetLastError();
}

}  // namespace cores

template <typename Kernel>
int allow_smem(Kernel k, int bytes, bool* done) {
  if (*done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  *done = true;
  return 0;
}

int launch_dx_mma(const void* dout, const void* w, const void* tg,
                  const void* n_used, void* dx, int M, int K, int N, int G,
                  int bm, cudaStream_t s) {
  static bool attr_set = false;
  const int e =
      allow_smem(mma::grouped_bwd_dx_mma_kernel, mma::kDxSmem, &attr_set);
  if (e != 0) return e;
  const long long units = (long long)((M + mma::kDxRows - 1) / mma::kDxRows) *
                          ((K + mma::kDxCols - 1) / mma::kDxCols);
  mma::grouped_bwd_dx_mma_kernel
      <<<(unsigned)units, mma::kDxThreads, mma::kDxSmem, s>>>(
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const __nv_bfloat16*>(w), static_cast<const int32_t*>(tg),
      static_cast<const int32_t*>(n_used), static_cast<__nv_bfloat16*>(dx), M,
      K, N, G, bm);
  return (int)cudaGetLastError();
}

int launch_dw_mma(const void* x, const void* dout, const void* tg,
                  const void* n_used, void* dw, int M, int K, int N, int G,
                  int bm, int walk, int split_tiles, int max_split,
                  int slots, float* part, int* counters, cudaStream_t s) {
  static bool attr_set = false;
  const int e =
      allow_smem(mma::grouped_bwd_dw_mma_kernel, mma::kDwSmem, &attr_set);
  if (e != 0) return e;
  const int n_kb = (K + mma::kDwTile - 1) / mma::kDwTile;
  const int n_nb = (N + mma::kDwTile - 1) / mma::kDwTile;
  const long long blocks = ((long long)G + (slots > 1 ? slots - 1 : 0)) *
                           n_kb * ((n_nb + walk - 1) / walk);
  mma::grouped_bwd_dw_mma_kernel
      <<<(unsigned)blocks, mma::kDwThreads, mma::kDwSmem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const int32_t*>(tg), static_cast<const int32_t*>(n_used),
      static_cast<__nv_bfloat16*>(dw), part, counters, M, K, N, G, bm, n_kb,
      n_nb, walk, split_tiles, max_split, slots);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (dout, w and dx alike).  path: 0 = CUDA
// cores (any dtype, alignment and shape), 1 = bf16 mma.sync (K and N
// multiples of 8, dout and w 16-byte aligned).  rows: the rows a unit
// takes (mma: 128, of one or more tiles; cores: a multiple of 16 up to
// 128 dividing bm).  n_used: device int32 scalar or null.  bm: a
// multiple of 16 that divides M.  One launch.  Returns 0 on success, -1
// for an unsupported argument, else the cudaError_t of the launch.
int mars_grouped_matmul_bwd_dx(int dtype, int path, const void* dout,
                               const void* w, const void* tile_group,
                               const void* n_used, void* dx, int M, int K,
                               int N, int G, int bm, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm <= 0 || bm % 16 != 0 || M <= 0 || M % bm != 0 || K <= 0 ||
      N <= 0 || G <= 0 || rows <= 0 || rows % 16 != 0)
    return -1;
  if (path == 0) {
    if (rows > cores::kMaxRows || bm % rows != 0) return -1;
    if (dtype == 0)
      return cores::launch_dx_any<float>(dout, w, tile_group, n_used, dx, M,
                                         K, N, G, bm, rows, s);
    if (dtype == 1)
      return cores::launch_dx_any<__nv_bfloat16>(dout, w, tile_group, n_used,
                                                 dx, M, K, N, G, bm, rows, s);
    return -1;
  }
  if (path != 1 || dtype != 1 || K % 8 != 0 || N % 8 != 0 ||
      !aligned16(dout) || !aligned16(w) || !aligned16(dx))
    return -1;
  if (rows != mma::kDxRows) return -1;
  return launch_dx_mma(dout, w, tile_group, n_used, dx, M, K, N, G, bm, s);
}

// dtype and path as above (x, dout and dw of one dtype; mma needs x and
// dout 16-byte aligned).  dw (G, K, N) is written whole.  walk: the
// 128-column tiles of N an mma block walks (1 on CUDA cores).  The row
// split (see Slab): an expert is cut into min(max_split, its live tiles /
// split_tiles) slabs where that is 2 or more and its request fits the
// `slots` partial slots; slots < 2 cuts no expert.  With slots >= 2 (and
// G at most kMaxSplitGroups), part holds slots * ceil(K / t) * ceil(N /
// t) * t * t floats (t = 128 for mma, 64 for cores) and counters slots *
// ceil(K / t) * ceil(N / t) ints that are 0 before the launch and 0 again
// after it.  One launch.  Returns as above.
int mars_grouped_matmul_bwd_dw(int dtype, int path, const void* x,
                               const void* dout, const void* tile_group,
                               const void* n_used, void* dw, int M, int K,
                               int N, int G, int bm, int walk,
                               int split_tiles, int max_split, int slots,
                               float* part, int* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm <= 0 || bm % 16 != 0 || M <= 0 || M % bm != 0 || K <= 0 ||
      N <= 0 || G <= 0 || walk < 1 ||
      (slots > 1 && (part == nullptr || counters == nullptr ||
                     split_tiles < 1 || max_split < 2 ||
                     G > kMaxSplitGroups)))
    return -1;
  if (path == 0) {
    if (walk != 1) return -1;
    if (dtype == 0)
      return cores::launch_dw<float>(x, dout, tile_group, n_used, dw, M, K, N,
                                     G, bm, split_tiles, max_split, slots,
                                     part, counters, s);
    if (dtype == 1)
      return cores::launch_dw<__nv_bfloat16>(
          x, dout, tile_group, n_used, dw, M, K, N, G, bm, split_tiles,
          max_split, slots, part, counters, s);
    return -1;
  }
  if (path != 1 || dtype != 1 || K % 8 != 0 || N % 8 != 0 ||
      !aligned16(x) || !aligned16(dout) || !aligned16(dw))
    return -1;
  return launch_dw_mma(x, dout, tile_group, n_used, dw, M, K, N, G, bm,
                       walk, split_tiles, max_split, slots, part, counters,
                       s);
}

const char* mars_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
