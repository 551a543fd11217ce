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
// tile_group need not be sorted, and the host never reads the routing.
//
// Bound: bytes.  At arctic-480b's training step (8 x 512 tokens top-2 =
// 8192 rows over 128 experts, w_in 7168 x 4864) dx reads every used
// expert's (K, N) matrix once and dw writes every expert's: 8.93 GB each
// in bf16, 2.73 ms at 3.35 TB/s with the rows, against 0.57 TFLOP each
// (0.58 ms at 989 TFLOP/s), about 64 operations a byte.
//
// What held the first design (mma.sync on cp.async stages) at 2.5x (dx)
// and 3.8x (dw) that bound: dx's weight stream was issued 16 bytes a
// thread by the warps that ran the products, so the load path set its
// pace (it moved 1.5x with the stage width alone), while K4's TMA
// producer reaches 0.83-0.92 of its bound; a dx unit of 128 rows
// straddled about three experts and row units were the fastest grid
// index, so every K band re-read all of dout (80 MB, more than L2).  dw's
// 71,680 short blocks each scanned tile_group for their tiles and started
// a pipeline, loaded x's rows again with every dout stage, and stored
// each tile from the mma fragments 4 bytes at a time while the next
// tile's loads waited (with no live row at all it took as long: its store
// path set its pace); a heavy expert's blocks started last.
//
// Design (bf16, K and N multiples of 8, 16-byte aligned operands: the
// training path).  Three launches.  A one-block prologue lists, from the
// routing on the device, each expert's live tiles in tile order (the tiles
// themselves where the map is sorted) and the experts heaviest first, with
// each one's dx items (a record an item) and dw units (tc::Work).  Then dx
// and dw, each one persistent block an SM taking every gridDim-th item of
// that order; both start while the kernel before them runs and wait for
// it only before reading the work order (programmatic dependent launch).
// In both a producer warp keeps a ring of TMA loads in flight (128-byte
// swizzle; a stage's arrival an mbarrier with its byte count, its release
// an mbarrier the consumer warps arrive at) and two consumer warpgroups
// run wgmma.mma_async from shared memory.
//   * dx as a weight stream, swapped: dx_g^T = w_g dout_g^T.  An item is
//     (expert g, band of 256 rows of K, chunk of up to 128 of g's rows); a
//     stage is 64 columns of N: the band's weight box (wgmma's A, K-major,
//     32 KB) and a 16-row dout box for each row group of the chunk, where
//     its tile lies (B, K-major).  Each weight byte leaves memory once (an
//     expert of more than one chunk streams its band again, from L2: its
//     chunks are adjacent in the order).  A warpgroup owns 128 rows of
//     the band as two m64 tiles; the chunk's rows are n (a wgmma of n 16
//     to 128, one code path for each), so no padding row is multiplied.
//     g's items are adjacent, so its dout rows stay in L2 across its
//     bands.  The epilogue transposes through shared memory and writes
//     16-byte runs of dx rows.  Dead tiles get zeros and read nothing.
//   * dw as a write stream: a unit is (expert g, 128 rows of K, a run of
//     128-column output tiles), heaviest expert first.  Where g has at
//     most 384 rows its x band stays in shared memory for the whole unit
//     and only dout streams, four 16-row groups a stage (two adjacent
//     groups, an expert's tiles in a sorted map, as one 32-row box); a
//     heavier expert streams x beside dout, two groups a stage, its units
//     taking fewer output tiles, K band fastest, so that the units running
//     together share one run of dout columns.  Both operands are MN-major
//     (wgmma's transpose bits), so nothing is copied; dout's 128 columns
//     are one m64n128 operand of two swizzle atoms.  Each tile is
//     converted to bf16 into one of two staging buffers a warpgroup and
//     written by a TMA store (cp.async.bulk.tensor), so its write overlaps
//     the next tile's loads and products.  An expert with no row gets its
//     zero tiles from the same stream.
//
// Other operands (float32, or bf16 whose K or N is not a multiple of 8 or
// whose base is not 16-byte aligned): units of a tile's rows (dx) and 64 x
// 64 output tiles (dw) on CUDA cores, f32 in shared memory, every load
// masked at the edges.  There dw keeps a row split for the shapes whose
// output tiles alone cannot fill the card: an expert with many live tiles
// is cut, from the routing on the device, into slabs of rank ranges run by
// extra blocks at the front of the grid (see Slab); each slab's block
// writes its f32 partial of each output tile and counts itself on the
// tile's arrival counter; the last to arrive sums the partials in slab
// order from zero, writes the tile and sets the counter back to 0 (K4's
// scheme).  The twin `grouped_matmul_bwd_plain` cuts the same slabs.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
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

// Experts the CUDA cores' row split counts (shared memory: the dw
// kernel's x stage before it fills).
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

// ---- bfloat16: TMA rings into wgmma, persistent blocks ----------------------
namespace tc {

constexpr int kConsumerWGs = 2;        // consumer warpgroups
constexpr int kConsumerWarps = 4 * kConsumerWGs;
constexpr int kThreads = 32 * kConsumerWarps + 32;   // + the producer warp
constexpr int kMaxGroups = 4096;       // experts the prologue lists
constexpr int kListThreads = 512;      // the prologue's one block
constexpr int kListChunk = 4096;       // tile_group entries staged at once
constexpr int kBox = 16 * 128;         // a 16-row box of 64 bf16 columns

// dx: an item is (expert, band of kDxBand K rows, chunk of up to kDxChunk
// of its rows); a stage is kDxStep columns of N: the band's weight box,
// then one 16-row dout box a row group of the chunk.  The epilogue stages
// the chunk's dx rows (kDxPitch bytes a row: 16 bytes of padding keep the
// transposing stores free of bank conflicts).
constexpr int kDxBand = 256;
constexpr int kDxChunk = 128;
constexpr int kDxStep = 64;
constexpr int kDxStages = 3;
constexpr int kDxWBytes = kDxBand * 128;
constexpr int kDxStageBytes = kDxWBytes + kDxChunk * 128;
constexpr int kDxPitch = kDxBand * 2 + 16;
constexpr int kDxEOff = kDxStages * kDxStageBytes;
constexpr int kDxBarOff = kDxEOff + kDxChunk * kDxPitch;
constexpr int kDxSmem = kDxBarOff + 16 * kDxStages + 1024;
static_assert(kDxSmem <= 227 * 1024, "dx fits a block");
static_assert(kDxBand == 64 * 2 * kConsumerWGs, "two m64 tiles a warpgroup");

// dw: a unit is (expert, kDwTile rows of K, a run of kDwTile-column output
// tiles).  Up to kDwXRows rows of the expert's x band stay resident (two
// 64-column boxes), and a stage holds four of its 16-row groups of dout
// (two 64-column boxes each); for a heavier expert a stage holds two
// groups of dout and of x, and a unit takes at most kDwUnitRows rows x
// output tiles.  Each warpgroup stages its 64 x 128 share of a tile in one
// of two buffers (two 64 x 64 boxes) for the TMA store.
constexpr int kDwTile = 128;
constexpr int kDwStages = 4;
constexpr int kDwStageBytes = 8 * kBox;
constexpr int kDwXRows = 384;
constexpr int kDwUnitRows = 8192;
constexpr int kDwOutBox = 64 * 128;
constexpr int kDwXOff = kDwStages * kDwStageBytes;
constexpr int kDwOutOff = kDwXOff + 2 * kDwXRows * 128;
constexpr int kDwBarOff = kDwOutOff + kConsumerWGs * 2 * 2 * kDwOutBox;
constexpr int kDwSmem = kDwBarOff + 16 * kDwStages + 16 + 1024;
static_assert(kDwSmem <= 227 * 1024, "dw fits a block");
static_assert(kDwTile == 64 * kConsumerWGs, "an m64 tile a warpgroup");

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
// Shared -> global by TMA, one bulk group; the parts of the box outside
// the tensor are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// At most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// This thread's shared-memory writes, before an async-proxy read of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Programmatic dependent launch: the next kernel of the stream may start
// its blocks (launch_dependents); this one waits here until the kernel
// before it has finished and its writes are visible (grid_wait; at once
// where it was launched without the attribute).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
// The 128 threads of consumer warpgroup wg (named barrier 1 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// wgmma operand descriptor of a 128-byte-swizzled tile at shared address
// `addr` (1024-byte aligned but for a step along the 128-byte row):
// groups of 8 rows lie 1024 bytes apart (the stride offset); an MN-major
// operand wider than one 64-element swizzle atom has its atoms `lead`
// bytes apart (the leading offset, read for no other operand here).
__device__ __forceinline__ uint64_t desc(uint32_t addr,
                                         uint32_t lead = 1024) {
  constexpr uint64_t k8Rows = 1024 >> 4;
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)(lead >> 4) << 16) | (k8Rows << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of registers that a
// wgmma in flight owns across the fence, commit and wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x N, f32) += A (64 x 16) B (16 x N), bf16 in shared memory, for N
// a multiple of 16 up to 128 (d: N / 2 accumulators a thread); TA / TB: 1
// where the operand is MN-major (transposed in the instruction).
template <int N, int TA, int TB>
struct Mma;
template <int TA, int TB>
struct Mma<16, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t da,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};
template <int TA, int TB>
struct Mma<32, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t da,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};
template <int TA, int TB>
struct Mma<48, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[24], uint64_t da,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, %27, %28;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};
template <int TA, int TB>
struct Mma<64, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};
template <int TA, int TB>
struct Mma<80, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[40], uint64_t da,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, %40, %41, p, 1, 1, %43, %44;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};
template <int TA, int TB>
struct Mma<96, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[48], uint64_t da,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};
template <int TA, int TB>
struct Mma<112, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[56], uint64_t da,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, %56, %57, p, 1, 1, %59, %60;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};
template <int TA, int TB>
struct Mma<128, TA, TB> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
};

// ---- the prologue: tile lists and the work order ----------------------------
// work (int32) holds, for T tiles and G experts:
//   list[T]      the live tiles of each expert in tile order, expert g's
//                at [off[g], off[g + 1])
//   off[G + 1]
//   order[G]     the experts, most live tiles first (ties: lower id first)
//   dx_off[G + 1] dx items before order position i (dx_items(g) below)
//   dw_off[G + 1] dw units before order position i (dw_units(g) below)
//   dx_rec[]     from rec_offset: dx item j as int4 (expert, K band | row
//                groups << 24, first row group, the expert's list offset)
// The work order is written by the prologue while dx and dw may already
// run (programmatic dependent launch): it is read after grid_wait, by
// plain loads, which grid_wait's memory clobber keeps after it (not the
// read-only path, whose data must not change while the kernel runs).
__device__ __forceinline__ int ld_work(const int* p) { return *p; }
__device__ __forceinline__ int4 ld_work(const int4* p) { return *p; }

struct Work {
  const int* list;
  const int* off;
  const int* order;
  const int* dx_off;
  const int* dw_off;
  const int4* dx_rec;
};
// Where the dx item records start: past the lists and offsets, 16-byte
// aligned.
__host__ __device__ __forceinline__ long long rec_offset(int T, int G) {
  return ((long long)T + 4 * G + 3 + 3) & ~3LL;
}
__device__ __forceinline__ Work work_of(const int* w, int T, int G) {
  return Work{w, w + T, w + T + G + 1, w + T + 2 * G + 1,
              w + T + 3 * G + 2,
              reinterpret_cast<const int4*>(w + rec_offset(T, G))};
}

// Output tiles of N a dw unit of an expert of `rows` rows takes.
__device__ __forceinline__ int dw_walk(int rows, int n_nb) {
  if (rows <= kDwXRows) return n_nb;
  return max(1, min(n_nb, kDwUnitRows / rows));
}
__device__ __forceinline__ int dx_items(int rows, int n_band) {
  return rows == 0 ? 0 : n_band * ((rows + kDxChunk - 1) / kDxChunk);
}
__device__ __forceinline__ int dw_units(int rows, int n_kb, int n_nb) {
  const int walk = dw_walk(rows, n_nb);
  return n_kb * ((n_nb + walk - 1) / walk);
}

// out[0 .. n) (and out2, when given) = the exclusive prefix sums of v[0 ..
// n) (shared), out[n] the total.  One warp calls it.
__device__ void warp_scan(const int* v, int* out, int* out2, int n) {
  const int lane = threadIdx.x & 31;
  const int per = (n + 31) / 32;
  const int lo = min(n, lane * per), hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += v[i];
  int inc = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  int base = inc - s;
  for (int i = lo; i < hi; ++i) {
    out[i] = base;
    if (out2) out2[i] = base;
    base += v[i];
  }
  if (lane == 31) out[n] = base;
}

// Warp 0 lists the live tiles among tgs[0 .. n) (tile_group[t0 ..]) 32 at
// a time: the lanes of one expert take consecutive places after its
// cursor, in tile order.
__device__ void list_chunk(const int* tgs, int n, int t0, int G, int* cursor,
                           int* list) {
  const int lane = threadIdx.x & 31;
  for (int i0 = 0; i0 < n; i0 += 32) {
    int g = i0 + lane < n ? tgs[i0 + lane] : -1;
    if (g >= G) g = -1;
    const unsigned peers = __match_any_sync(0xffffffffu, g);
    const int leader = __ffs(peers) - 1;
    int base = lane == leader && g >= 0 ? cursor[g] : 0;
    base = __shfl_sync(0xffffffffu, base, leader);
    if (g >= 0) {
      list[base + __popc(peers & ((1u << lane) - 1u))] = t0 + i0 + lane;
      if (lane == leader) cursor[g] = base + __popc(peers);
    }
    __syncwarp();
  }
}

// One block of kListThreads.  Shared: cnt, cursor, ord, px, pw (G each),
// the staged tile_group chunk.  Warp 0 scans and lists while the others
// rank the experts.
__global__ void __launch_bounds__(kListThreads)
grouped_bwd_lists_kernel(const int32_t* __restrict__ tile_group,
                 const int32_t* __restrict__ n_used, int* __restrict__ work,
                 int T, int G, int bm, int n_band, int n_kb, int n_nb) {
  extern __shared__ int sh[];
  int* cnt = sh;
  int* cursor = cnt + G;
  int* ord = cursor + G;
  int* px = ord + G;
  int* pw = px + G;
  int* tgs = pw + G;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int used = used_tiles(n_used, T);
  const bool one_chunk = used <= kListChunk;
  int* list = work;
  int* off = work + T;
  int* order = off + G + 1;
  launch_dependents();                 // dx (or dw) may set up meanwhile
  for (int g = tid; g < G; g += blockDim.x) cnt[g] = 0;
  __syncthreads();
  bool in_order = true;                // live and sorted: the lists are
  for (int t = tid; t < used; t += blockDim.x) {      // the tiles in order
    const int g = tile_group[t];
    if (one_chunk) tgs[t] = g;
    if (g >= 0 && g < G) atomicAdd(cnt + g, 1);
    in_order = in_order && g >= 0 && g < G &&
               (t + 1 == used || g <= tile_group[t + 1]);
  }
  const bool sorted = __syncthreads_and(in_order);
  if (sorted)
    for (int t = tid; t < used; t += blockDim.x) list[t] = t;
  if (warp == 0) {
    warp_scan(cnt, off, cursor, G);
    __syncwarp();
    if (one_chunk && !sorted) list_chunk(tgs, used, 0, G, cursor, list);
  } else {                             // heaviest first: an expert's place
    for (int g = tid - 32; g < G; g += blockDim.x - 32) {  // is the number
      const int c = cnt[g];                                // of those before
      int rank = 0;
      for (int h = 0; h < G; ++h) {
        const int d = cnt[h];
        rank += d > c || (d == c && h < g);
      }
      ord[rank] = g;
    }
  }
  for (int t0 = one_chunk || sorted ? used : 0; t0 < used;
       t0 += kListChunk) {
    const int n = min(kListChunk, used - t0);
    __syncthreads();
    for (int i = tid; i < n; i += blockDim.x) tgs[i] = tile_group[t0 + i];
    __syncthreads();
    if (warp == 0) list_chunk(tgs, n, t0, G, cursor, list);
  }
  __syncthreads();
  for (int i = tid; i < G; i += blockDim.x) {
    const int rows = cnt[ord[i]] * bm;
    order[i] = ord[i];
    px[i] = dx_items(rows, n_band);
    pw[i] = dw_units(rows, n_kb, n_nb);
  }
  __syncthreads();
  if (warp == 0) warp_scan(px, off + 2 * G + 1, tgs, G);       // dx_off
  if (warp == 1) warp_scan(pw, off + 3 * G + 2, nullptr, G);   // dw_off
  __syncthreads();
  // one record an item, each thread finding its item's order position
  int4* rec = reinterpret_cast<int4*>(work + rec_offset(T, G));
  const int items = tgs[G - 1] + px[G - 1];
  for (int j = tid; j < items; j += blockDim.x) {
    int lo = 0, hi = G;                // tgs[lo] <= j < tgs[hi] (or items)
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (tgs[mid] <= j) lo = mid;
      else hi = mid;
    }
    const int g = ord[lo], rows = cnt[g] * bm, local = j - tgs[lo];
    const int chunks = (rows + kDxChunk - 1) / kDxChunk;
    const int q0 = (local % chunks) * (kDxChunk / 16);
    const int groups = min(kDxChunk / 16, rows / 16 - q0);
    rec[j] = make_int4(g, local / chunks | groups << 24, q0, off[g]);
  }
}

// The order position i with pre[i] <= u < pre[i + 1] (pre[G] > u).
__device__ __forceinline__ int position(const int* pre, int G, int u) {
  int lo = 0, hi = G;                  // pre[lo] <= u < pre[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (ld_work(pre + mid) <= u) lo = mid;
    else hi = mid;
  }
  return lo;
}

// Global row of row group q (16 rows) of an expert whose live tiles are
// list[lo ..).
__device__ __forceinline__ long long item_row(const Work& wk, int lo, int q,
                                              int bm) {
  const int gpt = bm >> 4;
  return (long long)ld_work(wk.list + lo + q / gpt) * bm + (q % gpt) * 16;
}

// ---- dx ---------------------------------------------------------------------
struct DxItem {
  int g, kb, q0, groups, lo;           // expert, K band, first row group and
};                                     // count, the expert's list offset
__device__ __forceinline__ DxItem dx_item(const Work& wk, int item) {
  const int4 r = ld_work(wk.dx_rec + item);
  return DxItem{r.x, r.y & 0xffffff, r.z, r.y >> 24, r.w};
}

// One item of NG row groups (n = 16 NG) for consumer warpgroup wg: N in
// kDxStep-column stages from the ring (stage counter *it), two m64 tiles
// of the band (K rows 128 wg + 64 mt ..) against the chunk's rows, one
// wgmma a tile and k16 step; then the transposing epilogue.  Accumulator
// mt element 4 j + e: band row 128 wg + 64 mt + 16 w + lane/4 + 8 (e/2),
// chunk row 8 j + 2 (lane%4) + e%2.
template <int NG>
__device__ __forceinline__ void dx_run(const DxItem& d, const Work& wk,
                                       uint32_t base, unsigned char* gbase,
                                       uint32_t full0, uint32_t empty0,
                                       int nsteps, int* it,
                                       __nv_bfloat16* __restrict__ dx, int K,
                                       int bm) {
  constexpr int kN = 16 * NG;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, w4 = warp & 3, wtid = threadIdx.x & 127;
  float acc[2][kN / 2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) acc[mt][e] = 0.f;
  int prev = -1;
  for (int st = 0; st < nsteps; ++st, ++*it) {
    const int s = *it % kDxStages;
    mbar_wait(full0 + 8 * s, (*it / kDxStages) & 1);
    const uint32_t sw = base + s * kDxStageBytes, sd = sw + kDxWBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDxStep / 16; ++kk)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        Mma<kN, 0, 0>::run(acc[mt],
                           desc(sw + (128 * wg + 64 * mt) * 128 + 32 * kk),
                           desc(sd + 32 * kk));
    wgmma_commit();
    if (prev >= 0) {                   // the previous stage's products done
      wgmma_wait<1>();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);
    }
    prev = s;
  }
  wgmma_wait<0>();
  reg_fence(acc[0]);
  reg_fence(acc[1]);
  __syncwarp();
  if (prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);

  // transpose through shared memory: E[chunk row][band column], this
  // warpgroup's 128 columns, then whole 16-byte runs of dx rows
  unsigned char* E = gbase + kDxEOff;
  wg_sync(wg);                         // the last item's runs were read
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * j + 2 * (lane & 3) + (e & 1);
        const int k = 128 * wg + 64 * mt + 16 * w4 + (lane >> 2) +
                      8 * (e >> 1);
        *reinterpret_cast<__nv_bfloat16*>(E + r * kDxPitch + 2 * k) =
            __float2bfloat16(acc[mt][4 * j + e]);
      }
  wg_sync(wg);
  const int col0 = d.kb * kDxBand + 128 * wg;
  for (int idx = wtid; idx < kN * 16; idx += 128) {
    const int r = idx >> 4, c = (idx & 15) * 8;
    if (col0 + c >= K) continue;       // K % 8 == 0: whole runs
    const long long grow =
        item_row(wk, d.lo, d.q0 + (r >> 4), bm) + (r & 15);
    *reinterpret_cast<uint4*>(dx + grow * K + col0 + c) =
        *reinterpret_cast<const uint4*>(E + r * kDxPitch +
                                        2 * (128 * wg + c));
  }
}

// Item u of the block walks N in kDxStep-column stages; warpgroup wg owns
// K rows [kb * 256 + 128 wg, + 128) as two m64 tiles, the chunk's rows are
// wgmma's n.  The consumers first write the dead tiles' zeros, while the
// producer's first loads are in flight.
__global__ void __launch_bounds__(kThreads, 1)
grouped_bwd_dx_tc_kernel(const __grid_constant__ CUtensorMap wmap,
              const __grid_constant__ CUtensorMap dmap,
              const int32_t* __restrict__ tile_group,
              const int32_t* __restrict__ n_used,
              const int* work, __nv_bfloat16* __restrict__ dx,
              int M, int K, int N, int G, int bm) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t full0 = base + kDxBarOff, empty0 = full0 + 8 * kDxStages;
  const int T = M / bm;
  const Work wk = work_of(work, T, G);
  const int nsteps = (N + kDxStep - 1) / kDxStep;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  launch_dependents();                 // dw may set up as blocks retire
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDxStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {        // the producer warp: TMA loads only
    grid_wait();                       // the prologue's work order
    const int n_items = ld_work(wk.dx_off + G);
    int it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const DxItem d = dx_item(wk, item);
      // lane q holds row group q's first row
      const int row = lane < d.groups
                          ? (int)item_row(wk, d.lo, d.q0 + lane, bm) : 0;
      for (int st = 0; st < nsteps; ++st, ++it) {
        const int s = it % kDxStages, round = it / kDxStages;
        if (round > 0) mbar_wait(empty0 + 8 * s, (round - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t sw = base + s * kDxStageBytes, sd = sw + kDxWBytes;
        if (lane == 0) {
          mbar_expect_tx(full, kDxWBytes + d.groups * kBox);
          tma_load_3d(sw, &wmap, full, st * kDxStep, d.kb * kDxBand, d.g);
        }
        for (int q = 0; q < d.groups; ++q) {
          const int r = __shfl_sync(0xffffffffu, row, q);
          if (lane == 0)
            tma_load_2d(sd + q * kBox, &dmap, full, st * kDxStep, r);
        }
      }
    }
    return;
  }

  // dead tiles (past n_used, or a group outside [0, G)): zeros, 16 bytes
  // a thread across the grid; thread i takes runs i, i + stride, .. as
  // (tile t, run r of the tile's bm K / 8)
  {
    const int used = used_tiles(n_used, T);
    const long long runs = (long long)bm * (K / 8);
    const long long stride = (long long)gridDim.x * 32 * kConsumerWarps;
    const long long i0 =
        (long long)blockIdx.x * 32 * kConsumerWarps + threadIdx.x;
    const int dt = (int)(stride / runs);
    const long long dr = stride - dt * runs;
    int t = (int)(i0 / runs);
    long long r = i0 - t * runs;
    uint4* out = reinterpret_cast<uint4*>(dx);
    while (t < T) {
      if (!live_tile(t, __ldg(tile_group + t), used, G))
        out[t * runs + r] = make_uint4(0u, 0u, 0u, 0u);
      t += dt;
      r += dr;
      if (r >= runs) r -= runs, ++t;
    }
  }
  grid_wait();
  const int n_items = ld_work(wk.dx_off + G);
  int it = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const DxItem d = dx_item(wk, item);
    switch (d.groups) {
#define DX_CASE(NG)                                                        \
  case NG:                                                                 \
    dx_run<NG>(d, wk, base, gbase, full0, empty0, nsteps, &it, dx, K, bm); \
    break;
      DX_CASE(1) DX_CASE(2) DX_CASE(3) DX_CASE(4)
      DX_CASE(5) DX_CASE(6) DX_CASE(7) DX_CASE(8)
#undef DX_CASE
      default:
        __trap();                      // a chunk holds 1 .. 8 row groups
    }
  }
}

// ---- dw ---------------------------------------------------------------------
struct DwUnit {
  int g, kb, nb0, nb1, groups, lo;     // lo: the expert's list offset
  bool resident;                       // x's band kept in shared memory
};
// Unit u of the work order: expert order[i] with dw_off[i] <= u <
// dw_off[i + 1], its K band and its run of output tiles.
__device__ __forceinline__ DwUnit dw_unit(const Work& wk, int G, int u,
                                          int bm, int n_kb, int n_nb) {
  const int i = position(wk.dw_off, G, u);
  const int g = ld_work(wk.order + i), lo = ld_work(wk.off + g);
  const int rows = (ld_work(wk.off + g + 1) - lo) * bm;
  const int walk = dw_walk(rows, n_nb);
  const int local = u - ld_work(wk.dw_off + i);
  const bool resident = rows <= kDwXRows;
  // a resident expert's units are its K bands, each all of N; a streamed
  // one's go K band fastest, so the units running together read one run
  // of dout columns (from L2) against the x bands
  const int kb = resident ? local : local % n_kb;
  const int nb0 = resident ? 0 : local / n_kb * walk;
  return DwUnit{g, kb, nb0, min(n_nb, nb0 + walk), rows / 16, lo,
                rows > 0 && resident};
}
// The products of a stage of NG row groups: x^T (A at `a`, a group each
// kBox) against dout's 128 columns (B at st: two 64-column boxes `per`
// groups apart, one m64n128 wgmma a group).
template <int NG>
__device__ __forceinline__ void dw_stage(float (&acc)[64], uint32_t a,
                                         uint32_t st, int per) {
#pragma unroll
  for (int h = 0; h < NG; ++h)
    Mma<128, 1, 1>::run(acc, desc(a + h * kBox),
                        desc(st + h * kBox, per * kBox));
}

// Unit u of the block: for each output tile (K rows kb * 128 .., N
// columns nb * 128 ..) of its run, the expert's row groups in stages of up
// to four (a resident x band) or two (x streamed beside dout), each group a
// k16 step of one m64n128 wgmma a warpgroup (x^T: A, MN-major, the
// warpgroup's 64 K columns; dout: B, MN-major, two 64-column atoms); the
// tile then goes out through the warpgroup's staging buffers by TMA
// stores.  Two groups whose rows are adjacent (an expert's tiles in a
// sorted routing) arrive as one 32-row box.
__global__ void __launch_bounds__(kThreads, 1)
grouped_bwd_dw_tc_kernel(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap xmap2,
              const __grid_constant__ CUtensorMap dmap,
              const __grid_constant__ CUtensorMap dmap2,
              const __grid_constant__ CUtensorMap omap,
              const int* work, int M, int K, int N, int G,
              int bm) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t xs = base + kDwXOff, outs = base + kDwOutOff;
  const uint32_t full0 = base + kDwBarOff, empty0 = full0 + 8 * kDwStages;
  const uint32_t xfull = empty0 + 8 * kDwStages, xfree = xfull + 8;
  const int T = M / bm;
  const Work wk = work_of(work, T, G);
  const int n_kb = (K + kDwTile - 1) / kDwTile;
  const int n_nb = (N + kDwTile - 1) / kDwTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    mbar_init(xfull, 1);
    mbar_init(xfree, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  grid_wait();                         // the prologue's work order (and dx)
  const int n_units = ld_work(wk.dw_off + G);

  if (warp == kConsumerWarps) {        // the producer warp: TMA loads only
    // groups q, q + 1 (lanes i, i + 1 of `row`) into dst[0 ..) and dst[1
    // box ..]: one 32-row box where adjacent, else two 16-row boxes
    auto pair = [&](const CUtensorMap* m1, const CUtensorMap* m2,
                    uint32_t dst, uint32_t bar, int col, int row, int i,
                    int n) {
      const int r0 = __shfl_sync(0xffffffffu, row, i);
      const int r1 = __shfl_sync(0xffffffffu, row, i + 1);
      if (lane != 0) return;
      if (n == 2 && r1 == r0 + 16) {
        tma_load_2d(dst, m2, bar, col, r0);
      } else {
        tma_load_2d(dst, m1, bar, col, r0);
        if (n == 2) tma_load_2d(dst + kBox, m1, bar, col, r1);
      }
    };
    int it = 0, xu = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const DwUnit d = dw_unit(wk, G, u, bm, n_kb, n_nb);
      const int k0 = d.kb * kDwTile;
      const int per = d.resident ? 4 : 2;      // groups a stage
      if (d.resident) {                // lane q holds row group q's row
        const int row = lane < d.groups
                            ? (int)item_row(wk, d.lo, lane, bm) : 0;
        if (xu > 0) mbar_wait(xfree, (xu - 1) & 1);
        if (lane == 0) mbar_expect_tx(xfull, d.groups * 2 * kBox);
        for (int q = 0; q < d.groups; q += 2)
          for (int b = 0; b < 2; ++b)
            pair(&xmap, &xmap2, xs + b * kDwXRows * 128 + q * kBox, xfull,
                 k0 + 64 * b, row, q, min(2, d.groups - q));
        ++xu;
      }
      for (int nb = d.nb0; nb < d.nb1; ++nb) {
        for (int q0 = 0; q0 < d.groups; q0 += 32) {
          const int row = q0 + lane < d.groups
                              ? (int)item_row(wk, d.lo, q0 + lane, bm) : 0;
          for (int q = q0; q < min(d.groups, q0 + 32); q += per, ++it) {
            const int ng = min(per, d.groups - q);
            const int s = it % kDwStages, round = it / kDwStages;
            if (round > 0) mbar_wait(empty0 + 8 * s, (round - 1) & 1);
            const uint32_t full = full0 + 8 * s;
            const uint32_t st = base + s * kDwStageBytes;
            if (lane == 0)
              mbar_expect_tx(full, ng * (d.resident ? 2 : 4) * kBox);
            for (int h = 0; h < ng; h += 2)
              for (int c = 0; c < 2; ++c) {
                pair(&dmap, &dmap2, st + (c * per + h) * kBox, full,
                     nb * kDwTile + 64 * c, row, q - q0 + h,
                     min(2, ng - h));
                if (!d.resident)
                  pair(&xmap, &xmap2, st + (4 + 2 * c + h) * kBox, full,
                       k0 + 64 * c, row, q - q0 + h, min(2, ng - h));
              }
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns K rows k0 + 64 wg ..; accumulator
  // element 32 c + 4 j + e: row 16 w + lane/4 + 8 (e/2), column nb * 128 +
  // 64 c + 8 j + 2 (lane%4) + e%2
  const int wg = warp >> 2, w4 = warp & 3, wtid = threadIdx.x & 127;
  float acc[64];
  int it = 0, xu = 0, tiles = 0;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const DwUnit d = dw_unit(wk, G, u, bm, n_kb, n_nb);
    const int k0 = d.kb * kDwTile;
    const int per = d.resident ? 4 : 2;
    if (d.resident) mbar_wait(xfull, xu & 1);
    for (int nb = d.nb0; nb < d.nb1; ++nb, ++tiles) {
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.f;
      int prev = -1;
      for (int q = 0; q < d.groups; q += per, ++it) {
        const int ng = min(per, d.groups - q);
        const int s = it % kDwStages;
        mbar_wait(full0 + 8 * s, (it / kDwStages) & 1);
        const uint32_t st = base + s * kDwStageBytes;
        const uint32_t a = d.resident
                               ? xs + wg * kDwXRows * 128 + q * kBox
                               : st + (4 + 2 * wg) * kBox;
        wgmma_fence();
        switch (ng) {                  // straight-line wgmma for each count
          case 1: dw_stage<1>(acc, a, st, per); break;
          case 2: dw_stage<2>(acc, a, st, per); break;
          case 3: dw_stage<3>(acc, a, st, per); break;
          default: dw_stage<4>(acc, a, st, per); break;
        }
        wgmma_commit();
        if (prev >= 0) {               // the previous stage's products done
          wgmma_wait<1>();
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * prev);
        }
        prev = s;
      }
      wgmma_wait<0>();
      reg_fence(acc);
      __syncwarp();
      if (prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);

      // bf16 into staging buffer tiles % 2 (two 64 x 64 boxes, the TMA
      // store's 128-byte swizzle), once its store two tiles back has read it
      const int buf = tiles & 1;
      const uint32_t stg = outs + (wg * 2 + buf) * 2 * kDwOutBox;
      unsigned char* gstg = gbase + (stg - base);
      if (wtid == 0) bulk_wait_read<1>();
      wg_sync(wg);
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * w4 + (lane >> 2) + 8 * h;
            *reinterpret_cast<__nv_bfloat162*>(
                gstg + c * kDwOutBox + r * 128 + ((j ^ (r & 7)) << 4) +
                4 * (lane & 3)) =
                __floats2bfloat162_rn(acc[32 * c + 4 * j + 2 * h],
                                      acc[32 * c + 4 * j + 2 * h + 1]);
          }
      fence_proxy_async();
      wg_sync(wg);
      if (wtid == 0) {
        const int krow = k0 + 64 * wg;
        for (int c = 0; c < 2; ++c) {
          const int col = nb * kDwTile + 64 * c;
          if (krow < K && col < N)
            tma_store_3d(&omap, stg + c * kDwOutBox, col, krow, d.g);
        }
        bulk_commit();
      }
    }
    if (d.resident) {                  // the band's last products are done
      __syncwarp();
      if (lane == 0) mbar_arrive(xfree);
      ++xu;
    }
  }
  if (wtid == 0) bulk_wait_all();
}

}  // namespace tc

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
// dims 1..), boxes of `box` in the 128-byte swizzle; what lies outside
// the tensor reads as zero and is not written.
bool tensor_map(CUtensorMap* map, const void* ptr, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kNoTensorMap = -2;

// w (G, K, N) in boxes of 64 columns by `rows` rows of one expert.
bool expert_map(CUtensorMap* map, const void* w, int K, int N, int G,
                int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)G};
  const cuuint64_t strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  return tensor_map(map, w, 3, dims, strides, box);
}
// a (M, C) in boxes of `rows` rows by 64 columns.
bool rows_map(CUtensorMap* map, const void* a, int M, int C, int rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)rows};
  return tensor_map(map, a, 2, dims, strides, box);
}

// A launch of `blocks` tensor-core blocks on `s` that may begin while the
// kernel before it finishes (it waits in grid_wait before reading what
// that kernel wrote).
cudaLaunchConfig_t dependent_launch(int blocks, int smem, cudaStream_t s) {
  static cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)tc::kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

int launch_lists(const void* tg, const void* n_used, void* work, int M,
                 int K, int N, int G, int bm, cudaStream_t s) {
  static bool attr_set = false;
  const int most = (5 * tc::kMaxGroups + tc::kListChunk) * 4;
  const int e = allow_smem(tc::grouped_bwd_lists_kernel, most, &attr_set);
  if (e != 0) return e;
  const int bytes = (5 * G + tc::kListChunk) * 4;
  tc::grouped_bwd_lists_kernel<<<1, tc::kListThreads, bytes, s>>>(
      static_cast<const int32_t*>(tg), static_cast<const int32_t*>(n_used),
      static_cast<int*>(work), M / bm, G, bm,
      (K + tc::kDxBand - 1) / tc::kDxBand, (K + tc::kDwTile - 1) / tc::kDwTile,
      (N + tc::kDwTile - 1) / tc::kDwTile);
  return (int)cudaGetLastError();
}

int launch_dx_tc(const void* dout, const void* w, const void* tg,
                 const void* n_used, const void* work, void* dx, int M,
                 int K, int N, int G, int bm, int blocks, cudaStream_t s) {
  static bool attr_set = false;
  const int e =
      allow_smem(tc::grouped_bwd_dx_tc_kernel, tc::kDxSmem, &attr_set);
  if (e != 0) return e;
  CUtensorMap wm, dm;
  if (!expert_map(&wm, w, K, N, G, tc::kDxBand) ||
      !rows_map(&dm, dout, M, N, 16))
    return kNoTensorMap;
  const cudaLaunchConfig_t cfg = dependent_launch(blocks, tc::kDxSmem, s);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, tc::grouped_bwd_dx_tc_kernel, wm, dm,
      static_cast<const int32_t*>(tg), static_cast<const int32_t*>(n_used),
      static_cast<const int*>(work),
      static_cast<__nv_bfloat16*>(dx), M, K, N, G, bm);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

int launch_dw_tc(const void* x, const void* dout, const void* work, void* dw,
                 int M, int K, int N, int G, int bm, int blocks,
                 cudaStream_t s) {
  static bool attr_set = false;
  const int e =
      allow_smem(tc::grouped_bwd_dw_tc_kernel, tc::kDwSmem, &attr_set);
  if (e != 0) return e;
  CUtensorMap xm, xm2, dm, dm2, om;
  if (!rows_map(&xm, x, M, K, 16) || !rows_map(&xm2, x, M, K, 32) ||
      !rows_map(&dm, dout, M, N, 16) || !rows_map(&dm2, dout, M, N, 32) ||
      !expert_map(&om, dw, K, N, G, 64))
    return kNoTensorMap;
  const cudaLaunchConfig_t cfg = dependent_launch(blocks, tc::kDwSmem, s);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, tc::grouped_bwd_dw_tc_kernel, xm, xm2, dm, dm2, om,
      static_cast<const int*>(work), M, K, N, G, bm);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Shapes the tensor-core path takes: bf16, K and N multiples of 8, at most
// kMaxGroups experts, the tile lists in `work`.
bool tc_shapes(int dtype, int K, int N, int G, const void* work,
               int blocks) {
  return dtype == 1 && K % 8 == 0 && N % 8 == 0 && G <= tc::kMaxGroups &&
         work != nullptr && blocks >= 1;
}

}  // namespace

extern "C" {

// The tensor-core kernels' tile lists and work order (see tc::Work) into
// `work`, T + 4 G + 3 int32 (T = M / bm), from tile_group and n_used on
// the device; G at most 4096.  One launch.  Returns as below.
int mars_grouped_matmul_bwd_lists(const void* tile_group, const void* n_used,
                                  void* work, int M, int K, int N, int G,
                                  int bm, void* stream) {
  if (bm <= 0 || bm % 16 != 0 || M <= 0 || M % bm != 0 || K <= 0 ||
      N <= 0 || G <= 0 || G > tc::kMaxGroups || work == nullptr)
    return -1;
  return launch_lists(tile_group, n_used, work, M, K, N, G, bm,
                      static_cast<cudaStream_t>(stream));
}

// dtype: 0 = float32, 1 = bfloat16 (dout, w and dx alike).  path: 0 = CUDA
// cores (any dtype, alignment and shape; units of `rows` rows, a multiple
// of 16 up to 128 dividing bm); 1 = the bf16 tensor-core kernel (K and N
// multiples of 8, dout, w and dx 16-byte aligned, `work` filled by
// mars_grouped_matmul_bwd_lists on the same stream, `blocks` persistent
// blocks).  n_used: device int32 scalar or null.  bm: a multiple of 16
// that divides M.  One launch.  Returns 0 on success, -1 for an
// unsupported argument, -2 when no tensor map can be encoded, else the
// cudaError_t of the launch.
int mars_grouped_matmul_bwd_dx(int dtype, int path, const void* dout,
                               const void* w, const void* tile_group,
                               const void* n_used, const void* work, void* dx,
                               int M, int K, int N, int G, int bm, int rows,
                               int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm <= 0 || bm % 16 != 0 || M <= 0 || M % bm != 0 || K <= 0 ||
      N <= 0 || G <= 0)
    return -1;
  if (path == 0) {
    if (rows <= 0 || rows % 16 != 0 || rows > cores::kMaxRows ||
        bm % rows != 0)
      return -1;
    if (dtype == 0)
      return cores::launch_dx_any<float>(dout, w, tile_group, n_used, dx, M,
                                         K, N, G, bm, rows, s);
    if (dtype == 1)
      return cores::launch_dx_any<__nv_bfloat16>(dout, w, tile_group, n_used,
                                                 dx, M, K, N, G, bm, rows, s);
    return -1;
  }
  if (path != 1 || !tc_shapes(dtype, K, N, G, work, blocks) ||
      !aligned16(dout) || !aligned16(w) || !aligned16(dx))
    return -1;
  return launch_dx_tc(dout, w, tile_group, n_used, work, dx, M, K, N, G, bm,
                      blocks, s);
}

// dtype and path as above (x, dout and dw of one dtype; the tensor-core
// kernel needs x, dout and dw 16-byte aligned and ignores the split).
// dw (G, K, N) is written whole.  The CUDA cores' row split (see Slab): an
// expert is cut into min(max_split, its live tiles / split_tiles) slabs
// where that is 2 or more and its request fits the `slots` partial slots;
// slots < 2 cuts no expert.  With slots >= 2 (and G at most
// kMaxSplitGroups), part holds slots * ceil(K / 64) * ceil(N / 64) * 64 *
// 64 floats and counters slots * ceil(K / 64) * ceil(N / 64) ints that are
// 0 before the launch and 0 again after it.  One launch.  Returns as
// above.
int mars_grouped_matmul_bwd_dw(int dtype, int path, const void* x,
                               const void* dout, const void* tile_group,
                               const void* n_used, const void* work, void* dw,
                               int M, int K, int N, int G, int bm, int blocks,
                               int split_tiles, int max_split, int slots,
                               float* part, int* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm <= 0 || bm % 16 != 0 || M <= 0 || M % bm != 0 || K <= 0 ||
      N <= 0 || G <= 0)
    return -1;
  if (path == 0) {
    if (slots > 1 && (part == nullptr || counters == nullptr ||
                      split_tiles < 1 || max_split < 2 ||
                      G > kMaxSplitGroups))
      return -1;
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
  if (path != 1 || !tc_shapes(dtype, K, N, G, work, blocks) ||
      !aligned16(x) || !aligned16(dout) || !aligned16(dw))
    return -1;
  return launch_dw_tc(x, dout, work, dw, M, K, N, G, bm, blocks, s);
}

const char* mars_cuda_error_string(int err) {
  if (err == kNoTensorMap)
    return "cuTensorMapEncodeTiled is unavailable or refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
