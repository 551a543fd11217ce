// Blockwise (flash) attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention/flash_attention.py.  Per (batch b,
// head h):
//   o = softmax(q k^T / sqrt(D), masked) v
// with q (B, Sq, H, D), k and v (B, Sk, H, D) contiguous, one dtype
// (float32 or bfloat16), and o (B, Sq, H, D) in that dtype.  Scores and
// the running (m, l, acc) are f32; a masked score is -1e30; in bfloat16
// the probabilities are rounded to bf16 before the P V product, as the
// TPU kernel casts p to v's dtype; the result is acc / max(l, 1e-30).
// `causal` masks key > query and needs Sq == Sk (the TPU kernel masks
// kpos <= qpos with no offset while its oracle offsets queries by
// Sk - Sq; no caller needs that case, so it is refused).  Unlike the TPU
// kernel, any Sq and Sk are taken (the ragged tail is masked here), Sq
// may differ from Sk when not causal (cross-attention), and the head dim
// is 16, 64, 112, 128 or 256.
//
// Bound: operations at the path's long shapes.  Whisper-base's encoder
// self-attention (B 8, S 1500, 8 heads of 64) does 4 B H S^2 D = 36.9
// GFLOP, 37 us at 989 TFLOP/s on an H100 SXM, while its q, k, v and o are
// 24.6 MB, 7 us at 3.35 TB/s.  Few queries over many keys (whisper's
// cross-attention at decode: 1 query over 1500 frames) are bound by the
// bytes of K and V and by latency.
//
// Design.  On the TPU the grid is (B*H, query tile, KV tile) with the KV
// axis innermost and sequential, (m, l, acc) carried in VMEM scratch,
// and a fully masked KV tile costs a branch.  Here a block walks KV tiles
// itself; in causal mode the walk stops at the tile that holds the
// block's last query row, so masked tiles are never loaded, and the
// query tiles run last-first so the longest walks start first.  The host
// picks one of three kernels from the shapes (`split_plan` in the
// wrapper), one launch a call:
//   * bfloat16, more than 64 queries, D 64, 112 or 128: `wgmma` tiles.
//     A block owns 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows each run S = Q K^T and O += P V as
//     wgmma.mma_async m64, and one producer warp keeps TMA loads of
//     128-key K and V tiles in flight through a ring (3 stages at D 64, 2
//     at D 128: Q 32 KB and 32 KB per K and per V stage), each stage's
//     arrival an mbarrier with its byte count, each stage's release an
//     mbarrier the eight consumer warps arrive at.  The Q tile is loaded
//     once by TMA.  The tensor maps are 4-D, (D, H, S, B), so a box of
//     rows never crosses into the next batch, and rows past S come in as
//     zeros (their scores are still masked).  A box is 64 columns wide
//     (128 bytes, the 128-byte swizzle that wgmma reads), so D 128 is two
//     boxes and D 112 two boxes whose last 16 columns lie outside the map
//     and arrive as zeros: they add nothing to q.k and give output
//     columns that are not stored.  S is m64n128 from shared memory (Q
//     and K both K-major); the score accumulators become, after the
//     online-softmax update and the rounding of p to bf16, the register A
//     operand of O += P V, whose B operand V is read MN-major (transposed
//     in the instruction) as m64n64 per 64-column box.  A warpgroup runs
//     q.k, softmax and p.v of a tile in turn; the other warpgroup's
//     products fill the tensor cores meanwhile.  (At D 128 ptxas keeps
//     the wgmmas in order for want of registers; overlapping a tile's
//     softmax with the last tile's p.v, with setmaxnreg or a ping-pong of
//     the warpgroups, measured slower on an H100: see PERF.md.)
//   * bfloat16 otherwise (few queries, or head dim 16 or 256): mma.sync
//     tiles of 16 query rows, the keys split into ranges over blocks.
//     With few queries a 64-row tile is mostly padding (1/64 useful at
//     one query) and B*H blocks leave most of the card idle while each
//     walks every key in series (whisper's cross-attention at decode: 64
//     blocks over 1500 keys).  So the keys [0, Sk) are cut into ranges of
//     whole 64-key stages, from shapes and the SM count alone (about 3
//     blocks an SM), and block (range, query tile, batch-head) walks its
//     range: K and V through a 2-stage cp.async ring (37 KB at D 64, so
//     five blocks share an SM and their loads overlap), each warp 16 keys
//     of a stage with its own softmax state, q.k and p.v on mma.sync
//     m16n8k16 (p in registers), the four warp states merged in shared
//     memory.
//     At D 256 (paligemma's heads; a 64 x 256 f32 wgmma accumulator
//     would take 128 registers a thread before S and P, so the wgmma
//     tiles stop at 128) a stage of K and V is 66 KB: the ring takes 3
//     stages (206 KB with q, one block an SM) so that two stages are in
//     flight while one is read, and the q fragments are read from shared
//     memory at each step instead of being held in 64 registers beside
//     the 128 of the accumulator.  Halving the keys a stage would give
//     two blocks an SM only with two warps each: the same four warps and
//     keys in flight an SM, with more barriers.
//     With one range the block writes o; with more it writes an f32
//     partial (acc, m, l) to scratch and counts itself on an arrival
//     counter of its query tile, and the last block of the tile to arrive
//     merges the partials, writes o and sets the counter back to 0 for
//     the next call: still one launch.
//   * float32 (the exact float32 checks; TF32 would break them): CUDA
//     cores, 32 query rows by 32 keys a step, scores and probabilities
//     staged in shared memory, 8 threads a query row, with the same key
//     ranges and in-launch merge for few queries.
// Splitting the keys changes the summation order and the maximum each p
// is rounded at (each range's own), not what is rounded: p is rounded to
// bf16 once, then scaled by exp(m_range - m) in f32.
// A training forward passes `lse` (f32, (B, H, Sq)): each kernel then also
// stores every valid row's log-sum-exp, m ln 2 + log l from the row's
// final state (the wgmma kernel at the end of its row loop, the split
// kernels once the ranges are merged, or from the one range), so the
// backward (csrc/flash_attention_bwd.cu) need not rebuild it.  Each
// kernel is built with and without that store (a template flag), and the
// serve path, which passes null, runs the one without.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSplit = 32;          // key ranges; the merge's weights fit

// ---- shared helpers ---------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
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
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(smem)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(smem)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The row log-sum-exp a training forward saves for the backward, natural
// units, from a row's merged state (m its maximum in log2 units, l its
// sum): m ln 2 + log l; a row that kept no key stores +inf, so the
// backward's exp(s - lse) is 0 there and never NaN.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m * kLn2 + logf(l) : __int_as_float(0x7f800000);
}

// ---- key ranges: partial states and the in-launch merge --------------------
// A block that walked one key range of a query tile of ROWS rows writes
// its state as one record of ROWS * (D + 2) floats: acc [ROWS][D]
// (unnormalised), m [ROWS] (log2 units), l [ROWS].  Records of a tile lie
// together, range by range.
template <int ROWS, int D>
__device__ __forceinline__ float* part_record(float* part, long long tile,
                                              int n_split, int split) {
  return part + (tile * n_split + split) * (long long)(ROWS * (D + 2));
}

// Called by every thread of a block once its record is written: counts the
// block on its tile's arrival counter; the last of the tile's n_split
// blocks merges the records of the tile's nr valid rows into o (row
// stride rs) and sets the counter back to 0.  `wsm` is shared memory of
// 2 * n_split * nr + nr floats the block no longer needs.  Every record is
// written in full (an empty range as acc 0, m -1e30, l 0), so the merge
// reads them without a branch: first all (m, l), in flight together, into
// per-range weights in shared memory, then four columns a thread with
// one independent 16-byte load a range.  With LSE the merged rows'
// log-sum-exp goes to lse[0 .. nr).
template <typename T, int ROWS, int D, int NT, bool LSE>
__device__ void merge_if_last(float* part, int* counters, long long tile,
                              int n_split, T* ob, long long rs, int nr,
                              float* wsm, float* lse) {
  __shared__ int last;
  __threadfence();                 // this block's record, before its count
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counters + tile, 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();                 // the others' records, after their counts
  constexpr long long kRec = ROWS * (D + 2);
  const float* rec = part_record<ROWS, D>(part, tile, n_split, 0);
  const int n = n_split * nr;
  float* wl = wsm + n;             // l, then per row 1 / L at wl[n + r]
  for (int i = threadIdx.x; i < n; i += NT) {
    const int sp = i / nr, r = i - sp * nr;
    wsm[i] = __ldcg(rec + sp * kRec + ROWS * D + r);
    wl[i] = __ldcg(rec + sp * kRec + ROWS * D + ROWS + r);
  }
  __syncthreads();
  if (threadIdx.x < nr) {
    const int r = threadIdx.x;
    float M = kNegInf;
    for (int sp = 0; sp < n_split; ++sp) M = fmaxf(M, wsm[sp * nr + r]);
    float L = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const float l = wl[sp * nr + r];
      const float w = l > 0.f ? exp2f(wsm[sp * nr + r] - M) : 0.f;
      wsm[sp * nr + r] = w;        // an empty range adds nothing
      L += l * w;
    }
    wl[n + r] = 1.f / fmaxf(L, 1e-30f);
    if constexpr (LSE) lse[r] = row_lse(M, L);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nr * (D / 4); e += NT) {
    const int r = e / (D / 4), d = (e - r * (D / 4)) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int sp = 0; sp < n_split; ++sp) {
      const float4 a = __ldcg(
          reinterpret_cast<const float4*>(rec + sp * kRec + r * D + d));
      const float w = wsm[sp * nr + r];
      acc.x += w * a.x;
      acc.y += w * a.y;
      acc.z += w * a.z;
      acc.w += w * a.w;
    }
    const float inv = wl[n + r];
    T* out = ob + r * rs + d;
    out[0] = from_f32<T>(acc.x * inv);
    out[1] = from_f32<T>(acc.y * inv);
    out[2] = from_f32<T>(acc.z * inv);
    out[3] = from_f32<T>(acc.w * inv);
  }
  if (threadIdx.x == 0) counters[tile] = 0;   // armed for the next call
}

// ---- bfloat16, many queries: wgmma and TMA ----------------------------------
namespace wg {

constexpr int kBQ = 128;               // query rows a block owns
constexpr int kBK = 128;               // keys a ring stage holds
constexpr int kConsumerWarps = 8;      // two warpgroups of 64 rows
constexpr int kThreads = 32 * kConsumerWarps + 32;   // + the producer warp

// Shared memory of the padded head dim DP (64 or 128): a tile is DP / 64
// boxes of [rows][64] bf16, each row 128 bytes, 128-byte swizzled; then
// the mbarriers (Q, full[stage], empty[stage]); 1 KB of slack lets the
// base be aligned to the swizzle's 1024-byte period.
template <int DP>
struct Geo {
  static constexpr int kBoxes = DP / 64;
  static constexpr int kStages = DP == 64 ? 3 : 2;
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kTileBytes = kBK * DP * 2;     // K or V of a stage
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kTileBytes;
  static constexpr int kBarOff = kVOff + kStages * kTileBytes;
  static constexpr int kSmem = kBarOff + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kSmem <= 227 * 1024, "fits one block an SM");
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

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma operand descriptor of a 128-byte-swizzled tile at shared address
// `addr` (1024-byte aligned but for a step along the 128-byte row): groups
// of 8 rows lie 1024 bytes apart.  That is the stride offset; the leading
// offset is not read for these shapes (K-major with 16 columns inside the
// swizzled row; MN-major one 64-wide box), and carries the same 1024.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t k8Rows = 1024 >> 4;
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (k8Rows << 16) |
         (k8Rows << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of registers that a
// wgmma in flight owns across the fence, commit and wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 128 f32) = A B^T (+ d when scale_d): A 64 x 16 and B 128 x 16,
// both bf16 in shared memory, K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 f32) += A B (+ d when scale_d): A 64 x 16 bf16 in registers
// (the mma.sync A fragment layout, warp w holding rows 16 w ..), B 16 x 64
// bf16 in shared memory, MN-major (hence the transpose flag), 128-byte
// swizzle.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int D, bool LSE>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ lse, int H, int Sq, int Sk,
                        float scale_log2, int causal) {
  constexpr int DP = D <= 64 ? 64 : 128;
  using G = Geo<DP>;
  constexpr int kS = G::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + G::kKOff, sV = base + G::kVOff;
  const uint32_t q_bar = base + G::kBarOff;
  const uint32_t full0 = q_bar + 8, empty0 = full0 + 8 * kS;

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H;
  const int q0 = qt * kBQ;
  int n_kv = (Sk + kBK - 1) / kBK;
  if (causal) n_kv = min(n_kv, (min(q0 + kBQ, Sq) - 1) / kBK + 1);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {        // the producer warp: TMA loads only
    if (lane == 0) {
      mbar_expect_tx(q_bar, G::kQBytes);
      for (int x = 0; x < G::kBoxes; ++x)
        tma_load(sQ + x * kBQ * 128, &qmap, q_bar, 64 * x, h, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kS, round = j / kS;
        if (round > 0) mbar_wait(empty0 + 8 * s, (round - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * G::kTileBytes);
        for (int x = 0; x < G::kBoxes; ++x) {
          const uint32_t off = s * G::kTileBytes + x * kBK * 128;
          tma_load(sK + off, &kmap, full, 64 * x, h, j * kBK, b);
          tma_load(sV + off, &vmap, full, 64 * x, h, j * kBK, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wgi owns rows 64 wgi .. of the tile; warp w of it
  // rows 16 w .. (the wgmma accumulator layout: per 8 columns, rows g and
  // g + 8, columns 2 t4 and 2 t4 + 1, as mma.sync's)
  const int wgi = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int row_lo = q0 + wgi * 64 + (warp & 3) * 16;
  float oacc[G::kBoxes][32];
#pragma unroll
  for (int x = 0; x < G::kBoxes; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[x][i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float s[kBK / 2];
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
  uint32_t pa[kBK / 16][4];

  mbar_wait(q_bar, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int st = j % kS;
    mbar_wait(full0 + 8 * st, (j / kS) & 1);
    const uint32_t kst = sK + st * G::kTileBytes;
    const uint32_t vst = sV + st * G::kTileBytes;

    // s = q k^T over DP / 16 steps of 16 columns (4 a box)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk & 3) * 32;        // bytes into the row
      const uint64_t da = desc(sQ + (kk >> 2) * kBQ * 128 + wgi * 64 * 128 +
                               col);
      const uint64_t db = desc(kst + (kk >> 2) * kBK * 128 + col);
      wgmma_m64n128k16_ss(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);

    const int k0 = j * kBK;
    const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > row_lo);
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt * 4 + e] * scale_log2;
        if (edge) {
          const int kpos = k0 + nt * 8 + 2 * t4 + (e & 1);
          const int qpos = row_lo + g + 8 * (e >> 1);
          if (kpos >= Sk || (causal && kpos > qpos)) x = kNegInf;
        }
        s[nt * 4 + e] = x;
      }
    }
    // online softmax (log2 units), rows g (r = 0) and g + 8 (r = 1); the
    // four threads of a quad share a row.  Every row of a walked tile has
    // a valid key (k0 <= its position, k0 < Sk), so m_new is finite.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt * 4 + 2 * r], s[nt * 4 + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const float alpha = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        const float p0 = exp2f(s[nt * 4 + 2 * r] - m_new);
        const float p1 = exp2f(s[nt * 4 + 2 * r + 1] - m_new);
        s[nt * 4 + 2 * r] = p0;
        s[nt * 4 + 2 * r + 1] = p1;
        sum += p0 + p1;
      }
      l_run[r] = l_run[r] * alpha + sum;
#pragma unroll
      for (int x = 0; x < G::kBoxes; ++x)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          oacc[x][nt * 4 + 2 * r] *= alpha;
          oacc[x][nt * 4 + 2 * r + 1] *= alpha;
        }
    }
    // p rounded to bf16: the score tiles 2 kc and 2 kc + 1 are the A
    // fragment of keys 16 kc ..
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      pa[kc][0] = pack_bf16(s[8 * kc + 0], s[8 * kc + 1]);
      pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
      pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
      pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
    }
    // o += p v: 16 keys a step (2048 bytes of the V box), one m64n64 per
    // 64-column box
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc)
#pragma unroll
      for (int x = 0; x < G::kBoxes; ++x)
        wgmma_m64n64k16_rs(oacc[x], pa[kc],
                           desc(vst + x * kBK * 128 + kc * 16 * 128), 1);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int x = 0; x < G::kBoxes; ++x) reg_fence(oacc[x]);
    reg_fence(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);   // stage st may refill
  }

  const long long rs = (long long)H * D;
  __nv_bfloat16* ob = o + ((long long)b * Sq * H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row_lo + g + 8 * r;
    if (LSE && t4 == 0 && row < Sq)
      lse[(long long)blockIdx.y * Sq + row] = row_lse(m_run[r], l);
    l = fmaxf(l, 1e-30f);
    if (row < Sq) {
      __nv_bfloat16* orow = ob + (long long)row * rs;
#pragma unroll
      for (int x = 0; x < G::kBoxes; ++x)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = 64 * x + nt * 8 + 2 * t4;
          if (col < D)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(oacc[x][nt * 4 + 2 * r] / l,
                                      oacc[x][nt * 4 + 2 * r + 1] / l);
        }
    }
  }
}

}  // namespace wg

// ---- bfloat16, few queries: 16-row mma.sync tiles over key ranges ----------
namespace few {

constexpr int kThreads = 128;          // 4 warps
constexpr int kWarps = 4;
constexpr int kRows = 16;              // query rows a block owns
constexpr int kStage = 64;             // keys a ring stage holds
constexpr int kWarpKeys = kStage / kWarps;

template <int D>
struct Geo {
  // small blocks below D 256: 5 an SM at D 64; at D 256 one block an SM
  // with a deeper ring (see the design note above)
  static constexpr int kStages = D == 256 ? 3 : 2;
  static constexpr bool kQInRegs = D <= 128;   // q fragments in registers
  static constexpr int kPitch = D + 8;                 // padded bf16 row
  static constexpr int kChunks = D / 8;                // 16-byte copies a row
  static constexpr int kStageElems = 2 * kStage * kPitch;   // K then V
  static constexpr size_t kRing = (size_t)kStages * kStageElems * 2;
  static constexpr size_t kQ = (size_t)kRows * kPitch * 2;
  static constexpr size_t kSmem = kRing + kQ;
  static constexpr size_t kComb = (size_t)kWarps * kRows * (D + 2) * 4;
  static_assert(kComb <= kRing, "warp states must fit in the ring");
  static_assert(kSmem <= 227 * 1024, "fits one block an SM");
};

// K and V rows [k0, k0 + 64) of one stage into shared memory; rows at or
// past `hi` (outside the range) are zero-filled, so no stale value meets a
// zero probability.
template <int D>
__device__ __forceinline__ void load_stage(__nv_bfloat16* ks,
                                           const __nv_bfloat16* kb,
                                           const __nv_bfloat16* vb,
                                           long long rs, int k0, int hi) {
  using G = Geo<D>;
  __nv_bfloat16* vs = ks + kStage * G::kPitch;
  for (int c = threadIdx.x; c < kStage * G::kChunks; c += kThreads) {
    const int r = c / G::kChunks, dc = (c - r * G::kChunks) * 8;
    __nv_bfloat16* kd = ks + r * G::kPitch + dc;
    __nv_bfloat16* vd = vs + r * G::kPitch + dc;
    if (k0 + r < hi) {
      const long long off = (long long)(k0 + r) * rs + dc;
      cp_async16(kd, kb + off);
      cp_async16(vd, vb + off);
    } else {
      *reinterpret_cast<uint4*>(kd) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(vd) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <int D, bool LSE>
__global__ void __launch_bounds__(kThreads)
flash_attn_split_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             __nv_bfloat16* __restrict__ o,
                             float* __restrict__ part,
                             int* __restrict__ counters,
                             float* __restrict__ lse, int H, int Sq,
                             int Sk, float scale_log2, int causal,
                             int keys_per_split) {
  using G = Geo<D>;
  constexpr int kStages = G::kStages;
  constexpr int kPitch = G::kPitch;
  constexpr int kKSteps = D / 16;
  constexpr int kNT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw + G::kRing);

  const int split = blockIdx.x, n_split = gridDim.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int bh = blockIdx.z;
  const int b = bh / H, h = bh - b * H;
  const int q0 = qt * kRows, nr = min(kRows, Sq - q0);
  const long long rs = (long long)H * D;
  const __nv_bfloat16* qb = q + ((long long)b * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + ((long long)b * Sk * H + h) * D;
  const __nv_bfloat16* vb = v + ((long long)b * Sk * H + h) * D;
  __nv_bfloat16* ob = o + ((long long)b * Sq * H + h) * D + q0 * rs;

  // this block's keys [lo, hi): its range, and in causal mode no key past
  // the tile's last query row
  const int lo = split * keys_per_split;
  int hi = min(Sk, lo + keys_per_split);
  if (causal) hi = min(hi, q0 + nr);
  const int n_st = hi > lo ? (hi - lo + kStage - 1) / kStage : 0;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, mat = lane >> 3;
  for (int c = tid; c < kRows * (D / 8); c += kThreads) {
    const int r = c / (D / 8), dc = (c - r * (D / 8)) * 8;
    __nv_bfloat16* d = qs + r * kPitch + dc;
    if (r < nr)
      cp_async16(d, qb + (long long)(q0 + r) * rs + dc);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_st)
      load_stage<D>(ring + st * G::kStageElems, kb, vb, rs,
                    lo + st * kStage, hi);
    cp_async_commit();
  }

  uint32_t qf[G::kQInRegs ? kKSteps : 1][4];
  float acc[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int it = 0; it < n_st; ++it) {
    const int ahead = it + kStages - 1;
    if (ahead < n_st)
      load_stage<D>(ring + (ahead % kStages) * G::kStageElems, kb, vb, rs,
                    lo + ahead * kStage, hi);
    cp_async_commit();
    cp_async_wait<kStages - 1>();              // stage it (and q) landed
    __syncthreads();
    const int qrow = (mat & 1) * 8 + (lane & 7);
    if (G::kQInRegs && it == 0) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        ldmatrix_x4(qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
                    qs + qrow * kPitch + kk * 16 + (mat >> 1) * 8);
    }
    const __nv_bfloat16* kst = ring + (it % kStages) * G::kStageElems;
    const __nv_bfloat16* vst = kst + kStage * kPitch;
    const int key0 = warp * kWarpKeys;         // this warp's 16 keys
    const int kpos0 = lo + it * kStage + key0;
    if (kpos0 < hi) {                          // warp-uniform
      float s[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const int qk = G::kQInRegs ? kk : 0;
        if (!G::kQInRegs)
          ldmatrix_x4(qf[0][0], qf[0][1], qf[0][2], qf[0][3],
                      qs + qrow * kPitch + kk * 16 + (mat >> 1) * 8);
        uint32_t b0, b1, b2, b3;
        const int key = key0 + (mat >> 1) * 8 + (lane & 7);
        ldmatrix_x4(b0, b1, b2, b3,
                    kst + key * kPitch + kk * 16 + (mat & 1) * 8);
        mma_bf16(s[0], qf[qk], b0, b1);
        mma_bf16(s[1], qf[qk], b2, b3);
      }
      // online softmax (log2 units) of rows g (r = 0) and g + 8 (r = 1);
      // a masked key gets p = 0 outright, since a row may have no valid
      // key in this range yet (causal ranges past its position)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos = q0 + g + 8 * r;
        bool ok[2][2];
        float mx = kNegInf;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kpos = kpos0 + nt * 8 + 2 * t4 + c;
            ok[nt][c] = kpos < hi && !(causal && kpos > qpos);
            const float x = ok[nt][c] ? s[nt][2 * r + c] * scale_log2
                                      : kNegInf;
            s[nt][2 * r + c] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[r], mx);
        const float alpha = exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = ok[nt][c] ? exp2f(s[nt][2 * r + c] - m_new) : 0.f;
            s[nt][2 * r + c] = p;
            sum += p;
          }
        l_run[r] = l_run[r] * alpha + sum;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          acc[nt][2 * r] *= alpha;
          acc[nt][2 * r + 1] *= alpha;
        }
      }
      // acc += p v, p rounded to bf16 (the two score tiles are the A
      // fragment of these 16 keys)
      uint32_t a[4];
      a[0] = pack_bf16(s[0][0], s[0][1]);
      a[1] = pack_bf16(s[0][2], s[0][3]);
      a[2] = pack_bf16(s[1][0], s[1][1]);
      a[3] = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
      for (int dp = 0; dp < kNT / 2; ++dp) {
        uint32_t b0, b1, b2, b3;
        const int krow = key0 + (mat & 1) * 8 + (lane & 7);
        ldmatrix_x4_trans(b0, b1, b2, b3,
                          vst + krow * kPitch + dp * 16 + (mat >> 1) * 8);
        mma_bf16(acc[2 * dp], a, b0, b1);
        mma_bf16(acc[2 * dp + 1], a, b2, b3);
      }
    }
    __syncthreads();                           // this buffer refills next
  }
  cp_async_wait<0>();
  __syncthreads();

  // the four warp states into shared memory (over the ring), then merged
  float* cacc = reinterpret_cast<float*>(smem_raw);    // [warp][row][D]
  float* cm = cacc + kWarps * kRows * D;                // [warp][row]
  float* cl = cm + kWarps * kRows;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = warp * kRows + g + 8 * r;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      *reinterpret_cast<float2*>(cacc + row * D + nt * 8 + 2 * t4) =
          make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
    if (t4 == 0) {
      cm[row] = m_run[r];
      cl[row] = l;
    }
  }
  __syncthreads();
  const long long tile = (long long)bh * gridDim.y + qt;
  float* rec = part_record<kRows, D>(part, tile, n_split, split);
  for (int e = tid; e < nr * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, cm[w * kRows + r]);
    float sum = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(cm[w * kRows + r] - M);
      sum += cacc[(w * kRows + r) * D + d] * wt;
      L += cl[w * kRows + r] * wt;
    }
    if (n_split == 1) {
      ob[r * rs + d] = __float2bfloat16(sum / fmaxf(L, 1e-30f));
    } else {
      rec[r * D + d] = sum;
      if (d == 0) {
        rec[kRows * D + r] = M;
        rec[kRows * D + kRows + r] = L;
      }
    }
  }
  if (LSE && n_split == 1 && tid < nr) {     // one range: its lse
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, cm[w * kRows + tid]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      L += cl[w * kRows + tid] * exp2f(cm[w * kRows + tid] - M);
    lse[(long long)bh * Sq + q0 + tid] = row_lse(M, L);
  }
  if (n_split > 1) {
    __syncthreads();                           // done with the ring
    merge_if_last<__nv_bfloat16, kRows, D, kThreads, LSE>(
        part, counters, tile, n_split, ob, rs, nr,
        reinterpret_cast<float*>(smem_raw), lse + (long long)bh * Sq + q0);
  }
}

}  // namespace few

// ---- float32: CUDA cores, 32-row tiles over key ranges ---------------------
namespace f32 {

constexpr int kThreads = 256;          // 8 threads a query row
constexpr int kBQ = 32;
constexpr int kBK = 32;

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1) +
                  3 * kBQ) * sizeof(float);
}

template <int D, bool LSE>
__global__ void __launch_bounds__(kThreads)
flash_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ part, int* __restrict__ counters,
                      float* __restrict__ lse, int H, int Sq, int Sk,
                      float scale_log2, int causal, int keys_per_split) {
  constexpr int kQP = D + 1;            // padded row of q and k
  constexpr int kSP = kBK + 1;          // padded row of the scores
  constexpr int kPer = D / 8;           // output columns a thread owns
  extern __shared__ float fsm[];
  float* qs = fsm;                      // [kBQ][kQP]
  float* ks = qs + kBQ * kQP;           // [kBK][kQP]
  float* vs = ks + kBK * kQP;           // [kBK][D]
  float* ps = vs + kBK * D;             // [kBQ][kSP] scores, then p
  float* ms = ps + kBQ * kSP;           // [kBQ] running max (log2 units)
  float* ls = ms + kBQ;                 // [kBQ] running sum
  float* as = ls + kBQ;                 // [kBQ] this step's rescale

  const int split = blockIdx.x, n_split = gridDim.x;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int bh = blockIdx.z;
  const int b = bh / H, h = bh - b * H;
  const int q0 = qt * kBQ, nr = min(kBQ, Sq - q0);
  const long long rs = (long long)H * D;
  const float* qb = q + ((long long)b * Sq * H + h) * D;
  const float* kb = k + ((long long)b * Sk * H + h) * D;
  const float* vb = v + ((long long)b * Sk * H + h) * D;
  float* ob = o + ((long long)b * Sq * H + h) * D + q0 * rs;

  // this block's keys [lo, hi): its range, and in causal mode no key past
  // the tile's last query row
  const int lo = split * keys_per_split;
  int hi = min(Sk, lo + keys_per_split);
  if (causal) hi = min(hi, q0 + nr);
  const int n_kv = hi > lo ? (hi - lo + kBK - 1) / kBK : 0;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = tid >> 3, col = tid & 7;   // a query row, 8 threads each
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    qs[r * kQP + d] = r < nr ? qb[(long long)(q0 + r) * rs + d] : 0.f;
  }
  if (tid < kBQ) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = lo + j * kBK;
    __syncthreads();                   // the last step is done with k, v, p
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const bool in = k0 + r < hi;
      const long long off = (long long)(k0 + r) * rs + d;
      ks[r * kQP + d] = in ? kb[off] : 0.f;
      vs[r * D + d] = in ? vb[off] : 0.f;
    }
    __syncthreads();
    // scores: row `row`, keys col + 8 i
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i) {
      const int c = col + 8 * i;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot += qs[row * kQP + d] * ks[c * kQP + d];
      float x = dot * scale_log2;
      const int kpos = k0 + c, qpos = q0 + row;
      if (kpos >= hi || (causal && kpos > qpos)) x = kNegInf;
      ps[row * kSP + c] = x;
    }
    __syncthreads();
    // online softmax: warp w takes rows 4w .. 4w + 3, a lane a key; a
    // masked key gets p = 0 outright (a row may have no valid key in this
    // range yet)
#pragma unroll
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      const float x = ps[r * kSP + lane];
      const float m_old = ms[r], l_old = ls[r];
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_old, mx);
      const float p = x == kNegInf ? 0.f : exp2f(x - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ps[r * kSP + lane] = p;
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        as[r] = alpha;
        ls[r] = l_old * alpha + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();
    const float alpha = as[row];
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] *= alpha;
    for (int kk = 0; kk < kBK; ++kk) {
      const float p = ps[row * kSP + kk];
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] += p * vs[kk * D + col + 8 * i];
    }
  }
  __syncthreads();
  if (n_split == 1) {
    if (row < nr) {
      const float l = fmaxf(ls[row], 1e-30f);
      float* orow = ob + (long long)row * rs;
#pragma unroll
      for (int i = 0; i < kPer; ++i) orow[col + 8 * i] = acc[i] / l;
      if (LSE && col == 0)
        lse[(long long)bh * Sq + q0 + row] = row_lse(ms[row], ls[row]);
    }
    return;
  }
  const long long tile = (long long)bh * gridDim.y + qt;
  float* rec = part_record<kBQ, D>(part, tile, n_split, split);
  if (row < nr) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) rec[row * D + col + 8 * i] = acc[i];
    if (col == 0) {
      rec[kBQ * D + row] = ms[row];
      rec[kBQ * D + kBQ + row] = ls[row];
    }
  }
  __syncthreads();                             // done with k, v, p
  merge_if_last<float, kBQ, D, kThreads, LSE>(
      part, counters, tile, n_split, ob, rs, nr, fsm,
      lse + (long long)bh * Sq + q0);
}

}  // namespace f32

// ---- launchers --------------------------------------------------------------
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem, bool* done) {
  if (smem <= (size_t)kDefaultSmem || *done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  *done = true;
  return 0;
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, H, Sq, Sk, causal, n_split, keys_per_split;
  float scale_log2;
  float* part;
  int* counters;
  float* lse;
  cudaStream_t stream;
};

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

// A 4-D map over a contiguous (B, S, H, D) bf16 tensor, innermost first:
// (D, H, S, B); a box is 64 columns of `rows` positions of one head,
// 128-byte swizzled; what lies outside the tensor reads as zero.
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
                int D, int rows) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kNoTensorMap = -2;

template <int D, bool LSE>
int launch_wgmma(const Args& a) {
  constexpr int DP = D <= 64 ? 64 : 128;
  static bool attr_set = false;
  const size_t smem = wg::Geo<DP>::kSmem;
  const int rc =
      allow_smem(wg::flash_attn_wgmma_kernel<D, LSE>, smem, &attr_set);
  if (rc) return rc;
  CUtensorMap qm, km, vm;
  if (!tensor_map(&qm, a.q, a.B, a.Sq, a.H, D, wg::kBQ) ||
      !tensor_map(&km, a.k, a.B, a.Sk, a.H, D, wg::kBK) ||
      !tensor_map(&vm, a.v, a.B, a.Sk, a.H, D, wg::kBK))
    return kNoTensorMap;
  const dim3 grid((unsigned)((a.Sq + wg::kBQ - 1) / wg::kBQ),
                  (unsigned)(a.B * a.H));
  wg::flash_attn_wgmma_kernel<D, LSE><<<grid, wg::kThreads, smem,
                                        a.stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(a.o), a.lse, a.H, a.Sq, a.Sk,
      a.scale_log2, a.causal);
  return (int)cudaGetLastError();
}

template <int D, bool LSE>
int launch_few(const Args& a) {
  static bool attr_set = false;
  const size_t smem = few::Geo<D>::kSmem;
  const int rc =
      allow_smem(few::flash_attn_split_bf16_kernel<D, LSE>, smem, &attr_set);
  if (rc) return rc;
  const dim3 grid((unsigned)a.n_split,
                  (unsigned)((a.Sq + few::kRows - 1) / few::kRows),
                  (unsigned)(a.B * a.H));
  few::flash_attn_split_bf16_kernel<D, LSE><<<grid, few::kThreads, smem,
                                              a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<__nv_bfloat16*>(a.o), a.part, a.counters, a.lse, a.H, a.Sq,
      a.Sk, a.scale_log2, a.causal, a.keys_per_split);
  return (int)cudaGetLastError();
}

template <int D, bool LSE>
int launch_f32(const Args& a) {
  static bool attr_set = false;
  constexpr size_t smem = f32::smem_bytes<D>();
  static_assert(smem <= 227 * 1024, "fits one block an SM");
  const int rc =
      allow_smem(f32::flash_attn_f32_kernel<D, LSE>, smem, &attr_set);
  if (rc) return rc;
  const dim3 grid((unsigned)a.n_split,
                  (unsigned)((a.Sq + f32::kBQ - 1) / f32::kBQ),
                  (unsigned)(a.B * a.H));
  f32::flash_attn_f32_kernel<D, LSE><<<grid, f32::kThreads, smem,
                                       a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.part,
      a.counters, a.lse, a.H, a.Sq, a.Sk, a.scale_log2, a.causal,
      a.keys_per_split);
  return (int)cudaGetLastError();
}

// path: 0 = float32 (CUDA cores), 1 = bfloat16 16-row tiles over key
// ranges, 2 = bfloat16 wgmma tiles.  Each kernel is built twice: with
// the lse store (a training forward) and without it (the serve path,
// the code it ran before the store existed).
template <int D, bool LSE>
int launch_lse(int path, const Args& a) {
  switch (path) {
    case 0: return launch_f32<D, LSE>(a);
    case 1: return launch_few<D, LSE>(a);
    case 2:
      if constexpr (D == 16 || D == 256) return -1;
      else return launch_wgmma<D, LSE>(a);
    default: return -1;
  }
}

template <int D>
int launch(int path, const Args& a) {
  return a.lse != nullptr ? launch_lse<D, true>(path, a)
                          : launch_lse<D, false>(path, a);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike); q, k, v and o
// contiguous, 16-byte aligned.  path: 0 = float32 (dtype 0); 1 =
// bfloat16, 16-row tiles over n_split key ranges of keys_per_split keys
// (a multiple of 64); 2 = bfloat16 wgmma tiles (head dim 64, 112 or 128,
// Sk > 0, n_split 1).  float32 takes n_split ranges of keys_per_split keys
// (a multiple of 32).  n_split is at most 32.  With n_split > 1, part holds B * H * ceil(Sq / R) *
// n_split * R * (D + 2) floats (R: 16 for path 1, 32 for path 0) and
// counters B * H * ceil(Sq / R) ints that are 0 before the launch and 0
// again after it.  scale: the softmax scale (1 / sqrt(D)).  lse: null, or
// B * H * Sq floats that receive each query row's log-sum-exp of its
// scaled, masked scores (natural units; +inf for a row that keeps no
// key), laid out (B, H, Sq), for the backward.  Returns 0 on
// success, -1 for an unsupported argument (head dim, dtype, path, the
// wgmma path at head dim 16 or 256, causal with Sq != Sk, a grid
// dimension above 65535), -2 when no tensor map can be encoded, else the
// cudaError_t of the launch.
int mars_flash_attention(int dtype, int path, const void* q, const void* k,
                         const void* v, void* o, int B, int H, int Sq, int Sk,
                         int D, int causal, float scale, int n_split,
                         int keys_per_split, float* part, int* counters,
                         float* lse, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk < 0 || (long long)B * H > 65535 ||
      n_split < 1 || n_split > kMaxSplit || keys_per_split < 1)
    return -1;
  if (causal && Sq != Sk) return -1;
  if ((dtype == 0) != (path == 0) || dtype < 0 || dtype > 1) return -1;
  if (path == 2 && (n_split != 1 || Sk == 0)) return -1;
  if (Sq > 65535 * 16) return -1;
  if (n_split > 1 && (part == nullptr || counters == nullptr)) return -1;
  const Args a{q, k, v, o, B, H, Sq, Sk, causal, n_split, keys_per_split,
               scale * kLog2e, part, counters, lse,
               static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 16: return launch<16>(path, a);
    case 64: return launch<64>(path, a);
    case 112: return launch<112>(path, a);
    case 128: return launch<128>(path, a);
    case 256: return launch<256>(path, a);
    default: return -1;
  }
}

const char* mars_cuda_error_string(int err) {
  if (err == kNoTensorMap)
    return "cuTensorMapEncodeTiled is unavailable or refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
