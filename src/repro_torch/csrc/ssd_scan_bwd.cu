// Backward of the SSD (Mamba2) chunked scan (B3) for Hopper (sm_90a),
// plain C interface.
//
// Replaces no Pallas kernel: the reference has no backward kernel, and its
// trainer differentiates the jnp `ssd_chunked` (src/repro/models/ssm.py:93)
// with jax.value_and_grad (src/repro/train/step.py:47).  This computes the
// gradient jax.vjp of `ssd_chunked` gives (no initial state) for K3's
// forward (csrc/ssd_scan.cu): from dy (B,S,H,P) f32 and the final state's
// gradient dS (B,H,P,N) f32 (or none: zero), dx in x's dtype, db and dc in
// b's dtype, dla and ddt in f32.  x, b, c are read in their dtype (float32
// or bfloat16) and la, dt in f32, as K3 reads them.
//
// Within a chunk of q positions, cum = cumsum(la), e_t = exp(cum_t), f_k =
// exp(cum_end - cum_k), D_tk = exp(min(cum_t - cum_k, 0)) for k <= t (else
// exactly 0), W_tk = (c_t . b_k) D_tk dt_k; s_{c-1} is the state entering
// chunk c (K3 keeps it), G_c the gradient of the state leaving it.
//
// Design: three launches a call of several chunks, two of one chunk:
//   (1) state kernel, a block a (16 mt rows of P, head, batch), mt = 1, 2
//       or 4 m-tiles (``bwd_state_tiles``: the most that leave two blocks
//       an SM): walks the chunks from the last back with its rows of G in
//       the registers of mma accumulators, G_{c-1} = exp(cum_end,c) G_c +
//       U_c, U_c = sum_t e_t dy_t (x) c_t formed on tensor cores into them,
//       and writes each G_c once to gbuf (B, n_chunks, H, P, N).  The rows
//       of G are independent: a long scan of few heads keeps 16 rows a
//       block and still fills the card (mamba2's 4096 tokens: 32 heads x
//       4 slices), a batch of many takes taller blocks, which re-read the
//       chunk's c fewer times.  A ring of stages (3 in bf16, 2 in f32)
//       brings the coming chunks' c, dy and la by cp.async.
//   (2) grad kernel, a block a (chunk, group of hg heads, batch), 16 warps:
//       b and c once, C B^T and the heads' summed dCB in registers; per
//       head, with x, dy, G_c and s_{c-1} in shared memory:
//         A   dW = dy x^T; W, Q = dW D (C B^T) and dCB on the lower
//             triangle, Q's row and column sums; d(decay_c) = sum G_c s_{c-1}
//         B1  b G^T and the rows of r_k = x_k . (G b_k); db += f dt x G
//             (x and G_c are then free: the next head's start landing)
//         B2  dx = W^T dy + f dt (b G^T); dc += e dy s_{c-1} and its rows
//             (dy and s_{c-1} free: theirs start landing)
//         C1  every warp 4 positions, 8 lanes a position: ddt and the
//             gradient of cum from the warps' partial sums
//         C2  warp 0 the chunk end's terms and dla's reverse cumsum; warp 1
//             scans the next head's la.
//       It writes dx, ddt, dla and its group's db = dCB^T C + ... and dc =
//       dCB B + ... .  Warps 1..15 issue the copies.  Two sets of G and s
//       (the next head's landing under this head's products) fit in bf16
//       at N 128, but measured slower on the H100: the copies in flight
//       slowed the products by as much as they hid.
//   (3) sum kernel: db and dc over the head groups in group order.
// So the state gradient crosses HBM twice (gbuf written once, read once:
// 2 x 67.1 MB at mamba2-370m's training scan, 8 x 512, 32 heads of 64, N
// 128) and each entering state once (67.1 MB, which the bound counts);
// the earlier four-launch design moved about 370 MB of such tensors (U_c
// written and read, G_c written and read, s_{c-1} read twice).
//
// Products: every one runs on tensor cores, mma.sync m16n8k8 TF32 with f32
// accumulation, fragments loaded from padded shared memory (row strides
// chosen so a warp's fragment loads fall in distinct banks).  TF32 keeps
// 10 bits of mantissa, so an f32 operand a is split a = hi + lo, hi = a
// with its low 13 mantissa bits cleared and lo = (a - hi) cleared the same
// way, and a product is lo_a hi_b + hi_a lo_b + hi_a hi_b (3xTF32; lo lo
// is left out, about 2^-20 of a term).  x, b and c in bfloat16 are exact
// in TF32, so a product with one of them on one side splits only the
// other: two passes.  `tests/test_torch_ssd_scan_bwd.py` emulates this
// rounding on the CPU against float64 (within 1e-6 of each gradient's
// largest value; one rounding alone misses the 1e-4 the checks ask).
// mma.sync has a long latency on the H100 (`tools/mma_tf32_rate.py`:
// about 64 cycles a dependent product; 16 warps of 8 independent chains
// reach 316 TFLOP/s), so a warp keeps its tiles' products independent:
// all of a k-step's fragments are loaded, then each pass runs across the
// tiles.
//
// Per-position sums are reduced from the warps' accumulator tiles by
// shuffles into partial rows in shared memory, every sum in a fixed order.
// The mask exp(min(li, 0)) is 0 above the diagonal by a select, never 0 *
// inf; its derivative below the diagonal is 1 under 0, 1/2 at a tie (as
// JAX's min splits one) and 0 above; the diagonal's li is 0 and cancels.
// Nothing is summed with atomics: each output element has one owner that
// adds its terms in a fixed order, so two calls on the same inputs agree
// bit for bit.
//
// Bound: at mamba2's widths operations (the split passes over the TF32
// rate), at hymba's (N 16) bytes.  The grad kernel takes up to about 193
// KB of shared memory and 512 threads of at most 128 registers: one block
// an SM of 16 warps.  The models' widths (q 64, P 64, N 128 or 16) are
// compiled with their dims as constants; other shapes read them at run
// time.  Takes q <= 64, P <= 64, N <= 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 16;                 // grad kernel
constexpr int kThreads = kWarps * 32;
constexpr int kStateWarps = 4;             // state kernel
constexpr int kStateThreads = kStateWarps * 32;
constexpr int kSumThreads = 256;
constexpr int kMaxChunk = 64, kMaxP = 64, kMaxN = 128;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;
// n-tiles (8 columns each) a warp owns of a (q, q), (q, P), (q, N) output
// and of the state kernel's (16, N) one
constexpr int kNtQQ = 2, kNtQP = 2, kNtQN = 4, kNtState = 4;
// rows of a per-position partial sum: (warp column chunks) x qp <= 16 x
// kWarps, as a warp owns one tile pair
constexpr int kPartRows = 16 * kWarps;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }
__host__ __device__ inline long long a16(long long v) {
  return (v + 15) & ~15LL;
}
// the least row stride >= cols that is r modulo m
__host__ __device__ inline int pad_ld(int cols, int m, int r) {
  const int ld = cols - cols % m + r;
  return ld < cols ? ld + m : ld;
}
// row stride of a buffer of es-byte elements read as an A fragment by
// rows or a B fragment by columns ("rows"), else the other way: f32 rows
// 4 (or 8) modulo 32 words; bf16 rows 8 modulo 64 elements serve both
__host__ __device__ inline int ld_of(int cols, int es, bool rows) {
  return es == 2 ? pad_ld(cols, 64, 8) : pad_ld(cols, 32, rows ? 4 : 8);
}

// Shared memory of the grad kernel, in bytes; the wrapper's
// ``bwd_smem_bytes`` mirrors it.  Operand buffers first (zeroed once: their
// padding stays 0), then per-position vectors and partial sums.
struct GradLayout {
  int qp, pp, np, ldb, ldx, ldy, ldg, lds, ldw;
  long long b, c, x, dy, w, g, s, zero_end, vec, part, dcum, total;
};
// (of the dims padded to 16: constants where the kernel is built for them)
__host__ __device__ inline GradLayout grad_layout_p(int qp, int pp, int np,
                                                    int es) {
  GradLayout L;
  L.qp = qp;
  L.pp = pp;
  L.np = np;
  L.ldb = ld_of(L.np, es, true);           // b, c
  L.ldx = ld_of(L.pp, es, true);           // x
  L.ldy = ld_of(L.pp, 4, true);            // dy
  L.ldg = ld_of(L.np, 4, true);            // G_c
  L.lds = ld_of(L.np, 4, false);           // s_{c-1}
  L.ldw = ld_of(L.qp, 4, false);           // W, then dCB
  long long o = 0;
  L.b = o;  o = a16(o + (long long)L.qp * L.ldb * es);
  L.c = o;  o = a16(o + (long long)L.qp * L.ldb * es);
  L.x = o;  o = a16(o + (long long)L.qp * L.ldx * es);
  L.dy = o; o = a16(o + (long long)L.qp * L.ldy * 4);
  L.w = o;  o = a16(o + (long long)L.qp * L.ldw * 4);
  L.g = o;  o = a16(o + (long long)L.pp * L.ldg * 4);
  L.s = o;  o = a16(o + (long long)L.pp * L.lds * 4);
  L.zero_end = o;
  // two sets (this head's, the next head's) of cum, dt, e_t, f_t and
  // exp(cum_end)
  L.vec = o; o = a16(o + 2 * (4LL * L.qp + 4) * 4);
  // column sums of Q and Q m by m-tile (4); row sums of Q dt m, x . G b
  // and e_t c_t . (s^T dy_t) by warp column chunk; d(decay) by warp
  L.part = o; o = a16(o + (8LL * L.qp + 3LL * kPartRows + kWarps) * 4);
  // each position's gradient of cum and f_k dt_k r_k
  L.dcum = o; o = a16(o + 2LL * L.qp * 4);
  L.total = o;
  return L;
}
__host__ __device__ inline GradLayout grad_layout(int q, int P, int N,
                                                  int es) {
  return grad_layout_p(round16(q), round16(P), round16(N), es);
}

// Shared memory of the state kernel, whose block owns 16 mt rows of P: a
// ring of stages (3 with c in bf16, 2 in f32), each a chunk's c, dy slice
// (row stride 16 mt + 8) and la; then e_t.
__host__ __device__ constexpr int state_stages(int es) {
  return es == 2 ? 3 : 2;
}
struct StateLayout {
  int qp, np, ldc, ldy;
  long long c, y, l, stage, e, total;    // offsets within a stage; its size
};
__host__ __device__ inline StateLayout state_layout_p(int qp, int np, int es,
                                                      int mt) {
  StateLayout L;
  L.qp = qp;
  L.np = np;
  L.ldc = ld_of(L.np, es, false);
  L.ldy = 16 * mt + 8;
  long long o = 0;
  L.c = o; o = a16(o + (long long)L.qp * L.ldc * es);
  L.y = o; o = a16(o + (long long)L.qp * L.ldy * 4);
  L.l = o; o = a16(o + (long long)L.qp * 4);
  L.stage = o;
  L.e = state_stages(es) * o;
  L.total = a16(L.e + (long long)L.qp * 4);
  return L;
}
__host__ __device__ inline StateLayout state_layout(int q, int N, int es,
                                                    int mt) {
  return state_layout_p(round16(q), round16(N), es, mt);
}

// How the warps cut an M x N output (multiples of 16): mt m-tiles of 16
// rows, nt n-tiles of 8 columns, a warp ntw n-tiles of one m-tile (cpr
// warps a row of m-tiles); warp w < mt * cpr owns m-tile w / cpr and
// n-tiles (w % cpr) ntw + j.
struct Tiles {
  int mt, nt, ntw, cpr;
};
__host__ __device__ inline Tiles tiles_of(int M, int N, int ntmax) {
  Tiles t;
  t.mt = M / 16;
  t.nt = N / 8;
  for (t.ntw = 1; t.ntw < ntmax; ++t.ntw)
    if (t.mt * ((t.nt + t.ntw - 1) / t.ntw) <= kWarps) break;
  t.cpr = (t.nt + t.ntw - 1) / t.ntw;
  return t;
}

// ---- PTX: tensor-core product and asynchronous copies --------------------

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy rows x cols elements (row stride sstride) into shared memory (row
// stride ld) with cp.async in the widest of 16, 8 or 4 bytes that the
// rows, strides and addresses allow, else element by element.
template <typename E>
__device__ __forceinline__ void stage(E* dst, int ld, const E* src,
                                      long long sstride, int rows, int cols,
                                      int tid, int nthreads) {
  const int rb = cols * static_cast<int>(sizeof(E));
  const uintptr_t bits = static_cast<uintptr_t>(rb) |
                         static_cast<uintptr_t>(sstride * sizeof(E)) |
                         static_cast<uintptr_t>(ld * sizeof(E)) |
                         reinterpret_cast<uintptr_t>(src);
  const int vb = !(bits & 15) ? 16 : !(bits & 7) ? 8 : !(bits & 3) ? 4 : 0;
  if (vb) {
    const int per_row = rb / vb;
    if (nthreads % per_row == 0) {        // a thread keeps one column
      const int v = tid % per_row, step = nthreads / per_row;
      for (int r = tid / per_row; r < rows; r += step)
        cp_async(reinterpret_cast<char*>(dst + (long long)r * ld) + v * vb,
                 reinterpret_cast<const char*>(src + r * sstride) + v * vb,
                 vb);
    } else {
      for (int i = tid; i < rows * per_row; i += nthreads) {
        const int r = i / per_row, v = i - r * per_row;
        cp_async(reinterpret_cast<char*>(dst + (long long)r * ld) + v * vb,
                 reinterpret_cast<const char*>(src + r * sstride) + v * vb,
                 vb);
      }
    }
  } else {
    for (int i = tid; i < rows * cols; i += nthreads) {
      const int r = i / cols, col = i - r * cols;
      dst[(long long)r * ld + col] = src[r * sstride + col];
    }
  }
}

// ---- the split TF32 product ----------------------------------------------

__device__ __forceinline__ uint32_t tf32_bits(float v) {
  return __float_as_uint(v) & 0xffffe000u;
}

// acc[j] += sum_{k in [k0, k1)} A(m0 + r, k) B(k, n0 + 8 j + c) for the
// warp's m16 x n8 tiles j < nv (k0, k1 multiples of 8; fa(m, k) and
// fb(k, n) read the operands as f32).  SA / SB: the operand is split into
// hi + lo (else it is exact in TF32 and passed whole).
// warp_mma_rows: the same for MT m-tiles (rows m0 + 16 i) sharing the B
// fragments.
template <int MT, int NT, bool SA, bool SB, typename FA, typename FB>
__device__ __forceinline__ void warp_mma_rows(float (&acc)[MT][NT][4], FA fa,
                                              FB fb, int m0, int n0, int nv,
                                              int k0, int k1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll 2
  for (int k = k0; k < k1; k += 8) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int m = m0 + 16 * mi;
      const float av[4] = {fa(m + g, k + tq), fa(m + g + 8, k + tq),
                           fa(m + g, k + tq + 4), fa(m + g + 8, k + tq + 4)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[mi][i] = SA ? tf32_bits(av[i]) : __float_as_uint(av[i]);
        al[mi][i] = SA ? tf32_bits(av[i] - __uint_as_float(ah[mi][i])) : 0u;
      }
    }
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + 8 * j + g;
      const float bv[2] = {j < nv ? fb(k + tq, n) : 0.f,
                           j < nv ? fb(k + tq + 4, n) : 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        bh[j][i] = SB ? tf32_bits(bv[i]) : __float_as_uint(bv[i]);
        bl[j][i] = SB ? tf32_bits(bv[i] - __uint_as_float(bh[j][i])) : 0u;
      }
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      if (SA) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if (j < nv) mma_tf32(acc[mi][j], al[mi], bh[j]);
      }
      if (SB) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if (j < nv) mma_tf32(acc[mi][j], ah[mi], bl[j]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nv) mma_tf32(acc[mi][j], ah[mi], bh[j]);
    }
  }
}
template <int NT, bool SA, bool SB, typename FA, typename FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], FA fa, FB fb,
                                         int m0, int n0, int nv, int k0,
                                         int k1) {
  warp_mma_rows<1, NT, SA, SB>(reinterpret_cast<float(&)[1][NT][4]>(acc), fa,
                               fb, m0, n0, nv, k0, k1);
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// Sum v over the lanes of one accumulator row (the 4 lanes of a group).
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
// Sum v over the 8 groups of a warp (one accumulator column's rows).
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// Warp 0: the inclusive cumsum of la over the chunk, two positions a lane,
// by K3's scan; writes cum, e_t = exp(cum_t) and, where given, dt and f_t =
// exp(cum_end - cum_t) for t < qp (e, f and dt 0 past q); returns cum_end.
__device__ __forceinline__ float scan_chunk(const float* la, const float* dt,
                                            long long t0, int H, int h,
                                            int q, int qp, float* cum,
                                            float* dtv, float* ecum,
                                            float* fdec) {
  const int lane = threadIdx.x & 31;
  float lar[2], dtr[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = 2 * lane + e;
    const long long off = (t0 + t) * H + h;
    lar[e] = t < q ? la[off] : 0.f;
    dtr[e] = t < q && dt != nullptr ? dt[off] : 0.f;
  }
  const float pair = lar[0] + lar[1];
  float incl = pair;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float nb = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += nb;
  }
  const float excl = incl - pair;
  const float ca = excl + lar[0], cb = excl + lar[0] + lar[1];
  const float cum_end = __shfl_sync(0xffffffffu, (q - 1) & 1 ? cb : ca,
                                    (q - 1) >> 1);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = 2 * lane + e;
    const float cv = e ? cb : ca;
    if (t < qp) {
      if (cum != nullptr) cum[t] = cv;
      ecum[t] = t < q ? expf(cv) : 0.f;
      if (dtv != nullptr) dtv[t] = dtr[e];
      if (fdec != nullptr) fdec[t] = t < q ? expf(cum_end - cv) : 0.f;
    }
  }
  return cum_end;
}

// d min(li, 0) / d li: 1 under 0, 1/2 at a tie, 0 above.
__device__ __forceinline__ float dmin(float li) {
  return li < 0.f ? 1.f : (li == 0.f ? 0.5f : 0.f);
}

// (1) Grid (ceil(P / 16), heads, batch): G of 16 rows of P of one head
// from the last chunk back, written to gbuf for every chunk.  Warp w owns
// n-tiles [w ntw, (w + 1) ntw) of the (16, N) rows.
template <typename T, int QP, int NP, int MT>
__global__ void __launch_bounds__(kStateThreads)
ssd_bwd_state_kernel(const T* __restrict__ c, const float* __restrict__ la,
                     const float* __restrict__ dy,
                     const float* __restrict__ decay,
                     const float* __restrict__ dstate,
                     float* __restrict__ gbuf, int S, int H, int P, int N,
                     int q) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kStages = state_stages(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  const StateLayout L = state_layout_p(QP ? QP : round16(q),
                                       NP ? NP : round16(N), sizeof(T), MT);
  float* ecum = reinterpret_cast<float*>(smem + L.e);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int p0 = blockIdx.x * 16 * MT, h = blockIdx.y, bz = blockIdx.z;
  const int rows = min(16 * MT, P - p0), n_chunks = S / q;
  const long long PN = (long long)P * N;
  const int nt = L.np / 8, ntw = (nt + kStateWarps - 1) / kStateWarps;
  const int n0 = warp * ntw * 8, nv = max(0, min(ntw, nt - warp * ntw));
  const int qp = L.qp, ldc = L.ldc, ldy = L.ldy;

  for (int i = tid; i < static_cast<int>(L.e / 16); i += kStateThreads)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float acc[MT][kNtState][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < kNtState; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 16 * mi + g + 8 * (e >> 1);
        const int n = n0 + 8 * j + 2 * tq + (e & 1);
        acc[mi][j][e] = j < nv && p < rows && n < N && dstate != nullptr
                            ? dstate[((long long)bz * H + h) * PN +
                                     (long long)(p0 + p) * N + n]
                            : 0.f;
      }
  __syncthreads();
  // chunk ic lands in stage (n_chunks - 1 - ic) % kStages, kStages - 1
  // chunks ahead of its use; one cp.async group a chunk (empty past
  // chunk 1, whose U is the last needed)
  auto base = [&](int ic) {
    return smem + ((n_chunks - 1 - ic) % kStages) * L.stage;
  };
  auto stage_chunk = [&](int ic) {
    if (ic >= 1) {
      const long long t0 = (long long)bz * S + (long long)ic * q;
      unsigned char* st = base(ic);
      stage(reinterpret_cast<T*>(st + L.c), ldc, c + t0 * N, N, q, N, tid,
            kStateThreads);
      stage(reinterpret_cast<float*>(st + L.y), ldy,
            dy + (t0 * H + h) * (long long)P + p0, (long long)H * P, q,
            rows, tid, kStateThreads);
      if (warp == 0)          // each lane the two positions it scans
        for (int t = 2 * lane; t < min(q, 2 * lane + 2); ++t)
          cp_async(reinterpret_cast<float*>(st + L.l) + t,
                   la + (t0 + t) * H + h, 4);
    }
    cp_commit();
  };
  for (int k = 1; k < kStages; ++k) stage_chunk(n_chunks - k);
  for (int ic = n_chunks - 1; ic >= 0; --ic) {
    float* out = gbuf + (((long long)bz * n_chunks + ic) * H + h) * PN;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < kNtState; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int p = 16 * mi + g + 8 * (e >> 1), n = n0 + 8 * j + 2 * tq;
          float* o = out + (long long)(p0 + p) * N + n;
          if (j < nv && p < rows && n < N) {
            if (N % 2 == 0) {
              *reinterpret_cast<float2*>(o) =
                  make_float2(acc[mi][j][e], acc[mi][j][e + 1]);
            } else {
              o[0] = acc[mi][j][e];
              if (n + 1 < N) o[1] = acc[mi][j][e + 1];
            }
          }
        }
    if (ic == 0) break;
    stage_chunk(ic - (kStages - 1));
    cp_wait<kStages - 1>();
    const unsigned char* st = base(ic);
    if (warp == 0)
      scan_chunk(reinterpret_cast<const float*>(st + L.l), nullptr, 0, 1, 0,
                 q, qp, nullptr, nullptr, ecum, nullptr);
    __syncthreads();
    const float d = decay[((long long)bz * n_chunks + ic) * H + h];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < kNtState; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] *= d;
    // U[p][n] = sum_t (e_t dy[t][p]) c[t][n]
    const float* ys = reinterpret_cast<const float*>(st + L.y);
    const T* cs = reinterpret_cast<const T*>(st + L.c);
    warp_mma_rows<MT, kNtState, true, kSplit>(
        acc, [&](int m, int k) { return ecum[k] * ys[k * ldy + m]; },
        [&](int k, int n) { return to_f32(cs[k * ldc + n]); }, 0, n0, nv, 0,
        qp);
    __syncthreads();                      // before the stage is refilled
  }
  cp_wait<0>();                           // no copy outlives the block
}

// (2) Grid (chunks, head groups, batch): see the design comment.  gsrc is
// G (gbuf, (B, n_chunks, H, P, N)) for several chunks, else dS (B, H, P, N)
// or null; sprev (K3's entering states) is null for one chunk.  pdb, pdc
// (groups, B, S, N) take the head group's db and dc.
template <typename T, int QP, int PP, int NP>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_grad_kernel(const T* __restrict__ x, const T* __restrict__ b,
                    const T* __restrict__ c, const float* __restrict__ la,
                    const float* __restrict__ dt,
                    const float* __restrict__ dy,
                    const float* __restrict__ gsrc,
                    const float* __restrict__ sprev, T* __restrict__ dx,
                    float* __restrict__ dla, float* __restrict__ ddt,
                    float* __restrict__ pdb, float* __restrict__ pdc, int B,
                    int S, int H, int P, int N, int q, int hg) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const GradLayout L = grad_layout_p(QP ? QP : round16(q),
                                     PP ? PP : round16(P),
                                     NP ? NP : round16(N), sizeof(T));
  T* bs = reinterpret_cast<T*>(smem + L.b);      // (qp, ldb) b [k][n]
  T* cs = reinterpret_cast<T*>(smem + L.c);      // (qp, ldb) c [t][n]
  T* xs = reinterpret_cast<T*>(smem + L.x);      // (qp, ldx) x [k][p]
  float* dys = reinterpret_cast<float*>(smem + L.dy);   // (qp, ldy) dy [t][p]
  float* ws = reinterpret_cast<float*>(smem + L.w);     // (qp, ldw) W, dCB
  // per-position vectors of head h in set (h - h0) & 1: cum, dt, e_t, f_t
  // (qp each), exp(cum_end)
  float* vecs = reinterpret_cast<float*>(smem + L.vec);
  const int vset = 4 * L.qp + 4;
  float* colq = reinterpret_cast<float*>(smem + L.part);  // (4, qp) sum_t Q
  float* colm = colq + 4 * L.qp;                        // (4, qp) Q m
  float* rowm = colm + 4 * L.qp;                        // (chunks, qp)
  float* rpart = rowm + kPartRows;                      // (chunks, qp)
  float* ipart = rpart + kPartRows;                     // (chunks, qp)
  float* ddpart = ipart + kPartRows;                    // (kWarps)
  float* dcum = reinterpret_cast<float*>(smem + L.dcum);  // (qp)
  float* fdr = dcum + L.qp;                             // (qp)
  float* gs = reinterpret_cast<float*>(smem + L.g);     // (pp, ldg) G_c
  float* ss = reinterpret_cast<float*>(smem + L.s);     // (pp, lds) s_{c-1}

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int ic = blockIdx.x, grp = blockIdx.y, bz = blockIdx.z;
  const int n_chunks = S / q;
  const int h0 = grp * hg, h1 = min(H, h0 + hg);
  const long long t0 = (long long)bz * S + (long long)ic * q;
  const long long PN = (long long)P * N;
  const bool inter = ic > 0 && sprev != nullptr;   // s_{c-1} is not 0

  const bool has_g = gsrc != nullptr;
  const int qp = L.qp, pp = L.pp, np = L.np;
  const int ldb = L.ldb, ldx = L.ldx, ldy = L.ldy, ldg = L.ldg;
  const int lds = L.lds, ldw = L.ldw;
  const Tiles tqq = tiles_of(qp, qp, kNtQQ), tqp = tiles_of(qp, pp, kNtQP);
  const Tiles tqn = tiles_of(qp, np, kNtQN);
  // this warp's tiles of each output (mi < 0: none)
  const bool wqq = warp < tqq.mt * tqq.cpr, wqp = warp < tqp.mt * tqp.cpr;
  const bool wqn = warp < tqn.mt * tqn.cpr;
  const int qq_m0 = wqq ? warp / tqq.cpr * 16 : 0;
  const int qq_ch = wqq ? warp % tqq.cpr : 0, qq_n0 = qq_ch * tqq.ntw * 8;
  // n-tiles of the (q, q) outputs: up to the diagonal
  const int qq_nv = wqq ? max(0, min(min(tqq.ntw, tqq.nt - qq_ch * tqq.ntw),
                                     (qq_m0 + 15) / 8 - qq_ch * tqq.ntw + 1))
                        : 0;
  const int qq_nw = wqq ? min(tqq.ntw, tqq.nt - qq_ch * tqq.ntw) : 0;
  const int qp_m0 = wqp ? warp / tqp.cpr * 16 : 0;
  const int qp_ch = wqp ? warp % tqp.cpr : 0, qp_n0 = qp_ch * tqp.ntw * 8;
  const int qp_nv = wqp ? min(tqp.ntw, tqp.nt - qp_ch * tqp.ntw) : 0;
  const int qn_m0 = wqn ? warp / tqn.cpr * 16 : 0;
  const int qn_ch = wqn ? warp % tqn.cpr : 0, qn_n0 = qn_ch * tqn.ntw * 8;
  const int qn_nv = wqn ? min(tqn.ntw, tqn.nt - qn_ch * tqn.ntw) : 0;

  for (int i = tid; i < static_cast<int>(L.zero_end / 16); i += kThreads)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // a head's operands by cp.async from warps 1..15: warp 0 meanwhile
  // finishes the previous head
  const int st = tid - 32, nst = kThreads - 32;
  // x and G_c (free after phase B1), then dy and s_{c-1} (after B2)
  auto stage_xg = [&](int h) {
    if (warp > 0) {
      stage(xs, ldx, x + (t0 * H + h) * (long long)P, (long long)H * P, q, P,
            st, nst);
      if (has_g)
        stage(gs, ldg,
              gsrc + ((n_chunks > 1 ? (long long)bz * n_chunks + ic
                                    : (long long)bz) * H + h) * PN,
              N, P, N, st, nst);
    }
    cp_commit();
  };
  auto stage_ys = [&](int h) {
    if (warp > 0) {
      stage(dys, ldy, dy + (t0 * H + h) * (long long)P, (long long)H * P, q,
            P, st, nst);
      if (inter)
        stage(ss, lds,
              sprev + (((long long)bz * n_chunks + ic) * H + h) * PN, N, P,
              N, st, nst);
    }
    cp_commit();
  };
  auto scan_head = [&](int h) {            // by one warp
    float* v = vecs + ((h - h0) & 1) * vset;
    const float cum_end = scan_chunk(la, dt, t0, H, h, q, qp, v, v + qp,
                                     v + 2 * qp, v + 3 * qp);
    if (lane == 0) v[4 * qp] = expf(cum_end);
  };

  stage(bs, ldb, b + t0 * N, N, q, N, tid, kThreads);
  stage(cs, ldb, c + t0 * N, N, q, N, tid, kThreads);
  stage_xg(h0);
  stage_ys(h0);
  if (warp == 0) scan_head(h0);
  cp_wait<0>();
  __syncthreads();

  // C B^T [t][k] = sum_n c[t][n] b[k][n], in registers beside dW's tiles
  float cbr[kNtQQ][4], dcbr[kNtQQ][4];
  zero_acc(cbr);
  zero_acc(dcbr);
  if (wqq)
    warp_mma<kNtQQ, kSplit, kSplit>(
        cbr, [&](int m, int k) { return to_f32(cs[m * ldb + k]); },
        [&](int k, int n) { return to_f32(bs[n * ldb + k]); }, qq_m0, qq_n0,
        qq_nv, 0, np);
  // the (q, N) tiles summed over the heads: f dt x G (db), e dy^T s (dc)
  float adb[kNtQN][4], adc[kNtQN][4];
  zero_acc(adb);
  zero_acc(adc);

  for (int h = h0; h < h1; ++h) {
    const float* cum = vecs + ((h - h0) & 1) * vset;
    const float* dtv = cum + qp;
    const float* ecum = dtv + qp;
    const float* fdec = ecum + qp;
    const float* scal = fdec + qp;                      // exp(cum_end)
    // -- phase A: dW = dy x^T; W, Q and dCB on the lower triangle; Q's
    //    column and row sums; d(decay) = sum G * s
    if (wqq) {
      float acc[kNtQQ][4];
      zero_acc(acc);
      warp_mma<kNtQQ, true, kSplit>(
          acc, [&](int m, int k) { return dys[m * ldy + k]; },
          [&](int k, int n) { return to_f32(xs[n * ldx + k]); }, qq_m0,
          qq_n0, qq_nv, 0, pp);
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kNtQQ; ++j) {
        float cq[2] = {0.f, 0.f}, cm[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = qq_m0 + g + 8 * (e >> 1);
          const int k = qq_n0 + 8 * j + 2 * tq + (e & 1);
          float w = 0.f;
          if (j < qq_nv && k <= t && t < q) {
            const float li = cum[t] - cum[k];
            const float d = expf(fminf(li, 0.f));
            const float cb = cbr[j][e], dv = acc[j][e];
            w = cb * d * dtv[k];
            dcbr[j][e] += dv * d * dtv[k];
            const float qv = dv * d * cb;
            cq[e & 1] += qv;
            if (k < t) {
              const float m = dmin(li);
              cm[e & 1] += qv * m;
              rs[e >> 1] += qv * dtv[k] * m;
            }
          }
          if (j < qq_nw) ws[t * ldw + k] = w;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sq = col_sum(cq[e]), sm = col_sum(cm[e]);
          const int k = qq_n0 + 8 * j + 2 * tq + e;
          if (j < qq_nw && g == 0) {
            colq[(qq_m0 / 16) * qp + k] = sq;
            colm[(qq_m0 / 16) * qp + k] = sm;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = row_sum(rs[e]);
        if (tq == 0) rowm[qq_ch * qp + qq_m0 + g + 8 * e] = v;
      }
    }
    if (inter) {
      float part = 0.f;
      const int n4 = np / 4;
      for (int i = tid; i < pp * n4; i += kThreads) {
        const int p = i / n4, n = 4 * (i - p * n4);
        const float4 gv = *reinterpret_cast<const float4*>(gs + p * ldg + n);
        const float4 sv = *reinterpret_cast<const float4*>(ss + p * lds + n);
        part += gv.x * sv.x + gv.y * sv.y + gv.z * sv.z + gv.w * sv.w;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) ddpart[warp] = part;
    }
    __syncthreads();

    // -- phase B1: G b^T and the row sums of r_k = x_k . (G b_k); db +=
    //    f dt x G.  Then x and G are free: the next head's land under B2.
    float a2[kNtQP][4];
    zero_acc(a2);
    if (wqp) {
      if (has_g)
        warp_mma<kNtQP, kSplit, true>(
            a2, [&](int m, int k) { return to_f32(bs[m * ldb + k]); },
            [&](int k, int n) { return gs[n * ldg + k]; }, qp_m0, qp_n0,
            qp_nv, 0, np);
      float rr[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kNtQP; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = qp_m0 + g + 8 * (e >> 1);
          const int p = qp_n0 + 8 * j + 2 * tq + (e & 1);
          if (j < qp_nv) rr[e >> 1] += to_f32(xs[k * ldx + p]) * a2[j][e];
        }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = row_sum(rr[e]);
        if (tq == 0) rpart[qp_ch * qp + qp_m0 + g + 8 * e] = v;
      }
    }
    if (wqn && has_g) {
      float tmp[kNtQN][4];
      zero_acc(tmp);
      warp_mma<kNtQN, kSplit, true>(
          tmp, [&](int m, int k) { return to_f32(xs[m * ldx + k]); },
          [&](int k, int n) { return gs[k * ldg + n]; }, qn_m0, qn_n0, qn_nv,
          0, pp);
#pragma unroll
      for (int j = 0; j < kNtQN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = qn_m0 + g + 8 * (e >> 1);
          adb[j][e] += fdec[k] * dtv[k] * tmp[j][e];
        }
    }
    __syncthreads();
    if (h + 1 < h1) stage_xg(h + 1);

    // -- phase B2: dx = W^T dy + f dt (b G^T); dc += e dy^T s and the row
    //    sums of e_t c_t . (s^T dy_t)
    if (wqp) {
      float a1[kNtQP][4];
      zero_acc(a1);
      warp_mma<kNtQP, true, true>(
          a1, [&](int m, int k) { return ws[k * ldw + m]; },
          [&](int k, int n) { return dys[k * ldy + n]; }, qp_m0, qp_n0,
          qp_nv, qp_m0, qp);
#pragma unroll
      for (int j = 0; j < kNtQP; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = qp_m0 + g + 8 * (e >> 1);
          const int p = qp_n0 + 8 * j + 2 * tq + (e & 1);
          if (j < qp_nv && k < q && p < P)
            dx[((t0 + k) * H + h) * (long long)P + p] =
                from_f32<T>(a1[j][e] + fdec[k] * dtv[k] * a2[j][e]);
        }
    }
    if (wqn && inter) {
      float tmp[kNtQN][4];
      zero_acc(tmp);
      warp_mma<kNtQN, true, true>(
          tmp, [&](int m, int k) { return dys[m * ldy + k]; },
          [&](int k, int n) { return ss[k * lds + n]; }, qn_m0, qn_n0, qn_nv,
          0, pp);
      float rr[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kNtQN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = qn_m0 + g + 8 * (e >> 1);
          const int n = qn_n0 + 8 * j + 2 * tq + (e & 1);
          const float v = ecum[t] * tmp[j][e];
          adc[j][e] += v;
          rr[e >> 1] += to_f32(cs[t * ldb + n]) * v;
        }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = row_sum(rr[e]);
        if (tq == 0) ipart[qn_ch * qp + qn_m0 + g + 8 * e] = v;
      }
    }
    __syncthreads();
    if (h + 1 < h1) stage_ys(h + 1);

    // -- phase C1: each position's sums over the warps' partials, warp w
    //    the positions w + 16 m, 8 lanes a position (partials i and i + 8,
    //    then three shuffles): ddt, f_k dt_k r_k and the gradient of cum
    {
      const int i = lane & 7, j = warp + kWarps * (lane >> 3);
      float r = 0.f, cq = 0.f, cm = 0.f, row = 0.f, in = 0.f;
      if (j < q) {
#pragma unroll
        for (int u = 0; u < 16; u += 8) {
          if (i + u < tqp.cpr) r += rpart[(i + u) * qp + j];
          if (i + u < tqq.cpr) row += rowm[(i + u) * qp + j];
          if (inter && i + u < tqn.cpr) in += ipart[(i + u) * qp + j];
        }
        if (i < tqq.mt) {
          cq = colq[i * qp + j];
          cm = colm[i * qp + j];
        }
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        r += __shfl_xor_sync(0xffffffffu, r, off);
        row += __shfl_xor_sync(0xffffffffu, row, off);
        in += __shfl_xor_sync(0xffffffffu, in, off);
        cq += __shfl_xor_sync(0xffffffffu, cq, off);
        cm += __shfl_xor_sync(0xffffffffu, cm, off);
      }
      if (i == 0 && j < q) {
        ddt[(t0 + j) * H + h] = cq + fdec[j] * r;
        fdr[j] = fdec[j] * dtv[j] * r;
        dcum[j] = row - cm * dtv[j] - fdr[j] + in;
      }
    }
    __syncthreads();

    // -- phase C2: warp 0 adds the chunk end's terms and forms dla, and
    //    warp 1 scans the next head's la into the other set of vectors
    if (warp == 0) {
      float dcv[2], fd[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = lane + 32 * e;
        dcv[e] = j < q ? dcum[j] : 0.f;
        fd[e] = j < q ? fdr[j] : 0.f;
      }
      // the chunk end's terms: sum_k f_k dt_k r_k and exp(cum_end) d(decay)
      float fs = fd[0] + fd[1];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        fs += __shfl_xor_sync(0xffffffffu, fs, off);
      float dd = 0.f;
      if (inter)
        for (int i = 0; i < kWarps; ++i) dd += ddpart[i];
      const int last = q - 1;
      if (lane == last) dcv[0] += fs + scal[0] * dd;
      if (lane + 32 == last) dcv[1] += fs + scal[0] * dd;
      // dla: the reverse cumsum of dcum within the chunk
      float s1 = dcv[1], s0 = dcv[0];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float a = __shfl_down_sync(0xffffffffu, s1, off);
        const float b0 = __shfl_down_sync(0xffffffffu, s0, off);
        if (lane + off < 32) {
          s1 += a;
          s0 += b0;
        }
      }
      const float total1 = __shfl_sync(0xffffffffu, s1, 0);
      if (lane < q) dla[(t0 + lane) * H + h] = s0 + total1;
      if (lane + 32 < q) dla[(t0 + lane + 32) * H + h] = s1;
    }
    if (warp == 1 && h + 1 < h1) scan_head(h + 1);
    if (h + 1 < h1) {
      cp_wait<0>();
      __syncthreads();
    }
  }

  // the head group's db = dCB^T C + adb and dc = dCB B + adc
  __syncthreads();                        // every head's W read
  if (wqq)
#pragma unroll
    for (int j = 0; j < kNtQQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = qq_m0 + g + 8 * (e >> 1);
        const int k = qq_n0 + 8 * j + 2 * tq + (e & 1);
        if (j < qq_nw) ws[t * ldw + k] = dcbr[j][e];
      }
  __syncthreads();
  if (wqn) {
    // dCB[t][k] is 0 for k > t: rows k of db need t >= k, rows t of dc k <= t
    warp_mma<kNtQN, true, kSplit>(
        adb, [&](int m, int k) { return ws[k * ldw + m]; },
        [&](int k, int n) { return to_f32(cs[k * ldb + n]); }, qn_m0, qn_n0,
        qn_nv, qn_m0, qp);
    warp_mma<kNtQN, true, kSplit>(
        adc, [&](int m, int k) { return ws[m * ldw + k]; },
        [&](int k, int n) { return to_f32(bs[k * ldb + n]); }, qn_m0, qn_n0,
        qn_nv, 0, qn_m0 + 16);
#pragma unroll
    for (int j = 0; j < kNtQN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = qn_m0 + g + 8 * (e >> 1);
        const int n = qn_n0 + 8 * j + 2 * tq + (e & 1);
        if (j < qn_nv && row < q && n < N) {
          const long long o =
              (((long long)grp * B + bz) * S + (long long)ic * q + row) * N + n;
          pdb[o] = adb[j][e];
          pdc[o] = adc[j][e];
        }
      }
  }
}

// (3) db and dc: the head groups' partials summed in group order.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
ssd_bwd_sum_kernel(const float* __restrict__ pdb,
                   const float* __restrict__ pdc, T* __restrict__ db,
                   T* __restrict__ dc, long long total, int groups) {
  const long long i = (long long)blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= total) return;
  float sb = 0.f, sc = 0.f;
  for (int g = 0; g < groups; ++g) {
    sb += pdb[g * total + i];
    sc += pdc[g * total + i];
  }
  db[i] = from_f32<T>(sb);
  dc[i] = from_f32<T>(sc);
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= (size_t)kDefaultSmem) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int QP, int NP, int MT>
int launch_state(const void* c, const float* la, const float* dy,
                 const float* decay, const float* dstate, float* gbuf, int B,
                 int S, int H, int P, int N, int q, cudaStream_t stream) {
  const size_t smem = (size_t)state_layout(q, N, sizeof(T), MT).total;
  const int rc = allow_smem(ssd_bwd_state_kernel<T, QP, NP, MT>, smem);
  if (rc) return rc;
  ssd_bwd_state_kernel<T, QP, NP, MT>
      <<<dim3((P + 16 * MT - 1) / (16 * MT), H, B), kStateThreads, smem,
         stream>>>(static_cast<const T*>(c), la, dy, decay, dstate, gbuf, S,
                   H, P, N, q);
  return (int)cudaGetLastError();
}

// The kernels for dims padded to (QP, PP, NP), the widths the models run
// (constants), else 0: read at run time; mt m-tiles (16 rows of P) a
// block of the state kernel.
template <typename T, int QP, int PP, int NP>
int launch_dims(const void* x, const void* b, const void* c, const float* la,
                const float* dt, const float* dy, const float* dstate,
                const float* zbuf, const float* decay, float* gbuf, void* dx,
                void* db, void* dc, float* dla, float* ddt, float* pdb,
                float* pdc, int B, int S, int H, int P, int N, int q, int hg,
                int mt, cudaStream_t stream) {
  const int n_chunks = S / q, groups = (H + hg - 1) / hg;
  int rc;
  if (n_chunks > 1) {
    rc = mt == 4 ? launch_state<T, QP, NP, 4>(c, la, dy, decay, dstate, gbuf,
                                              B, S, H, P, N, q, stream)
         : mt == 2 ? launch_state<T, QP, NP, 2>(c, la, dy, decay, dstate,
                                                gbuf, B, S, H, P, N, q, stream)
                   : launch_state<T, QP, NP, 1>(c, la, dy, decay, dstate,
                                                gbuf, B, S, H, P, N, q, stream);
    if (rc) return rc;
  }
  const size_t smem = (size_t)grad_layout(q, P, N, sizeof(T)).total;
  rc = allow_smem(ssd_bwd_grad_kernel<T, QP, PP, NP>, smem);
  if (rc) return rc;
  ssd_bwd_grad_kernel<T, QP, PP, NP>
      <<<dim3(n_chunks, groups, B), kThreads, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(b),
          static_cast<const T*>(c), la, dt, dy, n_chunks > 1 ? gbuf : dstate,
          n_chunks > 1 ? zbuf : nullptr, static_cast<T*>(dx), dla, ddt, pdb,
          pdc, B, S, H, P, N, q, hg);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const long long total = (long long)B * S * N;
  ssd_bwd_sum_kernel<T><<<(unsigned)((total + kSumThreads - 1) / kSumThreads),
                          kSumThreads, 0, stream>>>(
      pdb, pdc, static_cast<T*>(db), static_cast<T*>(dc), total, groups);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* b, const void* c, const float* la,
           const float* dt, const float* dy, const float* dstate,
           const float* zbuf, const float* decay, float* gbuf, void* dx,
           void* db, void* dc, float* dla, float* ddt, float* pdb, float* pdc,
           int B, int S, int H, int P, int N, int q, int hg, int mt,
           cudaStream_t stream) {
  const int qp = round16(q), pp = round16(P), np = round16(N);
  if (qp == 64 && pp == 64 && np == 128)        // mamba2-370m
    return launch_dims<T, 64, 64, 128>(x, b, c, la, dt, dy, dstate, zbuf,
                                       decay, gbuf, dx, db, dc, dla, ddt, pdb,
                                       pdc, B, S, H, P, N, q, hg, mt, stream);
  if (qp == 64 && pp == 64 && np == 16)         // hymba-1.5b
    return launch_dims<T, 64, 64, 16>(x, b, c, la, dt, dy, dstate, zbuf,
                                      decay, gbuf, dx, db, dc, dla, ddt, pdb,
                                      pdc, B, S, H, P, N, q, hg, mt, stream);
  return launch_dims<T, 0, 0, 0>(x, b, c, la, dt, dy, dstate, zbuf, decay,
                                 gbuf, dx, db, dc, dla, ddt, pdb, pdc, B, S,
                                 H, P, N, q, hg, mt, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, b, c and dx, db, dc; la, dt, dy,
// dstate, dla, ddt are float32).  hg heads a block of the grad kernel; mt
// (1, 2 or 4) m-tiles of 16 rows of P a block of the state kernel.
// With S > q: zbuf (B, S / q, H, P, N) holds the state entering each chunk
// and decay (B, S / q, H) each chunk's exp(cum_end), as K3 left them, and
// gbuf (B, S / q, H, P, N) is scratch.  pdb and pdc (ceil(H / hg), B, S, N)
// are scratch.  dstate may be null (zero).  A call is three launches for
// S > q, else two.  Returns 0 on success, -1 for an unsupported argument,
// else the cudaError_t of a launch.
int mars_ssd_scan_bwd(int dtype, const void* x, const void* b, const void* c,
                      const float* la, const float* dt, const float* dy,
                      const float* dstate, const float* zbuf,
                      const float* decay, float* gbuf, void* dx, void* db,
                      void* dc, float* dla, float* ddt, float* pdb,
                      float* pdc, int B, int S, int H, int P, int N, int q,
                      int hg, int mt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q < 1 || q > kMaxChunk || S % q != 0 || hg < 1 || B < 1 ||
      B > 65535 || H < 1 || H > 65535 || P < 1 || P > kMaxP || N < 1 ||
      N > kMaxN || (H + hg - 1) / hg > 65535 || (dtype != 0 && dtype != 1) ||
      (mt != 1 && mt != 2 && mt != 4))
    return -1;
  const int es = dtype == 0 ? 4 : 2;
  if (grad_layout(q, P, N, es).total > kMaxSmem ||
      state_layout(q, N, es, mt).total > kMaxSmem)
    return -1;
  const int qp = round16(q), pp = round16(P), np = round16(N);
  const Tiles ts[3] = {tiles_of(qp, qp, kNtQQ), tiles_of(qp, pp, kNtQP),
                       tiles_of(qp, np, kNtQN)};
  for (const Tiles& t : ts)
    if (t.mt * t.cpr > kWarps) return -1;
  if ((np / 8 + kStateWarps - 1) / kStateWarps > kNtState) return -1;
  if (S != q && (zbuf == nullptr || decay == nullptr || gbuf == nullptr))
    return -1;
  if (dtype == 0)
    return launch<float>(x, b, c, la, dt, dy, dstate, zbuf, decay, gbuf, dx,
                         db, dc, dla, ddt, pdb, pdc, B, S, H, P, N, q, hg, mt,
                         s);
  return launch<__nv_bfloat16>(x, b, c, la, dt, dy, dstate, zbuf, decay, gbuf,
                               dx, db, dc, dla, ddt, pdb, pdc, B, S, H, P, N,
                               q, hg, mt, s);
}

const char* mars_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
