// Backward of blockwise (flash) attention for Hopper (sm_90a), plain C
// interface.
//
// The JAX package has no Pallas kernel here: its trainer differentiates
// plain `layers.sdpa` with `jax.value_and_grad`
// (src/repro/train/step.py:47).  The port's forward runs the hand-written
// K5 (csrc/flash_attention.cu) outside autograd, so its gradient is this
// kernel (B5).  Per (batch b, head h), with q (B, Sq, H, D), k, v (B, Sk,
// H, D), the forward's o, its saved row log-sum-exp lse (B, H, Sq, f32)
// and the incoming do (B, Sq, H, D), all contiguous and of one dtype
// (float32 or bfloat16), and scale 1/sqrt(D):
//   s = scale q k^T (masked), p = exp(s - lse), delta_i = sum_d do_id o_id,
//   dv = p^T do, dp = do v^T, ds = p (dp - delta),
//   dq = scale ds k, dk = scale ds^T q,
// every sum in f32, dq, dk, dv written in the input dtype.  In bfloat16
// the products run on the tensor cores, so p is rounded to bf16 before
// p^T do and ds (from the unrounded p) before ds k and ds^T q: the
// operands of a bf16 product; float32 rounds nothing.  `causal` keeps key
// <= query and needs Sq == Sk; without it any Sq and Sk (whisper's
// cross-attention).  Head dims 16 (the MoE smoke configs: one k-step,
// two n8 tiles a row, 48-byte padded rows), 64 and 128.
//
// Bound.  The five products of a (query, key) pair the mask keeps take
// 10 D operations (q.k, do.v, p^T do, ds k, ds^T q).  qwen1.5-0.5b's
// layer at batch 8 x 512 (16 heads of 64, causal) keeps 16.8 M pairs,
// 10.8 GFLOP: 11 us at the tensor cores' 989 TFLOP/s, while its q, k, v,
// o, do, dq, dk, dv are 67 MB in bf16, 20 us at 3.35 TB/s, so bytes bind;
// whisper-base's encoder (8 x 1500, 8 heads, no mask) does 92 GFLOP over
// 98 MB, so operations do (93 us).  On CUDA cores in f32 (67 TFLOP/s)
// operations bind both.
//
// Design (FlashAttention-2's backward).  Three kernels, one launch each,
// no atomics, so the result is the same bit for bit from run to run:
//   1. pre-pass: delta = rowsum(do o) in f32, D / 8 threads a row, each
//      reading 8 contiguous values of o and do: bytes-bound, o and do
//      read once.  The row log-sum-exp is K5's (its `lse` output, saved
//      by the forward), not recomputed here;
//   2. dk/dv, one block a 64-key tile: dk and dv stay in registers while
//      the block walks the query tiles (in causal mode from the key
//      tile's own diagonal on: earlier query tiles keep no key of it);
//   3. dq, one block a 64-query tile: dq stays in registers while the
//      block walks the key tiles (in causal mode up to its diagonal, the
//      longest walks scheduled first).
// In causal mode only the diagonal tile is masked.
//
// bfloat16 (the `tc` kernels): 4 warps a block, each owning 16 rows of
// the block's tile (keys in 2, queries in 3).  Tiles stay bf16 in shared
// memory, rows padded to D + 8 values (144 or 272 bytes: the 8 rows an
// ldmatrix reads fall in 8 distinct 16-byte bank groups, with or without
// .trans, as in K5's 16-row kernel), and the walked operand is double-
// buffered with cp.async: the next tile (and its rows' lse and delta)
// loads while this one computes.  Every product is mma.sync m16n8k16
// bf16 -> f32 with fragments from ldmatrix, 32 queries (keys) a step:
//   dk/dv: S^T = K Q^T and dP^T = V dO^T (K, V the A operands, Q, dO read
//   as B), P^T = exp2(S^T scale log2 e - lse log2 e) and dS^T = P^T o
//   (dP^T - delta) in registers; the m16n8 accumulators of P^T and dS^T
//   are, packed to bf16, the A fragments of dV += P^T dO and dK += dS^T
//   Q, whose B operands dO and Q are read with ldmatrix.trans: no shared
//   memory round trip;
//   dq: S = Q K^T and dP = dO V^T, then dQ += dS K (K with .trans).
// Shared memory: 6 tiles of 64 x (D + 8) bf16 and 512 bytes of lse and
// delta: 56 KB at D 64 (3 dK/dV blocks an SM at 168 registers a thread,
// 4 dQ blocks at 128), 105 KB at D 128 (2 of each).  At D 64 the A
// fragments of the block's own tile (K and V, or Q and dO) stay in
// registers; at D 128 they are re-read each step.
// Against PR 22's kernels this answers the three costs they had: f32
// products on CUDA cores (67 TFLOP/s) become bf16 tensor-core products;
// padded f32 tiles of 100-166 KB a block (one block an SM) become bf16
// tiles of 56/105 KB; the pre-pass no longer walks every key tile to
// rebuild the lse.  wgmma tiles are the way on to the bound.
//
// float32 (the `f32` kernels; the float32 training step on the card must
// equal the CPU's, which TF32 would break): CUDA cores.  Every tile is
// staged in shared memory as f32 with rows padded to D + 1 floats, so a
// warp's column reads fall in distinct banks; 256 threads as a 16 x 16
// grid each own a 4 x 4 patch of a 64 x 64 product (4 x D/16 of a 64 x D
// one).  Shared memory: dk/dv 4 tiles of 64 x (D + 1) plus p and ds (100
// KB at D 64, 166 KB at D 128).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // rows of a query tile and of a key tile
constexpr float kLog2e = 1.4426950408889634f;

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

struct Dims {
  int B, H, Sq, Sk, causal;
  float scale;
};

__device__ __forceinline__ bool kept(const Dims& g, int qi, int kj) {
  return qi < g.Sq && kj < g.Sk && (!g.causal || kj <= qi);
}

// --- 1. pre-pass: delta = rowsum(do o) -----------------------------------
constexpr int kDeltaThreads = 256;

// Eight contiguous values of a row from global memory, as f32.
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
}

// Rows are the (b, s, h) of o and do in memory order, D values each;
// delta goes to (b, h, s).
template <typename T, int D>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int H, int Sq,
                       long long rows) {
  constexpr int G = D / 8;                   // threads a row (2, 8 or 16)
  const long long t = (long long)blockIdx.x * kDeltaThreads + threadIdx.x;
  const long long row = t / G;
  const int part = (int)(t - row * G);
  float acc = 0.f;
  if (row < rows) {
    float a[8], c[8];
    load8(o + row * D + part * 8, a);
    load8(dout + row * D + part * 8, c);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = fmaf(a[i], c[i], acc);
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0 && row < rows) {
    const long long bs = row / H;
    const int h = (int)(row - bs * H);
    const long long b = bs / Sq;
    const int s = (int)(bs - b * Sq);
    delta[(b * H + h) * Sq + s] = acc;
  }
}

// --- bfloat16: mma.sync tiles --------------------------------------------
namespace tc {

constexpr int kThreads = 128;    // 4 warps, 16 rows of the block's tile each
constexpr int kStep = 32;        // queries (keys) of the walked tile a step

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
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
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
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
// The A fragment of the 16 columns 16 kc .. of a 16-row m16n8 accumulator
// tile pair (the accumulator layout is the A layout), rounded to bf16.
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&lo)[4],
                                     const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Fragment addresses in a tile of rows of `P` bf16 (lane's part of an x4
// ldmatrix).  A: rows r0 .. r0 + 15, columns c0 .. c0 + 15 of a row-major
// M x K tile.  B: for a product with Y^T, rows n0 .. n0 + 15 of Y (N x K),
// columns c0 ..: regs 0, 1 are the n8 tile n0 .., 2, 3 the tile n0 + 8.
// Bt (with .trans): rows k0 .. k0 + 15 of Y (K x N), columns c0 .. c0 +
// 15: regs 0, 1 the n8 tile c0 .., 2, 3 the tile c0 + 8.
template <int P>
__device__ __forceinline__ const __nv_bfloat16* a_at(
    const __nv_bfloat16* t, int r0, int c0, int lane) {
  const int mat = lane >> 3;
  return t + (r0 + (mat & 1) * 8 + (lane & 7)) * P + c0 + (mat >> 1) * 8;
}
template <int P>
__device__ __forceinline__ const __nv_bfloat16* b_at(
    const __nv_bfloat16* t, int n0, int c0, int lane) {
  const int mat = lane >> 3;
  return t + (n0 + (mat >> 1) * 8 + (lane & 7)) * P + c0 + (mat & 1) * 8;
}
template <int P>
__device__ __forceinline__ const __nv_bfloat16* bt_at(
    const __nv_bfloat16* t, int k0, int c0, int lane) {
  return a_at<P>(t, k0, c0, lane);
}

template <int D>
struct Geo {
  static constexpr int kPitch = D + 8;               // padded bf16 row
  static constexpr int kTileElems = kTile * kPitch;
  // the block's two tiles, then two stages of the walked pair and of the
  // walked rows' lse and delta (dk/dv only)
  static constexpr size_t kSmem =
      (size_t)6 * kTileElems * 2 + 2 * 2 * kTile * sizeof(float);
  static constexpr bool kFragRegs = D <= 64;         // own A fragments kept
  static_assert(kSmem <= 232448, "bf16 tiles exceed 227 KB");
};

// Rows [s0, s0 + 64) of a (S, H, D) slice whose row stride is rs into a
// padded tile by cp.async; rows at or past S are zeros (a zero operand,
// never a stale one, meets the products).
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long rs, int s0, int S) {
  constexpr int kChunks = D / 8;
  constexpr int P = Geo<D>::kPitch;
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks, dc = (c - r * kChunks) * 8;
    __nv_bfloat16* d = dst + r * P + dc;
    if (s0 + r < S)
      cp_async16(d, src + (long long)(s0 + r) * rs + dc);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// --- 2. dk and dv, one block a key tile ----------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, Dims g) {
  using G = Geo<D>;
  constexpr int P = G::kPitch;
  constexpr int kK = D / 16;                 // k-steps over the head dim
  constexpr int kN = D / 8;                  // n8 tiles of a D-wide row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + G::kTileElems;
  __nv_bfloat16* stage0 = Vs + G::kTileElems;          // Q, dO; Q, dO
  float* rows0 = reinterpret_cast<float*>(stage0 + 4 * G::kTileElems);

  const int bh = blockIdx.y, b = bh / g.H, h = bh - b * g.H;
  const int kt = blockIdx.x, k0 = kt * kTile;
  const long long rs = (long long)g.H * D;
  const __nv_bfloat16* qb = q + ((long long)b * g.Sq * g.H + h) * D;
  const __nv_bfloat16* ob = dout + ((long long)b * g.Sq * g.H + h) * D;
  const __nv_bfloat16* kb = k + ((long long)b * g.Sk * g.H + h) * D;
  const __nv_bfloat16* vb = v + ((long long)b * g.Sk * g.H + h) * D;
  const long long row0 = (long long)bh * g.Sq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int n_q = (g.Sq + kTile - 1) / kTile;
  const int qt0 = g.causal ? kt : 0;

  // one stage: Q and dO rows of query tile qt, their lse (+inf past Sq, so
  // p = 0 there) and delta
  auto load_stage = [&](int st, int qt) {
    __nv_bfloat16* Qs = stage0 + st * 2 * G::kTileElems;
    const int q0 = qt * kTile;
    load_rows<D>(Qs, qb, rs, q0, g.Sq);
    load_rows<D>(Qs + G::kTileElems, ob, rs, q0, g.Sq);
    float* rw = rows0 + st * 2 * kTile;
    const int r = tid & (kTile - 1), qi = q0 + r;
    float* dst = rw + (tid < kTile ? 0 : kTile) + r;
    const float* src = (tid < kTile ? lse : delta) + row0 + qi;
    if (qi < g.Sq) cp_async4(dst, src);
    else *dst = tid < kTile ? __int_as_float(0x7f800000) : 0.f;
  };

  load_rows<D>(Ks, kb, rs, k0, g.Sk);
  load_rows<D>(Vs, vb, rs, k0, g.Sk);
  if (qt0 < n_q) load_stage(0, qt0);
  cp_async_commit();

  float adk[kN][4], adv[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
  uint32_t kf[G::kFragRegs ? kK : 1][4], vf[G::kFragRegs ? kK : 1][4];
  const int kr = warp * 16;                  // this warp's key rows
  const float sl2 = g.scale * kLog2e;

  for (int qt = qt0; qt < n_q; ++qt) {
    const int st = (qt - qt0) & 1;
    if (qt + 1 < n_q) load_stage(st ^ 1, qt + 1);
    cp_async_commit();
    cp_async_wait<1>();                      // this stage (and K, V) landed
    __syncthreads();
    if (G::kFragRegs && qt == qt0) {
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        ldsm_x4(kf[kk], a_at<P>(Ks, kr, kk * 16, lane));
        ldsm_x4(vf[kk], a_at<P>(Vs, kr, kk * 16, lane));
      }
    }
    const __nv_bfloat16* Qs = stage0 + st * 2 * G::kTileElems;
    const __nv_bfloat16* Os = Qs + G::kTileElems;
    const float* lse_s = rows0 + st * 2 * kTile;
    const float* dl_s = lse_s + kTile;
    const int q0 = qt * kTile;
    const bool edge = q0 + kTile > g.Sq || k0 + kTile > g.Sk ||
                      (g.causal && qt == kt);
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += kStep) {
      // in the diagonal tile, a step of queries all before this warp's
      // keys keeps nothing
      if (g.causal && qt == kt && q0 + c0 + kStep - 1 < k0 + kr) continue;
      float s[kStep / 8][4], dp[kStep / 8][4];
#pragma unroll
      for (int n = 0; n < kStep / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      // S^T = K Q^T, dP^T = V dO^T over this step's 32 queries
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        uint32_t ka[4], va[4];
        if (G::kFragRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) ka[i] = kf[kk][i], va[i] = vf[kk][i];
        } else {
          ldsm_x4(ka, a_at<P>(Ks, kr, kk * 16, lane));
          ldsm_x4(va, a_at<P>(Vs, kr, kk * 16, lane));
        }
#pragma unroll
        for (int np = 0; np < kStep / 16; ++np) {
          uint32_t bq[4], bo[4];
          ldsm_x4(bq, b_at<P>(Qs, c0 + np * 16, kk * 16, lane));
          ldsm_x4(bo, b_at<P>(Os, c0 + np * 16, kk * 16, lane));
          mma(s[2 * np], ka, bq[0], bq[1]);
          mma(s[2 * np + 1], ka, bq[2], bq[3]);
          mma(dp[2 * np], va, bo[0], bo[1]);
          mma(dp[2 * np + 1], va, bo[2], bo[3]);
        }
      }
      // P^T and dS^T: element e of tile n is key kr + gq + 8 (e >> 1),
      // query c0 + 8 n + 2 t4 + (e & 1)
#pragma unroll
      for (int n = 0; n < kStep / 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qc = c0 + 8 * n + 2 * t4 + c;
          const float l2 = lse_s[qc] * kLog2e, dl = dl_s[qc];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + c;
            float p = exp2f(fmaf(s[n][e], sl2, -l2));
            if (edge && !kept(g, q0 + qc, k0 + kr + gq + 8 * r)) p = 0.f;
            s[n][e] = p;
            dp[n][e] = p * (dp[n][e] - dl);
          }
        }
      // dV += P^T dO, dK += dS^T Q over the step's 32 queries
#pragma unroll
      for (int kc = 0; kc < kStep / 16; ++kc) {
        uint32_t pa[4], da[4];
        to_a(pa, s[2 * kc], s[2 * kc + 1]);
        to_a(da, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
        for (int dc = 0; dc < D / 16; ++dc) {
          uint32_t bo[4], bq[4];
          ldsm_x4_t(bo, bt_at<P>(Os, c0 + kc * 16, dc * 16, lane));
          ldsm_x4_t(bq, bt_at<P>(Qs, c0 + kc * 16, dc * 16, lane));
          mma(adv[2 * dc], pa, bo[0], bo[1]);
          mma(adv[2 * dc + 1], pa, bo[2], bo[3]);
          mma(adk[2 * dc], da, bq[0], bq[1]);
          mma(adk[2 * dc + 1], da, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();                         // this stage refills next
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + kr + gq + 8 * r;
    if (kj >= g.Sk) continue;
    __nv_bfloat16* dkr = dk + ((((long long)b * g.Sk + kj) * g.H + h) * D);
    __nv_bfloat16* dvr = dv + ((((long long)b * g.Sk + kj) * g.H + h) * D);
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int col = 8 * n + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(dkr + col) = __floats2bfloat162_rn(
          adk[n][2 * r] * g.scale, adk[n][2 * r + 1] * g.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvr + col) =
          __floats2bfloat162_rn(adv[n][2 * r], adv[n][2 * r + 1]);
    }
  }
}

// --- 3. dq, one block a query tile ---------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, Dims g) {
  using G = Geo<D>;
  constexpr int P = G::kPitch;
  constexpr int kK = D / 16;
  constexpr int kN = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Os = Qs + G::kTileElems;              // dO
  __nv_bfloat16* stage0 = Os + G::kTileElems;          // K, V; K, V

  const int n_q = (g.Sq + kTile - 1) / kTile;
  const int qt = g.causal ? n_q - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int bh = blockIdx.y, b = bh / g.H, h = bh - b * g.H;
  const int q0 = qt * kTile;
  const long long rs = (long long)g.H * D;
  const __nv_bfloat16* qb = q + ((long long)b * g.Sq * g.H + h) * D;
  const __nv_bfloat16* ob = dout + ((long long)b * g.Sq * g.H + h) * D;
  const __nv_bfloat16* kb = k + ((long long)b * g.Sk * g.H + h) * D;
  const __nv_bfloat16* vb = v + ((long long)b * g.Sk * g.H + h) * D;
  const long long row0 = (long long)bh * g.Sq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int qr = warp * 16;                  // this warp's query rows
  const int n_k = g.causal ? qt + 1 : (g.Sk + kTile - 1) / kTile;

  auto load_stage = [&](int st, int kt) {
    __nv_bfloat16* Ks = stage0 + st * 2 * G::kTileElems;
    load_rows<D>(Ks, kb, rs, kt * kTile, g.Sk);
    load_rows<D>(Ks + G::kTileElems, vb, rs, kt * kTile, g.Sk);
  };
  load_rows<D>(Qs, qb, rs, q0, g.Sq);
  load_rows<D>(Os, ob, rs, q0, g.Sq);
  if (n_k > 0) load_stage(0, 0);
  cp_async_commit();

  // the thread's two rows' lse (log2 units; +inf past Sq) and delta
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + qr + gq + 8 * r;
    l2[r] = qi < g.Sq ? lse[row0 + qi] * kLog2e : __int_as_float(0x7f800000);
    dl[r] = qi < g.Sq ? delta[row0 + qi] : 0.f;
  }
  float adq[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[n][e] = 0.f;
  uint32_t qf[G::kFragRegs ? kK : 1][4], of[G::kFragRegs ? kK : 1][4];
  const float sl2 = g.scale * kLog2e;

  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_k) load_stage(st ^ 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();                      // this stage (and Q, dO) landed
    __syncthreads();
    if (G::kFragRegs && kt == 0) {
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        ldsm_x4(qf[kk], a_at<P>(Qs, qr, kk * 16, lane));
        ldsm_x4(of[kk], a_at<P>(Os, qr, kk * 16, lane));
      }
    }
    const __nv_bfloat16* Ks = stage0 + st * 2 * G::kTileElems;
    const __nv_bfloat16* Vs = Ks + G::kTileElems;
    const int k0 = kt * kTile;
    const bool edge = q0 + kTile > g.Sq || k0 + kTile > g.Sk ||
                      (g.causal && kt == qt);
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += kStep) {
      // in the diagonal tile, a step of keys all past this warp's
      // queries keeps nothing
      if (g.causal && kt == qt && k0 + c0 > q0 + qr + 15) continue;
      float s[kStep / 8][4], dp[kStep / 8][4];
#pragma unroll
      for (int n = 0; n < kStep / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      // S = Q K^T, dP = dO V^T over this step's 32 keys
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        uint32_t qa[4], oa[4];
        if (G::kFragRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[i] = qf[kk][i], oa[i] = of[kk][i];
        } else {
          ldsm_x4(qa, a_at<P>(Qs, qr, kk * 16, lane));
          ldsm_x4(oa, a_at<P>(Os, qr, kk * 16, lane));
        }
#pragma unroll
        for (int np = 0; np < kStep / 16; ++np) {
          uint32_t bk[4], bv[4];
          ldsm_x4(bk, b_at<P>(Ks, c0 + np * 16, kk * 16, lane));
          ldsm_x4(bv, b_at<P>(Vs, c0 + np * 16, kk * 16, lane));
          mma(s[2 * np], qa, bk[0], bk[1]);
          mma(s[2 * np + 1], qa, bk[2], bk[3]);
          mma(dp[2 * np], oa, bv[0], bv[1]);
          mma(dp[2 * np + 1], oa, bv[2], bv[3]);
        }
      }
      // dS: element e of tile n is query qr + gq + 8 (e >> 1), key c0 +
      // 8 n + 2 t4 + (e & 1)
#pragma unroll
      for (int n = 0; n < kStep / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = exp2f(fmaf(s[n][e], sl2, -l2[r]));
          if (edge && !kept(g, q0 + qr + gq + 8 * r,
                            k0 + c0 + 8 * n + 2 * t4 + (e & 1)))
            p = 0.f;
          dp[n][e] = p * (dp[n][e] - dl[r]);
        }
      // dQ += dS K over the step's 32 keys
#pragma unroll
      for (int kc = 0; kc < kStep / 16; ++kc) {
        uint32_t da[4];
        to_a(da, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
        for (int dc = 0; dc < D / 16; ++dc) {
          uint32_t bk[4];
          ldsm_x4_t(bk, bt_at<P>(Ks, c0 + kc * 16, dc * 16, lane));
          mma(adq[2 * dc], da, bk[0], bk[1]);
          mma(adq[2 * dc + 1], da, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();                         // this stage refills next
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + qr + gq + 8 * r;
    if (qi >= g.Sq) continue;
    __nv_bfloat16* dqr = dq + ((((long long)b * g.Sq + qi) * g.H + h) * D);
#pragma unroll
    for (int n = 0; n < kN; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dqr + 8 * n + 2 * t4) =
          __floats2bfloat162_rn(adq[n][2 * r] * g.scale,
                                adq[n][2 * r + 1] * g.scale);
  }
}

}  // namespace tc

// --- float32: CUDA cores -------------------------------------------------
namespace f32 {

constexpr int kThreads = 256;    // a 16 x 16 grid of threads
constexpr int kSq = kTile + 1;   // row stride of a 64 x 64 f32 tile

// Rows [s0, s0 + 64) of head h of batch b of a (B, S, H, D) tensor into
// shared memory as f32, row stride D + 1; rows at or past S are zeros.
template <typename T, int D>
__device__ void load_tile(float* dst, const T* __restrict__ src, int b,
                          int h, int s0, int S, int H) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int s = s0 + r;
    float x = 0.f;
    if (s < S) x = to_f(src[(((long long)b * S + s) * H + h) * D + c]);
    dst[r * (D + 1) + c] = x;
  }
}

// s = A B^T and dp = C E^T over a 64 x 64 tile: A, C query rows, B, E
// key rows, each 64 x D at stride D + 1.  Thread (ty, tx) owns rows
// ty + 16 i and columns tx + 16 j.
template <int D>
__device__ __forceinline__ void two_products(const float* A, const float* Bm,
                                             const float* C, const float* E,
                                             float (&s)[4][4],
                                             float (&dp)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], c[4], b[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[(ty + 16 * i) * (D + 1) + d];
      c[i] = C[(ty + 16 * i) * (D + 1) + d];
      b[i] = Bm[(tx + 16 * i) * (D + 1) + d];
      e[i] = E[(tx + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(c[i], e[j], dp[i][j]);
      }
  }
}

// p and ds of the thread's patch from s and dp, given the rows' lse and
// delta: p = exp(scale s - lse) where the pair is kept, else 0.
__device__ __forceinline__ void probs(const Dims& g, int q0, int k0,
                                      const float* lse_s, const float* dl_s,
                                      float (&s)[4][4], float (&dp)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float lse = lse_s[r], dl = dl_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float p = kept(g, q0 + r, k0 + c)
                          ? expf(s[i][j] * g.scale - lse) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dl);
    }
  }
}

// 2. dk and dv, one block a key tile
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, Dims g) {
  extern __shared__ float smem[];
  constexpr int kD = kTile * (D + 1);
  float* Ks = smem;
  float* Vs = Ks + kD;
  float* Qs = Vs + kD;
  float* Os = Qs + kD;                      // do
  float* Ps = Os + kD;
  float* Ds = Ps + kTile * kSq;             // ds
  float* lse_s = Ds + kTile * kSq;
  float* dl_s = lse_s + kTile;
  constexpr int J = D / 16;
  const int bh = blockIdx.y, b = bh / g.H, h = bh - b * g.H;
  const int kt = blockIdx.x, k0 = kt * kTile;
  const long long row0 = (long long)bh * g.Sq;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<T, D>(Ks, k, b, h, k0, g.Sk, g.H);
  load_tile<T, D>(Vs, v, b, h, k0, g.Sk, g.H);
  float adk[4][J], adv[4][J];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) adk[i][j] = adv[i][j] = 0.f;

  const int n_q = (g.Sq + kTile - 1) / kTile;
  for (int qt = g.causal ? kt : 0; qt < n_q; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();                        // last tile's reads are done
    load_tile<T, D>(Qs, q, b, h, q0, g.Sq, g.H);
    load_tile<T, D>(Os, dout, b, h, q0, g.Sq, g.H);
    if (threadIdx.x < kTile) {
      const int qi = q0 + threadIdx.x;
      lse_s[threadIdx.x] = qi < g.Sq ? lse[row0 + qi] : 0.f;
      dl_s[threadIdx.x] = qi < g.Sq ? delta[row0 + qi] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    two_products<D>(Qs, Ks, Os, Vs, s, dp);
    probs(g, q0, k0, lse_s, dl_s, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Ps[(ty + 16 * i) * kSq + tx + 16 * j] = s[i][j];
        Ds[(ty + 16 * i) * kSq + tx + 16 * j] = dp[i][j];
      }
    __syncthreads();
    // dv[c] += sum_r p[r][c] do[r], dk[c] += sum_r ds[r][c] q[r]: the
    // thread owns key rows ty + 16 i and columns tx + 16 j
#pragma unroll 2
    for (int r = 0; r < kTile; ++r) {
      float p[4], ds[4], ov[J], qv[J];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Ps[r * kSq + ty + 16 * i];
        ds[i] = Ds[r * kSq + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        ov[j] = Os[r * (D + 1) + tx + 16 * j];
        qv[j] = Qs[r * (D + 1) + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          adv[i][j] = fmaf(p[i], ov[j], adv[i][j]);
          adk[i][j] = fmaf(ds[i], qv[j], adk[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= g.Sk) continue;
    const long long base = (((long long)b * g.Sk + kj) * g.H + h) * D;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      dk[base + tx + 16 * j] = from_f<T>(adk[i][j] * g.scale);
      dv[base + tx + 16 * j] = from_f<T>(adv[i][j]);
    }
  }
}

// 3. dq, one block a query tile
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Dims g) {
  extern __shared__ float smem[];
  constexpr int kD = kTile * (D + 1);
  float* Qs = smem;
  float* Os = Qs + kD;                      // do
  float* Ks = Os + kD;
  float* Vs = Ks + kD;
  float* Ds = Vs + kD;                      // ds
  float* lse_s = Ds + kTile * kSq;
  float* dl_s = lse_s + kTile;
  constexpr int J = D / 16;
  const int n_q = (g.Sq + kTile - 1) / kTile;
  const int qt = n_q - 1 - (int)blockIdx.x;      // longest walks first
  const int bh = blockIdx.y, b = bh / g.H, h = bh - b * g.H;
  const int q0 = qt * kTile;
  const long long row0 = (long long)bh * g.Sq;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<T, D>(Qs, q, b, h, q0, g.Sq, g.H);
  load_tile<T, D>(Os, dout, b, h, q0, g.Sq, g.H);
  if (threadIdx.x < kTile) {
    const int qi = q0 + threadIdx.x;
    lse_s[threadIdx.x] = qi < g.Sq ? lse[row0 + qi] : 0.f;
    dl_s[threadIdx.x] = qi < g.Sq ? delta[row0 + qi] : 0.f;
  }
  float adq[4][J];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) adq[i][j] = 0.f;

  const int n_k = g.causal ? qt + 1 : (g.Sk + kTile - 1) / kTile;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                        // last tile's reads are done
    load_tile<T, D>(Ks, k, b, h, k0, g.Sk, g.H);
    load_tile<T, D>(Vs, v, b, h, k0, g.Sk, g.H);
    __syncthreads();
    float s[4][4], dp[4][4];
    two_products<D>(Qs, Ks, Os, Vs, s, dp);
    probs(g, q0, k0, lse_s, dl_s, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ds[(ty + 16 * i) * kSq + tx + 16 * j] = dp[i][j];
    __syncthreads();
    // dq[r] += sum_c ds[r][c] k[c]: the thread owns query rows ty + 16 i
    // and columns tx + 16 j
#pragma unroll 2
    for (int c = 0; c < kTile; ++c) {
      float ds[4], kv[J];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = Ds[(ty + 16 * i) * kSq + c];
#pragma unroll
      for (int j = 0; j < J; ++j) kv[j] = Ks[c * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j)
          adq[i][j] = fmaf(ds[i], kv[j], adq[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= g.Sq) continue;
    const long long base = (((long long)b * g.Sq + qi) * g.H + h) * D;
#pragma unroll
    for (int j = 0; j < J; ++j)
      dq[base + tx + 16 * j] = from_f<T>(adq[i][j] * g.scale);
  }
}

}  // namespace f32

template <int D>
constexpr size_t f32_dkdv_smem() {
  return (4 * kTile * (D + 1) + 2 * kTile * f32::kSq + 2 * kTile) *
         sizeof(float);
}
template <int D>
constexpr size_t f32_dq_smem() {
  return (4 * kTile * (D + 1) + kTile * f32::kSq + 2 * kTile) * sizeof(float);
}
static_assert(f32_dkdv_smem<128>() <= 232448, "dk/dv tile exceeds 227 KB");
static_assert(f32_dq_smem<128>() <= 232448, "dq tile exceeds 227 KB");

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, const float* lse,
           float* delta, Dims g, cudaStream_t s) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr size_t kDkdvSmem =
      kBf16 ? tc::Geo<D>::kSmem : f32_dkdv_smem<D>();
  constexpr size_t kDqSmem = kBf16 ? tc::Geo<D>::kSmem : f32_dq_smem<D>();
  static bool ready = false;                // shared-memory limits set
  if (!ready) {
    cudaError_t e;
    if constexpr (kBf16) {
      e = allow_smem(tc::flash_bwd_dkdv_tc_kernel<D>, kDkdvSmem);
      if (e == cudaSuccess)
        e = allow_smem(tc::flash_bwd_dq_tc_kernel<D>, kDqSmem);
    } else {
      e = allow_smem(f32::flash_bwd_dkdv_kernel<T, D>, kDkdvSmem);
      if (e == cudaSuccess)
        e = allow_smem(f32::flash_bwd_dq_kernel<T, D>, kDqSmem);
    }
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(o);
  const T* dot = static_cast<const T*>(dout);
  const unsigned bh = (unsigned)(g.B * g.H);
  const dim3 gq((g.Sq + kTile - 1) / kTile, bh);
  const dim3 gk((g.Sk + kTile - 1) / kTile, bh);
  const long long rows = (long long)g.B * g.Sq * g.H;
  const long long threads = rows * (D / 8);
  flash_bwd_delta_kernel<T, D>
      <<<(unsigned)((threads + kDeltaThreads - 1) / kDeltaThreads),
         kDeltaThreads, 0, s>>>(ot, dot, delta, g.H, g.Sq, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if constexpr (kBf16) {
    tc::flash_bwd_dkdv_tc_kernel<D><<<gk, tc::kThreads, kDkdvSmem, s>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), g);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    tc::flash_bwd_dq_tc_kernel<D><<<gq, tc::kThreads, kDqSmem, s>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), g);
  } else {
    f32::flash_bwd_dkdv_kernel<T, D><<<gk, f32::kThreads, kDkdvSmem, s>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), g);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    f32::flash_bwd_dq_kernel<T, D><<<gq, f32::kThreads, kDqSmem, s>>>(
        qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), g);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v,
             const void* o, const void* dout, void* dq, void* dk, void* dv,
             const float* lse, float* delta, Dims g, cudaStream_t s) {
  if (D == 16)
    return launch<T, 16>(q, k, v, o, dout, dq, dk, dv, lse, delta, g, s);
  if (D == 64)
    return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, g, s);
  if (D == 128)
    return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, g, s);
  return -1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q, o, dout, dq (B, Sq, H, D); k, v,
// dk, dv (B, Sk, H, D), 16-byte aligned; lse the forward's f32 row
// log-sum-exp (B, H, Sq); delta f32 scratch of B * H * Sq.  causal needs
// Sq == Sk.  Three launches on `stream`.  Returns 0 on success, -1 for an
// unsupported argument, else the cudaError_t of a launch.
int mars_flash_attention_bwd(int dtype, const void* q, const void* k,
                             const void* v, const void* o, const void* dout,
                             void* dq, void* dk, void* dv, const void* lse,
                             void* delta, int B, int H, int Sq, int Sk,
                             int D, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return -1;
  if ((long long)B * H > 65535) return -1;
  if (causal && Sq != Sk) return -1;
  const Dims g{B, H, Sq, Sk, causal ? 1 : 0, scale};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, o, dout, dq, dk, dv, l, dl, g, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, dout, dq, dk, dv, l, dl,
                                   g, s);
  return -1;
}

const char* mars_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
