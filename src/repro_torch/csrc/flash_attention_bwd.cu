// Backward of blockwise (flash) attention for Hopper (sm_90a), plain C
// interface.
//
// The JAX package has no Pallas kernel here: its trainer differentiates
// plain `layers.sdpa` with `jax.value_and_grad`
// (src/repro/train/step.py:47).  The port's forward runs the hand-written
// K5 (csrc/flash_attention.cu) outside autograd, so its gradient is this
// kernel (B5).  Per (batch b, head h), with q (B, Sq, H, D), k, v (B, Sk,
// H, D), the forward's o and the incoming do (B, Sq, H, D), all
// contiguous and of one dtype (float32 or bfloat16), and scale 1/sqrt(D):
//   s = scale q k^T (masked), lse = log sum_j exp(s_ij),
//   p = exp(s - lse), delta_i = sum_d do_id o_id,
//   dv = p^T do, dp = do v^T, ds = p (dp - delta),
//   dq = scale ds k, dk = scale ds^T q,
// every product and sum in f32, dq, dk, dv written in the input dtype.
// `causal` keeps key <= query and needs Sq == Sk; without it any Sq and
// Sk (whisper's cross-attention).  Head dims 64 and 128.
//
// Bound.  The five products of a (query, key) pair the mask keeps take
// 10 D operations (q.k, do.v, p^T do, ds k, ds^T q); the pre-pass here
// recomputes q.k (2 D more).  qwen1.5-0.5b's layer at batch 8 x 512 (16
// heads of 64, causal) keeps 16.8 M pairs, 10.8 GFLOP: 11 us at the
// tensor cores' 989 TFLOP/s, while its q, k, v, o, do, dq, dk, dv are 67
// MB in bf16, 20 us at 3.35 TB/s, so bytes bind; whisper-base's encoder
// (8 x 1500, 8 heads, no mask) does 92 GFLOP over 98 MB, so operations
// do (93 us).  On CUDA cores in f32 (67 TFLOP/s) operations bind both.
//
// Design (FlashAttention-2's backward, right before fast; its speed is a
// later PR's).  Three kernels, one launch each, no atomics, so the
// result is the same bit for bit from run to run:
//   1. pre-pass, one block a 64-row query tile: delta from do and o, and
//      the row log-sum-exp by an online max and sum over the key tiles
//      (K5 keeps no lse, so it is recomputed here);
//   2. dk/dv, one block a 64-row key tile: dk and dv stay in registers
//      while the block walks the query tiles (in causal mode from the
//      key tile's own diagonal on: earlier query tiles keep no key of
//      it), recomputing s and dp for each and staging p and ds in
//      shared memory;
//   3. dq, one block a query tile: dq stays in registers while the block
//      walks the key tiles (in causal mode up to its diagonal, the
//      longest walks scheduled first).
// Every tile is staged in shared memory as f32 with rows padded to D + 1
// floats, so a warp's column reads fall in distinct banks; 256 threads
// as a 16 x 16 grid each own a 4 x 4 patch of a 64 x 64 product (4 x D/16
// of a 64 x D one) and run its f32 multiply-adds on CUDA cores.  Shared
// memory: dk/dv 4 tiles of 64 x (D + 1) plus p and ds (100 KB at D 64,
// 166 KB at D 128).  Tensor-core tiles (wgmma on bf16 operands, as K5's)
// are the way to the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // rows of a query tile and of a key tile
constexpr int kThreads = 256;    // a 16 x 16 grid of threads
constexpr int kSq = kTile + 1;   // row stride of a 64 x 64 f32 tile

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

__device__ __forceinline__ bool kept(const Dims& g, int qi, int kj) {
  return qi < g.Sq && kj < g.Sk && (!g.causal || kj <= qi);
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

// --- 1. pre-pass: delta and the row log-sum-exp --------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ lse, float* __restrict__ delta,
                      Dims g) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * (D + 1);
  const int n_q = (g.Sq + kTile - 1) / kTile;
  const int qt = n_q - 1 - (int)blockIdx.x;      // longest walks first
  const int bh = blockIdx.y, b = bh / g.H, h = bh - b * g.H;
  const int q0 = qt * kTile;
  const long long row0 = (long long)bh * g.Sq;

  // delta: four lanes a row
  {
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
    const int qi = q0 + r;
    float acc = 0.f;
    if (qi < g.Sq) {
      const long long base = (((long long)b * g.Sq + qi) * g.H + h) * D;
      for (int d = part; d < D; d += 4)
        acc = fmaf(to_f(dout[base + d]), to_f(o[base + d]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0 && qi < g.Sq) delta[row0 + qi] = acc;
  }

  load_tile<T, D>(Qs, q, b, h, q0, g.Sq, g.H);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
  const int n_k = g.causal ? qt + 1 : (g.Sk + kTile - 1) / kTile;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(Ks, k, b, h, k0, g.Sk, g.H);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty + 16 * i) * (D + 1) + d];
        bb[i] = Ks[(tx + 16 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = kept(g, qi, k0 + tx + 16 * j) ? s[i][j] * g.scale
                                                : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
      // the 16 lanes of one ty hold the row's 64 columns
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float mn = fmaxf(m[i], tmax);
      // a row with nothing kept yet keeps l = 0 (no branch: every lane of
      // the warp takes the shuffles below)
      const float base = mn == -INFINITY ? 0.f : mn;
      float tsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) tsum += expf(s[i][j] - base);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        tsum += __shfl_xor_sync(0xffffffffu, tsum, off);
      l[i] = l[i] * expf(m[i] - base) + tsum;
      m[i] = mn;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      if (qi < g.Sq) lse[row0 + qi] = m[i] + logf(l[i]);
    }
  }
}

// --- 2. dk and dv, one block a key tile ----------------------------------
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

// --- 3. dq, one block a query tile ---------------------------------------
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

template <int D>
constexpr size_t prep_smem() { return 2 * kTile * (D + 1) * sizeof(float); }
template <int D>
constexpr size_t dkdv_smem() {
  return (4 * kTile * (D + 1) + 2 * kTile * kSq + 2 * kTile) * sizeof(float);
}
template <int D>
constexpr size_t dq_smem() {
  return (4 * kTile * (D + 1) + kTile * kSq + 2 * kTile) * sizeof(float);
}
static_assert(dkdv_smem<128>() <= 232448, "dk/dv tile exceeds 227 KB");
static_assert(dq_smem<128>() <= 232448, "dq tile exceeds 227 KB");

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* delta, Dims g, cudaStream_t s) {
  static bool ready = false;                // shared-memory limits set
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_prep_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)prep_smem<D>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dkdv_smem<D>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dq_smem<D>());
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
  flash_bwd_prep_kernel<T, D><<<gq, kThreads, prep_smem<D>(), s>>>(
      qt, kt, ot, dot, lse, delta, g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_kernel<T, D><<<gk, kThreads, dkdv_smem<D>(), s>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<T, D><<<gq, kThreads, dq_smem<D>(), s>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v,
             const void* o, const void* dout, void* dq, void* dk, void* dv,
             float* lse, float* delta, Dims g, cudaStream_t s) {
  if (D == 64)
    return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, g, s);
  if (D == 128)
    return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, g, s);
  return -1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q, o, dout, dq (B, Sq, H, D); k, v,
// dk, dv (B, Sk, H, D); lse and delta f32 scratch of B * H * Sq.  causal
// needs Sq == Sk.  Three launches on `stream`.  Returns 0 on success, -1
// for an unsupported argument, else the cudaError_t of a launch.
int mars_flash_attention_bwd(int dtype, const void* q, const void* k,
                             const void* v, const void* o, const void* dout,
                             void* dq, void* dk, void* dv, void* lse,
                             void* delta, int B, int H, int Sq, int Sk,
                             int D, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return -1;
  if ((long long)B * H > 65535) return -1;
  if (causal && Sq != Sk) return -1;
  const Dims g{B, H, Sq, Sk, causal ? 1 : 0, scale};
  float* l = static_cast<float*>(lse);
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
