// SSD (Mamba2) chunked scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_kernel` / `ssd_scan` in
// src/repro/kernels/ssd_scan/ssd_scan.py.  Per (batch b, head h) and per
// chunk of q <= 64 positions, with cum = cumsum(la) over the chunk:
//   y[t]  = sum_{k<=t} (c_t . b_k) * exp(min(cum_t - cum_k, 0)) * dt_k * x_k
//         + exp(cum_t) * (c_t . s_prev)
//   s     = exp(cum_{q-1}) * s_prev + sum_k b_k (x) (exp(cum_{q-1} - cum_k)
//                                                   * dt_k * x_k)
// starting from s = 0; y (B,S,H,P) and the final state (B,H,P,N) in f32.
// x (B,S,H,P), b and c (B,S,N) share one dtype (float32 or bfloat16) and
// are upcast to f32 on load; la and dt (B,S,H) are float32: the model
// computes them in f32 and its one-token decode recurrence uses them
// unrounded, so the prefill must too (rounding the log decay to bf16 moves
// exp(cum_t - cum_k) by up to a few percent a step).  The mask is
// exp(min(li, 0)) inside the lower triangle only: the upper triangle is
// exactly 0.
//
// Bound: every input is read once and y is written once in f32, about
// 2 flops per loaded byte at hymba's widths (P 64, N 16, q 64), so the
// kernel is bound by memory: its floor is those bytes over 3.35 TB/s on
// an H100 SXM.
//
// Design.  On the TPU the chunk axis is the innermost, sequential grid
// axis and the (Hb, P, N) state rides in VMEM scratch from one grid step
// to the next.  Hopper blocks run in parallel and carry nothing, so one
// thread block per (head h, batch b) -- grid (H, B) -- walks its chunks
// itself and keeps the P x N f32 state in shared memory for the whole
// sequence (4 KB a head at P 64, N 16): device memory sees each token
// once.  Per chunk the block stages x[:, h] (q x P), b and c (q x N) and
// la, dt (q) in shared memory as f32, takes the cumulative sum with one
// warp's shuffle scan, builds the masked q x q weight matrix
// W = (C B^T) * L * dt once, then threads own (t, p) outputs for y and
// (p, n) elements for the state update.  Rows of b, c and the state are
// padded by one float so threads striding over them hit distinct banks.
// The chunk length q is a runtime value (the serve load's prompts give
// q = 24; the smoke config q = 8), any 1 <= q <= 64.  No tensor cores:
// the contractions are at most 64 deep and the kernel is bandwidth-bound.
// What holds it back: at prefill (B 1, 50 heads) the grid is 50 blocks
// on 132 SMs, and C B^T, which does not depend on the head, is
// recomputed by every head's block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Shared-memory floats the kernel needs for (q, P, N); the wrapper's
// ``smem_bytes`` mirrors it and checks it against the card's 227 KB.
inline long long smem_floats(int q, int P, int N) {
  return (long long)q * P + 2LL * q * (N + 1) + (long long)q * q +
         (long long)P * (N + 1) + 4LL * q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ b,
                const T* __restrict__ c, const float* __restrict__ la,
                const float* __restrict__ dt, float* __restrict__ y,
                float* __restrict__ state, int S, int H, int P, int N,
                int q) {
  extern __shared__ float smem[];
  const int ldn = N + 1;                  // padded row of b, c, state
  float* xs = smem;                       // (q, P)
  float* bs = xs + q * P;                 // (q, ldn)
  float* cs = bs + q * ldn;               // (q, ldn)
  float* w = cs + q * ldn;                // (q, q) masked weights
  float* st = w + q * q;                  // (P, ldn) carried state
  float* cum = st + P * ldn;              // (q) la, then its cumsum
  float* dtv = cum + q;                   // (q) dt
  float* dec = dtv + q;                   // (q) exp(cum_end - cum_k) dt_k
  float* ecum = dec + q;                  // (q) exp(cum_t)

  const int h = blockIdx.x;
  const int bz = blockIdx.y;
  const int tid = threadIdx.x;
  const long long xrow = (long long)H * P;

  for (int i = tid; i < P * ldn; i += kThreads) st[i] = 0.f;

  const int n_chunks = S / q;
  for (int ic = 0; ic < n_chunks; ++ic) {
    const long long t0 = (long long)bz * S + (long long)ic * q;
    for (int i = tid; i < q * P; i += kThreads) {
      const int t = i / P, p = i - t * P;
      xs[i] = to_f32(x[(t0 + t) * xrow + (long long)h * P + p]);
    }
    for (int i = tid; i < q * N; i += kThreads) {
      const int t = i / N, n = i - t * N;
      const long long off = (t0 + t) * N + n;
      bs[t * ldn + n] = to_f32(b[off]);
      cs[t * ldn + n] = to_f32(c[off]);
    }
    for (int t = tid; t < q; t += kThreads) {
      const long long off = (t0 + t) * H + h;
      cum[t] = la[off];
      dtv[t] = dt[off];
    }
    __syncthreads();

    // inclusive cumsum of la over the chunk: one warp, two positions a
    // lane, shuffle scan over the pair sums
    if (tid < 32) {
      const int ta = 2 * tid, tb = 2 * tid + 1;
      const float va = ta < q ? cum[ta] : 0.f;
      const float vb = tb < q ? cum[tb] : 0.f;
      const float pair = va + vb;
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float nb = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += nb;
      }
      const float excl = incl - pair;
      if (ta < q) cum[ta] = excl + va;
      if (tb < q) cum[tb] = excl + va + vb;
    }
    __syncthreads();

    const float cum_end = cum[q - 1];
    for (int t = tid; t < q; t += kThreads) {
      ecum[t] = expf(cum[t]);
      dec[t] = expf(cum_end - cum[t]) * dtv[t];
    }
    // W[t, k] = (c_t . b_k) * exp(min(cum_t - cum_k, 0)) * dt_k, k <= t
    for (int i = tid; i < q * q; i += kThreads) {
      const int t = i / q, k = i - t * q;
      float v = 0.f;
      if (k <= t) {
        float cb = 0.f;
        for (int n = 0; n < N; ++n) cb += cs[t * ldn + n] * bs[k * ldn + n];
        v = cb * expf(fminf(cum[t] - cum[k], 0.f)) * dtv[k];
      }
      w[i] = v;
    }
    __syncthreads();

    // y[t, p] = sum_k W[t, k] x[k, p] + exp(cum_t) (c_t . s_prev[p])
    for (int i = tid; i < q * P; i += kThreads) {
      const int t = i / P, p = i - t * P;
      float intra = 0.f;
      for (int k = 0; k <= t; ++k) intra += w[t * q + k] * xs[k * P + p];
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter += cs[t * ldn + n] * st[p * ldn + n];
      y[((t0 + t) * H + h) * (long long)P + p] = intra + ecum[t] * inter;
    }
    __syncthreads();

    // s[p, n] = exp(cum_end) s[p, n] + sum_k b[k, n] dec_k x[k, p]
    const float decay = expf(cum_end);
    for (int i = tid; i < P * N; i += kThreads) {
      const int p = i / N, n = i - p * N;
      float z = 0.f;
      for (int k = 0; k < q; ++k) z += bs[k * ldn + n] * dec[k] * xs[k * P + p];
      st[p * ldn + n] = st[p * ldn + n] * decay + z;
    }
    __syncthreads();
  }

  float* out = state + ((long long)bz * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    out[i] = st[p * ldn + n];
  }
}

template <typename T>
int launch(const void* x, const void* b, const void* c, const float* la,
           const float* dt, float* y, float* state, int B, int S, int H,
           int P, int N, int q, cudaStream_t stream) {
  const size_t smem = (size_t)smem_floats(q, P, N) * sizeof(float);
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(H, B);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b),
      static_cast<const T*>(c), la, dt, y, state, S, H, P, N, q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, b and c share it; la and dt are
// float32).  Returns 0 on success, -1 for an unsupported dtype or chunk,
// else the cudaError_t of the launch.
int mars_ssd_scan(int dtype, const void* x, const void* b, const void* c,
                  const float* la, const float* dt, float* y, float* state,
                  int B, int S, int H, int P, int N, int q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q < 1 || q > kMaxChunk || S % q != 0) return -1;
  if (dtype == 0)
    return launch<float>(x, b, c, la, dt, y, state, B, S, H, P, N, q, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, b, c, la, dt, y, state, B, S, H, P, N, q,
                                 s);
  return -1;
}

const char* mars_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
