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
// Bound: mostly bytes.  Every input is read once and y and the final
// state are written once in f32 (at mamba2-370m's prefill the state alone
// is 8.4 MB); the f32 products (W x, the state update, C s) are about 2
// flops per byte at hymba's widths and 40 at mamba2's (N 128), where at
// long sequences they take longer on CUDA cores than the bytes take.
//
// Design.  On the TPU the chunk axis is the innermost, sequential grid
// axis and the (Hb, P, N) state rides in VMEM scratch from one grid step
// to the next.  Hopper blocks run in parallel and carry nothing, so the
// chunks run in parallel and the state is passed between them apart:
//   * One chunk (S no longer than the chunk: every serve prefill): one
//     launch of the chunk kernel in its fused mode.  A block owns (batch,
//     chunk, a group of `hg` heads, a block of `pb` of the P columns): it
//     stages the chunk's b and c in shared memory as f32 once, forms
//     C B^T once for the heads it owns, and per head forms the masked
//     weights W = (C B^T) * L * dt, writes y = W x and writes the chunk's
//     state contribution z = x^T (dec * b), dec_k = exp(cum_end - cum_k)
//     dt_k, as the final state: there is no carried state and no inter
//     term.
//   * Several chunks: three launches.  (1) The chunk kernel in its state
//     mode writes every chunk's z_c and its total decay exp(cum_end) to
//     scratch.  (2) A pass kernel, parallel over (batch, head, p, n),
//     walks the chunks: it overwrites z_c with the state entering chunk
//     c, s_{c-1}, and carries s_c = exp(cum_end,c) s_{c-1} + z_c, writing
//     the last as the final state (its loads run eight chunks ahead of its
//     chain of multiply-adds).  (3) The chunk kernel in its output mode
//     writes y = W x + exp(cum_t) C s_{c-1}.  The inputs are read twice
//     (by (1) and (3)), y once.
//   * A block walks its heads in turn, and loads head h + 1's x, carried
//     state, la and dt into registers while head h computes (x in its own
//     dtype: converting at the load would make the block wait for it).
//     Warp 0 scans la from its registers.  The chunk's b and c are read
//     once, coalesced, with eight loads of each in flight a thread (and
//     head h0's x beside them), then stored in every layout the mode
//     needs.
//   * The products run on CUDA cores in f32, register-tiled: a thread
//     owns a 4 x 4 micro-tile of outputs and reads two float4 rows of
//     shared memory per 16 multiply-adds, or a 2 x 2 one where 4 x 4
//     tiles would leave half the threads idle (the state contribution at
//     N 16, a short chunk's output).  The operands are kept with the
//     reduction index outermost: b both k-major and n-major, c n-major,
//     W^T, x k-major, the carried state n-major.  C B^T at a short chunk
//     takes one element a thread.
//   * The arithmetic is the previous one-block-per-head kernel's, term
//     for term: every sum is a chain of multiply-adds in the same order
//     (C B^T over n, W x and z over k, z's terms (b dec) x, the scan's
//     pair sums, the carried state decay s + z, the inter term over n),
//     and no cut of the heads, P, the chunks or the grid changes a bit.
//     mamba2-370m's bf16 teacher-forced check is that fragile: cutting
//     C B^T's sums over more threads (a faster prefill) moved its served
//     tokens from 0.23 to 0.69 below the dense argmax, past its 0.25
//     margin, with every scan within the kernel's tolerance.
//   * In bf16 C B^T could take the tensor cores exactly, but it is q^2 N
//     of the q^2 N + hg q P (q + 2 N) multiply-adds a block does, and
//     their sums would run in another order; it stays on the CUDA cores.
//     TF32 would keep about three digits, too few for the tolerance.
//   * The host's `split_plan` picks hg and pb from the shapes and the SM
//     count: the pair that least loads the busiest SM by a multiply-add
//     count (C B^T once a block, each head's products, and a fixed cost a
//     block), among those whose shared memory fits a block.  At hymba's
//     prefill (B 1, one chunk, 50 heads of 64) that is 100 blocks of one
//     head and 32 columns; at mamba2-370m's long prefill 128 blocks of 8
//     heads.
// What holds it back (PERF.md): a block runs each head's phases (stores,
// scan, W, products) in turn behind barriers, with one head's loads in
// flight, so at hymba's widths (N 16) the long scan's passes stream their
// bytes at a fraction of the memory's rate; the f32 products run at a
// small share of the CUDA cores' rate; and a launch of a few blocks is
// mostly latency.
// The chunk length q is a runtime value (the serve load's prompts give
// q = 24; the smoke config q = 8), any 1 <= q <= 64; q, N and pb are
// padded to multiples of 4 in shared memory with zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kXR = 16;                // x elements a thread prefetches: all
                                       // of q4 x p4 <= 64 x 64
constexpr int kSR = 8;                 // carried-state elements it prefetches
constexpr int kStageBatch = 8;         // b, c loads a thread keeps in flight
static_assert(kXR * kThreads >= kMaxChunk * 64, "x fits the registers");
constexpr int kPassThreads = 256;
constexpr int kPassAhead = 8;          // chunks a pass thread loads at once

enum Mode { kFused = 0, kState = 1, kOutput = 2 };

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

inline int up4(int v) { return (v + 3) & ~3; }

// Shared-memory floats the chunk kernel needs in `mode` for (q, pb, N);
// the wrapper's ``smem_bytes`` mirrors it and checks it against the
// card's 227 KB.
inline long long smem_floats(int mode, int q, int pb, int N) {
  const long long q4 = up4(q), n4 = up4(N), p4 = up4(pb);
  long long f = 4 * q4 + q4 * p4;                 // cum, dt, dec, ecum; x
  if (mode != kOutput) f += q4 * n4;              // b, k-major
  if (mode != kState) f += 2 * n4 * q4 + 2 * q4 * q4;   // b, c n-major; CB, W
  if (mode == kOutput) f += n4 * p4;              // carried state, n-major
  return f;
}

// W consecutive floats of shared memory (W = 2 or 4, aligned to 4 W B).
template <int W>
__device__ __forceinline__ void ld(const float* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  }
}

// acc[a][c] += sum_{r in [r0, r1)} A[r][i0 + a] (s_r Bm[r][j0 + c]) over
// row-major shared arrays (rows of lda and ldb floats), one multiply-add
// a term in r order; s_r = 1 without SCALE.  A thread's TI x TJ
// micro-tile (4 x 4, or 2 x 2 where 4 x 4 tiles would leave threads idle)
// changes how many outputs it owns, not how any one is summed.
template <int TI, int TJ, bool SCALE>
__device__ __forceinline__ void mm(float (&acc)[TI][TJ], const float* A,
                                   int lda, const float* Bm, int ldb, int i0,
                                   int j0, int r0, int r1, const float* s) {
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    float a[TI], b[TJ];
    ld<TI>(A + r * lda + i0, a);
    ld<TJ>(Bm + r * ldb + j0, b);
    if (SCALE) {
      const float sr = s[r];
#pragma unroll
      for (int v = 0; v < TJ; ++v) b[v] *= sr;
    }
#pragma unroll
    for (int u = 0; u < TI; ++u)
#pragma unroll
      for (int v = 0; v < TJ; ++v) acc[u][v] += a[u] * b[v];
  }
}

template <int TI, int TJ>
__device__ __forceinline__ void zero_tile(float (&acc)[TI][TJ]) {
#pragma unroll
  for (int u = 0; u < TI; ++u)
#pragma unroll
    for (int v = 0; v < TJ; ++v) acc[u][v] = 0.f;
}

// Calls f(i0, j0) with TI x TJ micro-tiles of an I x J output (I, J
// multiples of 4) spread over the block; 2 x 2 tiles where 4 x 4 ones
// would occupy fewer than half of the threads.
template <typename F>
__device__ __forceinline__ void tiles(int I, int J, F f) {
  if ((I / 4) * (J / 4) >= kThreads / 2) {
    for (int t = threadIdx.x; t < (I / 4) * (J / 4); t += kThreads)
      f(std::integral_constant<int, 4>{}, (t / (J / 4)) * 4,
        (t % (J / 4)) * 4);
  } else {
    for (int t = threadIdx.x; t < (I / 2) * (J / 2); t += kThreads)
      f(std::integral_constant<int, 2>{}, (t / (J / 2)) * 2,
        (t % (J / 2)) * 2);
  }
}

// Stage elements [i0, total) (step kThreads) into shared memory with
// kStageBatch loads in flight a thread: v = load(i), then store(i, v).
template <typename Load, typename Store>
__device__ __forceinline__ void stage(int total, int i0, Load load,
                                      Store store) {
  for (int base = i0; base < total; base += kStageBatch * kThreads) {
    float v[kStageBatch];
#pragma unroll
    for (int j = 0; j < kStageBatch; ++j) {
      const int i = base + j * kThreads;
      v[j] = i < total ? load(i) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kStageBatch; ++j) {
      const int i = base + j * kThreads;
      if (i < total) store(i, v[j]);
    }
  }
}

// Grid (chunks, head groups x p blocks, batch); see the design comment.
// zbuf (B, n_chunks, H, P, N) and decay (B, n_chunks, H) are the state
// and output modes' scratch.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_chunk_kernel(const T* __restrict__ x, const T* __restrict__ b,
                      const T* __restrict__ c, const float* __restrict__ la,
                      const float* __restrict__ dt, float* __restrict__ y,
                      float* __restrict__ state, float* __restrict__ zbuf,
                      float* __restrict__ decay, int S, int H, int P, int N,
                      int q, int hg, int pb) {
  extern __shared__ __align__(16) float smem[];
  const int q4 = (q + 3) & ~3, n4 = (N + 3) & ~3, p4 = (pb + 3) & ~3;
  float* cum = smem;                      // (q4) la, then its cumsum
  float* dtv = cum + q4;                  // (q4) dt
  float* dec = dtv + q4;                  // (q4) exp(cum_end - cum_k) dt_k
  float* ecum = dec + q4;                 // (q4) exp(cum_t)
  float* xs = ecum + q4;                  // (q4, p4) x, k-major
  float* next = xs + q4 * p4;
  float* bk = nullptr;                    // (q4, n4) b, k-major
  float *bt = nullptr, *ct = nullptr;     // (n4, q4) b, c, n-major
  float *cbt = nullptr, *wt = nullptr;    // (q4, q4) (C B^T)^T and W^T
  float* st = nullptr;                    // (n4, p4) s_prev, n-major
  if (MODE != kOutput) {
    bk = next;
    next += q4 * n4;
  }
  if (MODE != kState) {
    bt = next;
    ct = bt + n4 * q4;
    cbt = ct + n4 * q4;
    wt = cbt + q4 * q4;
    next = wt + q4 * q4;
  }
  if (MODE == kOutput) st = next;

  const int ic = blockIdx.x, bz = blockIdx.z;
  const int n_chunks = S / q;
  const int n_pb = (P + pb - 1) / pb;
  const int h0 = (blockIdx.y / n_pb) * hg, h1 = min(H, h0 + hg);
  const int p0 = (blockIdx.y % n_pb) * pb, np = min(pb, P - p0);
  const int tid = threadIdx.x;
  const long long t0 = (long long)bz * S + (long long)ic * q;
  const bool inter = MODE == kOutput && ic > 0;

  // Head h's x (and carried state) and la, dt are loaded into registers
  // while head h - 1 computes: all of x (kXR elements a thread), the
  // first kSR elements a thread of the state and the rest when they are
  // stored; warp 0 holds la and dt of positions 2 lane and 2 lane + 1, as
  // its scan takes them.
  // x stays in its own dtype until it is stored: a conversion at the load
  // would wait for the load there.
  T xr[kXR];
  float sr[kSR], lar[2], dtr[2];
  const T zero = from_f32<T>(0.f);
  const long long st_stride = (long long)P * N;
  auto state_in = [&](int h) {
    return zbuf + (((long long)bz * n_chunks + ic) * H + h) * st_stride;
  };
  auto x_raw = [&](int h, int i) {
    const int t = i / p4, p = i - t * p4;
    return t < q && p < np ? x[((t0 + t) * H + h) * (long long)P + p0 + p]
                           : zero;
  };
  auto s_at = [&](const float* sp, int i) {
    const int n = i / p4, p = i - n * p4;
    return p < np && n < N ? sp[(long long)(p0 + p) * N + n] : 0.f;
  };
  auto fetch = [&](int h) {
#pragma unroll
    for (int j = 0; j < kXR; ++j) {
      const int i = tid + j * kThreads;
      xr[j] = i < q4 * p4 ? x_raw(h, i) : zero;
    }
    if (inter) {
      const float* sp = state_in(h);
#pragma unroll
      for (int j = 0; j < kSR; ++j) {
        const int i = tid + j * kThreads;
        sr[j] = i < n4 * p4 ? s_at(sp, i) : 0.f;
      }
    }
    if (tid < 32) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = 2 * tid + e;
        const long long off = (t0 + t) * H + h;
        lar[e] = t < q ? la[off] : 0.f;
        dtr[e] = t < q ? dt[off] : 0.f;
      }
    }
  };

  // Head h0's x, la and dt, and the chunk's b and c (zero past q and N),
  // read once, coalesced (n fastest) and in their own dtype with every
  // load of a batch in flight, then stored in each layout the mode needs
  fetch(h0);
  for (int base = tid; base < q4 * n4; base += kStageBatch * kThreads) {
    T vb[kStageBatch], vc[kStageBatch];
#pragma unroll
    for (int j = 0; j < kStageBatch; ++j) {
      const int i = base + j * kThreads, t = i / n4, n = i - t * n4;
      const bool in = i < q4 * n4 && t < q && n < N;
      const long long off = (t0 + t) * N + n;
      vb[j] = in ? b[off] : zero;
      if (MODE != kState) vc[j] = in ? c[off] : zero;
    }
#pragma unroll
    for (int j = 0; j < kStageBatch; ++j) {
      const int i = base + j * kThreads, t = i / n4, n = i - t * n4;
      if (i >= q4 * n4) continue;
      if (MODE != kOutput) bk[i] = to_f32(vb[j]);
      if (MODE != kState) {
        bt[n * q4 + t] = to_f32(vb[j]);
        ct[n * q4 + t] = to_f32(vc[j]);
      }
    }
  }
  __syncthreads();
  // C B^T once for every head of the block: cbt[k][t] = c_t . b_k, each
  // an N-long chain of multiply-adds in n order; in 4 x 4 tiles when
  // there are enough of them, else one element a thread (a short chunk:
  // 36 tiles at q 24, too few to occupy the block)
  if (MODE != kState) {
    const int tiles = (q4 / 4) * (q4 / 4);
    if (tiles >= kThreads / 2) {
      for (int tile = tid; tile < tiles; tile += kThreads) {
        const int i0 = (tile / (q4 / 4)) * 4, j0 = (tile % (q4 / 4)) * 4;
        float acc[4][4];
        zero_tile(acc);
        mm<4, 4, false>(acc, ct, q4, bt, q4, i0, j0, 0, n4, nullptr);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            cbt[(j0 + v) * q4 + i0 + u] = acc[u][v];
      }
    } else {
      for (int i = tid; i < q4 * q4; i += kThreads) {
        const int k = i / q4, t = i - k * q4;
        float cb = 0.f;
        for (int n = 0; n < n4; ++n) cb += ct[n * q4 + t] * bt[n * q4 + k];
        cbt[i] = cb;
      }
    }
  }

  for (int h = h0; h < h1; ++h) {
#pragma unroll
    for (int j = 0; j < kXR; ++j) {
      const int i = tid + j * kThreads;
      if (i < q4 * p4) xs[i] = to_f32(xr[j]);
    }
    if (inter) {
#pragma unroll
      for (int j = 0; j < kSR; ++j) {
        const int i = tid + j * kThreads;
        if (i < n4 * p4) st[i] = sr[j];
      }
      const float* sp = state_in(h);
      stage(n4 * p4, tid + kSR * kThreads, [&](int i) { return s_at(sp, i); },
            [&](int i, float v) { st[i] = v; });
    }
    // inclusive cumsum of la over the chunk: warp 0, two positions a
    // lane, shuffle scan over the pair sums (q4 <= 64); then exp(cum_t)
    // and dec_k = exp(cum_end - cum_k) dt_k
    if (tid < 32) {
      const float pair = lar[0] + lar[1];
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float nb = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += nb;
      }
      const float excl = incl - pair;
      const float ca = excl + lar[0], cb = excl + lar[0] + lar[1];
      const float cum_end = __shfl_sync(0xffffffffu, (q - 1) & 1 ? cb : ca,
                                        (q - 1) >> 1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = 2 * tid + e;
        const float cv = e ? cb : ca;
        if (t < q4) {
          cum[t] = cv;
          dtv[t] = dtr[e];
          ecum[t] = t < q ? expf(cv) : 0.f;
          dec[t] = t < q ? expf(cum_end - cv) * dtr[e] : 0.f;
        }
      }
      if (MODE == kState && blockIdx.y % n_pb == 0 && tid == 0)
        decay[((long long)bz * n_chunks + ic) * H + h] = expf(cum_end);
    }
    if (h + 1 < h1) fetch(h + 1);
    __syncthreads();

    // W^T[k][t] = (c_t . b_k) * exp(min(cum_t - cum_k, 0)) * dt_k, k <= t
    if (MODE != kState) {
      for (int i = tid; i < q4 * q4; i += kThreads) {
        const int k = i / q4, t = i - k * q4;
        wt[i] = k <= t && t < q
                    ? cbt[i] * expf(fminf(cum[t] - cum[k], 0.f)) * dtv[k]
                    : 0.f;
      }
      __syncthreads();
    }

    // z[p][n] = sum_k (b[k][n] dec_k) x[k][p]: the final state (one
    // chunk) or chunk ic's contribution
    if (MODE != kOutput) {
      float* zo = MODE == kFused
                      ? state + ((long long)bz * H + h) * (long long)P * N
                      : zbuf + (((long long)bz * n_chunks + ic) * H + h) *
                                   (long long)P * N;
      tiles(p4, n4, [&](auto tw, int i0, int j0) {
        constexpr int W = decltype(tw)::value;
        float acc[W][W];
        zero_tile(acc);
        mm<W, W, true>(acc, xs, p4, bk, n4, i0, j0, 0, q4, dec);
#pragma unroll
        for (int u = 0; u < W; ++u)
#pragma unroll
          for (int v = 0; v < W; ++v)
            if (i0 + u < np && j0 + v < N)
              zo[(long long)(p0 + i0 + u) * N + j0 + v] = acc[u][v];
      });
    }
    // y[t][p] = sum_{k<=t} W[t][k] x[k][p] (+ exp(cum_t) c_t . s_prev[p])
    if (MODE != kState) {
      tiles(q4, p4, [&](auto tw, int i0, int j0) {
        constexpr int W = decltype(tw)::value;
        float acc[W][W];
        zero_tile(acc);
        mm<W, W, false>(acc, wt, q4, xs, p4, i0, j0, 0, i0 + W, nullptr);
        if (inter) {
          float ai[W][W];
          zero_tile(ai);
          mm<W, W, false>(ai, ct, q4, st, p4, i0, j0, 0, n4, nullptr);
#pragma unroll
          for (int u = 0; u < W; ++u)
#pragma unroll
            for (int v = 0; v < W; ++v) acc[u][v] += ecum[i0 + u] * ai[u][v];
        }
#pragma unroll
        for (int u = 0; u < W; ++u)
#pragma unroll
          for (int v = 0; v < W; ++v)
            if (i0 + u < q && j0 + v < np)
              y[((t0 + i0 + u) * H + h) * (long long)P + p0 + j0 + v] =
                  acc[u][v];
      });
    }
    __syncthreads();                      // before the next head's loads
  }
}

// One thread per (batch, head, V state elements): over the chunks in
// order, replace z_c with the state entering chunk c and carry
// s_c = decay_c s_{c-1} + z_c; the last is the final state.  V = 4 reads
// and writes 16 bytes at a time (P N a multiple of 4).
template <int V>
__device__ __forceinline__ auto pack(const float (&s)[V]) {
  if constexpr (V == 4) return make_float4(s[0], s[1], s[2], s[3]);
  else return s[0];
}

template <int V>
__global__ void __launch_bounds__(kPassThreads)
ssd_scan_pass_kernel(float* __restrict__ zbuf,
                     const float* __restrict__ decay,
                     float* __restrict__ state, int n_chunks, int H,
                     long long PN, long long total) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const long long i = ((long long)blockIdx.x * kPassThreads + threadIdx.x) *
                      V;
  if (i >= total) return;
  const long long bh = i / PN, e = i - bh * PN;
  const long long bz = bh / H, h = bh - bz * H;
  float s[V] = {};
  for (int c0 = 0; c0 < n_chunks; c0 += kPassAhead) {
    Vec z[kPassAhead];
    float d[kPassAhead];
#pragma unroll
    for (int j = 0; j < kPassAhead; ++j) {
      if (c0 + j < n_chunks) {
        const long long ch = bz * n_chunks + c0 + j;
        z[j] = __ldcg(reinterpret_cast<const Vec*>(zbuf + (ch * H + h) * PN +
                                                   e));
        d[j] = decay[ch * H + h];
      }
    }
#pragma unroll
    for (int j = 0; j < kPassAhead; ++j) {
      if (c0 + j < n_chunks) {
        const long long ch = bz * n_chunks + c0 + j;
        *reinterpret_cast<Vec*>(zbuf + (ch * H + h) * PN + e) = pack<V>(s);
        const float* zj = reinterpret_cast<const float*>(&z[j]);
#pragma unroll
        for (int v = 0; v < V; ++v) s[v] = d[j] * s[v] + zj[v];
      }
    }
  }
  *reinterpret_cast<Vec*>(state + i) = pack<V>(s);
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= (size_t)kDefaultSmem) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int MODE>
int launch_chunks(const void* x, const void* b, const void* c,
                  const float* la, const float* dt, float* y, float* state,
                  float* zbuf, float* decay, int B, int S, int H, int P,
                  int N, int q, int hg, int pb, cudaStream_t stream) {
  const size_t smem = (size_t)smem_floats(MODE, q, pb, N) * sizeof(float);
  const int rc = allow_smem(ssd_scan_chunk_kernel<T, MODE>, smem);
  if (rc) return rc;
  const dim3 grid(MODE == kFused ? 1 : S / q,
                  ((H + hg - 1) / hg) * ((P + pb - 1) / pb), B);
  ssd_scan_chunk_kernel<T, MODE><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b),
      static_cast<const T*>(c), la, dt, y, state, zbuf, decay, S, H, P, N,
      q, hg, pb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* b, const void* c, const float* la,
           const float* dt, float* y, float* state, float* zbuf,
           float* decay, int B, int S, int H, int P, int N, int q, int hg,
           int pb, cudaStream_t stream) {
  if (S == q)
    return launch_chunks<T, kFused>(x, b, c, la, dt, y, state, zbuf, decay,
                                    B, S, H, P, N, q, hg, pb, stream);
  int rc = launch_chunks<T, kState>(x, b, c, la, dt, y, state, zbuf, decay,
                                    B, S, H, P, N, q, hg, pb, stream);
  if (rc) return rc;
  const long long PN = (long long)P * N, total = (long long)B * H * PN;
  if (PN % 4 == 0)
    ssd_scan_pass_kernel<4><<<(unsigned)((total / 4 + kPassThreads - 1) /
                                         kPassThreads),
                              kPassThreads, 0, stream>>>(zbuf, decay, state,
                                                         S / q, H, PN, total);
  else
    ssd_scan_pass_kernel<1><<<(unsigned)((total + kPassThreads - 1) /
                                         kPassThreads),
                              kPassThreads, 0, stream>>>(zbuf, decay, state,
                                                         S / q, H, PN, total);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return launch_chunks<T, kOutput>(x, b, c, la, dt, y, state, zbuf, decay, B,
                                   S, H, P, N, q, hg, pb, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, b and c share it; la and dt are
// float32).  hg heads and pb columns of P a block (1 <= pb <= 64).  With
// S > q, zbuf holds B * (S / q) * H * P * N floats and decay
// B * (S / q) * H; both are scratch (null when S == q).  A call is one
// launch when S == q, else three.  Returns 0 on success, -1 for an
// unsupported argument, else the cudaError_t of the launch.
int mars_ssd_scan(int dtype, const void* x, const void* b, const void* c,
                  const float* la, const float* dt, float* y, float* state,
                  float* zbuf, float* decay, int B, int S, int H, int P,
                  int N, int q, int hg, int pb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q < 1 || q > kMaxChunk || S % q != 0 || hg < 1 || pb < 1 ||
      pb > 64 || B > 65535 || (long long)((H + hg - 1) / hg) *
                                  ((P + pb - 1) / pb) > 65535)
    return -1;
  if (S != q && (zbuf == nullptr || decay == nullptr)) return -1;
  if (dtype == 0)
    return launch<float>(x, b, c, la, dt, y, state, zbuf, decay, B, S, H, P,
                         N, q, hg, pb, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, b, c, la, dt, y, state, zbuf, decay, B, S,
                                 H, P, N, q, hg, pb, s);
  return -1;
}

const char* mars_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
