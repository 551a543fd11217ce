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
// or bfloat16) and la, dt in f32, as K3 reads them; all arithmetic is f32.
//
// Within a chunk of q positions, cum = cumsum(la), e_t = exp(cum_t), f_k =
// exp(cum_end - cum_k), D_tk = exp(min(cum_t - cum_k, 0)) for k <= t (else
// exactly 0), W_tk = (c_t . b_k) D_tk dt_k; s_{c-1} is the state entering
// chunk c (K3 keeps it), G_c the gradient of the state leaving it.
//
// Design: the forward's passes run in reverse, four launches (two for one
// chunk, which has no entering state and G = dS):
//   (1) state kernel, parallel over (chunk >= 1, head group, batch):
//       U_c = sum_t e_t dy_t (x) c_t, the gradient of s_{c-1} through
//       chunk c's outputs, into the scratch gbuf (B, n_chunks, H, P, N).
//   (2) pass kernel, a thread 4 elements of (P, N) of one (batch, head):
//       from the last chunk back, G_{c-1} = exp(cum_end,c) G_c + U_c (the
//       decay K3 kept), overwriting U_c in gbuf with G_c, and each warp's
//       share of d(decay_c) = sum G_c * s_{c-1} into d_decay.
//   (3) grad kernel, a block a (chunk, group of hg heads, batch): stages b,
//       c and C B^T once, then per head forms dW_tk = dy_t . x_k, W and
//       Q = dW D (C B^T) on the lower triangle and writes
//         dx_k  = sum_{t>=k} W_tk dy_t + f_k dt_k (G_c b_k),
//         ddt_k = sum_t Q_tk + f_k (x_k . G_c b_k),
//       the gradient of cum (the mask's d/d li below the diagonal, the
//       f_k and chunk-end terms, e_t c_t . (s_{c-1}^T dy_t), exp(cum_end)
//       d(decay_c)), and dla by a reverse cumsum of it within the chunk,
//       in f32; it sums over its heads dCB = dW D dt (shared memory) and
//       f dt x^T G and e dy^T s_{c-1} (registers, 4 x 4 tiles a thread), and
//       writes its head group's db = dCB^T C + ... and dc = dCB B + ... .
//   (4) sum kernel: db and dc over the head groups in group order, in b's
//       dtype.
// Nothing is summed with atomics: each output element has one owner that
// adds its terms in a fixed order, so two calls on the same inputs agree
// bit for bit.  The mask exp(min(li, 0)) is 0 above the diagonal by a
// select, never 0 * inf; its derivative below the diagonal is 1 under 0,
// 1/2 at a tie (as JAX's min splits one) and 0 above, and the diagonal's
// li is 0 and cancels, so it is left out.
//
// Bound: operations at mamba2-370m's widths (N 128: the products over N
// and P are about 40 f32 flops a byte), bytes at hymba's (N 16).  The
// products run on CUDA cores in f32, a thread a 4 x 4 (or 2 x 2) tile of
// outputs with rows padded by one float so a warp's scalar loads of a
// column fall in distinct banks.  A simple, correct kernel first: a block
// walks its heads' phases in turn behind barriers, and shared memory
// (about 204 KB at q 64, N 128, P 64) allows one block an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;
constexpr int kAccTiles = 2;           // (q, N) 4 x 4 tiles a thread owns

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

__host__ __device__ inline int up4(int v) { return (v + 3) & ~3; }

// Shared-memory floats of the grad kernel and of the state kernel (rows
// padded by one float); the wrapper's ``bwd_smem_bytes`` mirrors them.
inline long long grad_floats(int q, int P, int N) {
  const long long q4 = up4(q), n4 = up4(N), p4 = up4(P);
  const long long sn = n4 + 1, sp = p4 + 1, sq = q4 + 1;
  const long long pst = p4 / 2 > n4 / 4 ? p4 / 2 : n4 / 4;
  return 2 * q4 * sn        // b, c
         + 4 * q4 * sq      // C B^T, dCB (the block's heads), W, Q
         + 2 * q4 * sp      // x, dy
         + p4 * sn          // G_c, then s_{c-1}
         + q4 * pst         // row partial sums
         + 6 * q4 + 4;      // cum, dt, e, f, dcum, f dt r; exp(cum_end), dE
}
inline long long state_floats(int q, int P, int N) {
  const long long q4 = up4(q), n4 = up4(N), p4 = up4(P);
  return q4 * (n4 + 1) + q4 * (p4 + 1) + 2 * q4;   // c, dy; cum, e
}

// acc[u][v] += sum_{r in [r0, r1)} A(i0 + u, r) (s_r B(r, j0 + v js)) with
// A(i, r) = A[i ai + r ar] and B(r, j) = B[r br + j bj]: a thread's rows
// are consecutive, its columns js apart (neighbouring threads take
// neighbouring columns); one multiply-add a term in r order.
template <int TI, int TJ, bool SCALE>
__device__ __forceinline__ void mmg(float (&acc)[TI][TJ], const float* A,
                                    int ai, int ar, const float* B, int br,
                                    int bj, int i0, int j0, int js, int r0,
                                    int r1, const float* s) {
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    float a[TI], b[TJ];
#pragma unroll
    for (int u = 0; u < TI; ++u) a[u] = A[(i0 + u) * ai + r * ar];
    const float sr = SCALE ? s[r] : 1.f;
#pragma unroll
    for (int v = 0; v < TJ; ++v) {
      b[v] = B[r * br + (j0 + v * js) * bj];
      if (SCALE) b[v] *= sr;
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

// Column groups of an I x J output (multiples of 4) cut in W x W tiles:
// 4 x 4, or 2 x 2 where 4 x 4 tiles would occupy fewer than half of the
// threads.
__device__ __forceinline__ int tile_cols(int I, int J) {
  return (I / 4) * (J / 4) >= kThreads / 2 ? J / 4 : J / 2;
}

// Calls f(W, i0, jc, cols) for the W x W tiles of an I x J output spread
// over the block: rows i0 .. i0 + W - 1, columns jc + v cols.
template <typename F>
__device__ __forceinline__ void tiles(int I, int J, F f) {
  const int cols = tile_cols(I, J);
  if (cols == J / 4) {
    for (int t = threadIdx.x; t < (I / 4) * cols; t += kThreads)
      f(std::integral_constant<int, 4>{}, (t / cols) * 4, t % cols, cols);
  } else {
    for (int t = threadIdx.x; t < (I / 2) * cols; t += kThreads)
      f(std::integral_constant<int, 2>{}, (t / cols) * 2, t % cols, cols);
  }
}

// Warp 0: the inclusive cumsum of la over the chunk, two positions a lane,
// by K3's scan; writes cum, e_t = exp(cum_t) and, where given, dt and f_t =
// exp(cum_end - cum_t) (0 past q); returns cum_end.
__device__ __forceinline__ float scan_chunk(const float* la, const float* dt,
                                            long long t0, int H, int h,
                                            int q, int q4, float* cum,
                                            float* dtv, float* ecum,
                                            float* fdec) {
  const int lane = threadIdx.x;
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
    if (t < q4) {
      cum[t] = cv;
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

// (1) Grid (chunks 1 .. n_chunks - 1, head groups, batch): U_c of each of
// the group's heads into gbuf.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_kernel(const T* __restrict__ c, const float* __restrict__ la,
                     const float* __restrict__ dy, float* __restrict__ gbuf,
                     int S, int H, int P, int N, int q, int hg) {
  extern __shared__ __align__(16) float smem[];
  const int q4 = up4(q), n4 = up4(N), p4 = up4(P);
  const int sn = n4 + 1, sp = p4 + 1;
  float* cs = smem;                       // (q4, sn) c
  float* dys = cs + q4 * sn;              // (q4, sp) dy
  float* cum = dys + q4 * sp;             // (q4)
  float* ecum = cum + q4;                 // (q4) exp(cum_t)
  const int tid = threadIdx.x;
  const int ic = blockIdx.x + 1, bz = blockIdx.z, n_chunks = S / q;
  const int h0 = blockIdx.y * hg, h1 = min(H, h0 + hg);
  const long long t0 = (long long)bz * S + (long long)ic * q;
  const long long PN = (long long)P * N;
  for (int i = tid; i < q4 * n4; i += kThreads) {
    const int t = i / n4, n = i - t * n4;
    cs[t * sn + n] = t < q && n < N ? to_f32(c[(t0 + t) * N + n]) : 0.f;
  }
  for (int h = h0; h < h1; ++h) {
    for (int i = tid; i < q4 * p4; i += kThreads) {
      const int t = i / p4, p = i - t * p4;
      dys[t * sp + p] =
          t < q && p < P ? dy[((t0 + t) * H + h) * (long long)P + p] : 0.f;
    }
    if (tid < 32)
      scan_chunk(la, nullptr, t0, H, h, q, q4, cum, nullptr, ecum, nullptr);
    __syncthreads();
    float* out = gbuf + (((long long)bz * n_chunks + ic) * H + h) * PN;
    // U[p][n] = sum_t dy[t][p] (e_t c[t][n])
    tiles(p4, n4, [&](auto tw, int i0, int jc, int cols) {
      constexpr int W = decltype(tw)::value;
      float acc[W][W];
      zero_tile(acc);
      mmg<W, W, true>(acc, dys, 1, sp, cs, sn, 1, i0, jc, cols, 0, q4, ecum);
#pragma unroll
      for (int u = 0; u < W; ++u)
#pragma unroll
        for (int v = 0; v < W; ++v) {
          const int p = i0 + u, n = jc + v * cols;
          if (p < P && n < N) out[(long long)p * N + n] = acc[u][v];
        }
    });
    __syncthreads();                      // before the next head's loads
  }
}

// (2) Grid (slices of P N, heads, batch); a thread V elements of the (P,
// N) state.  Reads U_c (c >= 1) and s_{c-1} = zbuf, writes G_c over U_c
// and each warp's share of d(decay_c); V = 4 moves 16 bytes at a time.
template <int V>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_pass_kernel(float* __restrict__ gbuf, const float* __restrict__ zbuf,
                    const float* __restrict__ decay,
                    const float* __restrict__ dstate,
                    float* __restrict__ d_decay, int n_chunks, int H,
                    long long PN, int n_parts) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const int slice = blockIdx.x, h = blockIdx.y, bz = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long e = ((long long)slice * kThreads + threadIdx.x) * V;
  const bool in = e < PN;
  float g[V];
#pragma unroll
  for (int v = 0; v < V; ++v) g[v] = 0.f;
  if (in && dstate != nullptr) {
    const Vec t = *reinterpret_cast<const Vec*>(
        dstate + ((long long)bz * H + h) * PN + e);
#pragma unroll
    for (int v = 0; v < V; ++v) g[v] = reinterpret_cast<const float*>(&t)[v];
  }
  for (int ic = n_chunks - 1; ic >= 0; --ic) {
    const long long base = (((long long)bz * n_chunks + ic) * H + h) * PN + e;
    float u[V], s[V];
#pragma unroll
    for (int v = 0; v < V; ++v) u[v] = s[v] = 0.f;
    if (in && ic > 0) {
      const Vec tu = *reinterpret_cast<const Vec*>(gbuf + base);
      const Vec ts = *reinterpret_cast<const Vec*>(zbuf + base);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        u[v] = reinterpret_cast<const float*>(&tu)[v];
        s[v] = reinterpret_cast<const float*>(&ts)[v];
      }
    }
    if (in) {
      Vec tg;
#pragma unroll
      for (int v = 0; v < V; ++v) reinterpret_cast<float*>(&tg)[v] = g[v];
      *reinterpret_cast<Vec*>(gbuf + base) = tg;
    }
    float part = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) part += g[v] * s[v];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    const long long ch = ((long long)bz * n_chunks + ic) * H + h;
    if (lane == 0)
      d_decay[ch * n_parts + slice * (kThreads / 32) + warp] = part;
    const float d = decay[ch];
#pragma unroll
    for (int v = 0; v < V; ++v) g[v] = d * g[v] + u[v];
  }
}

// (3) Grid (chunks, head groups, batch): see the design comment.  gsrc is
// G (gbuf, (B, n_chunks, H, P, N)) for several chunks, else dS (B, H, P, N)
// or null; sprev (zbuf) and d_decay are null for one chunk.  pdb, pdc
// (groups, B, S, N) take the head group's db and dc.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_grad_kernel(const T* __restrict__ x, const T* __restrict__ b,
                    const T* __restrict__ c, const float* __restrict__ la,
                    const float* __restrict__ dt,
                    const float* __restrict__ dy,
                    const float* __restrict__ gsrc,
                    const float* __restrict__ sprev,
                    const float* __restrict__ d_decay, int n_parts,
                    T* __restrict__ dx, float* __restrict__ dla,
                    float* __restrict__ ddt, float* __restrict__ pdb,
                    float* __restrict__ pdc, int B, int S, int H, int P,
                    int N, int q, int hg) {
  extern __shared__ __align__(16) float smem[];
  const int q4 = up4(q), n4 = up4(N), p4 = up4(P);
  const int sn = n4 + 1, sp = p4 + 1, sq = q4 + 1;
  const int pst = max(p4 / 2, n4 / 4);
  float* bs = smem;                       // (q4, sn) b [k][n]
  float* cs = bs + q4 * sn;               // (q4, sn) c [t][n]
  float* cbs = cs + q4 * sn;              // (q4, sq) C B^T [t][k]
  float* dcb = cbs + q4 * sq;             // (q4, sq) dCB, the block's heads
  float* ws = dcb + q4 * sq;              // (q4, sq) W [t][k]
  float* qs = ws + q4 * sq;               // (q4, sq) Q = dW D (C B^T)
  float* xs = qs + q4 * sq;               // (q4, sp) x [k][p]
  float* dys = xs + q4 * sp;              // (q4, sp) dy [t][p]
  float* gs = dys + q4 * sp;              // (p4, sn) G_c, then s_{c-1}
  float* part = gs + p4 * sn;             // (q4, pst) row partial sums
  float* cum = part + q4 * pst;           // (q4)
  float* dtv = cum + q4;                  // (q4) dt
  float* ecum = dtv + q4;                 // (q4) exp(cum_t)
  float* fdec = ecum + q4;                // (q4) exp(cum_end - cum_k)
  float* dcum = fdec + q4;                // (q4) the gradient of cum
  float* fdr = dcum + q4;                 // (q4) f_k dt_k r_k
  float* scal = fdr + q4;                 // exp(cum_end), d(decay_c)

  const int tid = threadIdx.x;
  const int ic = blockIdx.x, g = blockIdx.y, bz = blockIdx.z;
  const int n_chunks = S / q;
  const int h0 = g * hg, h1 = min(H, h0 + hg);
  const long long t0 = (long long)bz * S + (long long)ic * q;
  const long long PN = (long long)P * N;
  const bool inter = ic > 0 && sprev != nullptr;   // s_{c-1} is not 0

  for (int i = tid; i < q4 * n4; i += kThreads) {
    const int t = i / n4, n = i - t * n4;
    const bool in = t < q && n < N;
    const long long off = (t0 + t) * N + n;
    bs[t * sn + n] = in ? to_f32(b[off]) : 0.f;
    cs[t * sn + n] = in ? to_f32(c[off]) : 0.f;
  }
  for (int i = tid; i < q4 * sq; i += kThreads) dcb[i] = 0.f;
  __syncthreads();
  // C B^T [t][k] = sum_n c[t][n] b[k][n]
  tiles(q4, q4, [&](auto tw, int i0, int jc, int cols) {
    constexpr int W = decltype(tw)::value;
    float acc[W][W];
    zero_tile(acc);
    mmg<W, W, false>(acc, cs, sn, 1, bs, 1, sn, i0, jc, cols, 0, n4, nullptr);
#pragma unroll
    for (int u = 0; u < W; ++u)
#pragma unroll
      for (int v = 0; v < W; ++v)
        cbs[(i0 + u) * sq + jc + v * cols] = acc[u][v];
  });

  // the (q, N) tiles a thread sums over the heads: f dt x^T G (db) and
  // e dy^T s_{c-1} (dc)
  const int acc_cols = n4 / 4, acc_tiles = (q4 / 4) * acc_cols;
  float adb[kAccTiles][4][4], adc[kAccTiles][4][4];
#pragma unroll
  for (int j = 0; j < kAccTiles; ++j) {
    zero_tile(adb[j]);
    zero_tile(adc[j]);
  }

  for (int h = h0; h < h1; ++h) {
    // x, dy, G_c of head h; la scanned
    for (int i = tid; i < q4 * p4; i += kThreads) {
      const int t = i / p4, p = i - t * p4;
      const bool in = t < q && p < P;
      const long long off = ((t0 + t) * H + h) * (long long)P + p;
      xs[t * sp + p] = in ? to_f32(x[off]) : 0.f;
      dys[t * sp + p] = in ? dy[off] : 0.f;
    }
    const float* gp =
        gsrc == nullptr
            ? nullptr
            : gsrc + ((n_chunks > 1 ? (long long)bz * n_chunks + ic
                                    : (long long)bz) * H + h) * PN;
    for (int i = tid; i < p4 * n4; i += kThreads) {
      const int p = i / n4, n = i - p * n4;
      gs[p * sn + n] =
          gp != nullptr && p < P && n < N ? gp[(long long)p * N + n] : 0.f;
    }
    if (tid < 32) {
      const float cum_end =
          scan_chunk(la, dt, t0, H, h, q, q4, cum, dtv, ecum, fdec);
      for (int t = tid; t < q4; t += 32) dcum[t] = 0.f;
      if (tid == 0) {
        float dd = 0.f;
        if (inter && d_decay != nullptr) {
          const float* pp =
              d_decay + (((long long)bz * n_chunks + ic) * H + h) * n_parts;
          for (int i = 0; i < n_parts; ++i) dd += pp[i];
        }
        scal[0] = expf(cum_end);
        scal[1] = dd;
      }
    }
    __syncthreads();

    // dW[t][k] = dy_t . x_k; on the lower triangle W, Q and dCB += dW D dt
    tiles(q4, q4, [&](auto tw, int i0, int jc, int cols) {
      constexpr int W = decltype(tw)::value;
      float acc[W][W];
      zero_tile(acc);
      mmg<W, W, false>(acc, dys, sp, 1, xs, 1, sp, i0, jc, cols, 0, p4,
                       nullptr);
#pragma unroll
      for (int u = 0; u < W; ++u)
#pragma unroll
        for (int v = 0; v < W; ++v) {
          const int t = i0 + u, k = jc + v * cols, idx = t * sq + k;
          if (k <= t && t < q) {
            const float d = expf(fminf(cum[t] - cum[k], 0.f));
            const float cb = cbs[idx];
            ws[idx] = cb * d * dtv[k];
            dcb[idx] += acc[u][v] * d * dtv[k];
            qs[idx] = acc[u][v] * d * cb;
          } else {
            ws[idx] = 0.f;
            qs[idx] = 0.f;
          }
        }
    });
    __syncthreads();

    // dx[k][p] = sum_t W[t][k] dy[t][p] + f_k dt_k (G b_k)[p], with the
    // row partials of r_k = x_k . G b_k
    const int pcols = tile_cols(q4, p4);
    tiles(q4, p4, [&](auto tw, int i0, int jc, int cols) {
      constexpr int W = decltype(tw)::value;
      float a1[W][W], a2[W][W];
      zero_tile(a1);
      zero_tile(a2);
      mmg<W, W, false>(a1, ws, 1, sq, dys, sp, 1, i0, jc, cols, i0, q4,
                       nullptr);
      mmg<W, W, false>(a2, bs, sn, 1, gs, 1, sn, i0, jc, cols, 0, n4,
                       nullptr);
#pragma unroll
      for (int u = 0; u < W; ++u) {
        const int k = i0 + u;
        const float s = fdec[k] * dtv[k];
        float rp = 0.f;
#pragma unroll
        for (int v = 0; v < W; ++v) {
          const int p = jc + v * cols;
          if (k < q && p < P)
            dx[((t0 + k) * H + h) * (long long)P + p] =
                from_f32<T>(a1[u][v] + s * a2[u][v]);
          rp += xs[k * sp + p] * a2[u][v];
        }
        part[k * pst + jc] = rp;
      }
    });
    // db's head term: adb[k][n] += f_k dt_k sum_p x[k][p] G[p][n]
#pragma unroll
    for (int j = 0; j < kAccTiles; ++j) {
      const int tt = tid + j * kThreads;
      if (tt < acc_tiles) {
        const int i0 = (tt / acc_cols) * 4, jc = tt % acc_cols;
        float tmp[4][4];
        zero_tile(tmp);
        mmg<4, 4, false>(tmp, xs, sp, 1, gs, sn, 1, i0, jc, acc_cols, 0, p4,
                         nullptr);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float s = fdec[i0 + u] * dtv[i0 + u];
#pragma unroll
          for (int v = 0; v < 4; ++v) adb[j][u][v] += s * tmp[u][v];
        }
      }
    }
    __syncthreads();

    // per position j: ddt, and the gradient of cum from the mask and f
    if (tid < q) {
      const int j = tid;
      float r = 0.f;
      for (int col = 0; col < pcols; ++col) r += part[j * pst + col];
      float colq = 0.f;
      for (int t = j; t < q; ++t) colq += qs[t * sq + j];
      ddt[(t0 + j) * H + h] = colq + fdec[j] * r;
      float row = 0.f;
      for (int k = 0; k < j; ++k)
        row += qs[j * sq + k] * dtv[k] * dmin(cum[j] - cum[k]);
      float col = 0.f;
      for (int t = j + 1; t < q; ++t)
        col += qs[t * sq + j] * dmin(cum[t] - cum[j]);
      fdr[j] = fdec[j] * dtv[j] * r;
      dcum[j] = row - col * dtv[j] - fdr[j];
    }
    __syncthreads();
    // the chunk end's terms: sum_k f_k dt_k r_k and exp(cum_end) d(decay)
    if (tid == 0) {
      float s = 0.f;
      for (int k = 0; k < q; ++k) s += fdr[k];
      dcum[q - 1] += s + scal[0] * scal[1];
    }
    if (inter) {
      const float* spp =
          sprev + (((long long)bz * n_chunks + ic) * H + h) * PN;
      for (int i = tid; i < p4 * n4; i += kThreads) {
        const int p = i / n4, n = i - p * n4;
        gs[p * sn + n] = p < P && n < N ? spp[(long long)p * N + n] : 0.f;
      }
      __syncthreads();
      // dc's head term: adc[t][n] += e_t sum_p dy[t][p] s[p][n]; and the
      // row partials of e_t c_t . (s^T dy_t), cum's inter term
#pragma unroll
      for (int j = 0; j < kAccTiles; ++j) {
        const int tt = tid + j * kThreads;
        if (tt < acc_tiles) {
          const int i0 = (tt / acc_cols) * 4, jc = tt % acc_cols;
          float tmp[4][4];
          zero_tile(tmp);
          mmg<4, 4, false>(tmp, dys, sp, 1, gs, sn, 1, i0, jc, acc_cols, 0,
                           p4, nullptr);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int t = i0 + u;
            const float et = ecum[t];
            float rp = 0.f;
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const float val = et * tmp[u][v];
              adc[j][u][v] += val;
              rp += cs[t * sn + jc + v * acc_cols] * val;
            }
            part[t * pst + jc] = rp;
          }
        }
      }
      __syncthreads();
      if (tid < q) {
        float s = 0.f;
        for (int col = 0; col < acc_cols; ++col) s += part[tid * pst + col];
        dcum[tid] += s;
      }
    }
    __syncthreads();
    // dla: the reverse cumsum of dcum within the chunk
    if (tid < q) {
      float s = 0.f;
      for (int t = q - 1; t >= tid; --t) s += dcum[t];
      dla[(t0 + tid) * H + h] = s;
    }
    __syncthreads();                      // before the next head's loads
  }

  // the head group's db = dCB^T C + adb and dc = dCB B + adc
#pragma unroll
  for (int j = 0; j < kAccTiles; ++j) {
    const int tt = tid + j * kThreads;
    if (tt < acc_tiles) {
      const int i0 = (tt / acc_cols) * 4, jc = tt % acc_cols;
      float t1[4][4], t2[4][4];
      zero_tile(t1);
      zero_tile(t2);
      mmg<4, 4, false>(t1, dcb, 1, sq, cs, sn, 1, i0, jc, acc_cols, 0, q4,
                       nullptr);
      mmg<4, 4, false>(t2, dcb, sq, 1, bs, sn, 1, i0, jc, acc_cols, 0, q4,
                       nullptr);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int row = i0 + u, n = jc + v * acc_cols;
          if (row < q && n < N) {
            const long long o =
                (((long long)g * B + bz) * S + (long long)ic * q + row) * N + n;
            pdb[o] = t1[u][v] + adb[j][u][v];
            pdc[o] = t2[u][v] + adc[j][u][v];
          }
        }
    }
  }
}

// (4) db and dc: the head groups' partials summed in group order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_sum_kernel(const float* __restrict__ pdb,
                   const float* __restrict__ pdc, T* __restrict__ db,
                   T* __restrict__ dc, long long total, int groups) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
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

template <typename T>
int launch(const void* x, const void* b, const void* c, const float* la,
           const float* dt, const float* dy, const float* dstate,
           const float* zbuf, const float* decay, float* gbuf,
           float* d_decay, void* dx, void* db, void* dc, float* dla,
           float* ddt, float* pdb, float* pdc, int B, int S, int H, int P,
           int N, int q, int hg, int n_parts, cudaStream_t stream) {
  const int n_chunks = S / q, groups = (H + hg - 1) / hg;
  const long long PN = (long long)P * N;
  int rc;
  if (n_chunks > 1) {
    const size_t smem = (size_t)state_floats(q, P, N) * sizeof(float);
    rc = allow_smem(ssd_bwd_state_kernel<T>, smem);
    if (rc) return rc;
    ssd_bwd_state_kernel<T><<<dim3(n_chunks - 1, groups, B), kThreads, smem,
                              stream>>>(static_cast<const T*>(c), la, dy,
                                        gbuf, S, H, P, N, q, hg);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    const int v = PN % 4 == 0 ? 4 : 1;
    const dim3 grid((unsigned)((PN + (long long)kThreads * v - 1) /
                               ((long long)kThreads * v)),
                    H, B);
    if (v == 4)
      ssd_bwd_pass_kernel<4><<<grid, kThreads, 0, stream>>>(
          gbuf, zbuf, decay, dstate, d_decay, n_chunks, H, PN, n_parts);
    else
      ssd_bwd_pass_kernel<1><<<grid, kThreads, 0, stream>>>(
          gbuf, zbuf, decay, dstate, d_decay, n_chunks, H, PN, n_parts);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  const size_t smem = (size_t)grad_floats(q, P, N) * sizeof(float);
  rc = allow_smem(ssd_bwd_grad_kernel<T>, smem);
  if (rc) return rc;
  ssd_bwd_grad_kernel<T><<<dim3(n_chunks, groups, B), kThreads, smem,
                           stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b),
      static_cast<const T*>(c), la, dt, dy, n_chunks > 1 ? gbuf : dstate,
      n_chunks > 1 ? zbuf : nullptr, n_chunks > 1 ? d_decay : nullptr,
      n_parts, static_cast<T*>(dx), dla, ddt, pdb, pdc, B, S, H, P, N, q, hg);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const long long total = (long long)B * S * N;
  ssd_bwd_sum_kernel<T><<<(unsigned)((total + kThreads - 1) / kThreads),
                          kThreads, 0, stream>>>(
      pdb, pdc, static_cast<T*>(db), static_cast<T*>(dc), total, groups);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, b, c and dx, db, dc; la, dt, dy,
// dstate, dla, ddt are float32).  hg heads a block of the grad kernel.
// With S > q: zbuf (B, S / q, H, P, N) holds the state entering each chunk
// and decay (B, S / q, H) each chunk's exp(cum_end), as K3 left them; gbuf
// (B, S / q, H, P, N) and d_decay (B, S / q, H, n_parts) are scratch
// (n_parts = 8 ceil(P N / (256 V)), V = 4 if P N % 4 == 0 else 1).  pdb and
// pdc (ceil(H / hg), B, S, N) are scratch.  dstate may be null (zero).  A
// call is four launches for S > q, else two.  Returns 0 on success, -1 for
// an unsupported argument, else the cudaError_t of a launch.
int mars_ssd_scan_bwd(int dtype, const void* x, const void* b, const void* c,
                      const float* la, const float* dt, const float* dy,
                      const float* dstate, const float* zbuf,
                      const float* decay, float* gbuf, float* d_decay,
                      void* dx, void* db, void* dc, float* dla, float* ddt,
                      float* pdb, float* pdc, int B, int S, int H, int P,
                      int N, int q, int hg, int n_parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q < 1 || q > kMaxChunk || S % q != 0 || hg < 1 || B < 1 ||
      B > 65535 || H < 1 || H > 65535 || P < 1 || N < 1 ||
      (H + hg - 1) / hg > 65535)
    return -1;
  if ((long long)(up4(q) / 4) * (up4(N) / 4) > (long long)kAccTiles * kThreads)
    return -1;
  if (grad_floats(q, P, N) * (long long)sizeof(float) > kMaxSmem ||
      state_floats(q, P, N) * (long long)sizeof(float) > kMaxSmem)
    return -1;
  if (S != q) {
    const long long PN = (long long)P * N;
    const long long v = PN % 4 == 0 ? 4 : 1;
    const long long slices = (PN + kThreads * v - 1) / (kThreads * v);
    if (zbuf == nullptr || decay == nullptr || gbuf == nullptr ||
        d_decay == nullptr || n_parts != slices * (kThreads / 32) ||
        slices > 0x7fffffffLL)
      return -1;
  }
  if (dtype == 0)
    return launch<float>(x, b, c, la, dt, dy, dstate, zbuf, decay, gbuf,
                         d_decay, dx, db, dc, dla, ddt, pdb, pdc, B, S, H, P,
                         N, q, hg, n_parts, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, b, c, la, dt, dy, dstate, zbuf, decay,
                                 gbuf, d_decay, dx, db, dc, dla, ddt, pdb, pdc,
                                 B, S, H, P, N, q, hg, n_parts, s);
  return -1;
}

const char* mars_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
