// Paged-KV decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_kernel` / `paged_attention` in
// src/repro/kernels/paged_attention/paged_attention.py: one decode query
// per lane attends that lane's cached KV, read page by page through its
// page table from a layered pool (L, P, page, Hkv, D); GQA folds n_rep
// query heads onto each KV head; a position is valid iff it lies in
// [window_lo, lengths[b]); online softmax in f32 with NEG_INF = -1e30 and
// o = acc / max(l, 1e-30).  Returns o in q's dtype and the softmax state
// (m, l) in f32 so the caller can merge the in-flight token.
//
// Bound: one decode step does ~1 flop per byte of K/V, so the kernel is
// bound by memory: its floor is the bytes of the *valid* K and V pages it
// must read (plus q and the outputs) over 3.35 TB/s on an H100 SXM.
//
// Design.  On the TPU the grid (B, n_pages) runs in order and carries the
// softmax state across grid steps in VMEM, and an index-map clamp keeps
// out-of-range pages from being fetched.  On Hopper blocks run in
// parallel and carry nothing, so:
//   * one thread block per (lane b, kv head g, chunk of <= 16 query heads
//     of g's group): grid (B, Hkv, ceil(n_rep / 16));
//   * the block computes its own page range j0 = max(lo, 0) / page ..
//     jmax = (lengths[b] - 1) / page and loops over it, so pages outside
//     the window or past the length are never read (this loop replaces the
//     clamp); every page in the range holds at least one valid position;
//   * per page it reads page_tables[b, j], offsets into plane `layer` by
//     stride, and stages the (page, D) K and V slices of head g in shared
//     memory with 16-byte coalesced loads;
//   * scores: one warp per (query head, token) pair, lanes split D,
//     shuffle-reduce; softmax update: one thread per query head keeps
//     m and l in registers; acc (n_rep, D) in f32 registers spread over
//     the block's threads;
//   * `layer` and `window` are runtime ints: one build serves every layer
//     and any global/window layout;
//   * an empty lane (length 0, or window == 1) writes o = 0, m = -1e30,
//     l = 0 exactly, so the caller's merge sees exp(m - m2) == 0.
// No TMA / wgmma: the kernel is bandwidth-bound and simple first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 16;       // query heads handled by one block
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D, int PAGE>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ page_tables,
                       const int* __restrict__ lengths, T* __restrict__ o,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       int H, int Hkv, int n_pages, long long plane_stride,
                       int layer, int window, float scale) {
  constexpr int kVec = 16 / sizeof(T);          // elements per 16-byte load
  constexpr int kRowVecs = D / kVec;            // 16-byte loads per token row
  constexpr int kAcc = kMaxRep * D / kThreads;  // accumulators per thread

  __shared__ __align__(16) T k_s[PAGE * D];
  __shared__ __align__(16) T v_s[PAGE * D];
  __shared__ float q_s[kMaxRep * D];
  __shared__ float p_s[kMaxRep * PAGE];         // scores, then probabilities
  __shared__ float r_s[kMaxRep];                // per-head alpha, then l

  const int b = blockIdx.x, g = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_rep = H / Hkv;
  const int r0 = blockIdx.z * kMaxRep;
  const int nr = min(kMaxRep, n_rep - r0);
  const long long head0 = (long long)b * H + (long long)g * n_rep + r0;

  for (int e = tid; e < nr * D; e += kThreads) q_s[e] = to_f32(q[head0 * D + e]);

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;                   // owned by threads tid < nr

  const int ln = lengths[b];
  const int lo = window > 0 ? ln - window + 1 : 0;
  if (ln > 0 && lo < ln) {                      // uniform over the block
    const int j0 = max(lo, 0) / PAGE;
    const int jmax = min((ln - 1) / PAGE, n_pages - 1);
    const T* kbase = k_pages + (long long)layer * plane_stride;
    const T* vbase = v_pages + (long long)layer * plane_stride;
    for (int j = j0; j <= jmax; ++j) {
      const long long blk = page_tables[(long long)b * n_pages + j];
      __syncthreads();                          // last page's readers done
      for (int c = tid; c < PAGE * kRowVecs; c += kThreads) {
        const int t = c / kRowVecs, dv = c % kRowVecs;
        const long long off = ((blk * PAGE + t) * Hkv + g) * D + dv * kVec;
        reinterpret_cast<uint4*>(k_s)[c] =
            *reinterpret_cast<const uint4*>(kbase + off);
        reinterpret_cast<uint4*>(v_s)[c] =
            *reinterpret_cast<const uint4*>(vbase + off);
      }
      __syncthreads();
      const int base = j * PAGE;
      for (int pr = warp; pr < nr * PAGE; pr += kWarps) {
        const int r = pr / PAGE, t = pr % PAGE;
        float sum = 0.f;
#pragma unroll
        for (int d = lane; d < D; d += 32)
          sum += q_s[r * D + d] * to_f32(k_s[t * D + d]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          const int pos = base + t;
          p_s[pr] = (pos < ln && pos >= lo) ? sum * scale : kNegInf;
        }
      }
      __syncthreads();
      if (tid < nr) {
        float mx = m;
#pragma unroll
        for (int t = 0; t < PAGE; ++t) mx = fmaxf(mx, p_s[tid * PAGE + t]);
        const float alpha = expf(m - mx);
        float psum = 0.f;
#pragma unroll
        for (int t = 0; t < PAGE; ++t) {
          const float p = expf(p_s[tid * PAGE + t] - mx);
          p_s[tid * PAGE + t] = p;
          psum += p;
        }
        l = l * alpha + psum;
        m = mx;
        r_s[tid] = alpha;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int e = tid + i * kThreads;
        if (e < nr * D) {
          const int r = e / D, d = e % D;
          float a = acc[i] * r_s[r];
#pragma unroll
          for (int t = 0; t < PAGE; ++t)
            a += p_s[r * PAGE + t] * to_f32(v_s[t * D + d]);
          acc[i] = a;
        }
      }
    }
  }
  __syncthreads();
  if (tid < nr) {
    r_s[tid] = l;
    m_out[head0 + tid] = m;
    l_out[head0 + tid] = l;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < nr * D)
      o[head0 * D + e] = from_f32<T>(acc[i] / fmaxf(r_s[e / D], 1e-30f));
  }
}

template <typename T, int D, int PAGE>
void launch(const void* q, const void* k, const void* v, const int* pt,
            const int* lengths, void* o, float* m, float* l, int B, int H,
            int Hkv, int n_pages, long long plane_stride, int layer,
            int window, float scale, cudaStream_t stream) {
  const int n_rep = H / Hkv;
  dim3 grid(B, Hkv, (n_rep + kMaxRep - 1) / kMaxRep);
  paged_attention_kernel<T, D, PAGE><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pt, lengths, static_cast<T*>(o), m, l, H, Hkv,
      n_pages, plane_stride, layer, window, scale);
}

template <typename T, int D>
bool launch_page(int page, const void* q, const void* k, const void* v,
                 const int* pt, const int* lengths, void* o, float* m,
                 float* l, int B, int H, int Hkv, int n_pages,
                 long long plane_stride, int layer, int window, float scale,
                 cudaStream_t s) {
  switch (page) {
    case 4: launch<T, D, 4>(q, k, v, pt, lengths, o, m, l, B, H, Hkv, n_pages,
                            plane_stride, layer, window, scale, s); return true;
    case 8: launch<T, D, 8>(q, k, v, pt, lengths, o, m, l, B, H, Hkv, n_pages,
                            plane_stride, layer, window, scale, s); return true;
    case 16: launch<T, D, 16>(q, k, v, pt, lengths, o, m, l, B, H, Hkv,
                              n_pages, plane_stride, layer, window, scale, s);
      return true;
    default: return false;
  }
}

template <typename T>
bool launch_dim(int D, int page, const void* q, const void* k, const void* v,
                const int* pt, const int* lengths, void* o, float* m,
                float* l, int B, int H, int Hkv, int n_pages,
                long long plane_stride, int layer, int window, float scale,
                cudaStream_t s) {
  switch (D) {
    case 64: return launch_page<T, 64>(page, q, k, v, pt, lengths, o, m, l, B,
                                       H, Hkv, n_pages, plane_stride, layer,
                                       window, scale, s);
    case 128: return launch_page<T, 128>(page, q, k, v, pt, lengths, o, m, l,
                                         B, H, Hkv, n_pages, plane_stride,
                                         layer, window, scale, s);
    default: return false;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pages and o share it).
// Returns 0 on success, -1 for an unsupported (dtype, D, page), else the
// cudaError_t of the launch.
int mars_paged_attention(int dtype, const void* q, const void* k_pages,
                         const void* v_pages, const int* page_tables,
                         const int* lengths, void* o, float* m, float* l,
                         int B, int H, int Hkv, int D, int page, int n_pages,
                         long long plane_stride, int layer, int window,
                         float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0)
    ok = launch_dim<float>(D, page, q, k_pages, v_pages, page_tables, lengths,
                           o, m, l, B, H, Hkv, n_pages, plane_stride, layer,
                           window, scale, s);
  else if (dtype == 1)
    ok = launch_dim<__nv_bfloat16>(D, page, q, k_pages, v_pages, page_tables,
                                   lengths, o, m, l, B, H, Hkv, n_pages,
                                   plane_stride, layer, window, scale, s);
  if (!ok) return -1;
  return static_cast<int>(cudaGetLastError());
}

const char* mars_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
