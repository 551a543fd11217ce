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
// is 16, 64, 112 or 128.
//
// Bound: operations at the path's long shapes.  Whisper-base's encoder
// self-attention (B 8, S 1500, 8 heads of 64) does 4 B H S^2 D = 36.9
// GFLOP, 37 us at 989 TFLOP/s on an H100 SXM, while its q, k, v and o are
// 24.6 MB, 7 us at 3.35 TB/s.  Short prefills (24 tokens) and
// cross-attention at decode (1 query over 1500 keys) are bound by bytes
// and by the launch.
//
// Design.  On the TPU the grid is (B*H, query tile, KV tile) with the KV
// axis innermost and sequential, (m, l, acc) carried in VMEM scratch,
// and a fully masked KV tile costs a branch.  Here one block owns one
// (query tile, batch-head) and walks the KV tiles itself, so nothing is
// carried between blocks; in causal mode the walk stops at the tile that
// holds the block's last query row, so masked tiles are never loaded,
// and the query tiles run last-first so the longest walks start first.
// bfloat16: 4 warps own 16 query rows each of a 64-row tile; the q tile
// is loaded once into registers as mma fragments, and 64-key K and V
// tiles stream through a two-stage shared-memory ring with 16-byte
// cp.async (the next tile lands while this one is multiplied).  Q K^T
// and P V run on the tensor cores with mma.sync m16n8k16 (fragments
// from ldmatrix; V with ldmatrix.trans); the score accumulators are
// reused in registers as the A operand of P V after the online-softmax
// update, so scores never touch shared memory.  Rows are padded by 16
// bytes so ldmatrix's eight row reads hit distinct banks.  float32 runs
// on CUDA cores (it serves the exact float32 checks): 32 query rows by
// 32 keys a step, scores and probabilities staged in shared memory, 8
// threads a query row.  Later work (ROADMAP): wgmma and TMA with warp
// specialisation, and a split of the keys over blocks for the one-query
// cross-attention at decode, where a 64-row tile does 1/64 useful work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDefaultSmem = 48 * 1024;

// ---- bfloat16: tensor cores -------------------------------------------------
constexpr int kThreads = 128;          // 4 warps x 16 query rows
constexpr int kBQ = 64;                // query rows a block owns
constexpr int kBK = 64;                // keys a pipeline stage holds

// ---- float32: CUDA cores ----------------------------------------------------
constexpr int kFThreads = 256;         // 8 threads a query row
constexpr int kFBQ = 32;
constexpr int kFBK = 32;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
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
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(s));
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

// `rows` rows of D bf16 from global (row stride `rs` elements, `valid`
// rows available) into shared rows of D + 8; rows past `valid` are zero.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long rs, int valid, int rows) {
  constexpr int kChunks = D / 8;       // 16-byte chunks a row
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks, dc = (c - r * kChunks) * 8;
    __nv_bfloat16* d = dst + r * (D + 8) + dc;
    if (r < valid)
      cp_async16(d, src + (long long)r * rs + dc);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int H, int Sq, int Sk,
                       float scale_log2, int causal) {
  constexpr int kPitch = D + 8;
  constexpr int kKSteps = D / 16;      // 16-deep steps of q k^T
  constexpr int kNT = D / 8;           // 8-column tiles of the output
  constexpr int kST = kBK / 8;         // 8-key tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBQ * kPitch;         // [2][kBK][kPitch]
  __nv_bfloat16* vs = ks + 2 * kBK * kPitch;     // [2][kBK][kPitch]

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H;
  const int q0 = qt * kBQ;
  const long long rs = (long long)H * D;         // elements per position
  const __nv_bfloat16* qb = q + ((long long)b * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + ((long long)b * Sk * H + h) * D;
  const __nv_bfloat16* vb = v + ((long long)b * Sk * H + h) * D;
  __nv_bfloat16* ob = o + ((long long)b * Sq * H + h) * D;

  int n_kv = (Sk + kBK - 1) / kBK;
  if (causal) n_kv = min(n_kv, (min(q0 + kBQ, Sq) - 1) / kBK + 1);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, mat = lane >> 3;
  const int row_lo = q0 + warp * 16;             // this warp's first row

  load_tile<D>(qs, qb + (long long)q0 * rs, rs, Sq - q0, kBQ);
  if (n_kv > 0) {
    load_tile<D>(ks, kb, rs, Sk, kBK);
    load_tile<D>(vs, vb, rs, Sk, kBK);
  }
  cp_async_commit();

  uint32_t qf[kKSteps][4];
  float acc[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int j = 0; j < n_kv; ++j) {
    if (j + 1 < n_kv) {                          // prefetch tile j + 1
      const int k1 = (j + 1) * kBK, st = (j + 1) & 1;
      load_tile<D>(ks + st * kBK * kPitch, kb + (long long)k1 * rs, rs,
                   Sk - k1, kBK);
      load_tile<D>(vs + st * kBK * kPitch, vb + (long long)k1 * rs, rs,
                   Sk - k1, kBK);
    }
    cp_async_commit();
    cp_async_wait<1>();                          // tile j (and q) landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const int row = warp * 16 + (mat & 1) * 8 + (lane & 7);
        ldmatrix_x4(qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
                    qs + row * kPitch + kk * 16 + (mat >> 1) * 8);
      }
    }
    const __nv_bfloat16* kst = ks + (j & 1) * kBK * kPitch;
    const __nv_bfloat16* vst = vs + (j & 1) * kBK * kPitch;
    const int k0 = j * kBK;

    // s = q k^T: rows g and g + 8 of the warp, keys nt*8 + 2 t4 (+1)
    float s[kST][4];
#pragma unroll
    for (int nt = 0; nt < kST; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int np = 0; np < kST / 2; ++np) {
        uint32_t b0, b1, b2, b3;
        const int key = np * 16 + (mat >> 1) * 8 + (lane & 7);
        ldmatrix_x4(b0, b1, b2, b3,
                    kst + key * kPitch + kk * 16 + (mat & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], b0, b1);
        mma_bf16(s[2 * np + 1], qf[kk], b2, b3);
      }
    }
    const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > row_lo);
#pragma unroll
    for (int nt = 0; nt < kST; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (edge) {
          const int kpos = k0 + nt * 8 + 2 * t4 + (e & 1);
          const int qpos = row_lo + g + 8 * (e >> 1);
          if (kpos >= Sk || (causal && kpos > qpos)) x = kNegInf;
        }
        s[nt][e] = x;
      }
    }

    // online softmax (log2 units), rows g (r = 0) and g + 8 (r = 1); the
    // four threads of a quad share a row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kST; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const float alpha = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kST; ++nt) {
        const float p0 = exp2f(s[nt][2 * r] - m_new);
        const float p1 = exp2f(s[nt][2 * r + 1] - m_new);
        s[nt][2 * r] = p0;
        s[nt][2 * r + 1] = p1;
        sum += p0 + p1;
      }
      l_run[r] = l_run[r] * alpha + sum;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        acc[nt][2 * r] *= alpha;
        acc[nt][2 * r + 1] *= alpha;
      }
    }

    // acc += p v, p rounded to bf16: the score tiles 2 kc and 2 kc + 1
    // are the A fragment of the 16 keys kc*16 ..
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dp = 0; dp < kNT / 2; ++dp) {
        uint32_t b0, b1, b2, b3;
        const int krow = kc * 16 + (mat & 1) * 8 + (lane & 7);
        ldmatrix_x4_trans(b0, b1, b2, b3,
                          vst + krow * kPitch + dp * 16 + (mat >> 1) * 8);
        mma_bf16(acc[2 * dp], a, b0, b1);
        mma_bf16(acc[2 * dp + 1], a, b2, b3);
      }
    }
    __syncthreads();                 // stage j & 1 is refilled next
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int row = row_lo + g + 8 * r;
    if (row < Sq) {
      __nv_bfloat16* orow = ob + (long long)row * rs;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8 + 2 * t4) =
            __floats2bfloat162_rn(acc[nt][2 * r] / l, acc[nt][2 * r + 1] / l);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kFThreads)
flash_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      int H, int Sq, int Sk, float scale_log2, int causal) {
  constexpr int kQP = D + 1;            // padded row of q and k
  constexpr int kSP = kFBK + 1;         // padded row of the scores
  constexpr int kPer = D / 8;           // output columns a thread owns
  extern __shared__ float fsm[];
  float* qs = fsm;                      // [kFBQ][kQP]
  float* ks = qs + kFBQ * kQP;          // [kFBK][kQP]
  float* vs = ks + kFBK * kQP;          // [kFBK][D]
  float* ps = vs + kFBK * D;            // [kFBQ][kSP] scores, then p
  float* ms = ps + kFBQ * kSP;          // [kFBQ] running max (log2 units)
  float* ls = ms + kFBQ;                // [kFBQ] running sum
  float* as = ls + kFBQ;                // [kFBQ] this step's rescale

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H;
  const int q0 = qt * kFBQ;
  const long long rs = (long long)H * D;
  const float* qb = q + ((long long)b * Sq * H + h) * D;
  const float* kb = k + ((long long)b * Sk * H + h) * D;
  const float* vb = v + ((long long)b * Sk * H + h) * D;
  float* ob = o + ((long long)b * Sq * H + h) * D;

  int n_kv = (Sk + kFBK - 1) / kFBK;
  if (causal) n_kv = min(n_kv, (min(q0 + kFBQ, Sq) - 1) / kFBK + 1);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = tid >> 3, col = tid & 7;   // a query row, 8 threads each
  for (int i = tid; i < kFBQ * D; i += kFThreads) {
    const int r = i / D, d = i - r * D;
    qs[r * kQP + d] = q0 + r < Sq ? qb[(long long)(q0 + r) * rs + d] : 0.f;
  }
  if (tid < kFBQ) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kFBK;
    __syncthreads();                   // the last step is done with k, v, p
    for (int i = tid; i < kFBK * D; i += kFThreads) {
      const int r = i / D, d = i - r * D;
      const bool in = k0 + r < Sk;
      const long long off = (long long)(k0 + r) * rs + d;
      ks[r * kQP + d] = in ? kb[off] : 0.f;
      vs[r * D + d] = in ? vb[off] : 0.f;
    }
    __syncthreads();
    // scores: row `row`, keys col + 8 i
#pragma unroll
    for (int i = 0; i < kFBK / 8; ++i) {
      const int c = col + 8 * i;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot += qs[row * kQP + d] * ks[c * kQP + d];
      float x = dot * scale_log2;
      const int kpos = k0 + c, qpos = q0 + row;
      if (kpos >= Sk || (causal && kpos > qpos)) x = kNegInf;
      ps[row * kSP + c] = x;
    }
    __syncthreads();
    // online softmax: warp w takes rows 4w .. 4w + 3, a lane a key
#pragma unroll
    for (int rr = 0; rr < kFBQ / 8; ++rr) {
      const int r = warp * (kFBQ / 8) + rr;
      const float x = ps[r * kSP + lane];
      const float m_old = ms[r], l_old = ls[r];
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_old, mx);
      const float p = exp2f(x - m_new);
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
    for (int kk = 0; kk < kFBK; ++kk) {
      const float p = ps[row * kSP + kk];
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] += p * vs[kk * D + col + 8 * i];
    }
  }
  __syncthreads();
  if (q0 + row < Sq) {
    const float l = fmaxf(ls[row], 1e-30f);
    float* orow = ob + (long long)(q0 + row) * rs;
#pragma unroll
    for (int i = 0; i < kPer; ++i) orow[col + 8 * i] = acc[i] / l;
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem, bool* done) {
  if (smem <= (size_t)kDefaultSmem || *done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  *done = true;
  return 0;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int H, int Sq, int Sk, float scale_log2, int causal,
                cudaStream_t s) {
  static bool attr_set = false;
  const size_t smem = (size_t)(kBQ + 4 * kBK) * (D + 8) * sizeof(__nv_bfloat16);
  const int rc = allow_smem(flash_attn_bf16_kernel<D>, smem, &attr_set);
  if (rc) return rc;
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)(B * H));
  flash_attn_bf16_kernel<D><<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, Sq, Sk, scale_log2, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int H, int Sq, int Sk, float scale_log2, int causal,
               cudaStream_t s) {
  static bool attr_set = false;
  const size_t smem =
      (size_t)(kFBQ * (D + 1) + kFBK * (D + 1) + kFBK * D +
               kFBQ * (kFBK + 1) + 3 * kFBQ) * sizeof(float);
  const int rc = allow_smem(flash_attn_f32_kernel<D>, smem, &attr_set);
  if (rc) return rc;
  const dim3 grid((unsigned)((Sq + kFBQ - 1) / kFBQ), (unsigned)(B * H));
  flash_attn_f32_kernel<D><<<grid, kFThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Sq, Sk,
      scale_log2, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int B, int H, int Sq, int Sk, float scale_log2, int causal,
           cudaStream_t s) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, B, H, Sq, Sk, scale_log2, causal, s);
  if (dtype == 1)
    return launch_bf16<D>(q, k, v, o, B, H, Sq, Sk, scale_log2, causal, s);
  return -1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike); q, k, v and o
// contiguous, 16-byte aligned.  scale: the softmax scale (1 / sqrt(D)).
// Returns 0 on success, -1 for an unsupported argument (head dim, dtype,
// causal with Sq != Sk, B * H above the grid's 65535), else the
// cudaError_t of the launch.
int mars_flash_attention(int dtype, const void* q, const void* k,
                         const void* v, void* o, int B, int H, int Sq, int Sk,
                         int D, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk < 0 || (long long)B * H > 65535)
    return -1;
  if (causal && Sq != Sk) return -1;
  const float sl = scale * kLog2e;
  switch (D) {
    case 16: return launch<16>(dtype, q, k, v, o, B, H, Sq, Sk, sl, causal, s);
    case 64: return launch<64>(dtype, q, k, v, o, B, H, Sq, Sk, sl, causal, s);
    case 112:
      return launch<112>(dtype, q, k, v, o, B, H, Sq, Sk, sl, causal, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, B, H, Sq, Sk, sl, causal, s);
    default: return -1;
  }
}

const char* mars_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
