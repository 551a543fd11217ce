// Paged-KV decode attention for Hopper (sm_90a), plain C interface: a
// split pass over the pages and a merge pass.
//
// Replaces the Pallas TPU kernel `_kernel` / `paged_attention` in
// src/repro/kernels/paged_attention/paged_attention.py, and the
// in-flight token's merge step of its `decode_attend`: one decode query
// per lane attends that lane's cached KV, read page by page through its
// page table from a layered pool (L, P, page, Hkv, D); GQA folds n_rep
// query heads onto each KV head; a position is valid iff it lies in
// [window_lo, lengths[b]); online softmax in f32 with NEG_INF = -1e30 and
// o = acc / max(l, 1e-30).  `paged_attention` returns o in q's dtype and
// the softmax state (m, l) in f32; `decode_attend` also folds in the
// in-flight token (k_new, v_new: not in the pool yet) and returns o.
//
// Bound: a decode step does about 1 flop per byte of K/V, so the function
// is bound by memory: the bytes of the *valid* K and V rows (plus q, the
// page-table entries and the outputs) over 3.35 TB/s on an H100 SXM.
// Reaching it takes enough blocks to cover 132 SMs and tens of KB of
// loads in flight on each SM.
//
// Design.  On the TPU the grid (B, n_pages) runs in order and carries the
// softmax state across grid steps in VMEM, and an index-map clamp keeps
// out-of-range pages from being fetched.  Here:
//   * Split pass, grid (n_split, Hkv x query-head chunks of 16, B), 128
//     threads.  The pages [0, n_pages) are cut into n_split contiguous
//     ranges of pages_per_split; block (s, g, b) walks the part of range
//     s inside the lane's [j0, jmax] (j0 = max(lo, 0) / page, jmax =
//     (lengths[b] - 1) / page), so pages outside the window or past the
//     length are never read; a range wholly outside writes the empty state
//     (acc 0, m -1e30, l 0) and reads no page.  The host picks n_split
//     from shapes alone (`split_plan` in the wrapper: about 4 blocks an SM
//     before empty ranges, each range a whole number of 64-token stages),
//     never from `lengths`, which it does not read back.  One lane and KV
//     head thus spread over up to n_split SMs instead of one.
//   * Loads in flight: K and V stream through a 3-stage shared-memory ring
//     of 64 tokens a stage (several pages), 16-byte cp.async.cg copies,
//     commit_group / wait_group: while a stage is computed the next two
//     are in flight (37-70 KB a block in bfloat16 at D 64-128, with 3 or
//     2 blocks an SM).
//     Warp w loads page slots w, w + 4, ... of a stage; the page-table
//     entries of a stage are read one stage before its copies are issued.
//   * All n_rep query heads of KV head g (up to 16) sit in one block, so
//     each K/V row is read once for all of them.  Each warp takes 16 of
//     the stage's 64 keys and keeps its own softmax state, updated once
//     a stage; the four states are merged in shared memory at the end.
//     bfloat16: q.k^T and p.v run on the tensor cores (mma.sync m16n8k16,
//     the query heads padded to 16 rows); the two 8-key score tiles are
//     the A fragment of p.v, so p never leaves the registers.  p goes in
//     as a bf16 head plus a bf16 remainder (two products; the tensor
//     cores have time to spare here), so p.v is as exact as f32 p times
//     the bf16 v, and the result stays that of the f32 reference, which
//     a bf16 p would move by up to 2^-9 of each term.  With n_rep 1
//     (qwen1.5-0.5b) 15 of the 16 rows are padding: there the split and
//     the ring carry the gain, not the tensor cores.  float32 runs on the
//     CUDA cores (it serves the exact float32 checks): a lane owns one
//     key and half the query heads for q.k (full-D dot products, no
//     shuffle per score), p goes through shared memory to p.v.
//   * Merge pass, one block per (lane, query head), a thread per element
//     of o: merges the n_split partial states (exp(m_s - M) weights),
//     and for decode_attend the in-flight token as one more partial
//     (score q.k_new / sqrt(D)), and writes o in q's dtype (plus m and l
//     for paged_attention).  As in the reference's decode_attend, the
//     cached positions' o is rounded to q's dtype before the token's
//     merge (merging from the f32 accumulators instead moved arctic's
//     served bf16 tokens past the teacher-forced check at a router near
//     tie; PERF.md §6 and ROADMAP.md §3 give the run).
//   * float8_e4m3fn pages (a KV cache stored in fp8, the reference's
//     cfg.kv_dtype) with float32 or bfloat16 q: the ring holds the fp8
//     rows as they lie in the pool (16-byte cp.async, half the bytes of
//     bf16), and once a stage has landed the block widens it into one
//     stage buffer of q's dtype (cvt.f16x2.e4m3x2, then to f32 or bf16:
//     every e4m3 value, subnormals included, is exact in both), which the
//     unchanged bf16 or f32 stage code then reads.  So the result is the
//     reference's cast of the pages to f32 followed by the same
//     arithmetic.  The in-flight token and the partial states keep q's
//     dtype and f32.
//   * `layer` and `window` are runtime ints: one build serves every layer
//     and any global/window layout.  An empty lane (length 0, or window
//     == 1) gives o = 0, m = -1e30, l = 0 exactly.  Block ids are not
//     clamped.  The kernels allocate nothing: the wrapper passes the f32
//     partial scratch (B, H, n_split, D) and (B, H, n_split).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                    // query heads a block holds
constexpr int kStageTok = 64;                // tokens a ring stage holds
constexpr int kWarpTok = kStageTok / kWarps; // keys a warp takes a stage
constexpr int kStages = 3;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDefaultSmem = 48 * 1024;

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

// (x0, x1) as a bf16 pair `hi` plus the bf16 pair of what rounding left,
// `lo`: hi + lo holds x to about 16 significant bits.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

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

// Shared-memory geometry of one (T, D, PAGE) instantiation.  Rows are
// padded by 16 bytes so ldmatrix's eight row reads (bf16) and a quarter
// warp's 16-byte reads of eight rows (f32) hit distinct banks.
template <typename T, int D, int PAGE>
struct Geo {
  static constexpr int kVec = 16 / (int)sizeof(T);    // elements a copy
  static constexpr int kChunks = D / kVec;            // copies a row
  static constexpr int kPitch = D + kVec;             // padded row
  static constexpr int kStagePages = kStageTok / PAGE;
  static constexpr int kWarpPages = kStagePages / kWarps;
  static constexpr int kStageElems = 2 * kStageTok * kPitch;   // K then V
  static constexpr size_t kRing = (size_t)kStages * kStageElems * sizeof(T);
  static constexpr size_t kQ = (size_t)kRows * kPitch * sizeof(T);
  // float32 only: p [warp][row][key + 1 pad], then alpha [warp][row]
  static constexpr size_t kP =
      sizeof(T) == 4 ? (size_t)kWarps * kRows * (kWarpTok + 2) * 4 : 0;
  static constexpr size_t kSmem = kRing + kQ + kP;
  static constexpr size_t kComb = (size_t)kWarps * kRows * (D + 2) * 4;
  static_assert(kComb <= kRing, "warp states must fit in the ring");
  static_assert(kStagePages % kWarps == 0, "pages a stage split by warp");
  static_assert(D % 16 == 0, "head dim a multiple of 16");
};

// The split kernel's shared memory with q of type T and pages of type KV:
// the ring of KV stages; for fp8 pages, one stage widened to T; q's rows;
// for float32, p and alpha.  The warp states of the end overlay the ring.
template <typename T, typename KV, int D, int PAGE>
struct Layout {
  using G = Geo<T, D, PAGE>;
  using GK = Geo<KV, D, PAGE>;
  static constexpr bool kWiden = !std::is_same<T, KV>::value;
  static constexpr size_t kWideOff = GK::kRing;
  static constexpr size_t kQOff =
      kWideOff + (kWiden ? (size_t)G::kStageElems * sizeof(T) : 0);
  static constexpr size_t kPOff = kQOff + G::kQ;
  static constexpr size_t kSmem = kPOff + G::kP;
};

// Two e4m3 values (the low byte first) as f32, through f16: exact.
__device__ __forceinline__ float2 fp8x2_to_float2(uint32_t pair) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair & 0xffffu), __NV_E4M3);
  return __half22float2(__half2(h));
}

__device__ __forceinline__ void store8(float* d, const float2* f) {
  reinterpret_cast<float4*>(d)[0] = make_float4(f[0].x, f[0].y, f[1].x,
                                                f[1].y);
  reinterpret_cast<float4*>(d)[1] = make_float4(f[2].x, f[2].y, f[3].x,
                                                f[3].y);
}
__device__ __forceinline__ void store8(__nv_bfloat16* d, const float2* f) {
  uint4 w;
  uint32_t* u = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __float22bfloat162_rn(f[i]);
    u[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  *reinterpret_cast<uint4*>(d) = w;
}

// A landed stage of fp8 rows (K then V at the ring's pitch) widened into
// a stage of T at T's pitch, which the stage code reads; 16 values a
// thread a step.
template <typename T, int D, int PAGE>
__device__ __forceinline__ void widen_stage(T* dst, const uint8_t* src) {
  using G = Geo<T, D, PAGE>;
  using GK = Geo<uint8_t, D, PAGE>;
  for (int c = threadIdx.x; c < 2 * kStageTok * GK::kChunks; c += kThreads) {
    const int r = c / GK::kChunks, dc = (c - r * GK::kChunks) * 16;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(src + r * GK::kPitch + dc);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    float2 f[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = fp8x2_to_float2(w[i]);
      f[2 * i + 1] = fp8x2_to_float2(w[i] >> 16);
    }
    T* d = dst + r * G::kPitch + dc;
    store8(d, f);
    store8(d + 8, f + 4);
  }
}

// Issue one stage's copies: warp w fills page slots w, w + kWarps, ...
// from the page ids in `pid` (-1: a slot past the range, zero-filled so
// no stale value meets a zero probability).
template <typename T, int D, int PAGE>
__device__ __forceinline__ void issue_stage(
    T* ks, const T* kbase, const T* vbase, const int (&pid)[
        Geo<T, D, PAGE>::kWarpPages], int g, int Hkv, int warp, int lane) {
  using G = Geo<T, D, PAGE>;
  T* vs = ks + kStageTok * G::kPitch;
#pragma unroll
  for (int i = 0; i < G::kWarpPages; ++i) {
    const int slot = warp + kWarps * i;
    T* kd = ks + slot * PAGE * G::kPitch;
    T* vd = vs + slot * PAGE * G::kPitch;
    if (pid[i] >= 0) {
      const long long row0 = (long long)pid[i] * PAGE;
      for (int c = lane; c < PAGE * G::kChunks; c += 32) {
        const int t = c / G::kChunks, dc = (c - t * G::kChunks) * G::kVec;
        const long long off = ((row0 + t) * Hkv + g) * D + dc;
        cp_async16(kd + t * G::kPitch + dc, kbase + off);
        cp_async16(vd + t * G::kPitch + dc, vbase + off);
      }
    } else {
      for (int c = lane; c < PAGE * G::kChunks; c += 32) {
        const int t = c / G::kChunks, dc = (c - t * G::kChunks) * G::kVec;
        *reinterpret_cast<uint4*>(kd + t * G::kPitch + dc) =
            make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vd + t * G::kPitch + dc) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
}

// Page ids of this warp's slots in stage `st` (-1 past the range).
template <int KP>
__device__ __forceinline__ void stage_pids(int (&pid)[KP], const int* pt_row,
                                           int first, int last, int st,
                                           int n_stages, int stage_pages,
                                           int warp) {
#pragma unroll
  for (int i = 0; i < KP; ++i) {
    const int j = first + st * stage_pages + warp + kWarps * i;
    pid[i] = (st < n_stages && j <= last) ? __ldg(pt_row + j) : -1;
  }
}

// ---- bfloat16 stage: tensor cores -----------------------------------------
template <int D>
struct Bf16State {
  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
  float m[2], l[2];                 // rows g and g + 8 (l: this thread's part)
};

template <int D>
__device__ __forceinline__ void bf16_stage(
    Bf16State<D>& st, const __nv_bfloat16* ks, int pos0, int lo, int end,
    float scale, int warp, int lane) {
  constexpr int kPitch = D + 8;
  const __nv_bfloat16* vs = ks + kStageTok * kPitch;
  const int g = lane >> 2, t4 = lane & 3, mat = lane >> 3;
  const int key0 = warp * kWarpTok;
  float s[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t b0, b1, b2, b3;
    const int key = key0 + (mat >> 1) * 8 + (lane & 7);
    ldmatrix_x4(b0, b1, b2, b3, ks + key * kPitch + kk * 16 + (mat & 1) * 8);
    mma_bf16(s[0], st.qf[kk], b0, b1);
    mma_bf16(s[1], st.qf[kk], b2, b3);
  }
  // online softmax once a stage: rows g (r = 0) and g + 8 (r = 1); the
  // four threads of a quad share a row and hold 4 of its 16 keys
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bool ok[2][2];
    float mx = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int pos = pos0 + nt * 8 + 2 * t4 + c;
        ok[nt][c] = pos >= lo && pos < end;
        const float x = ok[nt][c] ? s[nt][2 * r + c] * scale : kNegInf;
        s[nt][2 * r + c] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(st.m[r], mx);
    const float alpha = exp2f((st.m[r] - m_new) * kLog2e);
    st.m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p =
            ok[nt][c] ? exp2f((s[nt][2 * r + c] - m_new) * kLog2e) : 0.f;
        s[nt][2 * r + c] = p;
        sum += p;
      }
    st.l[r] = st.l[r] * alpha + sum;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      st.acc[nt][2 * r] *= alpha;
      st.acc[nt][2 * r + 1] *= alpha;
    }
  }
  // acc += p v: the two score tiles are the A fragment of these 16 keys,
  // p split into a bf16 head and a bf16 remainder (two products), so p
  // keeps 16 bits and the sum matches f32 p times bf16 v
  uint32_t ph[4], pr[4];
  split_bf16(s[0][0], s[0][1], ph[0], pr[0]);
  split_bf16(s[0][2], s[0][3], ph[1], pr[1]);
  split_bf16(s[1][0], s[1][1], ph[2], pr[2]);
  split_bf16(s[1][2], s[1][3], ph[3], pr[3]);
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    uint32_t b0, b1, b2, b3;
    const int krow = key0 + (mat & 1) * 8 + (lane & 7);
    ldmatrix_x4_trans(b0, b1, b2, b3,
                      vs + krow * kPitch + dp * 16 + (mat >> 1) * 8);
    mma_bf16(st.acc[2 * dp], ph, b0, b1);
    mma_bf16(st.acc[2 * dp + 1], ph, b2, b3);
    mma_bf16(st.acc[2 * dp], pr, b0, b1);
    mma_bf16(st.acc[2 * dp + 1], pr, b2, b3);
  }
}

// ---- float32 stage: CUDA cores --------------------------------------------
template <int D>
struct F32Geo {
  static constexpr int kC4 = D / 4;               // float4 columns of a row
  static constexpr int kRG = 32 / kC4;            // row groups in p.v
  static constexpr int kRPL = kRows / kRG;        // rows a lane owns in p.v
};

template <int D>
struct F32State {
  float m[kRows / 2], l[kRows / 2];  // rows rh + 2k (q.k lane mapping)
  float acc[F32Geo<D>::kRPL][4];     // rows rg * kRPL + k, float4 column c4
};

template <int D>
__device__ __forceinline__ void f32_stage(
    F32State<D>& st, const float* ks, const float* qs, float* ps, float* as,
    int nr, int pos0, int lo, int end, float scale, int warp, int lane) {
  constexpr int kPitch = D + 4;
  using FG = F32Geo<D>;
  const float* vs = ks + kStageTok * kPitch;
  const int key0 = warp * kWarpTok;
  const int i = lane & 15, rh = lane >> 4;
  // q.k: lane (key i, rows rh, rh + 2, ...), full-D dot products
  float s[kRows / 2];
#pragma unroll
  for (int k = 0; k < kRows / 2; ++k) s[k] = 0.f;
  const float4* kr = reinterpret_cast<const float4*>(ks + (key0 + i) * kPitch);
#pragma unroll 4
  for (int c = 0; c < D / 4; ++c) {
    const float4 kv = kr[c];
#pragma unroll
    for (int k = 0; k < kRows / 2; ++k) {
      if (rh + 2 * k < nr) {
        const float4 qv =
            reinterpret_cast<const float4*>(qs + (rh + 2 * k) * kPitch)[c];
        s[k] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }
  }
  const int pos = pos0 + i;
  const bool ok = pos >= lo && pos < end;
  float* pw = ps + warp * kRows * (kWarpTok + 1);
#pragma unroll
  for (int k = 0; k < kRows / 2; ++k) {
    const float x = ok ? s[k] * scale : kNegInf;
    float mx = x;
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(st.m[k], mx);
    const float alpha = exp2f((st.m[k] - m_new) * kLog2e);
    const float p = ok ? exp2f((x - m_new) * kLog2e) : 0.f;
    float sum = p;
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    st.l[k] = st.l[k] * alpha + sum;
    st.m[k] = m_new;
    const int r = rh + 2 * k;
    pw[r * (kWarpTok + 1) + i] = p;
    if (i == 0) as[warp * kRows + r] = alpha;
  }
  __syncwarp();
  // p.v: lane (float4 column c4, row group rg)
  if (lane < FG::kRG * FG::kC4) {
    const int c4 = lane % FG::kC4, rg = lane / FG::kC4;
#pragma unroll
    for (int k = 0; k < FG::kRPL; ++k) {
      const float alpha = as[warp * kRows + rg * FG::kRPL + k];
#pragma unroll
      for (int e = 0; e < 4; ++e) st.acc[k][e] *= alpha;
    }
#pragma unroll 4
    for (int t = 0; t < kWarpTok; ++t) {
      const float4 vv =
          reinterpret_cast<const float4*>(vs + (key0 + t) * kPitch)[c4];
#pragma unroll
      for (int k = 0; k < FG::kRPL; ++k) {
        const float p = pw[(rg * FG::kRPL + k) * (kWarpTok + 1) + t];
        st.acc[k][0] += p * vv.x;
        st.acc[k][1] += p * vv.y;
        st.acc[k][2] += p * vv.z;
        st.acc[k][3] += p * vv.w;
      }
    }
  }
  __syncwarp();                    // pw and as are rewritten next stage
}

// ---- split pass -----------------------------------------------------------
template <typename T, typename KV, int D, int PAGE>
__global__ void __launch_bounds__(kThreads)
paged_attention_split_kernel(const T* __restrict__ q,
                             const KV* __restrict__ k_pages,
                             const KV* __restrict__ v_pages,
                             const int* __restrict__ page_tables,
                             const int* __restrict__ lengths,
                             float* __restrict__ part_acc,
                             float* __restrict__ part_m,
                             float* __restrict__ part_l, int H, int Hkv,
                             int n_pages, int pages_per_split,
                             long long plane_stride, int layer, int window,
                             float scale) {
  using G = Geo<T, D, PAGE>;
  using GK = Geo<KV, D, PAGE>;
  using Lay = Layout<T, KV, D, PAGE>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  KV* ring = reinterpret_cast<KV*>(smem_raw);
  T* wide = reinterpret_cast<T*>(smem_raw + Lay::kWideOff);
  T* qs = reinterpret_cast<T*>(smem_raw + Lay::kQOff);

  const int split = blockIdx.x, n_split = gridDim.x, b = blockIdx.z;
  const int n_rep = H / Hkv;
  const int n_chunks = (n_rep + kRows - 1) / kRows;
  const int g = blockIdx.y / n_chunks;
  const int r0 = (blockIdx.y - g * n_chunks) * kRows;
  const int nr = min(kRows, n_rep - r0);
  const long long head0 = (long long)b * H + (long long)g * n_rep + r0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // this block's pages: range `split` inside the lane's [j0, jmax]
  const int ln = lengths[b];
  const int lo = window > 0 ? ln - window + 1 : 0;
  int first = split * pages_per_split;
  int last = min(first + pages_per_split, n_pages) - 1;
  if (ln > 0 && lo < ln) {
    first = max(first, max(lo, 0) / PAGE);
    last = min(last, (ln - 1) / PAGE);
  } else {
    last = first - 1;
  }
  if (first > last) {              // no page of the lane here: empty state
    for (int e = tid; e < nr * D; e += kThreads) {
      const int r = e / D, d = e - r * D;
      part_acc[((head0 + r) * n_split + split) * D + d] = 0.f;
    }
    if (tid < nr) {
      part_m[(head0 + tid) * n_split + split] = kNegInf;
      part_l[(head0 + tid) * n_split + split] = 0.f;
    }
    return;
  }
  const int end = min(ln, (last + 1) * PAGE);   // valid: [lo, end)
  const int n_stages =
      (last - first + G::kStagePages) / G::kStagePages;
  const KV* kbase = k_pages + (long long)layer * plane_stride;
  const KV* vbase = v_pages + (long long)layer * plane_stride;
  const int* pt_row = page_tables + (long long)b * n_pages;

  // q rows of this block (rows past nr zero), in the first copy group
  for (int c = tid; c < kRows * G::kChunks; c += kThreads) {
    const int r = c / G::kChunks, dc = (c - r * G::kChunks) * G::kVec;
    T* d = qs + r * G::kPitch + dc;
    if (r < nr)
      cp_async16(d, q + (head0 + r) * D + dc);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
  // the first stages' page ids, all loads in flight at once, then their
  // copies; `pid` holds the ids of the stage issued next
  int first_pids[kStages][G::kWarpPages];
#pragma unroll
  for (int st = 0; st < kStages; ++st)
    stage_pids(first_pids[st], pt_row, first, last, st, n_stages,
               G::kStagePages, warp);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_stages)
      issue_stage<KV, D, PAGE>(ring + st * GK::kStageElems, kbase, vbase,
                               first_pids[st], g, Hkv, warp, lane);
    cp_async_commit();
  }
  int pid[G::kWarpPages];
#pragma unroll
  for (int i = 0; i < G::kWarpPages; ++i) pid[i] = first_pids[kStages - 1][i];

  constexpr bool kBf16 = sizeof(T) == 2;
  Bf16State<D> bs;
  F32State<D> fs;
  float* ps = reinterpret_cast<float*>(smem_raw + Lay::kPOff);
  float* as = ps + kWarps * kRows * (kWarpTok + 1);
  if constexpr (kBf16) {
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) bs.acc[nt][e] = 0.f;
    bs.m[0] = bs.m[1] = kNegInf;
    bs.l[0] = bs.l[1] = 0.f;
  } else {
#pragma unroll
    for (int k = 0; k < kRows / 2; ++k) {
      fs.m[k] = kNegInf;
      fs.l[k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < F32Geo<D>::kRPL; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) fs.acc[k][e] = 0.f;
  }

  for (int it = 0; it < n_stages; ++it) {
    const int ahead = it + kStages - 1;       // the stage issued now
    if (ahead < n_stages)
      issue_stage<KV, D, PAGE>(ring + (ahead % kStages) * GK::kStageElems,
                               kbase, vbase, pid, g, Hkv, warp, lane);
    cp_async_commit();
    // the next stage's page ids load while this stage is computed
    stage_pids(pid, pt_row, first, last, ahead + 1, n_stages,
               G::kStagePages, warp);
    cp_async_wait<kStages - 1>();             // stage it (and q) landed
    __syncthreads();
    const KV* landed = ring + (it % kStages) * GK::kStageElems;
    const T* ks = reinterpret_cast<const T*>(landed);
    if constexpr (Lay::kWiden) {              // fp8 pages: widen to T
      widen_stage<T, D, PAGE>(wide, reinterpret_cast<const uint8_t*>(landed));
      __syncthreads();
      ks = wide;
    }
    const int pos0 = (first + it * G::kStagePages) * PAGE + warp * kWarpTok;
    const bool active = pos0 < end && pos0 + kWarpTok > lo;   // warp-uniform
    if constexpr (kBf16) {
      if (it == 0) {
        const int mat = lane >> 3;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int row = (mat & 1) * 8 + (lane & 7);
          ldmatrix_x4(bs.qf[kk][0], bs.qf[kk][1], bs.qf[kk][2], bs.qf[kk][3],
                      qs + row * G::kPitch + kk * 16 + (mat >> 1) * 8);
        }
      }
      if (active)
        bf16_stage<D>(bs, reinterpret_cast<const __nv_bfloat16*>(ks), pos0,
                      lo, end, scale, warp, lane);
    } else {
      if (active)
        f32_stage<D>(fs, reinterpret_cast<const float*>(ks),
                     reinterpret_cast<const float*>(qs), ps, as, nr, pos0, lo,
                     end, scale, warp, lane);
    }
    __syncthreads();                          // this buffer is refilled next
  }
  cp_async_wait<0>();
  __syncthreads();

  // each warp's state into shared memory (over the ring), then merged
  float* cacc = reinterpret_cast<float*>(smem_raw);   // [warp][row][D]
  float* cm = cacc + kWarps * kRows * D;               // [warp][row]
  float* cl = cm + kWarps * kRows;
  if constexpr (kBf16) {
    const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = bs.l[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = warp * kRows + g8 + 8 * r;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        *reinterpret_cast<float2*>(cacc + row * D + nt * 8 + 2 * t4) =
            make_float2(bs.acc[nt][2 * r], bs.acc[nt][2 * r + 1]);
      if (t4 == 0) {
        cm[row] = bs.m[r];
        cl[row] = l;
      }
    }
  } else {
    using FG = F32Geo<D>;
    if (lane < FG::kRG * FG::kC4) {
      const int c4 = lane % FG::kC4, rg = lane / FG::kC4;
#pragma unroll
      for (int k = 0; k < FG::kRPL; ++k)
        *reinterpret_cast<float4*>(
            cacc + (warp * kRows + rg * FG::kRPL + k) * D + 4 * c4) =
            make_float4(fs.acc[k][0], fs.acc[k][1], fs.acc[k][2],
                        fs.acc[k][3]);
    }
    if ((lane & 15) == 0) {
#pragma unroll
      for (int k = 0; k < kRows / 2; ++k) {
        const int row = warp * kRows + (lane >> 4) + 2 * k;
        cm[row] = fs.m[k];
        cl[row] = fs.l[k];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < nr * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, cm[w * kRows + r]);
    float sum = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f((cm[w * kRows + r] - M) * kLog2e);
      sum += cacc[(w * kRows + r) * D + d] * wt;
      L += cl[w * kRows + r] * wt;
    }
    const long long at = (head0 + r) * n_split + split;
    part_acc[at * D + d] = sum;
    if (d == 0) {
      part_m[at] = M;
      part_l[at] = L;
    }
  }
}

// ---- merge pass -----------------------------------------------------------
// One block per (lane b, query head h), one thread per element d: merge
// the n_split partial states; with `decode`, fold in the in-flight token
// (k_new, v_new: (B, Hkv, D) with element strides sb, sh) and write o;
// else write o, m and l.  The loop over ranges carries nothing but sums,
// so its loads (an empty range's zeros too) are in flight together.
template <typename T, int D>
__global__ void __launch_bounds__(D)
paged_attention_merge_kernel(const float* __restrict__ part_acc,
                             const float* __restrict__ part_m,
                             const float* __restrict__ part_l, int n_split,
                             const T* __restrict__ q,
                             const T* __restrict__ k_new,
                             const T* __restrict__ v_new, long long kn_sb,
                             long long kn_sh, long long vn_sb,
                             long long vn_sh, T* __restrict__ o,
                             float* __restrict__ m_out,
                             float* __restrict__ l_out, int H, int n_rep,
                             float scale, int decode) {
  constexpr int kWarpsD = (D + 31) / 32;
  __shared__ float dots[kWarpsD];
  const long long bh = blockIdx.x;
  const int d = threadIdx.x, lane = d & 31;
  float qd = 0.f, knd = 0.f, vnd = 0.f;
  if (decode) {                          // loads first, beside the partials
    const long long b = bh / H;
    const int gk = (int)(bh - b * H) / n_rep;
    qd = to_f32(q[bh * D + d]);
    knd = to_f32(k_new[b * kn_sb + gk * kn_sh + d]);
    vnd = to_f32(v_new[b * vn_sb + gk * vn_sh + d]);
  }
  const float* pm = part_m + bh * n_split;
  const float* pl = part_l + bh * n_split;
  const float* pa = part_acc + bh * n_split * D + d;
  float M = kNegInf;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, pm[s]);
  float acc = 0.f, L = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) {
    const float l = pl[s];
    const float w = l > 0.f ? expf(pm[s] - M) : 0.f;   // empty adds nothing
    L += l * w;
    acc += w * pa[s * D];
  }
  if (decode) {
    float dot = qd * knd;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane == 0) dots[d >> 5] = dot;
    __syncthreads();
    dot = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsD; ++w) dot += dots[w];
    const float s_new = dot * scale;
    const float m2 = fmaxf(M, s_new);
    const float alpha = expf(M - m2), p = expf(s_new - m2);
    const float l2 = fmaxf(L * alpha + p, 1e-30f);
    // the cached positions' o in q's dtype, as the reference merges it
    const float oc = to_f32(from_f32<T>(acc / fmaxf(L, 1e-30f)));
    o[bh * D + d] = from_f32<T>((oc * (L * alpha) + p * vnd) / l2);
  } else {
    o[bh * D + d] = from_f32<T>(acc / fmaxf(L, 1e-30f));
    if (d == 0) {
      m_out[bh] = M;
      l_out[bh] = L;
    }
  }
}

// ---- launchers ------------------------------------------------------------
struct SplitArgs {
  const void *q, *k, *v;
  const int *pt, *lengths;
  float *acc, *m, *l;
  int B, H, Hkv, n_pages, n_split, pages_per_split;
  long long plane_stride;
  int layer, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KV, int D, int PAGE>
int launch_split(const SplitArgs& a) {
  constexpr size_t kSmem = Layout<T, KV, D, PAGE>::kSmem;
  auto kernel = paged_attention_split_kernel<T, KV, D, PAGE>;
  static bool smem_ok = false;
  if (kSmem > (size_t)kDefaultSmem && !smem_ok) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (e != cudaSuccess) return (int)e;
    smem_ok = true;
  }
  const int n_rep = a.H / a.Hkv;
  dim3 grid(a.n_split, a.Hkv * ((n_rep + kRows - 1) / kRows), a.B);
  kernel<<<grid, kThreads, kSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), a.pt, a.lengths, a.acc, a.m, a.l, a.H,
      a.Hkv, a.n_pages, a.pages_per_split, a.plane_stride, a.layer, a.window,
      a.scale);
  return (int)cudaGetLastError();
}

template <typename T, typename KV, int D>
int launch_split_page(int page, const SplitArgs& a) {
  switch (page) {
    case 4: return launch_split<T, KV, D, 4>(a);
    case 8: return launch_split<T, KV, D, 8>(a);
    case 16: return launch_split<T, KV, D, 16>(a);
    default: return -1;
  }
}

template <typename T, typename KV>
int launch_split_dim(int D, int page, const SplitArgs& a) {
  switch (D) {
    case 64: return launch_split_page<T, KV, 64>(page, a);
    case 112: return launch_split_page<T, KV, 112>(page, a);
    case 128: return launch_split_page<T, KV, 128>(page, a);
    default: return -1;
  }
}

template <typename T>
int launch_split_kv(int kv_fp8, int D, int page, const SplitArgs& a) {
  if (kv_fp8) return launch_split_dim<T, uint8_t>(D, page, a);
  return launch_split_dim<T, T>(D, page, a);
}

struct MergeArgs {
  const float *acc, *m, *l;
  int n_split;
  const void *q, *k_new, *v_new;
  long long kn_sb, kn_sh, vn_sb, vn_sh;
  void* o;
  float *m_out, *l_out;
  int B, H, Hkv;
  float scale;
  int decode;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_merge(const MergeArgs& a) {
  paged_attention_merge_kernel<T, D><<<a.B * a.H, D, 0, a.stream>>>(
      a.acc, a.m, a.l, a.n_split, static_cast<const T*>(a.q),
      static_cast<const T*>(a.k_new), static_cast<const T*>(a.v_new),
      a.kn_sb, a.kn_sh, a.vn_sb, a.vn_sh, static_cast<T*>(a.o), a.m_out,
      a.l_out, a.H, a.H / a.Hkv, a.scale, a.decode);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_merge_dim(int D, const MergeArgs& a) {
  switch (D) {
    case 64: return launch_merge<T, 64>(a);
    case 112: return launch_merge<T, 112>(a);
    case 128: return launch_merge<T, 128>(a);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// dtype: q's, 0 = float32, 1 = bfloat16; kv_fp8: 0 = pages of q's dtype,
// 1 = float8_e4m3fn pages.  Writes the f32 partial states acc (B, H,
// n_split, D), m and l (B, H, n_split).  Returns 0 on success, -1 for an
// unsupported (dtype, D, page), else the cudaError_t of the launch.
int mars_paged_attention_split(int dtype, int kv_fp8, const void* q,
                               const void* k_pages,
                               const void* v_pages, const int* page_tables,
                               const int* lengths, float* part_acc,
                               float* part_m, float* part_l, int B, int H,
                               int Hkv, int D, int page, int n_pages,
                               int n_split, int pages_per_split,
                               long long plane_stride, int layer, int window,
                               float scale, void* stream) {
  const SplitArgs a{q, k_pages, v_pages, page_tables, lengths, part_acc,
                    part_m, part_l, B, H, Hkv, n_pages, n_split,
                    pages_per_split, plane_stride, layer, window, scale,
                    static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_split_kv<float>(kv_fp8, D, page, a);
  if (dtype == 1) return launch_split_kv<__nv_bfloat16>(kv_fp8, D, page, a);
  return -1;
}

// Merges the partial states into o (B, H, D) in q's dtype: with `decode`
// the in-flight token (k_new, v_new of q's dtype, (B, Hkv, D) with element
// strides kn_sb/kn_sh and vn_sb/vn_sh, the last dimension contiguous) is
// folded in and m_out, l_out are unused; else m_out, l_out (B, H) get the
// state.  Returns as mars_paged_attention_split.
int mars_paged_attention_merge(int dtype, const float* part_acc,
                               const float* part_m, const float* part_l,
                               int n_split, const void* q, const void* k_new,
                               const void* v_new, long long kn_sb,
                               long long kn_sh, long long vn_sb,
                               long long vn_sh, void* o, float* m_out,
                               float* l_out, int B, int H, int Hkv, int D,
                               float scale, int decode, void* stream) {
  const MergeArgs a{part_acc, part_m, part_l, n_split, q, k_new, v_new,
                    kn_sb, kn_sh, vn_sb, vn_sh, o, m_out, l_out, B, H, Hkv,
                    scale, decode, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_merge_dim<float>(D, a);
  if (dtype == 1) return launch_merge_dim<__nv_bfloat16>(D, a);
  return -1;
}

const char* mars_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
