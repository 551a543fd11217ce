// MARS cycle engine for Hopper (sm_90a), plain C interface.
//
// Replaces the device program of the reference's paper simulator, the
// `jax.lax.scan` of src/repro/core/mars.py:247 (`_run`; one step is
// `_insert_port` once per port, :123, then `_forward`, :200).  It is not a
// Pallas kernel, but it runs on the accelerator there, and a loop of small
// PyTorch ops would be some 10^7 launches a workload.
//
// What it computes.  One loop iteration is one GPU-boundary cycle: each of
// the n_ports insertion ports tries to insert its head request (a hit on
// a buffered page appends to that page's list; a miss allocates a
// PhyPageList way and pushes PhyPageOrderQ; a full set, a full RequestQ
// stalls that port only; a core at its MSHR cap has no input, which is no
// stall), then the head request of the oldest page is forwarded.  Output
// per instance: the forwarded original indices in order (the
// permutation), the count forwarded, the stall events and the cycle of
// the last forward + 1.  The integers are the reference's: the first way
// on ties (`jnp.argmax`), the same XOR-fold page-set hash, the same
// clamps.
//
// One departure that no output can show: the reference puts a request in
// the lowest free RequestQ slot (`jnp.argmin` of the occupancy bits,
// mars.py:148); here the free slots are a stack (pop on insert, push on
// forward).  A slot's number is read only to link a page's list and to
// free the slot again; the outputs depend on the slots only through "the
// RequestQ has room", that is, fewer than request_q requests buffered,
// which a count decides as well as a bit-vector (the reference's own
// oracle `mars_reorder_reference` keeps just that count, mars.py:336).
// The CPU twin (kernels/mars_engine/ref.py) keeps the reference's order.
//
// Bounds.  Bytes: the inputs (pages, src, port queues, 12-16 B a request)
// read once and the permutation (8 B a request) written once -- 0.1 us at
// 3.35 TB/s for n = 16384.  That is not what binds: a cycle depends on the
// one before, and within a cycle port p's insertion depends on port p-1's
// (they share the RequestQ and the sets), so the work is a chain of
// (cycles x n_ports) port attempts plus a forward a cycle.  The chain
// bound is that many dependent steps at one dependent shared-memory load
// each (the card's latency, timed by tools/s1s2_timing.py); it binds, some
// 10^4 above the byte bound.
//
// Design.  One block an instance, every instance of a call in one launch
// (each under its own MarsConfig, the parameters a row of `params`;
// shared memory sized for the largest; the port bound NP, 8 or 32, and
// whether any instance has more than 4 ways pick one of four template
// instances for the whole launch).  Thread 0 runs the cycle loop alone
// and reads nothing but registers and shared memory:
//   * each active port's head request (g, page, set, core) sits in
//     registers (the port loop is unrolled over NP ports, NP a template
//     bound on n_ports); after an insertion the next head comes from a
//     per-port ring in shared memory, a load that is not waited on until
//     that port's next attempt;
//   * a bit mask of the ports that still have input, so a drained port
//     costs nothing;
//   * a set's pages and tails are one 16-byte load each (ways <= 4; more
//     ways read one word a way), its valid ways a bit mask, so the hit way
//     and the first free way are each one __ffs;
//   * the RequestQ's free slots are a stack in shared memory and a count;
//     a RequestQ slot (g, next, core) is one 16-byte word;
//   * an attempt's loads (the core's MSHR count, the set's valid ways,
//     pages and tails, the stack's top) depend on registers alone and
//     issue together: one level of shared-memory latency an attempt;
//   * PhyPageOrderQ's entries carry their page's first slot, and its
//     first two entries stay in registers, so the page being forwarded
//     and its head need no load, and the next page none either when one
//     is exhausted; the forward's release of an MSHR and of a set's way
//     are shared-memory atomics whose results nobody waits for;
//   * the ports known to have no input (their head's core at its MSHR
//     cap) and known to stall on a full set are exact caches in
//     registers, cleared when a forward releases that core or frees a
//     way of that set, so such an attempt reads no memory; with the
//     RequestQ full an attempt reads only its core's MSHR count.
// The other warps stage the heads: the ring holds 128 heads a port and is
// refilled every 63 cycles behind a block barrier (a port takes at most
// one request a cycle, so the serial thread never reads a head that is
// not staged, and the stagers never write one it may still read), each
// head read from device memory and its set's XOR fold computed there.
// The loop stops once every port is drained and PhyPageOrderQ is empty (no
// state changes after that) and never runs past the reference's 3n +
// request_q + 64 cycles, so a stream that does not drain comes back short
// and the host's "engine bug" check fires.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // warp 0: the cycle loop; 1-7: stagers
constexpr int kRing = 128;              // staged heads a port (a power of two)
constexpr int kEpoch = 63;              // cycles a refill: 2 kEpoch + 1 <= kRing
constexpr int kMaxPorts = 32;           // the active-port mask is one word
constexpr int kMaxWays = 32;            // a set's valid ways are one word
constexpr int kMaxRequestQ = 1024;
constexpr int kParams = 16;             // int64s a row of `params`
constexpr size_t kMaxSmem = 232448;     // 227 KB a block on the H100

// a row of `params`
enum {
  kOff,        // the instance's first element of pages, src and perm
  kN,          // its request count
  kReqOff,     // its first element of port_req
  kMaxLen,     // port_req's row length
  kLenOff,     // its first element of port_len
  kPorts,
  kCores,
  kRequestQ,
  kSets,
  kWays,
  kOrderQ,
  kMshr,
  kMaxCycles,
};

__host__ __device__ inline int floor_mod(int a, int m) {
  const int r = a % m;
  return (r != 0 && ((r < 0) != (m < 0))) ? r + m : r;
}

// the reference's `_page_set`: XOR-fold all page bits down to the index
// width (arithmetic shifts on int32, Python's floor modulo)
__device__ __forceinline__ int page_set(int p, int nsets, int k, int rounds) {
  int s = p, x = p >> k;
  for (int i = 0; i < rounds; ++i) {
    s ^= x;
    x >>= k;
  }
  return floor_mod(s, nsets);
}

__host__ __device__ inline size_t take(size_t& o, size_t bytes) {
  const size_t at = o;
  o += (bytes + 15) & ~size_t(15);
  return at;
}

struct Layout {
  size_t rq, ring, pg, tail, vmask, poq, freeq, inflight, pub, bytes;
  int stride;                           // ints a set: 4 for ways <= 4
};

// shared-memory layout of one instance, in bytes (16-byte aligned parts)
__host__ __device__ inline Layout layout(int Q, int S, int W, int P,
                                         int n_cores, int np) {
  Layout L;
  size_t o = 0;
  L.stride = W <= 4 ? 4 : W;
  L.rq = take(o, 16 * (size_t)Q);                  // int4 (g, next, core)
  L.ring = take(o, 16 * (size_t)np * kRing);       // int4 (g, page, set, core)
  L.pg = take(o, 4 * (size_t)S * L.stride);
  L.tail = take(o, 4 * (size_t)S * L.stride);
  L.vmask = take(o, 4 * (size_t)S);
  L.poq = take(o, 8 * (size_t)P);                  // ((set << 5) | way, head)
  L.freeq = take(o, 4 * (size_t)Q);
  L.inflight = take(o, 4 * (size_t)n_cores);
  L.pub = take(o, 4 * 2 * (size_t)np);             // cursors, two epochs
  L.bytes = o;
  return L;
}

template <int NP, bool WIDE>
__global__ void __launch_bounds__(kThreads)
mars_engine_kernel(const int* __restrict__ pages, const int* __restrict__ src,
                   const int* __restrict__ port_req,
                   const int* __restrict__ port_len,
                   const long long* __restrict__ params,
                   long long* __restrict__ perm, int* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long* prm = params + (long long)blockIdx.x * kParams;
  const int n = (int)prm[kN], max_len = (int)prm[kMaxLen];
  const int n_ports = (int)prm[kPorts], n_cores = (int)prm[kCores];
  const int Q = (int)prm[kRequestQ], S = (int)prm[kSets], W = (int)prm[kWays];
  const int P = (int)prm[kOrderQ], mshr = (int)prm[kMshr];
  const long long max_cycles = prm[kMaxCycles];
  pages += prm[kOff];
  src += prm[kOff];
  perm += prm[kOff];
  port_req += prm[kReqOff];
  port_len += prm[kLenOff];
  const Layout L = layout(Q, S, W, P, n_cores, NP);
  int4* rq = reinterpret_cast<int4*>(smem + L.rq);
  int4* ring = reinterpret_cast<int4*>(smem + L.ring);
  int* pg = reinterpret_cast<int*>(smem + L.pg);
  int* tails = reinterpret_cast<int*>(smem + L.tail);
  unsigned* vmask = reinterpret_cast<unsigned*>(smem + L.vmask);
  int2* poq = reinterpret_cast<int2*>(smem + L.poq);
  int* freeq = reinterpret_cast<int*>(smem + L.freeq);
  int* inflight = reinterpret_cast<int*>(smem + L.inflight);
  int* pub = reinterpret_cast<int*>(smem + L.pub);
  const int tid = threadIdx.x;
  const int stride = L.stride;
  // the hash's fold width and rounds, as the reference derives them
  const int k = S > 1 ? max(1, 32 - __clz(S - 1)) : 1;
  const int rounds = max(1, (31 + k - 1) / k);

  // stage heads cur[p] + lo .. cur[p] + lo + span - 1 of every port (those
  // below its length) into the ring, by threads t, t + nt, ...
  auto stage = [&](const int* cur, int lo, int span, int t, int nt) {
    for (int i = t; i < n_ports * span; i += nt) {
      const int p = i / span;
      const int idx = cur[p] + lo + i % span;
      if (idx >= port_len[p]) continue;
      const int g = port_req[(long long)p * max_len + idx];
      const int gi = min(max(g, 0), n - 1);
      const int page = pages[gi];
      ring[p * kRing + (idx & (kRing - 1))] =
          make_int4(g, page, page_set(page, S, k, rounds),
                    min(max(src[gi], 0), n_cores - 1));
    }
  };

  for (int i = tid; i < S; i += kThreads) vmask[i] = 0u;
  for (int i = tid; i < Q; i += kThreads) freeq[i] = Q - 1 - i;
  for (int i = tid; i < n_cores; i += kThreads) inflight[i] = 0;
  for (int i = tid; i < 2 * NP; i += kThreads) pub[i] = 0;
  __syncthreads();
  stage(pub, 0, kEpoch + 1, tid, kThreads);
  __syncthreads();

  // thread 0's state: each port's cursor, length and head request (g,
  // page, set, core); the ports known to have no input (their head's
  // core at its MSHR cap) and those known to stall on a full set (and
  // which set), exact caches of what a lookup would find
  int cur[NP], plen[NP], stall_set[NP];
  int4 head[NP];
  unsigned active = 0u, blocked = 0u, set_full = 0u;
  int nfree = Q, poq_head = 0, poq_len = 0, stalls = 0, emitted = 0;
  // PhyPageOrderQ's first entry (the page being forwarded: its set, way
  // and head slot) and its second (way code, head slot), in registers
  int fwd_set = 0, fwd_way = 0, fwd_head = 0;
  int2 second = make_int2(0, 0);
  int to_insert = 0, inserted = 0;
  long long cycle = 0, last_cycle = -1;
  if (tid == 0) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      cur[p] = 0;
      stall_set[p] = -1;
      plen[p] = p < n_ports ? port_len[p] : 0;
      to_insert += plen[p];
      if (plen[p] > 0) active |= 1u << p;
      head[p] = ring[p * kRing];
    }
  }

  for (int epoch = 0;; ++epoch) {
    int done = 0;
    if (tid == 0) {
      for (int c = 0; c < kEpoch; ++c, ++cycle) {
        if (cycle >= max_cycles || (inserted == to_insert && poq_len == 0)) {
          done = 1;
          break;
        }
        // Fig 5: one insertion attempt per port, in port order
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const unsigned bit = 1u << p;
          if (!(active & bit) || (blocked & bit)) continue;  // no input
          if (set_full & bit) {              // its set is still full
            ++stalls;
            continue;
          }
          const int page = head[p].y, set = head[p].z, core = head[p].w;
          const int infl = inflight[core];
          if (nfree == 0) {                  // the RequestQ is full: a stall
            if (infl >= mshr) blocked |= bit;  // unless there is no input
            else ++stalls;
            continue;
          }
          // every load of an attempt depends on registers alone
          const unsigned vm = vmask[set];
          const int slot = freeq[nfree - 1];
          unsigned hits;
          int4 tv;
          if (!WIDE) {
            const int4 pv = reinterpret_cast<const int4*>(pg)[set];
            tv = reinterpret_cast<const int4*>(tails)[set];
            hits = (unsigned)(pv.x == page) | (unsigned)(pv.y == page) << 1 |
                   (unsigned)(pv.z == page) << 2 |
                   (unsigned)(pv.w == page) << 3;
          } else {
            hits = 0u;
            for (int w = 0; w < W; ++w)
              hits |= (unsigned)(pg[set * stride + w] == page) << w;
          }
          hits &= vm;
          const int way = hits ? __ffs(hits) - 1 : __ffs(~vm) - 1;
          if (infl >= mshr) {                // no input: not a stall
            blocked |= bit;
            continue;
          }
          if (!hits && (way < 0 || way >= W)) {   // a miss on a full set
            set_full |= bit;
            stall_set[p] = set;
            ++stalls;
            continue;
          }
          --nfree;
          rq[slot] = make_int4(head[p].x, -1, core, 0);
          const int e = set * stride + way;
          const bool alloc = hits == 0u;
          // a hit links the request to its page's tail; a miss allocates
          // the entry and pushes PhyPageOrderQ (predicated, no branches)
          const int tail = WIDE ? tails[e]
                           : way & 2 ? (way & 1 ? tv.w : tv.z)
                                     : (way & 1 ? tv.y : tv.x);
          if (!alloc) reinterpret_cast<int*>(rq + tail)[1] = slot;
          int pos = poq_head + poq_len;
          pos -= pos >= P ? P : 0;
          if (alloc) pg[e] = page;
          if (alloc) vmask[set] = vm | 1u << way;
          if (alloc) poq[pos] = make_int2(set << 5 | way, slot);
          const bool first = alloc && poq_len == 0;
          fwd_set = first ? set : fwd_set;
          fwd_way = first ? way : fwd_way;
          fwd_head = first ? slot : fwd_head;
          if (alloc && poq_len == 1) second = make_int2(set << 5 | way, slot);
          poq_len += alloc;
          tails[e] = slot;
          inflight[core] = infl + 1;
          ++inserted;
          if (infl + 1 >= mshr) {            // the core reached its cap
#pragma unroll
            for (int q = 0; q < NP; ++q)
              if (q != p && head[q].w == core) blocked |= 1u << q;
          }
          // the next head, waited on only at this port's next attempt
          head[p] = ring[p * kRing + (++cur[p] & (kRing - 1))];
          if (cur[p] == plen[p]) active &= ~bit;
        }
        // Fig 6: forward the head request of the oldest page
        if (poq_len > 0) {
          const int4 r = rq[fwd_head];
          if (emitted < n) perm[emitted] = r.x;
          ++emitted;
          last_cycle = cycle;
          atomicAdd(&inflight[r.z], -1);
          freeq[nfree++] = fwd_head;
#pragma unroll
          for (int q = 0; q < NP; ++q)       // the core is below its cap
            if (head[q].w == r.z) blocked &= ~(1u << q);
          if (r.y < 0) {                     // page exhausted: a way frees
            atomicAnd(&vmask[fwd_set], ~(1u << fwd_way));
#pragma unroll
            for (int q = 0; q < NP; ++q)
              if (stall_set[q] == fwd_set) set_full &= ~(1u << q);
            if (++poq_head == P) poq_head = 0;
            --poq_len;
            // the second entry moves up without a load; the next second
            // (read whether or not it exists) is not waited on until the
            // next page is exhausted
            fwd_set = second.x >> 5;
            fwd_way = second.x & 31;
            fwd_head = second.y;
            second = poq[poq_head + 1 < P ? poq_head + 1 : 0];
          } else {
            fwd_head = r.y;
          }
        }
      }
#pragma unroll
      for (int p = 0; p < NP; ++p) pub[((epoch + 1) & 1) * NP + p] = cur[p];
    } else if (tid >= 32) {
      // heads for the next epoch: kEpoch + 1 .. 2 kEpoch past the cursors
      // this epoch began at
      stage(pub + (epoch & 1) * NP, kEpoch + 1, kEpoch, tid - 32,
            kThreads - 32);
    }
    if (__syncthreads_or(done)) break;
  }
  if (tid == 0) {
    stats[3 * blockIdx.x + 0] = emitted;
    stats[3 * blockIdx.x + 1] = stalls;
    stats[3 * blockIdx.x + 2] = (int)(last_cycle + 1);
  }
}

template <int NP, bool WIDE>
int launch(const void* pages, const void* src, const void* port_req,
           const void* port_len, const void* params, int batch, size_t smem,
           void* perm, void* stats, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mars_engine_kernel<NP, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mars_engine_kernel<NP, WIDE><<<batch, kThreads, smem, stream>>>(
      static_cast<const int*>(pages), static_cast<const int*>(src),
      static_cast<const int*>(port_req), static_cast<const int*>(port_len),
      static_cast<const long long*>(params), static_cast<long long*>(perm),
      static_cast<int*>(stats));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `batch` instances, one block each, in one launch.  pages, src: int32,
// every instance's requests back to back; port_req: int32, each instance's
// (n_ports, max_len) queues (-1 padded) back to back; port_len: int32,
// each instance's n_ports lengths back to back; params_host and
// params_dev: the same int64[batch, 16] rows (the fields of the enum
// above; the host copy is read here, the device copy by the kernel).
// perm: int64, laid out as pages (each instance's forwarded indices in
// order; entries past its count forwarded are not written); stats:
// int32[batch, 3] = (forwarded, stall events, last forward's cycle + 1).
// Returns 0 on success, -1 for an unsupported argument, -2 when an
// instance's state does not fit in a block's shared memory, else the
// cudaError_t of the launch.
int mars_engine_run(const void* pages, const void* src, const void* port_req,
                    const void* port_len, const long long* params_host,
                    const void* params_dev, int batch, void* perm,
                    void* stats, void* stream) {
  if (batch <= 0) return batch == 0 ? 0 : -1;
  int np = 0;
  bool wide = false;
  for (int b = 0; b < batch; ++b) {
    const long long* p = params_host + (long long)b * kParams;
    if (p[kN] < 0 || p[kN] >= (1LL << 31) || p[kMaxLen] <= 0 ||
        p[kPorts] <= 0 || p[kPorts] > kMaxPorts || p[kCores] <= 0 ||
        p[kRequestQ] <= 0 || p[kRequestQ] > kMaxRequestQ || p[kSets] <= 0 ||
        p[kSets] >= (1 << 26) || p[kWays] <= 0 || p[kWays] > kMaxWays ||
        p[kOrderQ] <= 0 || p[kMaxCycles] < 0 ||
        p[kMaxLen] * p[kPorts] >= (1LL << 31))
      return -1;
    if (p[kPorts] > np) np = (int)p[kPorts];
    wide = wide || p[kWays] > 4;
  }
  np = np <= 8 ? 8 : kMaxPorts;
  size_t smem = 0;
  for (int b = 0; b < batch; ++b) {
    const long long* p = params_host + (long long)b * kParams;
    if (p[kCores] > (long long)kMaxSmem || p[kOrderQ] > (long long)kMaxSmem ||
        p[kSets] * p[kWays] > (long long)kMaxSmem)
      return -2;
    const Layout L = layout((int)p[kRequestQ], (int)p[kSets], (int)p[kWays],
                            (int)p[kOrderQ], (int)p[kCores], np);
    smem = L.bytes > smem ? L.bytes : smem;
  }
  if (smem > kMaxSmem) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = np == 8 ? (wide ? launch<8, true> : launch<8, false>)
                    : wide ? launch<kMaxPorts, true>
                           : launch<kMaxPorts, false>;
  return go(pages, src, port_req, port_len, params_dev, batch, smem, perm,
            stats, s);
}

const char* mars_engine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
