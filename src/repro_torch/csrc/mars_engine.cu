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
// stall), then the head request of the oldest page is forwarded.  Output:
// the forwarded original indices in order (the permutation), the count
// forwarded, the stall events and the cycle of the last forward + 1.
// The integers are the reference's: the first way on ties (`jnp.argmax`),
// the lowest free RequestQ slot (`jnp.argmin` of the occupancy bits; slot
// 0 and no room when full), the same XOR-fold page-set hash.
//
// Bound.  Bytes: the inputs (pages, src, port queues, 12-16 B a request)
// read once and the permutation (8 B a request) written once -- 0.1 us at
// 3.35 TB/s for n = 16384.  That is not what binds: a cycle depends on the
// one before, and within a cycle port p's insertion depends on port p-1's
// (they share the RequestQ and the sets), so the work is a chain of
// (cycles x n_ports) port attempts plus a forward a cycle.  The serial
// limit is that chain at some tens of GPU clocks a dependent step.
//
// Design.  One block of one warp a call.  All state lives in shared
// memory (RequestQ payload, links and source core; PhyPageList; the
// PhyPageOrderQ ring; per-port cursors and the cached head request --
// page, set and core, loaded once when a cursor moves, so a stalled port
// retries without touching device memory; inflight per core).  Lane 0
// does a cycle's insertions and forward in order, the serial work.  The
// RequestQ occupancy lives in registers as a free bit-vector, one 32-bit
// word a lane (RequestQ <= 1024): the lowest free slot is a ballot over
// the lanes' words and __ffs, and the owning lane clears or sets its bit
// when lane 0 says a slot was taken or freed.  The loop stops once every
// port is drained and PhyPageOrderQ is empty (no state changes after
// that) and never runs past the reference's 3n + request_q + 64 cycles,
// so a stream that does not drain comes back short and the host's
// "engine bug" check fires.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRequestQ = 1024;       // one free word a lane
constexpr size_t kMaxSmem = 232448;      // 227 KB a block on the H100

__device__ __forceinline__ int floor_mod(int a, int m) {
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

struct Layout {
  size_t rq_page, rq_order, rq_next, rq_core, ppl_page, ppl_valid, ppl_head,
      ppl_tail, poq, cursor, plen, head_g, head_page, head_set, head_core,
      inflight, bytes;
};

// shared-memory layout, in ints
__host__ __device__ inline Layout layout(int Q, int E, int P, int n_ports,
                                         int n_cores) {
  Layout L;
  size_t o = 0;
  L.rq_page = o; o += Q;
  L.rq_order = o; o += Q;
  L.rq_next = o; o += Q;
  L.rq_core = o; o += Q;
  L.ppl_page = o; o += E;
  L.ppl_valid = o; o += E;
  L.ppl_head = o; o += E;
  L.ppl_tail = o; o += E;
  L.poq = o; o += P;
  L.cursor = o; o += n_ports;
  L.plen = o; o += n_ports;
  L.head_g = o; o += n_ports;
  L.head_page = o; o += n_ports;
  L.head_set = o; o += n_ports;
  L.head_core = o; o += n_ports;
  L.inflight = o; o += n_cores;
  L.bytes = o * sizeof(int);
  return L;
}

__global__ void __launch_bounds__(32)
mars_engine_kernel(const int* __restrict__ pages,
                   const int* __restrict__ port_req,
                   const int* __restrict__ port_len,
                   const int* __restrict__ src, int n, int max_len,
                   int n_cores, int Q, int S, int W, int P, int n_ports,
                   int mshr, long long max_cycles,
                   long long* __restrict__ perm, int* __restrict__ stats) {
  extern __shared__ int smem[];
  const Layout L = layout(Q, S * W, P, n_ports, n_cores);
  int* rq_page = smem + L.rq_page;
  int* rq_order = smem + L.rq_order;
  int* rq_next = smem + L.rq_next;
  int* rq_core = smem + L.rq_core;
  int* ppl_page = smem + L.ppl_page;
  int* ppl_valid = smem + L.ppl_valid;
  int* ppl_head = smem + L.ppl_head;
  int* ppl_tail = smem + L.ppl_tail;
  int* poq = smem + L.poq;
  int* cursor = smem + L.cursor;
  int* plen = smem + L.plen;
  int* head_g = smem + L.head_g;
  int* head_page = smem + L.head_page;
  int* head_set = smem + L.head_set;
  int* head_core = smem + L.head_core;
  int* inflight = smem + L.inflight;
  const int lane = threadIdx.x;
  const int E = S * W;
  // the hash's fold width and rounds, as the reference derives them
  const int k = S > 1 ? max(1, 32 - __clz(S - 1)) : 1;
  const int rounds = max(1, (31 + k - 1) / k);

  // the request at a port's cursor, with the reference's clamps (a read
  // out of range clamps, as a JAX gather does)
  auto load_head = [&](int p, int cur) {
    const int idx = min(cur, max(plen[p] - 1, 0));
    const int g = port_req[(long long)p * max_len + idx];
    const int gi = min(max(g, 0), n - 1);
    const int page = pages[gi];
    head_g[p] = g;
    head_page[p] = page;
    head_set[p] = page_set(page, S, k, rounds);
    head_core[p] = min(max(src[gi], 0), n_cores - 1);
  };

  for (int i = lane; i < Q; i += 32) {
    rq_page[i] = 0;
    rq_order[i] = 0;
    rq_next[i] = -1;
    rq_core[i] = 0;
  }
  for (int i = lane; i < E; i += 32) {
    ppl_page[i] = 0;
    ppl_valid[i] = 0;
    ppl_head[i] = 0;
    ppl_tail[i] = 0;
  }
  for (int i = lane; i < P; i += 32) poq[i] = 0;
  for (int i = lane; i < n_cores; i += 32) inflight[i] = 0;
  for (int p = lane; p < n_ports; p += 32) {
    cursor[p] = 0;
    plen[p] = port_len[p];
    load_head(p, 0);
  }
  // this lane's word of the free bit-vector: slots 32 lane .. 32 lane + 31
  const int below = Q - 32 * lane;
  unsigned free_word = below >= 32 ? kFull
                       : below > 0 ? (1u << below) - 1u : 0u;
  __syncwarp();

  // lane 0's scalars
  int poq_head = 0, poq_len = 0, stalls = 0, emitted = 0;
  long long to_insert = 0, inserted = 0, last_cycle = -1;
  if (lane == 0)
    for (int p = 0; p < n_ports; ++p) to_insert += plen[p];

  for (long long cycle = 0; cycle < max_cycles; ++cycle) {
    int done = inserted == to_insert && poq_len == 0;
    if (__shfl_sync(kFull, done, 0)) break;
    // Fig 5: one insertion attempt per port, in port order
    for (int p = 0; p < n_ports; ++p) {
      const unsigned any = __ballot_sync(kFull, free_word != 0u);
      const int owner = any ? __ffs(any) - 1 : 0;
      const unsigned word = __shfl_sync(kFull, free_word, owner);
      const bool has_free = any != 0u;
      const int slot = has_free ? 32 * owner + __ffs(word) - 1 : 0;
      int took = 0;
      if (lane == 0) {
        const int cur = cursor[p];
        const int core = head_core[p];
        if (cur < plen[p] && inflight[core] < mshr) {   // have_input
          const int page = head_page[p];
          const int base = head_set[p] * W;
          int hit_way = -1, free_way = -1;
          for (int w = 0; w < W; ++w) {
            const bool v = ppl_valid[base + w] != 0;
            if (hit_way < 0 && v && ppl_page[base + w] == page) hit_way = w;
            if (free_way < 0 && !v) free_way = w;
          }
          const bool hit = hit_way >= 0;
          if (!has_free || (!hit && free_way < 0)) {
            ++stalls;                        // input, and no room
          } else {
            const int e = base + (hit ? hit_way : free_way);
            rq_page[slot] = page;
            rq_order[slot] = head_g[p];
            rq_next[slot] = -1;
            rq_core[slot] = core;
            if (hit) {
              rq_next[ppl_tail[e]] = slot;   // link to the page's tail
            } else {                          // allocate the entry
              ppl_page[e] = page;
              ppl_valid[e] = 1;
              ppl_head[e] = slot;
              poq[(poq_head + poq_len) % P] = e;
              ++poq_len;
            }
            ppl_tail[e] = slot;
            cursor[p] = cur + 1;
            ++inflight[core];
            ++inserted;
            if (cur + 1 < plen[p]) load_head(p, cur + 1);
            took = 1;
          }
        }
      }
      if (__shfl_sync(kFull, took, 0) && lane == (slot >> 5))
        free_word &= ~(1u << (slot & 31));
    }
    // Fig 6: forward the head request of the oldest page
    int freed = -1;
    if (lane == 0 && poq_len > 0) {
      const int e = poq[poq_head];
      const int head = ppl_head[e];
      if (emitted < n) perm[emitted] = rq_order[head];
      ++emitted;
      last_cycle = cycle;
      const int nxt = rq_next[head];
      if (nxt < 0) {                          // page exhausted
        ppl_valid[e] = 0;
        poq_head = (poq_head + 1) % P;
        --poq_len;
      } else {
        ppl_head[e] = nxt;
      }
      --inflight[rq_core[head]];
      freed = head;
    }
    freed = __shfl_sync(kFull, freed, 0);
    if (freed >= 0 && lane == (freed >> 5)) free_word |= 1u << (freed & 31);
  }
  if (lane == 0) {
    stats[0] = emitted;
    stats[1] = stalls;
    stats[2] = (int)(last_cycle + 1);
  }
}

}  // namespace

extern "C" {

// pages, src: int32[n]; port_req: int32[n_ports, max_len] (-1 padded);
// port_len: int32[n_ports]; perm: int64[n] (the forwarded indices in
// order; entries past the count forwarded are not written); stats:
// int32[3] = (forwarded, stall events, last forward's cycle + 1).  The
// shared-memory layout is this file's: 16 B a RequestQ slot, 16 B a
// PhyPageList entry, 4 B an order-queue slot, 24 B a port and 4 B a core.
// Returns 0 on success, -1 for an unsupported argument, -2 when the state
// does not fit in a block's shared memory, else the cudaError_t of the
// launch.
int mars_engine_run(const void* pages, const void* port_req,
                    const void* port_len, const void* src, int n, int max_len,
                    int n_cores, int request_q, int nsets, int ways,
                    int order_q, int n_ports, int mshr, long long max_cycles,
                    void* perm, void* stats, void* stream) {
  if (n <= 0 || max_len <= 0 || n_cores <= 0 || request_q <= 0 ||
      request_q > kMaxRequestQ || nsets <= 0 || ways <= 0 || order_q <= 0 ||
      n_ports <= 0 || max_cycles < 0)
    return -1;
  const Layout L = layout(request_q, nsets * ways, order_q, n_ports, n_cores);
  if (L.bytes > kMaxSmem) return -2;
  cudaError_t err = cudaFuncSetAttribute(
      mars_engine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  mars_engine_kernel<<<1, 32, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pages), static_cast<const int*>(port_req),
      static_cast<const int*>(port_len), static_cast<const int*>(src), n,
      max_len, n_cores, request_q, nsets, ways, order_q, n_ports, mshr,
      max_cycles, static_cast<long long*>(perm), static_cast<int*>(stats));
  return (int)cudaGetLastError();
}

const char* mars_engine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
