// LPDDR4 FR-FCFS channel model for Hopper (sm_90a), plain C interface.
//
// Replaces the device program of the reference's DRAM timing model, the
// `jax.lax.scan` of src/repro/core/dram.py:219 (`_run_channel`, :135-220,
// with `_decode` :87).  It is not a Pallas kernel, but it runs on the
// accelerator there; a PyTorch loop of small ops would launch some
// hundred kernels a served request.
//
// What it computes.  One loop iteration serves one request of a channel:
// the FR-FCFS pick in the `window`-entry pending queue (row hits first,
// then the oldest; the lowest slot on equal keys, like `jnp.argmin`; an
// all-invalid window picks slot 0 and changes nothing), the bank's
// precharge and activate under tRP, tRCD, tFAW (a ring of the last 4
// ACTs) and tRRD, the bus turnaround between reads and writes, and the
// refill of the served slot from the stream.  Output per channel: the
// latest data end (t_end), the ACT count and the row hits, all int32 as
// in the reference (_BIG = 1 << 29; a stream shorter than the window has
// only its first n slots valid).
//
// Bounds.  Bytes: 5 B a request read once (int32 line id, write flag),
// 12 B a channel written: 0.03 us at 3.35 TB/s for 16384 requests.  That
// is not what binds: each served request depends on the last (bank
// state, bus clock, the window's contents), so a channel is a chain of n
// dependent steps.  The chain bound is n steps of the longest channel at
// one dependent shared-memory load each (the card's latency, timed by
// tools/s1s2_timing.py); it binds, some 10^3 above the byte bound.
//
// Design.  One warp a channel, every channel of every stream of a call in
// one launch (the caller lays the streams' channels back to back).
// Window slot j lives in lane j % 32, slot j / 32 of that lane's
// registers (SLOTS a lane: window <= 32 SLOTS, at most 256): its arrival,
// write flag, bank, row and row-hit flag.  A step:
//   * each lane takes the least key, (hit ? 0 : BIG) + arrival, over its
//     own slots, and reads its candidate's bank state (open row, ready
//     time) from shared memory while one __reduce_min_sync (redux.sync)
//     finds the warp's least key.  Keys of valid slots are unique (the
//     arrivals are), so exactly one lane holds the least valid key and
//     no tie among valid slots can arise; within a channel's n steps the
//     window always holds a valid request, so the reference's
//     all-invalid step (which changes nothing) never comes;
//   * the owner writes its bank, row, direction, open-row flag and ready
//     time to a mailbox in shared memory, and after a __syncwarp every
//     lane reads them with one 16-byte load (three __reduce_or_sync
//     would run one after another); every lane then computes the same
//     timing, keeps the same scalars (bus clock, last ACT, direction,
//     counts, the tFAW ring as four registers whose first is its oldest
//     entry) and writes the same bank state to shared memory;
//   * only bank b's open row can change in a step: after an activate each
//     lane re-derives the hit flags of its slots on bank b, and the
//     refilled slot's flag comes from the open row of its bank; these
//     updates, the refill and the tFAW ring are selects, not branches,
//     and an invalid slot's key is a register, so a step runs straight;
//   * the refill is off the chain: the stream is read 32 requests at a
//     time, one a lane, two chunks ahead, and each lane decodes its own
//     element (bank, row, write flag) a chunk before it is needed; the
//     next element reaches the owner by a shuffle whose source lane the
//     cursor gives before the pick.
// A request's chain: one reduction, one shared-memory round trip and the
// timing arithmetic, against some 20 dependent shuffles before.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBig = 1 << 29;            // the reference's _BIG
constexpr int kNoSlot = 0x7fffffff;      // a key above every real slot's

struct Timing {
  int window, n_banks, lines_per_row, t_rcd, t_rp, t_burst, t_ccd, t_rrd,
      t_faw, t_wtr, t_rtw;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return (r != 0 && ((r < 0) != (m < 0))) ? r + m : r;
}

// the reference's `_decode`: row, and the XOR-folded bank hash
__device__ __forceinline__ void decode(int local, const Timing& t, int k,
                                       int rounds, int& bank, int& row) {
  row = floor_div(local, t.lines_per_row * t.n_banks);
  const int page = floor_div(local, t.lines_per_row);
  int b = page, x = page >> k;
  for (int i = 0; i < rounds; ++i) {
    b ^= x;
    x >>= k;
  }
  bank = floor_mod(b, t.n_banks);
}

template <int SLOTS>
__global__ void __launch_bounds__(32)
dram_channel_kernel(const int* __restrict__ local,
                    const uint8_t* __restrict__ is_write,
                    const long long* __restrict__ offsets, Timing t,
                    int* __restrict__ out) {
  __shared__ int open_row[32], bank_ready[32];
  __shared__ int4 box[2];
  const int ch = blockIdx.x;
  const int lane = threadIdx.x;
  const long long off = offsets[ch];
  const int n = (int)(offsets[ch + 1] - off);
  const int W = t.window;
  const int k = t.n_banks > 1 ? max(1, 32 - __clz(t.n_banks - 1)) : 1;
  const int rounds = max(1, (31 + k - 1) / k);
  const int* in = local + off;
  const uint8_t* wr_in = is_write + off;

  open_row[lane] = -1;
  bank_ready[lane] = 0;
  __syncwarp();

  // window slots of this lane: j = 32 s + lane
  // s_dead: an invalid slot's key, 2 BIG (the reference's) for a slot of
  // the window, above every key for a lane's slot past the window
  int s_arr[SLOTS], s_bank[SLOTS], s_row[SLOTS], s_dead[SLOTS];
  bool s_valid[SLOTS], s_wr[SLOTS], s_hit[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int j = 32 * s + lane;
    s_dead[s] = j < W ? 2 * kBig : kNoSlot;
    s_valid[s] = j < W && j < n;
    s_wr[s] = s_valid[s] ? wr_in[j] != 0 : false;
    s_arr[s] = j;
    decode(s_valid[s] ? in[j] : 0, t, k, rounds, s_bank[s], s_row[s]);
    s_hit[s] = open_row[s_bank[s]] == s_row[s];
  }
  // the stream from `base` on, a request a lane: `cur` and `nxt` decoded
  // (bank | write << 5, row), `raw` as read
  int base = W;
  int cur_bw = 0, cur_row = 0, nxt_bw = 0, nxt_row = 0, raw_v = 0, raw_w = 0;
  {
    int i = base + lane;
    if (i < n) {
      decode(in[i], t, k, rounds, cur_bw, cur_row);
      cur_bw |= (wr_in[i] != 0) << 5;
    }
    i += 32;
    if (i < n) {
      decode(in[i], t, k, rounds, nxt_bw, nxt_row);
      nxt_bw |= (wr_in[i] != 0) << 5;
    }
    i += 32;
    if (i < n) {
      raw_v = in[i];
      raw_w = wr_in[i];
    }
  }
  // scalars, kept alike by every lane; the tFAW ring, oldest first
  int a0 = -kBig, a1 = -kBig, a2 = -kBig, a3 = -kBig;
  int last_act = -kBig, bus_free = 0, last_dir = 0, n_act = 0, t_end = 0,
      hits = 0, cursor = W, par = 0;

  for (int step = 0; step < n; ++step) {
    // the next request of the stream, for the refill (off the chain)
    const int src_lane = (cursor - base) & 31;
    const int new_bw = __shfl_sync(kFull, cur_bw, src_lane);
    const int new_row = __shfl_sync(kFull, cur_row, src_lane);
    const int new_open = open_row[new_bw & 31];
    // this lane's least key: row hits first, then the oldest
    int lmin = kNoSlot, cs = 0, cb = 0, cr = 0, cw = 0;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int key =
          s_valid[s] ? (s_hit[s] ? 0 : kBig) + s_arr[s] : s_dead[s];
      if (key < lmin) {                  // ascending slots: lower wins ties
        lmin = key;
        cs = s;
        cb = s_bank[s];
        cr = s_row[s];
        cw = s_wr[s];
      }
    }
    const int c_open = open_row[cb], c_ready = bank_ready[cb];
    // at step k the window holds min(window, n - k) >= 1 valid requests
    // (a served slot is refilled while the stream lasts), so the least key
    // is a valid one: the reference's all-invalid case cannot arise here
    const int m = __reduce_min_sync(kFull, lmin);
    const bool owner = lmin == m;        // one lane: valid keys are unique
    const bool is_hit = m < kBig;
    // the owner's request reaches every lane through a mailbox (two, used
    // in turn, so no lane can still be reading the one being written)
    if (owner) box[par] = make_int4(cb | cw << 5 | (c_open >= 0) << 6, cr,
                                    c_ready, 0);
    __syncwarp();
    const int4 bx = box[par];
    par ^= 1;
    const int b = bx.x & 31, dirn = bx.x >> 5 & 1, r = bx.y, brb = bx.z;
    const bool was_open = bx.x >> 6 & 1;

    const int act_t = max(brb + (was_open ? t.t_rp : 0),
                          max(a0 + t.t_faw, last_act + t.t_rrd));
    const int row_ready = act_t + t.t_rcd;
    const int turn = dirn == last_dir ? 0 : (dirn == 1 ? t.t_rtw : t.t_wtr);
    const int bus_avail = bus_free + turn;
    const int start = is_hit ? max(bus_avail, brb) : max(bus_avail, row_ready);
    const int end = start + t.t_burst;
    const bool act = !is_hit;
    bank_ready[b] = start + t.t_ccd;     // every lane writes the same
    if (act) open_row[b] = r;
    // straight-line updates (selects, no branches) from here to the refill
    a0 = act ? a1 : a0;
    a1 = act ? a2 : a1;
    a2 = act ? a3 : a2;
    a3 = act ? act_t : a3;
    last_act = act ? act_t : last_act;
    n_act += act;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
      s_hit[s] = act && s_bank[s] == b ? s_row[s] == r : s_hit[s];
    bus_free = end;
    last_dir = dirn;
    t_end = max(t_end, end);
    hits += is_hit;

    // refill the served slot from the stream
    const bool have_next = cursor < n;
    const int nb = new_bw & 31;
    const bool new_hit = act && nb == b ? new_row == r : new_row == new_open;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const bool mine = owner && s == cs;
      const bool fill = mine && have_next;
      s_valid[s] = mine ? have_next : s_valid[s];
      s_arr[s] = fill ? cursor : s_arr[s];
      s_bank[s] = fill ? nb : s_bank[s];
      s_row[s] = fill ? new_row : s_row[s];
      s_wr[s] = fill ? (new_bw >> 5 & 1) != 0 : s_wr[s];
      s_hit[s] = fill ? new_hit : s_hit[s];
    }
    if (have_next && ++cursor - base == 32) {
      base += 32;
      cur_bw = nxt_bw;
      cur_row = nxt_row;
      decode(raw_v, t, k, rounds, nxt_bw, nxt_row);
      nxt_bw |= (raw_w != 0) << 5;
      const int i = base + 64 + lane;
      raw_v = i < n ? in[i] : 0;
      raw_w = i < n ? wr_in[i] : 0;
    }
  }
  if (lane == 0) {
    out[3 * ch + 0] = t_end;
    out[3 * ch + 1] = n_act;
    out[3 * ch + 2] = hits;
  }
}

}  // namespace

extern "C" {

// local: int32 channel-local line ids of every channel back to back;
// is_write: uint8, the same layout; offsets: int64[n_channels + 1], channel
// c's requests at [offsets[c], offsets[c + 1]); timing: the DramConfig's
// ints.  out: int32[n_channels, 3] = (t_end, n_act, hits).  One warp a
// channel, all in one launch.  Returns 0 on success, -1 for an
// unsupported argument (window outside 1..256, n_banks outside 1..32,
// lines_per_row < 1), else the cudaError_t of the launch.
int dram_channels_run(const void* local, const void* is_write,
                      const void* offsets, int n_channels, int window,
                      int n_banks, int lines_per_row, int t_rcd, int t_rp,
                      int t_burst, int t_ccd, int t_rrd, int t_faw, int t_wtr,
                      int t_rtw, void* out, void* stream) {
  if (n_channels <= 0) return 0;
  if (window < 1 || window > 256 || n_banks < 1 || n_banks > 32 ||
      lines_per_row < 1)
    return -1;
  const Timing t{window, n_banks, lines_per_row, t_rcd, t_rp, t_burst,
                 t_ccd, t_rrd, t_faw, t_wtr, t_rtw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(local);
  const uint8_t* w = static_cast<const uint8_t*>(is_write);
  const long long* o = static_cast<const long long*>(offsets);
  int* r = static_cast<int*>(out);
  if (window <= 32)
    dram_channel_kernel<1><<<n_channels, 32, 0, s>>>(l, w, o, t, r);
  else if (window <= 64)
    dram_channel_kernel<2><<<n_channels, 32, 0, s>>>(l, w, o, t, r);
  else if (window <= 128)
    dram_channel_kernel<4><<<n_channels, 32, 0, s>>>(l, w, o, t, r);
  else
    dram_channel_kernel<8><<<n_channels, 32, 0, s>>>(l, w, o, t, r);
  return (int)cudaGetLastError();
}

const char* dram_channel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
