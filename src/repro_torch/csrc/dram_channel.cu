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
// Bound.  Bytes: 5 B a request read once (int32 line id, write flag),
// 12 B a channel written: 0.03 us at 3.35 TB/s for 16384 requests.  That
// is not what binds: each served request depends on the last (bank
// state, bus clock, the window's contents), so a channel is a chain of n
// dependent steps, each a reduction over the window and a few broadcasts.
// The serial limit is n steps at some tens of GPU clocks a step.
//
// Design.  One warp a channel, all channels in one launch.  Window slot j
// lives in lane j % 32, slot j / 32 of that lane's registers (SLOTS a
// lane: window <= 32 SLOTS, at most 256): its line id, arrival, write
// flag and its decoded bank and row (decoded once, when the slot fills).
// Bank b's open row and ready time live in lane b's registers (n_banks
// <= 32), the tFAW ring's entry a in lane a; a lane reads its slot's open
// row with a shuffle from the bank's lane.  The pick is a shuffle
// reduction of (key, slot) that keeps the lower slot on equal keys.  The
// scalars (bus clock, last ACT, direction, counts) are kept by every lane
// alike.  The stream is read 32 requests at a time, one a lane, a chunk
// ahead of the refills, so no step waits on device memory.
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
  const int ch = blockIdx.x;
  const int lane = threadIdx.x;
  const long long off = offsets[ch];
  const int n = (int)(offsets[ch + 1] - off);
  const int W = t.window;
  const int k = t.n_banks > 1 ? max(1, 32 - __clz(t.n_banks - 1)) : 1;
  const int rounds = max(1, (31 + k - 1) / k);
  const int* in = local + off;
  const uint8_t* wr_in = is_write + off;

  // window slots of this lane: j = 32 s + lane
  int s_arr[SLOTS], s_bank[SLOTS], s_row[SLOTS];
  bool s_valid[SLOTS], s_wr[SLOTS], s_exists[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int j = 32 * s + lane;
    s_exists[s] = j < W;
    s_valid[s] = j < W && j < n;
    const int v = s_valid[s] ? in[j] : 0;
    s_wr[s] = s_valid[s] ? wr_in[j] != 0 : false;
    s_arr[s] = j;
    decode(v, t, k, rounds, s_bank[s], s_row[s]);
  }
  // bank `lane`'s state; tFAW ring entry `lane`
  int open_row = -1, bank_ready = 0, act_hist = -kBig;
  // scalars, kept alike by every lane
  int act_ptr = 0, last_act = -kBig, bus_free = 0, last_dir = 0, n_act = 0,
      t_end = 0, hits = 0, cursor = W;
  // the stream from `cursor` on, a chunk a lane ahead
  int base = W;
  int cur_v = base + lane < n ? in[base + lane] : 0;
  int cur_w = base + lane < n ? wr_in[base + lane] : 0;
  int nxt_v = base + 32 + lane < n ? in[base + 32 + lane] : 0;
  int nxt_w = base + 32 + lane < n ? wr_in[base + 32 + lane] : 0;

  for (int step = 0; step < n; ++step) {
    // FR-FCFS key of each slot: row hits first, then the oldest
    int key = kNoSlot, slot = kNoSlot;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int orow = __shfl_sync(kFull, open_row, s_bank[s]);
      const bool hit = s_valid[s] && orow == s_row[s];
      const int kk = !s_exists[s] ? kNoSlot
                     : s_valid[s] ? (hit ? 0 : kBig) + s_arr[s]
                                  : 2 * kBig;
      if (kk < key) {                    // ascending slots: lower wins ties
        key = kk;
        slot = 32 * s + lane;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int ok = __shfl_xor_sync(kFull, key, o);
      const int os = __shfl_xor_sync(kFull, slot, o);
      if (ok < key || (ok == key && os < slot)) {
        key = ok;
        slot = os;
      }
    }
    const bool valid = key < 2 * kBig;   // every valid key is below 2 BIG
    if (!valid) continue;                // the reference changes nothing
    const bool is_hit = key < kBig;
    const int owner = slot & 31, js = slot >> 5;
    int my_bank = 0, my_row = 0, my_wr = 0;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
      if (s == js) {
        my_bank = s_bank[s];
        my_row = s_row[s];
        my_wr = s_wr[s];
      }
    const int b = __shfl_sync(kFull, my_bank, owner);
    const int r = __shfl_sync(kFull, my_row, owner);
    const int dirn = __shfl_sync(kFull, my_wr, owner);
    const int orb = __shfl_sync(kFull, open_row, b);
    const int brb = __shfl_sync(kFull, bank_ready, b);
    const int ah = __shfl_sync(kFull, act_hist, act_ptr);

    const bool was_open = orb >= 0;
    const int act_t = max(brb + (was_open ? t.t_rp : 0),
                          max(ah + t.t_faw, last_act + t.t_rrd));
    const int row_ready = act_t + t.t_rcd;
    const int turn = dirn == last_dir ? 0 : (dirn == 1 ? t.t_rtw : t.t_wtr);
    const int bus_avail = bus_free + turn;
    const int start = is_hit ? max(bus_avail, brb) : max(bus_avail, row_ready);
    const int end = start + t.t_burst;
    const bool did_act = !is_hit;
    if (lane == b) {
      if (did_act) open_row = r;
      bank_ready = start + t.t_ccd;
    }
    bus_free = end;
    if (did_act) {
      if (lane == act_ptr) act_hist = act_t;
      act_ptr = (act_ptr + 1) % 4;
      last_act = act_t;
      ++n_act;
    }
    last_dir = dirn;
    t_end = max(t_end, end);
    hits += is_hit;

    // refill the served slot from the stream
    const bool have_next = cursor < n;
    const int v = __shfl_sync(kFull, cur_v, (cursor - base) & 31);
    const int w = __shfl_sync(kFull, cur_w, (cursor - base) & 31);
    if (lane == owner) {
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
        if (s == js) {
          s_valid[s] = have_next;
          if (have_next) {
            s_arr[s] = cursor;
            s_wr[s] = w != 0;
            decode(v, t, k, rounds, s_bank[s], s_row[s]);
          }
        }
    }
    if (have_next && ++cursor - base == 32) {
      base += 32;
      cur_v = nxt_v;
      cur_w = nxt_w;
      const int i = base + 32 + lane;
      nxt_v = i < n ? in[i] : 0;
      nxt_w = i < n ? wr_in[i] : 0;
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
// channel.  Returns 0 on success, -1 for an unsupported argument (window
// outside 1..256, n_banks outside 1..32, lines_per_row < 1), else the
// cudaError_t of the launch.
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
