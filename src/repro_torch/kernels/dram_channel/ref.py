"""Plain twin of the FR-FCFS channel model: a host loop over Python ints.

It follows the reference's ``_run_channel`` step (``repro/core/dram.py``)
statement by statement: the FR-FCFS pick is the first slot of least key
(``jnp.argmin``; row hits key ``arrival``, misses ``_BIG + arrival``,
invalid slots ``2 _BIG``, so an all-invalid window picks slot 0 and
changes nothing); a stream shorter than the window pads with zeros and
only its first ``n`` slots are valid; the refill reads
``local[min(cursor, n - 1)]``.  Each slot's (bank, row) is decoded once,
when the slot fills, as the kernel does; ``_decode`` is a pure function of
the line id, so that is the reference's decode.
"""
from __future__ import annotations

from repro_torch.core.dram import _decode

BIG = 1 << 29                  # the reference's _BIG


def decode(local: int, cfg) -> tuple[int, int]:
    """(bank, row) of a channel-local line id: ``core.dram._decode`` on a
    Python int (floor division and arithmetic shifts, as on int32)."""
    _, bank, row = _decode(local, cfg)
    return bank, row


def run_channel_plain(local, is_write, cfg) -> tuple[int, int, int]:
    """Serve one channel's stream (``local`` int line ids, ``is_write``
    flags, in arrival order) through the window: (t_end, n_act, hits)."""
    local = [int(v) for v in local]
    is_write = [bool(v) for v in is_write]
    n, W, B = len(local), cfg.window, cfg.n_banks
    padded = local + [0] * max(0, W - n)
    padded_wr = is_write + [False] * max(0, W - n)
    win_arr = list(range(W))
    win_wr = padded_wr[:W]
    win_valid = [j < n for j in range(W)]
    win_bank, win_row = zip(*(decode(v, cfg) for v in padded[:W]))
    win_bank, win_row = list(win_bank), list(win_row)
    cursor = W
    open_row = [-1] * B
    bank_ready = [0] * B
    bus_free = 0
    act_hist = [-BIG] * 4
    act_ptr = 0
    last_act = -BIG
    last_dir = 0
    n_act = t_end = hits = 0
    for _ in range(n):
        # FR-FCFS: row hits first, oldest first; invalid slots never chosen
        j, best = 0, 2 * BIG + 1
        for s in range(W):
            if win_valid[s]:
                key = (0 if open_row[win_bank[s]] == win_row[s] else BIG) \
                    + win_arr[s]
            else:
                key = 2 * BIG
            if key < best:
                j, best = s, key
        if not win_valid[j]:
            continue
        b, r = win_bank[j], win_row[j]
        is_hit = open_row[b] == r
        was_open = open_row[b] >= 0
        # activate path (off other banks' data critical path)
        act_t = max(bank_ready[b] + (cfg.t_rp if was_open else 0),
                    max(act_hist[act_ptr] + cfg.t_faw,
                        last_act + cfg.t_rrd))
        row_ready = act_t + cfg.t_rcd
        # read<->write turnaround occupies the bus
        dirn = int(win_wr[j])
        turn = 0 if dirn == last_dir else (cfg.t_rtw if dirn == 1
                                           else cfg.t_wtr)
        bus_avail = bus_free + turn
        start = max(bus_avail, bank_ready[b] if is_hit else row_ready)
        end = start + cfg.t_burst
        if not is_hit:
            open_row[b] = r
            act_hist[act_ptr] = act_t
            act_ptr = (act_ptr + 1) % 4
            last_act = act_t
            n_act += 1
        bank_ready[b] = start + cfg.t_ccd
        bus_free = end
        last_dir = dirn
        t_end = max(t_end, end)
        hits += is_hit
        # refill slot j from the input stream
        if cursor < n:
            nxt = local[min(cursor, n - 1)]
            win_bank[j], win_row[j] = decode(nxt, cfg)
            win_arr[j] = cursor
            win_wr[j] = is_write[min(cursor, n - 1)]
            cursor += 1
        else:
            win_valid[j] = False
    return t_end, n_act, hits
