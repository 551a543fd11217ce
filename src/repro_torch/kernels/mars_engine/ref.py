"""Plain twin of the MARS cycle engine: a host loop over Python ints.

It follows the reference's scan step (``repro/core/mars.py``:
``_insert_port`` once per port, then ``_forward``) statement by statement,
including its tie-breaks and clamps:

  * ``hit_way``/``free_way`` are the first matching way (``jnp.argmax``
    of a bool vector; 0 when none matches);
  * the RequestQ slot is the lowest free one (``jnp.argmin`` of the
    occupancy bit-vector; 0 when the queue is full, and then
    ``rq_has_free`` is False) — kept here as an int of free bits, lowest
    set bit first.  The kernel keeps its free slots as a stack instead:
    which slot a request takes shows in no output (the source note of
    ``csrc/mars_engine.cu`` says why);
  * a port whose core is at its MSHR cap has no input, so it is not a
    stall; only a port with input and no room counts;
  * a port with ``plen == 0`` reads ``port_req[p, 0] == -1`` and then
    ``src[max(g, 0)]`` and ``pages[max(g, 0)]``;
  * the forward of a cycle may emit a request inserted in that cycle.

Once every port is drained and PhyPageOrderQ is empty no state changes,
so the loop stops there and the remaining cycles emit -1, as the
reference's fixed-length scan does.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.mars import _page_set_py, n_cycles


def mars_engine_plain(pages, port_req, port_len, src, n_req: int,
                      n_cores: int, cfg) -> tuple[np.ndarray, int]:
    """Run the reference's scan of ``3 n_req + request_q + 64`` cycles.

    Returns (emits, stalls): ``emits`` int32[cycles] is the original index
    forwarded each cycle or -1 (the reference's scan output), ``stalls``
    the port-stall events of the final state."""
    Q, S, W, P = cfg.request_q, cfg.nsets, cfg.ways, cfg.order_q
    n_ports, mshr = cfg.n_ports, cfg.mshr_per_core
    pages = [int(v) for v in np.asarray(pages).reshape(-1)]
    src = [int(v) for v in np.asarray(src).reshape(-1)]
    port_req = [[int(v) for v in row] for row in np.asarray(port_req)]
    port_len = [int(v) for v in np.asarray(port_len).reshape(-1)]
    cycles = n_cycles(n_req, cfg)
    emits = np.full(cycles, -1, np.int32)

    rq_page = [0] * Q
    rq_order = [0] * Q
    rq_next = [-1] * Q
    rq_free = (1 << Q) - 1          # bit i set: slot i free (~rq_valid)
    ppl_page = [[0] * W for _ in range(S)]
    ppl_valid = [[False] * W for _ in range(S)]
    ppl_head = [[0] * W for _ in range(S)]
    ppl_tail = [[0] * W for _ in range(S)]
    poq = [0] * P
    poq_head = poq_len = 0
    cursors = [0] * n_ports
    stalls = 0
    inflight = [0] * max(n_cores, 1)
    to_insert = sum(port_len[:n_ports])
    inserted = 0

    for cycle in range(cycles):
        if inserted == to_insert and poq_len == 0:
            break
        # --- Fig 5: one insertion attempt per port (_insert_port)
        for port in range(n_ports):
            cur, plen = cursors[port], port_len[port]
            g = port_req[port][min(cur, max(plen - 1, 0))]
            core = max(src[max(g, 0)], 0)
            if not (cur < plen and inflight[core] < mshr):
                continue                       # no input: not a stall
            page = pages[max(g, 0)]
            s = _page_set_py(page, S)
            set_pages, set_valid = ppl_page[s], ppl_valid[s]
            hit_way = free_way = -1
            for w in range(W):
                if hit_way < 0 and set_valid[w] and set_pages[w] == page:
                    hit_way = w
                if free_way < 0 and not set_valid[w]:
                    free_way = w
            hit = hit_way >= 0
            rq_has_free = rq_free != 0
            slot = (rq_free & -rq_free).bit_length() - 1 if rq_has_free \
                else 0
            can_hit = hit and rq_has_free
            can_miss = not hit and free_way >= 0 and rq_has_free
            if not (can_hit or can_miss):
                stalls += 1
                continue
            way = hit_way if hit else free_way
            rq_page[slot] = page
            rq_order[slot] = g
            rq_next[slot] = -1
            rq_free &= ~(1 << slot)
            if can_hit:                        # link to the page's tail
                rq_next[ppl_tail[s][way]] = slot
            else:                              # allocate the entry
                ppl_page[s][way] = page
                ppl_valid[s][way] = True
                ppl_head[s][way] = slot
                poq[(poq_head + poq_len) % P] = s * W + way
                poq_len += 1
            ppl_tail[s][way] = slot
            cursors[port] += 1
            inflight[core] += 1
            inserted += 1
        # --- Fig 6: forward the oldest page's head request (_forward)
        if poq_len > 0:
            flat = poq[poq_head % P]
            s, way = flat // W, flat % W
            head = ppl_head[s][way]
            emit = rq_order[head]
            emits[cycle] = emit
            nxt = rq_next[head]
            rq_free |= 1 << head
            if nxt < 0:                        # page exhausted
                ppl_valid[s][way] = False
                poq_head = (poq_head + 1) % P
                poq_len -= 1
            else:
                ppl_head[s][way] = nxt
            inflight[max(src[max(emit, 0)], 0)] -= 1
    return emits, stalls
