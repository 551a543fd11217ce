"""MARS engine — cycle-level, hardware-faithful (port of
``repro/core/mars.py``).

The three hardware structures of the paper map 1:1 onto fixed-size arrays:

  RequestQ       -> Q-entry payload (page, original index) + intrusive
                    linked list ``rq_next`` + occupancy bit-vector
  PhyPageList    -> (NSETS x WAYS) set-associative entries keyed by physical
                    page number, each holding head/tail RequestQ slots
  PhyPageOrderQ  -> ring buffer of flat PhyPageList entry ids, FIFO in page
                    first-arrival order

One step == one GPU-boundary cycle.  The boundary has ``n_ports``
insertion ports (one per shader-core group), each attempting one insertion
per cycle (paper Fig 5); a port whose head request hits a full PhyPageList
set or a full RequestQ stalls *itself* only, not its siblings.  One request
per cycle is forwarded (paper Fig 6): always from the page that holds the
oldest buffered request (PhyPageOrderQ FIFO), draining that page to
exhaustion before moving on.

The reference runs the cycles as a ``jax.lax.scan``; here the cycles are
the hand-written CUDA kernel ``csrc/mars_engine.cu`` on a CUDA device and
its plain twin (``kernels/mars_engine/ref.py``, a host loop over Python
ints, statement by statement the reference's step) on the CPU.  Both give
the reference's integers: the permutation, the stall count and the cycle
of the last forward.  ``mars_reorder_reference`` is the slow OrderedDict
oracle of the same engine, copied whole.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.streams import PAGE_SHIFT
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MarsConfig:
    """Paper Section 4 configuration: 512-entry RequestQ, 128-entry 2-way
    set-associative PhyPageList."""

    request_q: int = 512
    page_entries: int = 128
    ways: int = 2
    # insertion ports at the GPU boundary (one per shader core group)
    n_ports: int = 8
    # max outstanding (buffered) requests per source core: shader cores have
    # a finite number of L1 MSHRs, which bounds how deep any single stream
    # can pile into the boundary queue
    mshr_per_core: int = 16

    @property
    def nsets(self) -> int:
        return self.page_entries // self.ways

    @property
    def order_q(self) -> int:
        # one PhyPageOrderQ slot per PhyPageList entry suffices (an entry is
        # pushed exactly once per allocation) -> never overflows.
        return self.page_entries


def _page_set_py(p: int, nsets: int) -> int:
    """XOR-fold all page bits down to the index width (python mirror)."""
    k = max(1, (nsets - 1).bit_length())
    s = p
    x = p >> k
    for _ in range(max(1, (31 + k - 1) // k)):
        s ^= x
        x >>= k
    return s % nsets


def n_cycles(n_req: int, cfg: MarsConfig) -> int:
    """Cycles the reference's scan runs: forwarding needs n non-idle
    cycles; idle cycles are bounded by port stalls which resolve as pages
    drain -> 3n + slack always completes."""
    return 3 * n_req + cfg.request_q + 64


def prepare(addr, ports=None, cfg: MarsConfig | None = None, src=None):
    """The reference's host preparation: pages (int32), per-port
    request-index queues padded with -1 to equal length, their lengths,
    the source core of every request and the core count."""
    cfg = cfg or MarsConfig()
    addr = np.asarray(addr)
    n = int(addr.shape[0])
    pages = (np.asarray(addr, np.int64) >> PAGE_SHIFT).astype(np.int32)
    if ports is None:
        ports = np.arange(n) % cfg.n_ports
    ports = np.asarray(ports) % cfg.n_ports
    if src is None:
        src = ports.astype(np.int32)   # 1 "core" per port if not given
    src = np.asarray(src, np.int32)
    n_cores = int(src.max()) + 1 if n else 1
    port_lists = [np.flatnonzero(ports == p) for p in range(cfg.n_ports)]
    max_len = max((len(l) for l in port_lists), default=0)
    port_req = np.full((cfg.n_ports, max(max_len, 1)), -1, np.int32)
    for p, l in enumerate(port_lists):
        port_req[p, :len(l)] = l
    port_len = np.array([len(l) for l in port_lists], np.int32)
    return pages, port_req, port_len, src, n_cores


def mars_reorder(addr, ports=None, cfg: MarsConfig | None = None, src=None,
                 *, device="cuda") -> tuple[np.ndarray, dict]:
    """Run the cycle-level MARS engine over a request stream.

    ``ports``: per-request boundary-port id (e.g. source shader-core group);
    defaults to distributing the stream round-robin over the ports, which
    preserves arrival order per port.

    Returns (perm, stats): ``perm`` is the permutation such that
    ``addr[perm]`` is the order requests leave MARS toward the memory
    controller; ``stats`` has stall/latency counters.  ``device="cuda"``
    (the default) runs the CUDA kernel and raises without a GPU;
    ``device="cpu"`` runs its plain twin.
    """
    return mars_reorder_many([(addr, ports, cfg, src)], device=device)[0]


def mars_reorder_many(items, *, device="cuda") -> list:
    """``mars_reorder`` over several independent streams, each ``(addr,
    ports, cfg, src)`` as ``mars_reorder`` takes them (None for a
    default), each under its own configuration.  Returns what
    ``mars_reorder`` returns for each, with the same drain and
    permutation checks.  ``device="cuda"`` (the default) runs every
    stream in one launch of the CUDA kernel and raises without a GPU;
    ``device="cpu"`` runs the plain twin stream by stream."""
    from repro_torch.kernels.mars_engine.mars_engine import mars_engine_many
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    jobs, out = [], []
    for addr, ports, cfg, src in items:
        cfg = cfg or MarsConfig()
        n = int(np.asarray(addr).shape[0])
        out.append((np.zeros(0, np.int64), {
            "stall_events": 0, "total_cycles": 0, "idle_frac": 0.0}))
        if n:
            pages, port_req, port_len, src_, n_cores = prepare(addr, ports,
                                                               cfg, src)
            jobs.append((len(out) - 1, n, (t(pages), t(port_req),
                                           t(port_len), t(src_), n_cores,
                                           cfg)))
    results = mars_engine_many([job for _, _, job in jobs])
    for (i, n, _), (perm, stats) in zip(jobs, results):
        perm = perm.cpu().numpy()
        emitted, stalls, total = (int(v) for v in stats.cpu().tolist())
        if emitted != n:  # engine must drain completely
            raise AssertionError(
                f"MARS drained {emitted}/{n} requests — engine bug")
        if np.unique(perm).shape[0] != n:
            raise AssertionError("MARS emitted a non-permutation — engine "
                                 "bug")
        out[i] = perm, {
            "stall_events": stalls,
            "total_cycles": total,
            "idle_frac": 1.0 - n / float(total),
        }
    return out


def mars_reorder_reference(addr: np.ndarray, ports: np.ndarray | None = None,
                           cfg: MarsConfig | None = None,
                           src: np.ndarray | None = None) -> np.ndarray:
    """Slow pure-python oracle of the same engine (for tests)."""
    cfg = cfg or MarsConfig()
    pages = np.asarray(addr, np.int64) >> PAGE_SHIFT
    n = len(pages)
    if ports is None:
        ports = np.arange(n) % cfg.n_ports
    ports = np.asarray(ports) % cfg.n_ports
    if src is None:
        src = ports.astype(np.int32)
    src = np.asarray(src, np.int32)
    inflight: dict[int, int] = {}
    from collections import OrderedDict, deque
    queues = [deque(np.flatnonzero(ports == p)) for p in range(cfg.n_ports)]
    buffered: "OrderedDict[int, deque[int]]" = OrderedDict()  # page -> [gidx]
    setcnt: dict[int, set[int]] = {}
    total = 0
    out: list[int] = []
    while len(out) < n:
        for q in queues:                       # one attempt per port
            if not q:
                continue
            g = int(q[0])
            if inflight.get(int(src[g]), 0) >= cfg.mshr_per_core:
                continue
            p = int(pages[g])
            s = _page_set_py(p, cfg.nsets)
            if p in buffered:
                if total < cfg.request_q:
                    buffered[p].append(g)
                    total += 1
                    inflight[int(src[g])] = inflight.get(int(src[g]), 0) + 1
                    q.popleft()
            else:
                ways = setcnt.setdefault(s, set())
                if len(ways) < cfg.ways and total < cfg.request_q:
                    buffered[p] = deque([g])
                    ways.add(p)
                    total += 1
                    inflight[int(src[g])] = inflight.get(int(src[g]), 0) + 1
                    q.popleft()
        if buffered:                           # forward one request
            page0 = next(iter(buffered))       # oldest-allocated page
            lst = buffered[page0]
            gg = int(lst.popleft())
            out.append(gg)
            inflight[int(src[gg])] -= 1
            total -= 1
            if not lst:
                del buffered[page0]
                setcnt[_page_set_py(page0, cfg.nsets)].discard(page0)
    return np.asarray(out, np.int64)
