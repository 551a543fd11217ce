"""SSD (Mamba2) chunked scan (port of ``repro/kernels/ssd_scan/
ssd_scan.py``).

``ssd_scan`` is the wrapper around the hand-written Hopper kernels
``csrc/ssd_scan.cu`` (which replace the Pallas ``_kernel`` /
``ssd_scan``; the source comment there gives their bound and design).
One chunk (S <= the chunk: every serve prefill) is one launch; more
chunks are three: every chunk's state contribution in parallel, a pass
that carries the state over the chunks, then every chunk's output.
``split_plan`` picks the heads and the P columns a block owns from the
shapes and the SM count.  On CUDA tensors it launches the kernels or
raises — there is no fallback; on CPU tensors it runs ``ssd_scan_plain``,
the kernel's plain PyTorch twin: the same chunked math in float32, chunk
by chunk, which the CPU tests and ``chip_smoke.py`` compare against.
``ssd_scan_chunked_plain`` does the kernels' passes in PyTorch.
``ssd_scan.launches`` counts calls that launched the kernels, and
``ssd_scan.pass_launches`` the two extra launches of a call of more than
one chunk.  The kernels have no backward yet: on CUDA tensors a call
that autograd would differentiate raises (``_refuse_grad``) instead of
running outside the graph.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 64                    # the kernel's largest chunk
_SMEM_LIMIT = 232_448             # bytes of shared memory a block may use
MODES = {"fused": 0, "state": 1, "output": 2}
P_BLOCKS = (64, 32, 16)           # columns of P a block may own
HEAD_GROUPS = (1, 2, 4, 8)        # heads a block may own
# a block's fixed cost (its loads, barriers and scan) in multiply-adds:
# on an H100, 1792 blocks of 8 heads ran the long case (B 4, S 4096, 50
# heads) faster than 6400 blocks of 2, which a count of products alone
# ranks the other way
BLOCK_MACS = 100_000


class Plan(NamedTuple):
    """How a call cuts its work: ``heads`` heads and ``p_block`` columns
    of P a block; ``n_chunks`` chunks, one launch if 1, else three."""
    heads: int
    p_block: int
    n_chunks: int


def chunk_len(S: int, chunk: int) -> int:
    """The chunk length ``q = min(chunk, S)``; raises unless it divides
    ``S`` (the reference asserts the same)."""
    q = min(chunk, S)
    if q < 1 or S % q:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"SSD chunk {q} (chunk={chunk})")
    return q


def ssd_scan_plain(x, b, c, la, dt, *, chunk: int = 64):
    """The kernel's plain twin: chunked SSD in float32 torch, chunk by
    chunk with the state carried between chunks.  Same contract as
    ``ssd_scan``."""
    Bz, S, H, P = x.shape
    N = b.shape[-1]
    q = chunk_len(S, chunk)
    x, b, c, la, dt = (t.float() for t in (x, b, c, la, dt))
    s = torch.zeros((Bz, H, P, N), dtype=torch.float32, device=x.device)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    ys = []
    for ic in range(S // q):
        sl = slice(ic * q, (ic + 1) * q)
        xc, bc, cc, lac, dtc = x[:, sl], b[:, sl], c[:, sl], la[:, sl], \
            dt[:, sl]
        cum = torch.cumsum(lac, dim=1)                      # (B, q, H)
        # within-chunk quadratic term; the mask keeps the upper triangle 0
        li = cum[:, :, None, :] - cum[:, None, :, :]        # (B, q, k, H)
        L = torch.where(tri[None, :, :, None],
                        torch.exp(torch.clamp_max(li, 0.0)),
                        torch.zeros((), device=x.device))
        scores = torch.einsum("bqn,bkn->bqk", cc, bc)[..., None] * L \
            * dtc[:, None, :, :]                            # (B, q, k, H)
        y_intra = torch.einsum("bqkh,bkhp->bqhp", scores, xc)
        # inter-chunk: the carried state's contribution
        y_inter = torch.einsum("bqn,bhpn,bqh->bqhp", cc, s, torch.exp(cum))
        ys.append(y_intra + y_inter)
        dec_end = torch.exp(cum[:, -1:, :] - cum)           # (B, q, H)
        z = torch.einsum("bkn,bkh,bkhp->bhpn", bc, dec_end * dtc, xc)
        s = s * torch.exp(cum[:, -1])[:, :, None, None] + z
    return torch.cat(ys, dim=1), s


def ssd_scan_chunked_plain(x, b, c, la, dt, *, chunk: int = 64):
    """The kernels' passes in float32 torch: every chunk's state
    contribution ``z_c`` and total decay at once; the state carried over
    the chunks, ``s_c = decay_c s_{c-1} + z_c``, keeping the state that
    enters each chunk; then every chunk's output, the intra-chunk term
    plus ``exp(cum_t) c_t . s_{c-1}``.  Same contract as ``ssd_scan``."""
    Bz, S, H, P = x.shape
    N = b.shape[-1]
    q = chunk_len(S, chunk)
    nc = S // q
    x, b, c, la, dt = (t.float() for t in (x, b, c, la, dt))
    xc = x.reshape(Bz, nc, q, H, P)
    bc, cc = b.reshape(Bz, nc, q, N), c.reshape(Bz, nc, q, N)
    cum = torch.cumsum(la.reshape(Bz, nc, q, H), dim=2)     # (B, nc, q, H)
    dtc = dt.reshape(Bz, nc, q, H)
    # pass 1: each chunk's contribution to the state, and its decay
    dec = torch.exp(cum[:, :, -1:] - cum) * dtc
    z = torch.einsum("bckn,bckh,bckhp->bchpn", bc, dec, xc)
    decay = torch.exp(cum[:, :, -1])                        # (B, nc, H)
    # pass 2: the state entering each chunk
    s = torch.zeros((Bz, H, P, N), dtype=torch.float32, device=x.device)
    entering = []
    for ic in range(nc):
        entering.append(s)
        s = decay[:, ic, :, None, None] * s + z[:, ic]
    s_prev = torch.stack(entering, 1)                       # (B, nc, H, P, N)
    # pass 3: the outputs
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B, nc, t, k, H)
    L = torch.where(tri[None, None, :, :, None],
                    torch.exp(torch.clamp_max(li, 0.0)),
                    torch.zeros((), device=x.device))
    w = torch.einsum("bctn,bckn->bctk", cc, bc)[..., None] * L \
        * dtc[:, :, None, :, :]                             # (B, nc, t, k, H)
    y = torch.einsum("bctkh,bckhp->bcthp", w, xc) \
        + torch.einsum("bctn,bchpn,bcth->bcthp", cc, s_prev, torch.exp(cum))
    return y.reshape(Bz, S, H, P), s


def smem_bytes(q: int, p_block: int, N: int, mode: str) -> int:
    """Shared memory one block of the chunk kernel takes in ``mode``
    (mirrors ``smem_floats`` in ``csrc/ssd_scan.cu``)."""
    q4, n4, p4 = (-(-v // 4) * 4 for v in (q, N, p_block))
    f = 4 * q4 + q4 * p4
    if mode != "output":
        f += q4 * n4
    if mode != "state":
        f += 2 * n4 * q4 + 2 * q4 * q4
    if mode == "output":
        f += n4 * p4
    return 4 * f


def _modes(n_chunks: int) -> tuple:
    return ("fused",) if n_chunks == 1 else ("state", "output")


def _block_macs(q: int, pb: int, N: int, heads: int, mode: str) -> int:
    """Multiply-adds a block of the chunk kernel does in ``mode`` (q, N
    and pb padded to 4, as it computes them), plus ``BLOCK_MACS``."""
    q4, n4, p4 = (-(-v // 4) * 4 for v in (q, N, pb))
    z = q4 * p4 * n4                          # the state contribution
    y = q4 * q4 * p4 // 2                     # W x, lower triangle
    if mode == "state":
        return BLOCK_MACS + heads * z
    cb = q4 * q4 * n4                         # C B^T, once a block
    if mode == "fused":
        return BLOCK_MACS + cb + heads * (y + z)
    return BLOCK_MACS + cb + heads * (y + q4 * n4 * p4)   # + C s_prev


@functools.lru_cache(maxsize=256)
def split_plan(B: int, S: int, H: int, P: int, N: int, q: int,
               sm_count: int) -> Plan:
    """Heads and P columns a block owns, from the shapes and the SM count
    alone: of every pair in ``HEAD_GROUPS`` x ``P_BLOCKS`` (a P block no
    wider than P, padded to 4) whose shared memory fits a block, the one
    that least loads the busiest SM, counted as the blocks an SM gets
    times the multiply-adds of a block (with ``BLOCK_MACS`` for its fixed
    cost), summed over the call's chunk kernels; ties go to the wider P
    block, then to fewer heads."""
    nc = S // q
    p4 = -(-P // 4) * 4
    best = None
    for pb in sorted({min(v, p4) for v in P_BLOCKS}, reverse=True):
        for hg in sorted({min(v, max(H, 1)) for v in HEAD_GROUPS}):
            fits = all(smem_bytes(q, pb, N, m) <= _SMEM_LIMIT
                       for m in _modes(nc))
            blocks = (1 if nc == 1 else nc) * B * -(-H // hg) * -(-P // pb)
            cost = sum(-(-blocks // sm_count) * _block_macs(q, pb, N, hg, m)
                       for m in _modes(nc))
            key = (not fits, cost)
            if best is None or key < best[0]:
                best = (key, Plan(hg, pb, nc))
    return best[1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _library() -> ctypes.CDLL:
    """The kernel's shared library (built at first use), with the C
    signatures declared."""
    lib = build.load("ssd_scan")
    fn = lib.mars_ssd_scan
    if fn.argtypes is None:               # first use: declare once
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        err = lib.mars_cuda_error_string
        err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
    return lib


def _launch(x, b, c, la, dt, q: int):
    """Check operands and launch the CUDA kernel on the current stream."""
    Bz, S, H, P = x.shape
    N = b.shape[-1]
    dev = x.device
    ops = (("x", x), ("b", b), ("c", c), ("la", la), ("dt", dt))
    for name, t in ops:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"ssd_scan kernel takes float32 or bfloat16, not "
                        f"{x.dtype}")
    for name, t, want in (("b", b, x.dtype), ("c", c, x.dtype),
                          ("la", la, torch.float32),
                          ("dt", dt, torch.float32)):
        if t.dtype != want:
            raise TypeError(f"ssd_scan kernel takes x, b and c of one dtype "
                            f"and la, dt in float32; x is {x.dtype}, "
                            f"{name} {t.dtype}")
    if q > MAX_CHUNK:
        raise ValueError(f"ssd_scan kernel takes chunks of at most "
                         f"{MAX_CHUNK} positions, got {q}")
    # the narrowest P block needs the least; split_plan picks one that fits
    need = max(smem_bytes(q, min(P_BLOCKS[-1], P), N, m)
               for m in _modes(S // q))
    if need > _SMEM_LIMIT:
        raise ValueError(f"ssd_scan kernel needs {need} B of shared memory "
                         f"for q={q}, N={N}; a block has {_SMEM_LIMIT}")
    y = torch.empty((Bz, S, H, P), dtype=torch.float32, device=dev)
    state = torch.empty((Bz, H, P, N), dtype=torch.float32, device=dev)
    if Bz == 0 or H == 0 or P == 0:
        return y, state
    lib = _library()
    plan = split_plan(Bz, S, H, P, N, q, _sm_count(dev.index or 0))
    zbuf = decay = None
    if plan.n_chunks > 1:
        zbuf = torch.empty((Bz, plan.n_chunks, H, P, N), dtype=torch.float32,
                           device=dev)
        decay = torch.empty((Bz, plan.n_chunks, H), dtype=torch.float32,
                            device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.mars_ssd_scan(
        _DTYPE_CODES[x.dtype], x.data_ptr(), b.data_ptr(), c.data_ptr(),
        la.data_ptr(), dt.data_ptr(), y.data_ptr(), state.data_ptr(),
        None if zbuf is None else zbuf.data_ptr(),
        None if decay is None else decay.data_ptr(),
        Bz, S, H, P, N, q, plan.heads, plan.p_block, stream)
    if rc != 0:
        why = lib.mars_cuda_error_string(rc).decode() if rc > 0 \
            else "unsupported"
        raise RuntimeError(f"ssd_scan kernel launch failed: rc={rc} ({why}; "
                           f"plan {plan})")
    if plan.n_chunks > 1:
        ssd_scan.pass_launches += 2
    ssd_scan.launches += 1
    return y, state


def _refuse_grad(*ts) -> None:
    """Raise when autograd would differentiate a launch: the kernels run
    outside the graph and have no backward kernel yet."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "ssd_scan (K3) has no backward kernel yet (ROADMAP.md §1, the "
            "next training slice): call it under torch.no_grad() on CUDA, "
            "or train on the CPU")


def ssd_scan(x, b, c, la, dt, *, chunk: int = 64):
    """x: (B,S,H,P); b,c: (B,S,N); la,dt: (B,S,H) (la is the per-step log
    decay ``dt * A``).  Returns ``(y (B,S,H,P) float32, final state
    (B,H,P,N) float32)``, starting from a zero state.  The chunk length
    is ``q = min(chunk, S)`` and must divide S.

    CUDA tensors launch the Hopper kernels (x, b and c of one dtype,
    float32 or bfloat16; la and dt float32; contiguous; q <= 64; no
    input that needs a gradient); CPU tensors run the plain twin."""
    Bz, S, H, P = x.shape
    N = b.shape[-1]
    if tuple(b.shape) != (Bz, S, N) or tuple(c.shape) != (Bz, S, N) \
            or tuple(la.shape) != (Bz, S, H) or tuple(dt.shape) != (Bz, S, H):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, b {tuple(b.shape)}, c "
            f"{tuple(c.shape)}, la {tuple(la.shape)}, dt {tuple(dt.shape)}")
    q = chunk_len(S, chunk)
    if x.device.type == "cuda":
        _refuse_grad(x, b, c, la, dt)
        return _launch(x, b, c, la, dt, q)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, b, c, la, dt, chunk=chunk)
    raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")


ssd_scan.launches = 0
ssd_scan.pass_launches = 0
