"""SSD (Mamba2) chunked scan and its backward (port of ``repro/kernels/
ssd_scan/ssd_scan.py``).

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
one chunk.

Training: with a gradient to take, ``ssd_scan`` is an autograd Function
whose forward is K3 keeping the state that enters each chunk (the
multi-chunk path computes it anyway) and whose backward is B3,
``ssd_scan_bwd`` (``csrc/ssd_scan_bwd.cu``; there is no Pallas backward:
the JAX trainer differentiates ``repro.models.ssm.ssd_chunked``).  Its
plain twin ``ssd_scan_bwd_plain`` runs the same passes in float32 torch;
the CPU runs it, CUDA tensors launch B3 or raise.
``ssd_scan_bwd.launches`` counts B3's kernel launches (``bwd_launches``
a call).
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


def _wide(t):
    """float32, or float64 for float64 (the twins' arithmetic; float64
    only for ``torch.autograd.gradcheck``)."""
    return t.double() if t.dtype == torch.float64 else t.float()


def ssd_scan_plain(x, b, c, la, dt, *, chunk: int = 64, keep: bool = False):
    """The kernel's plain twin: chunked SSD in float32 torch, chunk by
    chunk with the state carried between chunks.  Same contract as
    ``ssd_scan``; with ``keep`` it also returns the state entering each
    chunk, (B, n_chunks, H, P, N) float32, or None for one chunk."""
    Bz, S, H, P = x.shape
    N = b.shape[-1]
    q = chunk_len(S, chunk)
    x, b, c, la, dt = (_wide(t) for t in (x, b, c, la, dt))
    s = torch.zeros((Bz, H, P, N), dtype=x.dtype, device=x.device)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    ys, entering = [], []
    for ic in range(S // q):
        entering.append(s)
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
    if not keep:
        return torch.cat(ys, dim=1), s
    return torch.cat(ys, dim=1), s, \
        torch.stack(entering, 1) if len(entering) > 1 else None


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


def _check_operands(ops, dev) -> None:
    for name, t in ops:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_dtypes(x, b, c, la, dt) -> None:
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


def _launch(x, b, c, la, dt, q: int, keep: bool = False):
    """Check operands and launch the CUDA kernel on the current stream.
    With ``keep`` also returns the multi-chunk path's scratch, the state
    entering each chunk and each chunk's decay (None, None for one
    chunk), which B3 takes."""
    Bz, S, H, P = x.shape
    N = b.shape[-1]
    dev = x.device
    _check_operands((("x", x), ("b", b), ("c", c), ("la", la), ("dt", dt)),
                    dev)
    _check_dtypes(x, b, c, la, dt)
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
    zbuf = decay = None
    if S // q > 1:
        zbuf = torch.empty((Bz, S // q, H, P, N), dtype=torch.float32,
                           device=dev)
        decay = torch.empty((Bz, S // q, H), dtype=torch.float32,
                            device=dev)
    if Bz == 0 or H == 0 or P == 0:
        return (y, state, zbuf, decay) if keep else (y, state)
    lib = _library()
    plan = split_plan(Bz, S, H, P, N, q, _sm_count(dev.index or 0))
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
    return (y, state, zbuf, decay) if keep else (y, state)


def _check_shapes(x, b, c, la, dt) -> None:
    Bz, S, H, P = x.shape
    N = b.shape[-1]
    if tuple(b.shape) != (Bz, S, N) or tuple(c.shape) != (Bz, S, N) \
            or tuple(la.shape) != (Bz, S, H) or tuple(dt.shape) != (Bz, S, H):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, b {tuple(b.shape)}, c "
            f"{tuple(c.shape)}, la {tuple(la.shape)}, dt {tuple(dt.shape)}")


def ssd_scan_with_states(x, b, c, la, dt, *, chunk: int = 64):
    """``(y, state, saved)``: ``ssd_scan``'s outputs (K3 on CUDA tensors,
    the twin on CPU ones; no autograd) and what B3 takes from the
    forward, ``saved = (entering, decay)``: the state entering each chunk
    (B, n_chunks, H, P, N) float32 and, on CUDA, each chunk's decay
    exp(cum_end) (B, n_chunks, H); both None for one chunk, and decay
    None on the CPU, whose twin recomputes it."""
    _check_shapes(x, b, c, la, dt)
    q = chunk_len(x.shape[1], chunk)
    if x.device.type == "cuda":
        y, state, entering, decay = _launch(x, b, c, la, dt, q, keep=True)
        return y, state, (entering, decay)
    if x.device.type == "cpu":
        y, state, entering = ssd_scan_plain(x, b, c, la, dt, chunk=chunk,
                                            keep=True)
        return y, state, (entering, None)
    raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")


class _SSDScan(torch.autograd.Function):
    """K3 forward keeping the state entering each chunk, B3 backward
    (their plain twins on the CPU).  The final state's gradient is None
    when the caller drops the state, as the trainer does."""

    @staticmethod
    def forward(ctx, x, b, c, la, dt, chunk):
        y, state, (entering, decay) = ssd_scan_with_states(
            x, b, c, la, dt, chunk=chunk)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, b, c, la, dt, entering, decay)
        ctx.chunk, ctx.y_dtype = chunk, y.dtype
        return y, state

    @staticmethod
    def backward(ctx, dy, d_state):
        x, b, c, la, dt, entering, decay = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=ctx.y_dtype, device=x.device)
        grads = ssd_scan_bwd(
            x, b, c, la, dt, dy.contiguous(),
            None if d_state is None else d_state.contiguous(),
            chunk=ctx.chunk, saved=(entering, decay))
        return (*grads, None)


def ssd_scan(x, b, c, la, dt, *, chunk: int = 64):
    """x: (B,S,H,P); b,c: (B,S,N); la,dt: (B,S,H) (la is the per-step log
    decay ``dt * A``).  Returns ``(y (B,S,H,P) float32, final state
    (B,H,P,N) float32)``, starting from a zero state.  The chunk length
    is ``q = min(chunk, S)`` and must divide S.

    CUDA tensors launch the Hopper kernels (x, b and c of one dtype,
    float32 or bfloat16; la and dt float32; contiguous; q <= 64); CPU
    tensors run the plain twin.  Differentiable: with a gradient to
    take, the backward is ``ssd_scan_bwd`` (B3 on CUDA)."""
    _check_shapes(x, b, c, la, dt)
    q = chunk_len(x.shape[1], chunk)
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, b, c, la, dt)):
        return _SSDScan.apply(x, b, c, la, dt, chunk)
    if x.device.type == "cuda":
        return _launch(x, b, c, la, dt, q)
    return ssd_scan_plain(x, b, c, la, dt, chunk=chunk)


ssd_scan.launches = 0
ssd_scan.pass_launches = 0


# ---------------------------------------------------------------------------
# Backward (B3)
# ---------------------------------------------------------------------------

BWD_WARPS = 16            # warps a block of the grad kernel
BWD_MAX_P, BWD_MAX_N = 64, 128    # the widest head (P) and state (N) B3 takes
# a head's fixed cost in the grad kernel (its staging, scan, barriers and
# per-position pass) in multiply-adds
BWD_HEAD_MACS = 100_000


def bwd_launches(n_chunks: int) -> int:
    """B3's kernel launches a call: the grad kernel and the sum over head
    groups; with more than one chunk also the state kernel, which carries
    the state's gradient back over the chunks."""
    return 3 if n_chunks > 1 else 2


def _pad16(*vs):
    return tuple(-(-v // 16) * 16 for v in vs)


def _ld(cols: int, es: int, rows: bool) -> int:
    """A shared-memory row stride (``ld_of`` in the ``.cu``): the least
    >= cols that is 4 (rows) or 8 modulo 32 words for float32, 8 modulo
    64 elements for bfloat16."""
    m, r = (64, 8) if es == 2 else (32, 4 if rows else 8)
    ld = cols - cols % m + r
    return ld + m if ld < cols else ld


def _a16(v: int) -> int:
    return -(-v // 16) * 16


def bwd_smem_bytes(q: int, P: int, N: int, kernel: str = "grad",
                   dtype=torch.bfloat16) -> int:
    """Shared memory one block of B3's ``kernel`` ("grad" or "state")
    takes with x, b, c in ``dtype`` (mirrors ``grad_layout`` and
    ``state_layout`` in ``csrc/ssd_scan_bwd.cu``: dims padded to 16, rows
    padded so fragment loads fall in distinct banks)."""
    es = 2 if dtype == torch.bfloat16 else 4
    qp, pp, np_ = _pad16(q, P, N)
    if kernel == "state":
        mt = bwd_state_tiles_max(P)
        stage = _a16(qp * _ld(np_, es, False) * es) \
            + _a16(qp * (16 * mt + 8) * 4) + _a16(qp * 4)
        return _a16((3 if es == 2 else 2) * stage + qp * 4)
    parts = [qp * _ld(np_, es, True) * es] * 2 + [
        qp * _ld(pp, es, True) * es, qp * _ld(pp, 4, True) * 4,
        qp * _ld(qp, 4, False) * 4, pp * _ld(np_, 4, True) * 4,
        pp * _ld(np_, 4, False) * 4, 2 * (4 * qp + 4) * 4,
        (8 * qp + 3 * 16 * BWD_WARPS + BWD_WARPS) * 4, 2 * qp * 4]
    return sum(_a16(v) for v in parts)


def bwd_state_tiles_max(P: int) -> int:
    """The most m-tiles (16 rows of P) a block of the state kernel may
    own: 4, 2 or 1, no more than P's."""
    return max(m for m in (1, 2, 4) if m <= -(-P // 16))


@functools.lru_cache(maxsize=256)
def bwd_state_tiles(B: int, H: int, P: int, sm_count: int) -> int:
    """m-tiles (16 rows of P) a block of B3's state kernel owns: the most
    (up to ``bwd_state_tiles_max``) that still leave two blocks an SM.
    A block re-reads the chunk's c for its rows, so fewer, taller blocks
    read c fewer times; a long scan of few heads keeps 16 rows a block to
    fill the card."""
    for mt in (4, 2):
        if mt <= bwd_state_tiles_max(P) \
                and -(-P // (16 * mt)) * H * B >= 2 * sm_count:
            return mt
    return 1


def _bwd_block_macs(q: int, P: int, N: int, heads: int, n_chunks: int):
    """Tensor-core multiply-adds of one grad block (dims padded to 16),
    plus ``BLOCK_MACS`` and ``BWD_HEAD_MACS`` a head for fixed costs."""
    q16, p16, n16 = _pad16(q, P, N)
    fixed = BLOCK_MACS + 3 * q16 * q16 * n16  # C B^T; dCB^T C and dCB B
    head = BWD_HEAD_MACS + 2 * q16 * q16 * p16 + 2 * q16 * p16 * n16
    if n_chunks > 1:
        head += q16 * p16 * n16               # dy^T s_prev
    return fixed + heads * head


@functools.lru_cache(maxsize=256)
def bwd_plan(B: int, S: int, H: int, P: int, N: int, q: int,
             sm_count: int) -> int:
    """Heads a block of B3's grad kernel owns, from the shapes and the SM
    count alone: of the head counts ceil(H / groups) for every group
    count, the one that least loads the busiest SM (a block an SM: its
    shared memory and 512 threads) by the blocks an SM gets times a
    block's multiply-adds, where C B^T and the products of the heads'
    summed dCB are once a block; ties go to fewer heads."""
    nc = S // q
    best = None
    for hg in sorted({-(-H // g) for g in range(1, max(H, 1) + 1)}):
        blocks = nc * B * -(-H // hg)
        cost = -(-blocks // sm_count) * _bwd_block_macs(q, P, N, hg, nc)
        if best is None or cost < best[0]:
            best = (cost, hg)
    return best[1]


def ssd_scan_bwd_plain(x, b, c, la, dt, dy, d_state=None, *,
                       chunk: int = 64, entering=None):
    """B3's plain twin: the gradient of ``ssd_scan`` (y and the final
    state) in float32 torch, by the kernels' passes.  Within a chunk,
    cum = cumsum(la), e_t = exp(cum_t), f_k = exp(cum_end - cum_k), W_tk
    = (c_t . b_k) exp(min(cum_t - cum_k, 0)) dt_k for k <= t, and s_{c-1}
    the state entering chunk c (``entering``, recomputed when None):
    (1) U_c = sum_t e_t dy_t (x) c_t; (2) from the last chunk back, G_c,
    the gradient of the state leaving chunk c (``d_state`` for the last,
    zero when None), and G_{c-1} = exp(cum_end,c) G_c + U_c, with
    d(decay_c) = sum G_c * s_{c-1}; (3) every chunk's dx_k = sum_{t>=k}
    W_tk dy_t + f_k dt_k G_c b_k, ddt, dc and db (summed over heads),
    and the gradient of cum, turned into dla by a reverse cumsum within
    the chunk.  Returns (dx, db, dc, dla, ddt): dx in x's dtype, db and
    dc in b's, dla and ddt float32 — what ``jax.vjp`` of the reference's
    ``ssd_chunked`` gives."""
    Bz, S, H, P = x.shape
    N = b.shape[-1]
    q = chunk_len(S, chunk)
    nc = S // q
    if entering is None and nc > 1:
        entering = ssd_scan_plain(x, b, c, la, dt, chunk=chunk, keep=True)[2]
    xc = _wide(x).reshape(Bz, nc, q, H, P)
    dyc = _wide(dy).reshape(Bz, nc, q, H, P)
    bc, cc = _wide(b).reshape(Bz, nc, q, N), _wide(c).reshape(Bz, nc, q, N)
    dtc = _wide(dt).reshape(Bz, nc, q, H)
    cum = torch.cumsum(_wide(la).reshape(Bz, nc, q, H), dim=2)
    e = torch.exp(cum)                                      # (B, nc, q, H)
    f = torch.exp(cum[:, :, -1:] - cum)
    decay = torch.exp(cum[:, :, -1])                        # (B, nc, H)
    # pass 1: U_c, the gradient of the state entering chunk c through
    # the chunk's outputs
    U = torch.einsum("bcth,bcthp,bctn->bchpn", e, dyc, cc)
    # pass 2: G_c from the last chunk back, and d(decay_c)
    G = torch.zeros((Bz, H, P, N), dtype=xc.dtype, device=x.device) \
        if d_state is None else _wide(d_state)
    gs, d_decay = [None] * nc, torch.zeros_like(decay)
    for ic in reversed(range(nc)):
        gs[ic] = G
        if ic > 0:
            d_decay[:, ic] = (G * _wide(entering[:, ic])).sum((-2, -1))
            G = decay[:, ic, :, None, None] * G + U[:, ic]
    gs = torch.stack(gs, 1)                                 # (B, nc, H, P, N)
    # pass 3: every chunk's gradients
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B, nc, t, k, H)
    D = torch.where(tri[:, :, None], torch.exp(torch.clamp_max(li, 0.0)),
                    torch.zeros((), device=x.device))
    # d min(li, 0) / d li below the diagonal: 1 under 0, 1/2 at a tie (as
    # JAX splits one), 0 above (the diagonal's li is 0 and cancels)
    below = torch.tril(tri, -1)[:, :, None]
    m = torch.where(below, (li < 0).to(li.dtype)
                    + 0.5 * (li == 0).to(li.dtype),
                    torch.zeros((), dtype=li.dtype, device=x.device))
    cb = torch.einsum("bctn,bckn->bctk", cc, bc)[..., None]
    dtk = dtc[:, :, None]                                   # (B, nc, 1, k, H)
    dW = torch.einsum("bcthp,bckhp->bctkh", dyc, xc)
    gb = torch.einsum("bckn,bchpn->bckhp", bc, gs)
    fdt = f * dtc
    dx = torch.einsum("bctkh,bcthp->bckhp", cb * D * dtk, dyc) \
        + fdt[..., None] * gb
    r = (xc * gb).sum(-1)                                   # (B, nc, k, H)
    Q = dW * D * cb
    ddt = Q.sum(2) + f * r
    gl = Q * dtk * m
    dcum = gl.sum(3) - gl.sum(2) - fdt * r
    dcum[:, :, -1] += (fdt * r).sum(2) + decay * d_decay
    dcb = (dW * D * dtk).sum(-1)                            # (B, nc, t, k)
    db = torch.einsum("bctk,bctn->bckn", dcb, cc) \
        + torch.einsum("bckh,bckhp,bchpn->bckn", fdt, xc, gs)
    dc = torch.einsum("bctk,bckn->bctn", dcb, bc)
    if entering is not None:
        sdy = torch.einsum("bcthp,bchpn->bcthn", dyc, _wide(entering))
        dc = dc + torch.einsum("bcth,bcthn->bctn", e, sdy)
        dcum = dcum + e * torch.einsum("bctn,bcthn->bcth", cc, sdy)
    dla = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    return (dx.reshape(Bz, S, H, P).to(x.dtype),
            db.reshape(Bz, S, N).to(b.dtype),
            dc.reshape(Bz, S, N).to(c.dtype),
            dla.reshape(Bz, S, H), ddt.reshape(Bz, S, H))


def _bwd_library() -> ctypes.CDLL:
    lib = build.load("ssd_scan_bwd")
    fn = lib.mars_ssd_scan_bwd
    if fn.argtypes is None:               # first use: declare once
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 17
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        err = lib.mars_cuda_error_string
        err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
    return lib


def _bwd_launch(x, b, c, la, dt, dy, d_state, q: int, saved):
    """Check operands and launch B3's kernels on the current stream."""
    Bz, S, H, P = x.shape
    N = b.shape[-1]
    nc = S // q
    dev = x.device
    entering, decay = saved if saved is not None and nc > 1 \
        else (None, None)
    ops = [("x", x), ("b", b), ("c", c), ("la", la), ("dt", dt), ("dy", dy)]
    if d_state is not None:
        ops.append(("d_state", d_state))
    if nc > 1:
        if entering is None or decay is None:
            raise ValueError("ssd_scan_bwd on CUDA takes the entering states "
                             "and decays K3 kept (ssd_scan_with_states) for "
                             "more than one chunk")
        ops += [("entering", entering), ("decay", decay)]
    _check_operands(ops, dev)
    _check_dtypes(x, b, c, la, dt)
    for name, t, shape in (("dy", dy, (Bz, S, H, P)),
                           ("d_state", d_state, (Bz, H, P, N)),
                           ("entering", entering, (Bz, nc, H, P, N)),
                           ("decay", decay, (Bz, nc, H))):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != shape):
            raise ValueError(f"ssd_scan_bwd takes {name} float32 {shape}; "
                             f"got {t.dtype} {tuple(t.shape)}")
    if q > MAX_CHUNK:
        raise ValueError(f"ssd_scan_bwd kernel takes chunks of at most "
                         f"{MAX_CHUNK} positions, got {q}")
    need = max(bwd_smem_bytes(q, P, N, k, x.dtype) for k in ("grad", "state"))
    if need > _SMEM_LIMIT:
        raise ValueError(f"ssd_scan_bwd kernel needs {need} B of shared "
                         f"memory for q={q}, P={P}, N={N}; a block has "
                         f"{_SMEM_LIMIT}")
    if P > BWD_MAX_P or N > BWD_MAX_N:
        raise ValueError(f"ssd_scan_bwd kernel's tiles take P <= {BWD_MAX_P} "
                         f"and N <= {BWD_MAX_N}; got P={P}, N={N}")
    dx = torch.empty_like(x)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    dla = torch.empty((Bz, S, H), dtype=torch.float32, device=dev)
    ddt = torch.empty_like(dla)
    if x.numel() == 0 or b.numel() == 0:
        for t in (dx, db, dc, dla, ddt):
            t.zero_()
        return dx, db, dc, dla, ddt
    lib = _bwd_library()
    sm = _sm_count(dev.index or 0)
    hg = bwd_plan(Bz, S, H, P, N, q, sm)
    mt = bwd_state_tiles(Bz, H, P, sm)
    groups = -(-H // hg)
    pdb = torch.empty((groups, Bz, S, N), dtype=torch.float32, device=dev)
    pdc = torch.empty_like(pdb)
    gbuf = None
    if nc > 1:
        gbuf = torch.empty((Bz, nc, H, P, N), dtype=torch.float32,
                           device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.mars_ssd_scan_bwd(
        _DTYPE_CODES[x.dtype], *(ptr(t) for t in (
            x, b, c, la, dt, dy, d_state, entering, decay, gbuf,
            dx, db, dc, dla, ddt, pdb, pdc)),
        Bz, S, H, P, N, q, hg, mt, stream)
    if rc != 0:
        why = lib.mars_cuda_error_string(rc).decode() if rc > 0 \
            else "unsupported"
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed: rc={rc} "
                           f"({why}; {hg} heads a block)")
    ssd_scan_bwd.launches += bwd_launches(nc)
    return dx, db, dc, dla, ddt


def ssd_scan_bwd(x, b, c, la, dt, dy, d_state=None, *, chunk: int = 64,
                 saved=None):
    """The gradient of ``ssd_scan``: ``(dx, db, dc, dla, ddt)`` from the
    forward's inputs, dy (B, S, H, P) float32 and the final state's
    gradient d_state (B, H, P, N) float32 (None: zero).  ``saved`` is
    ``ssd_scan_with_states``'s ``(entering, decay)``.

    CUDA tensors launch B3 (``bwd_launches`` kernels; the entering states
    and decays are required for more than one chunk; two calls on the
    same inputs agree bitwise: no atomics); CPU tensors run
    ``ssd_scan_bwd_plain``."""
    _check_shapes(x, b, c, la, dt)
    q = chunk_len(x.shape[1], chunk)
    if x.device.type == "cuda":
        return _bwd_launch(x, b, c, la, dt, dy, d_state, q, saved)
    if x.device.type == "cpu":
        return ssd_scan_bwd_plain(x, b, c, la, dt, dy, d_state, chunk=chunk,
                                  entering=None if saved is None
                                  else saved[0])
    raise ValueError(f"ssd_scan_bwd runs on cuda or cpu, not {x.device}")


ssd_scan_bwd.launches = 0
