"""Blockwise (flash) attention (port of ``repro/kernels/flash_attention/
flash_attention.py``).

``flash_attention`` is the wrapper around the hand-written Hopper kernels
in ``csrc/flash_attention.cu`` (which replace the Pallas ``_kernel`` /
``flash_attention``; the source comment there gives their bound and
design).  ``split_plan`` picks one of three from the shapes and the SM
count alone: bfloat16 ``wgmma`` tiles of 128 queries fed by TMA for many
queries; bfloat16 16-row ``mma.sync`` tiles whose keys are split into
ranges over blocks (merged inside the same launch) for few queries; and
float32 on CUDA cores, with the same key split for few queries.  On CUDA
tensors it launches one kernel or raises — there is no fallback; on CPU
tensors it runs ``flash_attention_plain``, the kernel's plain PyTorch
twin, which the CPU tests and ``chip_smoke.py`` compare against.
``flash_attention_split_plain`` does the key split and merge in PyTorch.
``flash_attention.launches`` counts kernel launches.

The port's ``layers.sdpa`` routes here every attention whose mask is
none or plain causal with as many queries as keys.

Training: when q, k or v needs a gradient, ``flash_attention`` runs as a
``torch.autograd.Function`` whose forward is ``flash_attention_with_lse``
(K5 also writing each query row's log-sum-exp, which it saves) and whose
backward is ``flash_attention_bwd``: B5, the hand-written backward
kernels in ``csrc/flash_attention_bwd.cu`` (a pre-pass for rowsum(dO o),
then dK/dV and dQ, from the saved log-sum-exp; the JAX trainer
differentiates plain attention, so no Pallas kernel corresponds), on
CUDA tensors, and ``flash_attention_bwd_plain``, the explicit formulas in
PyTorch with B5's bf16 roundings, on CPU ones.  B5 takes every head dim
K5 takes (``HEAD_DIMS``).  ``flash_attention_bwd.launches`` counts B5's
kernel launches (``BWD_LAUNCHES`` a call).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 112, 128, 256)
_MAX_BATCH_HEADS = 65535          # the kernels' grid z (y for wgmma)
_MAX_QUERIES = 65535 * 16         # the few-query kernel's grid y
WGMMA_HEAD_DIMS = (64, 112, 128)  # padded to 64 or 128 columns
FEW_QUERIES = 64                  # bf16 up to this many queries: key split
BLOCKS_PER_SM = 3                 # key-split blocks the plan aims for, per SM
MAX_SPLIT = 32                    # key ranges a query tile takes at most
# query rows a block owns, keys a range is a multiple of, and the fewest
# keys a range takes, by path: a bf16 range of one 64-key stage costs its
# merge more than its split saves (two ring stages pay), while the f32
# tiles gain from any split
PATHS = {"f32": dict(code=0, rows=32, step=32, min_keys=32),
         "few": dict(code=1, rows=16, step=64, min_keys=128),
         "wgmma": dict(code=2, rows=128, step=128)}


class Plan(NamedTuple):
    """Which kernel runs and how the keys split: ``n_split`` ranges of
    ``keys_per_split`` keys (the last one shorter), ``rows`` query rows a
    block."""
    path: str
    n_split: int
    keys_per_split: int
    rows: int


@functools.lru_cache(maxsize=256)
def split_plan(B: int, Sq: int, Sk: int, H: int, D: int, dtype,
               sm_count: int) -> Plan:
    """The kernel and its key ranges, from shapes and the SM count alone
    (it reads no tensor).

    bfloat16 with more than ``FEW_QUERIES`` queries (and some keys) takes
    the wgmma tiles, which fill the card with query tiles; bfloat16
    otherwise, and head dims 16 and 256 at every length (outside
    ``WGMMA_HEAD_DIMS``), takes 16-row tiles; float32 its CUDA-core tiles
    of 32 rows.  Those two split the keys when B * H query tiles
    leave the card short of ``BLOCKS_PER_SM`` blocks an SM: into ranges
    of whole steps (64 keys a ring stage, 32 in float32), as many as
    bring the blocks to about that count, at most ``MAX_SPLIT``, none
    shorter than the path's ``min_keys``."""
    if dtype == torch.float32:
        path = "f32"
    elif Sq > FEW_QUERIES and D in WGMMA_HEAD_DIMS and Sk > 0:
        path = "wgmma"
    else:
        path = "few"
    rows, step = PATHS[path]["rows"], PATHS[path]["step"]
    keys = max(int(Sk), 1)
    if path == "wgmma":
        return Plan(path, 1, -(-keys // step) * step, rows)
    base = max(B * H * -(-Sq // rows), 1)
    want = min(max(-(-BLOCKS_PER_SM * sm_count // base), 1), MAX_SPLIT)
    kps = max(-(-keys // want), PATHS[path]["min_keys"])
    kps = -(-kps // step) * step
    return Plan(path, -(-keys // kps), kps, rows)


def split_ranges(Sk: int, keys_per_split: int) -> list:
    """The key ranges ``[start, stop)`` of a cut of ``[0, Sk)`` into
    ranges of ``keys_per_split`` keys, in order (the last may be
    shorter)."""
    return [(start, min(start + keys_per_split, Sk))
            for start in range(0, max(Sk, 1), keys_per_split)]


def _check(q, k, v, causal: bool) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; want "
                         f"(B, Sq, H, D) and (B, Sk, H, D)")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(
            f"causal flash_attention needs as many queries as keys, got "
            f"Sq={q.shape[1]}, Sk={k.shape[1]} (the reference kernel and "
            f"its oracle disagree on the query offset there)")


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          return_lse: bool = False):
    """The kernel's plain twin: one softmax over every key in float32
    (masked scores -1e30), the probabilities rounded to v's dtype before
    the product with v, the sum in float32 divided by ``max(l, 1e-30)``,
    the result in q's dtype.  Same contract as ``flash_attention``; with
    ``return_lse`` also the rows' log-sum-exp as ``flash_attention_with_
    lse`` gives it: ``(o, lse)``."""
    _check(q, k, v, causal)
    s, keep = _masked_scores(q, k, causal)
    lse = _row_lse(s, keep) if return_lse else None
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    # out of place, so autograd can differentiate the twin too
    s = torch.exp(s - s.amax(-1, keepdim=True))
    l = s.sum(-1, keepdim=True)                        # (B, H, Sq, 1)
    acc = torch.einsum("bhqk,bkhd->bqhd", s.to(v.dtype).float(), v.float())
    o = (acc / l.clamp_min(1e-30).transpose(1, 2)).to(q.dtype)
    return (o, lse) if return_lse else o


def _row_lse(s, keep):
    """(B, H, Sq) float32 log-sum-exp of each row of the scores ``s`` over
    the kept keys (``keep`` None: all); +inf for a row that keeps none,
    as the kernels store it, so exp(s - lse) is 0 there."""
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, -1)
    return lse.masked_fill_(lse == float("-inf"), float("inf"))


def _masked_scores(q, k, causal: bool):
    """f32 scores (B, H, Sq, Sk) and the mask of the kept (query, key)
    pairs (None: all kept)."""
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(q.shape[-1]))
    if not causal:
        return s, None
    keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril_()
    return s, keep


def flash_attention_split_plain(q, k, v, *, causal: bool = True,
                                keys_per_split: int):
    """The key split's arithmetic in PyTorch: the keys cut into ranges of
    ``keys_per_split`` (``split_ranges``, as ``split_plan`` cuts them),
    each range's f32 state (m its maximum, p = exp(s - m) rounded to v's
    dtype in its product with v, l the sum of the unrounded p), then the
    states merged with weights exp(m - max m) and the result divided by
    max(l, 1e-30) in q's dtype.  A range a query keeps no key of adds
    nothing."""
    _check(q, k, v, causal)
    Sk = k.shape[1]
    kps = max(int(keys_per_split), 1)
    s, keep = _masked_scores(q, k, causal)
    if keep is None:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device)
    parts = []
    for start, stop in split_ranges(Sk, kps):
        sr, kr = s[..., start:stop], keep[:, start:stop]
        sr = sr.masked_fill(~kr, NEG_INF)
        m = sr.amax(-1, keepdim=True)
        p = torch.where(kr, torch.exp(sr - m), torch.zeros_like(sr))
        acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                           v[:, start:stop].float())
        parts.append((acc, m, p.sum(-1, keepdim=True)))
    acc, m, l = (torch.stack(t) for t in zip(*parts))
    M = m.amax(0)
    w = torch.where(l > 0, torch.exp(m - M), torch.zeros_like(l))
    o = (acc * w).sum(0) / (l * w).sum(0).clamp_min(1e-30)
    return o.transpose(1, 2).to(q.dtype)


def _library() -> ctypes.CDLL:
    """The kernel's shared library (built at first use), with the C
    signature declared."""
    lib = build.load("flash_attention")
    fn = lib.mars_flash_attention
    if fn.argtypes is None:               # first use: declare once
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 6 + [ctypes.c_float]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4)
        err = lib.mars_cuda_error_string
        err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_counters: dict = {}


def _arrival_counters(dev, n: int) -> torch.Tensor:
    """The key split's arrival counters on ``dev``: at least ``n`` int32
    zeros, kept across calls (the merging block of each query tile sets
    its counter back to 0, so calls on one stream reuse them)."""
    buf = _counters.get(dev)
    if buf is None or buf.numel() < n:
        buf = _counters[dev] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                           device=dev)
    return buf


def _launch(q, k, v, causal: bool, want_lse: bool = False):
    """Check operands and launch the CUDA kernel of ``split_plan`` on the
    current stream; with ``want_lse`` the kernel also writes the rows'
    log-sum-exp, and ``(o, lse)`` is returned."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel built for head_dim in "
                         f"{HEAD_DIMS}; got {D}")
    if B * H > _MAX_BATCH_HEADS:
        raise ValueError(f"flash_attention kernel takes B * H <= "
                         f"{_MAX_BATCH_HEADS}; got {B * H}")
    if Sq > _MAX_QUERIES:
        raise ValueError(f"flash_attention kernel takes at most "
                         f"{_MAX_QUERIES} queries; got {Sq}")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev) \
        if want_lse else None
    if q.numel() == 0:
        return (o, lse) if want_lse else o
    lib = _library()
    plan = split_plan(B, Sq, Sk, H, D, q.dtype, _sm_count(dev.index or 0))
    part = counters = None
    if plan.n_split > 1:
        tiles = B * H * -(-Sq // plan.rows)
        part = torch.empty(tiles * plan.n_split * plan.rows * (D + 2),
                           dtype=torch.float32, device=dev)
        counters = _arrival_counters(dev, tiles)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.mars_flash_attention(
        _DTYPE_CODES[q.dtype], PATHS[plan.path]["code"], q.data_ptr(),
        k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, Sq, Sk, D,
        int(causal), 1.0 / math.sqrt(D), plan.n_split, plan.keys_per_split,
        None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(),
        None if lse is None else lse.data_ptr(), stream)
    if rc != 0:
        why = "unsupported" if rc == -1 \
            else lib.mars_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: rc={rc} "
                           f"({why}; plan {plan})")
    flash_attention.launches += 1
    return (o, lse) if want_lse else o


def _forward(q, k, v, causal: bool, want_lse: bool = False):
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, want_lse)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     return_lse=want_lse)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


def flash_attention_with_lse(q, k, v, *, causal: bool = True):
    """``(o, lse)``: ``flash_attention``'s output (one K5 launch on CUDA
    tensors, the twin on CPU ones; no autograd) and each query row's
    log-sum-exp of its scaled, masked scores, float32 (B, H, Sq), which
    B5 takes in place of recomputing it (+inf for a row with no kept
    key)."""
    _check(q, k, v, causal)
    return _forward(q, k, v, causal, want_lse=True)


class _FlashAttention(torch.autograd.Function):
    """K5 forward saving the rows' log-sum-exp, B5 backward (their plain
    twins on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = _forward(q, k, v, causal, want_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(),
                                         causal=ctx.causal, lse=lse)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, Sq, H, D); k, v: (B, Sk, H, D) -> (B, Sq, H, D) in q's dtype:
    ``softmax(q k^T / sqrt(D)) v`` per batch and head, with no mask or,
    when ``causal``, key <= query (which needs Sq == Sk).  Any sequence
    lengths; no GQA (repeat K/V heads first).

    CUDA tensors launch one Hopper kernel (float32 or bfloat16, one dtype,
    contiguous, head dim in ``HEAD_DIMS``: 16, 64, 112, 128, 256;
    ``split_plan`` says which);
    CPU tensors run the plain twin.  Differentiable: with a gradient to
    take, the backward is ``flash_attention_bwd``, at every head dim of
    ``HEAD_DIMS``."""
    _check(q, k, v, causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal)


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# Backward (B5)
# ---------------------------------------------------------------------------

BWD_LAUNCHES = 3          # pre-pass, dK/dV, dQ: the kernels of one call


def flash_attention_bwd_plain(q, k, v, o, do, *, causal: bool = True,
                              lse=None):
    """B5's plain twin, the explicit formulas in float32: s = q k^T /
    sqrt(D) (masked), p = exp(s - lse) with ``lse`` the forward's saved
    row log-sum-exp (recomputed as logsumexp(s) when None), delta =
    rowsum(do o), dv = p^T do, ds = p (do v^T - delta), dq = ds k /
    sqrt(D), dk = ds^T q / sqrt(D); each gradient in its input's dtype.
    For bfloat16 inputs p and ds are rounded to bfloat16 where B5 rounds
    them, as the operands of its tensor-core products: p before p^T do,
    ds (from the unrounded p) before ds k and ds^T q; for float32 inputs
    nothing is rounded."""
    _check(q, k, v, causal)
    s, keep = _masked_scores(q, k, causal)
    if keep is not None:
        s.masked_fill_(~keep, float("-inf"))
    lse = _row_lse(s, None) if lse is None else lse.float()
    p = s.sub_(lse[..., None]).exp_()
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    delta = (dof * o.float()).sum(-1).transpose(1, 2)[..., None]
    ds = p.mul_(dp.sub_(delta)).to(q.dtype).float()
    scale = 1.0 / math.sqrt(q.shape[-1])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_library() -> ctypes.CDLL:
    lib = build.load("flash_attention_bwd")
    fn = lib.mars_flash_attention_bwd
    if fn.argtypes is None:               # first use: declare once
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 6 + [ctypes.c_float]
                       + [ctypes.c_void_p])
        err = lib.mars_cuda_error_string
        err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
    return lib


def _bwd_launch(q, k, v, o, do, causal: bool, lse=None):
    """Check operands and launch B5's three kernels on the current
    stream."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention_bwd takes one dtype; {name} "
                            f"is {t.dtype}, q {q.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} "
                         f"must be shaped as q {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention_bwd kernel takes float32 or "
                        f"bfloat16; got {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd kernel built for head_dim "
                         f"in {HEAD_DIMS}; got {D}")
    if B * H > _MAX_BATCH_HEADS:
        raise ValueError(f"flash_attention_bwd kernel takes B * H <= "
                         f"{_MAX_BATCH_HEADS}; got {B * H}")
    if lse is None:
        raise ValueError("flash_attention_bwd on CUDA takes the forward's "
                         "row log-sum-exp (flash_attention_with_lse)")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or lse.device != dev or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 (B, H, Sq) = "
                         f"{(B, H, Sq)} tensor on {dev}; got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty(B * H * Sq, dtype=torch.float32, device=dev)
    lib = _bwd_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.mars_flash_attention_bwd(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), lse.data_ptr(), delta.data_ptr(), B, H, Sq, Sk, D,
        int(causal), 1.0 / math.sqrt(D), stream)
    if rc != 0:
        why = "unsupported" if rc == -1 \
            else lib.mars_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"rc={rc} ({why})")
    flash_attention_bwd.launches += BWD_LAUNCHES
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, do, *, causal: bool = True, lse=None):
    """(dq, dk, dv) of ``flash_attention(q, k, v, causal=causal) == o``
    for the incoming gradient ``do`` (shaped as q), each in its input's
    dtype, given ``lse``, the rows' log-sum-exp that
    ``flash_attention_with_lse`` returned with o.  CUDA tensors launch B5
    (float32 or bfloat16, one dtype, contiguous, head dim in
    ``HEAD_DIMS``; ``lse`` required); CPU tensors run the plain twin
    (which recomputes a missing ``lse``)."""
    _check(q, k, v, causal)
    if q.device.type == "cuda":
        return _bwd_launch(q, k, v, o, do, causal, lse)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                         lse=lse)
    raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not "
                     f"{q.device}")


flash_attention_bwd.launches = 0
