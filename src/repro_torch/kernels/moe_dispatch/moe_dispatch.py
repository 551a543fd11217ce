"""MARS-sorted grouped matmul (port of ``repro/kernels/moe_dispatch/
moe_dispatch.py``).

``grouped_matmul`` is the wrapper around the hand-written Hopper kernels
``csrc/moe_dispatch.cu`` (which replace the Pallas ``_kernel`` /
``grouped_matmul``; the source comment there gives their bound and
design).  ``split_plan`` picks one from the shapes and the SM count
alone: bfloat16 operands that TMA can map take work units of (row tile,
512-column span, K slab) fed by a TMA ring, the slabs' f32 partials
summed by the last unit of each output tile inside the same launch; any
other operands take a CUDA-core tiling.  One launch a call either way.
On CUDA tensors it launches the kernel or raises — there is no fallback;
on CPU tensors it runs ``grouped_matmul_plain``, the kernel's plain
twin: one float32 product per row tile, cast to x's dtype.
``grouped_matmul_split_plain`` does the K split's arithmetic in PyTorch.
``grouped_matmul.launches`` counts kernel launches.  The kernels have no
backward yet: on CUDA tensors a call that autograd would differentiate
raises (``_refuse_grad``) instead of running outside the graph.

The ``tile_group`` contract is the reference's: token rows sorted by
expert, each expert's segment padded to a multiple of ``bm`` rows
(``ops.pad_sorted_groups``), so row tile ``i`` belongs to expert
``tile_group[i]``.  ``n_tiles``, a device int32 scalar, is the number of
row tiles in use: later tiles come out zero and the kernel reads no
weights for them, so a caller can size its buffers by a bound without
reading the count back to the host.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

DEFAULT_BM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1
PATH_CODES = {"cores": 0, "tma": 1}
SPAN = 512                 # columns a 16-row TMA unit owns (1 KB of bf16)
STAGE_K = 32               # K rows a TMA ring stage holds
TMA_BLOCKS_PER_SM = 1      # TMA units an SM holds at once (133 KB each)
SPLIT_WAVES = 2            # waves of units the K split aims for
MIN_K_PER_SPLIT = 256      # the fewest K rows a slab takes


class Plan(NamedTuple):
    """Which kernel runs and how it cuts the work: units of ``rows`` rows
    by ``span`` columns (``n_span`` spans cover N) by ``n_split`` K slabs
    of ``k_per_split`` rows (the last one shorter)."""
    path: str
    rows: int
    span: int
    n_span: int
    n_split: int
    k_per_split: int


@functools.lru_cache(maxsize=256)
def split_plan(M: int, K: int, N: int, bm: int, dtype, sm_count: int,
               tma: bool = True) -> Plan:
    """The kernel and its work units, from shapes and the SM count alone
    (never ``n_tiles``, which only the device knows).

    bfloat16 operands that TMA can map (``tma``: K and N multiples of 8,
    16-byte aligned) take the TMA kernel: units of the largest of 64, 32
    or 16 rows that divides ``bm``, by ``SPAN * 16 / rows`` columns, by
    K slabs of whole ``STAGE_K``-row stages, as many as bring the units
    to ``SPLIT_WAVES`` waves of ``TMA_BLOCKS_PER_SM`` blocks an SM
    (counting every tile, live or not), none shorter than
    ``MIN_K_PER_SPLIT`` rows.  Anything else takes the CUDA-core tiling:
    blocks of up to 128 rows by 64 columns, K unsplit."""
    if dtype != torch.bfloat16 or not tma:
        return Plan("cores", min(bm, 128), 64, -(-N // 64), 1, K)
    rows = next(r for r in (64, 32, 16) if bm % r == 0)
    span = SPAN * 16 // rows
    n_span = -(-N // span)
    base = max(M // bm * (bm // rows) * n_span, 1)
    want = -(-SPLIT_WAVES * TMA_BLOCKS_PER_SM * sm_count // base)
    n_split = max(1, min(want, K // MIN_K_PER_SPLIT))
    kps = -(-K // n_split)
    kps = -(-kps // STAGE_K) * STAGE_K
    return Plan("tma", rows, span, n_span, -(-K // kps), kps)


def work_units(plan: Plan, M: int, K: int, N: int, bm: int) -> list:
    """The TMA kernel's work units in launch order, as ``(tile, row0,
    rows, col0, cols, k0, k1)``: unit ``((tile * chunks + chunk) *
    n_split + split) * n_span + span`` of the grid."""
    chunks = bm // plan.rows
    units = []
    for tile in range(M // bm):
        for chunk in range(chunks):
            row0 = tile * bm + chunk * plan.rows
            for split in range(plan.n_split):
                k0 = split * plan.k_per_split
                k1 = min(K, k0 + plan.k_per_split)
                for span in range(plan.n_span):
                    col0 = span * plan.span
                    units.append((tile, row0, plan.rows, col0,
                                  min(plan.span, N - col0), k0, k1))
    return units


def _check_shapes(x, w, tile_group, bm: int):
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"grouped_matmul takes x (M, K) and w (G, K, N); "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    M, K = x.shape
    if w.shape[1] != K:
        raise ValueError(f"x has K={K} columns, w has K={w.shape[1]} rows")
    if bm <= 0 or bm % 16 or M % bm:
        raise ValueError(f"bm must be a positive multiple of 16 that "
                         f"divides M={M}; got bm={bm}")
    if tuple(tile_group.shape) != (M // bm,):
        raise ValueError(f"tile_group must have M // bm = {M // bm} "
                         f"entries, got {tuple(tile_group.shape)}")


def grouped_matmul_plain(x, w, tile_group, *, bm: int = DEFAULT_BM,
                         n_tiles=None):
    """The kernel's plain twin: for each row tile in use, ``x_tile.float()
    @ w[g].float()`` cast to x's dtype; tiles at or past ``n_tiles``, or
    whose group lies outside [0, G), are zero.  Same contract as
    ``grouped_matmul``."""
    _check_shapes(x, w, tile_group, bm)
    M = x.shape[0]
    G, _, N = w.shape
    out = torch.zeros((M, N), dtype=x.dtype, device=x.device)
    used = M // bm if n_tiles is None else min(int(n_tiles), M // bm)
    for i, g in enumerate(tile_group[:used].tolist()):
        if 0 <= g < G:
            rows = slice(i * bm, (i + 1) * bm)
            out[rows] = (x[rows].float() @ w[g].float()).to(x.dtype)
    return out


def grouped_matmul_split_plain(x, w, tile_group, *, bm: int = DEFAULT_BM,
                               n_tiles=None, k_per_split: int):
    """The TMA kernel's arithmetic in PyTorch: for each row tile in use,
    one float32 partial ``x_tile[:, k0:k1].float() @ w[g, k0:k1].float()``
    per K slab of ``k_per_split`` rows, summed in slab order from zero
    (as the last unit of a tile sums them), cast to x's dtype; tiles at
    or past ``n_tiles``, or whose group lies outside [0, G), are zero."""
    _check_shapes(x, w, tile_group, bm)
    M, K = x.shape
    G, _, N = w.shape
    out = torch.zeros((M, N), dtype=x.dtype, device=x.device)
    used = M // bm if n_tiles is None else min(int(n_tiles), M // bm)
    for i, g in enumerate(tile_group[:used].tolist()):
        if 0 <= g < G:
            rows = slice(i * bm, (i + 1) * bm)
            acc = torch.zeros((bm, N), dtype=torch.float32, device=x.device)
            for k0 in range(0, K, k_per_split):
                ks = slice(k0, min(K, k0 + k_per_split))
                acc = acc + x[rows, ks].float() @ w[g, ks].float()
            out[rows] = acc.to(x.dtype)
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_counters: dict = {}


def _arrival_counters(dev, n: int) -> torch.Tensor:
    """The K split's arrival counters on ``dev``: at least ``n`` int32
    zeros, kept across calls (the last unit of each output tile sets its
    counter back to 0, so calls on one stream reuse them)."""
    buf = _counters.get(dev)
    if buf is None or buf.numel() < n:
        buf = _counters[dev] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                           device=dev)
    return buf


def _library() -> ctypes.CDLL:
    """The kernel's shared library (built at first use), with the C
    signatures declared."""
    lib = build.load("moe_dispatch")
    fn = lib.mars_grouped_matmul
    if fn.argtypes is None:               # first use: declare once
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 3)
        err = lib.mars_cuda_error_string
        err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
    return lib


def _launch(x, w, tile_group, bm: int, n_tiles):
    """Check operands and launch the CUDA kernel on the current stream."""
    M, K = x.shape
    G, _, N = w.shape
    dev = x.device
    for name, t in (("w", w), ("tile_group", tile_group)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"grouped_matmul kernel takes x and w of one dtype, "
                        f"float32 or bfloat16; got {x.dtype} and {w.dtype}")
    if tile_group.dtype != torch.int32:
        raise TypeError(f"tile_group must be int32, not {tile_group.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()
            and tile_group.is_contiguous()):
        raise ValueError("x, w and tile_group must be contiguous")
    if n_tiles is not None:
        if not isinstance(n_tiles, torch.Tensor) or n_tiles.numel() != 1 \
                or n_tiles.dtype != torch.int32 or n_tiles.device != dev:
            raise TypeError("n_tiles must be a one-element int32 tensor on "
                            "x's device")
    if max(M, K, N, G) > _INT_MAX:
        raise ValueError(f"grouped_matmul kernel takes dimensions below "
                         f"2**31; got M={M} K={K} N={N} G={G}")
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    if M == 0:
        return out
    lib = _library()
    tma = (K % 8 == 0 and N % 8 == 0 and x.data_ptr() % 16 == 0
           and w.data_ptr() % 16 == 0)
    plan = split_plan(M, K, N, bm, x.dtype, _sm_count(dev.index or 0), tma)
    part = counters = None
    if plan.n_split > 1:
        tiles = M // plan.rows * plan.n_span
        part = torch.empty(tiles * plan.n_split * plan.rows * plan.span,
                           dtype=torch.float32, device=dev)
        counters = _arrival_counters(dev, tiles)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.mars_grouped_matmul(
        _DTYPE_CODES[x.dtype], PATH_CODES[plan.path], x.data_ptr(),
        w.data_ptr(), tile_group.data_ptr(),
        None if n_tiles is None else n_tiles.data_ptr(), out.data_ptr(),
        M, K, N, G, bm, plan.rows, plan.n_span, plan.n_split,
        plan.k_per_split, None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(), stream)
    if rc != 0:
        why = "unsupported" if rc == -1 \
            else lib.mars_cuda_error_string(rc).decode()
        raise RuntimeError(f"grouped_matmul kernel launch failed: rc={rc} "
                           f"({why}; plan {plan})")
    grouped_matmul.launches += 1
    return out


def _refuse_grad(*ts) -> None:
    """Raise when autograd would differentiate a launch: the kernels run
    outside the graph and have no backward kernel yet."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "grouped_matmul (K4) has no backward kernel B4 yet: call it "
            "under torch.no_grad() on CUDA, or train on the CPU")


def grouped_matmul(x, w, tile_group, *, bm: int = DEFAULT_BM, n_tiles=None):
    """x: (M, K), rows sorted by group and group-padded so each row tile
    ``[i*bm, (i+1)*bm)`` belongs to one group; w: (G, K, N); tile_group:
    int32 (M // bm,) group of each row tile, in [0, G); ``n_tiles``:
    ``None`` (every tile in use) or a one-element int32 tensor on x's
    device.  Returns (M, N) in x's dtype, summed in float32.  ``bm`` is
    any positive multiple of 16 that divides M.

    CUDA tensors launch the Hopper kernel ``split_plan`` picks (x and w
    of one dtype, float32 or bfloat16, contiguous, neither needing a
    gradient); CPU tensors run the plain twin."""
    _check_shapes(x, w, tile_group, bm)
    if x.device.type == "cuda":
        _refuse_grad(x, w)
        return _launch(x, w, tile_group, bm, n_tiles)
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, tile_group, bm=bm, n_tiles=n_tiles)
    raise ValueError(f"grouped_matmul runs on cuda or cpu, not {x.device}")


grouped_matmul.launches = 0
