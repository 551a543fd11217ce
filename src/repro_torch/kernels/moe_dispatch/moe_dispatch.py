"""MARS-sorted grouped matmul (port of ``repro/kernels/moe_dispatch/
moe_dispatch.py``) and its backward.

``grouped_matmul`` is the wrapper around the hand-written Hopper kernels
``csrc/moe_dispatch.cu`` (K4, which replace the Pallas ``_kernel`` /
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
``grouped_matmul.launches`` counts kernel launches.

Training: when x or w needs a gradient, ``grouped_matmul`` runs as a
``torch.autograd.Function`` whose forward is the same K4 launch (or twin)
and whose backward is ``grouped_matmul_bwd``: B4, the hand-written
kernels of ``csrc/moe_dispatch_bwd.cu`` (dx = dout w_g^T over K4's row
tiles, dw_g = the sum of x^T dout over expert g's tiles; the JAX trainer
differentiates ``lax.ragged_dot``, so no Pallas kernel corresponds), on
CUDA tensors, and ``grouped_matmul_bwd_plain`` on CPU ones.
``bwd_plan`` picks the kernels from shapes and the SM count alone.  On
the bf16 tensor-core path a prologue launch builds, from the routing on
the device, each expert's tile list and the experts heaviest first with
their dx items and dw units (``bwd_work`` is its host mirror), which
persistent dx and dw kernels walk; on CUDA cores the dw kernel cuts an
expert with many row tiles across blocks from the routing it finds on
the device (``expert_slabs`` says how).  ``grouped_matmul_bwd.launches``
counts B4's launches (``bwd_launches``: three a call that needs both
gradients on the tensor-core path, two on CUDA cores).  The twins
compute in float64 for float64 inputs (for ``gradcheck``), else in
float32.

The ``tile_group`` contract is the reference's: token rows sorted by
expert, each expert's segment padded to a multiple of ``bm`` rows
(``ops.pad_sorted_groups``), so row tile ``i`` belongs to expert
``tile_group[i]``.  ``n_tiles``, a device int32 scalar, is the number of
row tiles in use: later tiles come out zero and the kernel reads no
weights for them, so a caller can size its buffers by a bound without
reading the count back to the host.

Fake tensors (``torch._subclasses.FakeTensorMode``: the dry-run,
``launch.dryrun``) hold no routing to read, so on them both wrappers run
the static bound in place of the twins: every row tile in use, each
against one expert's weights (``grouped_matmul_static``,
``grouped_matmul_bwd_static``): the twins' shapes and dtypes and 2 M K
N operations a product, as the reference's kernel runs every tile of the
padded rows.  A real tensor never takes them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

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


def _acc_dtype(t) -> torch.dtype:
    """The twins' accumulation dtype: float64 for float64 operands, else
    float32 (the kernels' f32 sums)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _live_tiles(tile_group, G: int, T: int, n_tiles) -> list:
    """``(tile, group)`` of each row tile in use (below ``n_tiles``) whose
    group lies in [0, G), in tile order."""
    used = T if n_tiles is None else max(0, min(int(n_tiles), T))
    return [(i, g) for i, g in enumerate(tile_group[:used].tolist())
            if 0 <= g < G]


def grouped_matmul_plain(x, w, tile_group, *, bm: int = DEFAULT_BM,
                         n_tiles=None):
    """The kernel's plain twin: for each row tile in use, ``x_tile.float()
    @ w[g].float()`` cast to x's dtype; tiles at or past ``n_tiles``, or
    whose group lies outside [0, G), are zero.  Same contract as
    ``grouped_matmul``."""
    _check_shapes(x, w, tile_group, bm)
    M = x.shape[0]
    G, _, N = w.shape
    acc = _acc_dtype(x)
    out = torch.zeros((M, N), dtype=x.dtype, device=x.device)
    for i, g in _live_tiles(tile_group, G, M // bm, n_tiles):
        rows = slice(i * bm, (i + 1) * bm)
        out[rows] = (x[rows].to(acc) @ w[g].to(acc)).to(x.dtype)
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
    for i, g in _live_tiles(tile_group, G, M // bm, n_tiles):
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


def _arrival_counters(dev, n: int, kernel: str = "K4") -> torch.Tensor:
    """A split's arrival counters on ``dev`` (K4's K slabs, or B4's row
    slabs with ``kernel="B4"``): at least ``n`` int32 zeros, kept across
    calls (the last unit of each output tile sets its counter back to 0,
    so calls on one stream reuse them)."""
    buf = _counters.get((kernel, dev))
    if buf is None or buf.numel() < n:
        buf = _counters[(kernel, dev)] = torch.zeros(
            max(n, 1024), dtype=torch.int32, device=dev)
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


def grouped_matmul_static(x, w):
    """``grouped_matmul``'s static bound on fake tensors: every row tile
    in use, each against expert 0's weights (the plain twin's shapes,
    dtype and accumulation; 2 M K N operations)."""
    acc = _acc_dtype(x)
    return (x.to(acc) @ w[0].to(acc)).to(x.dtype)


def grouped_matmul_bwd_static(x, w, dout, need_dx: bool, need_dw: bool):
    """``grouped_matmul_bwd``'s static bound on fake tensors: every row
    tile in use against expert 0's weights; dw sums x^T dout over every
    row once (2 M K N operations each), then takes the (G, K, N) shape."""
    acc = _acc_dtype(x)
    dx = dw = None
    if need_dx:
        dx = (dout.to(acc) @ w[0].to(acc).T).to(x.dtype)
    if need_dw:
        dw = (x.to(acc).T @ dout.to(acc)).to(w.dtype).expand(w.shape) \
            .contiguous()
    return dx, dw


def _forward(x, w, tile_group, bm: int, n_tiles):
    if isinstance(x, FakeTensor):
        return grouped_matmul_static(x, w)
    if x.device.type == "cuda":
        return _launch(x, w, tile_group, bm, n_tiles)
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, tile_group, bm=bm, n_tiles=n_tiles)
    raise ValueError(f"grouped_matmul runs on cuda or cpu, not {x.device}")


class _GroupedMatmul(torch.autograd.Function):
    """K4 forward, B4 backward (the twins on CPU tensors)."""

    @staticmethod
    def forward(ctx, x, w, tile_group, bm, n_tiles):
        ctx.save_for_backward(x, w, tile_group, n_tiles)
        ctx.bm = bm
        return _forward(x, w, tile_group, bm, n_tiles)

    @staticmethod
    def backward(ctx, dout):
        x, w, tile_group, n_tiles = ctx.saved_tensors
        need_dx, need_dw = ctx.needs_input_grad[:2]
        dx, dw = grouped_matmul_bwd(x, w, dout.contiguous(), tile_group,
                                    bm=ctx.bm, n_tiles=n_tiles,
                                    need_dx=need_dx, need_dw=need_dw)
        return dx, dw, None, None, None


def grouped_matmul(x, w, tile_group, *, bm: int = DEFAULT_BM, n_tiles=None):
    """x: (M, K), rows sorted by group and group-padded so each row tile
    ``[i*bm, (i+1)*bm)`` belongs to one group; w: (G, K, N); tile_group:
    int32 (M // bm,) group of each row tile, in [0, G); ``n_tiles``:
    ``None`` (every tile in use) or a one-element int32 tensor on x's
    device.  Returns (M, N) in x's dtype, summed in float32.  ``bm`` is
    any positive multiple of 16 that divides M.

    CUDA tensors launch the Hopper kernel ``split_plan`` picks (x and w
    of one dtype, float32 or bfloat16, contiguous); CPU tensors run the
    plain twin.  Differentiable in x and w: with a gradient to take, the
    backward is ``grouped_matmul_bwd`` (B4 on CUDA)."""
    _check_shapes(x, w, tile_group, bm)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _GroupedMatmul.apply(x, w, tile_group, bm, n_tiles)
    return _forward(x, w, tile_group, bm, n_tiles)


grouped_matmul.launches = 0


# ---------------------------------------------------------------------------
# Backward (B4)
# ---------------------------------------------------------------------------

# launches of a call that needs dx and dw: the tensor-core path's lists,
# dx and dw; the CUDA cores' dx and dw (``bwd_launches``)
BWD_LAUNCHES = {"tma": 3, "cores": 2}
PATH_CODES_BWD = {"cores": 0, "tma": 1}
# the tensor-core kernels' geometry (csrc/moe_dispatch_bwd.cu, namespace
# tc): a dx item is (expert, TC_DX_BAND rows of K, up to TC_DX_CHUNK of its
# rows); a dw unit is (expert, TC_DW_TILE rows of K, a run of
# TC_DW_TILE-column output tiles: all of N for an expert of at most
# TC_DW_X_ROWS rows, whose x band stays in shared memory, else at most
# TC_DW_UNIT_ROWS rows x tiles); the prologue lists at most TC_MAX_GROUPS
# experts
TC_DX_BAND = 256
TC_DX_CHUNK = 128
TC_DW_TILE = 128
TC_DW_X_ROWS = 384
TC_DW_UNIT_ROWS = 8192
TC_MAX_GROUPS = 4096
CORES_TILE = 64           # dw's output tile on CUDA cores
BWD_WAVES = 2             # waves of dw blocks the row split aims for
SLAB_WORK = 16384         # rows a CUDA-core dw slab takes at most
MIN_SLAB_ROWS = 64        # rows a CUDA-core dw slab takes at least
MAX_ROW_SPLIT = 32        # slabs an expert's row tiles are cut into at most
MAX_SPLIT_BYTES = 1 << 29  # f32 partials the row split may hold
MAX_SPLIT_GROUPS = 1024   # experts the kernel counts (kMaxSplitGroups)


def bwd_launches(dtype) -> int:
    """B4's launches for a call of a model's training step that needs dx
    and dw: bfloat16 takes the tensor-core path (the prologue's lists, dx,
    dw), float32 the CUDA cores (dx, dw)."""
    return BWD_LAUNCHES["tma" if dtype == torch.bfloat16 else "cores"]


class BwdPlan(NamedTuple):
    """B4's kernels and cuts: ``path`` "tma" (bf16 tensor cores fed by
    TMA, persistent blocks over the work order the prologue builds on the
    device) or "cores"; ``rows``: the rows of a dx item (``TC_DX_CHUNK``)
    or unit (cores).  The CUDA cores' row split, decided on the device
    from the routing (``expert_slabs``): an expert with c live row tiles
    is cut into ``min(max_split, c // split_tiles)`` slabs where that is 2
    or more and the request fits the ``slots`` partial slots (``slots`` <
    2, and always on the tensor-core path: no cut)."""
    path: str
    rows: int
    split_tiles: int
    max_split: int
    slots: int


@functools.lru_cache(maxsize=256)
def bwd_plan(M: int, K: int, N: int, G: int, bm: int, dtype,
             sm_count: int, tma: bool = True) -> BwdPlan:
    """B4's plan from shapes and the SM count alone (never ``n_tiles`` or
    the routing, which only the device knows).

    bfloat16 operands that are 16-byte aligned with K and N multiples of
    8 (``tma``), of at most ``TC_MAX_GROUPS`` experts, take the
    tensor-core kernels, which cut their work from the routing on the
    device (``bwd_work``) and need no split.  Anything else takes the
    CUDA-core kernels: dx units of up to 128 rows of one tile, dw blocks
    of one 64 x 64 output tile, and the row split: a slab holds at least
    ``split_tiles`` row tiles, the rows that spread the M rows' work over
    ``BWD_WAVES`` waves of dw blocks, but no more than ``SLAB_WORK`` rows
    and no fewer than ``MIN_SLAB_ROWS`` (each slab adds a partial that one
    block sums: only where the blocks alone cannot fill the card does a
    cut pay); an expert is cut into at most ``MAX_ROW_SPLIT`` slabs and
    no more than there are slots; the partial slots are as many as
    ``MAX_SPLIT_BYTES`` of f32 partials hold, and no more than the slabs
    of that size the M rows make (none beyond ``MAX_SPLIT_GROUPS``
    experts)."""
    if dtype == torch.bfloat16 and tma and G <= TC_MAX_GROUPS:
        return BwdPlan("tma", TC_DX_CHUNK, 1, 1, 0)
    t = CORES_TILE
    n_kb, n_nb = -(-K // t), -(-N // t)
    even = -(-M * n_kb * n_nb // (BWD_WAVES * sm_count))
    split_tiles = max(1, max(MIN_SLAB_ROWS, min(SLAB_WORK, even)) // bm)
    slots = min(MAX_SPLIT_BYTES // (n_kb * n_nb * t * t * 4),
                M // bm // split_tiles)
    if slots < 2 or G > MAX_SPLIT_GROUPS:
        slots = 0
    return BwdPlan("cores", min(bm, 128), split_tiles,
                   min(MAX_ROW_SPLIT, slots) if slots else 1, slots)


class BwdWork(NamedTuple):
    """The tensor-core kernels' work order, as their prologue builds it on
    the device (``csrc/moe_dispatch_bwd.cu``, ``tc::Work``): ``tiles[g]``
    expert g's live row tiles in tile order; ``order`` the experts, most
    live tiles first (ties: lower id first); ``dx_items[i]`` and
    ``dw_units[i]`` the dx items and dw units of expert ``order[i]``.  A
    persistent block takes every grid-th item (unit) of that order."""
    tiles: tuple
    order: tuple
    dx_items: tuple
    dw_units: tuple


def dw_walk(rows: int, n_nb: int) -> int:
    """Output tiles of N a dw unit of an expert of ``rows`` rows takes:
    all of them where its x band stays in shared memory, else as many as
    keep rows x tiles within ``TC_DW_UNIT_ROWS`` (at least one)."""
    if rows <= TC_DW_X_ROWS:
        return n_nb
    return max(1, min(n_nb, TC_DW_UNIT_ROWS // rows))


def bwd_work(tile_group, G: int, n_tiles, K: int, N: int,
             bm: int) -> BwdWork:
    """The host's mirror of the prologue: the live tiles of each expert
    (below ``n_tiles``, group in [0, G); tile_group may be unsorted), the
    experts heaviest first, and each one's dx items (K bands of
    ``TC_DX_BAND`` times chunks of ``TC_DX_CHUNK`` rows) and dw units (K
    bands of ``TC_DW_TILE`` times runs of ``dw_walk`` output tiles)."""
    T = tile_group.numel()
    tiles = [[] for _ in range(G)]
    for i, g in _live_tiles(tile_group, G, T, n_tiles):
        tiles[g].append(i)
    order = sorted(range(G), key=lambda g: (-len(tiles[g]), g))
    n_band, n_kb = -(-K // TC_DX_BAND), -(-K // TC_DW_TILE)
    n_nb = -(-N // TC_DW_TILE)
    rows = [len(tiles[g]) * bm for g in order]
    return BwdWork(tuple(tuple(t) for t in tiles), tuple(order),
                   tuple(n_band * -(-r // TC_DX_CHUNK) for r in rows),
                   tuple(n_kb * -(-n_nb // dw_walk(r, n_nb)) for r in rows))


def rec_offset(T: int, G: int) -> int:
    """Where the dx item records start in the work buffer: past the lists
    and offsets, 16-byte aligned."""
    return (T + 4 * G + 3 + 3) // 4 * 4


def dx_item_bound(T: int, G: int, K: int, bm: int) -> int:
    """The most dx items T row tiles of bm rows over G experts make."""
    return -(-K // TC_DX_BAND) * (T * bm // TC_DX_CHUNK + G)


def work_buffer(work: BwdWork, T: int, K: int, bm: int) -> list:
    """``work`` in the device's int32 layout: the lists (T entries, the
    places past the live tiles -1), off (G + 1), order (G), dx_off and
    dw_off (G + 1 each), -1 up to ``rec_offset``, then a record of four
    for each dx item: expert, K band | row groups << 24, first row group,
    the expert's offset in the lists."""
    G = len(work.tiles)
    lists = [t for tiles in work.tiles for t in tiles]
    off, dx_off, dw_off = [0], [0], [0]
    for tiles in work.tiles:
        off.append(off[-1] + len(tiles))
    for a, b in zip(work.dx_items, work.dw_units):
        dx_off.append(dx_off[-1] + a)
        dw_off.append(dw_off[-1] + b)
    head = (lists + [-1] * (T - len(lists)) + off + list(work.order)
            + dx_off + dw_off)
    head += [-1] * (rec_offset(T, G) - len(head))
    for g, kb, q0, groups in dx_item_list(work, K, bm):
        head += [g, kb | groups << 24, q0, off[g]]
    return head


def dx_item_list(work: BwdWork, K: int, bm: int) -> list:
    """Every dx item in the order's sequence as (expert, K band, first row
    group, row groups of 16): an expert's bands in order, each band's
    chunks adjacent."""
    out = []
    for g, n in zip(work.order, work.dx_items):
        groups = len(work.tiles[g]) * bm // 16
        chunks = -(-groups * 16 // TC_DX_CHUNK)
        for j in range(n):
            q0 = (j % chunks) * (TC_DX_CHUNK // 16)
            out.append((g, j // chunks, q0, min(TC_DX_CHUNK // 16,
                                                groups - q0)))
    return out


def dw_unit_list(work: BwdWork, K: int, N: int, bm: int) -> list:
    """Every dw unit in the order's sequence as (expert, K band, first and
    end output tile of N, row groups of 16, x band resident): a resident
    expert's units are its K bands, each all of N; a streamed one's go K
    band fastest within each run of ``dw_walk`` tiles."""
    n_kb, n_nb = -(-K // TC_DW_TILE), -(-N // TC_DW_TILE)
    out = []
    for g, n in zip(work.order, work.dw_units):
        rows = len(work.tiles[g]) * bm
        walk = dw_walk(rows, n_nb)
        for j in range(n):
            if rows <= TC_DW_X_ROWS:
                kb, nb0 = j, 0
            else:
                kb, nb0 = j % n_kb, j // n_kb * walk
            out.append((g, kb, nb0, min(n_nb, nb0 + walk), rows // 16,
                        0 < rows <= TC_DW_X_ROWS))
    return out


def expert_slabs(tile_group, G: int, T: int, n_tiles, plan: BwdPlan):
    """Each expert's (live tiles, slabs, first partial slot), as B4's dw
    kernel decides them on the device: in expert order, an expert with c
    live tiles asks for ``min(plan.max_split, c // plan.split_tiles)``
    slabs where that is 2 or more; the request is granted while the
    requests so far, granted or not, fit ``plan.slots`` slots (its first
    slot is the sum of the requests before it); any other expert is one
    slab (slot None)."""
    counts = [0] * G
    for _, g in _live_tiles(tile_group, G, T, n_tiles):
        counts[g] += 1
    out, base = [], 0
    for c in counts:
        req = min(plan.max_split, c // plan.split_tiles)
        if plan.slots >= 2 and req >= 2:
            out.append((c, req, base) if base + req <= plan.slots
                       else (c, 1, None))
            base += req
        else:
            out.append((c, 1, None))
    return out


def grouped_matmul_bwd_plain(x, w, dout, tile_group, *, bm: int = DEFAULT_BM,
                             n_tiles=None, plan: BwdPlan | None = None,
                             need_dx: bool = True, groups=None):
    """B4's plain twin: (dx, dw) of ``grouped_matmul(x, w, tile_group)``
    for the incoming gradient ``dout`` (M, N).  For each row tile in use
    whose group g lies in [0, G): ``dx_tile = dout_tile @ w[g]^T`` in
    float32, cast to x's dtype; other tiles zero (``None`` without
    ``need_dx``).  ``dw[g]``: g's live tiles cut into the slabs the
    kernel cuts under ``plan`` (``expert_slabs``; uncut without a plan),
    slab s of n taking the tiles of rank [c s / n, c (s + 1) / n); each
    slab's float32 partial sums ``x_tile^T @ dout_tile`` over its tiles in
    tile order from zero, the partials are summed in slab order from zero
    and cast to w's dtype once; an expert with no tile is exact zeros.
    ``groups`` (a list of expert ids) computes only those experts' dw,
    stacked in that order.  float64 operands are summed in float64."""
    _check_shapes(x, w, tile_group, bm)
    M = x.shape[0]
    G, K, N = w.shape
    if tuple(dout.shape) != (M, N):
        raise ValueError(f"dout must be (M, N) = {(M, N)}; got "
                         f"{tuple(dout.shape)}")
    acc = _acc_dtype(x)
    T = M // bm
    live = _live_tiles(tile_group, G, T, n_tiles)
    dx = None
    if need_dx:
        dx = torch.zeros_like(x)
        for i, g in live:
            rows = slice(i * bm, (i + 1) * bm)
            dx[rows] = (dout[rows].to(acc) @ w[g].to(acc).T).to(x.dtype)
    slabs = None if plan is None else expert_slabs(tile_group, G, T,
                                                   n_tiles, plan)
    groups = range(G) if groups is None else list(groups)
    dw = torch.zeros((len(groups), K, N), dtype=w.dtype, device=x.device)
    for j, g in enumerate(groups):
        tiles = [i for i, e in live if e == g]
        n = 1 if slabs is None else slabs[g][1]
        total = torch.zeros((K, N), dtype=acc, device=x.device)
        for s in range(n):
            part = torch.zeros((K, N), dtype=acc, device=x.device)
            for i in tiles[len(tiles) * s // n:len(tiles) * (s + 1) // n]:
                rows = slice(i * bm, (i + 1) * bm)
                part = part + x[rows].to(acc).T @ dout[rows].to(acc)
            total = total + part
        dw[j] = total.to(w.dtype)
    return dx, dw


def _bwd_library() -> ctypes.CDLL:
    """B4's shared library (built at first use), with the C signatures
    declared."""
    return declare_bwd(build.load("moe_dispatch_bwd"))


def declare_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/moe_dispatch_bwd.cu``) with B4's C
    signatures declared."""
    dx, dw = lib.mars_grouped_matmul_bwd_dx, lib.mars_grouped_matmul_bwd_dw
    lists = lib.mars_grouped_matmul_bwd_lists
    if dx.argtypes is None:               # first use: declare once
        head = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
        dx.restype = dw.restype = lists.restype = ctypes.c_int
        dx.argtypes = head + [ctypes.c_int, ctypes.c_void_p]
        dw.argtypes = head + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
        lists.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                          + [ctypes.c_void_p])
        err = lib.mars_cuda_error_string
        err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
    return lib


def _check_rc(lib, rc: int, which: str, plan) -> None:
    """Raise for a failed B4 launch; count one that ran."""
    if rc != 0:
        why = "unsupported" if rc == -1 \
            else lib.mars_cuda_error_string(rc).decode()
        raise RuntimeError(f"grouped_matmul_bwd {which} kernel launch "
                           f"failed: rc={rc} ({why}; plan {plan})")
    grouped_matmul_bwd.launches += 1


def _launch_lists(lib, tile_group, n_tiles, M: int, K: int, N: int, G: int,
                  bm: int, plan) -> torch.Tensor:
    """The tensor-core path's prologue on the current stream: a work
    buffer in ``work_buffer``'s layout (one launch)."""
    dev = tile_group.device
    T = M // bm
    work = torch.empty(rec_offset(T, G) + 4 * dx_item_bound(T, G, K, bm),
                       dtype=torch.int32, device=dev)
    _check_rc(lib, lib.mars_grouped_matmul_bwd_lists(
        tile_group.data_ptr(),
        None if n_tiles is None else n_tiles.data_ptr(), work.data_ptr(),
        M, K, N, G, bm, torch.cuda.current_stream(dev).cuda_stream),
        "lists", plan)
    return work


def bwd_work_device(tile_group, G: int, n_tiles, M: int, K: int, N: int,
                    bm: int) -> torch.Tensor:
    """The prologue's work buffer for a CUDA ``tile_group`` (one launch,
    counted): what ``work_buffer(bwd_work(...))`` computes on the host,
    for holding the one against the other."""
    plan = BwdPlan("tma", TC_DX_CHUNK, 1, 1, 0)
    return _launch_lists(_bwd_library(), tile_group, n_tiles, M, K, N, G,
                         bm, plan)


def _bwd_launch(x, w, dout, tile_group, bm: int, n_tiles, need_dx: bool,
                need_dw: bool):
    """Check operands and launch B4's dx and dw kernels (those wanted) on
    the current stream."""
    M, K = x.shape
    G, _, N = w.shape
    dev = x.device
    for name, t in (("w", w), ("dout", dout), ("tile_group", tile_group)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype \
            or dout.dtype != x.dtype:
        raise TypeError(f"grouped_matmul_bwd kernel takes x, w and dout of "
                        f"one dtype, float32 or bfloat16; got {x.dtype}, "
                        f"{w.dtype} and {dout.dtype}")
    if tile_group.dtype != torch.int32:
        raise TypeError(f"tile_group must be int32, not {tile_group.dtype}")
    if not all(t.is_contiguous() for t in (x, w, dout, tile_group)):
        raise ValueError("x, w, dout and tile_group must be contiguous")
    if n_tiles is not None:
        if not isinstance(n_tiles, torch.Tensor) or n_tiles.numel() != 1 \
                or n_tiles.dtype != torch.int32 or n_tiles.device != dev:
            raise TypeError("n_tiles must be a one-element int32 tensor on "
                            "x's device")
    if max(M, K, N, G) > _INT_MAX:
        raise ValueError(f"grouped_matmul_bwd kernel takes dimensions "
                         f"below 2**31; got M={M} K={K} N={N} G={G}")
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty_like(w) if need_dw else None
    if M == 0:
        return dx, None if dw is None else dw.zero_()
    lib = _bwd_library()
    tma = (K % 8 == 0 and N % 8 == 0
           and all(t.data_ptr() % 16 == 0 for t in (x, w, dout)))
    sm = _sm_count(dev.index or 0)
    plan = bwd_plan(M, K, N, G, bm, x.dtype, sm, tma)
    code, path = _DTYPE_CODES[x.dtype], PATH_CODES_BWD[plan.path]
    n_ptr = None if n_tiles is None else n_tiles.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    work = None
    if plan.path == "tma":
        work = _launch_lists(lib, tile_group, n_tiles, M, K, N, G, bm, plan)
    w_ptr = None if work is None else work.data_ptr()
    if need_dx:
        _check_rc(lib, lib.mars_grouped_matmul_bwd_dx(
            code, path, dout.data_ptr(), w.data_ptr(), tile_group.data_ptr(),
            n_ptr, w_ptr, dx.data_ptr(), M, K, N, G, bm, plan.rows, sm,
            stream), "dx", plan)
    if need_dw:
        part = counters = None
        if plan.slots >= 2:
            t = CORES_TILE
            tiles = plan.slots * -(-K // t) * -(-N // t)
            part = torch.empty(tiles * t * t, dtype=torch.float32,
                               device=dev)
            counters = _arrival_counters(dev, tiles, "B4")
        _check_rc(lib, lib.mars_grouped_matmul_bwd_dw(
            code, path, x.data_ptr(), dout.data_ptr(), tile_group.data_ptr(),
            n_ptr, w_ptr, dw.data_ptr(), M, K, N, G, bm, sm,
            plan.split_tiles, plan.max_split, plan.slots,
            None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr(), stream),
            "dw", plan)
    return dx, dw


def grouped_matmul_bwd(x, w, dout, tile_group, *, bm: int = DEFAULT_BM,
                       n_tiles=None, need_dx: bool = True,
                       need_dw: bool = True):
    """(dx, dw) of ``grouped_matmul(x, w, tile_group, bm=bm,
    n_tiles=n_tiles) == out`` for the incoming gradient ``dout`` (shaped
    as out), dx in x's dtype and dw in w's; ``None`` for a gradient not
    wanted.  CUDA tensors launch B4 (x, w and dout of one dtype, float32
    or bfloat16, contiguous; on the tensor-core path a prologue launch,
    then one for dx, one for dw; on CUDA cores one each); CPU tensors run
    the plain twin."""
    _check_shapes(x, w, tile_group, bm)
    if isinstance(x, FakeTensor):
        return grouped_matmul_bwd_static(x, w, dout, need_dx, need_dw)
    if x.device.type == "cuda":
        return _bwd_launch(x, w, dout, tile_group, bm, n_tiles, need_dx,
                           need_dw)
    if x.device.type == "cpu":
        dx, dw = grouped_matmul_bwd_plain(x, w, dout, tile_group, bm=bm,
                                          n_tiles=n_tiles)
        return dx if need_dx else None, dw if need_dw else None
    raise ValueError(f"grouped_matmul_bwd runs on cuda or cpu, not "
                     f"{x.device}")


grouped_matmul_bwd.launches = 0
