"""Row gather by MARS-sorted ids (port of ``repro/kernels/mars_gather/
mars_gather.py``).

``gather_rows`` is the wrapper around the hand-written Hopper kernel
``csrc/mars_gather.cu`` (which replaces the Pallas ``_kernel`` /
``gather_rows``; the source comment there gives its bound and design).
On CUDA tensors it launches the kernel or raises — there is no fallback;
on CPU tensors it runs ``gather_rows_plain``, ``table[sorted_ids]``.
The copy is bitwise, so kernel and twin agree exactly.
``gather_rows.launches`` counts kernel launches.

``mars_gather`` is the port of ``mars_gather_pallas``: sort the ids,
gather the rows in sorted order, unsort.

``scatter_add_rows`` is the gather's backward, B2, around the
hand-written kernel ``csrc/embedding_grad_scatter.cu`` (the reference's
``embedding_grad_scatter`` is plain jnp; the source comment gives B2's
bound and design): given ids stable-sorted by row and the permutation
that sorts them, each run of equal ids sums its gradient rows in f32 in
sorted order and writes its table row once; rows no id names are 0.
``scatter_plan`` gives its launch from (n, d, dtype) alone: a short run
is one warp's a 256-column chunk, a long one 8 warps'.  On CUDA tensors
it launches B2 or raises; on CPU tensors it runs
``scatter_add_rows_plain`` (``index_add_`` of the sorted rows in f32, a
sequential sum on the CPU, so bit for bit B2's).
``scatter_add_rows.launches`` counts B2's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.reorder import inverse_permutation
from repro_torch.kernels import build

_IDX_CODES = {torch.int32: 0, torch.int64: 1}
WARPS = 4                 # warps of a block, one (row, chunk) item each
MAX_LANE_VECS = 4         # vectors a lane keeps in flight


def gather_rows_plain(table: torch.Tensor, sorted_ids: torch.Tensor):
    """The kernel's plain twin: ``table[sorted_ids]``."""
    return table[sorted_ids]


def _library() -> ctypes.CDLL:
    """The kernel's shared library (built at first use), with the C
    signatures declared."""
    lib = build.load("mars_gather")
    fn = lib.mars_gather_rows
    if fn.argtypes is None:               # first use: declare once
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                       + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
        err = lib.mars_cuda_error_string
        err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=256)
def grid_plan(n: int, row_vecs: int, sm_count: int) -> tuple[int, int, int]:
    """``(chunk_vecs, n_chunks, blocks)`` for a gather of ``n`` rows of
    ``row_vecs`` vectors, from shapes and the SM count alone: each row is
    cut into ``n_chunks`` chunks of ``chunk_vecs`` vectors (the last one
    shorter), one warp a chunk, ``WARPS`` warps a block.  The chunk is
    the widest of 128, 64 and 32 vectors (4, 2 or 1 a lane; never wider
    than the row rounded up to 32) whose items still give at least one
    block an SM, else 32."""
    chunk = 32 * MAX_LANE_VECS
    while chunk > 32 and chunk >= 2 * max(row_vecs, 1):
        chunk //= 2

    def blocks(c):
        return -(-n * -(-row_vecs // c) // WARPS)
    while chunk > 32 and blocks(chunk) < sm_count:
        chunk //= 2
    return chunk, -(-row_vecs // chunk), blocks(chunk)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _vector_bytes(row_bytes: int, *ptrs: int) -> int:
    """Widest copy unit (16, 8, 4, 2 or 1 bytes) that divides the row and
    aligns every base pointer."""
    for vec in (16, 8, 4, 2):
        if row_bytes % vec == 0 and all(p % vec == 0 for p in ptrs):
            return vec
    return 1


def _launch(table: torch.Tensor, sorted_ids: torch.Tensor) -> torch.Tensor:
    """Check operands and launch the CUDA kernel on the current stream."""
    dev = table.device
    if sorted_ids.device != dev:
        raise ValueError(f"sorted_ids is on {sorted_ids.device}, table on "
                         f"{dev}")
    if table.dim() != 2 or sorted_ids.dim() != 1:
        raise ValueError(f"gather_rows takes a (V, D) table and (N,) ids; "
                         f"got {tuple(table.shape)} and "
                         f"{tuple(sorted_ids.shape)}")
    if sorted_ids.dtype not in _IDX_CODES:
        raise TypeError(f"gather_rows ids must be int32 or int64, not "
                        f"{sorted_ids.dtype}")
    if not table.is_contiguous() or not sorted_ids.is_contiguous():
        raise ValueError("table and sorted_ids must be contiguous")
    V, D = table.shape
    n = sorted_ids.shape[0]
    out = torch.empty((n, D), dtype=table.dtype, device=dev)
    row_bytes = D * table.element_size()
    if n == 0 or row_bytes == 0:
        return out
    lib = _library()
    vec = _vector_bytes(row_bytes, table.data_ptr(), out.data_ptr())
    chunk_vecs = grid_plan(n, row_bytes // vec,
                           _sm_count(dev.index or 0))[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.mars_gather_rows(
        _IDX_CODES[sorted_ids.dtype], vec, table.data_ptr(),
        sorted_ids.data_ptr(), out.data_ptr(), V, row_bytes, n, chunk_vecs,
        stream)
    if rc != 0:
        why = lib.mars_cuda_error_string(rc).decode() if rc > 0 \
            else "unsupported"
        raise RuntimeError(f"gather_rows kernel launch failed: rc={rc} "
                           f"({why})")
    gather_rows.launches += 1
    return out


def gather_rows(table: torch.Tensor, sorted_ids: torch.Tensor):
    """table: (V, D) of any dtype; sorted_ids: int32 or int64 (N,),
    normally MARS-sorted.  Returns (N, D): row ``i`` is
    ``table[sorted_ids[i]]``, bit for bit.

    CUDA tensors launch the Hopper kernel (ids must lie in [0, V): the
    kernel does not raise on one outside, it writes a zero row); CPU
    tensors run the plain twin."""
    if table.device.type == "cuda":
        return _launch(table, sorted_ids)
    if table.device.type == "cpu":
        return gather_rows_plain(table, sorted_ids)
    raise ValueError(f"gather_rows runs on cuda or cpu, not {table.device}")


gather_rows.launches = 0


def mars_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Full MARS gather (port of ``mars_gather_pallas``): sort the ids,
    gather rows in sorted order through ``gather_rows``, unsort.
    ids: int (...); returns (..., D)."""
    shape = ids.shape
    flat = ids.reshape(-1)
    perm = torch.argsort(flat, stable=True)
    rows = gather_rows(table, flat[perm])
    return rows[inverse_permutation(perm)].reshape(*shape, table.shape[1])


# ---------------------------------------------------------------------------
# Backward (B2): sorted segment sum of gradient rows
# ---------------------------------------------------------------------------

_SCATTER_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SCATTER_WARPS = 4         # warps of a B2 block, one (position, chunk) each
SCATTER_CHUNK = 256       # columns of a chunk (the grid's y)
SCATTER_SLICES = 8        # warps that sum a long run's chunk, 32 columns each


@functools.lru_cache(maxsize=256)
def scatter_plan(n: int, d: int, dtype) -> tuple[bool, int, int]:
    """B2's launch plan ``(wide, n_chunks, blocks)`` for ``n`` sorted
    positions of ``d`` columns, from shapes and the dtype alone: each row
    is cut into ``n_chunks`` chunks of ``SCATTER_CHUNK`` columns (the last
    one shorter), one warp a (position, chunk), ``SCATTER_WARPS``
    positions a block, the chunks along the grid's y.  A run shorter than
    ``SCATTER_SLICES`` positions is summed by its first warp, 8
    contiguous columns a lane (``wide``: as 16-byte loads, where d is a
    multiple of 8); a longer one by its first ``SCATTER_SLICES`` warps,
    warp t the 32 columns from 32 t of the chunk, one a lane."""
    if dtype not in _SCATTER_DTYPE_CODES:
        raise TypeError(f"scatter_add_rows kernel takes float32 or bfloat16 "
                        f"g; got {dtype}")
    return (d % 8 == 0, -(-d // SCATTER_CHUNK), -(-n // SCATTER_WARPS))


def scatter_add_rows_plain(sorted_ids, perm, g, vocab: int):
    """B2's plain twin: ``zeros(vocab, d)`` in float32 plus the rows
    ``g[perm]`` at ``sorted_ids`` (``index_add_``), rounded to g's
    dtype."""
    out = torch.zeros((vocab, g.shape[1]), dtype=torch.float32,
                      device=g.device)
    out.index_add_(0, sorted_ids, g[perm].float())
    return out.to(g.dtype)


def _scatter_library() -> ctypes.CDLL:
    lib = build.load("embedding_grad_scatter")
    fn = lib.mars_embedding_grad_scatter
    if fn.argtypes is None:               # first use: declare once
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                       + [ctypes.c_longlong] * 5 + [ctypes.c_void_p])
        err = lib.mars_cuda_error_string
        err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
    return lib


def _scatter_launch(sorted_ids, perm, g, vocab: int):
    """Check operands and launch B2 on the current stream."""
    dev = g.device
    for name, t in (("sorted_ids", sorted_ids), ("perm", perm)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, g on {dev}")
        if t.dtype != torch.int64 or t.dim() != 1:
            raise TypeError(f"scatter_add_rows takes (N,) int64 {name}; "
                            f"got {t.dtype} {tuple(t.shape)}")
    if g.dim() != 2 or g.shape[0] != sorted_ids.shape[0] \
            or perm.shape != sorted_ids.shape:
        raise ValueError(f"scatter_add_rows takes g (N, d) with N ids; got "
                         f"g {tuple(g.shape)}, {sorted_ids.shape[0]} ids")
    if g.dtype not in _SCATTER_DTYPE_CODES:
        raise TypeError(f"scatter_add_rows kernel takes float32 or bfloat16 "
                        f"g; got {g.dtype}")
    if not (g.is_contiguous() and sorted_ids.is_contiguous()
            and perm.is_contiguous()):
        raise ValueError("g, sorted_ids and perm must be contiguous")
    n, d = g.shape
    out = torch.zeros((vocab, d), dtype=g.dtype, device=dev)
    if n == 0 or d == 0:
        return out
    wide, n_chunks, blocks = scatter_plan(n, d, g.dtype)
    if wide and g.data_ptr() % 16:
        g = g.clone()             # a view at an odd offset: an aligned copy
    lib = _scatter_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.mars_embedding_grad_scatter(
        _SCATTER_DTYPE_CODES[g.dtype], int(wide), sorted_ids.data_ptr(),
        perm.data_ptr(), g.data_ptr(), out.data_ptr(), n, vocab, d, n_chunks,
        blocks, stream)
    if rc != 0:
        why = lib.mars_cuda_error_string(rc).decode() if rc > 0 \
            else "unsupported"
        raise RuntimeError(f"scatter_add_rows kernel launch failed: rc={rc} "
                           f"({why})")
    scatter_add_rows.launches += 1
    return out


def scatter_add_rows(sorted_ids, perm, g, vocab: int):
    """sorted_ids: int64 (N,), stable-sorted, and perm, the permutation
    that sorts them; g: (N, d) rows in token order.  Returns (vocab, d) in
    g's dtype: row ``r`` is the f32 sum, in sorted order, of ``g[perm[j]]``
    over the j with ``sorted_ids[j] == r`` (0 where none).

    CUDA tensors launch B2 (float32 or bfloat16 g; ids outside [0,
    vocab) add nothing there); CPU tensors run the plain twin."""
    if g.device.type == "cuda":
        return _scatter_launch(sorted_ids, perm, g, vocab)
    if g.device.type == "cpu":
        return scatter_add_rows_plain(sorted_ids, perm, g, vocab)
    raise ValueError(f"scatter_add_rows runs on cuda or cpu, not {g.device}")


scatter_add_rows.launches = 0
