"""MARS-sorted grouped matmul (port of ``repro/kernels/moe_dispatch/
moe_dispatch.py``).

``grouped_matmul`` is the wrapper around the hand-written Hopper kernel
``csrc/moe_dispatch.cu`` (which replaces the Pallas ``_kernel`` /
``grouped_matmul``; the source comment there gives its bound and
design).  On CUDA tensors it launches the kernel or raises — there is no
fallback; on CPU tensors it runs ``grouped_matmul_plain``, the kernel's
plain twin: one float32 product per row tile, cast to x's dtype.
``grouped_matmul.launches`` counts kernel launches.

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

import torch

from repro_torch.kernels import build

DEFAULT_BM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1


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


def _library() -> ctypes.CDLL:
    """The kernel's shared library (built at first use), with the C
    signatures declared."""
    lib = build.load("moe_dispatch")
    fn = lib.mars_grouped_matmul
    if fn.argtypes is None:               # first use: declare once
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
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
    vec = int(K % 8 == 0 and N % 8 == 0 and x.data_ptr() % 16 == 0
              and w.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.mars_grouped_matmul(
        _DTYPE_CODES[x.dtype], vec, x.data_ptr(), w.data_ptr(),
        tile_group.data_ptr(),
        None if n_tiles is None else n_tiles.data_ptr(), out.data_ptr(),
        M, K, N, G, bm, stream)
    if rc != 0:
        why = lib.mars_cuda_error_string(rc).decode() if rc > 0 \
            else "unsupported"
        raise RuntimeError(f"grouped_matmul kernel launch failed: rc={rc} "
                           f"({why})")
    grouped_matmul.launches += 1
    return out


def grouped_matmul(x, w, tile_group, *, bm: int = DEFAULT_BM, n_tiles=None):
    """x: (M, K), rows sorted by group and group-padded so each row tile
    ``[i*bm, (i+1)*bm)`` belongs to one group; w: (G, K, N); tile_group:
    int32 (M // bm,) group of each row tile, in [0, G); ``n_tiles``:
    ``None`` (every tile in use) or a one-element int32 tensor on x's
    device.  Returns (M, N) in x's dtype, summed in float32.  ``bm`` is
    any positive multiple of 16 that divides M.

    CUDA tensors launch the Hopper kernel (x and w of one dtype, float32
    or bfloat16, contiguous); CPU tensors run the plain twin."""
    _check_shapes(x, w, tile_group, bm)
    if x.device.type == "cuda":
        return _launch(x, w, tile_group, bm, n_tiles)
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, tile_group, bm=bm, n_tiles=n_tiles)
    raise ValueError(f"grouped_matmul runs on cuda or cpu, not {x.device}")


grouped_matmul.launches = 0
