"""SSD (Mamba2) chunked scan (port of ``repro/kernels/ssd_scan/
ssd_scan.py``).

``ssd_scan`` is the wrapper around the hand-written Hopper kernel
``csrc/ssd_scan.cu`` (which replaces the Pallas ``_kernel`` /
``ssd_scan``; the source comment there gives its bound and design).  On
CUDA tensors it launches the kernel or raises — there is no fallback; on
CPU tensors it runs ``ssd_scan_plain``, the kernel's plain PyTorch twin:
the same chunked math in float32, which the CPU tests and
``chip_smoke.py`` compare against.  ``ssd_scan.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 64                    # the kernel's largest chunk
_SMEM_LIMIT = 232_448             # bytes of shared memory a block may use


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


def _library() -> ctypes.CDLL:
    """The kernel's shared library (built at first use), with the C
    signatures declared."""
    lib = build.load("ssd_scan")
    fn = lib.mars_ssd_scan
    if fn.argtypes is None:               # first use: declare once
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        err = lib.mars_cuda_error_string
        err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
    return lib


def smem_bytes(q: int, P: int, N: int) -> int:
    """Shared memory one block of the kernel takes (mirrors
    ``smem_floats`` in ``csrc/ssd_scan.cu``)."""
    return 4 * (q * P + 2 * q * (N + 1) + q * q + P * (N + 1) + 4 * q)


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
    if smem_bytes(q, P, N) > _SMEM_LIMIT:
        raise ValueError(f"ssd_scan kernel needs {smem_bytes(q, P, N)} B of "
                         f"shared memory for q={q}, P={P}, N={N}; a block "
                         f"has {_SMEM_LIMIT}")
    y = torch.empty((Bz, S, H, P), dtype=torch.float32, device=dev)
    state = torch.empty((Bz, H, P, N), dtype=torch.float32, device=dev)
    if Bz == 0 or H == 0 or P == 0:
        return y, state
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.mars_ssd_scan(
        _DTYPE_CODES[x.dtype], x.data_ptr(), b.data_ptr(), c.data_ptr(),
        la.data_ptr(), dt.data_ptr(), y.data_ptr(), state.data_ptr(),
        Bz, S, H, P, N, q, stream)
    if rc != 0:
        why = lib.mars_cuda_error_string(rc).decode() if rc > 0 \
            else "unsupported"
        raise RuntimeError(f"ssd_scan kernel launch failed: rc={rc} ({why})")
    ssd_scan.launches += 1
    return y, state


def ssd_scan(x, b, c, la, dt, *, chunk: int = 64):
    """x: (B,S,H,P); b,c: (B,S,N); la,dt: (B,S,H) (la is the per-step log
    decay ``dt * A``).  Returns ``(y (B,S,H,P) float32, final state
    (B,H,P,N) float32)``, starting from a zero state.  The chunk length
    is ``q = min(chunk, S)`` and must divide S.

    CUDA tensors launch the Hopper kernel (x, b and c of one dtype,
    float32 or bfloat16; la and dt float32; contiguous; q <= 64); CPU
    tensors run the plain twin."""
    Bz, S, H, P = x.shape
    N = b.shape[-1]
    if tuple(b.shape) != (Bz, S, N) or tuple(c.shape) != (Bz, S, N) \
            or tuple(la.shape) != (Bz, S, H) or tuple(dt.shape) != (Bz, S, H):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, b {tuple(b.shape)}, c "
            f"{tuple(c.shape)}, la {tuple(la.shape)}, dt {tuple(dt.shape)}")
    q = chunk_len(S, chunk)
    if x.device.type == "cuda":
        return _launch(x, b, c, la, dt, q)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, b, c, la, dt, chunk=chunk)
    raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")


ssd_scan.launches = 0
