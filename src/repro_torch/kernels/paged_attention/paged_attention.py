"""Paged-KV decode attention (port of
``repro/kernels/paged_attention/paged_attention.py``).

``paged_attention`` is the wrapper around the hand-written Hopper kernel
``csrc/paged_attention.cu`` (which replaces the Pallas ``_kernel`` /
``paged_attention``; the source comment there gives its bound and
design).  On CUDA tensors it launches the kernel or raises — there is no
fallback; on CPU tensors it runs ``paged_attention_plain``, the kernel's
plain PyTorch twin, which the CPU tests and ``chip_smoke.py`` compare
against.  ``paged_attention.launches`` counts kernel launches.

``decode_attend`` is the full decode-step attention: the paged pass over
the cached pages plus one online-softmax merge step folding in the
in-flight token's K/V (not in the pool yet — the backend writes it back
after the step), done in torch as the reference does outside its kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_PAGE_SIZES = (4, 8, 16)


def _window_lo(ln, w: int):
    """First valid cached position for a query at position ``ln`` under
    sliding window ``w`` (0 = global).  Kept independent of
    ``ref._window_lo`` so the parity tests stay meaningful."""
    return ln - w + 1 if w > 0 else torch.zeros_like(ln)


def paged_attention_plain(q, k_pages, v_pages, page_tables, lengths, *,
                          layer: int, window: int = 0):
    """The kernel's plain twin on layered pages (L, P, page, Hkv, D):
    returns ``(o (B, H, D) in q's dtype, m (B, H, 1) f32, l (B, H, 1)
    f32)`` — the online-softmax state of the kernel written as one
    softmax over every valid cached position.  An empty lane gives
    (0, -1e30, 0)."""
    B, H, D = q.shape
    kp, vp = k_pages[layer], v_pages[layer]
    Hkv = kp.shape[2]
    n_rep = H // Hkv
    idx = page_tables.long()
    k = kp[idx].reshape(B, -1, Hkv, D).float()          # (B, S, Hkv, D)
    v = vp[idx].reshape(B, -1, Hkv, D).float()
    qg = q.reshape(B, Hkv, n_rep, D).float()
    s = torch.einsum("bgrd,bsgd->bgrs", qg, k) * (1.0 / math.sqrt(D))
    pos = torch.arange(k.shape[1], device=q.device)
    ln = lengths.long()[:, None]
    valid = ((pos[None, :] < ln) & (pos[None, :] >= _window_lo(ln, window))
             )[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bgrs,bsgd->bgrd", p, v)
    o = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return (o.reshape(B, H, D), m.reshape(B, H, 1), l.reshape(B, H, 1))


def _library() -> ctypes.CDLL:
    """The kernel's shared library (built at first use), with the C
    signatures declared."""
    lib = build.load("paged_attention")
    fn = lib.mars_paged_attention
    if fn.argtypes is None:               # first use: declare once
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 6 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_void_p])
        err = lib.mars_cuda_error_string
        err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
    return lib


def _launch(q, k_pages, v_pages, page_tables, lengths, layer: int,
            window: int):
    """Check operands and launch the CUDA kernel on the current stream."""
    B, H, D = q.shape
    L, P, page, Hkv, Dk = k_pages.shape
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_tables", page_tables), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_tables", page_tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(
            f"paged_attention kernel takes float32 or bfloat16 q and pages "
            f"of q's dtype; got q {q.dtype}, pages {k_pages.dtype}/"
            f"{v_pages.dtype}")
    if page_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_tables and lengths must be int32")
    if v_pages.shape != k_pages.shape or Dk != D or H % Hkv \
            or page_tables.dim() != 2 or page_tables.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, page_tables "
            f"{tuple(page_tables.shape)}, lengths {tuple(lengths.shape)}")
    if D not in _HEAD_DIMS or page not in _PAGE_SIZES:
        raise ValueError(f"kernel built for head_dim in {_HEAD_DIMS} and "
                         f"page in {_PAGE_SIZES}; got {D}, {page}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside the pool's {L} planes")
    o = torch.empty_like(q)
    m = torch.empty((B, H, 1), dtype=torch.float32, device=dev)
    l = torch.empty((B, H, 1), dtype=torch.float32, device=dev)
    if B == 0:
        return o, m, l
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.mars_paged_attention(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_tables.data_ptr(), lengths.data_ptr(),
        o.data_ptr(), m.data_ptr(), l.data_ptr(), B, H, Hkv, D, page,
        page_tables.shape[1], P * page * Hkv * D, layer, window,
        1.0 / math.sqrt(D), stream)
    if rc != 0:
        why = lib.mars_cuda_error_string(rc).decode() if rc > 0 \
            else "unsupported"
        raise RuntimeError(f"paged_attention kernel launch failed: rc={rc} "
                           f"({why})")
    paged_attention.launches += 1
    return o, m, l


def paged_attention(q, k_pages, v_pages, page_tables, lengths, *,
                    layer=None, window=0, return_state: bool = False):
    """q: (B, H, D); k/v_pages: (P, page, Hkv, D) or, for a layered block
    pool, (L, P, page, Hkv, D) with ``layer`` selecting the plane;
    page_tables: (B, n_pages) int32; lengths: (B,) int32.  ``window`` > 0
    restricts each query to the last ``window`` positions (query at
    ``lengths[b]`` included); 0 attends all cached positions.

    Returns (B, H, D), or with ``return_state`` the online-softmax state
    ``(o, m, l)`` (m/l: (B, H, 1) float32).  A lane whose window admits
    no cached position comes back as (o=0, m=-1e30, l=0).

    CUDA tensors launch the Hopper kernel (block ids in ``page_tables``
    must lie inside the pool: the kernel does not clamp them); CPU
    tensors run the plain twin.
    """
    if k_pages.dim() == 4 and isinstance(layer, int) and layer != 0:
        raise ValueError(
            f"4-D pages have only plane 0, got layer={layer} — a "
            f"calling-convention mix-up (layered pools are 5-D)")
    if k_pages.dim() == 4:            # single-layer pool: lift to one plane
        k_pages, v_pages, layer = k_pages[None], v_pages[None], 0
    if layer is None:
        raise ValueError("layered k_pages needs a layer index")
    layer, window = int(layer), int(window)
    if q.device.type == "cuda":
        o, m, l = _launch(q, k_pages, v_pages, page_tables, lengths, layer,
                          window)
    elif q.device.type == "cpu":
        o, m, l = paged_attention_plain(q, k_pages, v_pages, page_tables,
                                        lengths, layer=layer, window=window)
    else:
        raise ValueError(f"paged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return (o, m, l) if return_state else o


paged_attention.launches = 0


def decode_attend(q, k_new, v_new, k_pages, v_pages, page_tables, lengths,
                  *, layer=0, window=0):
    """Decode-step attention: ``paged_attention`` over the cached pages
    plus one online-softmax merge step for the in-flight token (position
    ``lengths[b]``, always attended).

    q: (B, H, D); k_new/v_new: (B, Hkv, D).  Returns (B, H, D).  A lane
    with ``lengths[b] == 0`` reduces to attending the token alone.
    """
    B, H, D = q.shape
    Hkv = k_new.shape[1]
    n_rep = H // Hkv
    o, m, l = paged_attention(q, k_pages, v_pages, page_tables, lengths,
                              layer=layer, window=window, return_state=True)
    qg = q.reshape(B, Hkv, n_rep, D).float()
    s_new = torch.einsum("bhrd,bhd->bhr", qg, k_new.float()) \
        * (1.0 / math.sqrt(D))
    s_new = s_new.reshape(B, H, 1)
    m2 = torch.maximum(m, s_new)
    alpha = torch.exp(m - m2)
    p = torch.exp(s_new - m2)
    l2 = l * alpha + p
    v_rep = v_new.repeat_interleave(n_rep, dim=1).float()   # (B, H, D)
    o2 = (o.float() * (l * alpha) + p * v_rep) / l2.clamp_min(1e-30)
    return o2.to(q.dtype)
