"""Paged-KV decode attention (port of
``repro/kernels/paged_attention/paged_attention.py``).

Two hand-written Hopper kernels in ``csrc/paged_attention.cu`` (which
replace the Pallas ``_kernel`` / ``paged_attention`` and the in-flight
merge of ``decode_attend``; the source comment there gives their bound
and design): a split pass that cuts each lane's pages into
``split_plan``'s ranges and writes one f32 partial softmax state per
range, and a merge pass that merges them — with the in-flight token, for
``decode_attend`` — into the output.  On CUDA tensors ``paged_attention``
and ``decode_attend`` launch both (two launches a call) or raise; there
is no fallback.  On CPU tensors they run their plain twins,
``paged_attention_plain`` and ``decode_attend_plain``.
``paged_attention.launches`` counts split launches (one a call),
``paged_attention.merge_launches`` merge launches.

The pages may be of q's dtype or ``float8_e4m3fn`` (a KV cache stored in
fp8, ``cfg.kv_dtype``): the split kernel widens fp8 pages exactly, as
the reference casts them to f32, and the plain twins do the same.

``paged_attention_split_plain`` does in PyTorch what the two kernels do
(the same partition into ranges, the partial states and their merge), so
the CPU tests hold that arithmetic against the JAX kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
FP8 = torch.float8_e4m3fn        # the one page dtype besides q's
_HEAD_DIMS = (64, 112, 128)
_PAGE_SIZES = (4, 8, 16)
STAGE_TOKENS = 64        # tokens a stage of the kernel's ring holds
ROWS = 16                # query heads a block of the split pass holds
BLOCKS_PER_SM = 4        # split-pass blocks the plan aims for, per SM


def _window_lo(ln, w: int):
    """First valid cached position for a query at position ``ln`` under
    sliding window ``w`` (0 = global).  Kept independent of
    ``ref._window_lo`` so the parity tests stay meaningful."""
    return ln - w + 1 if w > 0 else torch.zeros_like(ln)


def split_span(n_pages: int, n_split: int) -> tuple[int, int]:
    """``(n_split, pages_per_split)`` of a cut of ``[0, n_pages)`` into at
    most ``n_split`` contiguous ranges of ``pages_per_split`` pages (the
    last one shorter); ranges that would be empty are dropped, so
    ``n_split`` may come back smaller."""
    n_pages, n_split = max(int(n_pages), 1), max(int(n_split), 1)
    pps = -(-n_pages // n_split)
    return -(-n_pages // pps), pps


def split_plan(n_pages: int, page: int, B: int, Hkv: int, n_rep: int,
               sm_count: int) -> tuple[int, int]:
    """``(n_split, pages_per_split)`` for the split pass, from shapes alone
    (it reads no tensor, so the wrapper reads nothing back from the card).

    The grid has ``B * Hkv * ceil(n_rep / 16)`` blocks a range.  The plan
    takes enough ranges for about ``BLOCKS_PER_SM`` blocks an SM: the
    ranges past a lane's length (or before its window) are empty and exit
    at once, and the rest should still fill every SM; more ranges cost
    the merge pass more partial states to read (4 was the fastest of 2,
    4, 8 and 16 at the long, hymba, arctic and kimi shapes on an H100:
    ``tools/k1_split_sweep.py``).  Each range is a whole
    number of 64-token ring stages, so only a lane's own edges leave a
    stage part-empty.  No more pages than one stage holds give one
    range."""
    stage_pages = max(STAGE_TOKENS // page, 1)
    base = max(B * Hkv * -(-n_rep // ROWS), 1)
    want = max(-(-BLOCKS_PER_SM * sm_count // base), 1)
    pps = -(-max(n_pages, 1) // want)
    pps = -(-pps // stage_pages) * stage_pages
    return -(-max(n_pages, 1) // pps), pps


def split_ranges(n_pages: int, pages_per_split: int) -> list:
    """The page ranges ``[start, stop)`` of a cut of ``[0, n_pages)`` into
    ranges of ``pages_per_split`` pages, in order (the last one may be
    shorter)."""
    pps = int(pages_per_split)
    return [(start, min(start + pps, n_pages))
            for start in range(0, max(n_pages, 1), pps)]


def _lift(k_pages, v_pages, layer):
    """4-D single-plane pages -> one layered plane; checks ``layer``."""
    if k_pages.dim() == 4 and isinstance(layer, int) and layer != 0:
        raise ValueError(
            f"4-D pages have only plane 0, got layer={layer} — a "
            f"calling-convention mix-up (layered pools are 5-D)")
    if k_pages.dim() == 4:            # single-layer pool: lift to one plane
        return k_pages[None], v_pages[None], 0
    if layer is None:
        raise ValueError("layered k_pages needs a layer index")
    return k_pages, v_pages, int(layer)


def _scores(q, k_pages, v_pages, page_tables, lengths, layer, window):
    """Every cached position's f32 score, value and validity:
    ``(s (B, Hkv, n_rep, S), v (B, S, Hkv, D), valid (B, 1, 1, S))``."""
    B, H, D = q.shape
    kp, vp = k_pages[layer].float(), v_pages[layer].float()   # fp8: exact
    Hkv = kp.shape[2]
    idx = page_tables.long()
    k = kp[idx].reshape(B, -1, Hkv, D)                   # (B, S, Hkv, D)
    v = vp[idx].reshape(B, -1, Hkv, D)
    qg = q.reshape(B, Hkv, H // Hkv, D).float()
    s = torch.einsum("bgrd,bsgd->bgrs", qg, k) * (1.0 / math.sqrt(D))
    pos = torch.arange(k.shape[1], device=q.device)
    ln = lengths.long()[:, None]
    valid = ((pos[None, :] < ln) & (pos[None, :] >= _window_lo(ln, window))
             )[:, None, None, :]
    return s, v, valid


def _state(s, v, valid):
    """Unnormalised online-softmax state of the valid scores:
    ``(acc (B, Hkv, n_rep, D), m, l (B, Hkv, n_rep, 1))``; no valid score
    gives (0, -1e30, 0)."""
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    return torch.einsum("bgrs,bsgd->bgrd", p, v), m, p.sum(-1, keepdim=True)


def paged_attention_plain(q, k_pages, v_pages, page_tables, lengths, *,
                          layer: int, window: int = 0):
    """The oracle on layered pages (L, P, page, Hkv, D): returns ``(o (B,
    H, D) in q's dtype, m (B, H, 1) f32, l (B, H, 1) f32)`` — the online
    softmax state written as one softmax over every valid cached
    position.  An empty lane gives (0, -1e30, 0)."""
    B, H, D = q.shape
    acc, m, l = _state(*_scores(q, k_pages, v_pages, page_tables, lengths,
                                layer, window))
    o = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return (o.reshape(B, H, D), m.reshape(B, H, 1), l.reshape(B, H, 1))


def split_partials_plain(q, k_pages, v_pages, page_tables, lengths, *,
                         layer: int, window: int = 0, n_split: int):
    """The split pass's plain twin: for each range of
    ``split_span(n_pages, n_split)`` the f32 partial state of the valid
    positions inside it, ``(acc (B, H, n, D), m (B, H, n), l (B, H, n))``
    (acc unnormalised; a range with no valid position gives (0, -1e30,
    0))."""
    B, H, D = q.shape
    page = k_pages.shape[2]
    s, v, valid = _scores(q, k_pages, v_pages, page_tables, lengths, layer,
                          window)
    pos = torch.arange(s.shape[-1], device=q.device)
    parts = []
    n_pages = page_tables.shape[1]
    pps = split_span(n_pages, n_split)[1]
    for start, stop in split_ranges(n_pages, pps):
        inside = (pos >= start * page) & (pos < stop * page)
        acc, m, l = _state(s, v, valid & inside)
        parts.append((acc.reshape(B, H, D), m.reshape(B, H),
                      l.reshape(B, H)))
    acc, m, l = (torch.stack(t, dim=2) for t in zip(*parts))
    return acc, m, l


def merge_partials_plain(acc, m, l, q, k_new=None, v_new=None):
    """The merge pass's plain twin: merges the partial states (acc (B, H,
    n, D), m, l (B, H, n)) into ``(o (B, H, D) in q's dtype, m (B, H, 1),
    l (B, H, 1))``; with the in-flight token ``k_new``/``v_new`` (B, Hkv,
    D), folds it into that state as the reference does and returns o."""
    B, H, D = q.shape
    M = m.amax(-1, keepdim=True)                          # (B, H, 1)
    w = torch.exp(m - M)
    L = (l * w).sum(-1, keepdim=True)
    A = torch.einsum("bhn,bhnd->bhd", w, acc)
    o = (A / L.clamp_min(1e-30)).to(q.dtype)
    if k_new is None:
        return o, M, L
    return _merge_token(q, o, M, L, k_new, v_new)


def _merge_token(q, o, m, l, k_new, v_new):
    """The reference's in-flight merge step: the cached state (o in q's
    dtype, m, l (B, H, 1) f32) and the token at position ``lengths[b]``
    in one online-softmax step, in f32; o (B, H, D) in q's dtype."""
    B, H, D = q.shape
    n_rep = H // k_new.shape[1]
    kn = k_new.float().repeat_interleave(n_rep, dim=1)
    vn = v_new.float().repeat_interleave(n_rep, dim=1)
    s_new = (q.float() * kn).sum(-1, keepdim=True) * (1.0 / math.sqrt(D))
    m2 = torch.maximum(m, s_new)
    alpha, p = torch.exp(m - m2), torch.exp(s_new - m2)
    o2 = (o.float() * (l * alpha) + p * vn) / (l * alpha + p).clamp_min(1e-30)
    return o2.to(q.dtype)


def paged_attention_split_plain(q, k_pages, v_pages, page_tables, lengths,
                                *, layer: int, window: int = 0,
                                n_split: int):
    """What the two kernels compute, in PyTorch: the partial states of
    the ranges of ``split_span(n_pages, n_split)`` merged into ``(o, m,
    l)`` as ``paged_attention_plain`` returns them."""
    parts = split_partials_plain(q, k_pages, v_pages, page_tables, lengths,
                                 layer=layer, window=window, n_split=n_split)
    return merge_partials_plain(*parts, q)


def decode_attend_plain(q, k_new, v_new, k_pages, v_pages, page_tables,
                        lengths, *, layer: int, window: int = 0):
    """``decode_attend``'s plain twin on layered pages: the state of the
    valid cached positions in one f32 softmax (``paged_attention_plain``,
    o in q's dtype), then the reference's merge step for the in-flight
    token (always attended), in f32."""
    o, m, l = paged_attention_plain(q, k_pages, v_pages, page_tables,
                                    lengths, layer=layer, window=window)
    return _merge_token(q, o, m, l, k_new, v_new)


def _library() -> ctypes.CDLL:
    """The kernels' shared library (built at first use), with the C
    signatures declared."""
    lib = build.load("paged_attention")
    split, merge = lib.mars_paged_attention_split, \
        lib.mars_paged_attention_merge
    if split.argtypes is None:            # first use: declare once
        i, p, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        split.restype = merge.restype = i
        split.argtypes = ([i] * 2 + [p] * 8 + [i] * 8 + [ll, i, i,
                                                         ctypes.c_float, p])
        merge.argtypes = ([i] + [p] * 3 + [i] + [p] * 3 + [ll] * 4
                          + [p] * 3 + [i] * 4 + [ctypes.c_float, i, p])
        err = lib.mars_cuda_error_string
        err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(rc: int, lib, what: str) -> None:
    if rc != 0:
        why = lib.mars_cuda_error_string(rc).decode() if rc > 0 \
            else "unsupported"
        raise RuntimeError(f"{what} kernel launch failed: rc={rc} ({why})")


def _check_operands(q, k_pages, v_pages, page_tables, lengths, layer: int):
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
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != v_pages.dtype \
            or k_pages.dtype not in (q.dtype, FP8):
        raise TypeError(
            f"paged_attention kernel takes float32 or bfloat16 q and K/V "
            f"pages of one dtype, q's or {FP8}; got q {q.dtype}, pages "
            f"{k_pages.dtype}/{v_pages.dtype}")
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
    if B > 65535:
        raise ValueError(f"{B} lanes: the grid takes at most 65535")


def _launch(q, k_pages, v_pages, page_tables, lengths, layer: int,
                  window: int, n_split=None):
    """Check operands and launch the split pass on the current stream:
    returns the partial states ``(acc (B, H, n, D), m, l (B, H, n))``,
    f32, where ``n`` is ``split_plan``'s count (or ``split_span`` of
    ``n_split``, when given)."""
    _check_operands(q, k_pages, v_pages, page_tables, lengths, layer)
    B, H, D = q.shape
    L, P, page, Hkv, _ = k_pages.shape
    n_pages = page_tables.shape[1]
    lib = _library()
    if n_split is None:
        n, pps = split_plan(n_pages, page, B, Hkv, H // Hkv,
                            _sm_count(q.device.index or 0))
    else:
        n, pps = split_span(n_pages, n_split)
    dev = q.device
    acc = torch.empty((B, H, n, D), dtype=torch.float32, device=dev)
    m = torch.empty((B, H, n), dtype=torch.float32, device=dev)
    l = torch.empty((B, H, n), dtype=torch.float32, device=dev)
    if B == 0:
        return acc, m, l
    rc = lib.mars_paged_attention_split(
        _DTYPE_CODES[q.dtype], int(k_pages.dtype == FP8),
        q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_tables.data_ptr(), lengths.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), B, H, Hkv, D, page,
        n_pages, n, pps, P * page * Hkv * D, layer, window,
        1.0 / math.sqrt(D), torch.cuda.current_stream(dev).cuda_stream)
    _check(rc, lib, "paged_attention split")
    paged_attention.launches += 1
    return acc, m, l


def _launch_merge(acc, m, l, q, k_new=None, v_new=None):
    """Launch the merge pass on the current stream: o (B, H, D) in q's
    dtype with the in-flight token folded in, or ``(o, m, l)`` without
    one."""
    B, H, D = q.shape
    n = acc.shape[2]
    dev = q.device
    decode = k_new is not None
    if q.dtype not in _DTYPE_CODES or D not in _HEAD_DIMS \
            or not q.is_contiguous():
        raise ValueError(f"merge kernel takes contiguous float32 or "
                         f"bfloat16 q with head_dim in {_HEAD_DIMS}; got "
                         f"{q.dtype} {tuple(q.shape)}")
    for name, t, shape in (("acc", acc, (B, H, n, D)), ("m", m, (B, H, n)),
                           ("l", l, (B, H, n))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or t.device != dev or not t.is_contiguous():
            raise ValueError(f"partial {name} must be contiguous float32 "
                             f"{shape} on {dev}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if decode:
        for name, t in (("k_new", k_new), ("v_new", v_new)):
            if t.device != dev or t.dtype != q.dtype or t.dim() != 3 \
                    or t.shape[0] != B or t.shape[2] != D \
                    or H % t.shape[1] or t.stride(-1) != 1:
                raise ValueError(
                    f"{name} must be (B, Hkv, D) of q's dtype on q's device "
                    f"with a contiguous last dimension; got "
                    f"{tuple(t.shape)} {t.dtype} {t.device}, strides "
                    f"{t.stride()}")
        if v_new.shape != k_new.shape:
            raise ValueError(f"k_new {tuple(k_new.shape)} and v_new "
                             f"{tuple(v_new.shape)} differ")
    o = torch.empty_like(q)
    m_out = l_out = None
    if not decode:
        m_out = torch.empty((B, H, 1), dtype=torch.float32, device=dev)
        l_out = torch.empty((B, H, 1), dtype=torch.float32, device=dev)
    if B == 0:
        return o if decode else (o, m_out, l_out)
    lib = _library()
    Hkv = k_new.shape[1] if decode else 1
    kn, vn = (k_new, v_new) if decode else (q, q)
    rc = lib.mars_paged_attention_merge(
        _DTYPE_CODES[q.dtype], acc.data_ptr(), m.data_ptr(), l.data_ptr(), n,
        q.data_ptr(), kn.data_ptr(), vn.data_ptr(), kn.stride(0),
        kn.stride(1), vn.stride(0), vn.stride(1), o.data_ptr(),
        0 if decode else m_out.data_ptr(), 0 if decode else l_out.data_ptr(),
        B, H, Hkv, D, 1.0 / math.sqrt(D), int(decode),
        torch.cuda.current_stream(dev).cuda_stream)
    _check(rc, lib, "paged_attention merge")
    paged_attention.merge_launches += 1
    return o if decode else (o, m_out, l_out)


def paged_attention_partials(q, k_pages, v_pages, page_tables, lengths, *,
                             layer=None, window=0, n_split=None):
    """The split pass alone: ``(acc (B, H, n, D), m, l (B, H, n))`` f32
    partial states (CUDA: the kernel; CPU: ``split_partials_plain``).
    ``n_split`` forces the ranges of ``split_span(n_pages, n_split)``, as
    the tests do to reach range edges; None takes ``split_plan``'s on
    CUDA (the CPU twin needs it given)."""
    k_pages, v_pages, layer = _lift(k_pages, v_pages, layer)
    if q.device.type == "cuda":
        return _launch(q, k_pages, v_pages, page_tables, lengths,
                             layer, int(window), n_split)
    if q.device.type == "cpu":
        return split_partials_plain(q, k_pages, v_pages, page_tables,
                                    lengths, layer=layer, window=int(window),
                                    n_split=n_split)
    raise ValueError(f"paged_attention runs on cuda or cpu, not {q.device}")


def merge_partials(acc, m, l, q, k_new=None, v_new=None):
    """The merge pass alone (CUDA: the kernel; CPU:
    ``merge_partials_plain``)."""
    if q.device.type == "cuda":
        return _launch_merge(acc, m, l, q, k_new, v_new)
    if q.device.type == "cpu":
        return merge_partials_plain(acc, m, l, q, k_new, v_new)
    raise ValueError(f"paged_attention runs on cuda or cpu, not {q.device}")


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

    CUDA tensors launch the split and merge kernels (block ids in
    ``page_tables`` must lie inside the pool: the kernel does not clamp
    them); CPU tensors run ``paged_attention_plain``.
    """
    k_pages, v_pages, layer = _lift(k_pages, v_pages, layer)
    window = int(window)
    if q.device.type == "cuda":
        parts = _launch(q, k_pages, v_pages, page_tables, lengths, layer,
                        window)
        o, m, l = _launch_merge(*parts, q)
    elif q.device.type == "cpu":
        o, m, l = paged_attention_plain(q, k_pages, v_pages, page_tables,
                                        lengths, layer=layer, window=window)
    else:
        raise ValueError(f"paged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return (o, m, l) if return_state else o


paged_attention.launches = 0
paged_attention.merge_launches = 0


def decode_attend(q, k_new, v_new, k_pages, v_pages, page_tables, lengths,
                  *, layer=0, window=0):
    """Decode-step attention: the cached pages plus the in-flight token
    (position ``lengths[b]``, always attended).

    q: (B, H, D); k_new/v_new: (B, Hkv, D).  Returns (B, H, D).  A lane
    with ``lengths[b] == 0`` reduces to attending the token alone.  CUDA
    tensors launch the split pass and the merge pass, which merges the
    f32 partial states and folds the token in (two launches); CPU
    tensors run ``decode_attend_plain``.
    """
    k_pages, v_pages, layer = _lift(k_pages, v_pages, layer)
    window = int(window)
    if q.device.type == "cuda":
        parts = _launch(q, k_pages, v_pages, page_tables, lengths, layer,
                        window)
        return _launch_merge(*parts, q, k_new, v_new)
    if q.device.type == "cpu":
        return decode_attend_plain(q, k_new, v_new, k_pages, v_pages,
                                   page_tables, lengths, layer=layer,
                                   window=window)
    raise ValueError(f"decode_attend runs on cuda or cpu, not {q.device}")
