"""Core transformer building blocks (port of ``repro/models/layers.py``,
the subset the dense, hybrid, MoE, pure-SSM, encoder-decoder and VLM
families use).

Pure functions over a parameter tree whose layout matches the
reference's (``wq (d, H, dh)``, ``wo (H, dh, d)``, ...), so weights
convert leaf for leaf (``repro_torch.convert``).  The tree is a nested
``nn.ModuleDict`` of ``nn.ParameterDict`` (``as_module``) so
``.to(device)`` moves it; functions index it like the reference's dicts.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.sharding import dtensor

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameter tree
# ---------------------------------------------------------------------------

def as_module(tree: dict) -> nn.Module:
    """Nested dict of tensors -> nested ``ModuleDict``/``ParameterDict``
    (frozen parameters).  A dict of sub-dicts only becomes a
    ``ModuleDict``; one with leaves a ``ParameterDict``, which also holds
    its sub-dicts as modules (an MoE layer's ``shared`` expert sits beside
    its expert weights, as in the reference)."""
    if any(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False)
             if isinstance(v, torch.Tensor) else as_module(v)
             for k, v in tree.items()})
    return nn.ModuleDict({k: as_module(v) for k, v in tree.items()})


# elements of one float32 draw (256 MB): a larger tensor is drawn in
# slices along its leading axes, so the init's temporary stays about one
# expert matrix (arctic-480b's (L, E, d, e) = (2, 128, 7168, 4864)
# expert weights would take a 36 GB float32 temporary drawn whole)
_DRAW_ELEMS = 1 << 26


class Specs:
    """Stands in for the generator of the init functions, which then
    return each parameter's logical axes (a tuple of names, ``("layers",)``
    first on a stacked leaf) in place of the tensor: the reference's
    ``ParamBundle.specs``, laid out by the same code as the leaves."""
    device = torch.device("meta")


SPECS = Specs()


class LocalDraw:
    """Stands in for the generator ``gen`` of the init functions, which
    then make only the part ``region(axes, shape)`` of each parameter (a
    (start, stop) pair per dimension of the whole leaf): the whole leaf's
    draws are walked from ``gen`` in the same order and the part that
    falls in the region kept, so the slice is bitwise that of the
    one-process init from the same seed, with a temporary of at most
    ``_DRAW_ELEMS`` elements.  On a CUDA generator a draw that falls
    outside the region is not made: the generator's Philox offset is
    moved on by what a draw of that many elements advances it
    (``steps``, read off the first such draw made), so a rank makes about
    its part of the draws.  A CPU generator has no offset to move and
    makes every draw."""

    def __init__(self, gen: torch.Generator, region):
        self.gen, self.region = gen, region
        self.steps = {} if gen.device.type == "cuda" else None

    @property
    def device(self):
        return self.gen.device


def _whole(shape) -> tuple:
    return tuple((0, n) for n in shape)


def _fill_normal(out: torch.Tensor, gen: torch.Generator, scale: float,
                 shape, region, steps=None):
    """Draw ``normal * scale`` over a leaf of ``shape`` in the order of
    its draws (one draw up to ``_DRAW_ELEMS`` elements, else slices along
    the leading axes) and write into ``out`` the part each draw has in
    ``region``, the leaf's part that ``out`` holds.  With ``steps`` (a
    dict: elements of a draw -> the offset it moves ``gen`` on) a draw
    with no part in ``region`` of a size already seen only moves the
    offset."""
    if out.is_meta:                   # a layout only: nothing to draw
        return

    def walk(starts, sizes, dropped):
        ndim = len(sizes) - dropped
        if math.prod(sizes) <= _DRAW_ELEMS or ndim == 1:
            src, dst = [], []
            for s, n, (lo, hi) in zip(starts, sizes, region):
                a, b = max(s, lo), min(s + n, hi)
                src.append(slice(a - s, b - s))
                dst.append(slice(a - lo, b - lo))
            outside = any(sl.start >= sl.stop for sl in src)
            n = math.prod(sizes)
            if outside and steps is not None and n in steps:
                gen.set_offset(gen.get_offset() + steps[n])
                return
            before = gen.get_offset() if steps is not None else 0
            piece = torch.randn(sizes[dropped:], generator=gen,
                                dtype=torch.float32,
                                device=out.device).mul_(scale)
            if steps is not None:
                steps[n] = gen.get_offset() - before
            if not outside:
                out[tuple(dst)].copy_(piece.view(sizes)[tuple(src)])
            return
        rows = _DRAW_ELEMS // math.prod(sizes[dropped + 1:])
        for i in range(0, sizes[dropped], max(rows, 1)):
            s2, z2 = list(starts), list(sizes)
            s2[dropped] += i
            z2[dropped] = min(rows, sizes[dropped] - i) if rows > 1 else 1
            walk(s2, z2, dropped + (rows <= 1))
    walk([0] * len(shape), list(shape), 0)


def _normal(gen: torch.Generator, shape, dtype, scale: float, region=None,
            steps=None):
    """``normal * scale`` of ``shape`` (its part ``region``, default all
    of it), drawn in float32 and stored in ``dtype``.  A tensor of at
    most ``_DRAW_ELEMS`` elements is one draw (as the reference's
    ``_dense_init``); a larger one is drawn into the preallocated output
    slice by slice.  ``steps``: ``LocalDraw.steps``."""
    region = region or _whole(shape)
    out = torch.empty([b - a for a, b in region], dtype=dtype,
                      device=gen.device)
    _fill_normal(out, gen, scale, shape, region, steps)
    return out


def _axes(axes, stack: int) -> tuple:
    return (("layers",) if stack else ()) + tuple(axes)


def _layout(gen, shape, axes, stack: int):
    """(the whole leaf's shape, its axes, the part to make) of one
    parameter; the part is the whole leaf unless ``gen`` is a
    ``LocalDraw``."""
    full = ((stack,) if stack else ()) + tuple(shape)
    axes = _axes(axes, stack)
    region = gen.region(axes, full) if isinstance(gen, LocalDraw) \
        else _whole(full)
    return full, axes, region


def _dense_init(gen, shape, dtype, axes, scale: float | None = None,
                stack: int = 0):
    """``normal * scale`` (``_normal``) with the reference's default
    scale ``1/sqrt(fan_in)`` (``fan_in = shape[0]``); ``stack`` > 0 draws
    ``stack`` independent layers at once."""
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    full, axes, region = _layout(gen, shape, axes, stack)
    if isinstance(gen, Specs):
        return axes
    return _normal(getattr(gen, "gen", gen), full, dtype, scale, region,
                   getattr(gen, "steps", None))


def _const(gen, shape, dtype, axes, value: float, stack: int = 0):
    full, axes, region = _layout(gen, shape, axes, stack)
    if isinstance(gen, Specs):
        return axes
    return torch.full([b - a for a, b in region], value, dtype=dtype,
                      device=gen.device)


def _given(gen, shape, axes, make, stack: int = 0):
    """A parameter computed whole by ``make(full shape)`` (a few
    elements), or its part under a ``LocalDraw``."""
    full, axes, region = _layout(gen, shape, axes, stack)
    if isinstance(gen, Specs):
        return axes
    t = make(full)
    return t[tuple(slice(a, b) for a, b in region)].clone()


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def norm_init(cfg: ModelConfig, gen, stack: int = 0) -> dict:
    out = {"scale": _const(gen, (cfg.d_model,), cfg.pdtype, ("embed",), 1.0,
                           stack)}
    if cfg.norm == "ln":
        out["bias"] = _const(gen, (cfg.d_model,), cfg.pdtype, ("embed",),
                             0.0, stack)
    return out


def at_least_f32(x):
    """``x`` in float32, or as it is in float64: the model's float32
    islands (norms, dt, the skip term, attention and loss logits) stay
    float64 in a float64 step."""
    return x if x.dtype == torch.float64 else x.float()


def apply_norm(p, x, cfg: ModelConfig):
    x32 = at_least_f32(x)
    if cfg.norm == "ln":
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + cfg.norm_eps)
        return (y * at_least_f32(p["scale"])
                + at_least_f32(p["bias"])).to(x.dtype)
    var = (x32 ** 2).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + cfg.norm_eps)
    return (y * at_least_f32(p["scale"])).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(cfg: ModelConfig, positions: torch.Tensor) -> tuple:
    """positions: int[...]; returns (cos, sin) with trailing dim d_head/2."""
    d = cfg.d_head
    exps = torch.arange(0, d, 2, dtype=torch.float32,
                        device=positions.device) / d
    # the base is filled on the device: a host scalar copied there would
    # make the host wait for the stream at every layer of a decode step
    inv = 1.0 / torch.pow(torch.full((), cfg.rope_theta, dtype=torch.float32,
                                     device=positions.device), exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., S, H, d_head); cos/sin: (..., S, d_head/2)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA)
# ---------------------------------------------------------------------------

def attention_init(gen, cfg: ModelConfig, stack: int = 0) -> dict:
    d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    pd = cfg.pdtype
    q, kv = ("embed", "heads", "head"), ("embed", "kv_heads", "head")
    out = {
        "wq": _dense_init(gen, (d, H, dh), pd, q, stack=stack),
        "wk": _dense_init(gen, (d, K, dh), pd, kv, stack=stack),
        "wv": _dense_init(gen, (d, K, dh), pd, kv, stack=stack),
        "wo": _dense_init(gen, (H, dh, d), pd, ("heads", "head", "embed"),
                          scale=1.0 / math.sqrt(H * dh), stack=stack),
    }
    if cfg.qkv_bias:
        out["bq"] = _const(gen, (H, dh), pd, q[1:], 0.0, stack)
        out["bk"] = _const(gen, (K, dh), pd, kv[1:], 0.0, stack)
        out["bv"] = _const(gen, (K, dh), pd, kv[1:], 0.0, stack)
    return out


def _qkv(p, x, cfg: ModelConfig, positions=None):
    cd = cfg.cdtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cd))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(cd))
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    if cfg.use_rope and positions is not None:
        cos, sin = rope_freqs(cfg, positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    b, s, kh, dh = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, n_rep, dh) \
        .reshape(b, s, kh * n_rep, dh)


def _kv_for_heads(k, cfg: ModelConfig, tp):
    """K or V of the KV heads a layer holds, one per query head it
    computes: all of them, or under tensor parallelism (``tp``) this
    rank's query heads' from the KV heads ``tp.kv(cfg)`` it holds."""
    rep = cfg.n_heads // cfg.n_kv_heads
    if tp is None:
        return _repeat_kv(k, rep)
    (h0, h1), (k0, _) = tp.heads(cfg), tp.kv(cfg)
    idx = torch.arange(h0, h1, device=k.device) // rep - k0
    return k.index_select(2, idx)


# mask kind: plain causal attention with as many queries as keys
CAUSAL = "causal"


def sdpa(q, k, v, mask=None):
    """q:(B,Sq,H,dh) k,v:(B,Sk,H,dh).  ``mask`` is None (attend every
    key), ``CAUSAL`` (key <= query, Sq == Sk) or a bool tensor
    broadcastable to (B,H,Sq,Sk).  The caller names the kind, so nothing
    reads a mask back from the device: the first two run
    ``flash_attention`` — the Hopper kernel on CUDA tensors, its plain
    twin on CPU ones — and a tensor mask (a sliding window, a VLM's image
    prefix, the dense decode's cache mask) the plain masked softmax
    here."""
    if not torch.is_tensor(mask):
        from repro_torch.kernels.flash_attention.flash_attention import \
            flash_attention
        if mask not in (None, CAUSAL):
            raise ValueError(f"unknown mask kind {mask!r}")
        if q.shape[2] == 0:
            # a model rank with no heads launches nothing: zeros, tied to
            # q, k and v (empty sums) so that its backward reaches the
            # collectives the other ranks' backward runs
            return q.new_zeros(q.shape[:3] + v.shape[3:]) \
                + (q.sum() + k.sum() + v.sum())
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=mask == CAUSAL)
    logits = at_least_f32(torch.einsum("bqhd,bkhd->bhqk", q, k)) \
        * (1.0 / math.sqrt(q.shape[-1]))
    logits = torch.where(mask, logits, torch.full(
        (), NEG_INF, dtype=torch.float32, device=logits.device))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def causal_mask(sq: int, sk: int, window: int = 0, prefix_len=None,
                device=None):
    """bool[Sq, Sk] (True = attend).  ``sk - sq`` offsets queries to the
    cache tail; ``window`` > 0 restricts to a sliding window;
    ``prefix_len`` makes the first ``prefix_len`` keys visible to every
    query (a VLM's bidirectional image prefix)."""
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    if prefix_len is not None:
        m |= kpos < prefix_len
    return m


def attention_apply(p, x, cfg: ModelConfig, *, positions, mask,
                    kv_cache=None, cache_positions=None, xattn_kv=None):
    """Full attention layer.  Modes:
      - training/prefill: kv_cache is None -> self-attention over x
      - decode: kv_cache=(k,v) of shape (B,S,K,dh) -> write x's kv at
        ``cache_positions`` (a scalar, or one position per lane for
        ragged decode).  Unlike the reference's functional update the
        cache tensors are written **in place** (no cache-sized copy per
        token); they are also what ``new_kv`` returns.
      - cross: xattn_kv=(k,v) precomputed from the encoder (new_kv None)
    ``mask`` is a mask kind or tensor (see ``sdpa``).
    Returns (out, new_kv) where new_kv is (k, v) for cache maintenance.

    Under tensor parallelism (``dtensor.model_rank``) ``p`` holds this
    rank's heads and the KV heads they read, ``kv_cache`` and
    ``xattn_kv`` those KV heads (a cache cut by heads), x's gradient is
    summed over ``model`` and the row-parallel ``wo``'s output is summed
    over it.  A decode over a cache cut by sequence takes
    ``decode_seq_cut``.
    """
    cd = cfg.cdtype
    tp = dtensor.model_rank()
    if tp is not None:
        x = tp.sum_backward(x)
    if xattn_kv is not None:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cd))
        if cfg.qkv_bias:
            q = q + p["bq"].to(cd)
        k, v = xattn_kv
        new_kv = None
    else:
        q, k, v = _qkv(p, x, cfg, positions)
        new_kv = (k, v)
    if kv_cache is not None:
        ck, cv = kv_cache
        if cache_positions is None:
            k = torch.cat([ck, k], dim=1)
            v = torch.cat([cv, v], dim=1)
        else:
            s = k.shape[1]
            pos = torch.as_tensor(cache_positions, device=ck.device)
            # dynamic_update_slice semantics: the start clamps so the
            # update fits inside the cache
            pos = pos.clamp(0, ck.shape[1] - s).long()
            if pos.ndim:
                # ragged decode: one write position per sequence
                rows = torch.arange(ck.shape[0], device=ck.device)[:, None]
                cols = pos[:, None] + torch.arange(s, device=ck.device)
                ck[rows, cols] = k.to(ck.dtype)
                cv[rows, cols] = v.to(cv.dtype)
            elif tp is not None:
                # written on the device: no host read of the position
                cols = pos + torch.arange(s, device=ck.device)
                ck.index_copy_(1, cols, k.to(ck.dtype))
                cv.index_copy_(1, cols, v.to(cv.dtype))
            else:
                p0 = int(pos)
                ck[:, p0:p0 + s] = k.to(ck.dtype)
                cv[:, p0:p0 + s] = v.to(cv.dtype)
            k, v = ck, cv
        new_kv = (k, v)
        k = k.to(cd)   # low-precision cache reads upcast for compute
        v = v.to(cd)
    k = _kv_for_heads(k, cfg, tp)
    v = _kv_for_heads(v, cfg, tp)
    out = sdpa(q, k, v, mask)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(cd))
    if tp is not None:
        out = tp.sum_forward(out)
    return out, new_kv


def decode_seq_cut(p, x, cfg: ModelConfig, tp, *, positions, kv_cache,
                   pos, s0: int, mask):
    """One-token decode attention over a KV cache cut by sequence over
    ``model`` (flash-decoding; ``rules.cache_shardings`` where the KV
    heads do not divide the ranks).  This rank holds ``kv_cache`` (B,
    S/n, K, dh): positions ``s0 ..`` of every KV head.  The new token's q
    (of every head) and k, v (of every KV head) are put together over
    ``model`` from the ranks' heads; the rank holding position ``pos`` (a
    scalar or one a lane) writes k and v; every rank takes its partial
    max, sum and P·V over its positions in float32 (``mask`` (B, 1, 1,
    S/n) of them attended); these merge over ``model``, and each rank
    keeps its heads for the row-parallel ``wo``.  No gradient.  Returns
    (out (B, 1, d), (ck, cv))."""
    cd = cfg.cdtype
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = _qkv(p, x, cfg, positions)
    h0, h1 = tp.heads(cfg)
    q = tp.put_together(q, 2, (h0, h1), H)
    k, v = (tp.kv_heads_together(t, cfg, 2) for t in (k, v))
    ck, cv = kv_cache
    Sl = ck.shape[1]
    pos = torch.as_tensor(pos, device=ck.device).long()
    rows = torch.arange(ck.shape[0], device=ck.device)
    local = pos - s0
    inside = (local >= 0) & (local < Sl)
    at = torch.broadcast_to(local.clamp(0, Sl - 1), rows.shape)
    keep = torch.broadcast_to(inside, rows.shape)[:, None, None]
    ck[rows, at] = torch.where(keep, k[:, 0].to(ck.dtype), ck[rows, at])
    cv[rows, at] = torch.where(keep, v[:, 0].to(cv.dtype), cv[rows, at])
    kk = _repeat_kv(ck.to(cd), H // K)
    vv = _repeat_kv(cv.to(cd), H // K)
    logits = at_least_f32(torch.einsum("bqhd,bkhd->bhqk", q, kk)) \
        * (1.0 / math.sqrt(dh))
    logits = torch.where(mask, logits, torch.full(
        (), NEG_INF, dtype=torch.float32, device=logits.device))
    m_r = logits.amax(-1, keepdim=True)                  # (B, H, 1, 1)
    e = torch.exp(logits - m_r)
    m = tp.max(m_r)
    scale = torch.exp(m_r - m)
    den = tp.sum(e.sum(-1, keepdim=True) * scale)
    o = torch.einsum("bhqk,bkhd->bqhd", e, at_least_f32(vv)) \
        * scale.permute(0, 2, 1, 3)
    o = tp.sum(o) / den.permute(0, 2, 1, 3)
    out = o[:, :, h0:h1].to(cd)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(cd))
    return tp.sum(out), (ck, cv)


def paged_attention_apply(p, x, cfg: ModelConfig, *, lengths, k_pages,
                          v_pages, page_tables, layer, window=0):
    """Decode attention reading cached KV straight from the block pool
    through ``paged_attention`` (the Hopper kernel on CUDA tensors, its
    plain twin on CPU ones) plus the in-flight token's merge.

    x: (B, 1, d); k_pages/v_pages: the pool's layered (L, P, page, K, dh)
    buffers; ``layer`` selects the plane.  Returns (out (B, 1, d),
    (k_new, v_new) each (B, 1, K, dh), post-RoPE, for pool write-back).
    """
    from repro_torch.kernels.paged_attention.paged_attention import \
        decode_attend
    cd = cfg.cdtype
    positions = lengths[:, None]
    q, k, v = _qkv(p, x, cfg, positions)
    # round-trip through the cache dtype so the in-flight token sees the
    # same quantization the dense backend applies on cache write/read
    kc = k.to(cfg.kvdtype).to(cd)
    vc = v.to(cfg.kvdtype).to(cd)
    o = decode_attend(q[:, 0], kc[:, 0], vc[:, 0], k_pages, v_pages,
                      page_tables, lengths, layer=layer, window=window)
    out = torch.einsum("bshk,hkd->bsd", o[:, None].to(cd), p["wo"].to(cd))
    return out, (k, v)


def cross_kv(p, enc_out, cfg: ModelConfig):
    """Precompute cross-attention K/V from encoder output (under tensor
    parallelism this rank's KV heads, the encoder output's gradient
    summed over ``model``)."""
    cd = cfg.cdtype
    tp = dtensor.model_rank()
    if tp is not None:
        enc_out = tp.sum_backward(enc_out)
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"].to(cd))
    if cfg.qkv_bias:
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return k, v


# ---------------------------------------------------------------------------
# MLP (gated or plain)
# ---------------------------------------------------------------------------

def mlp_init(gen, cfg: ModelConfig, stack: int = 0,
             d_ff: int | None = None) -> dict:
    d, f, pd = cfg.d_model, d_ff or cfg.d_ff, cfg.pdtype
    out = {"wi": _dense_init(gen, (d, f), pd, ("embed", "mlp"), stack=stack),
           "wo": _dense_init(gen, (f, d), pd, ("mlp", "embed"), stack=stack)}
    if cfg.mlp_gated:
        out["wg"] = _dense_init(gen, (d, f), pd, ("embed", "mlp"),
                                stack=stack)
    return out


def _act(x, kind: str):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def mlp_apply(p, x, cfg: ModelConfig):
    """The MLP; under tensor parallelism ``p`` holds this rank's hidden
    units (column-parallel in, row-parallel out, summed over
    ``model``)."""
    cd = cfg.cdtype
    tp = dtensor.model_rank()
    if tp is not None:
        x = tp.sum_backward(x)
    h = torch.einsum("bsd,df->bsf", x, p["wi"].to(cd))
    if cfg.mlp_gated:
        g = torch.einsum("bsd,df->bsf", x, p["wg"].to(cd))
        h = _act(g, cfg.act) * h
    else:
        h = _act(h, cfg.act)
    out = torch.einsum("bsf,fd->bsd", h, p["wo"].to(cd))
    return out if tp is None else tp.sum_forward(out)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embedding_init(gen, cfg: ModelConfig) -> dict:
    out = {"tok": _dense_init(gen, (cfg.vocab, cfg.d_model), cfg.pdtype,
                              ("vocab", "embed"), scale=0.02)}
    if not cfg.tie_embeddings:
        out["head"] = _dense_init(gen, (cfg.d_model, cfg.vocab), cfg.pdtype,
                                  ("embed", "vocab"))
    if not cfg.use_rope and cfg.family == "encdec":
        # learned positions
        out["pos"] = _dense_init(gen, (cfg.max_position, cfg.d_model),
                                 cfg.pdtype, ("seq", "embed"), scale=0.02)
    return out


def embed_tokens(p, tokens, cfg: ModelConfig, positions=None):
    """Token rows through the MARS-sorted gather (``mars_gather``), plus
    the learned position rows at ``positions`` where the model has them.
    Under tensor parallelism ``p["tok"]`` holds this rank's vocabulary
    rows and ``p["pos"]`` its block of positions (``rules.model_cut``):
    ids and positions outside them give zero rows, and the rows are
    summed over ``model``."""
    from repro_torch.kernels.mars_gather import ops as gather_ops
    tp = dtensor.model_rank()
    if tp is None:
        x = gather_ops.embedding_gather(p["tok"], tokens).to(cfg.cdtype)
        if "pos" in p and positions is not None:
            x = x + p["pos"].to(cfg.cdtype)[positions]
        return x
    v0, v1 = tp.block(cfg.vocab)
    inside = (tokens >= v0) & (tokens < v1)
    rows = gather_ops.embedding_gather(
        p["tok"], torch.where(inside, tokens - v0, 0)).to(cfg.cdtype)
    x = torch.where(inside[..., None], rows, 0)
    if "pos" in p and positions is not None:
        p0, p1 = tp.block(cfg.max_position)
        mine = (positions >= p0) & (positions < p1)
        at = p["pos"].to(cfg.cdtype)[torch.where(mine, positions - p0, 0)]
        x = x + torch.where(mine[..., None], at, 0)
    return tp.sum_forward(x)


def lm_head(p, x, cfg: ModelConfig, whole: bool = True):
    """Logits (B, S, V).  Under tensor parallelism the head holds this
    rank's vocabulary columns: ``whole`` puts the ranks' columns
    together (no gradient: for serving and ``lm.forward``), else this
    rank's (B, S, V / n) come back, x's gradient summed over ``model``
    (the vocabulary-parallel loss)."""
    w = (p["tok"].T if cfg.tie_embeddings else p["head"]).to(cfg.cdtype)
    tp = dtensor.model_rank()
    if tp is None:
        return torch.einsum("bsd,dv->bsv", x, w)
    if not whole:
        return torch.einsum("bsd,dv->bsv", tp.sum_backward(x), w)
    return tp.put_together(torch.einsum("bsd,dv->bsv", x, w), 2,
                           tp.block(cfg.vocab), cfg.vocab)
