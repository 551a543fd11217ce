"""Causal LM, dense, hybrid, MoE, pure-SSM, encoder-decoder and VLM
families (port of ``repro/models/lm.py``).

One parameter tree, a Python loop over the stacked layer axis (the
reference's ``lax.scan``), and these entry points:

  ``forward``            — teacher-forced logits (``forward_aux`` also
                           returns the MoE router losses, ``loss_fn`` the
                           training loss; ``remat`` recomputes each block
                           in the backward)
  ``prefill``            — build the serving cache from a prompt
  ``decode_step``        — one-token serve step against the cache
  ``paged_decode_step``  — one-token serve step reading KV straight from
                           the block pool through ``paged_attention``
                           (the PagedBackend's kernel decode path)

Families ported: dense; hybrid (hymba: parallel attention and Mamba2
heads per layer, mean-combined; the SSM carries a per-sequence
recurrent state and conv context beside the KV cache); and MoE (an
optional leading stack of ``n_dense_layers`` dense blocks,
``blocks_dense``, then ``blocks`` whose MLP is a routed expert layer
with MARS-sorted dispatch, plus a shared expert or a parallel dense
residual MLP where configured).  Every entry point walks both stacks
with the absolute layer index.  Pure SSM (mamba2: attention-free Mamba2
blocks, no KV) and encoder-decoder (whisper: an ``encoder`` stack over
the stub frame embeddings ``frontend_emb``, then decoder blocks with
cross-attention ``xattn`` over it) serve through the dense backend only,
as in the reference.  The VLM family (paligemma: a gemma decoder, MQA)
prepends the stub image-patch embeddings ``frontend_emb`` to the tokens
in ``forward`` only, as a bidirectional prefix (positions, and so RoPE,
run over prefix and tokens; logits come back for the tokens); its
prefill and decode serve the text-only decoder, as the reference's do,
through the dense backend only.

Attention names its mask kind (``layers.sdpa``): every unwindowed
prefill, the encoder and the cross-attention run ``flash_attention``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.models import layers
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "hybrid", "moe", "ssm", "encdec", "vlm") \
            or cfg.is_moe != (cfg.family == "moe") \
            or bool(cfg.enc_layers) != (cfg.family == "encdec"):
        raise NotImplementedError(
            f"the torch port serves the dense, hybrid, MoE, SSM, "
            f"encoder-decoder and VLM families (got {cfg.family!r} with "
            f"n_experts={cfg.n_experts}, enc_layers={cfg.enc_layers})")


def check_paged_family(cfg: ModelConfig) -> None:
    """The paged path pages attention KV (and a hybrid's SSM side state):
    an attention-free, encoder-decoder or VLM model serves through the
    dense backend, as in the reference (``kvcache/backend.py:493-499``
    there)."""
    _check_family(cfg)
    if not cfg.has_attention or cfg.family in ("encdec", "vlm"):
        raise ValueError(f"paged serving pages attention KV only; the "
                         f"{cfg.family!r} family serves through the dense "
                         f"backend")


def _stacks(cfg: ModelConfig):
    """(tree key, first absolute layer, layer count) of each stacked block
    group in order: an MoE model's leading dense blocks, then the rest."""
    nd = cfg.n_dense_layers if cfg.is_moe else 0
    head = [("blocks_dense", 0, nd)] if nd else []
    return head + [("blocks", nd, cfg.n_layers - nd)]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, gen):
    """Random parameters with the reference's distributions and layout,
    drawn from ``gen`` on ``gen.device``.  Returns the tree as an
    ``nn.Module`` (``layers.as_module``); per-layer leaves are stacked on
    a leading layer axis (``blocks/attn/wq`` is (L, d, H, dh)).  An MoE
    model's first ``n_dense_layers`` blocks stack under
    ``blocks_dense``, the rest under ``blocks``.  Under a
    ``layers.LocalDraw`` each leaf is this rank's part of it."""
    return layers.as_module(_tree(cfg, gen))


def param_specs(cfg: ModelConfig) -> dict:
    """Each parameter's logical axes, leaf for leaf the reference's
    ``lm.init(cfg, key).specs``: a nested dict of tuples of axis names
    (``blocks/attn/wq`` is ``("layers", "embed", "heads", "head")``),
    laid out by the code that lays out ``init``'s leaves.  Needs no
    draw and no storage."""
    return _tree(cfg, layers.SPECS)


def _tree(cfg: ModelConfig, gen) -> dict:
    _check_family(cfg)
    decoder = cfg.family == "encdec"
    stacks = {name: _stack_init(gen, cfg, n,
                                moe=cfg.is_moe and name == "blocks",
                                decoder=decoder)
              for name, _, n in _stacks(cfg)}
    tree = {"embed": layers.embedding_init(gen, cfg),
            "final_norm": layers.norm_init(cfg, gen), **stacks}
    if cfg.enc_layers:
        tree["encoder"] = _stack_init(gen, cfg, cfg.enc_layers, moe=False,
                                      encoder=True)
        tree["enc_norm"] = layers.norm_init(cfg, gen)
    return tree


def _stack_init(gen, cfg: ModelConfig, L: int, *, moe: bool,
                decoder: bool = False, encoder: bool = False) -> dict:
    """``L`` stacked blocks; ``moe`` gives them a routed expert layer (and
    the dense residual MLP where configured) in place of the MLP,
    ``decoder`` a cross-attention ``xattn`` with its norm ``lnx``;
    ``encoder`` blocks have no SSM."""
    blocks = {}
    if cfg.has_attention:
        blocks["ln1"] = layers.norm_init(cfg, gen, L)
        blocks["attn"] = layers.attention_init(gen, cfg, L)
    if cfg.has_ssm and not encoder:
        blocks["ln_ssm"] = layers.norm_init(cfg, gen, L)
        blocks["ssm"] = ssm_mod.ssm_init(gen, cfg, L)
    if decoder:
        blocks["lnx"] = layers.norm_init(cfg, gen, L)
        blocks["xattn"] = layers.attention_init(gen, cfg, L)
    if moe:
        blocks["ln2"] = layers.norm_init(cfg, gen, L)
        blocks["moe"] = moe_mod.moe_init(gen, cfg, L)
        if cfg.moe_dense_residual:
            blocks["mlp"] = layers.mlp_init(gen, cfg, L)
    elif cfg.d_ff:
        blocks["ln2"] = layers.norm_init(cfg, gen, L)
        blocks["mlp"] = layers.mlp_init(gen, cfg, L)
    return blocks


# ---------------------------------------------------------------------------
# Block apply
# ---------------------------------------------------------------------------

def _planes(stacked, n: int) -> list:
    """The ``n`` per-layer planes of a stacked parameter subtree, each
    stacked leaf unbound once (under autograd one backward node a leaf
    that stacks the planes' gradients, not ``n`` indexing nodes each
    writing a full-size zero gradient)."""
    if isinstance(stacked, torch.Tensor):
        return list(stacked.unbind(0))
    per = {k: _planes(v, n) for k, v in stacked.items()}
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def _add_aux(total: dict, aux: dict) -> dict:
    """Router losses summed key by key (a missing key counts 0)."""
    return {k: total.get(k, 0.0) + aux.get(k, 0.0)
            for k in total.keys() | aux.keys()}


def _block_apply(bp, x, cfg: ModelConfig, *, masks, positions, kv=None,
                 cache_pos=None, ssm_state=None, xkv=None, is_global=None,
                 paged=None):
    """One transformer block.  Returns (x, new_kv, new_ssm, aux) — new_kv
    is None for an attention-free block, new_ssm the SSM branch's
    ``(state, conv_state)`` for a block with one, else None, and aux an
    MoE block's router losses (``moe_lb``, ``moe_z``; else empty).
    ``paged`` routes
    decode attention through ``paged_attention`` (KV read straight from
    the pool's layered page buffers); ``ssm_state`` ``(state,
    conv_state)`` switches the SSM branch to its one-token recurrence;
    ``xkv`` (k, v) is the encoder's cross-attention K/V of a decoder
    block.  ``masks`` holds mask kinds or tensors (``layers.sdpa``)."""
    attn_out = new_kv = None
    aux = {}
    if "attn" in bp:
        h = layers.apply_norm(bp["ln1"], x, cfg)
        if paged is not None:
            attn_out, new_kv = layers.paged_attention_apply(
                bp["attn"], h, cfg, lengths=paged["lengths"],
                k_pages=paged["k_pages"], v_pages=paged["v_pages"],
                page_tables=paged["page_tables"], layer=paged["layer"],
                window=paged.get("window", 0))
        else:
            mask = masks[0]
            if cfg.sliding_window and is_global is not None and is_global:
                mask = masks[1]
            attn_out, new_kv = layers.attention_apply(
                bp["attn"], h, cfg, positions=positions, mask=mask,
                kv_cache=kv, cache_positions=cache_pos)
    new_ssm = None
    if "ssm" in bp:
        hs = layers.apply_norm(bp["ln_ssm"], x, cfg)
        st, cs = ssm_state if ssm_state is not None else (None, None)
        ssm_out, new_ssm = ssm_mod.ssm_apply(bp["ssm"], hs, cfg, state=st,
                                             conv_state=cs,
                                             return_state=True)
        # hymba: parallel heads, mean-combined
        x = x + (0.5 * (attn_out + ssm_out) if attn_out is not None
                 else ssm_out)
    else:
        x = x + attn_out
    if "xattn" in bp and xkv is not None:
        h = layers.apply_norm(bp["lnx"], x, cfg)
        xo, _ = layers.attention_apply(bp["xattn"], h, cfg, positions=None,
                                       mask=None, xattn_kv=xkv)
        x = x + xo
    if "moe" in bp:
        h = layers.apply_norm(bp["ln2"], x, cfg)
        mo, aux = moe_mod.moe_apply(bp["moe"], h, cfg)
        if cfg.moe_dense_residual and "mlp" in bp:
            mo = mo + layers.mlp_apply(bp["mlp"], h, cfg)
        x = x + mo
    elif "mlp" in bp:
        h = layers.apply_norm(bp["ln2"], x, cfg)
        x = x + layers.mlp_apply(bp["mlp"], h, cfg)
    return x, new_kv, new_ssm, aux


def _scan_blocks(stacked, x, cfg: ModelConfig, *, masks, positions,
                 layer_offset: int, n: int, kv=None, cache_pos=None,
                 ssm_states=None, xkv=None, paged=None, remat: bool = False):
    """Loop over stacked block params (+ optional per-layer caches) for
    absolute layers ``layer_offset .. layer_offset + n - 1``.

    ``kv`` (dense cache K and V, (L, ...)), ``ssm_states`` (the SSM side
    state ``(ssm (L, B, H, P, N), conv (L, B, k-1, ch))``) and ``xkv``
    (cross-attention K and V, (L, B, Senc, K, dh)) span every layer of
    the model and are read at the absolute layer index, as is ``paged``
    (kernel-path decode operands: pool page buffers + table + lengths),
    whose index selects each iteration's plane of the layered pool
    through one shared table.  ``remat`` recomputes each block's
    activations in the backward (``torch.utils.checkpoint`` per block,
    the reference's ``jax.checkpoint`` of the scan body).  Returns (x,
    [(k, v) per layer, or None for an attention-free model], [(ssm,
    conv) per layer, or None per layer for a model without SSM], the
    layers' summed router losses)."""
    glob = None
    if cfg.sliding_window:
        # per-layer global/window flag: global layers attend the whole
        # cache, the rest apply the sliding window
        glob = [(li % cfg.global_every == 0) if cfg.global_every else False
                for li in range(layer_offset, layer_offset + n)]
    ys, ss = [], []
    aux_sum = {}
    planes = _planes(stacked, n)
    for i in range(n):
        li = layer_offset + i
        paged_l = None
        if paged is not None:
            paged_l = dict(paged, layer=li)
            if cfg.sliding_window:
                paged_l["window"] = 0 if glob[i] else cfg.sliding_window
        kv_i = None if kv is None else (kv[0][li], kv[1][li])
        ssm_i = None if ssm_states is None else (ssm_states[0][li],
                                                 ssm_states[1][li])
        xkv_i = None if xkv is None else (xkv[0][li], xkv[1][li])
        kw = dict(masks=masks, positions=positions, kv=kv_i,
                  cache_pos=cache_pos, ssm_state=ssm_i, xkv=xkv_i,
                  is_global=None if glob is None else glob[i], paged=paged_l)
        if remat:
            x, new_kv, new_ssm, aux = torch.utils.checkpoint.checkpoint(
                _block_apply, planes[i], x, cfg, use_reentrant=False, **kw)
        else:
            x, new_kv, new_ssm, aux = _block_apply(planes[i], x, cfg, **kw)
        aux_sum = _add_aux(aux_sum, aux)
        ys.append(new_kv)
        ss.append(new_ssm)
    return x, ys, ss, aux_sum


def _run_blocks(params, x, cfg: ModelConfig, **kw):
    """``_scan_blocks`` over every stacked block group in order (an MoE
    model's ``blocks_dense``, then ``blocks``) with the absolute layer
    index; returns (x, per-layer kv list, per-layer side-state list) over
    all ``n_layers`` layers, and the summed router losses."""
    ys, ss = [], []
    aux_sum = {}
    for name, off, n in _stacks(cfg):
        x, y, s, aux = _scan_blocks(params[name], x, cfg, layer_offset=off,
                                    n=n, **kw)
        ys += y
        ss += s
        aux_sum = _add_aux(aux_sum, aux)
    return x, ys, ss, aux_sum


def _stack_pairs(pairs):
    """Per-layer pairs (K and V, or SSM state and conv) -> two stacked
    (L, ...) tensors, or (None, None) where the layers have none."""
    if pairs[0] is None:
        return None, None
    return (torch.stack([a for a, _ in pairs]),
            torch.stack([b for _, b in pairs]))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _masks(cfg: ModelConfig, S: int, device, prefix: int = 0):
    """(mask of a layer, mask of a global layer) over a prompt of ``S``
    positions: the kind ``CAUSAL`` (``flash_attention``), and a sliding
    window's tensor.  With a VLM's image prefix of ``prefix`` positions
    both are tensors in which every query sees the prefix (the plain
    masked softmax: K5 has no prefix mode, as the Pallas kernel has
    none)."""
    if prefix:
        glob = layers.causal_mask(S, S, prefix_len=prefix, device=device)
        if not cfg.sliding_window:
            return glob, glob
        return (layers.causal_mask(S, S, window=cfg.sliding_window,
                                   prefix_len=prefix, device=device), glob)
    if not cfg.sliding_window:
        return layers.CAUSAL, layers.CAUSAL
    return (layers.causal_mask(S, S, window=cfg.sliding_window,
                               device=device), layers.CAUSAL)


def _encoder_forward(params, cfg: ModelConfig, frontend_emb,
                     remat: bool = False):
    """The encoder stack over the frame embeddings (B, Senc, d), no mask."""
    x = frontend_emb.to(cfg.cdtype)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    x, _, _, _ = _scan_blocks(params["encoder"], x, cfg, masks=(None, None),
                              positions=positions, layer_offset=0,
                              n=cfg.enc_layers, remat=remat)
    return layers.apply_norm(params["enc_norm"], x, cfg)


def _cross_kvs(params, cfg: ModelConfig, enc_out):
    """Every decoder layer's cross-attention (k, v), each stacked (L, B,
    Senc, K, dh)."""
    return _stack_pairs([layers.cross_kv(p, enc_out, cfg) for p in
                         _planes(params["blocks"]["xattn"], cfg.n_layers)])


def _prompt(params, cfg: ModelConfig, tokens, frontend_emb,
            remat: bool = False):
    """Token embeddings, positions and an encoder-decoder model's
    cross-attention K/V (None otherwise) of a (B, S) prompt."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    x = layers.embed_tokens(params["embed"], tokens, cfg, positions)
    xkv = None
    if cfg.family == "encdec":
        if frontend_emb is None:
            raise ValueError(f"{cfg.name} needs frontend_emb, the (B, "
                             f"{cfg.frontend_seq}, {cfg.d_model}) frame "
                             f"embeddings its encoder reads")
        xkv = _cross_kvs(params, cfg,
                         _encoder_forward(params, cfg, frontend_emb, remat))
    return x, positions, xkv


def _prepend_image(cfg: ModelConfig, x, frontend_emb):
    """A VLM's image-patch embeddings ``frontend_emb`` (B, P, d), in the
    compute dtype, before the token embeddings ``x`` (B, S, d); returns
    the (B, P + S, d) sequence and its positions 0 .. P + S - 1."""
    if frontend_emb is None:
        raise ValueError(f"{cfg.name} needs frontend_emb, the (B, "
                         f"{cfg.frontend_seq}, {cfg.d_model}) image-patch "
                         f"embeddings forward prepends (P may be 0)")
    img = frontend_emb.to(device=x.device, dtype=cfg.cdtype)
    x = torch.cat([img, x], dim=1)
    B, n = x.shape[:2]
    return x, torch.arange(n, device=x.device)[None, :].expand(B, n)


def forward_aux(params, cfg: ModelConfig, tokens, frontend_emb=None,
                remat: bool = False):
    """Teacher-forced logits (B, S, V) and the MoE router losses summed
    over the decoder's layers (``moe_lb``, ``moe_z``; 0 without MoE), as
    the reference's ``forward`` returns them.  tokens: (B, S) int; an
    encoder-decoder model's encoder reads ``frontend_emb`` (B, Senc, d);
    a VLM prepends it (B, P, d) as a bidirectional image prefix and
    returns the logits of the token positions (P = 0 is the text-only
    model).  ``remat`` recomputes each block in the backward."""
    _check_family(cfg)
    x, positions, xkv = _prompt(params, cfg, tokens, frontend_emb, remat)
    prefix = 0
    if cfg.family == "vlm":
        x, positions = _prepend_image(cfg, x, frontend_emb)
        prefix = frontend_emb.shape[1]
    x, _, _, aux = _run_blocks(params, x, cfg,
                               masks=_masks(cfg, x.shape[1], tokens.device,
                                            prefix),
                               positions=positions, xkv=xkv, remat=remat)
    x = layers.apply_norm(params["final_norm"], x[:, prefix:], cfg)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return layers.lm_head(params["embed"], x, cfg), \
        {k: aux.get(k, zero) for k in ("moe_lb", "moe_z")}


def forward(params, cfg: ModelConfig, tokens, frontend_emb=None):
    """Teacher-forced logits (B, S, V) alone (``forward_aux`` without the
    router losses)."""
    return forward_aux(params, cfg, tokens, frontend_emb)[0]


def loss_terms(params, cfg: ModelConfig, tokens, labels, frontend_emb=None,
               remat: bool = False):
    """The pieces of ``loss_fn``: (the summed negative log-likelihood of
    ``labels`` over the positions whose label is >= 0, the count of those
    positions, the router losses ``{"moe_lb", "moe_z"}``)."""
    logits, aux = forward_aux(params, cfg, tokens, frontend_emb,
                              remat=remat)
    logits = layers.at_least_f32(logits)
    mask = labels >= 0
    safe = torch.clamp_min(labels, 0).long()
    ll = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(ll, -1, safe[..., None])[..., 0]
    return (nll * mask).sum(), mask.sum(), aux


def loss_fn(params, cfg: ModelConfig, tokens, labels, frontend_emb=None,
            remat: bool = False, aux_weight: float = 0.01):
    """Causal LM cross-entropy with the MoE router losses (reference
    ``lm.py:607``): the mean negative log-likelihood of ``labels`` over
    the positions whose label is >= 0, plus ``aux_weight * (moe_lb +
    1e-3 moe_z)``.  Returns (loss, {"lm_loss": loss, "moe_lb",
    "moe_z"}), as the reference's."""
    nll, count, aux = loss_terms(params, cfg, tokens, labels, frontend_emb,
                                 remat)
    loss = nll / torch.clamp_min(count, 1)
    loss = loss + aux_weight * (aux["moe_lb"] + 1e-3 * aux["moe_z"])
    return loss, {"lm_loss": loss, **aux}


@dataclasses.dataclass
class Cache:
    """Dense serving storage (the DenseBackend's state)."""
    k: Any            # (L, B, Smax, K, dh), None without attention
    v: Any
    length: Any       # int tensor — tokens already cached; scalar, or (B,)
                      # for ragged (per-sequence) decode
    ssm: Any = None   # SSM: (L, B, H, P, N) float32 recurrent state
    conv: Any = None  # SSM: (L, B, k-1, d_in + 2N) conv context
    xk: Any = None    # encdec: (L, B, Senc, K, dh) cross-attention K/V
    xv: Any = None


def init_dense_cache(cfg: ModelConfig, batch: int, max_seq: int,
                     device="cuda", *, enc_len: int = 0) -> Cache:
    """Zeroed dense storage: K/V of ``max_seq`` positions where the model
    has attention, the SSM state and conv context where it has an SSM,
    and an encoder-decoder model's cross-attention K/V over ``enc_len``
    frames."""
    L, K, dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    cd = cfg.kvdtype

    def zeros(shape, dtype=cd):
        return torch.zeros(shape, dtype=dtype, device=device)
    k = v = ssm = conv = xk = xv = None
    if cfg.has_attention:
        k, v = (zeros((L, batch, max_seq, K, dh)) for _ in range(2))
    if cfg.has_ssm:
        ss, cs = ssm_mod.ssm_state_shapes(cfg, batch)
        ssm, conv = zeros((L,) + ss, torch.float32), zeros((L,) + cs)
    if cfg.family == "encdec":
        xk, xv = (zeros((L, batch, enc_len, K, dh)) for _ in range(2))
    return Cache(k, v, zeros((), torch.int32), ssm, conv, xk, xv)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               kind: str = "dense", device="cuda", enc_len: int = 0,
               **backend_kw):
    """Build a KV backend (``kind``: "dense" | "paged") on ``device``;
    ``enc_len`` sizes an encoder-decoder model's cross-attention K/V."""
    from repro_torch.kvcache.backend import make_backend
    return make_backend(cfg, kind, batch=batch, max_seq=max_seq,
                        device=device, enc_len=enc_len, **backend_kw)


def dense_decode_step(params, cfg: ModelConfig, tokens, cache: Cache):
    """One-token decode against dense storage.

    tokens: (B, 1) int.  ``cache.length`` may be a scalar (all lanes at
    the same position) or a (B,) vector for ragged decode; learned
    positions are read there.  The cache's K/V are written in place (see
    ``layers.attention_apply``); an SSM's state and conv context advance
    into new tensors; a decoder's cross-attention reads ``cache.xk/xv``.
    Returns (logits, cache with length + 1)."""
    _check_family(cfg)
    B = tokens.shape[0]
    pos = torch.as_tensor(cache.length, device=tokens.device)
    ragged = pos.ndim > 0
    posv = torch.broadcast_to(pos.reshape(-1), (B,))
    positions = posv[:, None]
    x = layers.embed_tokens(params["embed"], tokens, cfg, positions)
    masks = kv = None
    if cfg.has_attention:
        Smax = cache.k.shape[2]
        kpos = torch.arange(Smax, device=tokens.device)[None, :]
        m_causal = kpos <= posv[:, None]
        m = m_causal
        if cfg.sliding_window:
            m = m_causal & (kpos > posv[:, None] - cfg.sliding_window)
        masks = (m[:, None, None, :], m_causal[:, None, None, :])
        kv = (cache.k, cache.v)
    ssm_states = (cache.ssm, cache.conv) if cfg.has_ssm else None
    xkv = (cache.xk, cache.xv) if cfg.family == "encdec" else None
    x, _, ss, _ = _run_blocks(params, x, cfg, masks=masks,
                           positions=positions, kv=kv,
                           cache_pos=posv if ragged else pos,
                           ssm_states=ssm_states, xkv=xkv)
    x = layers.apply_norm(params["final_norm"], x, cfg)
    logits = layers.lm_head(params["embed"], x, cfg)
    ssm, conv = _stack_pairs(ss)
    return logits, Cache(cache.k, cache.v, cache.length + 1, ssm, conv,
                         cache.xk, cache.xv)


def paged_decode_step(params, cfg: ModelConfig, tokens, k_pages, v_pages,
                      page_tables, lengths, *, ssm_state=None,
                      conv_state=None):
    """One-token decode reading cached KV straight from the block pool
    through ``paged_attention`` — no gathered dense view.

    tokens: (B, 1) int; k_pages/v_pages: the pool's layered
    (L, P, page, K, dh) buffers; page_tables: (B, n_pages) int32;
    lengths: (B,) int32 ragged per-lane cached token counts.  A hybrid
    model also takes its side state, ``ssm_state`` (L, B, H, P, N)
    float32 and ``conv_state`` (L, B, k-1, ch).

    Returns (logits (B, 1, V), k_new, v_new, ssm_new, conv_new) with
    k_new/v_new (L, B, 1, K, dh) — the in-flight token's per-layer K/V
    for the caller's write-back — and the advanced side state (None for
    a dense model).  Attention-free and encoder-decoder models raise: they
    serve through the dense backend.
    """
    check_paged_family(cfg)
    ssm_states = None
    if cfg.has_ssm:
        if ssm_state is None or conv_state is None:
            raise ValueError("hybrid paged decode needs ssm_state and "
                             "conv_state")
        ssm_states = (ssm_state, conv_state)
    positions = lengths[:, None]
    x = layers.embed_tokens(params["embed"], tokens, cfg)
    paged = dict(k_pages=k_pages, v_pages=v_pages, page_tables=page_tables,
                 lengths=lengths)
    x, ys, ss, _ = _run_blocks(params, x, cfg, masks=None,
                            positions=positions, ssm_states=ssm_states,
                            paged=paged)
    x = layers.apply_norm(params["final_norm"], x, cfg)
    logits = layers.lm_head(params["embed"], x, cfg)
    k_new, v_new = _stack_pairs(ys)
    ssm_new, conv_new = _stack_pairs(ss)
    return logits, k_new, v_new, ssm_new, conv_new


def decode_step(params, cfg: ModelConfig, tokens, cache):
    """One-token decode.  ``cache`` is either a dense ``Cache`` or any
    ``KVBackend``.  Returns (logits, cache)."""
    if isinstance(cache, Cache):
        return dense_decode_step(params, cfg, tokens, cache)
    logits = cache.decode_step(params, tokens)
    return logits, cache


def prefill_parts(params, cfg: ModelConfig, tokens, frontend_emb=None):
    """Run the prompt, returning last-position logits plus every cacheable
    part.  Returns (logits (B,1,V), parts) with parts "k", "v" (L, B, S,
    K, dh) post-RoPE in the compute dtype, "ssm" (L, B, H, P, N) float32
    and "conv" (L, B, k-1, ch), and "xk", "xv" (L, B, Senc, K, dh) —
    each None where the model has no such part.  An encoder-decoder
    model's encoder reads ``frontend_emb`` (B, Senc, d).  A VLM serves
    its text-only decoder, as the reference does, and refuses a
    ``frontend_emb`` rather than drop it (ROADMAP.md §3)."""
    _check_family(cfg)
    S = tokens.shape[1]
    if cfg.family == "vlm" and frontend_emb is not None:
        raise ValueError(
            f"{cfg.name}: the serving path runs the text-only decoder and "
            f"takes no frontend_emb (the reference drops it unread; see "
            f"ROADMAP.md §3); lm.forward takes the image prefix")
    x, positions, xkv = _prompt(params, cfg, tokens, frontend_emb)
    x, ys, ss, _ = _run_blocks(params, x, cfg,
                               masks=_masks(cfg, S, tokens.device),
                            positions=positions, xkv=xkv)
    x = layers.apply_norm(params["final_norm"], x, cfg)
    logits = layers.lm_head(params["embed"], x[:, -1:], cfg)
    k, v = _stack_pairs(ys)
    ssm, conv = _stack_pairs(ss)
    xk, xv = xkv if xkv is not None else (None, None)
    return logits, {"k": k, "v": v, "ssm": ssm, "conv": conv, "xk": xk,
                    "xv": xv}


def dense_prefill(params, cfg: ModelConfig, tokens, max_seq: int,
                  frontend_emb=None):
    """Prompt -> (logits, dense Cache sized ``max_seq``)."""
    B, S = tokens.shape
    # the cross-attention K/V come from the prompt's encoder run below
    cache = init_dense_cache(cfg, B, max_seq, device=tokens.device)
    logits, parts = prefill_parts(params, cfg, tokens, frontend_emb)
    if cfg.has_attention:
        cache.k[:, :, :S] = parts["k"].to(cache.k.dtype)
        cache.v[:, :, :S] = parts["v"].to(cache.v.dtype)
    if cfg.has_ssm:
        cache.ssm, cache.conv = parts["ssm"], parts["conv"]
    if cfg.family == "encdec":
        cache.xk, cache.xv = parts["xk"], parts["xv"]
    cache.length = torch.tensor(S, dtype=torch.int32, device=tokens.device)
    return logits, cache


def prefill(params, cfg: ModelConfig, tokens, max_seq: int = 0,
            frontend_emb=None, backend=None):
    """Run the prompt through the model, building the serving cache.

    Returns (logits, backend).  With ``backend=None`` a ``DenseBackend``
    sized by ``max_seq`` (and an encoder-decoder model's frame count) is
    created on ``tokens.device``; pass a ``PagedBackend`` to prefill into
    pool block tables instead."""
    if backend is None:
        if not max_seq:
            raise ValueError("prefill needs max_seq (or an explicit backend)")
        enc_len = frontend_emb.shape[1] if cfg.family == "encdec" \
            and frontend_emb is not None else 0
        backend = init_cache(cfg, tokens.shape[0], max_seq,
                             device=tokens.device, enc_len=enc_len)
    logits = backend.prefill(params, tokens, frontend_emb=frontend_emb)
    return logits, backend
