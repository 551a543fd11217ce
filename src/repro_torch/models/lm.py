"""Causal LM, dense, hybrid and MoE families (port of
``repro/models/lm.py``).

One parameter tree, a Python loop over the stacked layer axis (the
reference's ``lax.scan``), four entry points:

  ``forward``            — teacher-forced logits
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
with the absolute layer index.  The other families raise
``NotImplementedError`` (ROADMAP.md queues them).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import layers
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "hybrid", "moe") \
            or cfg.is_moe != (cfg.family == "moe") or cfg.enc_layers:
        raise NotImplementedError(
            f"the torch port serves the dense, hybrid and MoE families "
            f"only (got {cfg.family!r}); see ROADMAP.md for the other "
            f"families")


def _stacks(cfg: ModelConfig):
    """(tree key, first absolute layer, layer count) of each stacked block
    group in order: an MoE model's leading dense blocks, then the rest."""
    nd = cfg.n_dense_layers if cfg.is_moe else 0
    head = [("blocks_dense", 0, nd)] if nd else []
    return head + [("blocks", nd, cfg.n_layers - nd)]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, gen: torch.Generator):
    """Random parameters with the reference's distributions and layout,
    drawn from ``gen`` on ``gen.device``.  Returns the tree as an
    ``nn.Module`` (``layers.as_module``); per-layer leaves are stacked on
    a leading layer axis (``blocks/attn/wq`` is (L, d, H, dh)).  An MoE
    model's first ``n_dense_layers`` blocks stack under
    ``blocks_dense``, the rest under ``blocks``."""
    _check_family(cfg)
    stacks = {name: _stack_init(gen, cfg, n,
                                moe=cfg.is_moe and name == "blocks")
              for name, _, n in _stacks(cfg)}
    tree = {"embed": layers.embedding_init(gen, cfg),
            "final_norm": layers.norm_init(cfg, gen.device), **stacks}
    return layers.as_module(tree)


def _stack_init(gen, cfg: ModelConfig, L: int, *, moe: bool) -> dict:
    """``L`` stacked blocks; ``moe`` gives them a routed expert layer (and
    the dense residual MLP where configured) in place of the MLP."""
    blocks = {"ln1": layers.norm_init(cfg, gen.device, L),
              "attn": layers.attention_init(gen, cfg, L)}
    if cfg.has_ssm:
        blocks["ln_ssm"] = layers.norm_init(cfg, gen.device, L)
        blocks["ssm"] = ssm_mod.ssm_init(gen, cfg, L)
    if moe:
        blocks["ln2"] = layers.norm_init(cfg, gen.device, L)
        blocks["moe"] = moe_mod.moe_init(gen, cfg, L)
        if cfg.moe_dense_residual:
            blocks["mlp"] = layers.mlp_init(gen, cfg, L)
    elif cfg.d_ff:
        blocks["ln2"] = layers.norm_init(cfg, gen.device, L)
        blocks["mlp"] = layers.mlp_init(gen, cfg, L)
    return blocks


# ---------------------------------------------------------------------------
# Block apply
# ---------------------------------------------------------------------------

def _layer(stacked, i: int) -> dict:
    """Plane ``i`` of a stacked parameter subtree."""
    return {k: (_layer(v, i) if not isinstance(v, torch.Tensor) else v[i])
            for k, v in stacked.items()}


def _block_apply(bp, x, cfg: ModelConfig, *, masks, positions, kv=None,
                 cache_pos=None, ssm_state=None, is_global=None, paged=None):
    """One transformer block.  Returns (x, new_kv, new_ssm) — new_ssm is
    the SSM branch's ``(state, conv_state)`` for a hybrid block, else
    None.  ``paged`` routes decode attention through ``paged_attention``
    (KV read straight from the pool's layered page buffers);
    ``ssm_state`` ``(state, conv_state)`` switches the SSM branch to its
    one-token recurrence."""
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
    if cfg.has_ssm:
        hs = layers.apply_norm(bp["ln_ssm"], x, cfg)
        st, cs = ssm_state if ssm_state is not None else (None, None)
        ssm_out, new_ssm = ssm_mod.ssm_apply(bp["ssm"], hs, cfg, state=st,
                                             conv_state=cs,
                                             return_state=True)
        # hymba: parallel heads, mean-combined
        x = x + 0.5 * (attn_out + ssm_out)
    else:
        x = x + attn_out
    if "moe" in bp:
        h = layers.apply_norm(bp["ln2"], x, cfg)
        mo, _ = moe_mod.moe_apply(bp["moe"], h, cfg)
        if cfg.moe_dense_residual and "mlp" in bp:
            mo = mo + layers.mlp_apply(bp["mlp"], h, cfg)
        x = x + mo
    elif "mlp" in bp:
        h = layers.apply_norm(bp["ln2"], x, cfg)
        x = x + layers.mlp_apply(bp["mlp"], h, cfg)
    return x, new_kv, new_ssm


def _scan_blocks(stacked, x, cfg: ModelConfig, *, masks, positions,
                 layer_offset: int, n: int, kv=None, cache_pos=None,
                 ssm_states=None, paged=None):
    """Loop over stacked block params (+ optional per-layer caches) for
    absolute layers ``layer_offset .. layer_offset + n - 1``.

    ``kv`` (dense cache K and V, (L, ...)) and ``ssm_states`` (the hybrid
    side state ``(ssm (L, B, H, P, N), conv (L, B, k-1, ch))``) span every
    layer of the model and are read at the absolute layer index, as is
    ``paged`` (kernel-path decode operands: pool page buffers + table +
    lengths), whose index selects each iteration's plane of the layered
    pool through one shared table.  Returns (x, [(k, v) per layer],
    [(ssm, conv) per layer, or None per layer for a dense model])."""
    glob = None
    if cfg.sliding_window:
        # per-layer global/window flag: global layers attend the whole
        # cache, the rest apply the sliding window
        glob = [(li % cfg.global_every == 0) if cfg.global_every else False
                for li in range(layer_offset, layer_offset + n)]
    ys, ss = [], []
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
        x, new_kv, new_ssm = _block_apply(
            _layer(stacked, i), x, cfg, masks=masks, positions=positions,
            kv=kv_i, cache_pos=cache_pos, ssm_state=ssm_i,
            is_global=None if glob is None else glob[i], paged=paged_l)
        ys.append(new_kv)
        ss.append(new_ssm)
    return x, ys, ss


def _run_blocks(params, x, cfg: ModelConfig, **kw):
    """``_scan_blocks`` over every stacked block group in order (an MoE
    model's ``blocks_dense``, then ``blocks``) with the absolute layer
    index; returns (x, per-layer kv list, per-layer side-state list) over
    all ``n_layers`` layers."""
    ys, ss = [], []
    for name, off, n in _stacks(cfg):
        x, y, s = _scan_blocks(params[name], x, cfg, layer_offset=off, n=n,
                               **kw)
        ys += y
        ss += s
    return x, ys, ss


def _stack_kv(ys):
    return (torch.stack([k for k, _ in ys]), torch.stack([v for _, v in ys]))


def _stack_ssm(ss):
    """Per-layer (state, conv) -> (ssm (L, B, H, P, N), conv (L, B, k-1,
    ch)), or (None, None) for a dense model."""
    if ss[0] is None:
        return None, None
    return (torch.stack([s for s, _ in ss]), torch.stack([c for _, c in ss]))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _masks(cfg: ModelConfig, S: int, device):
    m_causal = layers.causal_mask(S, S, device=device)
    m_window = layers.causal_mask(S, S, window=cfg.sliding_window,
                                  device=device) \
        if cfg.sliding_window else m_causal
    return (m_window if cfg.sliding_window else m_causal, m_causal)


def forward(params, cfg: ModelConfig, tokens):
    """Teacher-forced logits (B, S, V).  tokens: (B, S) int."""
    _check_family(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    x = layers.embed_tokens(params["embed"], tokens, cfg)
    x, _, _ = _run_blocks(params, x, cfg,
                          masks=_masks(cfg, S, tokens.device),
                          positions=positions)
    x = layers.apply_norm(params["final_norm"], x, cfg)
    return layers.lm_head(params["embed"], x, cfg)


@dataclasses.dataclass
class Cache:
    """Dense serving storage (the DenseBackend's state)."""
    k: Any            # (L, B, Smax, K, dh)
    v: Any
    length: Any       # int tensor — tokens already cached; scalar, or (B,)
                      # for ragged (per-sequence) decode
    ssm: Any = None   # hybrid: (L, B, H, P, N) float32 recurrent state
    conv: Any = None  # hybrid: (L, B, k-1, d_in + 2N) conv context


def init_dense_cache(cfg: ModelConfig, batch: int, max_seq: int,
                     device="cuda") -> Cache:
    L, K, dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    shape = (L, batch, max_seq, K, dh)
    ssm = conv = None
    if cfg.has_ssm:
        ss, cs = ssm_mod.ssm_state_shapes(cfg, batch)
        ssm = torch.zeros((L,) + ss, dtype=torch.float32, device=device)
        conv = torch.zeros((L,) + cs, dtype=cfg.kvdtype, device=device)
    return Cache(torch.zeros(shape, dtype=cfg.kvdtype, device=device),
                 torch.zeros(shape, dtype=cfg.kvdtype, device=device),
                 torch.zeros((), dtype=torch.int32, device=device),
                 ssm, conv)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               kind: str = "dense", device="cuda", **backend_kw):
    """Build a KV backend (``kind``: "dense" | "paged") on ``device``."""
    from repro_torch.kvcache.backend import make_backend
    return make_backend(cfg, kind, batch=batch, max_seq=max_seq,
                        device=device, **backend_kw)


def dense_decode_step(params, cfg: ModelConfig, tokens, cache: Cache):
    """One-token decode against dense storage.

    tokens: (B, 1) int.  ``cache.length`` may be a scalar (all lanes at
    the same position) or a (B,) vector for ragged decode.  The cache's
    K/V are written in place (see ``layers.attention_apply``); a hybrid
    model's SSM state and conv context advance into new tensors.
    Returns (logits, cache with length + 1)."""
    _check_family(cfg)
    B = tokens.shape[0]
    pos = torch.as_tensor(cache.length, device=tokens.device)
    ragged = pos.ndim > 0
    posv = torch.broadcast_to(pos.reshape(-1), (B,))
    positions = posv[:, None]
    x = layers.embed_tokens(params["embed"], tokens, cfg)
    Smax = cache.k.shape[2]
    kpos = torch.arange(Smax, device=tokens.device)[None, :]
    m_causal = kpos <= posv[:, None]
    m = m_causal
    if cfg.sliding_window:
        m = m_causal & (kpos > posv[:, None] - cfg.sliding_window)
    masks = (m[:, None, None, :], m_causal[:, None, None, :])
    ssm_states = (cache.ssm, cache.conv) if cfg.has_ssm else None
    x, _, ss = _run_blocks(params, x, cfg, masks=masks,
                           positions=positions, kv=(cache.k, cache.v),
                           cache_pos=posv if ragged else pos,
                           ssm_states=ssm_states)
    x = layers.apply_norm(params["final_norm"], x, cfg)
    logits = layers.lm_head(params["embed"], x, cfg)
    ssm, conv = _stack_ssm(ss)
    return logits, Cache(cache.k, cache.v, cache.length + 1, ssm, conv)


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
    a dense model).
    """
    _check_family(cfg)
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
    x, ys, ss = _run_blocks(params, x, cfg, masks=None,
                            positions=positions, ssm_states=ssm_states,
                            paged=paged)
    x = layers.apply_norm(params["final_norm"], x, cfg)
    logits = layers.lm_head(params["embed"], x, cfg)
    k_new, v_new = _stack_kv(ys)
    ssm_new, conv_new = _stack_ssm(ss)
    return logits, k_new, v_new, ssm_new, conv_new


def decode_step(params, cfg: ModelConfig, tokens, cache):
    """One-token decode.  ``cache`` is either a dense ``Cache`` or any
    ``KVBackend``.  Returns (logits, cache)."""
    if isinstance(cache, Cache):
        return dense_decode_step(params, cfg, tokens, cache)
    logits = cache.decode_step(params, tokens)
    return logits, cache


def prefill_parts(params, cfg: ModelConfig, tokens):
    """Run the prompt, returning last-position logits plus every cacheable
    part.  Returns (logits (B,1,V), parts) with parts "k", "v" (L, B, S,
    K, dh) post-RoPE in the compute dtype, and "ssm" (L, B, H, P, N)
    float32 and "conv" (L, B, k-1, ch) — None for a dense model."""
    _check_family(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    x = layers.embed_tokens(params["embed"], tokens, cfg)
    x, ys, ss = _run_blocks(params, x, cfg,
                            masks=_masks(cfg, S, tokens.device),
                            positions=positions)
    x = layers.apply_norm(params["final_norm"], x, cfg)
    logits = layers.lm_head(params["embed"], x[:, -1:], cfg)
    k, v = _stack_kv(ys)
    ssm, conv = _stack_ssm(ss)
    return logits, {"k": k, "v": v, "ssm": ssm, "conv": conv}


def dense_prefill(params, cfg: ModelConfig, tokens, max_seq: int):
    """Prompt -> (logits, dense Cache sized ``max_seq``)."""
    B, S = tokens.shape
    cache = init_dense_cache(cfg, B, max_seq, device=tokens.device)
    logits, parts = prefill_parts(params, cfg, tokens)
    cache.k[:, :, :S] = parts["k"].to(cache.k.dtype)
    cache.v[:, :, :S] = parts["v"].to(cache.v.dtype)
    if cfg.has_ssm:
        cache.ssm, cache.conv = parts["ssm"], parts["conv"]
    cache.length = torch.tensor(S, dtype=torch.int32, device=tokens.device)
    return logits, cache


def prefill(params, cfg: ModelConfig, tokens, max_seq: int = 0,
            backend=None):
    """Run the prompt through the model, building the serving cache.

    Returns (logits, backend).  With ``backend=None`` a ``DenseBackend``
    sized by ``max_seq`` is created on ``tokens.device``; pass a
    ``PagedBackend`` to prefill into pool block tables instead."""
    if backend is None:
        if not max_seq:
            raise ValueError("prefill needs max_seq (or an explicit backend)")
        backend = init_cache(cfg, tokens.shape[0], max_seq,
                             device=tokens.device)
    logits = backend.prefill(params, tokens)
    return logits, backend
