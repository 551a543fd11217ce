"""Mixture-of-Experts layer with MARS-sorted dispatch (port of
``repro/models/moe.py``).

Token->expert assignments arrive interleaved (tokens in sequence order);
the locality-oblivious baseline streams every token through capacity
buffers for every expert (``moe_apply_einsum``, the GShard one-hot
dispatch).  The MARS path sorts a step's assignments by destination
expert ("page", ``core.reorder.mars_sort_by_page``) and runs one grouped
matmul per product over the contiguous per-expert segments, so each
used expert's weights are read once, in one run, then inverse-permutes.

Where the reference calls ``lax.ragged_dot``, ``_grouped_ffn`` pads the
sorted rows group by group (``ops.pad_sorted_groups``) and calls
``grouped_matmul``: the hand-written Hopper kernel ``csrc/moe_dispatch.cu``
on CUDA tensors, its plain twin on CPU ones.  Everything stays on the
device: the sort, the counts, the slots and the number of row tiles in
use are tensors, so a layer never waits on the host.

The port dispatches on one device; the reference's expert-parallel
``_mars_dispatch_sharded`` is reached only by its training and dry-run
entry points (its serve path never hands the model a mesh), so it waits
for the parameter sharding rules.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core.reorder import mars_sort_by_page
from repro_torch.kernels.moe_dispatch.ops import grouped_ffn_padded
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

# Row tile of the serve path's grouped matmuls.  At decode a step routes
# 8 lanes x top-k tokens over the experts, so an expert's tile holds one
# or two real rows: 16 rows (the tensor cores' m16 fragment) is the
# smallest tile the kernel takes and pads each used expert least.
SERVE_BM = 16

# When a list, ``router_topk`` appends each call's per-token gap between
# the k-th and (k+1)-th router probabilities (a float32 tensor (T,)): the
# serve launcher's check reads it to tell a router near-tie from a fault.
ROUTER_GAPS = None


def moe_init(gen, cfg: ModelConfig, stack: int = 0) -> dict:
    """The reference's ``moe_init`` leaves: a float32 router (d, E), the
    expert weights ``w_in``/``w_gate`` (E, d, e) and ``w_out`` (E, e, d),
    and a ``shared`` gated MLP of width ``e * n_shared_experts`` when
    configured; ``stack`` > 0 stacks that many layers."""
    d = cfg.d_model
    e = cfg.d_expert or cfg.d_ff
    E = cfg.n_experts
    pd = cfg.pdtype
    out = {"router": layers._dense_init(gen, (d, E), torch.float32,
                                        stack=stack),
           "w_in": layers._dense_init(gen, (E, d, e), pd, stack=stack),
           "w_gate": layers._dense_init(gen, (E, d, e), pd, stack=stack),
           "w_out": layers._dense_init(gen, (E, e, d), pd, stack=stack)}
    if cfg.n_shared_experts:
        out["shared"] = layers.mlp_init(gen, cfg, stack,
                                        d_ff=e * cfg.n_shared_experts)
    return out


def router_topk(p, x, cfg: ModelConfig):
    """Returns (expert_idx (T, k), gates (T, k) in x's dtype, aux losses)
    for flat tokens x (T, d); the router runs in float32."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    if ROUTER_GAPS is not None and cfg.n_experts > cfg.top_k:
        top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
        ROUTER_GAPS.append(top[:, -2] - top[:, -1])
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    # load-balance aux (Switch-style) + router z-loss
    T = x.shape[0]
    me = probs.mean(0)
    ce = torch.zeros(cfg.n_experts, device=x.device).index_add_(
        0, idx.reshape(-1), torch.ones(T * cfg.top_k, device=x.device)) \
        / (T * cfg.top_k)
    aux_lb = cfg.n_experts * torch.sum(me * ce)
    aux_z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return idx, gates.to(x.dtype), {"moe_lb": aux_lb, "moe_z": aux_z}


# ---------------------------------------------------------------------------
# MARS-sorted grouped dispatch
# ---------------------------------------------------------------------------

def _grouped_ffn(tokens, local_ids, w_in, w_gate, w_out, n_local: int,
                 act: str, bm: int = SERVE_BM):
    """Sorted grouped FFN over contiguous per-expert segments.

    tokens: (A, d) already MARS-sorted by ``local_ids``.  The segments are
    padded to ``bm`` rows and the three products run through
    ``grouped_matmul`` (the reference's ``ragged_dot`` computes the same
    over the unpadded rows)."""
    return grouped_ffn_padded(tokens, local_ids, w_in, w_gate, w_out,
                              n_groups=n_local, act=act, bm=bm)


class _GatherRows(torch.autograd.Function):
    """``x.to(dtype)[src // k]`` for a permutation ``src`` of the T*k
    rows (``inv`` its inverse), whose backward is a gather too: row t of
    x's gradient sums the incoming rows ``inv[t*k .. t*k + k)`` in that
    order, in x's dtype, as the reference's scatter-add does.  Autograd
    of the index would scatter them by an accumulating ``index_put_``,
    which on CUDA sorts the indices first."""

    @staticmethod
    def forward(ctx, x, src, inv, k, dtype):
        ctx.save_for_backward(inv)
        ctx.k, ctx.x_dtype = k, x.dtype
        return x.to(dtype)[src // k if k > 1 else src]

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        gx = g[inv].to(ctx.x_dtype)
        if ctx.k > 1:
            gx = gx.view(-1, ctx.k, gx.shape[-1]).sum(1)
        return gx, None, None, None, None


def _mars_dispatch_local(p, xf, cfg: ModelConfig):
    """Single-device MARS dispatch: sort assignments by expert, grouped
    matmul, unsort.  (T, d) -> ((T, d), aux)."""
    E, k = cfg.n_experts, cfg.top_k
    idx, gates, aux = router_topk(p, xf, cfg)
    T, d = xf.shape
    flat_e = idx.reshape(-1)                      # (T*k,)
    perm, inv, sorted_e, _ = mars_sort_by_page(flat_e, E)
    cd = cfg.cdtype
    perm, inv = perm.long(), inv.long()
    # (T*k, d) page-ordered: row j is token perm[j] // k
    gathered = _GatherRows.apply(xf, perm, inv, k, cd)
    out_sorted = _grouped_ffn(gathered, sorted_e, p["w_in"].to(cd),
                              p["w_gate"].to(cd), p["w_out"].to(cd), E,
                              cfg.act)
    # back to assignment order
    out_flat = _GatherRows.apply(out_sorted, inv, perm, 1, cd)
    w = gates.reshape(-1, 1).to(cd)
    # the k weighted outputs of a token, summed in a fixed order (no
    # atomics), as the reference's scatter-add into zeros computes them
    y = (out_flat * w).view(T, k, d).sum(1)
    return y.to(xf.dtype), aux


def _mars_dispatch_sharded(p, xf, cfg: ModelConfig, mesh):
    """Expert-parallel dispatch across a mesh's ``model`` axis (reference
    ``moe.py:112``): not ported — only a training or dry-run mesh
    reaches it, and it needs the parameter sharding rules, which the port
    does not have yet."""
    raise NotImplementedError(
        "expert-parallel MoE dispatch (_mars_dispatch_sharded) needs the "
        "parameter sharding rules, which the torch port does not have yet; "
        "the port dispatches on one device")


def moe_apply_einsum(p, xf, cfg: ModelConfig):
    """Locality-oblivious baseline (GShard one-hot capacity dispatch):
    every token window is streamed through per-expert capacity buffers —
    the "interleaved streams" path MARS removes.  Assignments past an
    expert's capacity ``ceil(2 T k / E)`` are dropped, as in the
    reference."""
    E, k = cfg.n_experts, cfg.top_k
    T = xf.shape[0]
    idx, gates, aux = router_topk(p, xf, cfg)
    cap = max(1, int(math.ceil(T * k / E * 2.0)))
    # position of each assignment within its expert's capacity buffer
    onehot = F.one_hot(idx, E)                              # (T, k, E)
    pos = torch.cumsum(onehot.reshape(T * k, E), dim=0) - 1
    pos = pos.reshape(T, k, E)
    keep = (pos < cap) & (onehot > 0)
    # one_hot(pos, cap) * keep: positions outside [0, cap) give no row
    sel = ((pos[..., None] == torch.arange(cap, device=xf.device))
           & keep[..., None]).to(xf.dtype)                  # (T, k, E, cap)
    disp = (sel * gates[..., None, None]).sum(1)            # (T, E, cap)
    sel = sel.sum(1)                                        # (T, E, cap) 0/1
    cd = cfg.cdtype
    ex_in = torch.einsum("td,tec->ecd", xf.to(cd), sel.to(cd))
    h = torch.einsum("ecd,edf->ecf", ex_in, p["w_in"].to(cd))
    g = torch.einsum("ecd,edf->ecf", ex_in, p["w_gate"].to(cd))
    h = layers._act(g, cfg.act) * h
    out = torch.einsum("ecf,efd->ecd", h, p["w_out"].to(cd))
    y = torch.einsum("ecd,tec->td", out, disp.to(cd))
    return y, aux


@dataclasses.dataclass(frozen=True)
class MoeRuntime:
    dispatch: str = "mars"         # mars | einsum


_RUNTIME = MoeRuntime()


def set_dispatch(mode: str):
    global _RUNTIME
    if mode not in ("mars", "einsum"):
        raise ValueError(f"unknown MoE dispatch {mode!r}")
    _RUNTIME = MoeRuntime(dispatch=mode)


def moe_apply(p, x, cfg: ModelConfig):
    """x: (B, S, d) -> ((B, S, d), aux); adds the shared-expert path if
    configured."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    if _RUNTIME.dispatch == "einsum":
        y, aux = moe_apply_einsum(p, xf, cfg)
    else:
        y, aux = _mars_dispatch_local(p, xf, cfg)
    y = y.reshape(B, S, d)
    if cfg.n_shared_experts:
        y = y + layers.mlp_apply(p["shared"], x, cfg)
    return y, aux
