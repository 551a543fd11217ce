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

Under a mesh of processes whose ``model`` axis divides the experts
(``expert_parallel``), ``moe_apply`` takes the reference's
expert-parallel ``_mars_dispatch_sharded``: each model column holds its
experts' weights, runs the MARS-sorted window's slice destined to them
(``moe_column``) through the same grouped products, and the columns'
outputs are summed over ``model``.
"""
from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.nn.functional as F

from repro_torch.core.reorder import mars_sort_by_page
from repro_torch.kernels.moe_dispatch.ops import (_TakeRows,
                                                  grouped_ffn_padded)
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import context as shctx

# Row tile of the serve path's grouped matmuls.  At decode a step routes
# 8 lanes x top-k tokens over the experts, so an expert's tile holds one
# or two real rows: 16 rows (the tensor cores' m16 fragment) is the
# smallest tile the kernel takes and pads each used expert least.
SERVE_BM = 16

# When a list, ``router_topk`` appends each call's per-token gap between
# the k-th and (k+1)-th router probabilities (a float32 tensor (T,)): the
# serve launcher's check reads it to tell a router near-tie from a fault.
ROUTER_GAPS = None

# When a list, ``_mars_dispatch_sharded`` appends each call's rows its
# column dropped past its capacity (a one-element tensor, on the device).
COLUMN_DROPS = None


def moe_init(gen, cfg: ModelConfig, stack: int = 0) -> dict:
    """The reference's ``moe_init`` leaves: a float32 router (d, E), the
    expert weights ``w_in``/``w_gate`` (E, d, e) and ``w_out`` (E, e, d),
    and a ``shared`` gated MLP of width ``e * n_shared_experts`` when
    configured; ``stack`` > 0 stacks that many layers."""
    d = cfg.d_model
    e = cfg.d_expert or cfg.d_ff
    E = cfg.n_experts
    pd = cfg.pdtype
    up, down = ("expert", "embed", "mlp"), ("expert", "mlp", "embed")
    out = {"router": layers._dense_init(gen, (d, E), torch.float32,
                                        ("embed", "expert"), stack=stack),
           "w_in": layers._dense_init(gen, (E, d, e), pd, up, stack=stack),
           "w_gate": layers._dense_init(gen, (E, d, e), pd, up, stack=stack),
           "w_out": layers._dense_init(gen, (E, e, d), pd, down,
                                       stack=stack)}
    if cfg.n_shared_experts:
        out["shared"] = layers.mlp_init(gen, cfg, stack,
                                        d_ff=e * cfg.n_shared_experts)
    return out


def router_topk(p, x, cfg: ModelConfig, mesh=None):
    """Returns (expert_idx (T, k), gates (T, k) in x's dtype, aux losses)
    for flat tokens x (T, d); the router runs in float32.  Given a mesh
    of processes, x is this rank's share of tokens split over the data
    axes, and the aux losses are those of all of them, as the reference
    computes them over the global batch."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    if ROUTER_GAPS is not None and cfg.n_experts > cfg.top_k:
        top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
        ROUTER_GAPS.append(top[:, -2] - top[:, -1])
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    # load-balance aux (Switch-style) + router z-loss
    T = x.shape[0]
    counts = torch.zeros(cfg.n_experts, device=x.device).index_add_(
        0, idx.reshape(-1), torch.ones(T * cfg.top_k, device=x.device))
    z2 = torch.logsumexp(logits, dim=-1) ** 2
    if mesh is None:
        me, ce, aux_z = probs.mean(0), counts / (T * cfg.top_k), z2.mean()
    else:
        from repro_torch.sharding import dtensor
        daxes = shctx.data_axes(mesh)
        n = T * math.prod(mesh.shape[a] for a in daxes)
        me = dtensor.all_sum_grad(probs.sum(0), mesh, daxes) / n
        ce = dtensor.all_sum(counts, mesh, daxes) / (n * cfg.top_k)
        aux_z = dtensor.all_sum_grad(z2.sum(), mesh, daxes) / n
    aux_lb = cfg.n_experts * torch.sum(me * ce)
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


def _mars_dispatch_local(p, xf, cfg: ModelConfig, mesh=None):
    """Single-device MARS dispatch: sort assignments by expert, grouped
    matmul, unsort.  (T, d) -> ((T, d), aux).  ``mesh``: the data-split
    mesh of processes whose tokens the aux losses span
    (``router_topk``)."""
    E, k = cfg.n_experts, cfg.top_k
    idx, gates, aux = router_topk(p, xf, cfg, mesh)
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


# the expert weights, which an expert-parallel mesh keeps cut over
# ``model`` (the rest of a layer is gathered whole)
EXPERT_LEAVES = ("w_in", "w_gate", "w_out")


def expert_parallel(cfg: ModelConfig, mesh) -> bool:
    """Whether ``moe_apply`` takes the expert-parallel dispatch on
    ``mesh``: its model axis exceeds 1 and divides the experts (the
    reference's condition, ``moe.py:233-238`` there)."""
    n = mesh.shape.get("model", 1) if mesh is not None else 1
    return n > 1 and cfg.n_experts % n == 0


def column_capacity(n_assign: int, n_model: int) -> int:
    """Rows a model column computes of a window's ``n_assign`` sorted
    assignments: twice its even share (the paper's RequestQ-slot bound;
    overflow is dropped), or all of them under ``REPRO_MOE_FULL``."""
    if os.environ.get("REPRO_MOE_FULL"):
        return n_assign
    return int(math.ceil(n_assign / n_model * 2.0))


class _PutRows(torch.autograd.Function):
    """Rows ``x`` written at the distinct rows ``rows`` of an ``n``-row
    zero tensor; the backward takes those rows back."""

    @staticmethod
    def forward(ctx, x, rows, n):
        ctx.save_for_backward(rows)
        return x.new_zeros((n,) + x.shape[1:]).index_copy_(0, rows, x)

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        return g[rows], None, None


def moe_column(xf, idx, gates, w_in, w_gate, w_out, cfg: ModelConfig,
               col: int, n_model: int):
    """Column ``col``'s part of the expert-parallel dispatch (the body of
    the reference's ``_mars_dispatch_sharded``): MARS-sort the window's
    assignments by expert, take the contiguous slice ``[lo, lo + C)``
    from the first assignment to this column's experts (``C`` is
    ``column_capacity``), run the rows of those experts through the
    grouped products of this column's ``E / n_model`` experts ``w_*``,
    and scatter them back.  Rows of the slice bound for another column
    go to a dump group past the last expert, whose row tiles the kernels
    skip, and contribute 0, as do the column's rows past ``C``.
    Returns (this column's part of y (T, d), the rows it dropped: a
    one-element tensor); everything stays on the device."""
    E, k = cfg.n_experts, cfg.top_k
    E_loc = E // n_model
    T, d = xf.shape
    A = T * k
    C = column_capacity(A, n_model)
    cd = cfg.cdtype
    perm, inv, sorted_e, offsets = mars_sort_by_page(idx.reshape(-1), E)
    perm, inv = perm.long(), inv.long()
    gathered = _GatherRows.apply(xf, perm, inv, k, cd)       # (A, d)
    lo = offsets[col * E_loc].long()
    count = offsets[(col + 1) * E_loc].long() - lo
    j = torch.arange(C, device=xf.device)
    rows = (lo + j) % A                  # distinct, as C <= A
    mine = j < count                     # this column's experts come first
    local_e = torch.where(mine, sorted_e[rows].long() - col * E_loc, E_loc)
    xin = torch.where(mine[:, None], _TakeRows.apply(gathered, rows), 0)
    out_c = _grouped_ffn(xin, local_e, w_in.to(cd), w_gate.to(cd),
                         w_out.to(cd), E_loc + 1, cfg.act)
    out_c = torch.where(mine[:, None], out_c, 0)
    out_flat = _GatherRows.apply(_PutRows.apply(out_c, rows, A), inv, perm,
                                 1, cd)
    w = gates.reshape(-1, 1).to(cd)
    y = (out_flat * w).view(T, k, d).sum(1)
    return y, torch.clamp_min(count - C, 0).reshape(1)


def _mars_dispatch_sharded(p, xf, cfg: ModelConfig, mesh):
    """Expert-parallel dispatch over ``mesh``'s ``model`` axis (reference
    ``moe.py:112-190``): tokens split on the data axes and alike on every
    model column, experts cut over ``model``.  Every column routes its
    data row's window, runs ``moe_column`` on its experts (``p``'s
    ``w_*`` hold this column's ``E / n_model`` experts alone, as the
    trainer's ``kept_axes`` leaves them), and the parts are summed over
    ``model``.

    As shard_map's transpose does in the reference, the gradients the
    columns send back to what every column reads alike (the tokens and,
    through the gates, the router) are summed over ``model``: the sum
    is taken at the column's inputs (``dtensor.sum_backward``), so the
    router, the tokens and the aux losses reach every column alike.  The
    aux losses are those of the data shard, averaged over the data
    shards."""
    from repro_torch.sharding import dtensor
    if getattr(mesh, "dist", None) is None:
        raise ValueError("expert-parallel dispatch needs a mesh over "
                         "processes (launch.mesh.on_processes)")
    E = cfg.n_experts
    n_model = mesh.shape["model"]
    E_loc = E // n_model
    col = dtensor.coords(mesh)["model"]
    idx, gates, aux = router_topk(p, xf, cfg)
    w = [p[n] for n in EXPERT_LEAVES]
    if any(t.shape[0] != E_loc for t in w):
        raise ValueError(f"expert-parallel dispatch takes the column's "
                         f"{E_loc} experts, got {[t.shape[0] for t in w]}")
    y, dropped = moe_column(dtensor.sum_backward(xf, mesh, ("model",)), idx,
                            dtensor.sum_backward(gates, mesh, ("model",)),
                            *w, cfg, col, n_model)
    if COLUMN_DROPS is not None:
        COLUMN_DROPS.append(dropped)
    y = dtensor.sum_forward(y, mesh, ("model",))
    daxes = shctx.data_axes(mesh)
    n_data = math.prod(mesh.shape[a] for a in daxes)
    aux = {k: dtensor.all_sum_grad(v, mesh, daxes) / n_data
           for k, v in aux.items()}
    return y.to(xf.dtype), aux


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
    mesh = shctx.current_mesh()
    if _RUNTIME.dispatch == "einsum":
        y, aux = moe_apply_einsum(p, xf, cfg)
    elif expert_parallel(cfg, mesh):
        y, aux = _mars_dispatch_sharded(p, xf, cfg, mesh)
    else:
        spread = mesh is not None and getattr(mesh, "dist", None) is not None
        y, aux = _mars_dispatch_local(p, xf, cfg, mesh if spread else None)
    y = y.reshape(B, S, d)
    if cfg.n_shared_experts:
        y = y + layers.mlp_apply(p["shared"], x, cfg)
    return y, aux
