"""Mamba2 (SSD — state-space duality) layer, chunked, with O(1) decode
(port of ``repro/models/ssm.py``).

Prefill runs the chunked scan through ``kernels.ssd_scan.ssd_scan``: the
hand-written Hopper kernel on CUDA tensors, its plain twin on CPU ones;
in training its backward is the kernel B3 (``ssd_scan_bwd``).
Decode applies the recurrence directly, in plain torch, as the reference
does in jnp.

Shapes: d_inner = expand*d_model, H = d_inner/d_ssm_head heads of size P,
state size N, single B/C group shared across heads (n_groups=1).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import dtensor


def ssm_dims(cfg: ModelConfig):
    d_in = cfg.d_inner_ssm
    P = cfg.d_ssm_head
    H = d_in // P
    N = cfg.ssm_state
    return d_in, H, P, N


def ssm_init(gen: torch.Generator, cfg: ModelConfig, stack: int = 0) -> dict:
    """Random SSM parameters with the reference's distributions and
    layout (``stack`` > 0 draws that many layers on a leading axis):
    N(0, 1/fan_in) projections, conv weights at scale 1/sqrt(k), zero
    conv biases, ``a_log = log(linspace(1, 16, H))``, ``dt_bias`` zeros
    and ``d_skip`` ones in float32, ``norm`` ones."""
    d = cfg.d_model
    d_in, H, P, N = ssm_dims(cfg)
    k = cfg.ssm_conv
    pd, f32 = cfg.pdtype, torch.float32
    inner, small, heads = ("ssm_in",), ("ssm_small",), ("ssm_heads",)

    def a_log(full):
        return torch.log(torch.linspace(1.0, 16.0, H, dtype=f32,
                                        device=gen.device)).expand(full)
    return {
        "w_zx": layers._dense_init(gen, (d, 2 * d_in), pd,
                                   ("embed",) + inner, stack=stack),
        "w_bcdt": layers._dense_init(gen, (d, 2 * N + H), pd,
                                     ("embed",) + small, stack=stack),
        "conv_w": layers._dense_init(gen, (k, d_in), pd, ("conv",) + inner,
                                     scale=1.0 / math.sqrt(k), stack=stack),
        "conv_b": layers._const(gen, (d_in,), pd, inner, 0.0, stack),
        "conv_w_bc": layers._dense_init(gen, (k, 2 * N), pd,
                                        ("conv",) + small,
                                        scale=1.0 / math.sqrt(k),
                                        stack=stack),
        "conv_b_bc": layers._const(gen, (2 * N,), pd, small, 0.0, stack),
        "a_log": layers._given(gen, (H,), heads, a_log, stack),
        "dt_bias": layers._const(gen, (H,), f32, heads, 0.0, stack),
        "d_skip": layers._const(gen, (H,), f32, heads, 1.0, stack),
        "norm": layers._const(gen, (d_in,), pd, inner, 1.0, stack),
        "w_out": layers._dense_init(gen, (d_in, d), pd, inner + ("embed",),
                                    stack=stack),
    }


def _split_proj(p, x, cfg: ModelConfig, tp=None):
    """(z, x, bc, dt) of the input.  Under tensor parallelism (``tp``)
    ``w_zx`` holds this rank's heads' columns of both halves, x's
    gradient through them is summed over ``model``, and dt is this
    rank's heads' (``w_bcdt`` is whole)."""
    d_in, H, P, N = ssm_dims(cfg)
    cd = cfg.cdtype
    xin = x if tp is None else tp.sum_backward(x)
    zx = torch.einsum("bsd,dk->bsk", xin, p["w_zx"].to(cd))
    half = zx.shape[-1] // 2
    z, xs = torch.split(zx, [half, half], dim=-1)
    bcdt = torch.einsum("bsd,dk->bsk", x, p["w_bcdt"].to(cd))
    bc, dt = torch.split(bcdt, [2 * N, H], dim=-1)
    if tp is not None:
        h0, h1 = tp.ssm_heads(cfg)
        dt = tp.sum_backward(dt)[..., h0:h1]
    return z, xs, bc, dt


def _causal_conv(xbc, w, b, cfg: ModelConfig, conv_state=None):
    """Depthwise causal conv.  conv_state: (B, k-1, ch) trailing context
    for decode.  Returns (out, new_conv_state)."""
    k = cfg.ssm_conv
    w = w.to(xbc.dtype)                     # (k, ch)
    if conv_state is not None:
        buf = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    else:
        buf = F.pad(xbc, (0, 0, k - 1, 0))
    S = xbc.shape[1]
    out = sum(buf[:, i:i + S, :] * w[i] for i in range(k))
    out = F.silu(out + b.to(xbc.dtype))
    new_state = buf[:, buf.shape[1] - (k - 1):, :]
    return out, new_state


def ssm_apply(p, x, cfg: ModelConfig, *, state=None, conv_state=None,
              return_state: bool = False):
    """Full Mamba2 layer.  x: (B,S,d).  With ``state``/``conv_state`` given
    (decode), S must be 1 and the recurrence is applied directly.  With
    ``return_state`` also returns ``(state (B,H,P,N) float32, conv_state
    (B, k-1, d_in + 2N))``.

    Under tensor parallelism (``dtensor.model_rank``) ``p`` holds this
    rank's heads (``rules.model_cut``) and the layer computes them:
    ``state`` is theirs, ``conv_state`` is whole (its new x channels
    are put together over ``model``), the grouped norm's sum of squares
    is summed over ``model`` and ``w_out``'s row-parallel output too."""
    d_in, H, P, N = ssm_dims(cfg)
    tp = dtensor.model_rank()
    h0, h1 = (0, H) if tp is None else tp.ssm_heads(cfg)
    z, xs_raw, bc_raw, dt_raw = _split_proj(p, x, cfg, tp)
    cs_x = cs_bc = None
    if conv_state is not None:
        cs_x, cs_bc = conv_state[..., h0 * P:h1 * P], conv_state[..., d_in:]
    xs, new_conv_x = _causal_conv(xs_raw, p["conv_w"], p["conv_b"], cfg,
                                  cs_x)
    bc, new_conv_bc = _causal_conv(bc_raw, p["conv_w_bc"], p["conv_b_bc"],
                                   cfg, cs_bc)
    if tp is not None:
        bc = tp.sum_backward(bc)
        if return_state:
            new_conv_x = tp.put_together(new_conv_x, 2, (h0 * P, h1 * P),
                                         d_in)
    new_conv = torch.cat([new_conv_x, new_conv_bc], dim=-1)
    b, c = torch.split(bc, [N, N], dim=-1)
    Bsz, S = x.shape[0], x.shape[1]
    H = h1 - h0
    xs = xs.reshape(Bsz, S, H, P)
    dt = F.softplus(layers.at_least_f32(dt_raw) + p["dt_bias"])  # (B,S,H)
    a = -torch.exp(p["a_log"])                            # (H,)
    la = dt * a                                           # log decay

    if state is not None:
        # O(1) decode: s' = s*exp(la) + dt * x (outer) B
        dec = torch.exp(la[:, 0])[:, :, None, None]       # (B,H,1,1)
        upd = torch.einsum("bhp,bn->bhpn",
                           dt[:, 0, :, None] * xs[:, 0].float(),
                           b[:, 0].float())
        new_state = state * dec + upd
        y = torch.einsum("bhpn,bn->bhp", new_state,
                         c[:, 0].float())[:, None]
    elif H == 0:
        # a model rank with no SSM heads launches nothing: zeros, tied to
        # the scan's inputs (as ``layers.sdpa``'s empty rank) so that its
        # backward reaches the collectives the other ranks' backward runs
        y = xs.new_zeros(xs.shape, dtype=torch.float32) \
            + 0 * (b.sum() + c.sum() + la.sum() + dt.sum())
        new_state = xs.new_zeros((Bsz, 0, P, N), dtype=torch.float32)
    else:
        # la and dt stay float32, as in the decode recurrence above (the
        # reference rounds them to x's dtype here, ssm.py:175-176, so its
        # bf16 prefill and decode compute different decays)
        y, new_state = ssd_scan(xs, b.contiguous(), c.contiguous(), la, dt,
                                chunk=cfg.ssm_chunk)

    y = y + p["d_skip"][:, None] * layers.at_least_f32(xs)
    y = y.reshape(Bsz, S, H * P).to(x.dtype)
    y = y * F.silu(z)
    # grouped RMS norm over d_inner
    y32 = layers.at_least_f32(y)
    if tp is None:
        ms = (y32 ** 2).mean(-1, keepdim=True)
    else:
        ms = tp.sum_both((y32 ** 2).sum(-1, keepdim=True)) / d_in
    y = (y32 * torch.rsqrt(ms + cfg.norm_eps)).to(x.dtype)
    y = y * p["norm"].to(x.dtype)
    out = torch.einsum("bsk,kd->bsd", y, p["w_out"].to(cfg.cdtype))
    if tp is not None:
        out = tp.sum_forward(out)
    if return_state:
        return out, (new_state, new_conv)
    return out


def ssm_state_shapes(cfg: ModelConfig, batch: int):
    d_in, H, P, N = ssm_dims(cfg)
    return ((batch, H, P, N), (batch, cfg.ssm_conv - 1, d_in + 2 * N))
