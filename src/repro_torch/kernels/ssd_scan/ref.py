"""Plain oracle for the SSD chunked scan: the sequential recurrence (port
of ``repro/kernels/ssd_scan/ref.py``).

y_t = C_t . s_t,   s_t = exp(la_t) * s_{t-1} + dt_t * (x_t (x) B_t)

This is the O(S) literal recurrence; the chunked scan must match it.
"""
from __future__ import annotations

import torch


def ssd_ref(x, b, c, la, dt):
    """x: (B,S,H,P); b,c: (B,S,N); la,dt: (B,S,H) -> (y (B,S,H,P) f32,
    state (B,H,P,N) f32), starting from a zero state."""
    Bz, S, H, P = x.shape
    N = b.shape[-1]
    x, b, c, la, dt = (t.float() for t in (x, b, c, la, dt))
    s = torch.zeros((Bz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        s = s * torch.exp(la[:, t])[:, :, None, None] \
            + torch.einsum("bhp,bn->bhpn", dt[:, t, :, None] * x[:, t],
                           b[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", s, c[:, t]))
    y = torch.stack(ys, 1) if ys else x.new_zeros((Bz, 0, H, P))
    return y, s
