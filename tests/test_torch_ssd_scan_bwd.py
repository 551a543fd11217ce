"""Port parity for B3, the backward of the SSD (Mamba2) chunked scan:
``ssd_scan_bwd_plain`` (the CUDA kernel's plain twin, its passes in
float32 torch) against ``jax.vjp`` of the reference's ``ssd_chunked``
(``repro/models/ssm.py``, what the JAX trainer differentiates) and of
its sequential oracle ``ssd_ref`` with a nonzero final-state
cotangent; ``ssd_scan`` with an input that needs a gradient as the
autograd Function (K3 forward, B3 backward; their twins on the CPU),
checked by ``torch.autograd.gradcheck`` in float64 and against autograd
through ``ssd_scan_plain``; and B3's plan and wrapper checks.  Inputs
come from numpy and feed both sides.

Tolerances: each gradient within 1e-4 of its largest magnitude against
JAX (float32; the same arithmetic in another order, measured about
1e-6); against autograd through the forward twin the same, and for
bfloat16 inputs one bf16 spacing more on dx, db and dc (both sides round
the same float32 gradients, summed in another order, to bf16)."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.ref import ssd_ref as jssd_ref  # noqa: E402
from repro.models.ssm import ssd_chunked  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as tmod  # noqa: E402
from repro_torch.models.ssm import ssm_dims  # noqa: E402

torch.set_num_threads(1)

REL = 1e-4
NAMES = ("dx", "db", "dc", "dla", "ddt")


def _smoke_scan(arch, B=2, S=24):
    cfg = configs.get_smoke(arch)
    _, H, P, N = ssm_dims(cfg)
    return (B, S, H, P, N, cfg.ssm_chunk)


# (B, S, H, P, N, chunk): one chunk; one chunk of 24 under chunk 64 (the
# serve prefill); several chunks; chunks of one position; a chunk that is
# not a power of two; mamba2's width (N 128) over 2 chunks; the mamba2 and
# hymba smoke configs' scans
SHAPES = [(1, 16, 2, 8, 4, 16), (1, 24, 3, 16, 8, 64), (2, 64, 3, 8, 4, 16),
          (2, 8, 2, 4, 4, 1), (1, 96, 1, 8, 4, 24), (1, 128, 2, 16, 128, 64),
          _smoke_scan("mamba2_370m"), _smoke_scan("hymba_1_5b")]


def _inputs(B, S, H, P, N, seed=0, dt_shift=0.0):
    """x, b, c, la, dt as the model feeds them (dt = softplus(normal +
    ``dt_shift``), la a negative log decay), dy and a final-state
    cotangent; float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    b = rng.standard_normal((B, S, N)).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) + dt_shift)) \
        .astype(np.float32)
    la = (-np.exp(0.3 * rng.standard_normal((B, S, H))) * dt) \
        .astype(np.float32)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    ds = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return (x, b, c, la, dt), dy, ds


def _assert_rel(got, want, name, rel=REL, spacing=False):
    """|got - want| <= rel * max|want| (+ one bf16 spacing of want)."""
    got = got.detach().float().numpy() if hasattr(got, "detach") \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    bound = rel * max(float(np.abs(want).max()), 1e-30)
    if spacing:
        _, e = np.frexp(want)
        bound = bound + np.ldexp(np.ones_like(want), e - 8)
    assert (np.abs(got - want) <= bound).all(), (
        f"{name}: largest err {np.abs(got - want).max():.3e}, "
        f"max|want| {np.abs(want).max():.3e}")


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """CPU tensors never reach K3 or B3."""
    before = (tmod.ssd_scan.launches, tmod.ssd_scan_bwd.launches)
    yield
    assert (tmod.ssd_scan.launches, tmod.ssd_scan_bwd.launches) == before


def _jax_vjp(fn, arrays, dy, ds):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in arrays))
    ct = jnp.zeros_like(out[1]) if ds is None else jnp.asarray(ds)
    return vjp((jnp.asarray(dy), ct))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
def test_bwd_plain_matches_jax_vjp_of_ssd_chunked(B, S, H, P, N, chunk,
                                                  with_state):
    arrays, dy, ds = _inputs(B, S, H, P, N)
    ds = ds if with_state else None
    cfg = types.SimpleNamespace(ssm_chunk=chunk)
    want = _jax_vjp(lambda *a: ssd_chunked(*a, cfg), arrays, dy, ds)
    got = tmod.ssd_scan_bwd_plain(
        *(torch.from_numpy(a) for a in arrays), torch.from_numpy(dy),
        None if ds is None else torch.from_numpy(ds), chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32, name
        _assert_rel(g, w, name)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
def test_bwd_plain_matches_jax_vjp_with_slow_decays(B, S, H, P, N, chunk,
                                                   with_state):
    """dt drawn 5 lower (about 0.01): each chunk's decay exp(cum_end)
    lies near 0.5 rather than vanishing, so the gradient carried back
    across chunks and exp(cum_end) d(decay) in dla count."""
    arrays, dy, ds = _inputs(B, S, H, P, N, seed=4, dt_shift=-5.0)
    q = tmod.chunk_len(S, chunk)
    decay = np.exp(arrays[3].reshape(B, S // q, q, H).sum(2))
    assert 0.05 < float(np.median(decay)) < 0.999
    ds = ds if with_state else None
    cfg = types.SimpleNamespace(ssm_chunk=chunk)
    want = _jax_vjp(lambda *a: ssd_chunked(*a, cfg), arrays, dy, ds)
    got = tmod.ssd_scan_bwd_plain(
        *(torch.from_numpy(a) for a in arrays), torch.from_numpy(dy),
        None if ds is None else torch.from_numpy(ds), chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        _assert_rel(g, w, name)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [(1, 16, 2, 8, 4, 16),
                                              (2, 64, 3, 8, 4, 16),
                                              (1, 48, 2, 8, 8, 8)])
def test_bwd_plain_matches_jax_vjp_of_the_sequential_oracle(B, S, H, P, N,
                                                            chunk):
    """The final state's cotangent through the literal recurrence."""
    arrays, dy, ds = _inputs(B, S, H, P, N, seed=1)
    want = _jax_vjp(jssd_ref, arrays, dy, ds)
    got = tmod.ssd_scan_bwd_plain(
        *(torch.from_numpy(a) for a in arrays), torch.from_numpy(dy),
        torch.from_numpy(ds), chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        _assert_rel(g, w, name, rel=2e-4)


def test_bwd_plain_takes_the_entering_states_it_would_recompute():
    arrays, dy, ds = _inputs(2, 64, 3, 8, 4)
    t = [torch.from_numpy(a) for a in arrays]
    _, _, entering = tmod.ssd_scan_plain(*t, chunk=16, keep=True)
    _, s_prev = _chunked_entering(*t, chunk=16)
    torch.testing.assert_close(entering, s_prev, atol=2e-4, rtol=2e-4)
    a = tmod.ssd_scan_bwd_plain(*t, torch.from_numpy(dy),
                                torch.from_numpy(ds), chunk=16)
    b = tmod.ssd_scan_bwd_plain(*t, torch.from_numpy(dy),
                                torch.from_numpy(ds), chunk=16,
                                entering=entering)
    for g, h in zip(a, b):
        assert torch.equal(g, h)
    assert tmod.ssd_scan_plain(*t, chunk=64, keep=True)[2] is None


def _chunked_entering(x, b, c, la, dt, chunk):
    """The entering states by the sequential recurrence, one chunk at a
    time (the state after each chunk's last position)."""
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    Bz, S, H, P = x.shape
    q = tmod.chunk_len(S, chunk)
    states = [torch.zeros((Bz, H, P, b.shape[-1]))]
    for ic in range(1, S // q):
        sl = slice(0, ic * q)
        states.append(ssd_ref(x[:, sl], b[:, sl], c[:, sl], la[:, sl],
                              dt[:, sl])[1])
    return None, torch.stack(states, 1)


def test_function_passes_gradcheck_in_float64():
    """Two chunks, both outputs, every input; the twins compute in
    float64 for float64 inputs."""
    rng = np.random.default_rng(2)
    B, S, H, P, N = 1, 8, 2, 3, 2
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
    la = -np.exp(0.3 * rng.standard_normal((B, S, H))) * dt
    ins = [torch.from_numpy(a).requires_grad_() for a in (
        rng.standard_normal((B, S, H, P)), rng.standard_normal((B, S, N)),
        rng.standard_normal((B, S, N)), la, dt)]
    assert all(t.dtype == torch.float64 for t in ins)
    y, s = tmod.ssd_scan(*ins, chunk=4)
    assert type(y.grad_fn).__name__ == "_SSDScanBackward"
    assert y.dtype == s.dtype == torch.float64
    assert torch.autograd.gradcheck(lambda *a: tmod.ssd_scan(*a, chunk=4),
                                    ins)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [(1, 16, 2, 8, 4, 16),
                                              (2, 64, 3, 8, 4, 16),
                                              (1, 24, 3, 16, 8, 64),
                                              _smoke_scan("mamba2_370m")])
def test_function_matches_autograd_through_the_plain_twin(B, S, H, P, N,
                                                          chunk, with_state,
                                                          dtype):
    """The Function's gradients (B3's twin) against autograd through
    ``ssd_scan_plain``, x, b and c in ``dtype`` and la, dt in float32 as
    the model passes them, the loss y . dy (+ state . ds)."""
    arrays, dy, ds = _inputs(B, S, H, P, N, seed=3)
    td = getattr(torch, dtype)
    grads = []
    for fn in (tmod.ssd_scan, tmod.ssd_scan_plain):
        ins = [torch.from_numpy(a).to(td if i < 3 else torch.float32)
               .requires_grad_() for i, a in enumerate(arrays)]
        y, s = fn(*ins, chunk=chunk)
        loss = (y * torch.from_numpy(dy)).sum()
        if with_state:
            loss = loss + (s * torch.from_numpy(ds)).sum()
        grads.append(torch.autograd.grad(loss, ins))
    for i, (name, g, w) in enumerate(zip(NAMES, *grads)):
        assert g.dtype == w.dtype, name
        _assert_rel(g, w.float(), name,
                    spacing=dtype == "bfloat16" and i < 3)


def test_ssd_scan_is_the_function_only_with_a_gradient_to_take():
    arrays, _, _ = _inputs(1, 16, 2, 8, 4)
    t = [torch.from_numpy(a) for a in arrays]
    y, _ = tmod.ssd_scan(*t, chunk=8)
    assert y.grad_fn is None
    t[3].requires_grad_()
    with torch.no_grad():
        assert tmod.ssd_scan(*t, chunk=8)[0].grad_fn is None
    y, s = tmod.ssd_scan(*t, chunk=8)
    assert type(y.grad_fn).__name__ == "_SSDScanBackward"
    py, ps = tmod.ssd_scan_plain(*t, chunk=8)
    assert torch.equal(y, py) and torch.equal(s, ps)
    # the trainer drops the state: its gradient reaches backward as None
    (g,) = torch.autograd.grad(y.sum(), [t[3]])
    assert torch.isfinite(g).all()


# ---- B3's split TF32 products, emulated ------------------------------------

def _tf32(t):
    """t rounded as the kernel hands an operand to the tensor cores: its
    low 13 mantissa bits cleared."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split_einsum(spec, a, b, sa, sb):
    """``einsum(spec, a, b)`` in float32 as B3 forms a product: hi = a
    rounded, lo = (a - hi) rounded, lo_a hi_b + hi_a lo_b + hi_a hi_b for
    the sides split (``sa``, ``sb``: an exact side, x, b or c in bf16,
    goes whole); with neither split, one rounding of each side."""
    ah, bh = _tf32(a), _tf32(b)
    out = torch.einsum(spec, ah, bh)
    if sa:
        out = out + torch.einsum(spec, _tf32(a - ah), bh)
    if sb:
        out = out + torch.einsum(spec, ah, _tf32(b - bh))
    return out


def _b3_emulated(x, b, c, la, dt, dy, d_state, chunk, exact, split=True):
    """B3's gradients with every product as the kernels form it
    (``_split_einsum``; ``exact``: x, b and c are exact in TF32, as bf16
    inputs are) and the rest in float32, by ``ssd_scan_bwd_plain``'s
    passes: U_c and the reverse pass, C B^T, dW, W^T dy, b G^T, x G, dCB^T
    C, dCB B, dy s_{c-1}.  ``split=False``: one rounding, no lo terms."""
    def mm(spec, a_, b_, sa, sb):
        return _split_einsum(spec, a_, b_, sa and split, sb and split)
    sx = not exact                        # x, b, c need splitting
    Bz, S, H, P = x.shape
    N = b.shape[-1]
    q = tmod.chunk_len(S, chunk)
    nc = S // q
    entering = tmod.ssd_scan_plain(x, b, c, la, dt, chunk=chunk,
                                   keep=True)[2] if nc > 1 else None
    xc, dyc = x.reshape(Bz, nc, q, H, P), dy.reshape(Bz, nc, q, H, P)
    bc, cc = b.reshape(Bz, nc, q, N), c.reshape(Bz, nc, q, N)
    dtc = dt.reshape(Bz, nc, q, H)
    cum = torch.cumsum(la.reshape(Bz, nc, q, H), dim=2)
    e, f = torch.exp(cum), torch.exp(cum[:, :, -1:] - cum)
    decay = torch.exp(cum[:, :, -1])
    U = mm("bcthp,bctn->bchpn", e[..., None] * dyc, cc, True, sx)
    G = torch.zeros((Bz, H, P, N)) if d_state is None else d_state
    gs, d_decay = [None] * nc, torch.zeros_like(decay)
    for ic in reversed(range(nc)):
        gs[ic] = G
        if ic > 0:
            d_decay[:, ic] = (G * entering[:, ic]).sum((-2, -1))
            G = decay[:, ic, :, None, None] * G + U[:, ic]
    gs = torch.stack(gs, 1)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    D = torch.where(tri[:, :, None], torch.exp(torch.clamp_max(li, 0.0)),
                    torch.zeros(()))
    below = torch.tril(tri, -1)[:, :, None]
    m = torch.where(below, (li < 0).float() + 0.5 * (li == 0).float(),
                    torch.zeros(()))
    cb = mm("bctn,bckn->bctk", cc, bc, sx, sx)[..., None]
    dtk = dtc[:, :, None]
    dW = mm("bcthp,bckhp->bctkh", dyc, xc, True, sx)
    gb = mm("bckn,bchpn->bckhp", bc, gs, sx, True)
    fdt = f * dtc
    dx = mm("bctkh,bcthp->bckhp", cb * D * dtk, dyc, True, True) \
        + fdt[..., None] * gb
    r = (xc * gb).sum(-1)
    Q = dW * D * cb
    ddt = Q.sum(2) + f * r
    gl = Q * dtk * m
    dcum = gl.sum(3) - gl.sum(2) - fdt * r
    dcum[:, :, -1] += (fdt * r).sum(2) + decay * d_decay
    dcb = (dW * D * dtk).sum(-1)
    xg = mm("bckhp,bchpn->bckhn", xc, gs, sx, True)
    db = mm("bctk,bctn->bckn", dcb, cc, True, sx) \
        + (fdt[..., None] * xg).sum(3)
    dc = mm("bctk,bckn->bctn", dcb, bc, True, sx)
    if entering is not None:
        sdy = mm("bcthp,bchpn->bcthn", dyc, entering, True, True)
        dc = dc + (e[..., None] * sdy).sum(3)
        dcum = dcum + e * (cc[:, :, :, None] * sdy).sum(-1)
    dla = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    return (dx.reshape(Bz, S, H, P), db.reshape(Bz, S, N),
            dc.reshape(Bz, S, N), dla.reshape(Bz, S, H), ddt.reshape(Bz, S, H))


# (B, S, H, P, N, chunk, seed): a small multi-chunk scan with slow decays
# (the reverse pass counts), and one chunk pair at mamba2's training width
SPLIT_SHAPES = [(2, 64, 3, 8, 4, 16, 4), (1, 128, 2, 64, 128, 64, 5)]


def _split_case(B, S, H, P, N, chunk, seed, dtype):
    """Inputs (x, b, c rounded to ``dtype`` as the kernel reads them, all
    float32), dy, a final-state gradient, and the float64 gradients of
    those same values."""
    arrays, dy, ds = _inputs(B, S, H, P, N, seed=seed, dt_shift=-5.0)
    t = [torch.from_numpy(a) for a in arrays]
    t = [a.to(getattr(torch, dtype)).float() if i < 3 else a
         for i, a in enumerate(t)]
    dy, ds = torch.from_numpy(dy), torch.from_numpy(ds)
    want = tmod.ssd_scan_bwd_plain(*(a.double() for a in t), dy.double(),
                                   ds.double(), chunk=chunk)
    return t, dy, ds, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk,seed", SPLIT_SHAPES)
def test_bwd_split_tf32_products_meet_b3_rel(B, S, H, P, N, chunk, seed,
                                             dtype):
    """With every product split as the kernels split it (3xTF32; 2 passes
    where an exact bf16 x, b or c is a side), each gradient lies within
    B3_REL (1e-4 of its largest magnitude, chip_smoke.B3_REL) of float64
    on the same inputs."""
    t, dy, ds, want = _split_case(B, S, H, P, N, chunk, seed, dtype)
    got = _b3_emulated(*t, dy, ds, chunk, exact=dtype == "bfloat16")
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32, name
        _assert_rel(g, w, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_one_tf32_rounding_misses_b3_rel(dtype):
    """The hazard the split answers: one TF32 rounding of each operand (no
    lo terms) misses B3_REL at the mamba2 chunk pair's seeded inputs."""
    t, dy, ds, want = _split_case(*SPLIT_SHAPES[1], dtype)
    got = _b3_emulated(*t, dy, ds, SPLIT_SHAPES[1][5],
                       exact=dtype == "bfloat16", split=False)
    worst = max(float((g.double() - w).abs().max() / w.abs().max())
                for g, w in zip(got, want))
    assert worst > REL, worst


# ---- B3's plan and the wrapper's checks ---------------------------------

# n-tiles (8 columns) a warp of the grad kernel may own of a (q, q), (q, P)
# and (q, N) output (kNtQQ, kNtQP, kNtQN in csrc/ssd_scan_bwd.cu)
TILE_COLS = (2, 2, 4)


def _tiles(M, N, ntmax):
    """How the grad kernel's warps cut an M x N output (``tiles_of`` in
    the ``.cu``): (m-tiles of 16 rows, n-tiles of 8 columns, n-tiles a
    warp, warps a row of m-tiles), the fewest n-tiles a warp that leave
    at most BWD_WARPS warps, up to ``ntmax``."""
    mt, nt = M // 16, N // 8
    for ntw in range(1, ntmax + 1):
        if mt * -(-nt // ntw) <= tmod.BWD_WARPS or ntw == ntmax:
            return mt, nt, ntw, -(-nt // ntw)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (8, 512, 32, 64, 128, 64), (8, 512, 50, 64, 16, 64),
    (1, 4096, 32, 64, 128, 64), (8, 24, 32, 64, 128, 64),
    (1, 24, 50, 64, 16, 64), *SHAPES])
@pytest.mark.parametrize("sm_count", [1, 132])
def test_bwd_plan_fits_and_covers_every_head(B, S, H, P, N, chunk,
                                             sm_count):
    """The grad kernel's head groups cover every head once; both kernels'
    shared memory fits a block in either dtype; each of its (q, q), (q, P)
    and (q, N) outputs is cut into at most one tile pair a warp, every
    tile once; the state kernel's m-tiles (1, 2 or 4, no more than P's)
    leave two blocks an SM where they are more than one; the launches a
    call."""
    q = tmod.chunk_len(S, chunk)
    hg = tmod.bwd_plan(B, S, H, P, N, q, sm_count)
    assert 1 <= hg <= H and hg == -(-H // -(-H // hg))
    seen = np.zeros(H, np.int64)
    for g in range(-(-H // hg)):
        seen[g * hg:min(H, (g + 1) * hg)] += 1
    assert (seen == 1).all()
    for dtype in (torch.float32, torch.bfloat16):
        for kernel in ("grad", "state"):
            assert tmod.bwd_smem_bytes(q, P, N, kernel, dtype) \
                <= tmod._SMEM_LIMIT
    qp, pp, np_ = (-(-v // 16) * 16 for v in (q, P, N))
    for (M, Nn), ntmax in zip(((qp, qp), (qp, pp), (qp, np_)), TILE_COLS):
        mt, nt, ntw, cpr = _tiles(M, Nn, ntmax)
        assert mt * cpr <= tmod.BWD_WARPS and ntw <= ntmax
        cover = np.zeros((mt, nt), np.int64)
        for w in range(mt * cpr):
            for j in range(ntw):
                if (w % cpr) * ntw + j < nt:
                    cover[w // cpr, (w % cpr) * ntw + j] += 1
        assert (cover == 1).all()
    mt = tmod.bwd_state_tiles(B, H, P, sm_count)
    assert mt in (1, 2, 4) and mt <= tmod.bwd_state_tiles_max(P)
    assert mt == 1 or -(-P // (16 * mt)) * H * B >= 2 * sm_count
    assert tmod.bwd_launches(S // q) == (3 if S > q else 2)


@pytest.mark.parametrize("dtype,grad,state", [
    ("bfloat16", 156256, 108544), ("float32", 197216, 107264)])
def test_bwd_smem_at_mamba2_training_width(dtype, grad, state):
    """q 64, P 64, N 128: the grad kernel's layout (b, c and x in their
    dtype, rows padded 4 or 8 floats, bf16 rows 8 elements, modulo a
    bank row; dy, W, G_c, s_{c-1} in f32; two sets of per-position
    vectors, the partials, dcum and f dt r) and the state kernel's ring at
    its most m-tiles, 4 (3 stages of c, dy's 64 rows and la in bf16, 2 in
    f32); one block of each takes the byte counts below; the plan puts 16
    heads a grad block and 2 m-tiles a state block at 132 SMs (hymba: 25
    and 4)."""
    es = 2 if dtype == "bfloat16" else 4
    ldb = 136 if es == 2 else 132
    ldx = 72 if es == 2 else 68
    want = sum(-(-v // 16) * 16 for v in (
        64 * ldb * es, 64 * ldb * es, 64 * ldx * es, 64 * 68 * 4,
        64 * 72 * 4, 64 * 132 * 4, 64 * 136 * 4, 2 * (4 * 64 + 4) * 4,
        (8 * 64 + 3 * 256 + 16) * 4, 2 * 64 * 4))
    td = getattr(torch, dtype)
    assert tmod.bwd_smem_bytes(64, 64, 128, "grad", td) == want == grad
    stage = 64 * 136 * es + 64 * 72 * 4 + 64 * 4
    assert tmod.bwd_smem_bytes(64, 64, 128, "state", td) == state == \
        (3 if es == 2 else 2) * stage + 64 * 4
    assert state <= tmod._SMEM_LIMIT // 2     # two blocks an SM
    assert tmod.bwd_plan(8, 512, 32, 64, 128, 64, 132) == 16
    assert tmod.bwd_plan(8, 512, 50, 64, 16, 64, 132) == 25
    assert tmod.bwd_state_tiles(8, 32, 64, 132) == 2
    assert tmod.bwd_state_tiles(8, 50, 64, 132) == 4
    assert tmod.bwd_state_tiles(1, 32, 64, 132) == 1


def test_bwd_wrapper_never_falls_back():
    """Operands B3 does not take raise before any build; ones it takes go
    to the build (which needs nvcc) — never to the plain twin."""
    arrays, dy, ds = _inputs(1, 32, 2, 8, 4)
    x, b, c, la, dt = (torch.from_numpy(a) for a in arrays)
    dy, ds = torch.from_numpy(dy), torch.from_numpy(ds)
    _, _, saved = tmod.ssd_scan_with_states(x, b, c, la, dt, chunk=16)
    saved = (saved[0], torch.ones(1, 2, 2))
    launch = tmod._bwd_launch
    with pytest.raises(ValueError, match="entering states"):
        launch(x, b, c, la, dt, dy, None, 16, None)
    with pytest.raises(TypeError, match="one dtype"):
        launch(x, b.bfloat16(), c, la, dt, dy, None, 16, saved)
    with pytest.raises(ValueError, match="dy float32"):
        launch(x, b, c, la, dt, dy.bfloat16(), None, 16, saved)
    with pytest.raises(ValueError, match="d_state float32"):
        launch(x, b, c, la, dt, dy, ds[:, :1].contiguous(), 16, saved)
    with pytest.raises(ValueError, match="contiguous"):
        launch(x, b, c, la, dt, dy.transpose(1, 2).contiguous()
               .transpose(1, 2), None, 16, saved)
    with pytest.raises(ValueError, match="at most 64"):
        launch(x, b, c, la, dt, dy, None, 128, None)
    wide = [torch.from_numpy(a) for a in _inputs(1, 64, 1, 8, 512)[0]]
    with pytest.raises(ValueError, match="shared memory"):
        launch(*wide, torch.zeros(1, 64, 1, 8), None, 64, None)
    try:
        build._nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc"):
            launch(x, b, c, la, dt, dy, ds, 16, saved)
