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


# ---- B3's plan and the wrapper's checks ---------------------------------

@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (8, 512, 32, 64, 128, 64), (8, 512, 50, 64, 16, 64),
    (1, 4096, 32, 64, 128, 64), (8, 24, 32, 64, 128, 64),
    (1, 24, 50, 64, 16, 64), *SHAPES])
@pytest.mark.parametrize("sm_count", [1, 132])
def test_bwd_plan_fits_and_covers_every_head(B, S, H, P, N, chunk,
                                             sm_count):
    """The grad kernel's head groups cover every head once; its shared
    memory and the state kernel's fit a block; the (q, N) tiles a thread
    sums over heads fit its registers; the launches a call."""
    q = tmod.chunk_len(S, chunk)
    hg = tmod.bwd_plan(B, S, H, P, N, q, sm_count)
    assert 1 <= hg <= H
    assert hg in tmod.BWD_HEAD_GROUPS or hg == H
    seen = np.zeros(H, np.int64)
    for g in range(-(-H // hg)):
        seen[g * hg:min(H, (g + 1) * hg)] += 1
    assert (seen == 1).all()
    for kernel in ("grad", "state"):
        assert tmod.bwd_smem_bytes(q, P, N, kernel) <= tmod._SMEM_LIMIT
    q4, n4 = -(-q // 4) * 4, -(-N // 4) * 4
    assert (q4 // 4) * (n4 // 4) <= tmod.BWD_ACC_TILES * tmod.BWD_THREADS
    assert tmod.bwd_launches(S // q) == (4 if S > q else 2)


def test_bwd_smem_and_parts_at_mamba2_training_width():
    """q 64, P 64, N 128: the grad kernel's layout (rows padded by one
    float) takes 208656 B of a block's 232448; the pass kernel writes 8
    warp partials of d(decay) a block of 1024 state elements."""
    assert tmod.bwd_smem_bytes(64, 64, 128) == 4 * (
        2 * 64 * 129 + 4 * 64 * 65 + 2 * 64 * 65 + 64 * 129 + 64 * 32
        + 6 * 64 + 4) == 208656
    assert tmod.bwd_pass_parts(64, 128) == 64
    assert tmod.bwd_pass_parts(64, 16) == 8
    assert tmod.bwd_pass_parts(5, 7) == 8
    assert tmod.bwd_plan(8, 512, 32, 64, 128, 64, 132) == 16


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
