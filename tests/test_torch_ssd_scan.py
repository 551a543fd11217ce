"""Port parity for the SSD (Mamba2) chunked scan: the port's
``ssd_scan`` on CPU tensors (the kernel's plain twin, chunked f32 torch)
and its sequential oracle ``ssd_ref`` against the JAX package's Pallas
``ssd_scan`` in interpret mode and its ``ssd_ref``, on the shapes of the
JAX kernel tests plus hymba's prefill shape (a 24-token prompt under
chunk 64, so one chunk of 24).  Inputs come from numpy and feed both
sides.  The scan as the port's bf16 prefill calls it (x, b, c in bf16,
la and dt in float32) is held against the JAX kernel given the same.
``ssd_scan_chunked_plain``, the CUDA kernels' passes in PyTorch (every
chunk's state contribution, the state carried over the chunks, every
chunk's output), is held against the same, with a case of 8 chunks, and
``split_plan`` is checked to cover every head and column once.

Tolerances: ``atol=rtol=1e-4`` between the two chunked scans (the same
float32 arithmetic, summed in another order), for float32 inputs and
for bfloat16 inputs (both sides upcast the same bf16 values to f32);
``atol=rtol=2e-4`` against the sequential recurrence, which sums in a
different order altogether (the JAX kernel tests use the same)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.ref import ssd_ref as jssd_ref  # noqa: E402
from repro.kernels.ssd_scan.ssd_scan import ssd_scan as jssd_scan  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as tmod  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_ref as tssd_ref  # noqa: E402

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
SEQ_TOL = dict(atol=2e-4, rtol=2e-4)
SHAPES = [(1, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 32),
          (1, 96, 1, 8, 4, 32), (1, 24, 3, 16, 8, 64)]


def _inputs(B, S, H, P, N, seed=0):
    """x, b, c, la, dt as float32 numpy: dt = softplus(normal), la = a
    negative log decay, as the model feeds them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    b = rng.standard_normal((B, S, N)).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    la = (-np.exp(0.3 * rng.standard_normal((B, S, H))) * dt) \
        .astype(np.float32)
    return x, b, c, la, dt


def _sides(arrays, dtype):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


# the mamba2-370m smoke config's scan: H 8, P 16, N 16, chunk 8
MAMBA2_SMOKE = (2, 24, 8, 16, 16, 8)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """CPU tensors never reach the CUDA kernel."""
    before = tmod.ssd_scan.launches
    yield
    assert tmod.ssd_scan.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
def test_ssd_scan_matches_jax(B, S, H, P, N, chunk, dtype):
    j, t = _sides(_inputs(B, S, H, P, N), dtype)
    y, s = tmod.ssd_scan(*t, chunk=chunk)
    assert y.dtype == s.dtype == torch.float32
    assert tuple(y.shape) == (B, S, H, P) and tuple(s.shape) == (B, H, P, N)
    jy, js = jssd_scan(*j, chunk=chunk, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    # and the sequential recurrence, the JAX package's and the port's
    ry, rs = jssd_ref(*j)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **SEQ_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), **SEQ_TOL)
    ty, ts = tssd_ref(*t)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(rs), **TOL)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES + [MAMBA2_SMOKE])
def test_ssd_scan_takes_the_decay_in_float32(B, S, H, P, N, chunk):
    """The port's bf16 prefill hands the scan x, b and c in bf16 with la
    and dt in float32 (``models/ssm.py``: its one-token decode uses them
    unrounded), where the reference rounds la and dt to x's dtype
    (``repro/models/ssm.py:175-176``).  The port's scan matches the JAX
    kernel given the same mixed inputs, and la and dt rounded to bf16
    move the result well past the tolerance, so the departure is one
    this comparison sees."""
    x, b, c, la, dt = _inputs(B, S, H, P, N)
    j = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, b, c)] \
        + [jnp.asarray(la), jnp.asarray(dt)]
    t = [torch.from_numpy(a).bfloat16() for a in (x, b, c)] \
        + [torch.from_numpy(la), torch.from_numpy(dt)]
    y, s = tmod.ssd_scan(*t, chunk=chunk)
    jy, js = jssd_scan(*j, chunk=chunk, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    ry, rs = tmod.ssd_scan(*t[:3], *(a.bfloat16().float() for a in t[3:]),
                           chunk=chunk)
    assert not np.allclose(ry.numpy(), np.asarray(jy), **TOL)
    assert not np.allclose(rs.numpy(), np.asarray(js), **TOL)


def test_ssd_scan_plain_is_the_wrapper_on_cpu():
    arrays = [torch.from_numpy(a) for a in _inputs(2, 32, 3, 8, 4, seed=1)]
    y, s = tmod.ssd_scan(*arrays, chunk=8)
    py, ps = tmod.ssd_scan_plain(*arrays, chunk=8)
    assert torch.equal(y, py) and torch.equal(s, ps)


@pytest.mark.parametrize("S,chunk", [(24, 16), (10, 4), (96, 64)])
def test_ssd_scan_rejects_a_ragged_chunk(S, chunk):
    """S % min(chunk, S) != 0 raises, as the reference asserts."""
    arrays = [torch.from_numpy(a) for a in _inputs(1, S, 2, 8, 4)]
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        tmod.ssd_scan(*arrays, chunk=chunk)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        tmod.ssd_scan_plain(*arrays, chunk=chunk)


def test_ssd_scan_upper_triangle_is_exactly_zero():
    """The within-chunk mask is exp(min(li, 0)) on the lower triangle and
    exactly 0 above it: a position's output does not depend on any later
    position in its chunk, even where la would make exp(li) overflow."""
    x, b, c, la, dt = (torch.from_numpy(a)
                       for a in _inputs(1, 16, 2, 8, 4, seed=2))
    y, _ = tmod.ssd_scan(x, b, c, la, dt, chunk=16)
    x2, b2, la2 = x.clone(), b.clone(), la.clone()
    x2[:, 8:] = 1e3
    b2[:, 8:] = -7.0
    la2[:, 8:] = -80.0            # exp(-li) of later positions overflows
    y2, _ = tmod.ssd_scan(x2, b2, c, la2, dt, chunk=16)
    assert torch.isfinite(y2).all()
    assert torch.equal(y[:, :8], y2[:, :8])


def test_kernel_wrapper_never_falls_back():
    """Operands the kernel does not take raise before any build; ones it
    takes go to the build (which needs nvcc) — never to the plain twin."""
    x, b, c, la, dt = (torch.from_numpy(a) for a in _inputs(1, 16, 2, 8, 4))
    with pytest.raises(TypeError, match="one dtype"):
        tmod._launch(x, b, c, la.double(), dt, 16)
    with pytest.raises(TypeError, match="la, dt in float32"):
        tmod._launch(*(t.bfloat16() for t in (x, b, c, la, dt)), 16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tmod._launch(*(t.half() for t in (x, b, c, la, dt)), 16)
    with pytest.raises(ValueError, match="contiguous"):
        tmod._launch(x, b.transpose(1, 2).contiguous().transpose(1, 2), c,
                     la, dt, 16)
    with pytest.raises(ValueError, match="at most 64"):
        big = [torch.from_numpy(a) for a in _inputs(1, 128, 1, 8, 4)]
        tmod._launch(*big, 128)
    with pytest.raises(ValueError, match="shared memory"):
        wide = [torch.from_numpy(a) for a in _inputs(1, 64, 1, 8, 512)]
        tmod._launch(*wide, 64)
    with pytest.raises(ValueError, match="shape mismatch"):
        tmod.ssd_scan(x, b[:, :8], c, la, dt, chunk=8)
    try:
        build._nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc"):
            tmod._launch(x, b, c, la, dt, 16)


def test_smem_bytes_at_hymba_widths():
    """The chunk kernel's shared memory by mode, as ``smem_floats`` in
    ``csrc/ssd_scan.cu`` lays it out: hymba's prefill (one chunk of 24, a
    P block of 32, N 16) and its long scan (q 64, P 64) fit the default
    48 KB in the fused and state modes and a block's 227 KB in the output
    mode; the largest chunk at mamba2's state (N 128), P 128 cut in P
    blocks of 64, fits a block's 227 KB in every mode."""
    floats = 4 * 24 + 24 * 32 + 24 * 16 + 2 * 16 * 24 + 2 * 24 * 24
    assert tmod.smem_bytes(24, 32, 16, "fused") == 4 * floats <= 48 * 1024
    assert tmod.smem_bytes(24, 64, 128, "fused") == 4 * (
        4 * 24 + 24 * 64 + 24 * 128 + 2 * 128 * 24 + 2 * 24 * 24) \
        <= 48 * 1024
    assert tmod.smem_bytes(64, 64, 16, "state") == \
        4 * (4 * 64 + 64 * 64 + 64 * 16) <= 48 * 1024
    assert tmod.smem_bytes(64, 64, 16, "output") == \
        4 * (4 * 64 + 64 * 64 + 2 * 16 * 64 + 2 * 64 * 64 + 16 * 64)
    plan = tmod.split_plan(1, 2048, 32, 128, 128, 64, 132)
    assert plan.p_block == 64
    for mode in tmod.MODES:
        assert tmod.smem_bytes(64, plan.p_block, 128, mode) \
            <= tmod._SMEM_LIMIT


# ---- the kernels' passes (split_plan, ssd_scan_chunked_plain) ----

MANY_CHUNKS = (1, 128, 2, 16, 8, 16)          # 8 chunks of 16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES + [MANY_CHUNKS])
def test_ssd_scan_chunked_plain_matches_jax(B, S, H, P, N, chunk, dtype):
    """The kernels' passes (every chunk's state contribution, the state
    carried over the chunks, every chunk's output) against the JAX
    kernel in interpret mode and the sequential recurrence."""
    j, t = _sides(_inputs(B, S, H, P, N, seed=3), dtype)
    y, s = tmod.ssd_scan_chunked_plain(*t, chunk=chunk)
    assert y.dtype == s.dtype == torch.float32
    assert tuple(y.shape) == (B, S, H, P) and tuple(s.shape) == (B, H, P, N)
    jy, js = jssd_scan(*j, chunk=chunk, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    ry, rs = jssd_ref(*j)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **SEQ_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), **SEQ_TOL)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 24, 50, 64, 16, 64), (8, 24, 32, 64, 128, 64),
    (4, 4096, 50, 64, 16, 64), (1, 2048, 32, 64, 128, 64),
    (2, 96, 8, 32, 16, 24), (2, 16, 4, 8, 4, 1), *SHAPES, MAMBA2_SMOKE])
@pytest.mark.parametrize("sm_count", [1, 132])
def test_split_plan_covers_every_head_and_column(B, S, H, P, N, chunk,
                                                 sm_count):
    """The plan's blocks cover every (head, p) of every (batch, chunk)
    once, a call of one chunk takes one launch, and the blocks' shared
    memory fits in every mode the call runs."""
    q = tmod.chunk_len(S, chunk)
    plan = tmod.split_plan(B, S, H, P, N, q, sm_count)
    assert plan.n_chunks == S // q
    assert tmod._modes(plan.n_chunks) == (
        ("fused",) if S == q else ("state", "output"))
    assert plan.heads in tmod.HEAD_GROUPS or plan.heads == H
    assert 1 <= plan.p_block <= 64
    seen = np.zeros((H, P), dtype=np.int64)
    for g in range(-(-H // plan.heads)):
        for pb in range(-(-P // plan.p_block)):
            h0, p0 = g * plan.heads, pb * plan.p_block
            seen[h0:min(H, h0 + plan.heads),
                 p0:min(P, p0 + plan.p_block)] += 1
    assert (seen == 1).all()
    for mode in tmod._modes(plan.n_chunks):
        assert tmod.smem_bytes(q, plan.p_block, N, mode) <= tmod._SMEM_LIMIT


def test_split_plan_spreads_a_short_prefill_over_the_card():
    """hymba's prefill (one request, one chunk, 50 heads) takes more blocks
    than heads; mamba2-370m's long scan shares C B^T over 8 heads."""
    plan = tmod.split_plan(1, 24, 50, 64, 16, 24, 132)
    assert -(-50 // plan.heads) * -(-64 // plan.p_block) > 50
    assert tmod.split_plan(1, 2048, 32, 64, 128, 64, 132).heads == 8
