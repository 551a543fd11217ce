"""Port parity for the MARS row gather: the port's ``gather_rows`` and
``mars_gather`` on CPU tensors (the kernel's plain twin) against the JAX
package's Pallas ``gather_rows`` / ``mars_gather_pallas`` in interpret
mode, and ``embedding_gather``'s MARS path against the plain take — all
**bitwise** (the gather is a row copy: no tolerance), in float32 and
bfloat16, with int32 and int64 ids, repeated and unsorted ids included.
Then the wrapper's checks: what the CUDA kernel does not take raises,
and a CUDA-bound call never computes the plain twin instead."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mars_gather import mars_gather as jmg  # noqa: E402
from repro.kernels.mars_gather import ops as jops  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mars_gather import mars_gather as tmg  # noqa: E402
from repro_torch.kernels.mars_gather import ops as tops  # noqa: E402

torch.set_num_threads(1)


def _table(V, D, dtype, seed=0):
    """The same table as a jax array and a torch tensor (bf16 rounds
    identically on both sides)."""
    a = np.random.default_rng(seed).standard_normal((V, D)).astype(
        np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(
        getattr(torch, dtype))


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """CPU tensors never reach the CUDA kernel."""
    before = tmg.gather_rows.launches
    yield
    assert tmg.gather_rows.launches == before


@pytest.mark.parametrize("idx", ["int32", "int64"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_matches_pallas_bitwise(dtype, idx):
    jt, tt = _table(48, 40, dtype)
    ids = np.sort(np.random.default_rng(1).integers(0, 48, 24))
    got = tmg.gather_rows(tt, torch.from_numpy(ids.astype(idx)))
    want = jmg.gather_rows(jt, jnp.asarray(ids, jnp.int32), interpret=True)
    assert got.dtype == tt.dtype and tuple(got.shape) == (24, 40)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(tt[ids]))


@pytest.mark.parametrize("shape", [(40,), (3, 11)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mars_gather_matches_pallas_bitwise(dtype, shape):
    jt, tt = _table(64, 128, dtype, seed=2)
    ids = np.random.default_rng(3).integers(0, 64, shape).astype(np.int32)
    got = tmg.mars_gather(tt, torch.from_numpy(ids))
    want = jmg.mars_gather_pallas(jt, jnp.asarray(ids), interpret=True)
    assert tuple(got.shape) == shape + (128,)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(tt[ids]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_gather_mars_path_is_bitwise(dtype):
    """``embedding_gather``'s MARS path (sort by page, ``gather_rows``,
    unsort) is the plain take and the JAX op's, bit for bit, on a table
    large enough for "auto" to take it."""
    jt, tt = _table(1 << 16, 64, dtype, seed=4)
    ids = np.random.default_rng(5).integers(0, 1 << 16, (4, 9)) \
        .astype(np.int32)
    for mode in ("auto", "sorted"):
        got = tops.embedding_gather(tt, torch.from_numpy(ids), mode=mode)
        want = jops.embedding_gather(jt, jnp.asarray(ids), mode=mode)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(_bits(got), _bits(tt[ids]))


def test_gather_rows_empty_and_repeated_ids():
    _, tt = _table(8, 16, "float32")
    assert tuple(tmg.gather_rows(tt, torch.zeros(0, dtype=torch.int32))
                 .shape) == (0, 16)
    ids = torch.tensor([3, 3, 3, 0], dtype=torch.int32)
    assert torch.equal(tmg.gather_rows(tt, ids), tt[ids])


@pytest.mark.parametrize("row_bytes,ptrs,want", [
    (3200, (0, 4096), 16), (2048, (256, 512), 16), (24, (8, 16), 8),
    (12, (4, 0), 4), (6, (2, 4), 2), (3, (0, 0), 1), (3200, (4, 0), 4)])
def test_vector_width(row_bytes, ptrs, want):
    """The widest copy unit that divides the row and aligns both base
    pointers: hymba's bf16 rows (3200 B) and qwen's (2048 B) move in
    16-byte vectors."""
    assert tmg._vector_bytes(row_bytes, *ptrs) == want


def test_kernel_wrapper_never_falls_back():
    """Operands the kernel does not take raise before any build; ones it
    takes go to the build (which needs nvcc) — never to the plain twin."""
    _, tt = _table(8, 16, "float32")
    ids = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(TypeError, match="int32 or int64"):
        tmg._launch(tt, ids.to(torch.int16))
    with pytest.raises(ValueError, match="contiguous"):
        tmg._launch(tt.t(), ids)
    with pytest.raises(ValueError, match=r"\(V, D\) table"):
        tmg._launch(tt[None], ids)
    try:
        build._nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc"):
            tmg._launch(tt, ids)


# row widths in bytes of the served configs' tables in bf16 (hymba 1600,
# qwen and mamba2 1024, arctic 7168, whisper 512) and whisper's and
# mamba2's in float32, at the counts the paths gather
GRID_ROWS = {"hymba": 3200, "qwen": 2048, "arctic": 14336, "whisper": 1024,
             "mamba2": 2048, "whisper_f32": 2048, "mamba2_f32": 4096,
             "odd": 6}


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("n", [1, 8, 24, 192, 8192])
@pytest.mark.parametrize("table", list(GRID_ROWS))
def test_grid_plan_covers_every_byte_once(table, n, sms):
    """``grid_plan`` reads shapes and the SM count only; the kernel's items
    (block b, warp w -> item 4 b + w -> row item // n_chunks, vectors
    [chunk * chunk_vecs, + chunk_vecs) cut at the row's end) cover every
    vector of every output row exactly once, with at most 4 vectors a
    lane."""
    row_bytes = GRID_ROWS[table]
    vec = tmg._vector_bytes(row_bytes)
    row_vecs = row_bytes // vec
    chunk, n_chunks, blocks = tmg.grid_plan(n, row_vecs, sms)
    assert chunk in (32, 64, 128) and n_chunks == -(-row_vecs // chunk)
    seen = np.zeros((n, row_vecs), np.int64)
    for item in range(blocks * tmg.WARPS):
        if item >= n * n_chunks:
            continue
        row, c = divmod(item, n_chunks)
        seen[row, c * chunk:min((c + 1) * chunk, row_vecs)] += 1
    assert (seen == 1).all()


def test_grid_plan_spreads_few_long_rows():
    """Arctic's 24 ids of 14 336 bytes fill at least one block an SM of an
    H100 (the chunk shrinks to one 16-byte vector a lane); 8192 ids keep
    4 vectors a lane."""
    chunk, n_chunks, blocks = tmg.grid_plan(24, 14336 // 16, 132)
    assert blocks >= 132 and chunk == 32
    assert tmg.grid_plan(8192, 14336 // 16, 132)[0] == 128


# ---- the backward (B2): the MARS-sorted segment sum ------------------------
def _grad_case(kind, T=300, V=500, D=24, seed=7):
    """Ids with duplicates and unused rows: zipf-skewed as TokenStream
    draws them, uniform over few rows, or one row only."""
    rng = np.random.default_rng(seed)
    if kind == "zipf":
        ids = rng.zipf(1.3, T) % V
    elif kind == "few_rows":
        ids = rng.integers(0, 7, T) * 61
    else:
        ids = np.full(T, V - 1)
    g = rng.standard_normal((T, D)).astype(np.float32)
    return ids.astype(np.int32), g, V


@pytest.mark.parametrize("kind", ["zipf", "few_rows", "one_row"])
@pytest.mark.parametrize("shape", [(300,), (6, 50)])
def test_grad_scatter_twin_matches_reference(kind, shape):
    """The port's ``embedding_grad_scatter`` (B2's twin on CPU tensors)
    against the reference's in float32; both sum each row's rows in
    sorted order, the reference's ``.at[].add`` perhaps in another, so
    1e-5 (sums of up to 300 unit normals)."""
    ids, g, V = _grad_case(kind)
    ids, g = ids.reshape(shape), g.reshape(*shape, g.shape[-1])
    want = jops.embedding_grad_scatter(jnp.asarray(ids), jnp.asarray(g), V)
    got = tops.embedding_grad_scatter(torch.from_numpy(ids),
                                      torch.from_numpy(g), V)
    assert got.shape == (V, g.shape[-1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    unused = np.setdiff1d(np.arange(V), ids)
    assert unused.size and not got.numpy()[unused].any()


def test_grad_scatter_sums_each_row_in_sorted_order():
    """Each row of the twin is the f32 sum of its gradient rows in token
    order (the sorted order of a stable sort), bit for bit: the order B2
    sums in on the card."""
    ids, g, V = _grad_case("zipf")
    got = tops.embedding_grad_scatter(torch.from_numpy(ids),
                                      torch.from_numpy(g), V).numpy()
    for r in np.unique(ids):
        want = np.zeros(g.shape[1], np.float32)
        for j in np.flatnonzero(ids == r):
            want = (want + g[j]).astype(np.float32)
        assert np.array_equal(got[r], want), r


def test_grad_scatter_rounds_once_in_bf16():
    """A deliberate departure (ROADMAP.md §3): bf16 gradients are summed
    in f32 and rounded once, where the reference's ``.at[].add`` adds in
    bf16.  512 contributions of 2**-9 to one row sum to exactly 1.0 here;
    in bf16 the running sum stalls once the addend falls below half a
    spacing (at 0.5 the spacing is 2**-8), so the reference's row stays
    short of 1."""
    ids = np.zeros(512, np.int32)
    g = np.full((512, 4), 2.0 ** -9, np.float32)
    got = tops.embedding_grad_scatter(torch.from_numpy(ids),
                                      torch.from_numpy(g).bfloat16(), 3)
    assert got.dtype == torch.bfloat16
    assert got[0].float().eq(1.0).all() and not got[1:].any()
    want = jops.embedding_grad_scatter(jnp.asarray(ids),
                                       jnp.asarray(g, jnp.bfloat16), 3)
    assert float(np.asarray(want, np.float32)[0, 0]) < 1.0


@pytest.mark.parametrize("ids_kind", ["zipf", "uniform"])
def test_sorted_gather_table_gradient_matches_jax(ids_kind):
    """The sorted path (a table above 2**22 elements) as an autograd
    Function: its table gradient (B2's twin over the ids in token order)
    against ``jax.grad`` of the reference's ``embedding_gather``, float32,
    1e-5; and its values bitwise the plain take's."""
    V, D = 4200, 1000                       # 4.2 M > 2**22 elements
    rng = np.random.default_rng(11)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = (rng.zipf(1.3, (4, 64)) % V if ids_kind == "zipf"
           else rng.integers(0, V, (4, 64))).astype(np.int32)
    w = rng.standard_normal((4, 64, D)).astype(np.float32)

    def f(t):
        return jnp.sum(jops.embedding_gather(t, jnp.asarray(ids)) * w)
    want = jax.grad(f)(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_()
    out = tops.embedding_gather(tt, torch.from_numpy(ids))
    node = out.grad_fn.next_functions[0][0]       # under the reshape
    assert "SortedGather" in type(node).__name__
    assert torch.equal(out.detach(), torch.from_numpy(table)[ids])
    out.backward(torch.from_numpy(w))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n,d", [(4096, 1024), (4096, 512),   # B2_TABLES
                                 (4096, 1000), (4096, 999), (1, 1024),
                                 (1, 7), (33, 64), (5, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_plan_covers_every_column_of_every_run_once(n, d, dtype):
    """B2's plan: a warp for every sorted position (each position may
    start a run), and within each chunk of ``SCATTER_CHUNK`` columns the
    lanes of a short run's one warp (8 contiguous columns a lane, kept
    below d) and the ``SCATTER_SLICES`` warps of a long run (32 columns
    each, one a lane, kept below d) each cover every column of the row
    exactly once; 16-byte loads (``wide``) only where d is a multiple of
    8, so no lane's 8 columns straddle the row's end."""
    wide, n_chunks, blocks = tmg.scatter_plan(n, d, dtype)
    assert wide == (d % 8 == 0)
    assert (blocks - 1) * tmg.SCATTER_WARPS < n <= blocks * tmg.SCATTER_WARPS
    assert n_chunks <= 65535
    chunk, slices = tmg.SCATTER_CHUNK, tmg.SCATTER_SLICES
    assert chunk == 32 * slices == 32 * 8
    short = [c + k for y in range(n_chunks) for lane in range(32)
             for c in [chunk * y + 8 * lane] for k in range(8) if c + k < d]
    long = [c for y in range(n_chunks) for t in range(slices)
            for lane in range(32) for c in [chunk * y + 32 * t + lane]
            if c < d]
    assert sorted(short) == sorted(long) == list(range(d))
    if wide:
        assert all((chunk * y + 8 * lane) % 8 == 0 for y in range(n_chunks)
                   for lane in range(32))


def test_scatter_plan_spreads_a_long_run_over_warps():
    """qwen's d 1024 sums a long run with 4 chunks x 8 warps, whisper's d
    512 with 2 x 8, each warp 32 columns; a short run takes one warp a
    chunk, as many as 256-column chunks."""
    assert tmg.scatter_plan(4096, 1024, torch.bfloat16)[:2] == (True, 4)
    assert tmg.scatter_plan(4096, 512, torch.float32)[:2] == (True, 2)
    assert tmg.scatter_plan(4096, 999, torch.float32)[:2] == (False, 4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tmg.scatter_plan(4, 8, torch.float16)


def test_scatter_wrapper_never_falls_back():
    """B2's wrapper raises on what the kernel does not take before any
    build; operands it takes go to the build (which needs nvcc), never to
    the twin."""
    g = torch.zeros(4, 8)
    sids = torch.tensor([0, 1, 1, 3])
    perm = torch.arange(4)
    with pytest.raises(TypeError, match="int64"):
        tmg._scatter_launch(sids.int(), perm, g, 5)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tmg._scatter_launch(sids, perm, g.half(), 5)
    with pytest.raises(ValueError, match="contiguous"):
        tmg._scatter_launch(sids, perm, torch.zeros(8, 4).t(), 5)
    with pytest.raises(ValueError, match="g \\(N, d\\)"):
        tmg._scatter_launch(sids, perm, g[:3], 5)
    launches = tmg.scatter_add_rows.launches
    try:
        build._nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc"):
            tmg._scatter_launch(sids, perm, g, 5)
    assert tmg.scatter_add_rows.launches == launches

