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
