"""Port parity for the MARS-sorted MoE dispatch op and its grouped-matmul
kernel's plain twin: ``grouped_matmul_plain`` against the Pallas
``grouped_matmul`` (interpret mode) over the reference's kernel-test
parametrisation, ``pad_sorted_groups`` bitwise against the reference's
(and its tight bound against the reference's static one),
``mars_moe_ffn`` against the reference's ``use_pallas=True`` route, the
device-side MARS sort helpers against ``repro.core.reorder``, and the
wrapper's contract (tiles past ``n_tiles`` are zero; CUDA-bound launches
go to the kernel or raise).  ``grouped_matmul_split_plain``, the TMA
kernel's K split in PyTorch, is held against the Pallas kernel at the
reference shapes and at a routed arctic-like case, and ``split_plan`` is
checked to cover every row, K row and column of every tile once.  Inputs
come from numpy with a seed.

Tolerances: the reference's own — 1e-5 in float32 and 2e-2 in bfloat16
for the grouped matmul (both sides sum float32 products, in other
orders; bf16 rounds the output), 2e-4 for the whole op."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import reorder as jreorder  # noqa: E402
from repro.kernels.moe_dispatch import ops as jops  # noqa: E402
from repro.kernels.moe_dispatch.moe_dispatch import \
    grouped_matmul as jgrouped_matmul  # noqa: E402
from repro_torch.core import reorder as treorder  # noqa: E402
from repro_torch.kernels.moe_dispatch import moe_dispatch as tk4  # noqa: E402
from repro_torch.kernels.moe_dispatch import ops as tops  # noqa: E402
from repro_torch.kernels.moe_dispatch import ref as tref  # noqa: E402

torch.set_num_threads(1)

REF_SHAPES = [(256, 128, 128, 2, 128), (512, 256, 128, 4, 128),
              (256, 512, 256, 8, 64), (128, 128, 384, 3, 32)]


def _bf16(a):
    """numpy float32 -> (jax bf16 array, torch bf16 tensor), same bits."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j).view(np.uint16).astype(np.int16)) \
        .view(torch.bfloat16)
    return j, t


def _operands(M, K, N, G, bm, seed, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((G, K, N)) / np.sqrt(K)).astype(np.float32)
    tg = np.sort(rng.integers(0, G, M // bm)).astype(np.int32)
    if dtype == "bfloat16":
        (jx, tx), (jw, tw) = _bf16(x), _bf16(w)
    else:
        jx, jw, tx, tw = (jnp.asarray(x), jnp.asarray(w),
                          torch.from_numpy(x), torch.from_numpy(w))
    return jx, jw, tx, tw, tg


@pytest.mark.parametrize("M,K,N,G,bm", REF_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_plain_matches_pallas(M, K, N, G, bm, dtype):
    jx, jw, tx, tw, tg = _operands(M, K, N, G, bm, 0, dtype)
    want = jgrouped_matmul(jx, jw, jnp.asarray(tg), bm=bm, interpret=True)
    got = tk4.grouped_matmul(tx, tw, torch.from_numpy(tg), bm=bm)
    assert got.dtype == tx.dtype and tuple(got.shape) == (M, N)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_two_oracles_agree_with_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    w = rng.standard_normal((4, 32, 16)).astype(np.float32)
    gs = np.array([10, 20, 4, 30])
    a = tref.grouped_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(gs))
    b = tref.grouped_matmul_ref_loop(x, w, gs)
    np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)
    from repro.kernels.moe_dispatch.ref import grouped_matmul_ref
    want = grouped_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(gs))
    np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _sorted_ids(seed, A, E):
    return np.sort(np.random.default_rng(seed).integers(0, E, A)) \
        .astype(np.int32)


@pytest.mark.parametrize("A,E,bm", [(100, 5, 16), (16, 128, 16),
                                    (48, 128, 16), (64, 384, 32),
                                    (7, 3, 128), (256, 8, 64)])
def test_pad_sorted_groups_bitwise(A, E, bm):
    """Slots, tile map and M_pad equal the reference's bit for bit."""
    e = _sorted_ids(A + E, A, E)
    jslot, jtg, jM = jops.pad_sorted_groups(jnp.asarray(e), None, E, bm)
    slot, tg, M, n_used = tops.pad_sorted_groups(torch.from_numpy(e), None,
                                                 E, bm)
    assert M == jM
    assert slot.dtype == tg.dtype == n_used.dtype == torch.int32
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jtg))
    counts = np.bincount(e, minlength=E)
    assert int(n_used) == int((-(-counts // bm)).sum())


@pytest.mark.parametrize("A,E,bm", [(100, 5, 16), (16, 128, 16),
                                    (48, 128, 16), (64, 384, 32),
                                    (7, 3, 128), (256, 8, 64), (8, 8, 16)])
def test_tight_bound_keeps_reference_slots_and_tiles(A, E, bm):
    """The port's buffers (the tight bound) hold every slot the
    reference's do, its tiles are the reference's first tiles, and every
    reference tile past the bound is empty."""
    e = _sorted_ids(2 * A + E, A, E)
    jslot, jtg, jM = jops.pad_sorted_groups(jnp.asarray(e), None, E, bm)
    slot, tg, M, n_used = tops.pad_sorted_groups(torch.from_numpy(e), None,
                                                 E, bm, tight=True)
    assert M == tops.tight_rows(A, E, bm) <= jM and M % bm == 0
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jtg)[:M // bm])
    assert int(slot.max()) < M
    assert int(n_used) * bm <= M
    # reference tiles at or past the tight bound hold no assignment
    assert not (np.asarray(jslot) // bm >= M // bm).any()


def test_tight_bound_is_tight():
    """A routing that puts one assignment on each of min(E, A) experts
    fills every tile of the bound."""
    for A, E, bm in ((16, 128, 16), (8, 4, 32)):
        e = np.sort(np.arange(A) % E).astype(np.int32)
        *_, M, n_used = tops.pad_sorted_groups(torch.from_numpy(e), None,
                                               E, bm, tight=True)
        assert int(n_used) * bm == M


def _ffn_operands(T, d, f, E, k, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)]) \
        .astype(np.int32)
    g = rng.standard_normal((T, k))
    gates = (np.exp(g) / np.exp(g).sum(-1, keepdims=True)).astype(np.float32)
    w_in = (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32)
    w_gate = (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32)
    w_out = (rng.standard_normal((E, f, d)) / np.sqrt(f)).astype(np.float32)
    return x, idx, gates, w_in, w_gate, w_out


@pytest.mark.parametrize("T,d,f,E,k", [(64, 32, 48, 4, 2),
                                       (128, 64, 64, 8, 2),
                                       (32, 128, 96, 16, 8)])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_mars_moe_ffn_matches_reference_pallas_route(T, d, f, E, k,
                                                     use_kernel):
    ops_in = _ffn_operands(T, d, f, E, k)
    want = jops.mars_moe_ffn(*(jnp.asarray(a) for a in ops_in),
                             n_experts=E, use_pallas=True, bm=32)
    got = tops.mars_moe_ffn(*(torch.from_numpy(a) for a in ops_in),
                            n_experts=E, bm=32, use_kernel=use_kernel)
    assert got.shape == (T, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_result_does_not_depend_on_bm():
    """Padding rows are zero, so the tile height changes nothing."""
    ops_in = [torch.from_numpy(a) for a in _ffn_operands(40, 32, 48, 8, 2)]
    outs = [tops.mars_moe_ffn(*ops_in, n_experts=8, bm=bm, use_kernel=True)
            for bm in (16, 32, 128)]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_tiles_past_n_tiles_and_bad_groups_are_zero():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 8, 5)).astype(np.float32))
    tg = torch.tensor([0, 2, 3, 1], dtype=torch.int32)   # 3 is no group
    out = tk4.grouped_matmul(x, w, tg, bm=16,
                             n_tiles=torch.tensor([3], dtype=torch.int32))
    np.testing.assert_allclose(out[:16].numpy(), (x[:16] @ w[0]).numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out[16:32].numpy(),
                               (x[16:32] @ w[2]).numpy(), rtol=1e-6,
                               atol=1e-6)
    assert (out[32:] == 0).all()


@pytest.mark.parametrize("n", [1, 7, 64])
def test_device_sort_helpers_match_reference(n):
    ids = np.random.default_rng(n).integers(0, 9, n).astype(np.int32)
    jp, jinv, jsorted, joff = jreorder.mars_sort_by_page(jnp.asarray(ids), 9)
    tp, tinv, tsorted, toff = treorder.mars_sort_by_page(
        torch.from_numpy(ids), 9)
    for got, want in ((tp, jp), (tinv, jinv), (tsorted, jsorted),
                      (toff, joff)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tp.dtype == toff.dtype == torch.int32


def test_wrapper_checks_and_never_falls_back():
    x = torch.zeros(32, 8)
    w = torch.zeros(2, 8, 4)
    tg = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 16"):
        tk4.grouped_matmul(x, w, tg[:1], bm=32 - 8)
    with pytest.raises(ValueError, match="M // bm"):
        tk4.grouped_matmul(x, w, tg[:1], bm=16)
    with pytest.raises(ValueError, match="K="):
        tk4.grouped_matmul(x, torch.zeros(2, 4, 4), tg, bm=16)
    with pytest.raises(TypeError, match="int32"):
        tk4._launch(x, w, tg.long(), 16, None)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tk4._launch(x.half(), w.half(), tg, 16, None)
    with pytest.raises(TypeError, match="n_tiles"):
        tk4._launch(x, w, tg, 16, 2)
    launches = tk4.grouped_matmul.launches
    from repro_torch.kernels import build
    try:
        build._nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc"):
            tk4._launch(x, w, tg, 16, None)
    assert tk4.grouped_matmul.launches == launches


# ---- the TMA kernel's K split (split_plan, grouped_matmul_split_plain) ----

# (M, K, N, bm): the serve path's route shapes (arctic decode w_in and
# w_out, its prefill, kimi's decode), the reference test shapes, and edges
# no slab, stage, span or box divides
PLAN_SHAPES = [(256, 7168, 4864, 16), (256, 4864, 7168, 16),
               (768, 7168, 4864, 16), (1024, 7168, 2048, 16),
               *[(M, K, N, bm) for M, K, N, _, bm in REF_SHAPES],
               (64, 7000, 1000, 16), (128, 1000, 520, 32), (80, 264, 72, 80)]


@pytest.mark.parametrize("M,K,N,bm", PLAN_SHAPES)
@pytest.mark.parametrize("sm_count", [1, 132, 1000])
def test_split_plan_covers_every_row_once(M, K, N, bm, sm_count):
    """Every (row, K row, column) of every tile is in exactly one work
    unit, slabs are whole 32-row stages but the last, and the grid is the
    C launcher's ((M / rows) x n_split x n_span units): it is a function
    of the shapes and the SM count, never of n_tiles."""
    plan = tk4.split_plan(M, K, N, bm, torch.bfloat16, sm_count)
    assert plan.path == "tma" and bm % plan.rows == 0
    assert plan.span == tk4.SPAN * 16 // plan.rows
    assert plan.k_per_split % tk4.STAGE_K == 0
    assert (plan.n_split - 1) * plan.k_per_split < K \
        <= plan.n_split * plan.k_per_split
    assert plan.n_split == 1 or plan.k_per_split >= tk4.MIN_K_PER_SPLIT
    units = tk4.work_units(plan, M, K, N, bm)
    assert len(units) == M // plan.rows * plan.n_split * plan.n_span
    cover = np.zeros((M, K, N), dtype=np.int8) if M * K * N < 1 << 27 \
        else None
    rows = np.zeros(M, dtype=np.int64)
    for tile, row0, nr, col0, nc, k0, k1 in units:
        assert tile == row0 // bm and 0 < nc <= plan.span and k0 < k1
        rows[row0:row0 + nr] += (k1 - k0) * nc
        if cover is not None:
            cover[row0:row0 + nr, k0:k1, col0:col0 + nc] += 1
    assert (rows == K * N).all()
    if cover is not None:
        assert (cover == 1).all()


def test_split_plan_reads_no_device_state():
    """The plan takes shapes, the dtype and the SM count only: no
    ``n_tiles`` and no tensor, so it never waits on the device."""
    import inspect
    assert list(inspect.signature(tk4.split_plan).parameters) == \
        ["M", "K", "N", "bm", "dtype", "sm_count", "tma"]
    assert tk4.split_plan(256, 128, 128, 128, torch.float32, 132).path \
        == "cores"
    assert tk4.split_plan(256, 100, 36, 16, torch.bfloat16, 132,
                          tma=False).path == "cores"


@pytest.mark.parametrize("M,K,N,G,bm", REF_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kps", ["plan", 32])
def test_grouped_matmul_split_plain_matches_pallas(M, K, N, G, bm, dtype,
                                                   kps):
    """The K split's arithmetic (f32 partials per slab, summed in slab
    order) against the Pallas kernel in interpret mode, with the plan's
    slabs and with 32-row slabs (one ring stage each)."""
    jx, jw, tx, tw, tg = _operands(M, K, N, G, bm, 0, dtype)
    if kps == "plan":
        kps = tk4.split_plan(M, K, N, bm, torch.bfloat16, 132).k_per_split
    want = jgrouped_matmul(jx, jw, jnp.asarray(tg), bm=bm, interpret=True)
    got = tk4.grouped_matmul_split_plain(tx, tw, torch.from_numpy(tg), bm=bm,
                                         k_per_split=kps)
    assert got.dtype == tx.dtype and tuple(got.shape) == (M, N)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_split_plain_routed_arctic_like(dtype):
    """arctic-480b's decode routing narrowed (8 lanes x top-2 over 32
    experts, K 1000 and N 520: no slab, span or box divides them), sorted
    and tight-padded as the serve path does (bm 16, n_tiles on the
    device side): the split twin against the Pallas kernel, padding rows
    and tiles past n_tiles exactly 0."""
    rng = np.random.default_rng(7)
    T, k, E, K, N, bm = 8, 2, 32, 1000, 520, 16
    flat = np.stack([rng.permutation(E)[:k] for _ in range(T)]) \
        .reshape(-1).astype(np.int32)
    perm = np.argsort(flat, kind="stable")
    sorted_e = torch.from_numpy(flat[perm])
    slot, tg, M, n_used = tops.pad_sorted_groups(sorted_e, None, E, bm,
                                                 tight=True)
    rows = rng.standard_normal((T * k, K)).astype(np.float32)
    x = np.zeros((M, K), np.float32)
    x[slot.numpy()] = rows
    w = (rng.standard_normal((E, K, N)) / np.sqrt(K)).astype(np.float32)
    if dtype == "bfloat16":
        (jx, tx), (jw, tw) = _bf16(x), _bf16(w)
    else:
        jx, jw, tx, tw = (jnp.asarray(x), jnp.asarray(w), torch.from_numpy(x),
                          torch.from_numpy(w))
    plan = tk4.split_plan(M, K, N, bm, torch.bfloat16, 132)
    assert plan.n_split > 1
    got = tk4.grouped_matmul_split_plain(tx, tw, tg, bm=bm, n_tiles=n_used,
                                         k_per_split=plan.k_per_split)
    want = jgrouped_matmul(jx, jw, jnp.asarray(tg.numpy()), bm=bm, bk=K,
                           bn=N, interpret=True)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    pad = np.ones(M, bool)
    pad[slot.numpy()] = False
    assert (got[torch.from_numpy(pad)] == 0).all()
    assert (got[int(n_used) * bm:] == 0).all()
