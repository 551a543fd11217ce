"""Port parity for B4, the backward of the grouped matmul (K4):
``grouped_matmul_bwd_plain`` (B4's plain twin) against ``jax.vjp`` of the
reference's ``jax.lax.ragged_dot`` (what the JAX trainer differentiates,
``repro/models/moe.py:77-89``) over the unpadded groups, after the port's
padding (``ops.pad_sorted_groups``), in float32 and bfloat16; the
autograd Function ``grouped_matmul`` under ``torch.autograd.gradcheck``
in float64 and against autograd through ``grouped_matmul_plain``; the
twin's row split (``expert_slabs``) and ``bwd_plan``; the tensor-core
path's work order (``bwd_work``, the host mirror of the kernels'
prologue: tile lists for unsorted maps, experts heaviest first, dx items
and dw units) against a brute force, its buffer layout, and its geometry
against the kernel source; and the wrapper's contract (CUDA-bound
launches go to the kernel or raise).  Shapes include
an empty expert (its dw is exact zeros), a one-row expert, ``n_tiles``
below the tile count (the tiles past it hold garbage that must not
count), bm 16, 32 and 128, and N and K not multiples of 8.  Inputs come
from numpy with a seed.

Tolerances: float32, 1e-5 of the largest value plus 1e-5 relative (the
same f32 products summed in another order).  bfloat16: the inputs are
rounded to bf16 on both sides and JAX sums in float32 without rounding
the result, so the twin's bf16 gradient lies within one rounding, 2**-8
relative, of it, plus the f32 order term."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels.moe_dispatch import moe_dispatch as tk4  # noqa: E402
from repro_torch.kernels.moe_dispatch import ops as tops  # noqa: E402

torch.set_num_threads(1)

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2.0 ** -8)}

# (rows of each expert, K, N, bm): an empty expert, a one-row expert,
# bm 16 / 32 / 128, N and K not multiples of 8
CASES = [((5, 0, 1, 17, 3), 24, 20, 16),
         ((0, 40, 1, 0), 32, 36, 32),
         ((130, 2, 0), 40, 24, 128),
         ((1, 1, 1, 1, 0, 9), 100, 36, 16)]


def _round_bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _problem(sizes, K, N, bm, seed, dtype):
    """Sorted rows of each expert, their padded layout (the tight bound,
    and two more tiles past n_tiles) with garbage in the tiles past
    n_tiles, and the JAX vjp of ragged_dot on the unpadded rows."""
    rng = np.random.default_rng(seed)
    G, A = len(sizes), sum(sizes)
    x = rng.standard_normal((A, K)).astype(np.float32)
    w = (rng.standard_normal((G, K, N)) / np.sqrt(K)).astype(np.float32)
    dy = rng.standard_normal((A, N)).astype(np.float32)
    if dtype == "bfloat16":
        x, w, dy = _round_bf16(x), _round_bf16(w), _round_bf16(dy)
    sizes_j = jnp.asarray(sizes, jnp.int32)
    _, vjp = jax.vjp(lambda a, b: jax.lax.ragged_dot(a, b, sizes_j),
                     jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = (np.asarray(t) for t in vjp(jnp.asarray(dy)))
    sorted_e = torch.from_numpy(np.repeat(np.arange(G), sizes)
                                .astype(np.int32))
    slot, tg, M_pad, n_used = tops.pad_sorted_groups(sorted_e, None, G, bm,
                                                     tight=True)
    slot = slot.long()
    # two more tiles past n_tiles, with groups in range
    tg = torch.cat([tg, torch.tensor([0, G - 1], dtype=torch.int32)])
    M_pad += 2 * bm
    td = getattr(torch, dtype)
    xb = torch.from_numpy(rng.standard_normal((M_pad, K))
                          .astype(np.float32)).to(td)
    db = torch.from_numpy(rng.standard_normal((M_pad, N))
                          .astype(np.float32)).to(td)
    live = torch.zeros(M_pad, dtype=torch.bool)
    live[:int(n_used) * bm] = True
    # rows of live tiles that no assignment owns are zero, as the model's
    # padding leaves them; rows of dead tiles keep their garbage
    xb[live], db[live] = 0, 0
    xb[slot], db[slot] = torch.from_numpy(x).to(td), \
        torch.from_numpy(dy).to(td)
    return dict(x=xb, w=torch.from_numpy(w).to(td), dout=db, tg=tg,
                n=n_used, bm=bm, slot=slot, want_dx=want_dx,
                want_dw=want_dw, M_pad=M_pad, live=live)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    atol, rtol = tol
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(scale, 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sizes,K,N,bm", CASES)
def test_bwd_twin_matches_jax_vjp_of_ragged_dot(sizes, K, N, bm, dtype):
    """dx at the assignments' slots and dw of every expert against
    ``jax.vjp`` of ``ragged_dot``; dx is zero on every other row (padding
    and the tiles past n_tiles, whose garbage must not count) and an
    empty expert's dw is exactly zero."""
    c = _problem(sizes, K, N, bm, seed=len(sizes) * K, dtype=dtype)
    dx, dw = tk4.grouped_matmul_bwd_plain(c["x"], c["w"], c["dout"], c["tg"],
                                          bm=bm, n_tiles=c["n"])
    assert dx.dtype == dw.dtype == getattr(torch, dtype)
    _close(dx[c["slot"]], c["want_dx"], TOL[dtype])
    _close(dw, c["want_dw"], TOL[dtype])
    pad = torch.ones(c["M_pad"], dtype=torch.bool)
    pad[c["slot"]] = False
    assert bool((dx[pad] == 0).all())
    for g, n in enumerate(sizes):
        if n == 0:
            assert bool((dw[g] == 0).all())


@pytest.mark.parametrize("sizes,K,N,bm", CASES)
def test_function_gradients_match_autograd_of_the_forward_twin(sizes, K, N,
                                                                bm):
    """``grouped_matmul`` with x and w needing a gradient (CPU: the K4 and
    B4 twins inside the autograd Function) gives the gradients autograd
    takes through ``grouped_matmul_plain`` (float32)."""
    c = _problem(sizes, K, N, bm, seed=7, dtype="float32")
    got, want = [], []
    for fn in (tk4.grouped_matmul, tk4.grouped_matmul_plain):
        leaves = [c["x"].clone().requires_grad_(),
                  c["w"].clone().requires_grad_()]
        fn(*leaves, c["tg"], bm=bm, n_tiles=c["n"]).backward(c["dout"])
        (got if fn is tk4.grouped_matmul else want).append(
            [t.grad for t in leaves])
    for g, w in zip(got[0], want[0]):
        _close(g, w.numpy(), TOL["float32"])


def test_function_passes_gradcheck_in_float64():
    """``torch.autograd.gradcheck`` of ``grouped_matmul`` in float64 (the
    twins sum in float64) at a tiny shape: an unsorted tile map with a
    group out of range and n_tiles below the tile count."""
    rng = np.random.default_rng(11)
    tg = torch.tensor([1, 0, 1, -1, 2, 0], dtype=torch.int32)
    x = torch.from_numpy(rng.standard_normal((6 * 16, 5))) \
        .requires_grad_()
    w = torch.from_numpy(rng.standard_normal((3, 5, 6))).requires_grad_()
    n = torch.tensor([5], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda a, b: tk4.grouped_matmul(a, b, tg, bm=16, n_tiles=n), (x, w))


@pytest.mark.parametrize("n_split", [2, 3, 7])
def test_row_split_sums_the_same_gradient(n_split):
    """The twin cut into slabs as the kernel cuts them under a plan (an
    expert with enough tiles into at most ``n_split`` rank ranges, each
    slab's tiles in order, the slabs in order) sums the same dw: equal to
    the uncut twin to float64 round-off; dx does not depend on the cut;
    a subset of experts is the same rows of the whole."""
    c = _problem((5, 0, 1, 130, 3), 24, 20, 16, seed=3, dtype="float32")
    args = [t.double() for t in (c["x"], c["w"], c["dout"])]
    plan = tk4.BwdPlan("cores", 16, 1, n_split, 64)
    slabs = tk4.expert_slabs(c["tg"], 5, c["tg"].numel(), c["n"], plan)
    assert slabs[3][1] == min(n_split, slabs[3][0]) > 1
    dx1, dw1 = tk4.grouped_matmul_bwd_plain(*args, c["tg"], bm=16,
                                            n_tiles=c["n"])
    dxs, dws = tk4.grouped_matmul_bwd_plain(*args, c["tg"], bm=16,
                                            n_tiles=c["n"], plan=plan)
    assert torch.equal(dx1, dxs)
    np.testing.assert_allclose(dws.numpy(), dw1.numpy(), rtol=1e-12,
                               atol=1e-12)
    _, some = tk4.grouped_matmul_bwd_plain(*args, c["tg"], bm=16,
                                           n_tiles=c["n"], plan=plan,
                                           need_dx=False, groups=[3, 1])
    assert torch.equal(some, dws[[3, 1]])


@pytest.mark.parametrize("counts,split_tiles,max_split,slots,want", [
    ((9, 0, 2, 40), 4, 32, 16, [(9, 2, 0), (0, 1, None), (2, 1, None),
                                (40, 10, 2)]),
    ((9, 40, 12), 4, 32, 8, [(9, 2, 0), (40, 1, None), (12, 1, None)]),
    ((9, 40, 12), 4, 32, 20, [(9, 2, 0), (40, 10, 2), (12, 3, 12)]),
    ((64, 64), 2, 32, 288, [(64, 32, 0), (64, 32, 32)]),
    ((64, 64), 2, 32, 0, [(64, 1, None), (64, 1, None)])])
def test_expert_slabs_grant_in_expert_order(counts, split_tiles, max_split,
                                            slots, want):
    """``expert_slabs``: an expert asks for min(max_split, c //
    split_tiles) slabs where that is 2 or more; in expert order a request
    is granted while the requests so far, granted or not, fit the slots
    (so a refused request refuses every later one), its first slot being
    the sum of the requests before it; the slabs granted fit the slots and
    their extra blocks the ``slots - 1`` the kernel launches."""
    tg = torch.tensor([g for g, c in enumerate(counts) for _ in range(c)],
                      dtype=torch.int32)
    plan = tk4.BwdPlan("cores", 16, split_tiles, max_split, slots)
    got = tk4.expert_slabs(tg, len(counts), tg.numel(), None, plan)
    assert got == want
    granted = [n for _, n, slot in got if slot is not None]
    assert sum(granted) <= max(slots, 0)
    assert sum(n - 1 for n in granted) <= max(slots - 1, 0)


@pytest.mark.parametrize("M,K,N,G,bm,sm", [
    (10240, 7168, 4864, 128, 16, 132), (10240, 4864, 7168, 128, 16, 132),
    (38912, 7168, 2048, 384, 16, 132), (9216, 64, 96, 8, 16, 132),
    (9216, 96, 64, 8, 16, 132), (512, 320, 200, 3, 128, 132),
    (64, 100, 36, 2, 16, 132), (256, 256, 264, 4, 32, 8)])
def test_bwd_plan_from_shapes_alone(M, K, N, G, bm, sm):
    """``bwd_plan``: bf16 operands that TMA can map take the tensor-core
    path, which cuts its own work on the device (dx items of
    ``TC_DX_CHUNK`` rows) and never splits rows; float32 (or unaligned)
    the CUDA cores (dx units of rows dividing bm, dw blocks of one 64 x 64
    tile) with the row split: a slab holds at least the tiles of the rows
    that spread the work over ``BWD_WAVES`` waves of blocks, but no more
    than ``SLAB_WORK`` rows and no fewer than ``MIN_SLAB_ROWS``; the slots
    are no more than ``MAX_SPLIT_BYTES`` of partials hold or slabs of that
    size the rows make, and 0 where fewer than 2; an expert asks for no
    more slabs than there are slots.  At every full-width training shape
    a CUDA-core slab is ``SLAB_WORK`` rows.  More experts than the
    prologue lists take the CUDA cores."""
    for dtype, tma in ((torch.bfloat16, True), (torch.float32, True),
                       (torch.bfloat16, False)):
        plan = tk4.bwd_plan(M, K, N, G, bm, dtype, sm, tma)
        fast = dtype == torch.bfloat16 and tma
        assert plan.path == ("tma" if fast else "cores")
        if fast:
            assert plan == tk4.BwdPlan("tma", tk4.TC_DX_CHUNK, 1, 1, 0)
            continue
        assert bm % plan.rows == 0 and plan.rows % 16 == 0
        assert plan.rows <= 128
        t = tk4.CORES_TILE
        n_kb, n_nb = -(-K // t), -(-N // t)
        rows = max(tk4.MIN_SLAB_ROWS,
                   min(tk4.SLAB_WORK, -(-M * n_kb * n_nb // (tk4.BWD_WAVES
                                                             * sm))))
        assert plan.split_tiles == max(1, rows // bm)
        room = tk4.MAX_SPLIT_BYTES // (n_kb * n_nb * t * t * 4)
        assert plan.slots == 0 or 2 <= plan.slots <= min(
            room, M // bm // plan.split_tiles)
        assert plan.slots * n_kb * n_nb * t * t * 4 <= tk4.MAX_SPLIT_BYTES
        assert plan.max_split == (min(tk4.MAX_ROW_SPLIT, plan.slots)
                                  if plan.slots else 1)
    if K >= 2048:
        plan = tk4.bwd_plan(M, K, N, G, bm, torch.float32, sm)
        assert plan.split_tiles * bm == tk4.SLAB_WORK
    assert tk4.bwd_plan(M, K, N, tk4.TC_MAX_GROUPS + 1, bm, torch.bfloat16,
                        sm).path == "cores"


def test_bwd_wrapper_checks_and_never_falls_back():
    """B4's wrapper raises on what the kernels do not take (dtype, a
    mixed dtype, the tile map's dtype, layout, n_tiles) before any build;
    operands it takes go to the build (which needs nvcc), never to the
    twin, and count no launch."""
    x = torch.zeros(32, 8)
    w = torch.zeros(2, 8, 4)
    d = torch.zeros(32, 4)
    tg = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tk4._bwd_launch(x.half(), w.half(), d.half(), tg, 16, None, True,
                        True)
    with pytest.raises(TypeError, match="one dtype"):
        tk4._bwd_launch(x, w, d.bfloat16(), tg, 16, None, True, True)
    with pytest.raises(TypeError, match="int32"):
        tk4._bwd_launch(x, w, d, tg.long(), 16, None, True, True)
    with pytest.raises(ValueError, match="contiguous"):
        tk4._bwd_launch(x, w, torch.zeros(4, 32).t(), tg, 16, None, True,
                        True)
    with pytest.raises(TypeError, match="n_tiles"):
        tk4._bwd_launch(x, w, d, tg, 16, 2, True, True)
    with pytest.raises(ValueError, match="dout must be"):
        tk4.grouped_matmul_bwd(x, w, d[:16], tg, bm=16)
    launches = tk4.grouped_matmul_bwd.launches
    from repro_torch.kernels import build
    try:
        build._nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc"):
            tk4._bwd_launch(x, w, d, tg, 16, None, True, True)
    assert tk4.grouped_matmul_bwd.launches == launches


def test_only_the_wanted_gradients_come_back():
    """``grouped_matmul_bwd`` returns None for a gradient not wanted, and
    the Function asks only for those autograd needs (w frozen: no dw)."""
    c = _problem((3, 2), 8, 8, 16, seed=1, dtype="float32")
    dx, dw = tk4.grouped_matmul_bwd(c["x"], c["w"], c["dout"], c["tg"],
                                    bm=16, n_tiles=c["n"], need_dw=False)
    assert dw is None and dx is not None
    x = c["x"].clone().requires_grad_()
    tk4.grouped_matmul(x, c["w"], c["tg"], bm=16,
                       n_tiles=c["n"]).backward(c["dout"])
    assert torch.equal(x.grad, dx)


# ---- the tensor-core path's work order (its prologue's host mirror) --------

def _random_map(seed, G, T, bad=0.0, unsorted=False):
    rng = np.random.default_rng(seed)
    tg = np.sort(rng.integers(0, G, T))
    if unsorted:
        rng.shuffle(tg)
    tg[rng.random(T) < bad] = -1
    return tg.tolist()


# (tile_group, G, n_tiles, K, N, bm): sorted and live; unsorted with
# groups out of range and n_tiles short; an expert beyond the resident x
# band (its units streamed, a run of one output tile each); ties; no live
# tile; bm 128; random maps over 40 experts, sorted and shuffled
WORK_CASES = [
    ([0] * 3 + [2] + [3] * 5 + [4] * 2 + [5] * 2, 6, None, 300, 200, 16),
    ([2, 0, -1, 2, 5, 1, 0, 7, 2], 6, 8, 264, 256, 32),
    ([0] * 600 + [1] + [2] * 3, 3, None, 256, 1000, 16),
    ([3, 0, 1, 2, 0, 1, 2], 4, None, 512, 128, 16),
    ([1, 0, 1], 2, 0, 64, 64, 16),
    ([1, 1, 0], 3, None, 64, 96, 128),
    (_random_map(5, 40, 300), 40, 280, 7168, 4864, 16),
    (_random_map(6, 40, 300, bad=0.1, unsorted=True), 40, None, 2048, 2048,
     16)]


@pytest.mark.parametrize("tg,G,n_tiles,K,N,bm", WORK_CASES)
def test_bwd_work_matches_brute_force(tg, G, n_tiles, K, N, bm):
    """``bwd_work`` (what the prologue builds on the device) against a
    brute force: each expert's live tiles (below n_tiles, group in [0, G))
    in tile order, whatever the map's order; the experts by live tiles,
    most first, ties by id; each expert with rows gets one dx item for
    each K band and chunk of at most ``TC_DX_CHUNK`` rows, its items
    adjacent and each band's chunks adjacent, covering its row groups
    once a band; every (expert, K band, N tile) of dw lies in exactly one
    unit, all of N in one unit where the expert's x band stays resident,
    else units of at most ``TC_DW_UNIT_ROWS`` rows x tiles (or one
    tile)."""
    T = len(tg)
    tgt = torch.tensor(tg, dtype=torch.int32)
    n = None if n_tiles is None else torch.tensor([n_tiles],
                                                  dtype=torch.int32)
    work = tk4.bwd_work(tgt, G, n, K, N, bm)
    used = T if n_tiles is None else min(n_tiles, T)
    want = [[t for t in range(used) if tg[t] == g] for g in range(G)]
    assert [list(t) for t in work.tiles] == want
    assert list(work.order) == sorted(range(G),
                                      key=lambda g: (-len(want[g]), g))
    n_band = -(-K // tk4.TC_DX_BAND)
    items = tk4.dx_item_list(work, K, bm)
    assert len(items) == sum(work.dx_items)
    seen = []
    for g, kb, q0, groups in items:
        assert 1 <= groups <= tk4.TC_DX_CHUNK // 16 and 0 <= kb < n_band
        seen.extend((g, kb, q) for q in range(q0, q0 + groups))
        assert q0 + groups <= len(want[g]) * bm // 16
    assert sorted(seen) == sorted(set(seen)) == sorted(
        (g, kb, q) for g in range(G) for kb in range(n_band)
        for q in range(len(want[g]) * bm // 16))
    firsts = [g for i, (g, *_) in enumerate(items)
              if i == 0 or items[i - 1][0] != g]
    assert firsts == [g for g in work.order if want[g]]
    n_kb, n_nb = -(-K // tk4.TC_DW_TILE), -(-N // tk4.TC_DW_TILE)
    units = tk4.dw_unit_list(work, K, N, bm)
    assert len(units) == sum(work.dw_units)
    tiles = []
    for g, kb, nb0, nb1, groups, resident in units:
        rows = len(want[g]) * bm
        assert groups == rows // 16
        assert resident == (0 < rows <= tk4.TC_DW_X_ROWS)
        if rows <= tk4.TC_DW_X_ROWS:
            assert (nb0, nb1) == (0, n_nb)
        else:
            assert nb1 - nb0 == 1 or rows * (nb1 - nb0) <= \
                tk4.TC_DW_UNIT_ROWS
        tiles.extend((g, kb, nb) for nb in range(nb0, nb1))
    assert sorted(tiles) == sorted(set(tiles)) == sorted(
        (g, kb, nb) for g in range(G) for kb in range(n_kb)
        for nb in range(n_nb))
    assert [u[0] for u in units] == sorted(
        (u[0] for u in units), key=work.order.index)


@pytest.mark.parametrize("tg,G,n_tiles,K,N,bm", WORK_CASES)
def test_work_buffer_layout(tg, G, n_tiles, K, N, bm):
    """``work_buffer`` lays the work order out as the device's buffer
    (lists, offsets, order, the dx and dw prefix sums, then a 16-byte
    aligned record a dx item within ``dx_item_bound``)."""
    T = len(tg)
    n = None if n_tiles is None else torch.tensor([n_tiles],
                                                  dtype=torch.int32)
    work = tk4.bwd_work(torch.tensor(tg, dtype=torch.int32), G, n, K, N,
                        bm)
    buf = tk4.work_buffer(work, T, K, bm)
    assert buf[:T] == [t for tiles in work.tiles for t in tiles] + [-1] * (
        T - sum(map(len, work.tiles)))
    off = buf[T:T + G + 1]
    assert off == [sum(map(len, work.tiles[:g])) for g in range(G + 1)]
    assert buf[T + G + 1:T + 2 * G + 1] == list(work.order)
    for i, pre in ((2, work.dx_items), (3, work.dw_units)):
        assert buf[T + i * G + i - 1:T + (i + 1) * G + i] == [
            sum(pre[:j]) for j in range(G + 1)]
    rec = tk4.rec_offset(T, G)
    assert rec % 4 == 0 and T + 4 * G + 3 <= rec < T + 4 * G + 7
    items = tk4.dx_item_list(work, K, bm)
    assert len(items) <= tk4.dx_item_bound(T, G, K, bm)
    assert len(buf) == rec + 4 * len(items)
    for j, (g, kb, q0, groups) in enumerate(items):
        assert buf[rec + 4 * j:rec + 4 * j + 4] == [g, kb | groups << 24, q0,
                                                    off[g]]


def test_tc_geometry_matches_the_kernel_source():
    """The host mirror's geometry is the kernels' own: the constants of
    ``namespace tc`` in ``csrc/moe_dispatch_bwd.cu``."""
    import re
    from pathlib import Path
    src = (Path(tk4.__file__).resolve().parents[2] / "csrc"
           / "moe_dispatch_bwd.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert (const("kDxBand"), const("kDxChunk"), const("kDwTile"),
            const("kDwXRows"), const("kDwUnitRows"), const("kMaxGroups")) \
        == (tk4.TC_DX_BAND, tk4.TC_DX_CHUNK, tk4.TC_DW_TILE,
            tk4.TC_DW_X_ROWS, tk4.TC_DW_UNIT_ROWS, tk4.TC_MAX_GROUPS)
