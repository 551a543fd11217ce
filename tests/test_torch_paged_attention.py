"""Port parity for paged-KV decode attention: the port's ``paged_attention``
and ``decode_attend`` on CPU tensors (the kernel's plain twin) against the
JAX package's Pallas kernel in interpret mode and its oracles, on the
cases of the JAX kernel tests: ragged lengths, a layered pool, the
in-flight merge, sliding windows, a per-layer hybrid layout, empty lanes
and GQA.  Inputs come from numpy and feed both sides.

Tolerances: float32 ``atol=rtol=1e-5`` (the same f32 arithmetic, summed
in another order); bfloat16 ``atol=2e-2`` on the output (one bf16 ulp at
|o| ~ 2 is 1.6e-2; m/l stay f32 and keep 1e-5)."""
import functools
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import paged_attention as jpa  # noqa: E402
from repro.kernels.paged_attention import ref as jref  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention as tpa  # noqa: E402
from repro_torch.kernels.paged_attention import ref as tref  # noqa: E402

torch.set_num_threads(1)

TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=0.0)}
STATE_TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, *, B, H, Hkv, D, page, npages, L=None, lengths=None,
          P=None):
    """numpy operands: q, k/v pages (layered when ``L``), in-flight k/v,
    a page table of distinct blocks, lengths."""
    rng = np.random.default_rng(seed)
    P = P or B * npages + 2
    lead = (L,) if L else ()
    q = rng.standard_normal((B, H, D), np.float32)
    kp = rng.standard_normal(lead + (P, page, Hkv, D), np.float32)
    vp = rng.standard_normal(lead + (P, page, Hkv, D), np.float32)
    kn = rng.standard_normal((B, Hkv, D), np.float32)
    vn = rng.standard_normal((B, Hkv, D), np.float32)
    pt = rng.permutation(P)[:B * npages].reshape(B, npages).astype(np.int32)
    if lengths is None:
        lengths = rng.integers(1, page * npages + 1, B)
    return dict(q=q, kp=kp, vp=vp, kn=kn, vn=vn, pt=pt,
                ln=np.asarray(lengths, np.int32))


def _sides(c, dtype):
    """The same operands as jax arrays and torch tensors in ``dtype``
    (float data rounds to bf16 identically on both sides)."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)
    j, t = {}, {}
    for k, a in c.items():
        if a.dtype == np.float32:
            j[k] = jnp.asarray(a).astype(jd)
            t[k] = torch.from_numpy(a).to(td)
        else:
            j[k] = jnp.asarray(a)
            t[k] = torch.from_numpy(a)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _check_state(t_out, j_out, dtype):
    (o, m, l), (jo, jm, jl) = t_out, j_out
    assert o.dtype == getattr(torch, dtype)
    assert m.dtype == l.dtype == torch.float32
    np.testing.assert_allclose(_np(o), _np(jo), **TOL[dtype])
    np.testing.assert_allclose(_np(m), _np(jm), **STATE_TOL)
    np.testing.assert_allclose(_np(l), _np(jl), **STATE_TOL)


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """CPU tensors never reach the CUDA kernels."""
    before = (tpa.paged_attention.launches,
              tpa.paged_attention.merge_launches)
    yield
    assert (tpa.paged_attention.launches,
            tpa.paged_attention.merge_launches) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,D,page,npages", [
    (2, 4, 2, 64, 16, 4),
    (3, 8, 1, 64, 32, 2),
    (1, 4, 4, 128, 16, 8),
])
def test_paged_attention_matches_jax(B, H, Hkv, D, page, npages, dtype):
    c = _case(2, B=B, H=H, Hkv=Hkv, D=D, page=page, npages=npages)
    j, t = _sides(c, dtype)
    got = tpa.paged_attention(t["q"], t["kp"], t["vp"], t["pt"], t["ln"],
                              return_state=True)
    want = jpa.paged_attention(j["q"], j["kp"], j["vp"], j["pt"], j["ln"],
                               interpret=True, return_state=True)
    _check_state(got, want, dtype)
    # and the port's oracle agrees with the plain twin
    np.testing.assert_allclose(
        _np(got[0]),
        _np(tref.paged_attention_ref(t["q"], t["kp"], t["vp"], t["pt"],
                                     t["ln"])), **TOL[dtype])


def test_paged_attention_layered_pool():
    c = _case(7, B=2, H=4, Hkv=2, D=64, page=16, npages=3, L=3)
    j, t = _sides(c, "float32")
    for layer in range(3):
        got = tpa.paged_attention(t["q"], t["kp"], t["vp"], t["pt"],
                                  t["ln"], layer=layer, return_state=True)
        want = jpa.paged_attention(j["q"], j["kp"], j["vp"], j["pt"],
                                   j["ln"], layer=layer, interpret=True,
                                   return_state=True)
        _check_state(got, want, "float32")
    # 4-D single-plane pages read as plane 0
    out4 = tpa.paged_attention(t["q"], t["kp"][1], t["vp"][1], t["pt"],
                               t["ln"])
    np.testing.assert_allclose(
        _np(out4), _np(tref.paged_attention_ref(
            t["q"], t["kp"], t["vp"], t["pt"], t["ln"], layer=1)),
        **TOL["float32"])
    with pytest.raises(ValueError, match="4-D pages"):
        tpa.paged_attention(t["q"], t["kp"][1], t["vp"][1], t["pt"],
                            t["ln"], layer=1)
    with pytest.raises(ValueError, match="layer index"):
        tpa.paged_attention(t["q"], t["kp"], t["vp"], t["pt"], t["ln"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attend_merges_inflight_token(dtype):
    """Paged pass + one merge step == flat softmax over [cache; token],
    zero-length lanes included, against both packages."""
    c = _case(8, B=3, H=8, Hkv=2, D=32, page=8, npages=2, L=2, P=7,
              lengths=[0, 5, 16])
    c["pt"] = np.asarray([[1, 2], [3, 4], [5, 6]], np.int32)
    j, t = _sides(c, dtype)
    for layer in range(2):
        args_t = (t["q"], t["kn"], t["vn"], t["kp"], t["vp"], t["pt"],
                  t["ln"])
        args_j = (j["q"], j["kn"], j["vn"], j["kp"], j["vp"], j["pt"],
                  j["ln"])
        got = tpa.decode_attend(*args_t, layer=layer)
        assert got.dtype == getattr(torch, dtype)
        assert np.isfinite(_np(got)).all()
        want = jpa.decode_attend(*args_j, layer=layer, interpret=True)
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
        np.testing.assert_allclose(
            _np(got), _np(tref.paged_decode_ref(*args_t, layer=layer)),
            **TOL[dtype])


@pytest.mark.parametrize("window", [0, 1, 3, 8, 11, 100])
def test_window_mask(window):
    """The query at ``lengths[b]`` sees only the last ``window``
    positions; window 1 admits no cached key (empty state), a window
    wider than the cache is the global mask."""
    c = _case(12, B=3, H=4, Hkv=2, D=32, page=8, npages=3,
              lengths=[2, 13, 24])
    j, t = _sides(c, "float32")
    got = tpa.paged_attention(t["q"], t["kp"], t["vp"], t["pt"], t["ln"],
                              window=window, return_state=True)
    want = jpa.paged_attention(j["q"], j["kp"], j["vp"], j["pt"], j["ln"],
                               window=window, interpret=True,
                               return_state=True)
    _check_state(got, want, "float32")
    full = tpa.decode_attend(t["q"], t["kn"], t["vn"], t["kp"], t["vp"],
                             t["pt"], t["ln"], window=window)
    jfull = jpa.decode_attend(j["q"], j["kn"], j["vn"], j["kp"], j["vp"],
                              j["pt"], j["ln"], window=window,
                              interpret=True)
    np.testing.assert_allclose(_np(full), _np(jfull), **TOL["float32"])
    np.testing.assert_allclose(
        _np(full), _np(tref.paged_decode_ref(
            t["q"], t["kn"], t["vn"], t["kp"], t["vp"], t["pt"], t["ln"],
            window=window)), **TOL["float32"])
    if window == 1:
        o, m, l = got
        assert (o == 0).all() and (m == -1e30).all() and (l == 0).all()


def test_window_per_layer_hybrid_layout():
    """global_every layout: window flipped per layer (0 on global layers)
    over one layered pool."""
    c = _case(13, B=2, H=4, Hkv=2, D=32, page=8, npages=2, L=4,
              lengths=[7, 16])
    j, t = _sides(c, "float32")
    for li in range(4):
        wl = 0 if li % 2 == 0 else 5
        got = tpa.paged_attention(t["q"], t["kp"], t["vp"], t["pt"],
                                  t["ln"], layer=li, window=wl,
                                  return_state=True)
        want = jpa.paged_attention(j["q"], j["kp"], j["vp"], j["pt"],
                                   j["ln"], layer=li,
                                   window=jnp.asarray(wl, jnp.int32),
                                   interpret=True, return_state=True)
        _check_state(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_empty_lane_state_is_exact(dtype):
    """A lane with length 0 comes back as (0, -1e30, 0) exactly, beside a
    full lane — what the merge needs for exp(m - m2) == 0."""
    c = _case(21, B=2, H=4, Hkv=2, D=64, page=16, npages=4,
              lengths=[0, 64])
    j, t = _sides(c, dtype)
    o, m, l = tpa.paged_attention(t["q"], t["kp"], t["vp"], t["pt"],
                                  t["ln"], return_state=True)
    assert (o[0] == 0).all() and (m[0] == -1e30).all() and (l[0] == 0).all()
    _check_state((o, m, l),
                 jpa.paged_attention(j["q"], j["kp"], j["vp"], j["pt"],
                                     j["ln"], interpret=True,
                                     return_state=True), dtype)


@pytest.mark.parametrize("n_rep", [2, 8])
def test_gqa_groups(n_rep):
    """Query head h reads kv head h // n_rep, as in the reference."""
    c = _case(30 + n_rep, B=3, H=8, Hkv=8 // n_rep, D=64, page=4,
              npages=5, L=2)
    j, t = _sides(c, "float32")
    got = tpa.paged_attention(t["q"], t["kp"], t["vp"], t["pt"], t["ln"],
                              layer=1, return_state=True)
    want = jpa.paged_attention(j["q"], j["kp"], j["vp"], j["pt"], j["ln"],
                               layer=1, interpret=True, return_state=True)
    _check_state(got, want, "float32")


@pytest.mark.parametrize("window", [0, 5])
def test_oracles_agree(window):
    """The port's flat-softmax oracles against the JAX package's."""
    c = _case(40, B=3, H=4, Hkv=2, D=32, page=8, npages=3, L=2,
              lengths=[0, 9, 24])
    j, t = _sides(c, "float32")
    args_t = (t["q"], t["kn"], t["vn"], t["kp"], t["vp"], t["pt"], t["ln"])
    args_j = (j["q"], j["kn"], j["vn"], j["kp"], j["vp"], j["pt"], j["ln"])
    np.testing.assert_allclose(
        _np(tref.paged_decode_ref(*args_t, layer=1, window=window)),
        _np(jref.paged_decode_ref(*args_j, layer=1, window=window)),
        **TOL["float32"])
    np.testing.assert_allclose(
        _np(tref.paged_attention_ref(*args_t[:1], *args_t[3:], layer=1,
                                     window=window)),
        _np(jref.paged_attention_ref(*args_j[:1], *args_j[3:], layer=1,
                                     window=window)),
        **TOL["float32"])


# -- the split-and-merge arithmetic of the two CUDA kernels ------------------
# ``paged_attention_split_plain`` cuts the pages into the kernels' ranges,
# computes each range's partial state and merges them; it is held against
# the JAX kernel (interpret mode) at the tolerances above: f32 1e-5 (the
# same f32 arithmetic, summed per range and then across ranges), bf16 2e-2
# on o (one bf16 ulp at |o| ~ 2 is 1.6e-2), m/l f32 1e-5.  Each case:
# (B, H, Hkv, D, page, npages, L, layer, lengths, window).
SPLIT_CASES = {
    # ragged lengths, an empty lane and a full one, n_rep 1
    "ragged": (4, 8, 8, 64, 4, 12, None, 0, [0, 5, 48, 17], 0),
    # windows that leave only the last ranges (whole ranges masked), and
    # window 1, which admits no cached key
    "window_masks_ranges": (3, 4, 2, 64, 4, 12, None, 0, [48, 45, 20], 9),
    "window1": (3, 4, 2, 64, 4, 12, None, 0, [48, 0, 7], 1),
    # GQA at the head dims the kernels build: n_rep 5 (hymba), 7
    # (arctic), 8 (kimi-k2, d 112), n_rep 1 at d 112; a layered pool
    # read at layer > 0
    "rep5_d64": (2, 10, 2, 64, 8, 6, 2, 1, [0, 37], 0),
    "rep7_d128": (2, 14, 2, 128, 8, 6, 2, 1, [48, 29], 0),
    "rep8_d112": (2, 8, 1, 112, 16, 4, 3, 2, [64, 33], 0),
    "rep1_d112": (2, 4, 4, 112, 16, 4, 3, 2, [15, 64], 0),
}


@functools.lru_cache(maxsize=None)
def _split_case(name, dtype):
    """Operands of a split case and the JAX kernel's state on them."""
    B, H, Hkv, D, page, npages, L, layer, lengths, window = \
        SPLIT_CASES[name]
    c = _case(60, B=B, H=H, Hkv=Hkv, D=D, page=page, npages=npages, L=L,
              lengths=lengths)
    j, t = _sides(c, dtype)
    kw = dict(layer=layer) if L else {}
    want = jpa.paged_attention(j["q"], j["kp"], j["vp"], j["pt"], j["ln"],
                               window=window, interpret=True,
                               return_state=True, **kw)
    return t, dict(layer=layer, window=window), want


def _layered(t, L):
    return (t["kp"], t["vp"]) if L else (t["kp"][None], t["vp"][None])


@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_plain_matches_jax(name, n_split):
    t, kw, want = _split_case(name, "float32")
    kp, vp = _layered(t, SPLIT_CASES[name][6])
    got = tpa.paged_attention_split_plain(t["q"], kp, vp, t["pt"], t["ln"],
                                          n_split=n_split, **kw)
    _check_state(got, want, "float32")
    if kw["window"] == 1 or name == "ragged":
        o, m, l = got
        empty = [b for b, n in enumerate(SPLIT_CASES[name][8])
                 if n == 0 or kw["window"] == 1]
        assert (o[empty] == 0).all() and (m[empty] == -1e30).all() \
            and (l[empty] == 0).all()


@pytest.mark.parametrize("n_split", [2, 7])
@pytest.mark.parametrize("name", ["ragged", "rep7_d128", "rep8_d112"])
def test_split_plain_matches_jax_bf16(name, n_split):
    t, kw, want = _split_case(name, "bfloat16")
    kp, vp = _layered(t, SPLIT_CASES[name][6])
    got = tpa.paged_attention_split_plain(t["q"], kp, vp, t["pt"], t["ln"],
                                          n_split=n_split, **kw)
    _check_state(got, want, "bfloat16")


@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
def test_split_plain_lengths_on_range_edges(n_split):
    """Lengths that are exact multiples of a range's span (and one short
    of, and one past, an edge): each range ends where a lane does."""
    B, H, Hkv, D, page, npages = 5, 4, 2, 64, 4, 14
    pps = tpa.split_span(npages, n_split)[1]
    span = pps * page
    lengths = [min(span, npages * page), min(2 * span, npages * page),
               span - 1, min(span + 1, npages * page), npages * page]
    c = _case(61, B=B, H=H, Hkv=Hkv, D=D, page=page, npages=npages,
              lengths=lengths)
    j, t = _sides(c, "float32")
    got = tpa.paged_attention_split_plain(t["q"], t["kp"][None],
                                          t["vp"][None], t["pt"], t["ln"],
                                          layer=0, n_split=n_split)
    want = jpa.paged_attention(j["q"], j["kp"], j["vp"], j["pt"], j["ln"],
                               interpret=True, return_state=True)
    _check_state(got, want, "float32")


def test_split_partials_are_the_kernels_ranges():
    """Each partial state covers exactly its range's valid positions: a
    range past a lane's length is empty (0, -1e30, 0), and merging the
    partials (``merge_partials``, the CPU twin of the merge kernel)
    gives the oracle."""
    c = _case(62, B=2, H=4, Hkv=2, D=64, page=4, npages=12,
              lengths=[10, 48])
    _, t = _sides(c, "float32")
    kp, vp = t["kp"][None], t["vp"][None]
    acc, m, l = tpa.paged_attention_partials(t["q"], kp, vp, t["pt"],
                                             t["ln"], layer=0, n_split=3)
    assert acc.shape == (2, 4, 3, 64) and m.shape == l.shape == (2, 4, 3)
    # lane 0 holds 10 positions: pages 0-2 of range [0, 4); ranges 1, 2
    # are empty
    assert (m[0, :, 1:] == -1e30).all() and (l[0, :, 1:] == 0).all() \
        and (acc[0, :, 1:] == 0).all()
    assert (l[1] > 0).all()
    o, M, L = tpa.merge_partials(acc, m, l, t["q"])
    want = tpa.paged_attention_plain(t["q"], kp, vp, t["pt"], t["ln"],
                                     layer=0)
    _check_state((o, M, L), want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["ragged", "window_masks_ranges",
                                  "window1", "rep7_d128", "rep8_d112"])
def test_decode_attend_plain_matches_jax(name, dtype):
    """The cached positions' state and the in-flight token's merge step
    against the JAX ``decode_attend`` (kernel state + one merge step)."""
    B, H, Hkv, D, page, npages, L, layer, lengths, window = \
        SPLIT_CASES[name]
    c = _case(63, B=B, H=H, Hkv=Hkv, D=D, page=page, npages=npages, L=L,
              lengths=lengths)
    j, t = _sides(c, dtype)
    kp, vp = _layered(t, L)
    got = tpa.decode_attend_plain(t["q"], t["kn"], t["vn"], kp, vp, t["pt"],
                                  t["ln"], layer=layer, window=window)
    assert got.dtype == getattr(torch, dtype)
    kw = dict(layer=layer) if L else {}
    want = jpa.decode_attend(j["q"], j["kn"], j["vn"], j["kp"], j["vp"],
                             j["pt"], j["ln"], window=window, interpret=True,
                             **kw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    # the merge pass's twin folds the token into the split twin's partial
    # states: the same answer
    parts = tpa.split_partials_plain(t["q"], kp, vp, t["pt"], t["ln"],
                                     layer=layer, window=window, n_split=3)
    merged = tpa.merge_partials_plain(*parts, t["q"], t["kn"], t["vn"])
    np.testing.assert_allclose(_np(merged), _np(want), **TOL[dtype])


def test_decode_attend_rounds_o_as_the_reference():
    """The in-flight merge keeps the reference's rounding point: JAX
    ``decode_attend`` rounds the kernel's o to q's dtype before the merge
    step, and so do the port's merge kernel and its twins.  In bf16 the
    port then agrees with the reference to within one bf16 spacing of
    |o| (2**-7: summation order may move a value across a rounding
    boundary), closer than the bf16 tolerance; the f32 answer rounded
    once stays within that tolerance; in f32 both agree to summation
    order."""
    c = _case(64, B=4, H=8, Hkv=2, D=64, page=4, npages=8, L=2,
              lengths=[0, 9, 32, 30])
    j, t = _sides(c, "bfloat16")
    args = (t["q"], t["kn"], t["vn"], t["kp"], t["vp"], t["pt"], t["ln"])
    got = tpa.decode_attend(*args, layer=1)
    want = jpa.decode_attend(j["q"], j["kn"], j["vn"], j["kp"], j["vp"],
                             j["pt"], j["ln"], layer=1, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6,
                               rtol=2.0 ** -7)
    once = tref.paged_decode_ref(*(a.float() if a.is_floating_point()
                                   else a for a in args), layer=1)
    np.testing.assert_allclose(_np(got), _np(once), **TOL["bfloat16"])
    parts = tpa.split_partials_plain(t["q"], t["kp"], t["vp"], t["pt"],
                                     t["ln"], layer=1, n_split=3)
    merged = tpa.merge_partials_plain(*parts, t["q"], t["kn"], t["vn"])
    np.testing.assert_allclose(_np(merged), _np(want), atol=1e-6,
                               rtol=2.0 ** -7)
    j32, t32 = _sides(c, "float32")
    got32 = tpa.decode_attend(t32["q"], t32["kn"], t32["vn"], t32["kp"],
                              t32["vp"], t32["pt"], t32["ln"], layer=1)
    want32 = jpa.decode_attend(j32["q"], j32["kn"], j32["vn"], j32["kp"],
                               j32["vp"], j32["pt"], j32["ln"], layer=1,
                               interpret=True)
    np.testing.assert_allclose(_np(got32), _np(want32), **TOL["float32"])


# -- the split plan: a function of shapes ------------------------------------
def test_split_plan_takes_shapes_alone():
    """The wrapper picks the ranges from ints it already knows: no
    tensor goes in, so ``lengths`` is never read back from the card."""
    params = list(inspect.signature(tpa.split_plan).parameters)
    assert params == ["n_pages", "page", "B", "Hkv", "n_rep", "sm_count"]
    plan = tpa.split_plan(256, 16, 8, 16, 1, 132)
    assert plan == tpa.split_plan(256, 16, 8, 16, 1, 132)
    assert all(type(x) is int for x in plan)


@pytest.mark.parametrize("n_pages,page", [(1, 16), (4, 16), (8, 8),
                                          (16, 4), (3, 4)])
def test_split_plan_one_range_when_too_few_pages(n_pages, page):
    """No more pages than one 64-token stage: nothing to split."""
    assert tpa.split_plan(n_pages, page, 1, 1, 1, 132)[0] == 1


@pytest.mark.parametrize("n_pages", [1, 5, 8, 31, 128, 256, 1000])
@pytest.mark.parametrize("page", [4, 8, 16])
@pytest.mark.parametrize("B,Hkv,n_rep,sms", [(1, 1, 1, 132), (8, 16, 1, 132),
                                             (8, 5, 5, 132), (64, 8, 7, 78),
                                             (3, 1, 32, 132)])
def test_split_plan_tiles_the_pages(n_pages, page, B, Hkv, n_rep, sms):
    """The ranges tile [0, n_pages) without gap or overlap, none empty,
    each a whole number of 64-token stages but the last."""
    n, pps = tpa.split_plan(n_pages, page, B, Hkv, n_rep, sms)
    ranges = tpa.split_ranges(n_pages, pps)
    assert len(ranges) == n >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == n_pages
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(n - 1))
    assert pps % max(64 // page, 1) == 0


@pytest.mark.parametrize("n_pages", [1, 2, 9, 12, 64])
@pytest.mark.parametrize("n_split", [1, 2, 3, 7, 100])
def test_split_span_tiles_the_pages(n_pages, n_split):
    n, pps = tpa.split_span(n_pages, n_split)
    ranges = tpa.split_ranges(n_pages, pps)
    assert len(ranges) == n <= max(n_split, 1)
    assert ranges[0][0] == 0 and ranges[-1][1] == n_pages
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(n - 1))


@pytest.mark.parametrize("name,shape", [
    ("long", (256, 16, 8, 16, 1)),       # 8 lanes, 16 heads of 64, 4096
    ("arctic", (128, 16, 8, 8, 7)),      # 56 heads over 8, lengths 2048
    ("hymba", (128, 16, 8, 5, 5)),       # 25 heads over 5, window 1024
    ("kimi", (128, 16, 8, 8, 8)),        # 64 heads over 8 of 112
])
def test_split_plan_fills_an_h100(name, shape):
    """At the timed cases an H100's 132 SMs get at least two blocks each
    (before a lane's empty ranges exit)."""
    n_pages, page, B, Hkv, n_rep = shape
    n, _ = tpa.split_plan(n_pages, page, B, Hkv, n_rep, 132)
    assert n * B * Hkv * -(-n_rep // 16) >= 2 * 132


@pytest.mark.parametrize("D,page", [(32, 16), (96, 16), (256, 16),
                                    (64, 32), (128, 2)])
def test_cuda_branch_refuses_unbuilt_shapes(D, page):
    """A head dim or page the kernels were not built for raises before
    any build or launch, and never falls back to a plain twin."""
    q = torch.zeros(1, 4, D)
    kp = torch.zeros(1, 3, page, 2, D)
    pt = torch.zeros(1, 1, dtype=torch.int32)
    ln = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim"):
        tpa._launch(q, kp, kp, pt, ln, 0, 0)


def test_merge_kernel_refuses_bad_operands():
    """The merge pass's wrapper checks the partial states and the
    in-flight token before any build or launch."""
    q = torch.zeros(2, 4, 64)
    acc, m, l = torch.zeros(2, 4, 3, 64), torch.zeros(2, 4, 3), \
        torch.zeros(2, 4, 3)
    with pytest.raises(ValueError, match="partial acc"):
        tpa._launch_merge(acc[..., :32], m, l, q)
    with pytest.raises(ValueError, match="partial m"):
        tpa._launch_merge(acc, m.double(), l, q)
    with pytest.raises(ValueError, match="head_dim"):
        tpa._launch_merge(acc[..., :32].contiguous(), m, l,
                          q[..., :32].contiguous())
    kn = torch.zeros(2, 2, 128)[..., ::2]          # last dim strided
    with pytest.raises(ValueError, match="k_new"):
        tpa._launch_merge(acc, m, l, q, kn, kn)
