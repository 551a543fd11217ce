"""Port parity for paged-KV decode attention: the port's ``paged_attention``
and ``decode_attend`` on CPU tensors (the kernel's plain twin) against the
JAX package's Pallas kernel in interpret mode and its oracles, on the
cases of the JAX kernel tests: ragged lengths, a layered pool, the
in-flight merge, sliding windows, a per-layer hybrid layout, empty lanes
and GQA.  Inputs come from numpy and feed both sides.

Tolerances: float32 ``atol=rtol=1e-5`` (the same f32 arithmetic, summed
in another order); bfloat16 ``atol=2e-2`` on the output (one bf16 ulp at
|o| ~ 2 is 1.6e-2; m/l stay f32 and keep 1e-5)."""
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
    """CPU tensors never reach the CUDA kernel."""
    before = tpa.paged_attention.launches
    yield
    assert tpa.paged_attention.launches == before


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
