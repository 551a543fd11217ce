"""Port parity for blockwise attention: the port's ``flash_attention`` on
CPU tensors (the kernel's plain twin) against the JAX package's Pallas
``flash_attention`` in interpret mode, at the reference kernel tests'
shapes, and against the JAX oracle ``attention_ref`` at the shapes the
Pallas kernel refuses but the port's path needs (ragged sequences,
cross-attention with fewer queries than keys, head dims 16 and 112).
Then the port's ``layers.sdpa``: each mask kind routes to the same
numbers as its plain masked form.  Inputs come from numpy and feed both
sides.

Tolerances: the reference's own — float32 2e-5, bfloat16 3e-2 (both
round the probabilities and the output to bf16, at other points)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jfa  # noqa: E402
from repro.kernels.flash_attention import ref as jref  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as tfa  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tref  # noqa: E402
from repro_torch.models import layers  # noqa: E402

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _qkv(seed, B, Sq, Sk, H, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D), np.float32),
            rng.standard_normal((B, Sk, H, D), np.float32),
            rng.standard_normal((B, Sk, H, D), np.float32))


def _sides(arrays, dtype):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("B,S,H,D,bq,bk", [
    (1, 128, 2, 64, 64, 64),
    (2, 256, 4, 64, 128, 128),
    (1, 512, 1, 128, 256, 256),
    (1, 128, 2, 256, 64, 64),      # paligemma's head dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_causal(B, S, H, D, bq, bk, dtype):
    (jq, jk, jv), (tq, tk, tv) = _sides(_qkv(0, B, S, S, H, D), dtype)
    want = jfa.flash_attention(jq, jk, jv, causal=True, bq=bq, bk=bk,
                               interpret=True)
    got = tfa.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_noncausal(dtype):
    (jq, jk, jv), (tq, tk, tv) = _sides(_qkv(1, 1, 128, 128, 2, 64), dtype)
    want = jfa.flash_attention(jq, jk, jv, causal=False, bq=64, bk=64,
                               interpret=True)
    got = tfa.flash_attention(tq, tk, tv, causal=False)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("B,Sq,Sk,H,D,causal", [
    (2, 24, 24, 4, 64, True),      # a 24-token prefill: not a tile multiple
    (1, 100, 100, 3, 64, True),
    (2, 100, 100, 2, 64, False),
    (2, 1, 40, 4, 64, False),      # cross-attention at decode
    (2, 7, 40, 4, 64, False),      # cross-attention at prefill
    (2, 24, 24, 4, 16, True),      # the smoke configs' head dim
    (1, 24, 24, 2, 112, True),     # kimi-k2's head dim
    (1, 7, 40, 2, 112, False),
    (2, 24, 24, 2, 256, True),     # paligemma's head dim
    (1, 7, 100, 2, 256, False),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_oracle_where_pallas_refuses(B, Sq, Sk, H, D, causal,
                                                   dtype):
    (jq, jk, jv), (tq, tk, tv) = _sides(_qkv(2, B, Sq, Sk, H, D), dtype)
    want = jref.attention_ref(jq, jk, jv, causal=causal)
    got = tfa.flash_attention(tq, tk, tv, causal=causal)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0)])
def test_oracle_port_matches_jax_oracle(causal, window):
    """The port's ``attention_ref`` keeps the reference's query offset
    ``Sk - S`` and its window."""
    (jq, jk, jv), (tq, tk, tv) = _sides(_qkv(3, 2, 7, 19, 2, 16), "float32")
    want = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    got = tref.attention_ref(tq, tk, tv, causal=causal, window=window)
    _close(got, want, 1e-5)


def test_causal_needs_as_many_queries_as_keys():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 7, 40, 2, 16))
    with pytest.raises(ValueError, match="as many queries as keys"):
        tfa.flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="as many queries as keys"):
        tfa.flash_attention_plain(q, k, v, causal=True)
    with pytest.raises(ValueError, match="shape mismatch"):
        tfa.flash_attention(q, k[:, :, :1], v, causal=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["none", "causal"])
def test_sdpa_mask_kinds_equal_their_masked_form(kind, dtype):
    """``sdpa`` with the kind None or CAUSAL (through ``flash_attention``)
    against the same attention with the mask as a bool tensor (the plain
    masked softmax).  bfloat16: the plain form rounds its scores and
    probabilities to bf16, the kernel path keeps f32 scores."""
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype))
               for a in _qkv(5, 2, 24, 24, 4, 16))
    mask = None if kind == "none" else layers.CAUSAL
    full = torch.ones(24, 24, dtype=torch.bool) if kind == "none" \
        else layers.causal_mask(24, 24)
    got = layers.sdpa(q, k, v, mask)
    want = layers.sdpa(q, k, v, full)
    tol = 1e-6 if dtype == "float32" else TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=tol, atol=tol)


def test_sdpa_refuses_an_unknown_mask_kind():
    q = torch.zeros(1, 2, 1, 16)
    with pytest.raises(ValueError, match="mask kind"):
        layers.sdpa(q, q, q, "window")


def test_kernel_wrapper_never_falls_back():
    """A CUDA-bound launch with operands the kernel takes goes to the
    build (which needs nvcc), never to the plain twin; operands the
    kernel does not take raise before that."""
    q = torch.zeros(1, 4, 2, 64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa._launch(q.half(), q.half(), q.half(), False)
    with pytest.raises(ValueError, match="head_dim"):
        tfa._launch(q[..., :32].contiguous(), q[..., :32].contiguous(),
                    q[..., :32].contiguous(), False)
    with pytest.raises(ValueError, match="contiguous"):
        tfa._launch(q.transpose(1, 2), q, q, False)
    big = torch.zeros(1, 1, 65536, 16)
    with pytest.raises(ValueError, match="B \\* H"):
        tfa._launch(big, big, big, False)
    launches = tfa.flash_attention.launches
    try:
        build._nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc"):
            tfa._launch(q, q, q, False)
    assert tfa.flash_attention.launches == launches


def test_every_csrc_source_is_built():
    """``build.SOURCES`` lists every CUDA source, so ``build_all`` builds
    every kernel before the kernel phases."""
    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    assert sorted(build.SOURCES) == sources
    assert "flash_attention" in sources and "moe_dispatch" in sources


# ---- the kernels' plan and the key split's arithmetic ---------------------
# shapes the serving paths give K5: whisper-base's encoder, cross-attention
# at prefill and decode, decoder prefill; qwen's, arctic's and kimi's
# 24-token prefills; a long causal prefill
PLAN_SHAPES = {"whisper_encoder": (8, 1500, 1500, 8, 64, False),
               "whisper_cross_prefill": (8, 24, 1500, 8, 64, False),
               "whisper_cross_decode": (8, 1, 1500, 8, 64, False),
               "whisper_decoder_prefill": (8, 24, 24, 8, 64, True),
               "qwen_prefill": (1, 24, 24, 16, 64, True),
               "arctic_prefill": (1, 24, 24, 56, 128, True),
               "kimi_prefill": (1, 24, 24, 64, 112, True),
               "long_prefill": (1, 8192, 8192, 16, 128, True),
               "paligemma_prefill": (8, 24, 24, 8, 256, True),
               "long_d256": (1, 2048, 2048, 8, 256, True)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sms", [132, 114, 8])
@pytest.mark.parametrize("name", list(PLAN_SHAPES))
def test_split_plan_covers_every_key_once(name, sms, dtype):
    """``split_plan`` reads shapes and the SM count only; its ranges cover
    every key exactly once, in whole steps of the path (all but the last
    range), within the kernel's 32 ranges; bf16 takes the wgmma tiles for
    many queries and the key split for few, and at head dim 256 (outside
    the wgmma tiles) the key split at every length."""
    B, Sq, Sk, H, D, causal = PLAN_SHAPES[name]
    plan = tfa.split_plan(B, Sq, Sk, H, D, getattr(torch, dtype), sms)
    assert plan.path == ("f32" if dtype == "float32" else
                         "wgmma" if Sq > tfa.FEW_QUERIES and D != 256
                         else "few")
    assert 1 <= plan.n_split <= tfa.MAX_SPLIT
    assert plan.keys_per_split % tfa.PATHS[plan.path]["step"] == 0
    ranges = tfa.split_ranges(Sk, plan.keys_per_split)
    assert len(ranges) == plan.n_split
    seen = np.zeros(Sk, np.int64)
    for start, stop in ranges:
        assert stop > start
        seen[start:stop] += 1
    assert (seen == 1).all()
    if plan.path == "wgmma":
        assert plan.n_split == 1


def test_split_plan_fills_the_card_at_decode():
    """Whisper's one-query cross-attention (64 query tiles of 1500 keys)
    splits its keys so the blocks cover the card; a prefill of many
    queries does not split."""
    plan = tfa.split_plan(8, 1, 1500, 8, 64, torch.bfloat16, 132)
    assert plan.n_split > 1 and 64 * plan.n_split >= 132
    assert tfa.split_plan(8, 1500, 1500, 8, 64, torch.float32,
                          132).n_split == 1


@pytest.mark.parametrize("keys_per_split", [64, 128, 192, 1000])
@pytest.mark.parametrize("B,Sq,Sk,H,D,causal", [
    (2, 1, 300, 4, 64, False),      # cross-attention at decode
    (2, 7, 300, 4, 16, False),
    (1, 100, 100, 3, 64, True),     # causal: ranges past a row are empty
    (1, 24, 200, 2, 112, False),
    (2, 1, 300, 2, 256, False),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_plain_matches_plain_and_oracle(B, Sq, Sk, H, D, causal,
                                              keys_per_split, dtype):
    """The key split's arithmetic (``flash_attention_split_plain``) against
    the one-softmax twin and the JAX oracle, at the tolerances above."""
    (jq, jk, jv), (tq, tk, tv) = _sides(_qkv(6, B, Sq, Sk, H, D), dtype)
    got = tfa.flash_attention_split_plain(tq, tk, tv, causal=causal,
                                          keys_per_split=keys_per_split)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, tfa.flash_attention_plain(tq, tk, tv, causal=causal)
           .float().numpy(), TOL[dtype])
    _close(got, jref.attention_ref(jq, jk, jv, causal=causal), TOL[dtype])


@pytest.mark.parametrize("keys_per_split", [64, 192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_plain_matches_pallas(keys_per_split, dtype):
    """The key split against the Pallas kernel in interpret mode at the
    reference test's shapes."""
    (jq, jk, jv), (tq, tk, tv) = _sides(_qkv(7, 2, 256, 256, 4, 64), dtype)
    want = jfa.flash_attention(jq, jk, jv, causal=True, bq=128, bk=128,
                               interpret=True)
    got = tfa.flash_attention_split_plain(tq, tk, tv, causal=True,
                                          keys_per_split=keys_per_split)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("D", tfa.HEAD_DIMS)
def test_split_plan_gives_wgmma_only_its_head_dims(D):
    """The kernels take every head dim of ``HEAD_DIMS`` on the 16-row and
    float32 tiles, and the wgmma tiles only at ``WGMMA_HEAD_DIMS`` (the
    launcher refuses them at 16 and 256, where a 64 x 256 accumulator
    leaves no registers): at no length does the plan ask for wgmma
    outside them, and bf16 at head dim 256 takes the 16-row tiles."""
    for dtype in (torch.float32, torch.bfloat16):
        for Sq in (1, 24, tfa.FEW_QUERIES + 1, 2048):
            plan = tfa.split_plan(1, Sq, Sq, 8, D, dtype, 132)
            if plan.path == "wgmma":
                assert D in tfa.WGMMA_HEAD_DIMS
            if D == 256:
                assert plan.path == ("f32" if dtype == torch.float32
                                     else "few")


# ---- the backward (B5) ----------------------------------------------------
# B5's plain twin against jax.grad of the reference's oracle and against
# torch autograd of the forward twin, float32: the same f32 arithmetic in
# another order (the twin's explicit formulas against autograd's chain),
# so 2e-5, the forward's float32 tolerance.  The cases: causal, and no
# mask with fewer and more queries than keys, at head dims 16 and 64;
# and the MoE smoke configs' attention (4 heads of 16, causal), which
# trains through B5 at d 16 on the card.
BWD_CASES = [(2, 40, 40, 3, 16, True), (2, 130, 130, 2, 64, True),
             (2, 24, 70, 3, 64, False), (1, 70, 24, 2, 16, False),
             (2, 96, 96, 4, 16, True)]


def _bwd_inputs(B, Sq, Sk, H, D, seed=3):
    q, k, v = _qkv(seed, B, Sq, Sk, H, D)
    do = np.random.default_rng(seed + 1).standard_normal(
        (B, Sq, H, D)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("B,Sq,Sk,H,D,causal", BWD_CASES)
def test_bwd_twin_matches_jax_grad_of_oracle(B, Sq, Sk, H, D, causal):
    q, k, v, do = _bwd_inputs(B, Sq, Sk, H, D)

    def f(q, k, v):
        return jnp.sum(jref.attention_ref(q, k, v, causal=causal) * do)
    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o = tfa.flash_attention_plain(tq, tk, tv, causal=causal)
    got = tfa.flash_attention_bwd(tq, tk, tv, o, tdo, causal=causal)
    for g, w in zip(got, want):
        _close(g, w, TOL["float32"])


@pytest.mark.parametrize("B,Sq,Sk,H,D,causal", BWD_CASES)
def test_bwd_twin_matches_autograd_of_forward_twin(B, Sq, Sk, H, D, causal):
    arrays = _bwd_inputs(B, Sq, Sk, H, D, seed=5)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    do = torch.from_numpy(arrays[3])
    o = tfa.flash_attention_plain(tq, tk, tv, causal=causal)
    want = torch.autograd.grad(o, (tq, tk, tv), do)
    got = tfa.flash_attention_bwd_plain(tq.detach(), tk.detach(), tv.detach(),
                                        o.detach(), do, causal=causal)
    for g, w in zip(got, want):
        _close(g, w.numpy(), TOL["float32"])


@pytest.mark.parametrize("kind", ["none", "causal"])
def test_flash_attention_is_differentiable_through_the_bwd_twin(kind):
    """With a gradient to take, ``flash_attention`` runs its autograd
    Function: the values are the forward twin's, and q, k and v get the
    backward twin's gradients (float32, exact: the same functions)."""
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(2, 33, 33, 2,
                                                            64))
    causal = kind == "causal"
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = tfa.flash_attention(*leaves, causal=causal)
    o.backward(do)
    want_o = tfa.flash_attention_plain(q, k, v, causal=causal)
    assert torch.equal(o.detach(), want_o)
    want = tfa.flash_attention_bwd_plain(q, k, v, want_o, do, causal=causal)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad, w)


def test_sdpa_trains_through_flash_attention():
    """``layers.sdpa`` with the causal kind carries gradients to q, k, v
    as its plain masked form does (float32, 2e-5)."""
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(1, 20, 20, 2,
                                                            16))
    mask = layers.causal_mask(20, 20)
    grads = []
    for m in (layers.CAUSAL, mask):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        layers.sdpa(*leaves, m).backward(do)
        grads.append([t.grad for t in leaves])
    for g, w in zip(*grads):
        _close(g, w.numpy(), TOL["float32"])


def test_bwd_kernel_wrapper_never_falls_back():
    """B5's wrapper raises on what the kernel does not take (dtype, head
    dim, layout, mismatched o, a missing or misshapen saved lse) before
    any build; operands it takes go to
    the build (which needs nvcc), never to the twin; and a forward that
    needs a gradient on CUDA at another head dim raises before K5."""
    q = torch.zeros(1, 4, 2, 64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa._bwd_launch(*(q.half(),) * 5, False)
    with pytest.raises(TypeError, match="one dtype"):
        tfa._bwd_launch(q, q, q, q, q.bfloat16(), False)
    q112 = torch.zeros(1, 4, 2, 112)
    with pytest.raises(ValueError, match="head_dim"):
        tfa._bwd_launch(q112, q112, q112, q112, q112, False)
    with pytest.raises(ValueError, match="contiguous"):
        tfa._bwd_launch(q, q, q, q, q.transpose(1, 2).contiguous()
                        .transpose(1, 2), False)
    with pytest.raises(ValueError, match="shaped as q"):
        tfa._bwd_launch(q, q, q, q[:, :2].contiguous(), q, False)
    with pytest.raises(ValueError, match="head_dim"):
        tfa._check_bwd(q112)
    with pytest.raises(ValueError, match="log-sum-exp"):
        tfa._bwd_launch(q, q, q, q, q, False)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="lse must be"):
        tfa._bwd_launch(q, q, q, q, q, False, lse.transpose(1, 2))
    launches = tfa.flash_attention_bwd.launches
    try:
        build._nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc"):
            tfa._bwd_launch(q, q, q, q, q, False, lse)
    assert tfa.flash_attention_bwd.launches == launches



# ---- the forward's saved row log-sum-exp, and B5's bf16 roundings ---------
# The training forward saves each query row's log-sum-exp of its scaled,
# masked scores (float32), which B5 takes instead of recomputing it.  The
# twin's equals torch.logsumexp and the reference oracle's scores under
# jax.nn.logsumexp to 1e-6 (float32 scores of unit normals over up to 130
# keys: their sums differ by round-off only).
LSE_CASES = [(2, 40, 40, 3, 64, True), (2, 24, 70, 3, 64, False),
             (1, 70, 24, 2, 128, False), (1, 130, 130, 2, 128, True)]


def _masked_logits(q, k, causal):
    """The reference oracle's logits (its scale; -1e30 where masked)."""
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / np.sqrt(
        q.shape[-1]))
    if causal:
        keep = np.tril(np.ones((q.shape[1], k.shape[1]), bool))
        logits = jnp.where(keep, logits, -1e30)
    return logits


@pytest.mark.parametrize("B,Sq,Sk,H,D,causal", LSE_CASES)
def test_plain_lse_is_the_logsumexp_of_the_masked_scores(B, Sq, Sk, H, D,
                                                         causal):
    q, k, v = _qkv(8, B, Sq, Sk, H, D)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = tfa.flash_attention_plain(tq, tk, tv, causal=causal,
                                       return_lse=True)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    assert torch.equal(o, tfa.flash_attention_plain(tq, tk, tv,
                                                    causal=causal))
    s = torch.einsum("bqhd,bkhd->bhqk", tq, tk) / np.sqrt(D)
    if causal:
        s = s.masked_fill(~torch.ones(Sq, Sk, dtype=torch.bool).tril(),
                          float("-inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               rtol=1e-6, atol=1e-6)
    want = jax.nn.logsumexp(_masked_logits(q, k, causal), axis=-1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    o2, lse2 = tfa.flash_attention_with_lse(tq, tk, tv, causal=causal)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


def test_plain_lse_of_a_row_with_no_kept_key_is_inf():
    """A row that keeps no key gets +inf, as the kernels store it, so
    exp(s - lse) is 0 there in the backward and never NaN; the other rows
    their logsumexp."""
    s = torch.randn(1, 2, 3, 5)
    keep = torch.ones(3, 5, dtype=torch.bool)
    keep[1] = False
    lse = tfa._row_lse(s, keep)
    assert torch.isinf(lse[..., 1]).all() and (lse[..., 1] > 0).all()
    assert torch.equal(lse[..., 0], torch.logsumexp(s[..., 0, :], -1))
    p = torch.exp(s.masked_fill(~keep, float("-inf")) - lse[..., None])
    assert not p.isnan().any() and not p[..., 1, :].any()


@pytest.mark.parametrize("B,Sq,Sk,H,D,causal", LSE_CASES)
def test_bwd_twin_given_the_saved_lse_equals_the_twin_recomputing_it(
        B, Sq, Sk, H, D, causal):
    """The twin given the forward's lse against the twin that rebuilds it
    with logsumexp: float32 round-off (1e-6)."""
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(B, Sq, Sk, H, D,
                                                            seed=9))
    o, lse = tfa.flash_attention_plain(q, k, v, causal=causal,
                                       return_lse=True)
    got = tfa.flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                        lse=lse)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, do, causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6)


def _bwd_numpy(q, k, v, o, do, causal, rounded: bool, out_bf16=True):
    """B5's formulas in numpy float32 from the (bf16-valued) inputs; with
    ``rounded``, p rounded to bf16 before p^T do and ds (from the
    unrounded p) before ds k and ds^T q; with ``out_bf16`` each gradient
    rounded to bf16."""
    bf = jnp.bfloat16

    def rnd(x):
        return np.asarray(np.asarray(x, bf), np.float32) if rounded else x
    scale = np.float32(1.0 / np.sqrt(q.shape[-1]))
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s = np.where(np.tril(np.ones(s.shape[-2:], bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    lse = m + np.log(np.exp(s - m).sum(-1, keepdims=True))
    p = np.exp(s - lse).astype(np.float32)
    dv = np.einsum("bhqk,bqhd->bkhd", rnd(p), do)
    dp = np.einsum("bqhd,bkhd->bhqk", do, v)
    delta = (do * o).sum(-1).transpose(0, 2, 1)[..., None]
    ds = rnd((p * (dp - delta)).astype(np.float32))
    dq = np.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = np.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    if not out_bf16:
        return [dq, dk, dv]
    return [np.asarray(np.asarray(g, bf), np.float32) for g in (dq, dk, dv)]


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_twin_rounds_p_and_ds_to_bf16_where_b5_does(causal):
    """For bfloat16 inputs the twin rounds p and ds to bf16 at B5's points
    (the operands of its tensor-core products): against the numpy
    formulas that round there, all but a few of its bf16 gradients are
    bitwise equal and none is more than one bf16 spacing off (the two sum
    in other orders), while the unrounded formulas differ in many more.
    For float32 inputs nothing is rounded: the twin is the unrounded
    formulas (1e-5)."""
    B, S, H, D = 2, 48, 2, 64
    arrays = [np.asarray(np.asarray(a, jnp.bfloat16), np.float32)
              for a in _bwd_inputs(B, S, S, H, D, seed=13)]
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in arrays)
    to = tfa.flash_attention_plain(tq, tk, tv, causal=causal)
    o = to.float().numpy()
    got = [g.float().numpy() for g in tfa.flash_attention_bwd_plain(
        tq, tk, tv, to, tdo, causal=causal)]
    want = _bwd_numpy(*arrays[:3], o, arrays[3], causal, rounded=True)
    plain = _bwd_numpy(*arrays[:3], o, arrays[3], causal, rounded=False)
    off = far = 0
    for g, w, u in zip(got, want, plain):
        np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=1e-6)
        off += int((g != w).sum())
        far += int((g != u).sum())
    n = sum(g.size for g in got)
    assert off <= n // 200 and far >= 10 * max(off, 1), (off, far, n)
    f32 = [torch.from_numpy(a) for a in arrays]
    o32 = tfa.flash_attention_plain(*f32[:3], causal=causal)
    got32 = tfa.flash_attention_bwd_plain(*f32[:3], o32, f32[3],
                                          causal=causal)
    want32 = _bwd_numpy(*arrays[:3], o32.numpy(), arrays[3], causal,
                        rounded=False, out_bf16=False)
    for g, w in zip(got32, want32):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,Sq,Sk,H,D,causal", BWD_CASES)
def test_autograd_saves_the_lse_and_matches_jax_grad(B, Sq, Sk, H, D,
                                                     causal):
    """``flash_attention`` under autograd saves (q, k, v, o, lse), the lse
    the forward twin's, and its gradients match ``jax.grad`` of the
    reference's oracle in float32 (2e-5)."""
    q, k, v, do = _bwd_inputs(B, Sq, Sk, H, D, seed=21)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = tfa.flash_attention(*leaves, causal=causal)
    saved = o.grad_fn.saved_tensors
    assert len(saved) == 5
    want_lse = tfa.flash_attention_plain(*(t.detach() for t in leaves),
                                         causal=causal, return_lse=True)[1]
    assert torch.equal(saved[4], want_lse)
    o.backward(torch.from_numpy(do))

    def f(q, k, v):
        return jnp.sum(jref.attention_ref(q, k, v, causal=causal) * do)
    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    for t, w in zip(leaves, want):
        _close(t.grad, w, TOL["float32"])
