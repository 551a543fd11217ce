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
