"""Port parity for the dense LM: ``forward``, ``prefill_parts``,
``dense_decode_step`` and ``paged_decode_step`` of the port against the
JAX package's, at float32 with the same weights (the JAX init converted
through ``repro_torch.convert``) and the same numpy tokens.

Configs: the qwen1.5-0.5b smoke config (MHA, QKV bias, tied embeddings),
a GQA variant of it (``n_kv_heads=2``), and the hymba-1.5b smoke config
(hybrid: parallel attention and Mamba2 heads, a sliding window of 16
with global layers, SSM chunk 8 — prompts are multiples of 8 there, and
its SSM state and conv context are compared too), and the MoE smoke
configs of arctic-480b (128 -> 8 experts top-2 with a parallel dense
residual MLP) and kimi-k2 (a leading dense block stack, ``blocks_dense``,
then routed layers with a shared expert), whose expert products run the
grouped-matmul kernel's plain twin on the CPU, and the smoke configs of
the dense GQA models starcoder2-7b (LayerNorm, non-gated GELU, QKV
bias), phi3-medium-14b and deepseek-coder-33b.  The whisper-base smoke
config (encoder-decoder: an encoder stack over stub frame embeddings,
cross-attention in every decoder layer, learned positions) and the
mamba2-370m smoke config (pure SSM, no attention, no K/V) serve through
the dense path only, as does the paligemma-3b smoke config (VLM: one KV
head, d_head 16, gated GELU, tied embeddings), whose forward prepends an
image prefix of ``frontend_seq`` stub patches and whose prefill and
decode serve the text-only decoder: their forward (with the same
frontend), prefill parts (cross-attention K/V included) and prefill plus
four dense decode steps are compared, and the paged decode refuses them.
Tolerance ``atol=rtol=1e-4``: the same float32 arithmetic, with matrix
products summed in another order by another library."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
F32 = dict(param_dtype="float32", compute_dtype="float32")
VARIANTS = {"qwen_smoke": ("qwen1_5_0_5b", {}),
            "qwen_smoke_gqa": ("qwen1_5_0_5b", {"n_kv_heads": 2}),
            "hymba_smoke": ("hymba_1_5b", {}),
            "arctic_smoke": ("arctic_480b", {}),
            "kimi_smoke": ("kimi_k2_1t_a32b", {}),
            "starcoder2_smoke": ("starcoder2_7b", {}),
            "phi3_smoke": ("phi3_medium_14b", {}),
            "deepseek_smoke": ("deepseek_coder_33b", {})}
# families the paged path refuses: they serve through the dense backend
DENSE_ONLY = {"whisper_smoke": ("whisper_base", {}),
              "mamba2_smoke": ("mamba2_370m", {}),
              "paligemma_smoke": ("paligemma_3b", {})}
ALL_VARIANTS = {**VARIANTS, **DENSE_ONLY}


def _cfgs(variant: str, **extra):
    arch, kw = ALL_VARIANTS[variant]
    kw = dict(kw, **extra)
    jc = dataclasses.replace(jconfigs.get_smoke(arch), **kw)
    tc = dataclasses.replace(tconfigs.get_smoke(arch), **kw)
    return jc, tc


def _seq(cfg, n: int) -> int:
    """A prompt length near ``n`` that the model takes: a hybrid model's
    SSM scan needs a multiple of its chunk."""
    if cfg.has_ssm:
        return -(-n // cfg.ssm_chunk) * cfg.ssm_chunk
    return n


_PARAMS: dict = {}


def _params(variant: str):
    """(jax params, port params) for one f32 variant, from one JAX init
    (cached per module: the init is the slow part)."""
    if variant not in _PARAMS:
        jc, tc = _cfgs(variant, **F32)
        jp = _jax_init(jc, 0)
        # non-zero QKV biases, SSM biases and skips so those paths are
        # exercised
        rng = np.random.default_rng(1)
        blocks = dict(jp["blocks"])
        for sub, names in (("attn", ("bq", "bk", "bv")),
                           ("ssm", ("conv_b", "conv_b_bc", "dt_bias",
                                    "d_skip"))):
            if sub in blocks:
                leaves = dict(blocks[sub])
                for b in names:
                    if b in leaves:
                        leaves[b] = jnp.asarray(0.1 * rng.standard_normal(
                            leaves[b].shape) + (b == "d_skip"), jnp.float32)
                blocks[sub] = leaves
        jp = dict(jp, blocks=blocks)
        tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                       "cpu")
        _PARAMS[variant] = (jc, tc, jp, tp)
    return _PARAMS[variant]


def _jax_init(cfg, seed: int):
    """The JAX init, jitted (eager init dispatches op by op and dominates
    this file's time); both sides get the same resulting tree."""
    return jax.jit(lambda k: jlm.init(cfg, k).params)(jax.random.key(seed))


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def _frontend(cfg, B, seed=10, forward=False):
    """The reference tests' stub embeddings (normal * 0.02) as numpy: an
    encoder-decoder model's frames and, for ``forward``, a VLM's image
    prefix of ``frontend_seq`` patches (its prefill and decode serve the
    text-only decoder and take none); None otherwise."""
    if cfg.family != "encdec" and not (forward and cfg.family == "vlm"):
        return None
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_seq, cfg.d_model))).astype(np.float32)


def _fe(fe, to):
    return None if fe is None else to(fe)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("variant", list(ALL_VARIANTS))
def test_forward_matches_jax(variant):
    jc, tc, jp, tp = _params(variant)
    S = _seq(tc, 12)
    toks = _tokens(tc, 2, S)
    fe = _frontend(tc, 2, forward=True)
    got = tlm.forward(tp, tc, torch.from_numpy(toks),
                      _fe(fe, torch.from_numpy))
    want, _ = jlm.forward(jp, jc, jnp.asarray(toks), _fe(fe, jnp.asarray))
    assert got.shape == (2, S, tc.vocab) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("variant", list(ALL_VARIANTS))
def test_prefill_parts_matches_jax(variant):
    jc, tc, jp, tp = _params(variant)
    toks = _tokens(tc, 2, _seq(tc, 9), seed=1)
    fe = _frontend(tc, 2)
    logits, parts = tlm.prefill_parts(tp, tc, torch.from_numpy(toks),
                                      _fe(fe, torch.from_numpy))
    jlogits, jparts = jlm.prefill_parts(jp, jc, jnp.asarray(toks),
                                        _fe(fe, jnp.asarray))
    _close(logits, jlogits)
    for name, jpart in jparts.items():
        if jpart is None:
            assert parts[name] is None, name
        else:
            assert tuple(parts[name].shape) == jpart.shape, name
            _close(parts[name], jpart)
    assert (parts["ssm"] is None) == (not tc.has_ssm)
    assert (parts["k"] is None) == (not tc.has_attention)
    assert (parts["xk"] is None) == (tc.family != "encdec")


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("variant", list(ALL_VARIANTS))
def test_dense_decode_step_matches_jax(variant, ragged):
    """Prefill into a dense cache, then decode two tokens (four for the
    dense-only families); ``ragged`` gives each lane its own cache length
    (the paged gather path; whisper reads its learned positions there)."""
    jc, tc, jp, tp = _params(variant)
    S = _seq(tc, 9)
    Smax = S + 7
    toks = _tokens(tc, 2, S, seed=2)
    fe = _frontend(tc, 2)
    jlog, jcache = jlm.dense_prefill(jp, jc, jnp.asarray(toks), Smax,
                                     _fe(fe, jnp.asarray))
    tlog, tcache = tlm.dense_prefill(tp, tc, torch.from_numpy(toks), Smax,
                                     _fe(fe, torch.from_numpy))
    _close(tlog, jlog)
    if ragged:
        lens = np.asarray([5, S], np.int32)
        jcache = dataclasses.replace(jcache, length=jnp.asarray(lens))
        tcache = dataclasses.replace(tcache, length=torch.from_numpy(lens))
    steps = 4 if variant in DENSE_ONLY else 2
    nxt = _tokens(tc, 2, steps, seed=3)
    for i in range(steps):
        jlog, jcache = jlm.dense_decode_step(jp, jc,
                                             jnp.asarray(nxt[:, i:i + 1]),
                                             jcache)
        tlog, tcache = tlm.dense_decode_step(
            tp, tc, torch.from_numpy(nxt[:, i:i + 1]), tcache)
        _close(tlog, jlog)
        if tc.has_attention:
            _close(tcache.k, jcache.k)
            _close(tcache.v, jcache.v)
        else:
            assert tcache.k is None and tcache.v is None
        if tc.has_ssm:
            _close(tcache.ssm, jcache.ssm)
            _close(tcache.conv, jcache.conv)
        if tc.family == "encdec":
            _close(tcache.xk, jcache.xk)
            _close(tcache.xv, jcache.xv)
        np.testing.assert_array_equal(tcache.length.numpy(),
                                      np.asarray(jcache.length))


def _paged_operands(k, v, lengths, page, n_pages, seed):
    """Scatter dense (L, B, S, K, dh) prompt K/V into a layered pool of
    shuffled blocks; returns (k_pages, v_pages, page_tables)."""
    L, B, S, K, dh = k.shape
    P = B * n_pages + 3
    rng = np.random.default_rng(seed)
    pt = rng.permutation(P)[:B * n_pages].reshape(B, n_pages)
    kp = rng.standard_normal((L, P, page, K, dh)).astype(np.float32)
    vp = rng.standard_normal((L, P, page, K, dh)).astype(np.float32)
    for b in range(B):
        for t in range(int(lengths[b])):
            kp[:, pt[b, t // page], t % page] = k[:, b, t]
            vp[:, pt[b, t // page], t % page] = v[:, b, t]
    return kp, vp, pt.astype(np.int32)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_paged_decode_step_matches_jax(variant):
    """Kernel-path decode over a ragged layered pool (lane lengths 5 and
    9, pages of 4; padding blocks hold noise that must stay masked)
    against the JAX kernel path in interpret mode and against the port's
    dense decode of the same caches.  A hybrid model takes its prompt's
    SSM state and conv context as side state and advances them."""
    jc, tc, jp, tp = _params(variant)
    toks = _tokens(tc, 2, _seq(tc, 9), seed=4)
    _, parts = jlm.prefill_parts(jp, jc, jnp.asarray(toks))
    k, v = (np.asarray(parts[n], np.float32) for n in ("k", "v"))
    side = {}
    if tc.has_ssm:
        side = {n: np.array(parts[n], np.float32) for n in ("ssm", "conv")}
    lengths = np.asarray([5, 9], np.int32)
    kp, vp, pt = _paged_operands(k, v, lengths, page=4, n_pages=4, seed=5)
    nxt = _tokens(tc, 2, 1, seed=6)
    jlog, jk, jv, jssm, jconv = jlm.paged_decode_step(
        jp, jc, jnp.asarray(nxt), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(pt), jnp.asarray(lengths),
        ssm_state=jnp.asarray(side["ssm"]) if side else None,
        conv_state=jnp.asarray(side["conv"]) if side else None,
        interpret=True)
    tlog, tk, tv, tssm, tconv = tlm.paged_decode_step(
        tp, tc, torch.from_numpy(nxt), torch.from_numpy(kp),
        torch.from_numpy(vp), torch.from_numpy(pt),
        torch.from_numpy(lengths),
        ssm_state=torch.from_numpy(side["ssm"]) if side else None,
        conv_state=torch.from_numpy(side["conv"]) if side else None)
    assert tuple(tk.shape) == jk.shape == (tc.n_layers, 2, 1,
                                           tc.n_kv_heads, tc.d_head)
    _close(tlog, jlog)
    _close(tk, jk)
    _close(tv, jv)
    if side:
        _close(tssm, jssm)
        _close(tconv, jconv)
    else:
        assert tssm is None and tconv is None
    # the same step through the dense path of the port (one free slot
    # past the longest lane for the in-flight token)
    pad = ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0))
    cache = tlm.Cache(torch.from_numpy(np.pad(k, pad)),
                      torch.from_numpy(np.pad(v, pad)),
                      torch.from_numpy(lengths),
                      *(torch.from_numpy(side[n]) for n in side))
    dlog, dcache = tlm.dense_decode_step(tp, tc, torch.from_numpy(nxt),
                                         cache)
    _close(tlog, dlog.numpy())
    if side:
        _close(tssm, dcache.ssm.numpy())
        _close(tconv, dcache.conv.numpy())


@pytest.mark.parametrize("variant", list(DENSE_ONLY))
def test_paged_decode_refuses_dense_only_families(variant):
    """As the reference, the paged path pages attention KV only: a pure
    SSM or encoder-decoder model serves through the dense backend."""
    _, tc = _cfgs(variant, **F32)
    z = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="dense backend"):
        tlm.paged_decode_step(None, tc, z, None, None, None, z[0])


def test_encdec_needs_its_frontend():
    jc, tc, jp, tp = _params("whisper_smoke")
    with pytest.raises(ValueError, match="frontend_emb"):
        tlm.forward(tp, tc, torch.from_numpy(_tokens(tc, 1, 4)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(ALL_VARIANTS))
def test_converter_and_init_match_jax_tree(variant, dtype):
    """``params_from_numpy`` keeps every leaf's key, shape, dtype and
    bits (bf16 through the uint16 view); the port's own ``lm.init`` gives
    the same keys, shapes and dtypes as the JAX init."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    jc, tc = _cfgs(variant, **kw)
    jtree = jax.tree.map(np.asarray, _jax_init(jc, 3))
    ttree = convert.params_from_numpy(jtree, tc, "cpu")
    tinit = tlm.init(tc, torch.Generator("cpu").manual_seed(3))
    jflat = {jax.tree_util.keystr(p): a for p, a in
             jax.tree_util.tree_flatten_with_path(jtree)[0]}

    def flat(mod):
        return {"".join(f"['{k}']" for k in n.split(".")): t
                for n, t in mod.named_parameters()}
    for tree in (ttree, tinit):
        got = flat(tree)
        assert sorted(got) == sorted(jflat)
        for key, a in jflat.items():
            t = got[key]
            assert tuple(t.shape) == a.shape, key
            # SSM a_log / dt_bias / d_skip and the MoE router stay
            # float32 in any dtype
            want = "float32" if key.split("']")[-2].endswith(
                ("a_log", "dt_bias", "d_skip", "router")) else dtype
            assert a.dtype.name == want, key
            assert t.dtype == getattr(torch, want), key
    for key, a in jflat.items():
        t = flat(ttree)[key].detach()
        if dtype == "bfloat16":
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16),
                a.view(np.uint16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)


def test_init_distributions():
    """The port's init draws what the reference's ``_dense_init`` draws:
    N(0, 1/fan_in) for projections, N(0, 0.02^2) for the embedding,
    ones for norm scales, zeros for QKV biases."""
    cfg = tconfigs.get_smoke("qwen1_5_0_5b")
    p = tlm.init(cfg, torch.Generator("cpu").manual_seed(0))
    d, H, dh = cfg.d_model, cfg.n_heads, cfg.d_head
    for leaf, scale in ((p["blocks"]["attn"]["wq"], d ** -0.5),
                        (p["blocks"]["attn"]["wo"], (H * dh) ** -0.5),
                        (p["blocks"]["mlp"]["wo"], cfg.d_ff ** -0.5),
                        (p["embed"]["tok"], 0.02)):
        x = leaf.detach().float()
        assert abs(float(x.std()) / scale - 1) < 0.1
        assert abs(float(x.mean())) < 0.1 * scale
    assert (p["blocks"]["ln1"]["scale"] == 1).all()
    assert (p["blocks"]["attn"]["bq"] == 0).all()
    assert "head" not in p["embed"]          # tied embeddings
