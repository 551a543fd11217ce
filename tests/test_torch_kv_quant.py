"""fp8 KV-cache storage in the port (``cfg.kv_dtype="float8_e4m3fn"``),
against the JAX package's: the reference's own checks
(``tests/test_kv_quant.py``: decode stays close to the bf16-cache decode,
and the cache is half the bytes) on the port, the port's fp8 dense decode
against JAX's on the same converted weights, K1's plain twin on fp8
pages against the reference's ``decode_attend`` in interpret mode on the
same pages, and K1's wrapper, which takes fp8 pages to the kernel and
refuses every other page dtype but q's.

Tolerances: the reference's criterion as it stands (top-1 kept unless
near a tie, ``allclose`` at 0.35 / 0.35).  Port against JAX in float32
with fp8 K/V: both round the same f32 K/V to e4m3 (round to nearest
even) and compute in f32, but their f32 K/V differ in the last bits, so
an element next to an e4m3 rounding midpoint may land one e4m3 step (up
to 2**-3 relative) apart; the logits are held to 2e-2.  K1's twin against
the reference kernel on the same fp8 pages: both widen the pages exactly
and run f32 arithmetic, float32 q 1e-5, bfloat16 q one bf16 step of the
output (2e-2, as ``test_torch_paged_attention.py``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels.paged_attention import paged_attention as jpa  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention as tpa  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

torch.set_num_threads(1)

ARCHS = ["qwen1_5_0_5b", "deepseek_coder_33b"]
FP8 = "float8_e4m3fn"
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _params(cfg, jcfg):
    """The JAX init of ``jcfg`` and its conversion for the port."""
    jp = jax.jit(lambda k: jlm.init(jcfg, k).params)(jax.random.key(0))
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                         "cpu")


def _port_decode(params, cfg, tokens):
    """Prefill 4 tokens into a dense cache of 16, decode the next 4; the
    last step's logits and the cache."""
    _, cache = tlm.prefill(params, cfg, torch.from_numpy(tokens[:, :4]),
                           max_seq=16)
    assert cache.cache.k.dtype == cfg.kvdtype
    for t in range(4, 8):
        lg, cache = tlm.decode_step(params, cfg,
                                    torch.from_numpy(tokens[:, t:t + 1]),
                                    cache)
    return np.asarray(lg[0, 0].float().numpy(), np.float32)


def _tokens(vocab):
    return np.random.default_rng(1).integers(0, vocab, (1, 8)) \
        .astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_fp8_kv_cache_decode_close_to_bf16(arch):
    """The reference's check on the port: the same weights decode with a
    bf16 and an fp8 cache; fp8 perturbs the logits slightly, and the top
    token survives whenever more than the quantization noise decides
    it."""
    cfg = tconfigs.get_smoke(arch)
    cfg8 = dataclasses.replace(cfg, kv_dtype=FP8)
    _, params = _params(cfg, jconfigs.get_smoke(arch))
    tokens = _tokens(cfg.vocab)
    a = _port_decode(params, cfg, tokens)
    b = _port_decode(params, cfg8, tokens)
    margin = np.sort(a)[-1] - np.sort(a)[-2]
    if margin > 2 * np.abs(a - b).max():
        assert np.argmax(a) == np.argmax(b)
    else:
        assert np.argmax(b) in np.argsort(a)[-2:]
    np.testing.assert_allclose(a, b, rtol=0.35, atol=0.35)


@pytest.mark.parametrize("arch", ARCHS)
def test_fp8_kv_decode_matches_jax(arch):
    """The port's fp8-cache dense decode against JAX's on the same
    converted weights and tokens, in float32 with fp8 K/V."""
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), kv_dtype=FP8, **F32)
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), kv_dtype=FP8,
                               **F32)
    jp, params = _params(cfg, jcfg)
    tokens = _tokens(cfg.vocab)
    got = _port_decode(params, cfg, tokens)
    _, cache = jlm.prefill(jp, jcfg, jnp.asarray(tokens[:, :4]), max_seq=16)
    assert cache.cache.k.dtype == jcfg.kvdtype
    for t in range(4, 8):
        lg, cache = jlm.decode_step(jp, jcfg, jnp.asarray(tokens[:, t:t + 1]),
                                    cache)
    np.testing.assert_allclose(got, np.asarray(lg[0, 0], np.float32),
                               rtol=2e-2, atol=2e-2)


def test_fp8_cache_is_half_the_bytes():
    cfg = tconfigs.get_smoke("qwen1_5_0_5b")
    cfg8 = dataclasses.replace(cfg, kv_dtype=FP8)
    c16 = tlm.init_cache(cfg, batch=2, max_seq=32, device="cpu")
    c8 = tlm.init_cache(cfg8, batch=2, max_seq=32, device="cpu")
    k8, k16 = c8.cache.k, c16.cache.k
    assert k8.dtype == torch.float8_e4m3fn
    assert k8.numel() * k8.element_size() * 2 \
        == k16.numel() * k16.element_size()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attend_plain_fp8_pages_match_jax(dtype):
    """K1's plain twin (``decode_attend`` on CPU tensors) reads fp8 pages
    as the Pallas kernel does: the same e4m3 bytes on both sides, GQA, a
    layered pool, ragged lengths with an empty lane."""
    rng = np.random.default_rng(7)
    B, H, Hkv, D, page, npages, L, P = 4, 8, 2, 64, 16, 4, 2, 20
    q = rng.standard_normal((B, H, D), np.float32)
    kn = rng.standard_normal((B, Hkv, D), np.float32)
    vn = rng.standard_normal((B, Hkv, D), np.float32)
    kp = rng.standard_normal((L, P, page, Hkv, D), np.float32)
    vp = rng.standard_normal((L, P, page, Hkv, D), np.float32)
    pt = rng.permutation(P)[:B * npages].reshape(B, npages).astype(np.int32)
    ln = np.asarray([0, 5, 33, page * npages], np.int32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)
    jkp, jvp = (jnp.asarray(a).astype(jnp.float8_e4m3fn) for a in (kp, vp))
    tkp, tvp = (torch.from_numpy(np.array(a).view(np.uint8))
                .view(torch.float8_e4m3fn) for a in (jkp, jvp))
    want = jpa.decode_attend(jnp.asarray(q).astype(jd),
                             jnp.asarray(kn).astype(jd),
                             jnp.asarray(vn).astype(jd), jkp, jvp,
                             jnp.asarray(pt), jnp.asarray(ln), layer=1,
                             interpret=True)
    got = tpa.decode_attend(torch.from_numpy(q).to(td),
                            torch.from_numpy(kn).to(td),
                            torch.from_numpy(vn).to(td), tkp, tvp,
                            torch.from_numpy(pt), torch.from_numpy(ln),
                            layer=1)
    assert got.dtype == td
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol if dtype == "float32" else 0.0)


@pytest.mark.parametrize("pages", ["float16", "float8_e5m2", "bfloat16",
                                   "mixed"])
def test_kernel_wrapper_refuses_other_page_dtypes(pages):
    """K1's wrapper takes pages of q's dtype or float8_e4m3fn, K and V of
    one dtype; any other raises before a build or launch."""
    q = torch.zeros(2, 4, 64)                       # float32 q
    if pages == "mixed":
        kp = torch.zeros(1, 3, 16, 2, 64, dtype=torch.float8_e4m3fn)
        vp = torch.zeros(1, 3, 16, 2, 64)
    else:
        kp = vp = torch.zeros(1, 3, 16, 2, 64, dtype=getattr(torch, pages))
    pt = torch.zeros(2, 1, dtype=torch.int32)
    ln = torch.ones(2, dtype=torch.int32)
    launches = tpa.paged_attention.launches
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        tpa._launch(q, kp, vp, pt, ln, 0, 0)
    assert tpa.paged_attention.launches == launches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_wrapper_takes_fp8_pages_to_the_kernel(dtype):
    """fp8 pages with float32 or bfloat16 q pass the wrapper's checks and
    go to the kernel's build (which needs nvcc), never to the plain
    twin."""
    from repro_torch.kernels import build
    q = torch.zeros(2, 4, 64, dtype=getattr(torch, dtype))
    kp = torch.zeros(1, 3, 16, 2, 64, dtype=torch.float8_e4m3fn)
    pt = torch.zeros(2, 1, dtype=torch.int32)
    ln = torch.ones(2, dtype=torch.int32)
    launches = tpa.paged_attention.launches
    try:
        build._nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc"):
            tpa._launch(q, kp, kp, pt, ln, 0, 0)
    assert tpa.paged_attention.launches == launches


def test_fp8_paged_decode_matches_dense():
    """The paged backend with an fp8 pool decodes as the dense backend with
    an fp8 cache (float32 compute): its dirty blocks reach the device
    mirror every step (``index_copy_`` has no float8 kernel, so the
    backend copies them as bytes).  Both read the same e4m3 values and
    compute in f32, summed in another order: 1e-4."""
    cfg = dataclasses.replace(tconfigs.get_smoke("qwen1_5_0_5b"),
                              kv_dtype=FP8, **F32)
    _, params = _params(cfg, dataclasses.replace(
        jconfigs.get_smoke("qwen1_5_0_5b"), kv_dtype=FP8, **F32))
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 8)) \
        .astype(np.int32)
    paged = tlm.init_cache(cfg, 2, 16, kind="paged", device="cpu")
    assert paged.pool.k_pages.dtype == torch.float8_e4m3fn
    _, paged = tlm.prefill(params, cfg, tokens[:, :4], backend=paged)
    _, dense = tlm.prefill(params, cfg, torch.from_numpy(tokens[:, :4]),
                           max_seq=16)
    for t in range(4, 8):
        lp, paged = tlm.decode_step(params, cfg, tokens[:, t:t + 1], paged)
        ld, dense = tlm.decode_step(params, cfg,
                                    torch.from_numpy(tokens[:, t:t + 1]),
                                    dense)
        np.testing.assert_allclose(lp.float().numpy(), ld.float().numpy(),
                                   rtol=1e-4, atol=1e-4)
