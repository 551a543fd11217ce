"""The VLM family (paligemma-3b) in the port, against the JAX package's:
the prefix-LM mask, ``forward`` with an image prefix of stub patch
embeddings (bidirectional over the prefix, positions and RoPE over
prefix and tokens, logits of the token positions), and the serving path,
which runs the text-only decoder as the reference's does (its parity
with JAX is in ``test_torch_lm.py``, ``test_torch_kvcache.py``,
``test_torch_step.py`` and ``test_torch_serve.py``, with the other
dense-only families).  Where the reference drops a prefill's
``frontend_emb`` unread, the port refuses it (ROADMAP.md §3).

Inputs come from numpy with a seed and feed both sides; weights are the
JAX init converted through ``repro_torch.convert``.  Tolerance
``atol=rtol=1e-4`` at float32, as ``test_torch_lm.py``; the masks are
compared bitwise."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kvcache.backend import make_backend  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
F32 = dict(param_dtype="float32", compute_dtype="float32")
_MODEL: dict = {}


def _model():
    """(jax cfg, port cfg, jax params, port params): the paligemma-3b
    smoke config at float32 (8 image patches, one KV head)."""
    if not _MODEL:
        jc = dataclasses.replace(jconfigs.get_smoke("paligemma_3b"), **F32)
        tc = dataclasses.replace(tconfigs.get_smoke("paligemma_3b"), **F32)
        jp = jax.jit(lambda k: jlm.init(jc, k).params)(jax.random.key(0))
        tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                       "cpu")
        _MODEL.update(v=(jc, tc, jp, tp))
    return _MODEL["v"]


def _inputs(cfg, B, S, P, seed=0):
    """(B, S) tokens and a (B, P, d) image prefix, normal * 0.02."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    fe = (0.02 * rng.standard_normal((B, P, cfg.d_model))).astype(np.float32)
    return toks, fe


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("sq,sk,window,prefix_len", [
    (6, 6, 0, None), (6, 6, 0, 3), (6, 6, 0, 0), (6, 6, 0, 6),
    (9, 9, 2, 4), (4, 9, 0, 2), (4, 9, 3, 5), (1, 7, 0, 3)])
def test_causal_mask_matches_reference(sq, sk, window, prefix_len):
    """``causal_mask(prefix_len=)``: the first ``prefix_len`` keys are
    visible to every query, beside the causal and window terms, bit for
    bit as the reference's."""
    got = tlayers.causal_mask(sq, sk, window=window, prefix_len=prefix_len)
    want = np.asarray(jlayers.causal_mask(sq, sk, window=window,
                                          prefix_len=prefix_len))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("P", [3, 0])
def test_forward_with_image_prefix_matches_jax(P):
    """``forward`` with a (B, P, d) image prefix shorter than the config's
    ``frontend_seq`` against ``jlm.forward`` (``test_torch_lm.py`` holds
    the full one): logits of the token positions only; P = 0 (an empty
    prefix) is legal and gives the text-only model."""
    jc, tc, jp, tp = _model()
    toks, fe = _inputs(tc, 2, 12, P)
    got = tlm.forward(tp, tc, torch.from_numpy(toks), torch.from_numpy(fe))
    want, _ = jlm.forward(jp, jc, jnp.asarray(toks), jnp.asarray(fe))
    assert got.shape == (2, 12, tc.vocab) and got.dtype == torch.float32
    _close(got, want)


def test_empty_prefix_is_the_served_decoder():
    """With an empty prefix, ``forward``'s logits at the last position are
    the text-only prefill's (what the serving path computes), and its
    attention takes the mask kind ``CAUSAL`` (K5 on the card)."""
    _, tc, _, tp = _model()
    toks, fe = _inputs(tc, 2, 9, 0, seed=1)
    full = tlm.forward(tp, tc, torch.from_numpy(toks), torch.from_numpy(fe))
    last, _ = tlm.prefill_parts(tp, tc, torch.from_numpy(toks))
    _close(full[:, -1:], last.numpy())
    assert tlm._masks(tc, 9, "cpu", 0) == (tlayers.CAUSAL, tlayers.CAUSAL)
    m, g = tlm._masks(tc, 9, "cpu", 4)
    assert torch.equal(m, g) and bool(m[0, 3]) and not bool(m[4, 5])


def test_image_prefix_attends_bidirectionally():
    """Port of the reference's property test: perturbing the last image
    patch moves the logits of the first text position, which a causal
    mask over the prefix would hide from it."""
    _, tc, _, tp = _model()
    toks, fe = _inputs(tc, 1, 8, tc.frontend_seq, seed=2)
    fe2 = fe.copy()
    fe2[:, -1] += 1.0
    l1 = tlm.forward(tp, tc, torch.from_numpy(toks), torch.from_numpy(fe))
    l2 = tlm.forward(tp, tc, torch.from_numpy(toks), torch.from_numpy(fe2))
    assert not torch.allclose(l1[:, 0], l2[:, 0])


def test_forward_needs_its_frontend():
    _, tc, _, tp = _model()
    toks, _ = _inputs(tc, 1, 4, 0)
    with pytest.raises(ValueError, match="frontend_emb"):
        tlm.forward(tp, tc, torch.from_numpy(toks))


def test_prefill_refuses_a_frontend():
    """The serving path runs the text-only decoder; the reference drops a
    prefill's ``frontend_emb`` unread, the port refuses it (ROADMAP.md
    §3) at every prefill entry point."""
    _, tc, _, tp = _model()
    toks, fe = _inputs(tc, 2, 6, tc.frontend_seq)
    toks, fe = torch.from_numpy(toks), torch.from_numpy(fe)
    calls = [lambda: tlm.prefill_parts(tp, tc, toks, fe),
             lambda: tlm.dense_prefill(tp, tc, toks, 12, fe),
             lambda: tlm.prefill(tp, tc, toks, max_seq=12, frontend_emb=fe),
             lambda: make_backend(tc, "dense", batch=2, max_seq=12,
                                  device="cpu").prefill(tp, toks, fe)]
    for call in calls:
        with pytest.raises(ValueError, match="ROADMAP"):
            call()
