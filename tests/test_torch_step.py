"""Port parity for the serving steps: ``serve.step.greedy_generate`` of the
port against the JAX package's on the qwen1.5-0.5b, whisper-base (with the
same stub frame embeddings), mamba2-370m and paligemma-3b (its text-only
decoder) smoke configs at float32, with the same weights (the JAX init
converted through ``repro_torch.convert``) and the same numpy prompts: the
generated tokens must be identical.  Also ``make_prefill`` and
``make_decode_step`` over the dense ``Cache``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.serve import step as tstep  # noqa: E402

torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32")
ARCHS = ["qwen1_5_0_5b", "whisper_base", "mamba2_370m", "paligemma_3b"]
_MODELS: dict = {}


def _model(arch: str):
    if arch not in _MODELS:
        jc = dataclasses.replace(jconfigs.get_smoke(arch), **F32)
        tc = dataclasses.replace(tconfigs.get_smoke(arch), **F32)
        jp = jax.jit(lambda k: jlm.init(jc, k).params)(jax.random.key(0))
        tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                       "cpu")
        _MODELS[arch] = (jc, tc, jp, tp)
    return _MODELS[arch]


def _inputs(cfg, B=3, S=16, seed=0):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)
    fe = None
    if cfg.family == "encdec":
        fe = (0.02 * rng.standard_normal(
            (B, cfg.frontend_seq, cfg.d_model))).astype(np.float32)
    return prompt, fe


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_jax(arch):
    jc, tc, jp, tp = _model(arch)
    prompt, fe = _inputs(tc)
    n, max_seq = 6, prompt.shape[1] + 6
    want = jstep.greedy_generate(jp, jc, jnp.asarray(prompt), n,
                                 max_seq=max_seq,
                                 frontend=None if fe is None
                                 else jnp.asarray(fe))
    got = tstep.greedy_generate(tp, tc, torch.from_numpy(prompt), n,
                                max_seq=max_seq,
                                frontend=None if fe is None
                                else torch.from_numpy(fe))
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_step_factories_match_jax(arch):
    jc, tc, jp, tp = _model(arch)
    prompt, fe = _inputs(tc, seed=1)
    max_seq = prompt.shape[1] + 2
    jlog, jcache = jstep.make_prefill(jc, max_seq)(
        jp, jnp.asarray(prompt), None if fe is None else jnp.asarray(fe))
    tlog, tcache = tstep.make_prefill(tc, max_seq)(
        tp, torch.from_numpy(prompt),
        None if fe is None else torch.from_numpy(fe))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=1e-4)
    tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
    jnxt, jlog, _ = jstep.make_decode_step(jc)(jp, jcache, jnp.asarray(tok))
    tnxt, tlog, tcache = tstep.make_decode_step(tc)(tp, tcache,
                                                    torch.from_numpy(tok))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(tnxt.numpy(), np.asarray(jnxt))
    assert int(tcache.length) == prompt.shape[1] + 1
