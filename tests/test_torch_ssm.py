"""Port parity for the Mamba2 layer: the port's ``ssm_apply`` against the
JAX package's at float32, with the same weights (the JAX ``ssm_init``
converted through ``repro_torch.convert``) and the same numpy inputs, on
the hymba smoke config: prefill (the chunked scan, three chunks of 8)
with its returned SSM state and conv context, then O(1) decode steps
from that state.  In bfloat16, the port's prefill against its own decode
recurrence: the prefill keeps the decay in float32, as the decode does
(a departure from the reference, which rounds it).  Plus the port's own
init against the reference's distributions.

Tolerance ``atol=rtol=1e-4``: the same float32 arithmetic, summed in
another order by another library."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as tscan  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _setup(seed=0):
    jc = dataclasses.replace(jconfigs.get_smoke("hymba_1_5b"), **F32)
    tc = dataclasses.replace(tconfigs.get_smoke("hymba_1_5b"), **F32)
    jp = dict(jax.jit(lambda k: jssm.ssm_init(k, jc).params)(
        jax.random.key(seed)))
    # non-trivial biases and skips so every term is exercised
    rng = np.random.default_rng(seed + 1)
    for name in ("conv_b", "conv_b_bc", "dt_bias", "d_skip", "norm"):
        jp[name] = jnp.asarray(
            0.5 * rng.standard_normal(jp[name].shape) + (name == "norm"),
            jnp.float32)
    tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
    return jc, tc, jp, tp


def _np(x):
    return x.detach().float().numpy()


def test_ssm_prefill_matches_jax():
    jc, tc, jp, tp = _setup()
    x = np.random.default_rng(2).standard_normal(
        (2, 24, tc.d_model)).astype(np.float32)
    out, (st, cs) = tssm.ssm_apply(tp, torch.from_numpy(x), tc,
                                   return_state=True)
    jout, (jst, jcs) = jssm.ssm_apply(jp, jnp.asarray(x), jc,
                                      return_state=True)
    ss, conv = tssm.ssm_state_shapes(tc, 2)
    assert tuple(st.shape) == ss and st.dtype == torch.float32
    assert tuple(cs.shape) == conv
    np.testing.assert_allclose(_np(out), np.asarray(jout), **TOL)
    np.testing.assert_allclose(_np(st), np.asarray(jst), **TOL)
    np.testing.assert_allclose(_np(cs), np.asarray(jcs), **TOL)


def test_ssm_decode_matches_jax():
    """Three decode steps from a prefill state: the O(1) recurrence and
    the conv context update, step by step."""
    jc, tc, jp, tp = _setup(seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, tc.d_model)).astype(np.float32)
    _, (st, cs) = tssm.ssm_apply(tp, torch.from_numpy(x), tc,
                                 return_state=True)
    _, (jst, jcs) = jssm.ssm_apply(jp, jnp.asarray(x), jc,
                                   return_state=True)
    launches = tscan.ssd_scan.launches
    for i in range(3):
        xt = rng.standard_normal((2, 1, tc.d_model)).astype(np.float32)
        out, (st, cs) = tssm.ssm_apply(tp, torch.from_numpy(xt), tc,
                                       state=st, conv_state=cs,
                                       return_state=True)
        jout, (jst, jcs) = jssm.ssm_apply(jp, jnp.asarray(xt), jc,
                                          state=jst, conv_state=jcs,
                                          return_state=True)
        np.testing.assert_allclose(_np(out), np.asarray(jout), **TOL)
        np.testing.assert_allclose(_np(st), np.asarray(jst), **TOL)
        np.testing.assert_allclose(_np(cs), np.asarray(jcs), **TOL)
    assert tscan.ssd_scan.launches == launches


def test_decode_continues_the_prefill():
    """A prefill of 8 tokens followed by 8 one-token decode steps gives the
    outputs, state and conv context of one prefill of all 16."""
    _, tc, _, tp = _setup(seed=5)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 16, tc.d_model)).astype(np.float32))
    full, (fst, fcs) = tssm.ssm_apply(tp, x, tc, return_state=True)
    _, (st, cs) = tssm.ssm_apply(tp, x[:, :8], tc, return_state=True)
    outs = []
    for t in range(8, 16):
        o, (st, cs) = tssm.ssm_apply(tp, x[:, t:t + 1], tc, state=st,
                                     conv_state=cs, return_state=True)
        outs.append(o)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(full[:, 8:]),
                               **TOL)
    np.testing.assert_allclose(_np(st), _np(fst), **TOL)
    np.testing.assert_allclose(_np(cs), _np(fcs), **TOL)


@pytest.mark.parametrize("arch", ["mamba2_370m", "hymba_1_5b"])
def test_bf16_prefill_decays_as_the_decode_recurrence(arch, monkeypatch):
    """In bfloat16 the prefill hands the scan la and dt in float32, as the
    one-token decode recurrence uses them; the reference rounds them to
    bf16 in its prefill (``repro/models/ssm.py:175-176``), so its bf16
    prefill and decode compute different decays.  Here a bf16 prefill of
    24 tokens and 24 decode steps from a zero state agree: the outputs
    within one bf16 spacing of the largest, the conv context exactly and
    the float32 state at 1e-4.  The reference's rounding, put in the
    port's prefill, moves the state far past that."""
    cfg = dataclasses.replace(tconfigs.get_smoke(arch),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    p = tssm.ssm_init(torch.Generator("cpu").manual_seed(0), cfg, 0)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)).bfloat16()
    full, (fst, fcs) = tssm.ssm_apply(p, x, cfg, return_state=True)
    st, cs = torch.zeros_like(fst), torch.zeros_like(fcs)
    outs = []
    for t in range(24):
        o, (st, cs) = tssm.ssm_apply(p, x[:, t:t + 1], cfg, state=st,
                                     conv_state=cs, return_state=True)
        outs.append(o)
    dec = torch.cat(outs, 1)
    assert full.dtype == dec.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(full), _np(dec), rtol=0,
                               atol=2 ** -7 * float(dec.float().abs().max()))
    assert torch.equal(fcs, cs)
    np.testing.assert_allclose(_np(fst), _np(st), **TOL)
    scan = tssm.ssd_scan
    monkeypatch.setattr(tssm, "ssd_scan", lambda x, b, c, la, dt, chunk: scan(
        x, b, c, la.bfloat16().float(), dt.bfloat16().float(), chunk=chunk))
    _, (rst, _) = tssm.ssm_apply(p, x, cfg, return_state=True)
    assert not np.allclose(_np(rst), _np(st), **TOL)


@pytest.mark.parametrize("stack", [0, 3])
def test_ssm_init_matches_reference_tree_and_distributions(stack):
    """Same keys, shapes and dtypes as the JAX ``ssm_init`` (a leading
    layer axis when stacked); a_log = log(linspace(1, 16, H)), dt_bias
    zeros and d_skip ones in float32, norm ones, zero conv biases,
    N(0, 1/fan_in) projections and conv weights at 1/sqrt(k)."""
    cfg = tconfigs.get_smoke("hymba_1_5b")
    jc = jconfigs.get_smoke("hymba_1_5b")
    jp = jssm.ssm_init(jax.random.key(0), jc).params
    tp = tssm.ssm_init(torch.Generator("cpu").manual_seed(0), cfg, stack)
    lead = (stack,) if stack else ()
    assert sorted(tp) == sorted(jp)
    for k, a in jp.items():
        assert tuple(tp[k].shape) == lead + a.shape, k
        assert str(tp[k].dtype) == f"torch.{a.dtype.name}", k
    d_in, H, P, N = tssm.ssm_dims(cfg)
    want_a = np.log(np.linspace(1.0, 16.0, H, dtype=np.float32))
    np.testing.assert_allclose(tp["a_log"].reshape(-1, H).numpy(),
                               np.broadcast_to(want_a, (max(stack, 1), H)),
                               rtol=1e-6)
    assert (tp["dt_bias"] == 0).all() and (tp["d_skip"] == 1).all()
    assert (tp["norm"] == 1).all() and (tp["conv_b"] == 0).all()
    assert (tp["conv_b_bc"] == 0).all()
    for k, scale in (("w_zx", cfg.d_model ** -0.5),
                     ("w_out", d_in ** -0.5),
                     ("conv_w", cfg.ssm_conv ** -0.5)):
        x = tp[k].float()
        assert abs(float(x.std()) / scale - 1) < 0.1, k
        assert abs(float(x.mean())) < 0.1 * scale, k
