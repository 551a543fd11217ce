"""The rest of ``tests/test_kv_backend.py`` on the port, each case held
against the JAX package: dense-vs-paged decode parity on qwen1.5-0.5b,
starcoder2-7b and phi3-medium-14b (gathered view and kernel path, the
JAX paged backend alongside in float32), the backend registry and decode
modes, the hybrid fork's side state, layer-axis placement, ragged decode,
exhaustion rollbacks, released backends, dirty-block staging and prefix
sharing.  Allocator state (block tables, refcounts, the dirty set,
staged-block counts) must equal the JAX backend's bitwise; logits agree
within float32 tolerance.  The JAX backend decodes in ``"gather"`` mode
(no Pallas kernel in interpret mode); the port's ``"kernel"`` mode runs
its plain twin on CPU tensors.

Already ported elsewhere, not repeated here: the pure-window case
(``test_dense_paged_parity_sliding_window``), the MoE layer offsets
(``test_kernel_decode_parity_moe_layer_offsets``) and the hybrid SSM
parity (``test_hybrid_dense_paged_parity``), all in
``tests/test_torch_kvcache.py``.  The deprecated ``DenseBackend.k``/``.v``
compatibility reads were never ported: ``.cache`` is the read."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kvcache.backend import PagedBackend as JPaged  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kvcache import row_group_of  # noqa: E402
from repro_torch.kvcache.backend import DenseBackend, PagedBackend, \
    ShardedPagedBackend, make_backend  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

torch.set_num_threads(1)

ARCHS = ["qwen1_5_0_5b", "starcoder2_7b", "phi3_medium_14b"]
F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)
_MODELS: dict = {}


def _model(arch, f32=True, **over):
    """(jax cfg, port cfg, jax params, port params): ``arch``'s smoke
    config, the reference's init (key 0) converted to the port."""
    key = (arch, f32, tuple(sorted(over.items())))
    if key not in _MODELS:
        kw = dict(F32 if f32 else {}, **over)
        jc = dataclasses.replace(jconfigs.get_smoke(arch), **kw)
        tc = dataclasses.replace(tconfigs.get_smoke(arch), **kw)
        jp = jax.jit(lambda k: jlm.init(jc, k).params)(jax.random.key(0))
        tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                       "cpu")
        _MODELS[key] = (jc, tc, jp, tp)
    return _MODELS[key]


def _paged(arch="qwen1_5_0_5b", f32=True, **kw):
    """The JAX paged backend (gather decode) and the port's (kernel
    decode on CPU tensors), alike."""
    jc, tc, jp, tp = _model(arch, f32)
    return (JPaged(jc, decode_mode="gather", **kw),
            PagedBackend(tc, decode_mode="kernel", device="cpu", **kw),
            jp, tp)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(1, vocab, shape) \
        .astype(np.int32)


def _same_alloc(jpool, tpool):
    np.testing.assert_array_equal(tpool.used, jpool.used)
    np.testing.assert_array_equal(tpool.refcount, jpool.refcount)
    assert tpool.content == jpool.content
    assert list(tpool._evictable) == list(jpool._evictable)
    assert tpool.placement.free_ids() == jpool.placement.free_ids()
    assert tpool.dirty == jpool.dirty
    assert tpool.stats.as_dict() == jpool.stats.as_dict()


def _same_tables(jb, tb):
    assert sorted(tb._seqs) == sorted(jb._seqs)
    for sid, s in jb._seqs.items():
        t = tb._seqs[sid]
        assert (t.table.blocks, t.table.num_tokens, t.tokens) == \
            (s.table.blocks, s.table.num_tokens, s.tokens)


# ---------------------------------------------------------------------------
# dense vs paged logit parity — gather path and kernel path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("decode_mode", ["gather", "kernel"])
def test_dense_paged_decode_parity(arch, decode_mode):
    """The port's DenseBackend and PagedBackend give matching logits over
    prefill + 5 greedy decode steps, and so does the JAX paged backend on
    the same converted weights (float32, where no compute-dtype near tie
    can flip an argmax); the port's and the JAX pool hold the same
    blocks."""
    jc, tc, jp, tp = _model(arch)
    toks = _tokens(1, (2, 9), tc.vocab)
    dense = DenseBackend(tc, batch=2, max_seq=24, device="cpu")
    paged = PagedBackend(tc, num_blocks=64, block_size=4,
                         decode_mode=decode_mode, device="cpu")
    jpaged = JPaged(jc, num_blocks=64, block_size=4, decode_mode="gather")
    assert paged.decode_mode == decode_mode
    lg_d, _ = tlm.prefill(tp, tc, torch.from_numpy(toks), backend=dense)
    lg_p, _ = tlm.prefill(tp, tc, torch.from_numpy(toks), backend=paged)
    lg_j, _ = jlm.prefill(jp, jc, jnp.asarray(toks), backend=jpaged)
    np.testing.assert_allclose(lg_p.numpy(), lg_d.numpy(), **TOL)
    np.testing.assert_allclose(lg_p.numpy(), np.asarray(lg_j), **TOL)
    tok = lg_d[:, -1].argmax(-1).to(torch.int32)[:, None]
    for _ in range(5):
        lg_d, _ = tlm.decode_step(tp, tc, tok, dense)
        lg_p, _ = tlm.decode_step(tp, tc, tok, paged)
        lg_j, _ = jlm.decode_step(jp, jc, jnp.asarray(tok.numpy()), jpaged)
        np.testing.assert_allclose(lg_p.numpy(), lg_d.numpy(), **TOL)
        np.testing.assert_allclose(lg_p.numpy(), np.asarray(lg_j), **TOL)
        a = lg_d[:, -1].argmax(-1)
        assert torch.equal(a, lg_p[:, -1].argmax(-1))
        tok = a.to(torch.int32)[:, None]
    assert (paged.lengths == dense.lengths).all()
    assert (paged.lengths == np.asarray(jpaged.lengths)).all()
    _same_alloc(jpaged.pool, paged.pool)
    paged.release()
    paged.pool.check_invariants()
    assert paged.pool.num_live == 0


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "starcoder2_7b"])
def test_gather_path_is_the_dense_math_in_bf16(arch):
    """The gathered-view decode runs the dense step itself: in the
    config's own bfloat16 it tracks the port's dense backend at the
    reference's tolerance, with the same argmaxes."""
    _, tc, _, tp = _model(arch, f32=False)
    toks = torch.from_numpy(_tokens(1, (2, 9), tc.vocab))
    dense = DenseBackend(tc, batch=2, max_seq=24, device="cpu")
    paged = PagedBackend(tc, num_blocks=64, block_size=4,
                         decode_mode="gather", device="cpu")
    lg_d, _ = tlm.prefill(tp, tc, toks, backend=dense)
    lg_p, _ = tlm.prefill(tp, tc, toks, backend=paged)
    np.testing.assert_allclose(lg_p.float().numpy(), lg_d.float().numpy(),
                               **TOL)
    tok = lg_d[:, -1].argmax(-1).to(torch.int32)[:, None]
    for _ in range(5):
        lg_d, _ = tlm.decode_step(tp, tc, tok, dense)
        lg_p, _ = tlm.decode_step(tp, tc, tok, paged)
        np.testing.assert_allclose(lg_p.float().numpy(),
                                   lg_d.float().numpy(), **TOL)
        a = lg_d[:, -1].float().argmax(-1)
        assert torch.equal(a, lg_p[:, -1].float().argmax(-1))
        tok = a.to(torch.int32)[:, None]
    paged.release()


def test_make_backend_registry():
    from repro.kvcache.backend import make_backend as jmake
    jc, tc, _, _ = _model("qwen1_5_0_5b")
    assert isinstance(make_backend(tc, "dense", batch=1, max_seq=8,
                                   device="cpu"), DenseBackend)
    assert isinstance(make_backend(tc, "paged", num_blocks=16,
                                   device="cpu"), PagedBackend)
    # paged sizing honors the capacity request, as the reference's
    for batch, max_seq in ((2, 64), (3, 15), (1, 0)):
        be = make_backend(tc, "paged", batch=batch, max_seq=max_seq,
                          device="cpu")
        assert be.pool.cfg.num_blocks == jmake(
            jc, "paged", batch=batch, max_seq=max_seq).pool.cfg.num_blocks
    assert make_backend(tc, "paged", batch=2, max_seq=64,
                        device="cpu").pool.cfg.num_blocks == 2 * 5
    with pytest.raises(ValueError, match="holographic"):
        make_backend(tc, "holographic")
    # families whose decode state the pool cannot hold are refused (the
    # reference raises NotImplementedError, the port ValueError)
    with pytest.raises(ValueError, match="dense backend"):
        make_backend(tconfigs.get_smoke("mamba2_370m"), "paged",
                     device="cpu")


def test_paged_decode_mode_selection():
    _, tc, _, _ = _model("qwen1_5_0_5b")
    assert PagedBackend(tc, num_blocks=16,
                        device="cpu").decode_mode == "kernel"
    assert PagedBackend(tc, num_blocks=16, decode_mode="gather",
                        device="cpu").decode_mode == "gather"
    with pytest.raises(ValueError):
        PagedBackend(tc, num_blocks=16, decode_mode="telepathic",
                     device="cpu")
    swin = dataclasses.replace(tc, sliding_window=8)
    assert PagedBackend(swin, num_blocks=16,
                        device="cpu").decode_mode == "kernel"
    sharded = ShardedPagedBackend(tc, n_shards=2, num_blocks=16,
                                  devices=["cpu", "cpu"])
    assert sharded.decode_mode == "kernel"
    sharded.decode_mode = "gather"
    assert [b.decode_mode for b in sharded.backends] == ["gather"] * 2
    with pytest.raises(ValueError):
        sharded.decode_mode = "telepathic"


def test_hybrid_fork_copies_side_state():
    """A forked hybrid sequence owns its SSM/conv state: diverging forks
    advance independent recurrences, as in the JAX backend."""
    jc, tc, jp, tp = _model("hymba_1_5b", ssm_chunk=4)
    jb = JPaged(jc, num_blocks=64, block_size=4, decode_mode="gather")
    tb = PagedBackend(tc, num_blocks=64, block_size=4, decode_mode="kernel",
                      device="cpu")
    for b, p in ((jb, jp), (tb, tp)):
        sid, _, _ = b.new_seq(p, list(range(1, 9)))
        fid = b.fork_seq(sid)
        b.decode(p, [sid, fid], [7, 9])              # forks diverge
    s, f = tb._seqs[0], tb._seqs[1]
    assert s.ssm is not f.ssm and not torch.equal(s.ssm, f.ssm)
    for sid in (0, 1):
        np.testing.assert_allclose(tb._seqs[sid].ssm.numpy(),
                                   np.asarray(jb._seqs[sid].ssm), **TOL)
    _same_tables(jb, tb)
    for b in (jb, tb):
        b.release()
        b.pool.check_invariants()


def test_dense_backend_exposes_concrete_cache_reads():
    """``DenseBackend.cache`` is the concrete ``lm.Cache``: its K plane is
    (L, B, max_seq, Hkv, dh) and its length follows the prefill."""
    _, tc, _, tp = _model("qwen1_5_0_5b")
    be = tlm.init_cache(tc, batch=2, max_seq=16, device="cpu")
    assert tuple(be.cache.k.shape) == (tc.n_layers, 2, 16, tc.n_kv_heads,
                                       tc.d_head)
    _, be = tlm.prefill(tp, tc, torch.from_numpy(_tokens(2, (2, 4),
                                                         tc.vocab)),
                        backend=be)
    assert int(be.cache.length) == 4


# ---------------------------------------------------------------------------
# layer-axis placement
# ---------------------------------------------------------------------------

def test_layer_axis_keeps_token_blocks_in_one_row_group():
    jb, tb, jp, tp = _paged(num_blocks=64, block_size=4)
    prompt = list(range(1, 19))
    for b, p in ((jb, jp), (tb, tp)):
        sid, _, _ = b.new_seq(p, prompt)
        for _ in range(3):
            b.decode(p, [sid], [5])
    _same_tables(jb, tb)
    _same_alloc(jb.pool, tb.pool)
    cfg, pool, table = tb.cfg, tb.pool, tb.table(0)
    bpg = pool.cfg.blocks_per_group
    for t in range(table.num_tokens):
        groups = {row_group_of(tb.block_of(0, layer, t), bpg)
                  for layer in range(cfg.n_layers)}
        assert len(groups) == 1
        assert tb.block_of(0, 0, t) == jb.block_of(0, 0, t)
    assert len({row_group_of(b, bpg) for b in table.blocks}) == \
        -(-len(table.blocks) // bpg)
    assert pool.k_pages.shape[0] == cfg.n_layers


def test_paged_ragged_decode_matches_isolated():
    """Lanes at different lengths decoding in one batched call see the
    logits they get decoding alone, and the JAX backend's."""
    jc, tc, jp, tp = _model("starcoder2_7b")
    kw = dict(num_blocks=64, block_size=4, share_prefixes=False)
    together = PagedBackend(tc, decode_mode="kernel", device="cpu", **kw)
    jtogether = JPaged(jc, decode_mode="gather", **kw)
    a, la, _ = together.new_seq(tp, list(range(1, 14)))
    b, lb, _ = together.new_seq(tp, list(range(20, 25)))
    jtogether.new_seq(jp, list(range(1, 14)))
    jtogether.new_seq(jp, list(range(20, 25)))
    lg = together.decode(tp, [a, b], [7, 9])
    np.testing.assert_allclose(lg, np.asarray(jtogether.decode(
        jp, [a, b], [7, 9])), **TOL)
    for prompt, nxt, want0, idx in ((list(range(1, 14)), 7, la, 0),
                                    (list(range(20, 25)), 9, lb, 1)):
        alone = PagedBackend(tc, decode_mode="kernel", device="cpu", **kw)
        s, l0, _ = alone.new_seq(tp, prompt)
        np.testing.assert_allclose(l0, want0, **TOL)
        np.testing.assert_allclose(lg[idx], alone.decode(tp, [s], [nxt])[0],
                                   **TOL)


# ---------------------------------------------------------------------------
# exhaustion rollback, released backends, dirty staging
# ---------------------------------------------------------------------------

def test_pool_exhaustion_rolls_back_partial_prefill():
    jb, tb, jp, tp = _paged(num_blocks=8, block_size=4)
    prompt = list(range(1, 17)) + list(range(100, 124))
    for b, p in ((jb, jp), (tb, tp)):
        pool = b.pool
        sid, _, _ = b.new_seq(p, list(range(1, 21)))
        b.free_seq(sid)
        assert pool.num_live == 0 and pool.num_cached == 5
        with pytest.raises(RuntimeError, match="pool exhausted"):
            b.new_seq(p, prompt)
        pool.check_invariants()
        assert pool.num_live == 0 and pool.num_cached >= 1
    _same_alloc(jb.pool, tb.pool)
    for b, p in ((jb, jp), (tb, tp)):
        sid2, _, _ = b.new_seq(p, list(range(1, 13)))
        b.free_seq(sid2)
        b.pool.check_invariants()
        assert b.pool.num_live == 0
    _same_alloc(jb.pool, tb.pool)


def test_pool_exhaustion_rolls_back_whole_batch():
    jb, tb, jp, tp = _paged(num_blocks=6, block_size=4, share_prefixes=False)
    rows = np.asarray([list(range(1, 13)) + [0, 0], list(range(20, 34))],
                      np.int32)
    for b, p in ((jb, jp), (tb, tp)):
        with pytest.raises(RuntimeError, match="pool exhausted"):
            b._add_seqs(p, rows)
        b.pool.check_invariants()
        assert b.pool.num_live == 0 and not b._seqs
    _same_alloc(jb.pool, tb.pool)


def test_released_dense_backend_raises_clear_error():
    _, tc, _, tp = _model("qwen1_5_0_5b")
    be = DenseBackend(tc, batch=1, max_seq=8, device="cpu")
    toks = torch.from_numpy(_tokens(0, (1, 4), tc.vocab))
    tlm.prefill(tp, tc, toks, backend=be)
    be.release()
    for fn in (lambda: be.decode_step(tp, torch.ones((1, 1),
                                                     dtype=torch.int32)),
               lambda: be.prefill(tp, toks), lambda: be.lengths,
               be.flush):
        with pytest.raises(RuntimeError, match="released"):
            fn()


@pytest.mark.parametrize("sharded", [False, True])
def test_released_paged_backend_raises_clear_error(sharded):
    _, tc, _, tp = _model("qwen1_5_0_5b")
    be = ShardedPagedBackend(tc, n_shards=2, num_blocks=32, block_size=4,
                             devices=["cpu", "cpu"]) if sharded else \
        PagedBackend(tc, num_blocks=32, block_size=4, device="cpu")
    toks = torch.from_numpy(_tokens(0, (1, 4), tc.vocab))
    tlm.prefill(tp, tc, toks, backend=be)
    be.release()
    be.pool.check_invariants()
    for fn in (lambda: be.decode_step(tp, torch.ones((1, 1),
                                                     dtype=torch.int32)),
               lambda: be.prefill(tp, toks),
               lambda: be.lengths,
               lambda: be.new_seq(tp, [1, 2, 3]),
               lambda: be.fork_seq(0),
               lambda: be.free_seq(0),
               lambda: be.table(0)):
        with pytest.raises(RuntimeError, match="released"):
            fn()


def test_decode_stages_only_dirty_blocks():
    """Per-step staging uploads the blocks dirtied since that mirror slot
    was last staged — the union of the last two steps' dirty sets, never
    the whole pool after the first step — the same counts as the JAX
    backend's, and the staged mirror converges to the host pool."""
    jb, tb, jp, tp = _paged(num_blocks=64, block_size=4,
                            share_prefixes=False)
    staged = []
    for b, p in ((jb, jp), (tb, tp)):
        pool = b.pool
        got = []
        sid, _, _ = b.new_seq(p, list(range(1, 10)))
        b.decode(p, [sid], [3])
        assert b.staged_blocks_last_step == pool.cfg.num_blocks
        prev = set(pool.dirty)
        for tok in (5, 7, 9, 11):
            cur = set(pool.dirty)
            b.decode(p, [sid], [tok])
            assert b.staged_blocks_last_step == len(prev | cur) <= 2
            got.append(b.staged_blocks_last_step)
            prev = cur
        sid2, _, _ = b.new_seq(p, list(range(30, 45)))
        cur = set(pool.dirty)
        assert 1 < len(prev | cur) < pool.cfg.num_blocks
        b.decode(p, [sid, sid2], [2, 4])
        assert b.staged_blocks_last_step == len(prev | cur)
        got.append(b.staged_blocks_last_step)
        staged.append(got)
    assert staged[1] == staged[0]
    _same_alloc(jb.pool, tb.pool)
    k, v = tb._staged_pages()
    assert torch.equal(k, tb.pool.k_pages) and torch.equal(v, tb.pool.v_pages)
    tb.release()


def test_paged_prefix_sharing_shares_storage():
    jb, tb, jp, tp = _paged(num_blocks=64, block_size=4)
    prompt = list(range(1, 18))
    for b, p in ((jb, jp), (tb, tp)):
        s1, l1, n1 = b.new_seq(p, prompt)
        s2, l2, n2 = b.new_seq(p, prompt)
        assert n1 == 0 and n2 == 16
        assert b.table(s1).blocks[:4] == b.table(s2).blocks[:4]
        np.testing.assert_allclose(np.asarray(l1), np.asarray(l2),
                                   rtol=1e-5, atol=1e-5)
    _same_tables(jb, tb)
    _same_alloc(jb.pool, tb.pool)
    for b in (jb, tb):
        b.release()
        assert b.pool.num_live == 0
