"""Differential tests of the port's host-side KV-cache logic: the same
sequence of pool / prefix-cache / block-table operations (prefill with
prefix matching, appends, forks with copy-on-write, releases, eviction
under a tight pool, reservations, dirty-set drains) driven through both
packages must leave bitwise-identical state — allocator arrays, block
tables, stats, the dirty set and the KV payload bits.  The same holds
for the decode operand pack, the lane order, the MARS reorder and the
embedding gather, and for the reference's 400-step randomized soak, run
under each package's ``analysis.refsan``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import reorder as jreorder  # noqa: E402
from repro.kernels.mars_gather import ops as jgather  # noqa: E402
from repro.kernels.paged_attention import ops as jops  # noqa: E402
from repro.kvcache import pool as jpool  # noqa: E402
from repro.kvcache import prefix as jprefix  # noqa: E402
from repro_torch.core import reorder as treorder  # noqa: E402
from repro_torch.kernels.mars_gather import ops as tgather  # noqa: E402
from repro_torch.kernels.paged_attention import ops as tops  # noqa: E402
from repro_torch.kvcache import pool as tpool  # noqa: E402
from repro_torch.kvcache import prefix as tprefix  # noqa: E402

torch.set_num_threads(1)

L, K, D, BS = 2, 2, 8, 4          # layers, kv heads, head dim, block size


class Side:
    """One package's pool + prefix cache + live tables."""

    def __init__(self, pool_mod, prefix_mod, **cfg):
        self.prefix_mod = prefix_mod
        self.pool = pool_mod.BlockPool(pool_mod.PoolConfig(**cfg))
        self.cache = prefix_mod.PrefixCache(self.pool.cfg.block_size)
        self.cache.attach(self.pool)
        self.tables: list = []
        self.tokens: list = []

    def prefill(self, prompt, kv):
        bids, n = self.cache.match(prompt, self.pool)
        table = self.prefix_mod.BlockTable(list(bids), n)
        try:
            table.extend(self.pool, prompt[n:], seq_tokens=prompt,
                         cache=self.cache,
                         kv=(kv[0][:, n:], kv[1][:, n:]))
        except RuntimeError:
            self.cache.release(table, self.pool)
            return "exhausted"
        self.tables.append(table)
        self.tokens.append(list(prompt))
        return n

    def append(self, i, toks, kv):
        """Append when the pool can take it (``extend`` is not atomic
        under exhaustion: each appended token needs at most one block,
        plus one for a copy-on-write tail)."""
        if not self.pool.can_alloc(len(toks) + 1):
            return "full"
        seq = self.tokens[i] + list(toks)
        self.tables[i].extend(self.pool, list(toks), seq_tokens=seq,
                              cache=self.cache, kv=kv)
        self.tokens[i] = seq
        return None

    def fork(self, i):
        self.tables.append(self.tables[i].fork(self.pool))
        self.tokens.append(list(self.tokens[i]))

    def release(self, i):
        self.cache.release(self.tables.pop(i), self.pool)
        self.tokens.pop(i)


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _assert_same(j: Side, t: Side):
    jp, tp = j.pool, t.pool
    np.testing.assert_array_equal(tp.used, jp.used)
    np.testing.assert_array_equal(tp.refcount, jp.refcount)
    np.testing.assert_array_equal(tp.arrival, jp.arrival)
    np.testing.assert_array_equal(tp.last_use, jp.last_use)
    assert tp.content == jp.content
    assert list(tp._evictable) == list(jp._evictable)
    assert tp.placement.free_ids() == jp.placement.free_ids()
    assert tp.reserved == jp.reserved
    assert tp.stats.as_dict() == jp.stats.as_dict()
    assert tp.dirty == jp.dirty
    assert [(x.blocks, x.num_tokens) for x in t.tables] == \
        [(x.blocks, x.num_tokens) for x in j.tables]
    assert t.tokens == j.tokens
    assert t.cache._by_key == j.cache._by_key
    np.testing.assert_array_equal(_bits(tp.k_pages), _bits(jp.k_pages))
    np.testing.assert_array_equal(_bits(tp.v_pages), _bits(jp.v_pages))
    tp.check_invariants()


@pytest.mark.parametrize("placement,eviction,dtype", [
    ("mars", "fifo", "float32"),
    ("mars", "lru", "bfloat16"),
    ("naive", "fifo", "float32"),
])
def test_pool_prefix_differential(placement, eviction, dtype):
    cfg = dict(num_blocks=24, block_size=BS, blocks_per_group=4,
               placement=placement, eviction=eviction, n_kv_heads=K,
               head_dim=D, n_layers=L, dtype=dtype)
    j = Side(jpool, jprefix, **cfg)
    t = Side(tpool, tprefix, **cfg)
    rng = np.random.default_rng(0)
    hot = [tuple(int(x) for x in rng.integers(1, 50, 2 * BS))
           for _ in range(3)]

    def kv(n):
        # float32 payload; the bf16 pools round it on write (both sides
        # round to nearest even)
        return (rng.standard_normal((L, n, K, D)).astype(np.float32),
                rng.standard_normal((L, n, K, D)).astype(np.float32))

    for step in range(160):
        op = rng.choice(["prefill", "append", "fork", "release",
                         "reserve", "drain"],
                        p=[0.3, 0.3, 0.1, 0.15, 0.05, 0.1])
        if op == "prefill" or not j.tables:
            prompt = list(hot[rng.integers(3)]) + \
                [int(x) for x in rng.integers(1, 50, rng.integers(1, 7))]
            payload = kv(len(prompt))
            assert t.prefill(prompt, payload) == j.prefill(prompt, payload)
        elif op == "append":
            i = int(rng.integers(len(j.tables)))
            toks = [int(x) for x in rng.integers(1, 50, rng.integers(1, 4))]
            payload = kv(len(toks))
            assert t.append(i, toks, payload) == j.append(i, toks, payload)
        elif op == "fork":
            i = int(rng.integers(len(j.tables)))
            j.fork(i)
            t.fork(i)
        elif op == "release":
            i = int(rng.integers(len(j.tables)))
            j.release(i)
            t.release(i)
        elif op == "reserve":
            n = int(rng.integers(0, 4))
            ok = j.pool.can_reserve(n)
            assert t.pool.can_reserve(n) == ok
            if ok:
                j.pool.reserve(n)
                t.pool.reserve(n)
            j.pool.unreserve(j.pool.reserved // 2)
            t.pool.unreserve(t.pool.reserved // 2)
        else:
            assert t.pool.drain_dirty() == j.pool.drain_dirty()
        _assert_same(j, t)
    # the run exercised every path it claims to
    s = t.pool.stats
    assert s.cow_copies and s.evictions and s.prefix_hits and s.alloc_fails


def _random_tables(rng, n, block_size=4, num_blocks=64):
    tables = []
    for _ in range(n):
        ntok = int(rng.integers(0, 20))
        nblk = -(-ntok // block_size)
        tables.append(tprefix.BlockTable(
            [int(b) for b in rng.choice(num_blocks, nblk, replace=False)],
            ntok))
    return tables


@pytest.mark.parametrize("n_lanes", [1, 3, 5, 8])
def test_decode_step_operands_and_lane_order(n_lanes):
    rng = np.random.default_rng(n_lanes)
    for _ in range(3):
        tables = _random_tables(rng, n_lanes)
        toks = [int(x) for x in rng.integers(0, 100, n_lanes)]
        got = tops.decode_step_operands(tables, toks, 4)
        want = jops.decode_step_operands(tables, toks, 4)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        # padded lanes have length 0 and token 0; page axis is a pow2
        Bp, n_pages = got[0].shape
        assert Bp & (Bp - 1) == 0 and n_pages & (n_pages - 1) == 0
        assert (got[1][n_lanes:] == 0).all() and (got[2][n_lanes:] == 0).all()
        for shard_ids in (None, [int(s) for s in rng.integers(0, 2, n_lanes)]):
            np.testing.assert_array_equal(
                tops.batch_lane_order(tables, 4, shard_ids),
                jops.batch_lane_order(tables, 4, shard_ids))
        np.testing.assert_array_equal(
            tops.pool_page_tables(tables, pad_lanes=8)[0],
            jops.pool_page_tables(tables, pad_lanes=8)[0])
    assert len(tops.batch_lane_order([], 4)) == 0


@pytest.mark.parametrize("window", [None, 1, 5, 16])
def test_mars_order_matches_reference(window):
    rng = np.random.default_rng(7)
    jorder = jax.jit(jreorder.mars_order, static_argnames=("window",))
    for n in (0, 7, 100):
        ids = rng.integers(0, 9, n).astype(np.int32)
        got = treorder.mars_order(ids, window=window)
        want = np.asarray(jorder(jnp.asarray(ids), window=window))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            treorder.mars_order(ids, num_pages=9, window=window), want)
        np.testing.assert_array_equal(
            treorder.inverse_permutation(got),
            np.asarray(jreorder.inverse_permutation(jnp.asarray(want))))
        tperm = torch.from_numpy(got.astype(np.int64))
        np.testing.assert_array_equal(
            treorder.inverse_permutation(tperm).numpy(),
            treorder.inverse_permutation(got))


@pytest.mark.parametrize("mode,rows", [("auto", 64), ("auto", 1 << 16),
                                       ("plain", 64), ("sorted", 64)])
def test_embedding_gather_is_a_plain_take(mode, rows):
    """Every mode is bitwise the plain row take, and the reference's."""
    rng = np.random.default_rng(3)
    table = rng.standard_normal((rows, 64)).astype(np.float32)
    ids = rng.integers(0, rows, (3, 11)).astype(np.int32)
    got = tgather.embedding_gather(torch.from_numpy(table),
                                   torch.from_numpy(ids), mode=mode)
    assert tuple(got.shape) == (3, 11, 64)
    np.testing.assert_array_equal(got.numpy(), table[ids])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jgather.embedding_gather(
            jnp.asarray(table), jnp.asarray(ids), mode=mode)))


# ---------------------------------------------------------------------------
# hybrid side state (hymba: SSM state and conv context per sequence)
# ---------------------------------------------------------------------------

F32 = dict(param_dtype="float32", compute_dtype="float32")
_HYBRID: dict = {}


def _hybrid():
    """(jax cfg, port cfg, jax params, port params): the hymba smoke
    config at float32 with its window cut to 6 so decode crosses it."""
    if not _HYBRID:
        import dataclasses
        from repro import configs as jconfigs
        from repro.models import lm as jlm
        from repro_torch import configs as tconfigs
        from repro_torch import convert
        kw = dict(F32, sliding_window=6)
        jc = dataclasses.replace(jconfigs.get_smoke("hymba_1_5b"), **kw)
        tc = dataclasses.replace(tconfigs.get_smoke("hymba_1_5b"), **kw)
        jp = jax.jit(lambda k: jlm.init(jc, k).params)(jax.random.key(0))
        tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                       "cpu")
        _HYBRID.update(v=(jc, tc, jp, tp))
    return _HYBRID["v"]


HTOL = dict(atol=1e-4, rtol=1e-4)


def _same_side_state(jb, tb, sids):
    for sid in sids:
        js, ts = jb._seqs[sid], tb._seqs[sid]
        assert ts.tokens == js.tokens
        assert ts.table.blocks == js.table.blocks
        assert ts.ssm.device == tb.device and ts.ssm.dtype == torch.float32
        assert tuple(ts.ssm.shape) == js.ssm.shape
        assert tuple(ts.conv.shape) == js.conv.shape
        np.testing.assert_allclose(ts.ssm.numpy(), js.ssm, **HTOL)
        np.testing.assert_allclose(ts.conv.float().numpy(),
                                   np.asarray(js.conv, np.float32), **HTOL)


@pytest.mark.parametrize("decode_mode", ["kernel", "gather"])
def test_hybrid_side_state_matches_jax_backend(decode_mode):
    """Prefill, decode, fork, pause and resume carry each sequence's SSM
    state and conv context exactly as the JAX backend does: the same
    values after every operation, forks and paused records owning their
    own copies, a resumed sequence continuing from its paused state."""
    from repro.kvcache.backend import PagedBackend as JPagedBackend
    from repro_torch.kvcache.backend import PagedBackend as TPagedBackend
    jc, tc, jp, tp = _hybrid()
    jb = JPagedBackend(jc, num_blocks=64, block_size=4,
                       decode_mode=decode_mode)
    tb = TPagedBackend(tc, num_blocks=64, block_size=4,
                       decode_mode=decode_mode, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, tc.vocab, n).tolist() for n in (8, 16)]

    def both(fn_j, fn_t):
        out_j, out_t = fn_j(jb), fn_t(tb)
        return out_j, out_t

    def decode(sids, toks):
        lj, lt = both(lambda b: b.decode(jp, sids, toks),
                      lambda b: b.decode(tp, sids, toks))
        np.testing.assert_allclose(lt, lj, **HTOL)
        _same_side_state(jb, tb, sids)

    sids = []
    for p in prompts:
        (sj, lj, nj), (st, lt, nt) = both(lambda b: b.new_seq(jp, p),
                                          lambda b: b.new_seq(tp, p))
        assert sj == st and nj == nt
        np.testing.assert_allclose(lt, lj, **HTOL)
        sids.append(st)
    a, b = sids
    _same_side_state(jb, tb, sids)
    decode([a, b], [3, 5])
    fj, ft = both(lambda x: x.fork_seq(a), lambda x: x.fork_seq(a))
    assert fj == ft
    f = ft
    _same_side_state(jb, tb, [a, f])
    assert tb._seqs[f].ssm is not tb._seqs[a].ssm
    assert torch.equal(tb._seqs[f].ssm, tb._seqs[a].ssm)
    decode([a, b, f], [7, 9, 11])            # the fork diverges
    assert not torch.equal(tb._seqs[f].ssm, tb._seqs[a].ssm)
    paused_ssm = tb._seqs[b].ssm.clone()
    rj, rt = both(lambda x: x.pause_seq(b), lambda x: x.pause_seq(b))
    np.testing.assert_allclose(rt["ssm"].numpy(), rj["ssm"], **HTOL)
    np.testing.assert_allclose(rt["conv"].numpy(), rj["conv"], **HTOL)
    decode([a, f], [2, 4])
    bj, bt = both(lambda x: x.resume_seq(rj), lambda x: x.resume_seq(rt))
    assert bj == bt
    assert torch.equal(tb._seqs[bt].ssm, paused_ssm)
    assert tb._seqs[bt].ssm is not rt["ssm"]
    _same_side_state(jb, tb, [a, f, bt])
    decode([a, f, bt], [6, 8, 10])
    assert torch.equal(rt["ssm"], paused_ssm)    # the record kept its copy
    for x in (jb, tb):
        x.release()
        x.pool.check_invariants()
    assert tb.pool.num_live == 0


@pytest.mark.parametrize("decode_mode", ["kernel", "gather"])
def test_hybrid_dense_paged_parity(decode_mode):
    """The port's PagedBackend against its DenseBackend on the hybrid
    model, batch API: the same logits after the prefill and after each
    of 7 decode steps past the window (the dense cache holds the side
    state in ``lm.Cache.ssm``/``conv``)."""
    from repro_torch.kvcache.backend import make_backend
    from repro_torch.models import lm as tlm
    _, tc, _, tp = _hybrid()
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        1, tc.vocab, (2, 8)).astype(np.int32))
    dense = make_backend(tc, "dense", batch=2, max_seq=24, device="cpu")
    paged = make_backend(tc, "paged", num_blocks=64, block_size=4,
                         decode_mode=decode_mode, device="cpu")
    lg_d, _ = tlm.prefill(tp, tc, toks, backend=dense)
    lg_p, _ = tlm.prefill(tp, tc, toks, backend=paged)
    np.testing.assert_allclose(lg_p.numpy(), lg_d.numpy(), **HTOL)
    tok = lg_d[:, -1].argmax(-1).to(torch.int32)[:, None]
    for _ in range(7):
        lg_d, _ = tlm.decode_step(tp, tc, tok, dense)
        lg_p, _ = tlm.decode_step(tp, tc, tok, paged)
        np.testing.assert_allclose(lg_p.numpy(), lg_d.numpy(), **HTOL)
        assert torch.equal(lg_p[:, -1].argmax(-1), lg_d[:, -1].argmax(-1))
        tok = lg_d[:, -1].argmax(-1).to(torch.int32)[:, None]
    assert dense.cache.ssm.shape == (tc.n_layers, 2) + tuple(
        paged._seqs[paged._batch[0]].ssm.shape[1:])
    paged.release()
    paged.pool.check_invariants()
    assert paged.pool.num_live == 0


# ---------------------------------------------------------------------------
# MoE layer offsets (kimi: a leading dense block stack)
# ---------------------------------------------------------------------------

_MOE: dict = {}


def _moe(arch: str):
    """(jax cfg, port cfg, jax params, port params) for an MoE smoke
    config at float32."""
    if arch not in _MOE:
        import dataclasses
        from repro import configs as jconfigs
        from repro.models import lm as jlm
        from repro_torch import configs as tconfigs
        from repro_torch import convert
        jc = dataclasses.replace(jconfigs.get_smoke(arch), **F32)
        tc = dataclasses.replace(tconfigs.get_smoke(arch), **F32)
        jp = jax.jit(lambda k: jlm.init(jc, k).params)(jax.random.key(0))
        tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                       "cpu")
        _MOE[arch] = (jc, tc, jp, tp)
    return _MOE[arch]


@pytest.mark.parametrize("decode_mode", ["kernel", "gather"])
@pytest.mark.parametrize("arch", ["kimi_k2_1t_a32b", "arctic_480b"])
def test_kernel_decode_parity_moe_layer_offsets(arch, decode_mode):
    """Port of the reference's MoE layer-offset test: with a leading dense
    block stack (kimi: ``n_dense_layers=1``) the paged path's absolute
    layer index must address the right plane of the layered pool in both
    stacks.  The port's paged backend against its dense backend and
    against the JAX paged backend, three decode steps."""
    from repro.kvcache.backend import PagedBackend as JPagedBackend
    from repro.models import lm as jlm
    from repro_torch.kvcache.backend import make_backend
    from repro_torch.models import lm as tlm
    jc, tc, jp, tp = _moe(arch)
    assert tc.is_moe and (tc.n_dense_layers > 0) == (arch != "arctic_480b")
    toks = np.random.default_rng(3).integers(1, tc.vocab, (2, 9)) \
        .astype(np.int32)
    dense = make_backend(tc, "dense", batch=2, max_seq=24, device="cpu")
    paged = make_backend(tc, "paged", num_blocks=64, block_size=4,
                         decode_mode=decode_mode, device="cpu")
    jpaged = JPagedBackend(jc, num_blocks=64, block_size=4,
                           decode_mode=decode_mode)
    assert paged.pool.cfg.n_layers == tc.n_layers
    lg_d, _ = tlm.prefill(tp, tc, torch.from_numpy(toks), backend=dense)
    lg_p, _ = tlm.prefill(tp, tc, torch.from_numpy(toks), backend=paged)
    lg_j, _ = jlm.prefill(jp, jc, jnp.asarray(toks), backend=jpaged)
    np.testing.assert_allclose(lg_p.numpy(), lg_d.numpy(), **HTOL)
    np.testing.assert_allclose(lg_p.numpy(), np.asarray(lg_j), **HTOL)
    tok = lg_d[:, -1].argmax(-1).to(torch.int32)[:, None]
    for _ in range(3):
        lg_d, _ = tlm.decode_step(tp, tc, tok, dense)
        lg_p, _ = tlm.decode_step(tp, tc, tok, paged)
        lg_j, _ = jlm.decode_step(jp, jc, jnp.asarray(tok.numpy()), jpaged)
        np.testing.assert_allclose(lg_p.numpy(), lg_d.numpy(), **HTOL)
        np.testing.assert_allclose(lg_p.numpy(), np.asarray(lg_j), **HTOL)
        a = lg_d[:, -1].argmax(-1)
        assert torch.equal(a, lg_p[:, -1].argmax(-1))
        tok = a.to(torch.int32)[:, None]
    for b in (paged, jpaged):
        b.release()
        b.pool.check_invariants()
    assert paged.pool.num_live == 0


_DENSE_FAMILIES: dict = {}


def _dense_family(arch: str):
    """(jax cfg, port cfg, jax params, port params) of a dense-only smoke
    config (whisper-base: encoder-decoder; mamba2-370m: pure SSM;
    paligemma-3b: VLM, served as its text-only decoder) at float32."""
    if arch not in _DENSE_FAMILIES:
        import dataclasses
        from repro import configs as jconfigs
        from repro.models import lm as jlm
        from repro_torch import configs as tconfigs
        from repro_torch import convert
        jc = dataclasses.replace(jconfigs.get_smoke(arch), **F32)
        tc = dataclasses.replace(tconfigs.get_smoke(arch), **F32)
        jp = jax.jit(lambda k: jlm.init(jc, k).params)(jax.random.key(0))
        tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                       "cpu")
        _DENSE_FAMILIES[arch] = (jc, tc, jp, tp)
    return _DENSE_FAMILIES[arch]


@pytest.mark.parametrize("arch", ["whisper_base", "mamba2_370m",
                                  "paligemma_3b"])
def test_dense_backend_matches_jax_backend(arch):
    """``make_backend("dense", enc_len=...)`` against the JAX
    ``DenseBackend``: whisper's cache holds cross-attention K/V over its
    frames and its prefill takes the frame embeddings; mamba2's holds no
    K/V, only the SSM state and conv context; paligemma's holds the K/V
    of its one KV head, with no image prefix.  Prefill logits, every
    cache part and three decode steps agree."""
    from repro.kvcache.backend import DenseBackend as JDenseBackend
    from repro_torch.kvcache.backend import DenseBackend, make_backend
    jc, tc, jp, tp = _dense_family(arch)
    rng = np.random.default_rng(11)
    B, S, Smax = 2, 8, 12
    toks = rng.integers(1, tc.vocab, (B, S)).astype(np.int32)
    fe = None
    if tc.family == "encdec":
        fe = (0.02 * rng.standard_normal(
            (B, tc.frontend_seq, tc.d_model))).astype(np.float32)
    enc_len = 0 if fe is None else fe.shape[1]
    jb = JDenseBackend(jc, B, Smax, enc_len)
    tb = make_backend(tc, "dense", batch=B, max_seq=Smax, enc_len=enc_len,
                      device="cpu")
    assert isinstance(tb, DenseBackend)
    for name in ("k", "v", "ssm", "conv", "xk", "xv"):
        want = getattr(jb.cache, name)
        got = getattr(tb.cache, name)
        assert (got is None) == (want is None), name
        if want is not None:
            assert tuple(got.shape) == want.shape, name
    jl = jb.prefill(jp, jnp.asarray(toks),
                    frontend_emb=None if fe is None else jnp.asarray(fe))
    tl = tb.prefill(tp, torch.from_numpy(toks),
                    frontend_emb=None if fe is None else
                    torch.from_numpy(fe))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **HTOL)

    def same_cache():
        for name in ("k", "v", "ssm", "conv", "xk", "xv"):
            want = getattr(jb.cache, name)
            got = getattr(tb.cache, name)
            assert (got is None) == (want is None), name
            if want is not None:
                np.testing.assert_allclose(got.float().numpy(),
                                           np.asarray(want, np.float32),
                                           **HTOL)
        np.testing.assert_array_equal(tb.lengths, jb.lengths)
    same_cache()
    for _ in range(3):
        nxt = rng.integers(1, tc.vocab, (B, 1)).astype(np.int32)
        jl = jb.decode_step(jp, jnp.asarray(nxt))
        tl = tb.decode_step(tp, torch.from_numpy(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **HTOL)
        same_cache()


@pytest.mark.parametrize("arch", ["whisper_base", "mamba2_370m",
                                  "paligemma_3b"])
def test_paged_backend_refuses_dense_only_families(arch):
    from repro_torch.kvcache.backend import PagedBackend
    _, tc, _, _ = _dense_family(arch)
    with pytest.raises(ValueError, match="dense backend"):
        PagedBackend(tc, num_blocks=8, block_size=4, device="cpu")


def test_paged_prefill_refuses_a_frontend():
    """As the reference's: the paged backend keeps no frontend state."""
    from repro_torch import configs as tconfigs
    from repro_torch.kvcache.backend import PagedBackend
    from repro_torch.models import lm as tlm
    cfg = tconfigs.get_smoke("qwen1_5_0_5b")
    params = tlm.init(cfg, torch.Generator("cpu").manual_seed(0))
    pb = PagedBackend(cfg, num_blocks=8, block_size=4, device="cpu")
    with pytest.raises(ValueError, match="frontend"):
        pb.prefill(params, np.ones((1, 4), np.int32),
                   frontend_emb=torch.zeros(1, 2, cfg.d_model))


@pytest.mark.parametrize("decode_mode", ["gather", "kernel"])
def test_dense_paged_parity_sliding_window(decode_mode):
    """Port of the reference's pure-window case
    (``tests/test_kv_backend.py``): starcoder2's smoke config with every
    layer windowed (``sliding_window=5``), prefilled and decoded 7 steps
    past the window edge, so the mask cuts keys.  The port's paged
    backend against its dense backend (whose window is a tensor mask) and
    against the JAX paged backend on the same converted weights, in
    float32: the same logits and argmaxes at every step."""
    import dataclasses
    from repro import configs as jconfigs
    from repro.kvcache.backend import PagedBackend as JPagedBackend
    from repro.models import lm as jlm
    from repro_torch import configs as tconfigs
    from repro_torch import convert
    from repro_torch.kvcache.backend import make_backend
    from repro_torch.models import lm as tlm
    jc = dataclasses.replace(jconfigs.get_smoke("starcoder2_7b"),
                             sliding_window=5, **F32)
    tc = dataclasses.replace(tconfigs.get_smoke("starcoder2_7b"),
                             sliding_window=5, **F32)
    jp = jax.jit(lambda k: jlm.init(jc, k).params)(jax.random.key(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    toks = np.random.default_rng(11).integers(1, tc.vocab, (2, 9)) \
        .astype(np.int32)
    dense = make_backend(tc, "dense", batch=2, max_seq=24, device="cpu")
    paged = make_backend(tc, "paged", num_blocks=64, block_size=4,
                         decode_mode=decode_mode, device="cpu")
    jpaged = JPagedBackend(jc, num_blocks=64, block_size=4,
                           decode_mode=decode_mode)
    assert paged.decode_mode == decode_mode
    lg_d, _ = tlm.prefill(tp, tc, torch.from_numpy(toks), backend=dense)
    lg_p, _ = tlm.prefill(tp, tc, torch.from_numpy(toks), backend=paged)
    lg_j, _ = jlm.prefill(jp, jc, jnp.asarray(toks), backend=jpaged)
    np.testing.assert_allclose(lg_p.numpy(), lg_d.numpy(), **HTOL)
    np.testing.assert_allclose(lg_p.numpy(), np.asarray(lg_j), **HTOL)
    tok = lg_d[:, -1].argmax(-1).to(torch.int32)[:, None]
    for _ in range(7):          # lengths reach 16 >> window 5
        lg_d, _ = tlm.decode_step(tp, tc, tok, dense)
        lg_p, _ = tlm.decode_step(tp, tc, tok, paged)
        lg_j, _ = jlm.decode_step(jp, jc, jnp.asarray(tok.numpy()), jpaged)
        np.testing.assert_allclose(lg_p.numpy(), lg_d.numpy(), **HTOL)
        np.testing.assert_allclose(lg_p.numpy(), np.asarray(lg_j), **HTOL)
        a = lg_d[:, -1].argmax(-1)
        assert torch.equal(a, lg_p[:, -1].argmax(-1))
        tok = a.to(torch.int32)[:, None]
    for b in (paged, jpaged):
        b.release()
        b.pool.check_invariants()
    assert paged.pool.num_live == 0


# ---------------------------------------------------------------------------
# randomized alloc/share/free soak under the refcount sanitizer
# ---------------------------------------------------------------------------

def _soak(pool_mod, prefix_mod, refsan, steps=400):
    """The reference's ``test_soak_invariants`` on one package: 400
    randomized start / extend / fork / finish steps on a 96-block host
    pool with a small vocabulary (heavy prefix reuse), the package's
    ``refsan`` attached.  Checks as the reference does at every step
    (exact refcounts, shared blocks never mutated, the full sweep every
    25 steps) and returns the allocator state after every step."""
    rng = np.random.default_rng(7)
    pool = pool_mod.BlockPool(pool_mod.PoolConfig(num_blocks=96,
                                                  block_size=4))
    cache = prefix_mod.PrefixCache(4)
    cache.attach(pool)
    san = refsan.attach(pool)           # shadow refcounts with provenance
    vocab = 30
    live: list = []
    shared: dict = {}
    states = []
    for step in range(steps):
        op = rng.random()
        if op < 0.35 and pool.can_alloc(6):
            toks = rng.integers(1, vocab, int(rng.integers(3, 14))).tolist()
            bids, n = cache.match(toks, pool)
            t = prefix_mod.BlockTable(list(bids), n)
            try:
                t.extend(pool, toks[n:], seq_tokens=toks, cache=cache)
            except RuntimeError:        # pool momentarily full: roll back
                cache.release(t, pool)
                continue
            live.append((t, toks))
        elif op < 0.55 and live:
            t, toks = live[int(rng.integers(len(live)))]
            new = rng.integers(1, vocab, int(rng.integers(1, 4))).tolist()
            pre = t.num_tokens
            try:
                t.extend(pool, new, seq_tokens=toks + new, cache=cache)
                toks.extend(new)
            except RuntimeError:        # partial extension: resync tokens
                toks.extend(new[:t.num_tokens - pre])
        elif op < 0.7 and live:
            t, toks = live[int(rng.integers(len(live)))]
            live.append((t.fork(pool), list(toks)))
        elif live:
            t, _ = live.pop(int(rng.integers(len(live))))
            cache.release(t, pool)
        for bid in range(pool.cfg.num_blocks):     # CoW never mutates
            if pool.refcount[bid] > 1:
                assert shared.setdefault(bid, pool.content[bid]) == \
                    pool.content[bid], f"shared block {bid} mutated"
            else:
                shared.pop(bid, None)
        exp = np.zeros(pool.cfg.num_blocks, np.int32)
        for t, _ in live:
            for b in t.blocks:
                exp[b] += 1
        np.testing.assert_array_equal(pool.refcount, exp)
        if step % 25 == 0:
            pool.check_invariants()
        states.append((pool.used.tolist(), pool.refcount.tolist(),
                       pool.arrival.tolist(), pool.last_use.tolist(),
                       list(pool.content), list(pool._evictable),
                       pool.placement.free_ids(), pool.stats.as_dict(),
                       [(list(t.blocks), t.num_tokens) for t, _ in live]))
    for t, _ in live:
        cache.release(t, pool)
    pool.check_invariants()
    assert pool.num_live == 0
    assert pool.num_free + pool.num_cached == pool.cfg.num_blocks
    report = san.report(quiesced=True)
    san.check(quiesced=True)            # no leaks, no double-frees, no UAF
    san.detach()
    pool.alloc(pool.cfg.num_blocks)     # the cached set drains too
    assert pool.num_cached == 0 and len(cache) == 0
    return states, report


def test_soak_invariants():
    """No leak, no double-free, exact refcounts, CoW never mutates a shared
    block under randomized traffic on the port's pool, under the port's
    ``refsan``; the allocator state after every step, and the sanitizer's
    final report, are the reference's on the same seed."""
    from repro.analysis import refsan as jrefsan
    from repro_torch.analysis import refsan as trefsan
    want = _soak(jpool, jprefix, jrefsan)
    got = _soak(tpool, tprefix, trefsan)
    assert len(got[0]) == len(want[0]) > 300
    for step, (g, w) in enumerate(zip(*(s[0] for s in (got, want)))):
        assert g == w, f"allocator state differs after step {step}"
    assert got[1] == want[1] and got[1]["ok"]


# ---------------------------------------------------------------------------
# the DRAM-model acceptance tests of ``tests/test_kvcache.py``, on the port
# (``core.dram.simulate`` through the channel kernel's plain twin), and the
# port's simulated benchmark rows against the reference's and the baseline
# ---------------------------------------------------------------------------

import dataclasses  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

from repro_torch.benchmarks import kvcache_sim  # noqa: E402
from repro_torch.benchmarks import run as bench_run  # noqa: E402
from repro_torch.core import dram as tdram  # noqa: E402

BASELINE = Path(__file__).resolve().parents[1] / "results" \
    / "bench_baseline.json"


def _tchurn(placement, seed=0, n=256, n_live=12):
    """The reference test's ``_churn`` on the port's pool."""
    rng = np.random.default_rng(seed)
    pool = tpool.BlockPool(tpool.PoolConfig(num_blocks=n, block_size=4,
                                            placement=placement))
    cache = tprefix.PrefixCache(4)
    cache.attach(pool)
    live = []
    for _ in range(300):
        if live and (len(live) >= n_live or rng.random() < 0.5):
            t = live.pop(int(rng.integers(len(live))))
            for b in t.blocks:
                pool.decref(b)
        else:
            t = tprefix.BlockTable()
            for _ in range(int(rng.integers(2, 8))):
                t.blocks.append(pool.alloc(1, hint_blocks=t.blocks)[0])
            t.num_tokens = len(t.blocks) * pool.cfg.block_size
            live.append(t)
    while len(live) < n_live:
        t = tprefix.BlockTable()
        for _ in range(int(rng.integers(2, 8))):
            t.blocks.append(pool.alloc(1, hint_blocks=t.blocks)[0])
        live.append(t)
    pool.check_invariants()
    return pool, live


def test_mars_placement_bandwidth_at_least_naive():
    """Acceptance: MARS-placed >= naive-placed achieved bandwidth through
    the port's DRAM model (seed-averaged decode-batch gather)."""
    gbps = {"mars": [], "naive": []}
    for seed in (0, 1):
        for placement in gbps:
            _, live = _tchurn(placement, seed=seed)
            trace = tops.kv_read_trace(live, grant_beats=2)
            gbps[placement].append(
                tdram.simulate(trace, device="cpu").achieved_gbps)
    assert np.mean(gbps["mars"]) >= np.mean(gbps["naive"])


def test_kernel_path_row_hits_at_least_gather():
    """Acceptance: the reference kernel's sequence-major page walk hits
    the row buffer at least as often as the gather path's round-robin
    lane interleave, on both placements, and at least matches its
    bandwidth; a 64-token window shortens the walk."""
    kb = kvcache_sim
    for placement in ("naive", "mars"):
        res = kb.decode_path_comparison(placement=placement, device="cpu")
        assert kb.row_hit_rate(res["kernel"]) >= \
            kb.row_hit_rate(res["gather"]), placement
        assert res["kernel"].achieved_gbps >= \
            res["gather"].achieved_gbps * 0.99, placement
    res = kb.decode_path_comparison(placement="mars", window_tokens=64,
                                    device="cpu")
    assert kb.row_hit_rate(res["kernel"]) >= kb.row_hit_rate(res["gather"])
    full = kb.decode_path_comparison(placement="mars", device="cpu")
    assert res["kernel"].n_requests < full["kernel"].n_requests, \
        "window page gate did not shorten the kernel's address stream"
    assert res["gather"].n_requests == full["gather"].n_requests


def _fields(res) -> dict:
    """Every field of a result dict's DramResults (or their sharded
    aggregate), per-shard results included."""
    out = {}
    for k, r in res.items():
        d = dataclasses.asdict(r)
        if "per_shard" in d:
            d["per_shard"] = [sorted(s.items()) for s in d["per_shard"]]
        out[k] = d
    return out


@pytest.mark.parametrize("fn", ["placement", "decode", "decode_window",
                                "sharded", "tier"])
def test_simulated_rows_equal_the_reference_functions(fn):
    """Each function behind the smoke pass's simulated rows gives the
    reference's ``benchmarks/kvcache_bench.py`` results exactly."""
    import benchmarks.kvcache_bench as jkb
    calls = {"placement": ("placement_comparison", dict(n_live=8)),
             "decode": ("decode_path_comparison", dict(placement="naive")),
             "decode_window": ("decode_path_comparison",
                               dict(window_tokens=64)),
             "sharded": ("sharded_placement_comparison", dict(n_shards=2)),
             "tier": ("tiered_promotion_comparison", {})}
    name, kw = calls[fn]
    want = getattr(jkb, name)(**kw)
    got = getattr(kvcache_sim, name)(device="cpu", **kw)
    assert _fields(got) == _fields(want)


@pytest.fixture(scope="module")
def smoke_rows():
    rows = []
    kvcache_sim.run(lambda name, us, derived="": rows.append(
        {"name": name, "us_per_call": us, "derived": derived}),
        smoke=True, device="cpu")
    return rows


def test_smoke_rows_equal_the_baseline(smoke_rows):
    """The 19 simulated keys of ``results/bench_baseline.json`` (placement
    lanes8, decode gather and kernel, sharded shards2, tier promote), each
    at its printed precision, and no other row."""
    baseline = json.loads(BASELINE.read_text())
    sim_keys = sorted(k for k in baseline if bench_run.SIMULATED.match(k))
    assert len(sim_keys) == 19
    assert sorted(r["name"] for r in smoke_rows) == sim_keys
    assert bench_run.check_baseline(smoke_rows, baseline) == []
    got = {r["name"]: r["derived"] for r in smoke_rows}
    assert got["kvcache/placement/mars/lanes8"] == "51.02GB/s"
    assert got["kvcache/placement/naive/lanes8"] == "45.73GB/s"
    assert got["kvcache/placement/uplift/lanes8"] == "11.59%"


def test_baseline_check_catches_a_changed_row(smoke_rows):
    baseline = json.loads(BASELINE.read_text())
    changed = dict(baseline)
    changed["kvcache/decode/kernel/mars/rowhit"] += 0.01
    fails = bench_run.check_baseline(smoke_rows, changed)
    assert len(fails) == 1 and "kernel/mars/rowhit" in fails[0]
    missing = [r for r in smoke_rows
               if r["name"] != "kvcache/tier/promote/mars/rowhit"]
    fails = bench_run.check_baseline(missing, baseline)
    assert len(fails) == 1 and "missing" in fails[0]
    # rows outside the simulated names are not this runner's to check
    assert bench_run.check_baseline(smoke_rows, {
        "kvcache/alloc/single/locality": 1.0}) == []


def test_run_cli_smoke_against_the_baseline(tmp_path, capsys):
    """``python -m repro_torch.benchmarks.run --smoke --device cpu
    --baseline results/bench_baseline.json`` passes; a snapshot with one
    changed simulated row fails it."""
    assert bench_run.main(["--smoke", "--device", "cpu", "--baseline",
                           str(BASELINE)]) == 0
    out = capsys.readouterr()
    assert out.out.startswith("name,us_per_call,derived\n")
    assert "baseline check passed (19 simulated keys equal)" in out.err
    bad = json.loads(BASELINE.read_text())
    bad["kvcache/placement/uplift/lanes8"] = 11.6
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(bad))
    assert bench_run.main(["--smoke", "--device", "cpu", "--only",
                           "kvcache", "--baseline", str(path)]) == 1
    assert "DIFFERENT kvcache/placement/uplift/lanes8" in \
        capsys.readouterr().err


def test_run_cli_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        bench_run.main(["--smoke"])
