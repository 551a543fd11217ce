"""The port's tensor parallelism over ``model`` (``rules.model_cut``, the
layers' cut paths, ``serve.step`` over a mesh) against one process, on
gloo groups of 2 and 4 fresh processes, in float32, inputs from numpy
seeds.

- Each cut layer's output and gradients (its input's and every leaf's,
  the ranks' parts put together) within ``REL`` of the one-process
  layer's: attention with heads that divide, with KV heads shared by
  ranks, with uneven heads and a rank with none; the MLP; the
  vocabulary-parallel embedding and cross-entropy at an even and an
  uneven vocabulary; the SSM block (its grouped norm summed over
  ``model``), also with 2 SSM heads on 4 ranks (two ranks with none);
  cross-attention.
- ``dtensor.fetch`` and ``dtensor.return_grad`` on every leaf of four
  smoke configs over 4 processes (model 4, and data 2 x model 2):
  exactly each rank's cut, the cut gradients summed back to each
  placement, and no collective larger than the rank's cut or stored
  part (leaves stored off their cut travel by an all-to-all); a whole
  training step with a rank of no heads.
- The 2-rank ``lm.forward`` logits against the JAX package's
  ``lm.forward`` on the converted reference init (qwen, hymba and
  paligemma smoke, paligemma with its image prefix).
- Serving over a cache cut by heads (qwen), by sequence
  (paligemma's one KV head on 2 ranks, deepseek's two on 4) and an SSM
  state cut by heads (mamba2): a prefill and decode steps whose greedy
  tokens equal one process's and the JAX package's ``make_prefill`` /
  ``make_decode_step``'s, logits within ``REL``.
"""
import contextlib
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from torch_procs import run_ranks  # noqa: E402

REL = 1e-5
F32 = dict(param_dtype="float32", compute_dtype="float32")

# (case, layer, config, replaced fields): run on the mesh (1, world)
LAYERS = {2: [("heads_divide", "attn", "qwen1_5_0_5b", {}),
              ("mlp", "mlp", "qwen1_5_0_5b", {}),
              ("vocab_256", "vocab", "qwen1_5_0_5b", {"vocab": 256}),
              ("ssm", "ssm", "mamba2_370m", {}),
              ("cross", "xattn", "whisper_base", {})],
          4: [("kv_shared", "attn", "qwen1_5_0_5b", {"n_kv_heads": 2}),
              ("uneven_empty", "attn", "qwen1_5_0_5b",
               {"n_heads": 6, "n_kv_heads": 2}),
              ("vocab_250", "vocab", "qwen1_5_0_5b", {"vocab": 250}),
              ("ssm_empty", "ssm", "mamba2_370m",
               {"ssm_expand": 1, "d_ssm_head": 32})]}
FORWARD = ["qwen1_5_0_5b", "hymba_1_5b", "paligemma_3b"]
# (config, ranks on model): the cache cut by heads / by sequence
SERVE = {2: ["qwen1_5_0_5b", "paligemma_3b", "mamba2_370m"],
         4: ["deepseek_coder_33b"]}
B, S, STEPS = 3, 16, 4


def _cfg(arch, **fields):
    return dataclasses.replace(tconfigs.get_smoke(arch), **F32, **fields)


def _mesh(world):
    from repro_torch.launch import mesh as tmesh
    return tmesh.on_processes(tmesh.Mesh(("data", "model"),
                                         {"data": 1, "model": world}, ()))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _layer_params(kind, cfg, rng):
    """(whole leaves, their logical axes) of one layer, numpy normal *
    0.1 in float32 (``d_skip`` about 1)."""
    from repro_torch.models import layers, ssm
    init = {"attn": layers.attention_init, "xattn": layers.attention_init,
            "mlp": lambda g, c: layers.mlp_init(g, c),
            "vocab": lambda g, c: layers.embedding_init(g, c),
            "ssm": lambda g, c: ssm.ssm_init(g, c)}[kind]
    axes = init(layers.SPECS, cfg)
    shapes = {k: tuple(v.shape) for k, v in
              init(torch.Generator(), cfg).items()}
    leaves = {k: torch.from_numpy((0.1 * rng.standard_normal(shapes[k])
                                   + (k == "d_skip")).astype(np.float32))
              for k in shapes}
    return leaves, axes


def _layer_fn(kind, cfg):
    """``f(params, inputs)``: the layer's output (a loss term for
    ``vocab``), whose sum against a fixed gradient is the objective."""
    from repro_torch.models import layers, lm, ssm
    from repro_torch.sharding import dtensor

    def attn(p, x, enc):
        pos = torch.arange(x.shape[1])[None].expand(x.shape[0], -1)
        return layers.attention_apply(p, x, cfg, positions=pos,
                                      mask=layers.CAUSAL)[0]

    def xattn(p, x, enc):
        return layers.attention_apply(p, x, cfg, positions=None, mask=None,
                                      xattn_kv=layers.cross_kv(p, enc,
                                                               cfg))[0]

    def vocab(p, ids, labels):
        x = layers.embed_tokens(p, ids, cfg)
        tp = dtensor.model_rank()
        if tp is None:
            ll = torch.log_softmax(layers.lm_head(p, x, cfg), -1)
            return -torch.gather(ll, -1, labels[..., None])[..., 0]
        return lm._vocab_parallel_nll(
            layers.lm_head(p, x, cfg, whole=False), labels, cfg, tp)
    return {"attn": attn, "xattn": xattn, "vocab": vocab,
            "mlp": lambda p, x, _: layers.mlp_apply(p, x, cfg),
            "ssm": lambda p, x, _: ssm.ssm_apply(p, x, cfg)}[kind]


def _run_layer(kind, cfg, params, inputs, gy, cuts=None):
    """The objective's output and gradients (the input's first, then
    every leaf's cut), the params cut by ``cuts`` when given."""
    from repro_torch.sharding import dtensor
    p = {k: (v if cuts is None else dtensor.take_cut(v, cuts[k]))
         .clone().requires_grad_() for k, v in params.items()}
    xs = [t.clone().requires_grad_() if t.is_floating_point() else t
          for t in inputs]
    out = _layer_fn(kind, cfg)(p, *xs)
    ws = [t for t in xs if t.requires_grad] + list(p.values())
    grads = torch.autograd.grad((out * gy).sum(), ws, allow_unused=True,
                                materialize_grads=True)
    return out.detach(), grads[:len(ws) - len(p)], dict(
        zip(p, grads[len(ws) - len(p):]))


def _whole_grad(g, cut, shape, mesh):
    """A leaf's gradient put together over ``model`` from the ranks'
    cuts' (a whole leaf's is whole on every rank)."""
    from repro_torch.sharding import dtensor
    d = dtensor._cut_dim(cut)
    if d is None:
        return g
    full = g.new_zeros(shape)
    full.index_copy_(d, dtensor._cut_index(cut[d], g.device), g)
    return dtensor.all_sum(full, mesh, ("model",))


def _layer_rank(rank, world, out):
    from repro_torch.sharding import context as shctx
    from repro_torch.sharding import rules
    mesh = _mesh(world)
    res = {}
    for case, kind, arch, fields in LAYERS[world]:
        cfg = _cfg(arch, **fields)
        rng = np.random.default_rng(7)
        params, axes = _layer_params(kind, cfg, rng)
        if kind == "vocab":
            ids = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
            inputs = [ids, torch.from_numpy(rng.integers(0, cfg.vocab,
                                                         (2, 16)))]
            gy = torch.from_numpy(rng.standard_normal((2, 16))
                                  .astype(np.float32))
        else:
            x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
            enc = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
            inputs = [torch.from_numpy(x), torch.from_numpy(enc)]
            gy = torch.from_numpy(rng.standard_normal(
                (2, 16, cfg.d_model)).astype(np.float32))
        want = _run_layer(kind, cfg, params, inputs, gy)
        cuts = {k: rules.model_cut(axes[k], tuple(v.shape), cfg, world,
                                   rank) for k, v in params.items()}
        with shctx.use_mesh(mesh):
            got = _run_layer(kind, cfg, params, inputs, gy, cuts)
        errs = {"out": _rel(got[0], want[0])}
        for i, (g, w) in enumerate(zip(got[1], want[1])):
            errs[f"input{i}"] = _rel(g, w)
        for k, g in got[2].items():
            errs[k] = _rel(_whole_grad(g, cuts[k], params[k].shape, mesh),
                           want[2][k])
        res[case] = dict(errs=errs, cut_heads=next(
            (c[0] for c in cuts.get("wq", ()) if c is not None), None))
    with open(f"{out}/layers_{world}_{rank}.json", "w") as f:
        json.dump(res, f)


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


@pytest.fixture(scope="module")
def layer_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_layers")
    for world in LAYERS:
        run_ranks(_layer_rank, world, out, str(out))
    return {(w, r): json.loads((out / f"layers_{w}_{r}.json").read_text())
            for w in LAYERS for r in range(w)}


@pytest.mark.parametrize("world,case", [(w, c[0]) for w, cs in
                                        LAYERS.items() for c in cs])
def test_cut_layer_matches_one_process(layer_runs, world, case):
    for r in range(world):
        errs = layer_runs[(world, r)][case]["errs"]
        bad = {k: e for k, e in errs.items() if not e <= REL}
        assert not bad, (case, r, bad)


def test_uneven_heads_leave_a_rank_empty(layer_runs):
    """6 query heads on 4 ranks: 2, 2, 2 and none (the ceil split), so
    the last rank computes no head and contributes zeros."""
    got = [layer_runs[(4, r)]["uneven_empty"]["cut_heads"] for r in
           range(4)]
    assert got == [[0, 2], [2, 4], [4, 6], [6, 6]]


def test_model_cut_of_the_production_configs():
    """The production cuts: 56 heads on 16 ranks give 4 a rank and
    none to ranks 14 and 15, the 8 KV heads shared by rank pairs; hymba's
    25 heads 2 a rank on 13 ranks; qwen's vocabulary 151936 halved; an
    SSM's ``w_zx`` cut in both halves; experts that do not divide
    raise."""
    from repro_torch.sharding import rules
    ds = tconfigs.get("deepseek_coder_33b")
    heads = [rules.head_range(ds, 16, r) for r in range(16)]
    assert heads[0] == (0, 4) and heads[13] == (52, 56)
    assert heads[14] == heads[15] == (56, 56)
    assert [rules.kv_range(ds, 16, r) for r in (0, 1, 2, 13)] == \
        [(0, 1), (0, 2), (1, 2), (7, 8)]
    hy = tconfigs.get("hymba_1_5b")
    counts = [b - a for a, b in (rules.head_range(hy, 16, r)
                                 for r in range(16))]
    assert counts == [2] * 12 + [1, 0, 0, 0]
    qw = tconfigs.get("qwen1_5_0_5b")
    assert rules.model_cut(("vocab", "embed"), (151936, 1024), qw, 2, 1) \
        == (((75968, 151936),), None)
    mb = tconfigs.get("mamba2_370m")
    d_in, P = mb.d_inner_ssm, mb.d_ssm_head
    assert rules.model_cut(("layers", "embed", "ssm_in"),
                           (48, 1024, 2 * d_in), mb, 16, 1)[2] == \
        ((2 * P, 4 * P), (d_in + 2 * P, d_in + 4 * P))
    arc = tconfigs.get("arctic_480b")
    assert rules.model_cut(("layers", "embed", "expert"), (35, 7168, 128),
                           arc, 16, 3) == (None, None, None)
    with pytest.raises(ValueError, match="experts"):
        rules.model_cut(("expert", "embed", "mlp"), (128, 8, 8), arc, 3, 0)


# ---------------------------------------------------------------------------
# Fetching cuts from the storage, returning their gradients
# ---------------------------------------------------------------------------

# (config, mesh (data, model)): storage off the cut (deepseek's and
# starcoder2's heads on 4 ranks stored over the head dim, KV heads
# shared), ``w_zx``'s two ranges and uneven heads (hymba), a vocabulary
# stored whole over ``model`` (whisper), each also over 2 data rows
EXCHANGE = [(a, m) for m in ((1, 4), (2, 2)) for a in
            ("deepseek_coder_33b", "starcoder2_7b", "hymba_1_5b",
             "whisper_base")]


def _exchange_rank(rank, world, out):
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import lm
    from repro_torch.sharding import dtensor, rules
    from repro_torch.train import step as tstep
    from repro_torch.utils import collectives
    from repro_torch.utils.tree import leaf_paths
    res = {}
    for arch, (nd, nm) in EXCHANGE:
        cfg = _cfg(arch)
        mesh = tmesh.on_processes(tmesh.Mesh(
            ("data", "model"), {"data": nd, "model": nm}, ()))
        here = dtensor.coords(mesh)
        whole = {k: v.detach() for k, v in leaf_paths(
            lm.init(cfg, torch.Generator().manual_seed(0)))}
        shard = rules.param_shardings(lm.param_specs(cfg), _nest(whole),
                                      mesh, fsdp=True)
        placed = _nest({name: dtensor.distribute(dtensor.local_part(
            w.detach(), tstep._at(shard, name), mesh),
            tstep._at(shard, name), mesh) for name, w in whole.items()})
        cuts = tstep.model_cuts(cfg, mesh, placed)
        errs, worst = {}, 0.0
        for name, w in whole.items():
            p, cut = tstep._at(placed, name), tstep._at(cuts, name)
            spec = tstep._at(shard, name)
            with collectives.record() as rec:
                got = dtensor.fetch(p, mesh, cut)
            errs[f"fetch/{name}"] = float((got - dtensor.take_cut(
                w, cut[here["model"]])).abs().max()) if got.numel() else 0.

            def grad_of(data, model):
                """Rank (data, model)'s gradient of its cut: a whole
                leaf's alike on a data row's model ranks."""
                c = cut[model]
                seed = data * nm + model if dtensor._cut_dim(c) is not None \
                    else data
                return torch.from_numpy(np.random.default_rng(seed)
                                        .standard_normal(rules.cut_shape(
                                            c, w.shape)).astype(np.float32))
            with collectives.record() as back:
                g = dtensor.return_grad(grad_of(here["data"], here["model"]),
                                        p, mesh, cut, ("data",)).to_local()
            want = torch.zeros(w.shape)
            for q in range(nd * nm):
                dq, mq = divmod(q, nm)
                c = cut[mq]
                d = dtensor._cut_dim(c)
                if d is None:
                    if mq == 0:
                        want += grad_of(dq, mq)
                    continue
                want.index_add_(d, dtensor._cut_index(c[d], "cpu"),
                                grad_of(dq, mq))
            errs[f"grad/{name}"] = _rel(g, dtensor.local_part(want, spec,
                                                              mesh))
            # only cuts travel: no call moves more than this rank's cut
            # (whole over the data axes) or its stored part
            bound = max(math.prod(rules.cut_shape(cut[here["model"]],
                                                  w.shape)),
                        p.to_local().numel()) * w.element_size()
            worst = max([worst] + [c.bytes / bound
                                   for c in rec.calls + back.calls])
        res[f"{arch}/{nd}x{nm}"] = dict(errs=errs, worst=worst)
    with open(f"{out}/exchange_{rank}.json", "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def exchange_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_exchange")
    run_ranks(_exchange_rank, 4, out, str(out))
    return [json.loads((out / f"exchange_{r}.json").read_text())
            for r in range(4)]


@pytest.mark.parametrize("arch,mesh", EXCHANGE)
def test_fetch_and_return_grad_move_only_cuts(exchange_runs, arch, mesh):
    """``dtensor.fetch`` gives each rank exactly its cut of the whole
    leaf, and ``dtensor.return_grad`` the ranks' cut gradients summed
    over the data axes and the ranks whose cuts overlap, at the leaf's
    placement; no collective of either moves more than the rank's cut
    or its stored part."""
    key = f"{arch}/{mesh[0]}x{mesh[1]}"
    for r, run in enumerate(exchange_runs):
        errs = run[key]["errs"]
        bad = {k: e for k, e in errs.items()
               if not e <= (0 if k.startswith("fetch") else REL)}
        assert not bad, (key, r, bad)
        assert run[key]["worst"] <= 1, (key, r, run[key]["worst"])


@contextlib.contextmanager
def _six_heads():
    """The sharded-step tests' configs with 6 query heads over 2 KV
    heads: on 4 model ranks 2, 2, 2 and none."""
    import test_torch_sharded_train as sharded
    real = sharded._cfg
    sharded._cfg = lambda arch: dataclasses.replace(real(arch), n_heads=6,
                                                    n_kv_heads=2)
    try:
        yield sharded
    finally:
        sharded._cfg = real


def _empty_rank_step(rank, world, out):
    with _six_heads() as sharded:
        res = sharded.one_step("qwen1_5_0_5b", (1, 4), 1, "adamw")
    if rank == 0:
        torch.save(res, f"{out}/empty_rank.pt")


def test_whole_step_with_an_empty_rank(tmp_path):
    """A training step of 6 heads on 4 model ranks, the last with none:
    its empty cuts get empty gradients and every other leaf is reached
    (the step raises for a leaf the loss does not reach); the loss and
    every gradient within ``REL`` of one process."""
    run_ranks(_empty_rank_step, 4, tmp_path, str(tmp_path))
    got = torch.load(tmp_path / "empty_rank.pt")
    with _six_heads() as sharded:
        want = sharded.one_step("qwen1_5_0_5b", None, 1, "adamw")
    assert abs(got["loss"] - want["loss"]) <= REL * abs(want["loss"])
    for name, w in want["grads"].items():
        assert _rel(got["grads"][name], w) <= REL, name


# ---------------------------------------------------------------------------
# Whole models: forward against JAX, serving
# ---------------------------------------------------------------------------

def _jax_model(arch):
    jc = dataclasses.replace(jconfigs.get_smoke(arch), **F32)
    jp = jax.jit(lambda k: jlm.init(jc, k).params)(jax.random.key(0))
    return jc, jax.tree.map(np.asarray, jp)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def _nest(flat):
    out = {}
    for name, v in flat.items():
        *head, last = name.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _port_params(out, arch):
    from repro_torch import convert
    with np.load(f"{out}/{arch}.npz") as z:
        tree = _nest({k: z[k] for k in z.files})
    return convert.params_from_numpy(tree, _cfg(arch), "cpu")


def _prompt(cfg, seed=3):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab, (B, S)).astype(np.int32)


def _image(cfg):
    return (0.02 * np.random.default_rng(11).standard_normal(
        (B, cfg.frontend_seq, cfg.d_model))).astype(np.float32)


def _serve(cfg, params, prompt, mesh=None):
    """A prefill and ``STEPS - 1`` greedy decode steps: (the tokens, the
    logits of each step)."""
    from repro_torch.serve import step as sstep
    if mesh is not None:
        params = sstep.cut_params(cfg, mesh, sstep.place(cfg, params, mesh))
    logits, cache = sstep.make_prefill(cfg, S + STEPS, mesh)(
        params, torch.from_numpy(prompt))
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    toks, logs = [tok], [logits]
    step = sstep.make_decode_step(cfg, mesh)
    for _ in range(STEPS - 1):
        tok, logits, cache = step(params, cache, tok)
        toks.append(tok)
        logs.append(logits)
    return torch.cat(toks, 1).numpy(), [t.numpy() for t in logs]


def _model_rank(rank, world, out):
    from repro_torch.models import lm
    from repro_torch.serve import step as sstep
    from repro_torch.sharding import context as shctx
    mesh = _mesh(world)
    res = {}
    if world == 2:
        for arch in FORWARD:
            cfg = _cfg(arch)
            work = sstep.cut_params(cfg, mesh, sstep.place(
                cfg, _port_params(out, arch), mesh))
            fe = _image(cfg) if cfg.family == "vlm" else None
            with shctx.use_mesh(mesh), torch.no_grad():
                res[f"forward/{arch}"] = lm.forward(
                    work, cfg, torch.from_numpy(_prompt(cfg)),
                    None if fe is None else torch.from_numpy(fe)).numpy()
    for arch in SERVE[world]:
        cfg = _cfg(arch)
        toks, logs = _serve(cfg, _port_params(out, arch), _prompt(cfg),
                            mesh)
        res[f"tokens/{arch}"] = toks
        for i, t in enumerate(logs):
            res[f"logits/{arch}/{i}"] = t
    if rank == 0:
        np.savez(f"{out}/ranks_{world}.npz", **res)


@pytest.fixture(scope="module")
def model_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_models")
    jax_side = {}
    for arch in sorted(set(FORWARD) | {a for v in SERVE.values()
                                       for a in v}):
        jc, jp = _jax_model(arch)
        np.savez(out / f"{arch}.npz", **_flat(jp))
        prompt = jnp.asarray(_prompt(jc))
        if arch in FORWARD:
            fe = jnp.asarray(_image(jc)) if jc.family == "vlm" else None
            jax_side[f"forward/{arch}"] = np.asarray(
                jlm.forward(jp, jc, prompt, fe)[0])
        logits, cache = jstep.make_prefill(jc, S + STEPS)(jp, prompt)
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        toks, step = [tok], jstep.make_decode_step(jc)
        for _ in range(STEPS - 1):
            tok, logits, cache = step(jp, cache, tok)
            toks.append(tok)
        jax_side[f"tokens/{arch}"] = np.asarray(jnp.concatenate(toks, 1))
    for world in SERVE:
        run_ranks(_model_rank, world, out, str(out))
    ranks = {}
    for world in SERVE:
        with np.load(out / f"ranks_{world}.npz") as z:
            ranks.update({k: z[k] for k in z.files})
    return out, jax_side, ranks


@pytest.mark.parametrize("arch", FORWARD)
def test_two_rank_forward_matches_jax(model_runs, arch):
    _, jax_side, ranks = model_runs
    got, want = ranks[f"forward/{arch}"], jax_side[f"forward/{arch}"]
    assert got.shape == want.shape == (B, S, _cfg(arch).vocab)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", [a for v in SERVE.values() for a in v])
def test_cut_serving_matches_one_process_and_jax(model_runs, arch):
    """Greedy tokens equal one process's and the JAX package's; each
    step's logits within ``REL`` of one process's."""
    out, jax_side, ranks = model_runs
    cfg = _cfg(arch)
    toks, logs = _serve(cfg, _port_params(out, arch), _prompt(cfg))
    np.testing.assert_array_equal(ranks[f"tokens/{arch}"], toks)
    np.testing.assert_array_equal(toks, jax_side[f"tokens/{arch}"])
    for i, want in enumerate(logs):
        assert _rel(torch.from_numpy(ranks[f"logits/{arch}/{i}"]),
                    torch.from_numpy(want)) <= REL, (arch, i)


def test_the_serve_cases_cut_the_cache_as_named():
    """qwen's 4 KV heads divide 2 ranks (the cache cut by heads);
    paligemma's one on 2 and deepseek's two on 4 do not (cut by
    sequence); mamba2's 8 SSM heads divide 2."""
    from repro_torch.launch import mesh as tmesh
    from repro_torch.sharding import rules

    def spec(arch, n):
        m = tmesh.Mesh(("data", "model"), {"data": 1, "model": n}, ())
        return rules.cache_shardings(m, _cfg(arch), B)
    assert spec("qwen1_5_0_5b", 2).k[3] == "model"
    assert spec("paligemma_3b", 2).k[2] == "model"
    assert spec("deepseek_coder_33b", 4).k[2] == "model"
    assert spec("mamba2_370m", 2).ssm[2] == "model"
