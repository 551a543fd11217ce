"""Repo-specific static lint pass (AST-only, never imports checked code;
port of ``repro/analysis/lint.py``, its rules' findings word for word).

The rules encode serving-stack protocol invariants that a generic linter
cannot know about.  Each rule has a kebab-case name; suppress a finding
by appending ``# lint: ok(rule-name)`` (or bare ``# lint: ok``) to the
flagged line — suppressions are for *deliberate* violations only, e.g.
deprecation-coverage tests.

Rules
-----
pool-kv-mutation
    ``k_pages``/``v_pages``/``dirty`` may only be mutated by
    ``BlockPool`` itself (``write_kv``/``copy_block``/``drain_dirty``/
    ``_free_block``/``forget_dirty``/``__init__``).  Anything else
    bypasses the dirty-block staging contract and the write lands on
    the host copy but never reaches the device mirror.

flush-barrier
    In pipelined backends (classes that define ``_commit_pending``),
    ``fork_seq``/``free_seq``/``prefill``/``new_seq``/``_add_seqs``
    must reach ``self.flush()`` (or delegate to a flushing method)
    before touching backend state, and ``release`` must drain the
    in-flight step (``flush``/``sync``+``_commit_pending``) before
    tearing down.  Otherwise CoW forks or frees race the one-step-
    lagged KV write-back.

positional-pool
    ``PagedBackend``/``ShardedPagedBackend`` must be constructed via
    ``make_backend(...)`` or keyword arguments; ≥2 positional args hit
    the deprecated legacy signature.

dense-kv-read
    ``DenseBackend.k``/``.v`` reads are deprecated; use
    ``kv_for_layer(l)``.  Flagged when the receiver was assigned from
    ``DenseBackend(...)``/``make_backend(...)``/``init_cache(...)`` in
    the same scope.

drain-dirty-consumer
    ``drain_dirty()`` is destructive (clears the staging set); under
    ``src/`` only the backend staging path (``kvcache/backend.py``,
    ``kvcache/pool.py``) may call it.  A second consumer silently
    steals the other's staged writes.

The reference's sixth rule, ``pallas-fetch-gate``, checks the index maps
of Pallas ``BlockSpec``s; the port has none (its kernels are CUDA, whose
bounds ``chip_smoke.py``'s edge cases hold), so it is not carried.

CLI: ``python -m repro_torch.analysis.lint [paths] [--json PATH]
[--list-rules]`` prints ``path:line:col: [rule] message`` per finding
and exits 1 when anything is found (0 on a clean tree), with
``tools/lint.py``'s JSON summary; paths default to ``src tests`` under
the checkout, and ``lint_fixtures`` directories are skipped.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import re

RULES = {
    "pool-kv-mutation": ("direct k_pages/v_pages/dirty mutation outside "
                         "BlockPool write paths"),
    "flush-barrier": ("fork/free/prefill/new_seq/release in a pipelined "
                      "backend without a flush/drain barrier first"),
    "positional-pool": ("deprecated positional PagedBackend/"
                        "ShardedPagedBackend construction"),
    "dense-kv-read": "deprecated DenseBackend.k/.v concrete-cache read",
    "drain-dirty-consumer": ("drain_dirty() called outside the backend "
                             "staging path"),
}

_POOL_ATTRS = {"k_pages", "v_pages"}
_DIRTY_METHODS = {"add", "discard", "clear", "update", "pop", "remove"}
_POOL_OK_METHODS = {"__init__", "write_kv", "copy_block", "drain_dirty",
                    "_free_block", "forget_dirty"}
_FLUSHING = {"flush", "free_seq", "fork_seq", "new_seq", "_add_seqs"}
_BARRIER_PRE_OK = {"_check_released"}
_BARRIER_METHODS = {"fork_seq", "free_seq", "prefill", "new_seq",
                    "_add_seqs"}
_DRAIN_OK_FILES = ("kvcache/backend.py", "kvcache/pool.py")
_CTOR_NAMES = {"PagedBackend", "ShardedPagedBackend"}
_DENSE_SOURCES = {"DenseBackend", "make_backend", "init_cache"}

_SUPPRESS_RE = re.compile(r"#.*?lint:\s*ok(?:\(([a-z0-9-]+)\))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    msg: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.msg}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _root_name(node: ast.AST) -> str | None:
    """Leftmost Name of an attribute/subscript chain, else None."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_self_call(node: ast.AST, names: set[str]) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "self"
            and node.func.attr in names)


def _assign_targets(node: ast.stmt):
    if isinstance(node, ast.Assign):
        return node.targets
    if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        return [node.target]
    return []


# ---------------------------------------------------------------------------
# pool-kv-mutation


def _rule_pool_kv_mutation(tree: ast.Module, out: list):
    allowed: list[tuple[int, int]] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "BlockPool":
            for item in node.body:
                if (isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and item.name in _POOL_OK_METHODS):
                    allowed.append((item.lineno, item.end_lineno or item.lineno))

    def ok(line: int) -> bool:
        return any(a <= line <= b for a, b in allowed)

    for node in ast.walk(tree):
        for tgt in _assign_targets(node) if isinstance(node, ast.stmt) else []:
            for sub in ast.walk(tgt):
                hit = None
                if isinstance(sub, ast.Attribute) and isinstance(sub.ctx, ast.Store):
                    if sub.attr in _POOL_ATTRS or sub.attr == "dirty":
                        hit = sub.attr
                elif (isinstance(sub, ast.Subscript)
                      and isinstance(sub.ctx, ast.Store)
                      and isinstance(sub.value, ast.Attribute)
                      and sub.value.attr in _POOL_ATTRS):
                    hit = sub.value.attr
                if hit is not None and not ok(sub.lineno):
                    out.append((sub.lineno, sub.col_offset, "pool-kv-mutation",
                                f"direct store to .{hit} outside BlockPool "
                                "write paths — use write_kv/copy_block so the "
                                "dirty-staging contract holds"))
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _DIRTY_METHODS
                and isinstance(node.func.value, ast.Attribute)
                and node.func.value.attr == "dirty"
                and not ok(node.lineno)):
            out.append((node.lineno, node.col_offset, "pool-kv-mutation",
                        f"direct .dirty.{node.func.attr}(...) outside "
                        "BlockPool — use forget_dirty/write_kv/drain_dirty"))


# ---------------------------------------------------------------------------
# flush-barrier


def _stmt_contains_flush(st: ast.stmt) -> bool:
    return any(_is_self_call(n, _FLUSHING) for n in ast.walk(st))


def _stmt_violation(st: ast.stmt):
    """First pre-flush self-mutation / disallowed self-call in a leaf stmt."""
    for n in ast.walk(st):
        if isinstance(n, ast.stmt):
            for tgt in _assign_targets(n):
                for sub in ast.walk(tgt):
                    if (isinstance(sub, (ast.Attribute, ast.Subscript))
                            and isinstance(sub.ctx, ast.Store)
                            and _root_name(sub) == "self"):
                        return (sub.lineno, sub.col_offset,
                                "backend state mutated")
        if (isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and isinstance(n.func.value, ast.Name)
                and n.func.value.id == "self"
                and n.func.attr not in (_FLUSHING | _BARRIER_PRE_OK)):
            return (n.lineno, n.col_offset, f"self.{n.func.attr}(...) called")
    return None


def _scan_barrier(body: list, flushed: bool):
    """Walk statements in order; return (flushed, violation|None)."""
    for st in body:
        if flushed:
            return True, None
        if isinstance(st, (ast.If, ast.For, ast.While, ast.With, ast.Try)):
            header = [x for x in ast.iter_child_nodes(st)
                      if isinstance(x, ast.expr)]
            for expr in header:
                fake = ast.Expr(value=expr)
                ast.copy_location(fake, expr)
                v = _stmt_violation(fake)
                if v:
                    return flushed, v
                if any(_is_self_call(n, _FLUSHING) for n in ast.walk(expr)):
                    flushed = True
            sub_bodies = [st.body]
            for fld in ("orelse", "finalbody"):
                sb = getattr(st, fld, None)
                if sb:
                    sub_bodies.append(sb)
            for h in getattr(st, "handlers", []) or []:
                sub_bodies.append(h.body)
            branch_flushed = []
            for sb in sub_bodies:
                f, v = _scan_barrier(sb, flushed)
                if v:
                    return flushed, v
                branch_flushed.append(f)
            # conservative: a flush on any branch counts (real code
            # flushes unconditionally; this avoids guard false-positives)
            flushed = flushed or any(branch_flushed)
        else:
            if _stmt_contains_flush(st):
                flushed = True
                continue
            v = _stmt_violation(st)
            if v:
                return flushed, v
    return flushed, None


def _rule_flush_barrier(tree: ast.Module, out: list):
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        methods = {m.name: m for m in cls.body
                   if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
        if "_commit_pending" not in methods:
            continue
        for name in sorted(_BARRIER_METHODS & set(methods)):
            fn = methods[name]
            flushed, v = _scan_barrier(fn.body, False)
            if v and not flushed:
                line, col, what = v
                out.append((line, col, "flush-barrier",
                            f"{cls.name}.{name}: {what} before flush() — "
                            "the one-step-lagged write-back must land first"))
        if "release" in methods:
            fn = methods["release"]
            drains = any(_is_self_call(n, {"flush", "_commit_pending"})
                         for n in ast.walk(fn))
            if not drains:
                out.append((fn.lineno, fn.col_offset, "flush-barrier",
                            f"{cls.name}.release never drains the pipeline "
                            "(no flush()/_commit_pending()) — in-flight KV "
                            "write-back is dropped"))


# ---------------------------------------------------------------------------
# positional-pool


def _rule_positional_pool(tree: ast.Module, out: list):
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = None
        if isinstance(node.func, ast.Name):
            name = node.func.id
        elif isinstance(node.func, ast.Attribute):
            name = node.func.attr
        if name in _CTOR_NAMES and len(node.args) >= 2:
            out.append((node.lineno, node.col_offset, "positional-pool",
                        f"positional {name}(cfg, pool, ...) is deprecated — "
                        "use make_backend(...) or keyword arguments"))


# ---------------------------------------------------------------------------
# dense-kv-read


def _rule_dense_kv_read(tree: ast.Module, out: list):
    scopes = [tree] + [n for n in ast.walk(tree)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
    for scope in scopes:
        backends: set[str] = set()
        for node in ast.walk(scope):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                fname = None
                if isinstance(node.value.func, ast.Name):
                    fname = node.value.func.id
                elif isinstance(node.value.func, ast.Attribute):
                    fname = node.value.func.attr
                if fname in _DENSE_SOURCES:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            backends.add(tgt.id)
        if not backends:
            continue
        for node in ast.walk(scope):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.ctx, ast.Load)
                    and node.attr in ("k", "v")
                    and isinstance(node.value, ast.Name)
                    and node.value.id in backends):
                out.append((node.lineno, node.col_offset, "dense-kv-read",
                            f"deprecated read of .{node.attr} on backend "
                            f"'{node.value.id}' — use kv_for_layer(l)"))


# ---------------------------------------------------------------------------
# drain-dirty-consumer


def _rule_drain_dirty(tree: ast.Module, relpath: str, out: list):
    rp = relpath.replace(os.sep, "/")
    if not rp.startswith("src/"):
        return
    if rp.endswith(_DRAIN_OK_FILES):
        return
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "drain_dirty"):
            out.append((node.lineno, node.col_offset, "drain-dirty-consumer",
                        "drain_dirty() outside the backend staging path — "
                        "a second consumer steals staged writes from "
                        "_staged_pages"))


# ---------------------------------------------------------------------------
# driver


def _suppressed(src_lines: list[str], line: int, rule: str) -> bool:
    if not (1 <= line <= len(src_lines)):
        return False
    m = _SUPPRESS_RE.search(src_lines[line - 1])
    return bool(m) and (m.group(1) is None or m.group(1) == rule)


def lint_source(src: str, relpath: str) -> list[Finding]:
    """Lint python source text as if it lived at ``relpath``."""
    tree = ast.parse(src)
    raw: list[tuple[int, int, str, str]] = []
    _rule_pool_kv_mutation(tree, raw)
    _rule_flush_barrier(tree, raw)
    _rule_positional_pool(tree, raw)
    _rule_dense_kv_read(tree, raw)
    _rule_drain_dirty(tree, relpath, raw)
    lines = src.splitlines()
    findings = [Finding(relpath, ln, col, rule, msg)
                for ln, col, rule, msg in sorted(set(raw))
                if not _suppressed(lines, ln, rule)]
    return findings


def lint_file(path: str, relpath: str | None = None) -> list[Finding]:
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    return lint_source(src, relpath if relpath is not None else path)


_SKIP_DIRS = {"lint_fixtures", "__pycache__", ".git", ".venv"}


def iter_py_files(paths, root: str = "."):
    """Yield (abspath, relpath) for .py files under ``paths``."""
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(full):
            yield full, os.path.relpath(full, root)
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS
                                 and not d.startswith("."))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    fp = os.path.join(dirpath, fn)
                    yield fp, os.path.relpath(fp, root)


def lint_paths(paths, root: str = ".") -> list[Finding]:
    findings: list[Finding] = []
    for full, rel in iter_py_files(paths, root):
        findings.extend(lint_file(full, rel))
    return findings


_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories to lint (default: src tests)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write a machine-readable findings summary")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for name, desc in sorted(RULES.items()):
            print(f"{name:22s} {desc}")
        return 0

    paths = args.paths or ["src", "tests"]
    nfiles = 0
    findings = []
    for full, rel in iter_py_files(paths, _ROOT):
        nfiles += 1
        findings.extend(lint_file(full, rel))

    for f in findings:
        print(f)

    counts = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    summary = {
        "ok": not findings,
        "files": nfiles,
        "findings": [f.to_dict() for f in findings],
        "counts": counts,
    }
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(summary, fh, indent=2, sort_keys=True)
            fh.write("\n")

    if findings:
        print(f"[lint] BAD {len(findings)} finding(s) across {nfiles} files")
        return 1
    print(f"[lint] OK {nfiles} files clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
