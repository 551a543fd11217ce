"""The port's protocol lint (``repro_torch.analysis.lint``) against the
reference's (``repro.analysis.lint``): the reference's lint cases
(``tests/test_analysis.py``) for the five rules the port carries.  Every
``tests/lint_fixtures/`` fixture gives the same findings in both linters
(rule, line, column and message), ``pallas-fetch-gate``'s, the rule the
port does not carry, aside; the suppression pragma; the port's tree and
the shipped tests lint clean; the CLI's JSON summary and exit codes are
``tools/lint.py``'s."""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro.analysis import lint as jlint  # noqa: E402
from repro_torch.analysis import lint as tlint  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "lint_fixtures")
NOT_CARRIED = "pallas-fetch-gate"

# rule -> (bad fixture, ok fixture, relpath the fixture pretends to be at)
CORPUS = {
    "pool-kv-mutation": ("bad_pool_mutation.py", "ok_pool_mutation.py", None),
    "flush-barrier": ("bad_flush_barrier.py", "ok_flush_barrier.py", None),
    "positional-pool": ("bad_positional_pool.py", "ok_positional_pool.py",
                        None),
    "dense-kv-read": ("bad_dense_read.py", "ok_dense_read.py", None),
    "drain-dirty-consumer": ("bad_drain_dirty.py", "ok_drain_dirty.py",
                             "src/repro_torch/fake/{name}"),
}


def _rel(name, tmpl):
    return tmpl.format(name=name) if tmpl else os.path.join(FIXTURES, name)


def _as_tuples(findings):
    return [dataclasses.astuple(f) for f in findings]


def test_rules_are_the_reference_s_less_the_pallas_gate():
    assert set(tlint.RULES) == set(jlint.RULES) - {NOT_CARRIED}
    assert all(tlint.RULES[r] == jlint.RULES[r] for r in tlint.RULES)
    assert set(CORPUS) == set(tlint.RULES)


@pytest.mark.parametrize("name", sorted(os.listdir(FIXTURES)))
def test_every_fixture_gives_the_reference_s_findings(name):
    """Each fixture, at its own path and at a path under ``src/``: the
    reference's findings but its ``pallas-fetch-gate`` ones."""
    for rel in (os.path.join(FIXTURES, name), f"src/repro_torch/x/{name}"):
        path = os.path.join(FIXTURES, name)
        want = [f for f in jlint.lint_file(path, rel)
                if f.rule != NOT_CARRIED]
        assert _as_tuples(tlint.lint_file(path, rel)) == _as_tuples(want)


@pytest.mark.parametrize("rule", sorted(CORPUS))
def test_bad_fixture_trips_exactly_its_rule(rule):
    bad, ok, tmpl = CORPUS[rule]
    findings = tlint.lint_file(os.path.join(FIXTURES, bad), _rel(bad, tmpl))
    assert findings and {f.rule for f in findings} == {rule}
    for f in findings:
        assert f.line > 0 and f"[{rule}]" in str(f)
    assert tlint.lint_file(os.path.join(FIXTURES, ok), _rel(ok, tmpl)) == []


def test_suppression_pragma_silences_one_rule():
    src = "def f(pool, bid):\n    pool.dirty.discard(bid)\n"
    assert len(tlint.lint_source(src, "x.py")) == 1
    ok = ("def f(pool, bid):\n"
          "    pool.dirty.discard(bid)  # lint: ok(pool-kv-mutation)\n")
    assert tlint.lint_source(ok, "x.py") == []
    bare = "def f(pool, bid):\n    pool.dirty.discard(bid)  # lint: ok\n"
    assert tlint.lint_source(bare, "x.py") == []
    wrong = ("def f(pool, bid):\n"
             "    pool.dirty.discard(bid)  # lint: ok(dense-kv-read)\n")
    assert len(tlint.lint_source(wrong, "x.py")) == 1


def test_port_tree_and_tests_lint_clean():
    findings = tlint.lint_paths(["src/repro_torch", "tests"], ROOT)
    assert findings == [], "\n".join(str(f) for f in findings)


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", *args],
        capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})


def test_cli_json_summary_and_exit_codes(tmp_path):
    out = tmp_path / "lint.json"
    proc = _cli(os.path.join(FIXTURES, "bad_positional_pool.py"),
                "--json", str(out))
    assert proc.returncode == 1
    summary = json.loads(out.read_text())
    assert summary["ok"] is False and summary["files"] == 1
    assert summary["counts"] == {"positional-pool": 2}
    assert all({"path", "line", "col", "rule", "msg"} <= set(f)
               for f in summary["findings"])
    assert "[lint] BAD 2 finding(s) across 1 files" in proc.stdout
    proc = _cli(os.path.join(FIXTURES, "ok_positional_pool.py"),
                "--json", str(out))
    assert proc.returncode == 0
    assert json.loads(out.read_text())["ok"] is True
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    assert [ln.split()[0] for ln in proc.stdout.splitlines()] == \
        sorted(tlint.RULES)
