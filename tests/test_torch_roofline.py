"""The port's roofline table (``launch.roofline``) against the
reference's on the same records: every line equal but an ok row's hint
column (the port's hints name the H100's levers); the last record of a
cell wins; and records of the port's dry-run (``dryrun.analyze`` of a
train trace and of a traced serve cell) print as ok rows."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as troofline  # noqa: E402
from repro_torch.utils.collectives import Collective  # noqa: E402


def _ok(arch, shape, mesh, tc, tm, tl):
    bound = max(tc, tm, tl)
    dom = max((("compute", tc), ("memory", tm), ("collective", tl)),
              key=lambda kv: kv[1])[0]
    return {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
            "t_compute_s": tc, "t_memory_s": tm, "t_collective_s": tl,
            "dominant": dom, "roofline_fraction": tc / bound,
            "useful_flop_ratio": 0.37}


RECORDS = [
    _ok("qwen1_5_0_5b", "train_4k", "16x16", 0.34, 14.2, 0.006),
    _ok("qwen1_5_0_5b", "train_4k", "2x16x16", 0.17, 0.01, 0.003),
    _ok("arctic_480b", "train_4k", "16x16", 1.0, 0.5, 3.0),
    {"arch": "qwen1_5_0_5b", "shape": "long_500k", "mesh": "16x16",
     "status": "skip",
     "reason": "full attention at 524k context out of scope (per spec)"},
    {"arch": "kimi_k2_1t_a32b", "shape": "train_4k", "mesh": "16x16",
     "status": "error", "error": "RuntimeError: " + "x" * 80},
    # a rerun of a cell: the later line wins
    _ok("arctic_480b", "train_4k", "16x16", 2.0, 0.5, 3.0),
]


def _table(mod, path, capsys, *extra):
    import sys
    argv = sys.argv
    sys.argv = ["roofline", str(path), *extra]
    try:
        mod.main()
    finally:
        sys.argv = argv
    return capsys.readouterr().out.splitlines()


def _drop_hint(line: str) -> str:
    cells = line.split(" | ")
    return " | ".join(cells[:-1]) if "(frac " in line else line


@pytest.mark.parametrize("extra", [(), ("--mesh", "16x16")])
def test_table_is_the_reference_s_but_the_hints(tmp_path, capsys, extra):
    path = tmp_path / "dryrun.jsonl"
    path.write_text("# a comment line\n"
                    + "\n".join(json.dumps(r) for r in RECORDS) + "\n")
    want = _table(jroofline, path, capsys, *extra)
    got = _table(troofline, path, capsys, *extra)
    assert len(got) == len(want) and len(got) > 6
    assert [_drop_hint(x) for x in got] == [_drop_hint(x) for x in want]
    hints = [x.split(" | ")[-1] for x in got if "(frac " in x]
    assert hints and all(h in {v[:58] + " |" for v in
                               troofline.MOVE_HINTS.values()}
                         for h in hints)
    assert sum("arctic_480b | train_4k | 16x16 | 2.00e+00" in x
               for x in got) == 1


def test_planned_row_and_a_dry_run_record(tmp_path, capsys):
    """A serve cell is no longer planned: a traced decode cell (the qwen
    smoke config on a 2 x 4 fake mesh) prints as an ok row beside a
    train record, and no row reads ``PLANNED``."""
    from repro_torch import configs as tconfigs
    from repro_torch.launch import mesh as tmesh
    traced = dict(flops=4e12, bytes=2e11, memory={},
                  calls=[Collective("all-gather", "x", 9 * 10 ** 11)])
    ok = {"arch": "qwen1_5_0_5b", "shape": "train_4k", "mesh": "16x16",
          "status": "ok", **dryrun.analyze(traced, 256, 256 * 2e12)}
    assert ok["dominant"] == "collective"
    assert ok["t_compute_s"] == 4e12 / dryrun.PEAK_FLOPS
    cfg = tconfigs.get_smoke("qwen1_5_0_5b")
    mesh = tmesh.Mesh(("data", "model"), {"data": 2, "model": 4}, ())
    with dryrun.fake_group(mesh.size):
        serve = dryrun.trace_serve(cfg, tmesh.on_processes(mesh, "cpu"),
                                   "decode", 8, 64)
    decode = {"arch": "qwen1_5_0_5b", "shape": "decode_32k",
              "mesh": "16x16", "status": "ok",
              **dryrun.analyze(serve, 8, dryrun.model_flops(
                  cfg, "decode", 8, 64))}
    path = tmp_path / "dryrun.jsonl"
    path.write_text(json.dumps(ok) + "\n" + json.dumps(decode) + "\n")
    out = _table(troofline, path, capsys)
    row = next(x for x in out if "decode_32k" in x)
    assert f"| {decode['t_compute_s']:.2e} | {decode['t_memory_s']:.2e} " \
        f"| {decode['t_collective_s']:.2e} | {decode['dominant']} (frac " \
        in row
    assert any("collective (frac " in x for x in out)
    assert not any("PLANNED" in x for x in out)
    assert "2 ok / 0 skip / 0 error" in "\n".join(out)
