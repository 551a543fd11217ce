"""Happens-before model of the ``DecodeStep`` lifecycle (port of
``repro/analysis/races.py``; stdlib only, the reference's verdicts).

The pipelined backends (``PagedBackend``/``ShardedPagedBackend``) obey a
small protocol per shard:

* ``dispatch(k)`` may only run with no step in flight and no
  synced-but-uncommitted step pending (``dispatch_decode`` commits step
  ``k-1`` *before* emitting its own dispatch event, so a pending step at
  dispatch time means the one-step write-back lag was exceeded);
* ``sync(k)`` must follow ``dispatch(k)`` and moves the step from
  in-flight to pending;
* ``commit(k)`` must follow ``sync(k)``;
* barrier ops (``prefill``/``fork``/``free``/``release``/``resume``)
  require the shard fully drained (no in-flight, no pending step) — the
  flush barrier in front of every CoW fork / free / admission / resume;
* ``pause`` (decode preemption) must likewise observe the flush barrier
  BEFORE demoting the victim's blocks: a pause with a step in flight or
  a write-back still pending is the distinct ``preempt-during-dispatch``
  violation (the demoted pages would race the deferred KV commit);
* pipelining is real only if ≥1 token is emitted strictly between some
  ``sync(k)`` and its ``commit(k)`` (``lag_tokens``).

Two frontends drive one checker:

``check_history(events)``
    in-process: feed an explicit event list (e.g. every interleaving of
    per-shard chains from :func:`interleavings`) and get violations.
    Events may carry a ``round`` id, enabling the issue-then-gather
    check (all dispatches of a round precede all of its syncs).

``analyze_trace(lines)``
    offline: replay ``obs`` TraceLog JSONL (``backend.dispatch`` /
    ``backend.decode`` / ``backend.commit`` / ``backend.prefill`` /
    ``engine.token`` events) and produce a JSON-serializable report.
    The reference's ``tools/check_metrics.py --require-pipeline`` runs
    the same replay through ``repro.analysis.races``.

Run standalone: ``python -m repro_torch.analysis.races trace.jsonl
[--require-pipeline] [--json out.json]``.
"""
from __future__ import annotations

import dataclasses
import json

DISPATCH, SYNC, COMMIT = "dispatch", "sync", "commit"
PREFILL, FORK, FREE, RELEASE = "prefill", "fork", "free", "release"
PAUSE, RESUME = "pause", "resume"
TOKEN = "token"
_BARRIERS = {PREFILL, FORK, FREE, RELEASE, RESUME}
KINDS = {DISPATCH, SYNC, COMMIT, TOKEN, PAUSE} | _BARRIERS


@dataclasses.dataclass(frozen=True)
class Ev:
    """One lifecycle event. ``step`` is the per-shard step index;
    ``round`` (optional) groups a sharded issue-then-gather round."""
    kind: str
    shard: int = 0
    step: int | None = None
    round: int | None = None

    def __repr__(self) -> str:  # compact, for violation messages
        bits = [self.kind, f"sh{self.shard}"]
        if self.step is not None:
            bits.append(f"#{self.step}")
        if self.round is not None:
            bits.append(f"r{self.round}")
        return ":".join(bits)


@dataclasses.dataclass(frozen=True)
class Violation:
    code: str
    shard: int
    step: int | None
    index: int          # position in the event stream (-1 = end-of-stream)
    msg: str

    def __str__(self) -> str:
        return f"[{self.code}] {self.msg}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Shard:
    __slots__ = ("inflight", "pending", "seen_dispatch", "dispatched",
                 "synced", "committed")

    def __init__(self):
        self.inflight: int | None = None
        self.pending: int | None = None
        self.seen_dispatch = False
        self.dispatched = 0
        self.synced = 0
        self.committed = 0


class PipelineChecker:
    """Feed events in order; violations accumulate in ``.violations``.

    ``strict_start=False`` (trace replay) ignores sync/commit on a shard
    before its first dispatch — the obs ring buffer may have dropped the
    head of the stream.
    """

    def __init__(self, strict_start: bool = True):
        self.strict_start = strict_start
        self.violations: list[Violation] = []
        self.lag_tokens = 0
        self._shards: dict[int, _Shard] = {}
        self._rounds: dict[int, list[tuple[int, str]]] = {}
        self._n = 0

    def _sh(self, shard: int) -> _Shard:
        return self._shards.setdefault(shard, _Shard())

    def _bad(self, code: str, shard: int, step: int | None, msg: str):
        self.violations.append(Violation(code, shard, step, self._n, msg))

    def feed(self, ev: Ev):
        i, s = self._n, self._sh(ev.shard)
        if ev.round is not None and ev.kind in (DISPATCH, SYNC):
            self._rounds.setdefault(ev.round, []).append((i, ev.kind))
        if ev.kind == DISPATCH:
            if s.inflight is not None:
                self._bad("double-dispatch", ev.shard, ev.step,
                          f"dispatch of step {ev.step} on shard {ev.shard} "
                          f"while step {s.inflight} is still in flight")
            elif s.pending is not None:
                self._bad("lag-exceeded", ev.shard, ev.step,
                          f"dispatch of step {ev.step} on shard {ev.shard} "
                          f"before step {s.pending}'s commit — write-back "
                          "lag exceeded one step")
            s.inflight = ev.step
            s.seen_dispatch = True
            s.dispatched += 1
        elif ev.kind == SYNC:
            if s.inflight is None:
                if s.seen_dispatch or self.strict_start:
                    self._bad("sync-before-dispatch", ev.shard, ev.step,
                              f"sync of step {ev.step} on shard {ev.shard} "
                              "before its dispatch")
            elif ev.step is not None and s.inflight != ev.step:
                self._bad("sync-mismatch", ev.shard, ev.step,
                          f"sync of step {ev.step} on shard {ev.shard} but "
                          f"step {s.inflight} is the one in flight")
            if s.inflight is not None or s.seen_dispatch or self.strict_start:
                if s.pending is not None:
                    self._bad("lag-exceeded", ev.shard, ev.step,
                              f"sync of step {ev.step} on shard {ev.shard} "
                              f"while step {s.pending} is still uncommitted")
                s.pending = ev.step if ev.step is not None else s.inflight
                s.inflight = None
                s.synced += 1
        elif ev.kind == COMMIT:
            if s.pending is None:
                if s.seen_dispatch or self.strict_start:
                    self._bad("commit-before-sync", ev.shard, ev.step,
                              f"commit of step {ev.step} on shard {ev.shard} "
                              "before its sync — KV write-back would land "
                              "ahead of the logits it belongs to")
            else:
                if ev.step is not None and s.pending != ev.step:
                    self._bad("commit-mismatch", ev.shard, ev.step,
                              f"commit of step {ev.step} on shard {ev.shard} "
                              f"but step {s.pending} is pending")
                s.pending = None
                s.committed += 1
        elif ev.kind == PAUSE:
            # preemption's own code: demoting the victim's blocks while a
            # decode is in flight (or its KV write-back still deferred)
            # would hand reusable pages to the allocator with device
            # writes against them still outstanding
            if s.inflight is not None or s.pending is not None:
                stuck = s.inflight if s.inflight is not None else s.pending
                self._bad("preempt-during-dispatch", ev.shard, ev.step,
                          f"pause on shard {ev.shard} with step {stuck} "
                          "not yet committed — block demotion must observe "
                          "the flush barrier before preempting")
        elif ev.kind in _BARRIERS:
            if s.inflight is not None or s.pending is not None:
                stuck = s.inflight if s.inflight is not None else s.pending
                self._bad("barrier-missed", ev.shard, ev.step,
                          f"{ev.kind} on shard {ev.shard} inside an "
                          f"undrained pipeline (step {stuck} not yet "
                          "committed) — flush barrier missed")
        elif ev.kind == TOKEN:
            for sh in self._shards.values():
                if sh.pending is not None:
                    self.lag_tokens += 1
                    break
        else:
            raise ValueError(f"unknown event kind: {ev.kind!r}")
        self._n += 1

    def finish(self) -> list[Violation]:
        for shard, s in sorted(self._shards.items()):
            if s.inflight is not None:
                self._bad("lost-sync", shard, s.inflight,
                          f"step {s.inflight} on shard {shard} dispatched "
                          "but never synced")
            if s.pending is not None:
                self._bad("lost-commit", shard, s.pending,
                          f"step {s.pending} on shard {shard} synced but "
                          "never committed — flush lost the write-back")
        for rnd, evs in sorted(self._rounds.items()):
            last_dispatch = max((i for i, k in evs if k == DISPATCH),
                                default=None)
            first_sync = min((i for i, k in evs if k == SYNC), default=None)
            if (last_dispatch is not None and first_sync is not None
                    and first_sync < last_dispatch):
                self.violations.append(Violation(
                    "gather-before-issue", -1, None, first_sync,
                    f"round {rnd}: a shard synced before every shard's "
                    "kernel was issued — issue-then-gather order broken"))
        return self.violations

    def stats(self) -> dict:
        return {
            "shards": len(self._shards),
            "events": self._n,
            "dispatched": sum(s.dispatched for s in self._shards.values()),
            "synced": sum(s.synced for s in self._shards.values()),
            "committed": sum(s.committed for s in self._shards.values()),
            "lag_tokens": self.lag_tokens,
        }


def check_history(events, strict_start: bool = True) -> list[Violation]:
    """Run a full event sequence through the checker; returns violations."""
    c = PipelineChecker(strict_start=strict_start)
    for ev in events:
        c.feed(ev)
    return c.finish()


def shard_chain(shard: int, steps: int, tokens: bool = True,
                rounds: bool = False) -> list[Ev]:
    """The legal per-shard lifecycle: d0 s0 [tok] c0 d1 s1 [tok] c1 ...

    Commit of step k is emitted by dispatch of step k+1 (one-step lag),
    so tokens sampled from step k's logits land between s(k) and c(k).
    """
    out: list[Ev] = []
    for k in range(steps):
        rnd = k if rounds else None
        out.append(Ev(DISPATCH, shard, k, rnd))
        out.append(Ev(SYNC, shard, k, rnd))
        if tokens:
            out.append(Ev(TOKEN, shard, k))
        out.append(Ev(COMMIT, shard, k, rnd))
    return out


def interleavings(*chains):
    """Exhaustively yield every order-preserving merge of the chains."""
    chains = [list(c) for c in chains if c]
    if not chains:
        yield []
        return

    def rec(prefix, rests):
        if all(not r for r in rests):
            yield list(prefix)
            return
        for i, r in enumerate(rests):
            if not r:
                continue
            prefix.append(r[0])
            nxt = list(rests)
            nxt[i] = r[1:]
            yield from rec(prefix, nxt)
            prefix.pop()

    yield from rec([], chains)


# ---------------------------------------------------------------------------
# obs TraceLog replay

_EV_MAP = {
    "backend.dispatch": DISPATCH,
    "backend.decode": SYNC,       # span emitted when sync() returns
    "backend.commit": COMMIT,
    "backend.prefill": PREFILL,
    "backend.pause": PAUSE,       # decode preemption: pause -> demote
    "backend.resume": RESUME,     # bitwise restore (a flush barrier)
    "engine.token": TOKEN,
}


@dataclasses.dataclass
class Report:
    violations: list[Violation]
    stats: dict

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {"ok": self.ok,
                "violations": [v.to_dict() for v in self.violations],
                "stats": self.stats}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)


def _iter_trace_events(lines):
    """Parse TraceLog JSONL into Ev records in timestamp order.

    ``TraceLog.span`` stamps ``ts`` at *entry* (``dur_us`` is attached
    at exit), and instantaneous events stamp at emission, so a plain
    ``ts`` sort reconstructs program order for the single-threaded
    engine — ``backend.decode``'s ts is the moment the engine began
    blocking in ``sync``, which is exactly the happens-before point the
    protocol cares about.
    """
    out = []
    for seq, line in enumerate(lines):
        if isinstance(line, (bytes, str)):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue    # malformed lines are the schema check's job
        else:
            rec = line
        name = rec.get("ev")
        kind = _EV_MAP.get(name)
        if kind is None:
            continue
        ev = Ev(kind, int(rec.get("shard", 0)),
                rec.get("step") if rec.get("step") is None
                else int(rec.get("step")))
        out.append((rec.get("ts", 0), seq, ev))
    out.sort(key=lambda t: (t[0], t[1]))
    return [ev for _, _, ev in out]


def analyze_trace(lines, require_pipeline: bool = False) -> Report:
    """Replay an obs TraceLog (JSONL lines or parsed dicts) offline."""
    events = _iter_trace_events(lines)
    c = PipelineChecker(strict_start=False)
    for ev in events:
        c.feed(ev)
    c.finish()
    stats = c.stats()
    if require_pipeline:
        if stats["dispatched"] == 0:
            c.violations.append(Violation(
                "no-pipeline", -1, None, -1,
                "trace holds no backend.dispatch events — pipelined "
                "decode never ran"))
        elif stats["lag_tokens"] == 0:
            c.violations.append(Violation(
                "no-lag", -1, None, -1,
                "no token was ever emitted between a sync and its commit "
                "— the write-back is not lagged, decode is sequential"))
    return Report(violations=c.violations, stats=stats)


def analyze_trace_file(path: str, require_pipeline: bool = False) -> Report:
    with open(path, encoding="utf-8") as fh:
        return analyze_trace(fh, require_pipeline=require_pipeline)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Replay an obs TraceLog JSONL through the decode-"
                    "pipeline happens-before checker.")
    ap.add_argument("trace", help="trace JSONL path")
    ap.add_argument("--require-pipeline", action="store_true",
                    help="fail unless pipelined decode actually ran")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the findings report as JSON")
    args = ap.parse_args(argv)

    report = analyze_trace_file(args.trace,
                                require_pipeline=args.require_pipeline)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            fh.write(report.to_json() + "\n")
    for v in report.violations:
        print(f"[races] BAD {v.msg}")
    if report.ok:
        print(f"[races] OK {report.stats}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
