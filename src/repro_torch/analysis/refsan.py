"""Opt-in ``BlockPool`` shadow refcount sanitizer (port of
``repro/analysis/refsan.py``).

Wraps a live pool's mutating methods (``alloc``/``incref``/``decref``/
``reuse_cached``/``_free_block``/``write_kv``/``copy_block``/``touch``)
with instance-level shims that keep a *shadow* account of every block:
free / live / cached, a generation counter bumped per allocation, and
the call site (first frame outside the pool) that performed each alloc
and free.  Because block ids are recycled, a use-after-free by a stale
id is invisible to the pool itself — the shadow account catches it the
moment the stale holder touches the reused slot.

Findings reported:

``double-free``      decref/_free_block of an already-free block
``use-after-free``   incref/touch/write/copy of a free block (including
                     by id reuse — generation mismatch provenance)
``bad-alloc``        allocator handed out a block the shadow account
                     considers live/cached
``leak``             blocks still live at ``report(quiesced=True)``,
                     with the allocating call site

Usage::

    san = refsan.attach(pool)          # also accepts ShardedBlockPool
    ... exercise ...
    san.check()                        # raises on findings
    san.check(quiesced=True)           # additionally: no live blocks
    san.detach()

Pure stdlib; overhead is one dict update + a few frame hops per pool
op, fine for the soaks.  The shims record block ids only and never touch
a KV payload (``write_kv``/``copy_block`` take torch tensors, pinned on
a CUDA pool), so the sanitizer copies no KV.
"""
from __future__ import annotations

import dataclasses
import sys

# frames skipped when naming a call site: the pool and this module, in
# either package (suffix match: ``repro_torch/kvcache/pool.py`` too)
_SKIP_FILES = ("kvcache/pool.py", "analysis/refsan.py")

FREE, LIVE, CACHED = "free", "live", "cached"


def _call_site() -> str:
    """First stack frame outside pool.py / this module."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename.replace("\\", "/")
        if not fn.endswith(_SKIP_FILES):
            return f"{fn.rsplit('/', 1)[-1]}:{f.f_lineno}:{f.f_code.co_name}"
        f = f.f_back
    return "<unknown>"


@dataclasses.dataclass(frozen=True)
class RefFinding:
    kind: str           # double-free | use-after-free | bad-alloc | leak
    bid: int
    gen: int
    op: str             # pool method that tripped it
    site: str           # call site of the offending op
    history: str        # where the block was alloc'd / freed before
    msg: str

    def __str__(self) -> str:
        return f"[{self.kind}] {self.msg}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Slot:
    __slots__ = ("state", "gen", "alloc_site", "free_site")

    def __init__(self, state: str):
        self.state = state
        self.gen = 0
        self.alloc_site = "<pre-attach>"
        self.free_site = "<never>"


class RefcountSanitizer:
    """Shadow accounting for one ``BlockPool``. Construct via
    :func:`attach`."""

    _WRAPPED = ("alloc", "incref", "decref", "reuse_cached", "_free_block",
                "write_kv", "copy_block", "touch")

    def __init__(self, pool):
        self.pool = pool
        self.findings: list[RefFinding] = []
        self._orig: dict = {}
        n = pool.cfg.num_blocks
        self._slots = [None] * n
        for bid in range(n):
            if not pool.used[bid]:
                st = FREE
            elif pool.refcount[bid] == 0:
                st = CACHED
            else:
                st = LIVE
            self._slots[bid] = _Slot(st)
        for name in self._WRAPPED:
            self._orig[name] = getattr(pool, name)
            setattr(pool, name, self._make_wrapper(name))

    # -- wrapping ----------------------------------------------------------

    def _make_wrapper(self, name: str):
        orig = self._orig[name]
        pre = getattr(self, f"_pre_{name}", None)

        def wrapper(*args, **kwargs):
            if pre is not None:
                pre(*args, **kwargs)
            out = orig(*args, **kwargs)
            post = getattr(self, f"_post_{name}", None)
            if post is not None:
                post(out, *args, **kwargs)
            return out

        wrapper.__name__ = f"refsan_{name}"
        return wrapper

    def detach(self):
        for name, orig in self._orig.items():
            # the originals are bound methods; deleting the instance
            # attribute restores class-level resolution
            try:
                delattr(self.pool, name)
            except AttributeError:
                setattr(self.pool, name, orig)
        self._orig.clear()

    # -- findings ----------------------------------------------------------

    def _flag(self, kind: str, bid: int, op: str, msg: str):
        slot = self._slots[bid]
        history = (f"alloc@{slot.alloc_site} free@{slot.free_site} "
                   f"gen={slot.gen}")
        self.findings.append(RefFinding(
            kind=kind, bid=bid, gen=slot.gen, op=op,
            site=_call_site(), history=history,
            msg=f"{msg} (block {bid}, {history})"))

    def _expect_held(self, bid: int, op: str):
        slot = self._slots[bid]
        if slot.state == FREE:
            self._flag("use-after-free", bid, op,
                       f"{op} on a freed block — stale id after "
                       f"{slot.gen} reuse(s)?")

    # -- per-op shims ------------------------------------------------------

    def _post_alloc(self, out, n, *a, **k):
        for bid in out:
            slot = self._slots[bid]
            if slot.state != FREE:
                self._flag("bad-alloc", bid, "alloc",
                           f"allocator handed out a {slot.state} block")
            slot.state = LIVE
            slot.gen += 1
            slot.alloc_site = _call_site()
            slot.free_site = "<never>"

    def _pre_incref(self, bid, *a, **k):
        self._expect_held(bid, "incref")

    def _post_incref(self, out, bid, *a, **k):
        self._sync(bid)

    def _pre_decref(self, bid, *a, **k):
        slot = self._slots[bid]
        if slot.state == FREE:
            self._flag("double-free", bid, "decref",
                       "decref of an already-free block")

    def _post_decref(self, out, bid, *a, **k):
        self._sync(bid)

    def _pre_reuse_cached(self, bid, *a, **k):
        self._expect_held(bid, "reuse_cached")

    def _post_reuse_cached(self, out, bid, *a, **k):
        self._sync(bid)

    def _pre__free_block(self, bid, *a, **k):
        slot = self._slots[bid]
        if slot.state == FREE:
            self._flag("double-free", bid, "_free_block",
                       "free of an already-free block")

    def _post__free_block(self, out, bid, *a, **k):
        slot = self._slots[bid]
        slot.state = FREE
        slot.free_site = _call_site()

    def _pre_write_kv(self, bid, *a, **k):
        self._expect_held(bid, "write_kv")

    def _pre_copy_block(self, src, dst, *a, **k):
        self._expect_held(src, "copy_block")
        self._expect_held(dst, "copy_block")

    def _pre_touch(self, bid, *a, **k):
        self._expect_held(bid, "touch")

    def _sync(self, bid: int):
        """Resync one slot's state from pool ground truth (decref may
        have cached or freed it)."""
        slot = self._slots[bid]
        if not self.pool.used[bid]:
            if slot.state != FREE:
                slot.state = FREE
                slot.free_site = _call_site()
        elif self.pool.refcount[bid] == 0:
            slot.state = CACHED
        else:
            slot.state = LIVE

    # -- reporting ---------------------------------------------------------

    def leaks(self) -> list[RefFinding]:
        out = []
        for bid, slot in enumerate(self._slots):
            if slot.state == LIVE:
                out.append(RefFinding(
                    kind="leak", bid=bid, gen=slot.gen, op="report",
                    site="<end-of-run>",
                    history=f"alloc@{slot.alloc_site} gen={slot.gen}",
                    msg=f"block {bid} still live at end of run "
                        f"(allocated at {slot.alloc_site}, "
                        f"refcount {int(self.pool.refcount[bid])})"))
        return out

    def report(self, quiesced: bool = False) -> dict:
        findings = list(self.findings)
        if quiesced:
            findings += self.leaks()
        return {
            "ok": not findings,
            "findings": [f.to_dict() for f in findings],
            "counts": {
                "free": sum(s.state == FREE for s in self._slots),
                "live": sum(s.state == LIVE for s in self._slots),
                "cached": sum(s.state == CACHED for s in self._slots),
            },
        }

    def check(self, quiesced: bool = False):
        rep = self.report(quiesced=quiesced)
        if not rep["ok"]:
            msgs = "\n  ".join(f["msg"] for f in rep["findings"][:20])
            raise AssertionError(
                f"refcount sanitizer: {len(rep['findings'])} finding(s)\n"
                f"  {msgs}")


class _MultiSanitizer:
    """One sanitizer per shard of a ``ShardedBlockPool``."""

    def __init__(self, pools):
        self.parts = [RefcountSanitizer(p) for p in pools]

    @property
    def findings(self):
        return [f for p in self.parts for f in p.findings]

    def leaks(self):
        return [f for p in self.parts for f in p.leaks()]

    def report(self, quiesced: bool = False) -> dict:
        reps = [p.report(quiesced=quiesced) for p in self.parts]
        return {
            "ok": all(r["ok"] for r in reps),
            "findings": [f for r in reps for f in r["findings"]],
            "counts": [r["counts"] for r in reps],
        }

    def check(self, quiesced: bool = False):
        for p in self.parts:
            p.check(quiesced=quiesced)

    def detach(self):
        for p in self.parts:
            p.detach()


def attach(pool):
    """Attach a sanitizer to a ``BlockPool`` or ``ShardedBlockPool``."""
    shards = getattr(pool, "shards", None)
    if shards is not None:
        return _MultiSanitizer(shards)
    return RefcountSanitizer(pool)
