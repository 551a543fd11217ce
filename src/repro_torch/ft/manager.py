"""Fault-tolerance runtime: heartbeats, straggler mitigation, elastic
restart (port of ``repro/ft/manager.py``, numpy only, unchanged).

On a real multi-pod deployment each host runs this manager beside the
training loop.  The control plane is deliberately simple and file/launcher
based (no external services), which is what actually survives at scale:

  * HeartbeatMonitor — every host writes a monotonic heartbeat; the leader
    declares a host dead after ``timeout_s`` and triggers an elastic
    restart from the last committed checkpoint.
  * StragglerDetector — EWMA of per-step wall time; a host is a straggler
    when its step time exceeds ``factor`` x the fleet median for
    ``patience`` consecutive steps.  Action: flag for preemptive restart /
    hot-spare swap (the scheduler decides; we surface the signal).
  * ElasticPlan — given the surviving device set, picks the largest valid
    (pod, data, model) mesh <= the original, preserving the model axis
    (TP/EP degree must not change — parameters reshard only along
    data/pod), and returns the new mesh + the checkpoint resharding plan.

Failure handling is CHECKPOINT-RESTART based: collectives on TPU cannot
survive membership change mid-step, so the recovery unit is the step. The
cost model is: lose <= ckpt_interval steps + restart time; the interval
auto-tunes from measured step time and MTBF (Young/Daly).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Callable, Optional

import numpy as np


# ---------------------------------------------------------------------------
# Heartbeats
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HeartbeatMonitor:
    directory: Path
    host_id: int
    timeout_s: float = 60.0

    def __post_init__(self):
        self.directory = Path(self.directory)
        self.directory.mkdir(parents=True, exist_ok=True)

    def beat(self, step: int) -> None:
        p = self.directory / f"hb_{self.host_id}.json"
        tmp = p.with_suffix(".tmp")
        tmp.write_text(json.dumps({"t": time.time(), "step": step}))
        os.replace(tmp, p)

    def dead_hosts(self, now: float | None = None) -> list[int]:
        now = now or time.time()
        dead = []
        for p in self.directory.glob("hb_*.json"):
            try:
                t = json.loads(p.read_text())["t"]
            except (json.JSONDecodeError, KeyError):
                continue
            if now - t > self.timeout_s:
                dead.append(int(p.stem.split("_")[1]))
        return sorted(dead)


# ---------------------------------------------------------------------------
# Stragglers
# ---------------------------------------------------------------------------

class StragglerDetector:
    """EWMA step-time tracking vs fleet median."""

    def __init__(self, n_hosts: int, factor: float = 1.5,
                 patience: int = 5, alpha: float = 0.3):
        self.factor = factor
        self.patience = patience
        self.alpha = alpha
        self.ewma = np.zeros(n_hosts)
        self.strikes = np.zeros(n_hosts, np.int32)

    def observe(self, host: int, step_time_s: float) -> None:
        e = self.ewma[host]
        self.ewma[host] = step_time_s if e == 0 else \
            self.alpha * step_time_s + (1 - self.alpha) * e

    def stragglers(self) -> list[int]:
        active = self.ewma[self.ewma > 0]
        if len(active) < 2:
            return []
        med = float(np.median(active))
        out = []
        for h, e in enumerate(self.ewma):
            if e > self.factor * med:
                self.strikes[h] += 1
                if self.strikes[h] >= self.patience:
                    out.append(h)
            else:
                self.strikes[h] = 0
        return out


# ---------------------------------------------------------------------------
# Elastic re-mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple
    axis_names: tuple
    dropped_hosts: tuple
    notes: str


def plan_elastic_mesh(original_shape: tuple, axis_names: tuple,
                      surviving_devices: int) -> ElasticPlan:
    """Largest valid mesh under the survivor count.

    The model axis is preserved (changing TP/EP degree would invalidate
    every parameter shard); capacity shrinks along data, then pod.  E.g.
    (2,16,16) with one pod lost -> (1,16,16); 512 -> 448 devices keeps
    (2,14,16) if 'data' can shrink to 14 and the global batch divides.
    """
    shape = dict(zip(axis_names, original_shape))
    model = shape.get("model", 1)
    if surviving_devices < model:
        raise ValueError("cannot preserve model axis; survivors "
                         f"{surviving_devices} < model {model}")
    rest = surviving_devices // model
    pod = shape.get("pod", 1)
    data = shape.get("data", 1)
    # shrink data first; on equal capacity prefer fewer pods (a whole-pod
    # loss should collapse to a clean single-pod mesh, not two half-pods)
    best = None
    for p in range(1, pod + 1):
        d = min(data, rest // p)
        if d >= 1 and (best is None or p * d > best[0] * best[1]):
            best = (p, d)
    p, d = best
    new = []
    for a in axis_names:
        new.append({"pod": p, "data": d, "model": model}.get(a, shape[a]))
    used = p * d * model
    return ElasticPlan(tuple(new), tuple(axis_names),
                       dropped_hosts=(),
                       notes=f"{surviving_devices} survivors -> "
                             f"{used} used ({surviving_devices-used} spare)")


# ---------------------------------------------------------------------------
# Checkpoint cadence (Young/Daly)
# ---------------------------------------------------------------------------

def optimal_ckpt_interval_steps(step_time_s: float, ckpt_time_s: float,
                                mtbf_hours: float, n_hosts: int) -> int:
    """Young/Daly: T_opt = sqrt(2 * C * MTBF_system)."""
    mtbf_system = mtbf_hours * 3600.0 / max(n_hosts, 1)
    t_opt = math.sqrt(2.0 * ckpt_time_s * mtbf_system)
    return max(1, int(t_opt / max(step_time_s, 1e-6)))


# ---------------------------------------------------------------------------
# Run supervisor
# ---------------------------------------------------------------------------

class RunSupervisor:
    """Glue: drives heartbeat + straggler + checkpoint cadence around a
    step function; used by launch/train.py and the FT integration test."""

    def __init__(self, workdir: str, n_hosts: int = 1, host_id: int = 0,
                 ckpt_interval: int = 50, hb_timeout_s: float = 60.0,
                 mtbf_hours: float = 24.0):
        self.workdir = Path(workdir)
        self.ckpt_dir = self.workdir / "ckpt"
        self.hb = HeartbeatMonitor(self.workdir / "hb", host_id,
                                   hb_timeout_s)
        self.stragglers = StragglerDetector(n_hosts)
        self.ckpt_interval = ckpt_interval
        self.mtbf_hours = mtbf_hours
        self.n_hosts = n_hosts
        self._step_times: deque = deque(maxlen=50)
        self._ckpt_times: deque = deque(maxlen=5)

    def should_checkpoint(self, step: int) -> bool:
        return step > 0 and step % self.ckpt_interval == 0

    def after_step(self, step: int, step_time_s: float) -> dict:
        self._step_times.append(step_time_s)
        self.hb.beat(step)
        self.stragglers.observe(0, step_time_s)
        events = {"dead": self.hb.dead_hosts(),
                  "stragglers": self.stragglers.stragglers()}
        # retune cadence from live measurements
        if self._step_times and self._ckpt_times:
            self.ckpt_interval = optimal_ckpt_interval_steps(
                float(np.mean(self._step_times)),
                float(np.mean(self._ckpt_times)),
                self.mtbf_hours, self.n_hosts)
        return events

    def record_ckpt_time(self, seconds: float) -> None:
        self._ckpt_times.append(seconds)
