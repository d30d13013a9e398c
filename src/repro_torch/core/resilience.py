"""Failure detection and straggler statistics.

The part of ``repro/core/resilience.py`` that the training loop drives:
``Heartbeat`` (small records in each node's pmem pool, readable by the
monitor) and ``StragglerDetector`` (per-step durations against the fleet
median). ``FailureRecovery`` and the repair daemon wait for the
replication slice (ROADMAP Queue A item 2).
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List, Optional

from repro_torch.core.object_store import PMemObjectStore


class Heartbeat:
    def __init__(self, stores: Dict[str, PMemObjectStore]):
        self.stores = stores
        # monitor-side first-seen clock per node that has NOT yet written
        # a heartbeat: a just-joined / just-restarted node must get a
        # grace window before the monitor declares it dead and repairs
        # around it. State lives in the monitor (this object), never in
        # the observed node's pmem.
        self._first_seen: Dict[str, float] = {}

    def beat(self, nid: str, step: int) -> None:
        try:
            self.stores[nid].pool.put_json(
                "hb/heartbeat.json", {"ts": time.time(), "step": step})
        except IOError:
            # Not a swallowed durability failure: an unreachable pmem
            # means the node is dead, and a dead node STOPPING its
            # heartbeat is exactly the signal the monitor consumes.
            pass  # pmemlint: disable=silent-swallow

    def read(self, nid: str) -> Optional[dict]:
        try:
            return self.stores[nid].pool.get_json("hb/heartbeat.json")
        except (FileNotFoundError, IOError):
            return None

    def dead_nodes(self, timeout_s: float, now: Optional[float] = None,
                   grace_s: Optional[float] = None) -> List[str]:
        """Nodes the monitor considers dead: pool unreachable, heartbeat
        older than ``timeout_s``, or — for a node that has never beaten —
        first seen by THIS monitor more than ``grace_s`` (default
        ``timeout_s``) ago. The grace window exists because a freshly
        joined or restarted node has a reachable pool but no heartbeat
        record yet; declaring it dead on sight would trigger a spurious
        repair sweep around a healthy node."""
        now = now or time.time()
        grace = timeout_s if grace_s is None else grace_s
        dead = []
        for nid in self.stores:
            pool = self.stores[nid].pool
            if not getattr(pool, "alive", True):
                dead.append(nid)  # pmem unreachable: unambiguously dead
                continue
            try:
                hb = pool.get_json("hb/heartbeat.json")
            except FileNotFoundError:
                hb = None  # pool reachable, node just never beat (yet)
            except IOError:
                dead.append(nid)
                continue
            if hb is not None:
                self._first_seen.pop(nid, None)
                if now - hb["ts"] > timeout_s:
                    dead.append(nid)
                continue
            first = self._first_seen.setdefault(nid, now)
            if now - first > grace:
                dead.append(nid)
        return dead


class StragglerDetector:
    """Flags nodes whose step times exceed k x median of the fleet."""

    def __init__(self, threshold: float = 1.5, window: int = 16):
        self.threshold = threshold
        self.window = window
        self._times: Dict[str, List[float]] = {}

    def record(self, nid: str, step_seconds: float) -> None:
        hist = self._times.setdefault(nid, [])
        hist.append(step_seconds)
        del hist[:-self.window]

    def forget(self, nid: str) -> None:
        """Drop a removed node's history. A dead node's stale step times
        would otherwise keep skewing the fleet median forever — slow
        final steps from the victim can flag healthy survivors, and a
        fast victim deflates the median the survivors are judged by."""
        self._times.pop(nid, None)

    def stragglers(self) -> List[str]:
        if len(self._times) < 2:
            return []
        medians = {n: statistics.median(v) for n, v in self._times.items()
                   if v}
        fleet = statistics.median(medians.values())
        return [n for n, m in medians.items()
                if m > self.threshold * fleet]
