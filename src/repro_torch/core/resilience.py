"""Failure detection, straggler statistics, recovery orchestration.

PyTorch counterpart of ``repro/core/resilience.py``: ``Heartbeat`` (small
records in each node's pmem pool, readable by the monitor),
``StragglerDetector`` (per-step durations against the fleet median) and
``FailureRecovery``: a dead node -> the newest checkpoint the acks mark
recoverable, restored onto the checkpointer's device from replicas or
drained copies -> the replication factor restored by ``TieredIO.repair``
(or read from the running ``RepairDaemon``'s ledger).
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List, Optional, Set

from repro_torch.core.checkpoint import DistributedCheckpointer
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


class FailureRecovery:
    def __init__(self, ckpt: DistributedCheckpointer, hb: Heartbeat,
                 timeout_s: float = 10.0, tiered=None,
                 straggler: Optional[StragglerDetector] = None):
        self.ckpt = ckpt
        self.hb = hb
        self.timeout_s = timeout_s
        self.tiered = tiered          # Optional[TieredIO]
        self.straggler = straggler    # forgotten on node loss, if given
        self.inflight_errors: List[Exception] = []
        # how the last recovery picked its step ({"skipped_by_ack",
        # "probed"}) and the last repair report
        self.last_restore_stats: dict = {}
        self.last_repair_report: dict = {}
        # dead nodes already restored and repaired: a polling caller acts
        # on NEW deaths only
        self._handled_dead: Set[str] = set()
        self.daemon = None
        self.daemon_wait_s = 60.0

    # ---- continuous repair daemon (owned by the monitor loop) --------
    def start_daemon(self, *, poll_s: float = 0.05, max_inflight: int = 2,
                     priority: int = 4, **kw):
        """Start the background ``RepairDaemon`` on this monitor's
        heartbeat and TieredIO engine."""
        if self.tiered is None:
            raise RuntimeError("the repair daemon needs a TieredIO engine")
        if self.daemon is None:
            from repro_torch.core.tiered_io import RepairDaemon
            self.daemon = RepairDaemon(
                self.tiered, self.hb, timeout_s=self.timeout_s,
                poll_s=poll_s, max_inflight=max_inflight,
                priority=priority, **kw)
            self.tiered.repair_daemon = self.daemon
        self.daemon.start()
        return self.daemon

    def stop_daemon(self) -> None:
        if self.daemon is not None:
            self.daemon.stop()

    def quiesce_inflight(self) -> List[Exception]:
        """Consume every in-flight TieredIO future before reading the
        checkpoint index: a committed save becomes visible, and a
        replicate or drain that died with its node is swallowed (kept in
        ``inflight_errors``, never raised)."""
        if self.tiered is None:
            return []
        errors = self.tiered.quiesce()
        self.inflight_errors.extend(errors)
        return errors

    def check_and_recover(self, now: Optional[float] = None,
                          repair: bool = True):
        """None when healthy or when every dead node was handled by an
        earlier call, else (restored_tree, manifest, dead_nodes) from the
        newest checkpoint the acks mark recoverable for the dead set,
        restored onto the checkpointer's device. With ``repair`` the
        replication factor is then restored (``last_repair_report``),
        from the running daemon's ledger when it covers the dead set."""
        dead = self.hb.dead_nodes(self.timeout_s, now)
        self._handled_dead &= set(dead)
        new = [n for n in dead if n not in self._handled_dead]
        if not new:
            return None
        if self.straggler is not None:
            for nid in new:
                self.straggler.forget(nid)
        self.quiesce_inflight()
        if self.ckpt.latest_step() is None:
            raise RuntimeError(f"nodes {dead} dead and no checkpoint exists")
        tree, manifest = self.ckpt.restore_latest_recoverable(
            lost_nodes=dead)
        self.last_restore_stats = dict(self.ckpt.last_restore_stats)
        self.last_repair_report = {}
        if repair and self.tiered is not None:
            daemon = self.daemon or self.tiered.repair_daemon
            report = None
            if daemon is not None:
                if daemon.running:
                    daemon.wait_for(dead, timeout=self.daemon_wait_s)
                if daemon.covers(dead):
                    report = daemon.report()
            if report is None:
                report = self.tiered.repair(dead)
                # this dead set is about to be marked handled: re-run a
                # sweep with transient copy errors before accepting them
                for _ in range(2):
                    if not report.get("errors"):
                        break
                    report = self.tiered.repair(dead)
            self.last_repair_report = report
        self._handled_dead |= set(dead)
        return tree, manifest, dead
