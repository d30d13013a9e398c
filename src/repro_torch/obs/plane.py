"""TelemetryPlane: the one handle the data plane talks to.

Owns the metrics ``Registry`` plus one ``FlightRecorder`` per node
pool. Core modules take ``obs=None`` kwargs; a None plane (or
``enabled=False``) degrades every call to a cheap no-op or a pure
in-DRAM metric update, so the library works stand-alone and the
overhead bench can compare telemetry on/off on the same code path.

Event routing: ``event``/``begin``/``end`` write to the named node's
ring when it is alive, falling back to the home (first) node's ring —
a dying node's last events land *somewhere* durable, which is the whole
point of a flight recorder. Metric snapshots are best-effort JSON
(``obs/metrics.json`` on every live pool, written at clean shutdown);
after a crash the rings are the source of truth and
``python -m repro_torch.obs.report`` replays them.

A copy of ``repro/obs/plane.py``, kept so that the port imports nothing
of the JAX package. Attrs are written as JSON, so callers pass plain
Python values (ints, floats, strings, lists), never tensors.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

from repro_torch.obs.metrics import Counter, Gauge, Histogram, Registry
from repro_torch.obs.recorder import EVT_BEGIN, EVT_END, EVT_POINT, \
    FlightRecorder
from repro_torch.obs.trace import Span, new_id

SNAPSHOT_NAME = "obs/metrics.json"


class TelemetryPlane:
    def __init__(self, pools: Optional[Dict[str, Any]] = None, *,
                 enabled: bool = True,
                 registry: Optional[Registry] = None,
                 slots: Optional[int] = None,
                 slot_bytes: Optional[int] = None):
        self.enabled = enabled
        self.registry = registry if registry is not None else Registry()
        self.recorders: Dict[str, FlightRecorder] = {}
        self._home: Optional[str] = None
        self._ring_kw = {}
        if slots is not None:
            self._ring_kw["slots"] = slots
        if slot_bytes is not None:
            self._ring_kw["slot_bytes"] = slot_bytes
        if pools and enabled:
            for nid in sorted(pools):
                self.attach(nid, pools[nid])

    def attach(self, nid: str, pool) -> None:
        """Create/open the node's flight-recorder ring."""
        self.recorders[nid] = FlightRecorder(pool, **self._ring_kw)
        if self._home is None:
            self._home = nid

    # ---- registry passthrough ---------------------------------------
    def counter(self, name: str) -> Counter:
        return self.registry.counter(name)

    def gauge(self, name: str) -> Gauge:
        return self.registry.gauge(name)

    def histogram(self, name: str) -> Histogram:
        return self.registry.histogram(name)

    # ---- flight-recorder events -------------------------------------
    def _recorder(self, node: Optional[str]) -> Optional[FlightRecorder]:
        if not self.recorders:
            return None
        rec = self.recorders.get(node) if node is not None else None
        if rec is None and self._home is not None:
            rec = self.recorders.get(self._home)
        return rec

    def event(self, name: str, *, node: Optional[str] = None,
              trace: int = 0, span: int = 0, parent: int = 0,
              **attrs) -> None:
        """Point event on the node's ring (no-op when disabled)."""
        if not self.enabled:
            return
        rec = self._recorder(node)
        if rec is not None:
            ok = rec.record(EVT_POINT, name, trace=trace, span=span,
                            parent=parent, attrs=attrs or None)
            if not ok and node is not None and node != self._home:
                home = self._recorder(None)
                if home is not None:
                    home.record(EVT_POINT, name, trace=trace, span=span,
                                parent=parent, attrs=attrs or None)

    def begin(self, name: str, *, node: Optional[str] = None,
              trace: Optional[int] = None, parent: int = 0,
              **attrs) -> Span:
        """Open a span (always returns a handle, even when disabled —
        callers pass it straight back to ``end``)."""
        sp = Span(name=name, trace=trace or new_id(), span=new_id(),
                  parent=parent, node=node, t0=time.time())
        if self.enabled:
            rec = self._recorder(node)
            if rec is not None:
                rec.record(EVT_BEGIN, name, ts=sp.t0, trace=sp.trace,
                           span=sp.span, parent=parent,
                           attrs=attrs or None)
        return sp

    def end(self, span: Optional[Span], *, status: str = "ok",
            **attrs) -> None:
        if span is None:
            return
        t1 = time.time()
        self.registry.histogram(f"span.{span.name}.s") \
            .observe(t1 - span.t0)
        if self.enabled:
            rec = self._recorder(span.node)
            if rec is not None:
                out = {"status": status}
                out.update(attrs)
                rec.record(EVT_END, span.name, ts=t1, trace=span.trace,
                           span=span.span, parent=span.parent,
                           attrs=out)

    # ---- snapshots --------------------------------------------------
    def snapshot(self) -> dict:
        snap = self.registry.snapshot()
        snap["ts"] = time.time()
        snap["recorder"] = {
            nid: {"committed": rec.committed, "drops": rec.drops}
            for nid, rec in sorted(self.recorders.items())}
        return snap

    def persist_snapshot(self) -> int:
        """Write the metrics snapshot to every live pool (clean
        shutdown only — after a crash the rings tell the story).
        Returns the number of pools that took it."""
        snap = self.snapshot()
        wrote = 0
        for rec in self.recorders.values():
            try:
                rec.pool.put_json(SNAPSHOT_NAME, snap)
            except (IOError, OSError):
                continue  # dead pool: the survivors carry the snapshot
            wrote += 1
        return wrote
