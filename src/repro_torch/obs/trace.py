"""Trace spans and correlation IDs for the data plane.

A *trace* is one end-to-end lifecycle (a ``save_async`` replicate →
drain → ack, a repair sweep's scan → copy → re-ack, one workflow run).
A *span* is one timed operation inside it. IDs are 63-bit random ints
(JSON-safe, nonzero); 0 means "untraced". Spans carry no global state —
the context is threaded explicitly through scheduler ``span=`` kwargs,
checkpoint manifests and ack-record info dicts, so correlation survives
thread hops and, via the flight recorder, crashes.

``build_traces`` reconstructs span trees from recorder events — shared
by ``repro_torch.obs.report`` and the trace-propagation tests.

A copy of ``repro/obs/trace.py`` (the standard library only), kept so
that the port imports nothing of the JAX package.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

# Flight-recorder event kinds (also the replay wire values).
EVT_POINT = 0
EVT_BEGIN = 1
EVT_END = 2


def new_id() -> int:
    """63-bit nonzero random correlation id."""
    while True:
        v = struct.unpack("<Q", os.urandom(8))[0] >> 1
        if v:
            return v


@dataclass
class Span:
    """A live span handle (ended via ``TelemetryPlane.end``)."""
    name: str
    trace: int
    span: int
    parent: int = 0
    node: Optional[str] = None
    t0: float = 0.0


def ctx(span: Optional[Span]) -> Optional[dict]:
    """Propagation context for scheduler ``span=`` kwargs / manifests."""
    if span is None:
        return None
    return {"trace": span.trace, "span": span.span}


def build_traces(events: Iterable[dict]) -> Dict[int, dict]:
    """Group replayed recorder events into per-trace span trees.

    Returns ``{trace_id: {"spans": {span_id: {...}}, "roots": [...],
    "points": [...]}}``. A span whose BEGIN was overwritten by ring
    wrap-around is synthesized from its END so the tree stays
    connected. Trace 0 collects untraced events.
    """
    traces: Dict[int, dict] = {}
    for ev in sorted(events, key=lambda e: (e["ts"], e.get("seq", 0))):
        tr = traces.setdefault(ev["trace"],
                               {"spans": {}, "points": [], "roots": []})
        spans = tr["spans"]
        if ev["kind"] == EVT_BEGIN:
            spans[ev["span"]] = {
                "name": ev["name"], "parent": ev["parent"],
                "node": ev.get("node"), "t0": ev["ts"], "t1": None,
                "status": None, "attrs": dict(ev.get("attrs") or {}),
                "events": []}
        elif ev["kind"] == EVT_END:
            sp = spans.get(ev["span"])
            if sp is None:
                sp = spans[ev["span"]] = {
                    "name": ev["name"], "parent": ev["parent"],
                    "node": ev.get("node"), "t0": None, "t1": None,
                    "status": None, "attrs": {}, "events": []}
            sp["t1"] = ev["ts"]
            attrs = dict(ev.get("attrs") or {})
            sp["status"] = attrs.pop("status", "ok")
            sp["attrs"].update(attrs)
        else:
            tr["points"].append(ev)
            sp = spans.get(ev["span"]) or spans.get(ev["parent"])
            if sp is not None:
                sp["events"].append(ev)
    for tr in traces.values():
        spans = tr["spans"]
        tr["roots"] = sorted(sid for sid, sp in spans.items()
                             if sp["parent"] not in spans)
    return traces


def connected_to_root(trace: dict, span_id: int) -> bool:
    """True if ``span_id`` reaches a root span via parent links."""
    spans = trace["spans"]
    seen = set()
    cur = span_id
    while cur in spans and cur not in seen:
        seen.add(cur)
        parent = spans[cur]["parent"]
        if parent not in spans:
            return cur in trace["roots"]
        cur = parent
    return False


def span_names(trace: dict) -> List[str]:
    return sorted({sp["name"] for sp in trace["spans"].values()})
