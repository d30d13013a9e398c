"""Post-crash flight-recorder replay CLI.

    python -m repro_torch.obs.report <pmem-root> [--trace HEX] [--json]

``<pmem-root>`` is the cluster's pmem directory (one subdirectory per
node — ``SimCluster`` uses ``<root>/pmem``); a single node directory
works too. Every surviving node's ``obs/flightring`` is replayed
through the sanctioned ``PMemRegion`` read path, the events are merged
into causally-ordered per-trace span timelines, and the most recent
``obs/metrics.json`` snapshot (written at clean shutdown) is dumped if
one survived. After a crash there is no snapshot — the rings themselves
are the diagnosis, including each node's last pre-crash event.

A copy of ``repro/obs/report.py`` reading through the port's
``PMemPool``: each package's report reads the other's pmem root.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import List, Optional, Tuple

from repro_torch.core.pmem import PMemPool
from repro_torch.obs.plane import SNAPSHOT_NAME
from repro_torch.obs.recorder import EVT_BEGIN, EVT_END, FlightRecorder
from repro_torch.obs.trace import build_traces

_KIND_MARK = {EVT_BEGIN: ">", EVT_END: "<"}


def load_events(root: Path) -> Tuple[List[dict], Optional[dict]]:
    """Replay every node ring under ``root`` (the cluster pmem dir, one
    subdirectory per node); returns (events tagged with their node,
    newest surviving metrics snapshot or None)."""
    events: List[dict] = []
    snapshot: Optional[dict] = None
    snap_ts = -1.0
    if not root.is_dir():
        return events, snapshot
    for sub in sorted(p for p in root.iterdir() if p.is_dir()):
        nid = sub.name
        pool = PMemPool(root, nid)
        for ev in FlightRecorder.replay(pool):
            ev["node"] = nid
            events.append(ev)
        try:
            snap = pool.get_json(SNAPSHOT_NAME)
        except (IOError, OSError, KeyError, ValueError):
            snap = None
        if isinstance(snap, dict):
            ts = float(snap.get("ts", 0.0))
            if ts >= snap_ts:
                snapshot, snap_ts = snap, ts
    return events, snapshot


def _trace_t0(tr: dict) -> float:
    """Earliest timestamp seen in a trace (sort key for the report)."""
    times = [sp["t0"] or sp["t1"] or 0.0 for sp in tr["spans"].values()]
    times += [ev["ts"] for ev in tr["points"]]
    return min(times) if times else 0.0


def _fmt_ts(ts: float) -> str:
    return time.strftime("%H:%M:%S", time.localtime(ts)) + \
        f".{int((ts % 1) * 1e6):06d}"


def _fmt_event(ev: dict) -> str:
    mark = _KIND_MARK.get(ev["kind"], ".")
    ids = ""
    if ev["span"] or ev["parent"]:
        ids = f" span={ev['span']:x}"
        if ev["parent"]:
            ids += f" parent={ev['parent']:x}"
    attrs = ""
    if ev["attrs"]:
        attrs = " " + ",".join(f"{k}={v}"
                               for k, v in sorted(ev["attrs"].items()))
    return (f"  {_fmt_ts(ev['ts'])} {ev['node']:>8} {mark} "
            f"{ev['name']}{ids}{attrs}")


def render(events: List[dict], snapshot: Optional[dict],
           only_trace: Optional[int] = None) -> str:
    out: List[str] = []
    traces = build_traces(events)
    nodes = sorted({ev["node"] for ev in events})
    out.append(f"flight recorder: {len(events)} events from "
               f"{len(nodes)} ring(s) {nodes}")
    for tid in sorted(traces, key=lambda t: _trace_t0(traces[t])):
        if only_trace is not None and tid != only_trace:
            continue
        tr = traces[tid]
        tevents = [ev for ev in events if ev["trace"] == tid]
        tevents.sort(key=lambda e: (e["ts"], e["seq"]))
        label = f"trace {tid:x}" if tid else "untraced events"
        roots = [tr["spans"][r]["name"] for r in tr["roots"]]
        out.append("")
        out.append(f"{label}  spans={len(tr['spans'])} "
                   f"roots={roots}")
        for ev in tevents:
            out.append(_fmt_event(ev))
    # per-node last pre-crash event: the line a post-mortem reads first
    out.append("")
    out.append("last event per ring:")
    for nid in nodes:
        last = max((ev for ev in events if ev["node"] == nid),
                   key=lambda e: e["seq"])
        out.append(_fmt_event(last))
    if snapshot is not None:
        out.append("")
        out.append("metrics snapshot (clean-shutdown survivor):")
        out.append(json.dumps(snapshot, indent=2, sort_keys=True,
                              default=str))
    else:
        out.append("")
        out.append("no metrics snapshot found (crash before clean "
                   "shutdown — the rings above are the record)")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="replay crash-persistent flight-recorder rings "
                    "into a causally-ordered timeline")
    ap.add_argument("root", help="cluster pmem directory "
                                 "(one subdir per node)")
    ap.add_argument("--trace", default=None,
                    help="only show this trace id (hex)")
    ap.add_argument("--json", action="store_true",
                    help="dump raw events as JSON instead of a "
                         "timeline")
    args = ap.parse_args(argv)
    events, snapshot = load_events(Path(args.root))
    if args.json:
        print(json.dumps({"events": events, "snapshot": snapshot},
                         indent=2, default=str))
        return 0
    if not events:
        print(f"no flight-recorder events under {args.root}")
        return 1
    only = int(args.trace, 16) if args.trace else None
    print(render(events, snapshot, only))
    return 0


if __name__ == "__main__":
    sys.exit(main())
