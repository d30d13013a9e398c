"""The traced stretch's idle time split by the program's own spans.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

Runs one cell as ``run.py --trace 1`` does and reduces its stretch with
the program's host spans (``repro_torch.obs.spans``: ranges in the
``serve.``, ``model.``, ``moe.`` and ``sync.`` namespaces) beside the
harness's ``pb.*`` ranges, so that each idle gap is named after the
innermost range of either under way at its middle (``reduce_events``).
Busy time, the idle share and the device time by kernel read as the
harness's own reduction (``trace.reduce_events``) reads them on the same
events; only the gaps' labels differ.

It prints the run's lines as ``run.py`` does, its result line (whose
``breakdown`` carries the program's labels), and last one JSON object:
every label's idle seconds, the share of the idle time that the
harness's reduction puts under ``pb.prefill`` or ``pb.decode_chunk``
and this one under a program span (``named_share``), and per traffic
kind:

  * ``idle_in_sync.<kind>``: 100 x the idle seconds under ``sync.*`` over
    the stretch: the card idle while the host waited for it;
  * ``idle_in_dispatch.<kind>``: 100 x the idle seconds under ``model.*``
    or ``moe.*`` over the stretch: the card idle while the host was still
    issuing the forward's work.

``idle_by_call`` names each gap also after the profiler's innermost host
range under way at its middle, an aten operator or a CUDA API call
(``idle_by_call``): where the program blocks outside the watchdog (a
blocking copy's ``cudaStreamSynchronize``) or the allocator calls
``cudaMalloc``, the pair says so.

A program without the spans records none of these ranges: its labels are
the harness's, and the four quantities read nothing (None).
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

if __package__ in (None, ""):  # run as a script: the checkout's packages
    sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from portbench import trace  # noqa: E402

SYNC = ("sync.",)
DISPATCH = ("model.", "moe.")
#: the harness's labels of the time inside the engine's calls
ENGINE = ("pb.prefill", "pb.decode_chunk")
#: the (span, host call) pairs printed, by idle seconds
CALLS = 25


def namespaces() -> Tuple[str, ...]:
    """The program's span namespaces; none for a program without the
    spans."""
    try:
        from repro_torch.obs.spans import NAMESPACES
    except ImportError:
        return ()
    return NAMESPACES


class SpanTrace(trace.Trace):
    """A reduced stretch whose gaps may carry the program's labels;
    ``program_ranges`` counts its ranges of the program's."""

    def __init__(self, window, device, ranges):
        super().__init__(window, device, ranges)
        self.program_ranges = sum(not n.startswith("pb.")
                                  for n, _, _ in ranges)


def reduce_events(events: List[dict],
                  names: Optional[Tuple[str, ...]] = None) -> SpanTrace:
    """``trace.reduce_events`` with the ranges in the namespaces ``names``
    (default: the program's) kept beside the ``pb.*`` ones."""
    keep = ("pb.",) + tuple(namespaces() if names is None else names)
    device, ranges, window = [], [], None
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        a = float(ev["ts"])
        b = a + float(ev["dur"])
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in trace.DEVICE_CATS:
            device.append((name, a, b))
        elif cat == "user_annotation" and name.startswith(keep):
            ranges.append((name, a, b))
            if name == trace.STRETCH:
                window = (a, b)
    if window is None:
        raise ValueError(f"no {trace.STRETCH} range in the trace")
    if not device:
        raise ValueError("the trace holds no device activity")
    return SpanTrace(window, device, ranges)


def idle_in(t: trace.Trace, prefixes: Tuple[str, ...]) -> float:
    """The idle seconds whose label starts with one of ``prefixes``."""
    return sum(s for n, s in t.idle_by_label.items()
               if n.startswith(tuple(prefixes)))


def idle_in_percent(t: Optional[trace.Trace], prefixes: Tuple[str, ...]
                    ) -> Optional[float]:
    """100 x ``idle_in(prefixes)`` over the stretch; None without a trace
    or without the program's spans in it."""
    if not isinstance(t, SpanTrace) or not t.program_ranges:
        return None
    return 100.0 * idle_in(t, prefixes) / t.window_s


def named_share(harness_trace: trace.Trace, t: trace.Trace
                ) -> Optional[float]:
    """Of the idle seconds the harness's reduction puts under
    ``pb.prefill`` or ``pb.decode_chunk``, the share this one names after
    a program span (the same gaps, relabelled where a span was under
    way)."""
    engine = idle_in(harness_trace, ENGINE)
    if engine <= 0:
        return None
    return 1.0 - idle_in(t, ENGINE) / engine


#: the profiler's own host ranges: aten operators and CUDA API calls
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


def _innermost(ranges: List[Tuple[str, float, float]]):
    """A lookup of the innermost of properly nested ``ranges`` (one
    thread's) under way at a time: the last range to start at or before
    it, else the nearest of its ancestors that is still under way."""
    import bisect
    ranges = sorted(ranges, key=lambda r: (r[1], -r[2]))
    starts = [r[1] for r in ranges]
    parent, stack = [], []
    for i, (_, a, b) in enumerate(ranges):
        while stack and ranges[stack[-1]][2] < a:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)

    def at(t: float):
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and ranges[i][2] < t:
            i = parent[i]
        return ranges[i] if i >= 0 else None
    return at


def idle_by_call(events: List[dict], names: Optional[Tuple[str, ...]] = None
                 ) -> Dict[str, float]:
    """Each idle gap of the stretch named after the program's innermost
    span and the profiler's innermost host range (an aten operator or a
    CUDA API call, such as a ``cudaStreamSynchronize`` inside a blocking
    copy or a ``cudaMalloc``) under way at its middle, as ``"<span> |
    <call>"``, in seconds."""
    keep = ("pb.",) + tuple(namespaces() if names is None else names)
    device, spans_, calls, window = [], [], {}, None
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        a = float(ev["ts"])
        r = (ev.get("name", ""), a, a + float(ev["dur"]))
        cat = ev.get("cat", "")
        if cat in trace.DEVICE_CATS:
            device.append(r)
        elif cat == "user_annotation" and r[0].startswith(keep):
            if r[0] == trace.STRETCH:
                window = r[1:]
            else:
                spans_.append(r)
        elif cat in HOST_CATS:
            calls.setdefault(ev.get("tid"), []).append(r)
    if window is None or not device:
        raise ValueError("no stretch or no device activity in the trace")
    lo, hi = window
    busy = trace._union([(max(a, lo), min(b, hi)) for _, a, b in device
                         if b > lo and a < hi])
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    span_at = _innermost(spans_)
    call_at = [_innermost(rs) for rs in calls.values()]
    out: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        sp = span_at(mid)
        inner = [c for c in (f(mid) for f in call_at) if c is not None]
        call = min(inner, key=lambda c: c[2] - c[1])[0] if inner else "-"
        key = f"{sp[0] if sp else 'pb.none'} | {call}"
        out[key] = out.get(key, 0.0) + (b - a) / 1e6
    return out


def split(t: trace.Trace, kind: str) -> Dict[str, Optional[float]]:
    """The two quantities of a stretch of a ``kind`` mix, by name."""
    return {f"idle_in_sync.{kind}": idle_in_percent(t, SYNC),
            f"idle_in_dispatch.{kind}": idle_in_percent(t, DISPATCH)}


def main(argv=None) -> int:
    import argparse
    import json
    from unittest import mock

    from portbench.run import CHECKOUT, _environment, forbidden_modules
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    _environment()
    sys.path[:0] = [str(CHECKOUT / "src")]
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("the split needs a CUDA device", file=sys.stderr)
        return 2
    seen = {}
    plain = trace.reduce_events

    def both(events):
        seen["harness"] = plain(events)
        seen["spans"] = reduce_events(events)
        seen["calls"] = idle_by_call(events)
        return seen["spans"]

    bench = harness.Bench(CHECKOUT)
    kind = bench.traffic(bench.cell(args.workload)["traffic"])["kind"]
    with mock.patch.object(trace, "reduce_events", both):
        out = harness.run_cell(bench, args.workload, args.seed,
                               args.seconds, True, device="cuda")
    if forbidden_modules():
        print(f"loaded in the measured process: {forbidden_modules()}",
              file=sys.stderr)
        return 3
    line = dict(out["result"])
    line["checks"] = out["checks"]
    print(json.dumps(line))
    t = seen["spans"]
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "window_s": t.window_s, "busy_s": t.busy_s,
        "idle_share": 100.0 * t.idle_share,
        "named_share": named_share(seen["harness"], t),
        **split(t, kind),
        "idle_by_label": dict(sorted(t.idle_by_label.items(),
                                     key=lambda kv: -kv[1])),
        "idle_by_call": dict(sorted(seen["calls"].items(),
                                    key=lambda kv: -kv[1])[:CALLS])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
