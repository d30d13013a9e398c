"""The traced stretch: ``torch.profiler`` over a fixed number of requests
or decode chunks inside the window, and its reduction to device busy
time, idle gaps by host range, and device time by kernel name.

The harness wraps its own calls in ``record_function`` ranges named
``pb.*`` (``pb.stretch`` around the whole stretch; ``pb.request``,
``pb.prefill``, ``pb.decode_chunk``, ``pb.hold``, ``pb.prompt_gen``
inside it). The trace is exported once the window has closed, to a
temporary file that is read and removed, and reduced from its events:
device activity is every ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
event; the stretch is the ``pb.stretch`` range; an idle gap (no device
activity) is named after the innermost ``pb.*`` range under way at its
middle.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STRETCH = "pb.stretch"
TOP = 10
NAME_CHARS = 160


def span(name: str, on: bool):
    """A ``record_function`` range when tracing, else nothing."""
    if not on:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(name)


class Profiler:
    """Starts and stops ``torch.profiler`` around a stretch and reduces
    what it recorded once the window has closed."""

    def __init__(self, skip: int, count: int, device_type: str = "cuda"):
        import torch
        self.skip, self.count = skip, count
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device_type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._acts = acts
        self._prof = None
        self._range = None
        self.done = False

    def warm(self) -> None:
        """Profile a trifle in set-up, so that the tracer's own start-up
        (CUPTI's) is paid before the window."""
        import torch
        with torch.profiler.profile(activities=self._acts):
            x = torch.ones(8, device="cuda" if len(self._acts) > 1
                           else "cpu")
            (x + 1).sum().item()

    def covers(self, i: int) -> bool:
        return self.skip <= i < self.skip + self.count

    def before(self, i: int) -> None:
        """Call before unit ``i`` (a request or a chunk)."""
        if i == self.skip and self._prof is None and not self.done:
            import torch
            self._prof = torch.profiler.profile(activities=self._acts)
            self._prof.start()
            self._range = torch.profiler.record_function(STRETCH)
            self._range.__enter__()

    def after(self, i: int) -> None:
        """Call after unit ``i``."""
        if i == self.skip + self.count - 1:
            self.stop()

    def stop(self) -> None:
        if self._prof is not None and not self.done:
            self._range.__exit__(None, None, None)
            self._prof.stop()
            self.done = True

    def reduce(self) -> Optional["Trace"]:
        if self._prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json", prefix="pb_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.remove(path)
        self._prof = None
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return reduce_events(events)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Trace:
    """A reduced stretch; times in seconds."""

    def __init__(self, window: Tuple[float, float],
                 device: List[Tuple[str, float, float]],
                 ranges: List[Tuple[str, float, float]]):
        lo, hi = window
        self.window_s = (hi - lo) / 1e6
        clipped = [(n, max(a, lo), min(b, hi)) for n, a, b in device
                   if b > lo and a < hi]
        self.device = clipped
        busy = _union([(a, b) for _, a, b in clipped])
        self.busy_s = sum(b - a for a, b in busy) / 1e6
        gaps, t = [], lo
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        by_label: Dict[str, float] = {}
        for a, b in gaps:
            mid = (a + b) / 2
            inner = [(e - s, n) for n, s, e in ranges
                     if n != STRETCH and s <= mid <= e]
            label = min(inner)[1] if inner else "pb.none"
            by_label[label] = by_label.get(label, 0.0) + (b - a) / 1e6
        self.idle_by_label = by_label
        ops: Dict[str, float] = {}
        for n, a, b in clipped:
            key = n[:NAME_CHARS]
            ops[key] = ops.get(key, 0.0) + (b - a) / 1e6
        self.ops = ops

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def kernel_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(b - a for n, a, b in self.device if rx.search(n)) / 1e6

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_by_label.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in gaps[:TOP]]}


def idle_percent(ctx, kind: str) -> Optional[float]:
    """The idle share, in %, of a traced run of a ``kind`` mix (the
    readers ``idle_share.<kind>``: one quantity, named apart for the
    end-to-end metric each kind's cells move)."""
    if ctx.trace is None or ctx.traffic["kind"] != kind:
        return None
    return 100.0 * ctx.trace.idle_share


def reduce_events(events: List[dict]) -> Trace:
    device, ranges, window = [], [], None
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        a = float(ev["ts"])
        b = a + float(ev["dur"])
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in DEVICE_CATS:
            device.append((name, a, b))
        elif cat == "user_annotation" and name.startswith("pb."):
            ranges.append((name, a, b))
            if name == STRETCH:
                window = (a, b)
    if window is None:
        raise ValueError(f"no {STRETCH} range in the trace")
    if not device:
        raise ValueError("the trace holds no device activity")
    return Trace(window, device, ranges)
