"""Metrics registry: counters, gauges, bounded-memory histograms.

A copy of ``repro/obs/metrics.py`` (the standard library only), kept so
that the port imports nothing of the JAX package: every instrument is
internally locked, histograms are fixed geometric ladders, and
``StatsView`` keeps dict-shaped stats surfaces (``TieredIO.stats``)
reading through to the counters. The JAX package's telemetry plane
(``obs/plane.py``, ``trace.py``, ``recorder.py``: spans and the
crash-persistent flight recorder) is not ported (ROADMAP Queue A item
10), so every port module that takes ``obs=`` accepts only ``None`` and
keeps its instruments in a private ``Registry`` (``registry_of``).
"""
from __future__ import annotations

import threading
from collections.abc import Mapping
from typing import Dict, Iterator

# One geometric ladder for every histogram: 1e-7 * 2^i, i in [0, 64).
# Covers sub-microsecond latencies up to ~9e11 (also fine for byte
# sizes); fixed width keeps memory bounded.
_H_LO = 1e-7
_H_BUCKETS = 64


class Counter:
    """Monotonic (plus explicit ``set`` for resettable views)."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    def set(self, v: int) -> None:
        with self._lock:
            self._v = v

    @property
    def value(self) -> int:
        with self._lock:
            return self._v


class Gauge:
    """Instantaneous level (queue depth, inflight saves, used bytes)."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._v += n

    def dec(self, n: float = 1) -> None:
        with self._lock:
            self._v -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Histogram:
    """Geometric-bucket latency/size histogram, O(1) memory."""

    __slots__ = ("name", "_counts", "_count", "_sum", "_min", "_max",
                 "_lock")

    def __init__(self, name: str):
        self.name = name
        self._counts = [0] * _H_BUCKETS
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = 0.0
        self._lock = threading.Lock()

    @staticmethod
    def _bucket(v: float) -> int:
        if v <= _H_LO:
            return 0
        b = 0
        x = _H_LO
        while x < v and b < _H_BUCKETS - 1:
            x *= 2.0
            b += 1
        return b

    def observe(self, v: float) -> None:
        v = max(0.0, float(v))
        b = self._bucket(v)
        with self._lock:
            self._counts[b] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """Approximate: upper edge of the bucket holding quantile q."""
        with self._lock:
            if not self._count:
                return 0.0
            target = q * self._count
            seen = 0
            for b, n in enumerate(self._counts):
                seen += n
                if seen >= target:
                    return min(self._max, _H_LO * (2.0 ** b))
            return self._max

    def summary(self) -> Dict[str, float]:
        with self._lock:
            if not self._count:
                return {"count": 0, "sum": 0.0}
            lo, hi, cnt, tot = self._min, self._max, self._count, \
                self._sum
        return {"count": cnt, "sum": tot, "min": lo, "max": hi,
                "mean": tot / cnt, "p50": self.percentile(0.50),
                "p95": self.percentile(0.95),
                "p99": self.percentile(0.99)}


class Registry:
    """Create-or-get instrument index; one per TelemetryPlane."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name)
            return h

    def snapshot(self) -> dict:
        """Plain-JSON view of every instrument (for ``obs/metrics.json``
        and ``BENCH_obs.json`` artifacts)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(hists.items())},
        }


class StatsView(Mapping):
    """Dict-shaped read-through alias over ``{key: Counter}``.

    ``view["saves"]`` reads the counter, ``view["saves"] = 3`` sets it,
    ``view == {"saves": 3}`` and ``dict(view)`` behave like the plain
    dicts these views replaced — existing tests and benchmarks keep
    working unchanged.
    """

    __slots__ = ("_c",)

    def __init__(self, counters: Dict[str, Counter]):
        self._c = counters

    def __getitem__(self, k: str) -> int:
        return self._c[k].value

    def __setitem__(self, k: str, v: int) -> None:
        self._c[k].set(v)

    def __iter__(self) -> Iterator[str]:
        return iter(self._c)

    def __len__(self) -> int:
        return len(self._c)

    def __eq__(self, other) -> bool:
        if isinstance(other, Mapping):
            return dict(self) == dict(other)
        return NotImplemented

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __repr__(self) -> str:
        return f"StatsView({dict(self)!r})"


def registry_of(obs) -> Registry:
    """The registry a module's instruments live in: a private one, since
    a telemetry plane (``obs`` not None) is not ported."""
    if obs is not None:
        raise NotImplementedError(
            "the telemetry plane (obs/plane.py, trace.py, recorder.py) is "
            "not ported (ROADMAP Queue A item 10): pass obs=None")
    return Registry()
