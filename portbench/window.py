"""Window arithmetic: exact percentiles and rates over a run's log.

The measured window opens when set-up ends and closes with the first
request (or, in a decode mix, batch) that finishes at or after the
window's nominal end, so it holds whole requests only and every
second of it, gaps included, counts. Every request that finished in it
counts: a rate is the work of all of them over the window's seconds, a
tail the percentile of all their latencies.
"""
from __future__ import annotations

import math
from typing import List, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value that at least q% of the values do not exceed."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return float(xs[rank - 1])


def rate(amounts: Sequence[float], seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("an empty window")
    return float(sum(amounts)) / seconds


def ttft(requests: List[dict]) -> List[float]:
    """Each request's time from its issue to its first token on the
    host."""
    return [r["t_first"] - r["t_issue"] for r in requests]
