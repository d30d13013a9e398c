"""Pmem-native telemetry plane (a copy of ``repro/obs``).

Three layers, as in the JAX package:

  * ``metrics``  — process-local registry: counters, gauges,
    bounded-memory histograms; ``StatsView`` read-through aliases keep
    the dict-shaped stats surfaces alive.
  * ``trace``    — correlation IDs + span trees reconstructed from
    recorder events.
  * ``recorder`` — crash-persistent per-node pmem flight recorder
    (fixed-slot ring under MetaLog's committed-tail discipline), byte for
    byte the JAX package's ring.

``plane.TelemetryPlane`` ties them together; ``report`` is the
post-crash replay CLI (``python -m repro_torch.obs.report``).
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     Registry, StatsView, registry_of)
from repro_torch.obs.plane import TelemetryPlane  # noqa: F401
from repro_torch.obs.recorder import FlightRecorder  # noqa: F401
from repro_torch.obs.trace import Span, build_traces, ctx, new_id  # noqa: F401
