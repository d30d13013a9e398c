"""The telemetry plane's process-local half: ``metrics`` (counters,
gauges, histograms, ``StatsView``). Spans, the flight recorder and the
plane itself wait for ROADMAP Queue A item 10."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     Registry, StatsView, registry_of)
