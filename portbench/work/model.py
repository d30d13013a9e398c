"""The model's own operation and byte counts, from the configuration's
numbers and the request's sizes (no measurement): what ``mfu.*`` divides
by the peak.

Each part of the model counts what its kind states
(``portbench/reference/<kind>.py``, found through ``kinds.py``): 2
operations a weight of each projection a token passes through, and each
kind's own terms (attention's 4 Dh a visible pair and query head, the
SSD recurrence's 4 P N a token and head, the head at a prompt's last
position only, as the program computes it). A decode step with ``pos``
positions held moves at least every weight once (the embedding's rows of
the batch only) and what each layer states it must read and write of its
state or cache.
"""
from __future__ import annotations

import math

from portbench import kinds
from portbench.work import peaks


def _model(cfg: dict, fn: str, *args) -> float:
    layers = sum(getattr(k, fn)(cfg, *args) for _, mixer, mlp in
                 kinds.layers(cfg) for k in (mixer, mlp))
    return layers * kinds.repeats(cfg) + getattr(kinds.top(cfg), fn)(
        cfg, *args)


def prefill_flops(cfg: dict, batch: int, s: int) -> float:
    return _model(cfg, "prefill_flops", batch, s)


def decode_step(cfg: dict, batch: int, pos: int):
    """(operations, least bytes) of one decode step of ``batch`` rows with
    ``pos`` positions held before it."""
    return _model(cfg, "decode_flops", batch, pos), \
        _model(cfg, "decode_bytes", batch, pos)


def decode_step_least_seconds(cfg: dict, batch: int, pos: int) -> float:
    return peaks.least_seconds(*decode_step(cfg, batch, pos))


def decode_least_seconds(cfg: dict, batch: int, pos: int,
                         steps: int) -> float:
    """``steps`` decode steps from ``pos`` held positions."""
    return math.fsum(decode_step_least_seconds(cfg, batch, pos + j)
                     for j in range(steps))
