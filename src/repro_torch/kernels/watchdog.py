"""Wait for the card with a deadline, so that a hung kernel fails.

A wgmma kernel's mbarrier wait spins without a limit (a limit with a trap
in that loop makes ptxas drop the ``setmaxnreg`` register hand-over; see
``kernels/csrc/hopper.cuh``), so a wrong phase or byte count would hang
``torch.cuda.synchronize()`` for ever. ``synchronize`` records an event on
the current stream and polls it against a deadline instead, and raises
``KernelTimeout`` when the deadline passes first. The kernel phases of
``chip_smoke.py`` and the card tests wait through it. A kernel that still
runs when it raises keeps its card until the process ends.
"""
from __future__ import annotations

import time

#: seconds a wait may take before it counts as a hang; the slowest single
#: wait of the card tests or of chip_smoke.py's kernel phases takes well
#: under 1 s
DEADLINE_S = 120.0
#: the first poll interval, which doubles up to MAX_POLL_S
POLL_S = 1e-4
MAX_POLL_S = 0.01


class KernelTimeout(RuntimeError):
    """Work queued on the card did not finish within its deadline."""


def wait_event(event, what: str = "the card's queued work", *,
               clock=time.monotonic, sleep=time.sleep) -> float:
    """Poll ``event.query()`` until it is done or DEADLINE_S seconds have
    passed; return the seconds waited or raise ``KernelTimeout``.
    ``clock`` and ``sleep`` are the time module's (a test passes fakes)."""
    t0 = clock()
    interval = POLL_S
    while not event.query():
        if clock() - t0 > DEADLINE_S:
            raise KernelTimeout(f"{what} did not finish within "
                                f"{DEADLINE_S} s (a kernel hangs?)")
        sleep(interval)
        interval = min(2 * interval, MAX_POLL_S)
    return clock() - t0


def synchronize() -> float:
    """Wait, with the deadline, for the work queued so far on the current
    stream, where every kernel of the port launches; return the seconds
    waited."""
    import torch
    event = torch.cuda.Event()
    event.record()
    return wait_event(event)
