"""Training loop: steps + the paper's systemware hooks.

PyTorch counterpart of ``repro/train/loop.py``. Per step: train_step ->
heartbeat -> straggler stats. Every ``ckpt_every`` steps the loop hands
the step's state, as it lies on the card, to the TieredIO engine via
``save_async``: the state is never written in place (the optimizer is
functional), so the save may hold it while the next step runs. Before a
step that would make a second newer state, the loop waits until the
previous save has let go of its device tensors (``ticket.device_done``),
so the card holds at most one extra copy of the state; that wait is
added to the checkpoint's ``ckpt_seconds`` entry, which holds all the
loop pays for that checkpoint. In-flight saves are joined at the end.

Failure injection (``fault_at``), the repair daemon and drains to the
external store wait for the replication slice (ROADMAP Queue A item 2).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from repro_torch.core.cluster import SimCluster
from repro_torch.core.resilience import StragglerDetector


@dataclass
class LoopConfig:
    steps: int = 20
    ckpt_every: int = 5
    delta_ckpt: bool = False     # incremental checkpoints vs last full
    drain_every: int = 0         # drains: not ported (raises)
    repair_daemon: bool = False  # not ported (raises)


@dataclass
class LoopState:
    step: int = 0
    losses: List[float] = field(default_factory=list)
    ckpt_seconds: List[float] = field(default_factory=list)
    recovered_at: List[int] = field(default_factory=list)
    # acknowledged durability of the final checkpoint at shutdown
    final_ckpt_durability: Optional[str] = None


_REPLICATION = "(ROADMAP Queue A item 2: replication, drain and repair)"


def run(train_step_fn: Callable, params, opt_state,
        batches: Iterator[Dict[str, np.ndarray]], cluster: SimCluster,
        loop_cfg: LoopConfig,
        fault_at: Optional[int] = None) -> LoopState:
    """Drive training with asynchronous checkpoints."""
    if fault_at is not None or loop_cfg.repair_daemon:
        raise NotImplementedError(
            f"failure injection and the repair daemon are not ported "
            f"{_REPLICATION}")
    if loop_cfg.drain_every:
        raise NotImplementedError(
            f"drains to the external store are not ported {_REPLICATION}")
    state = LoopState()
    sd = StragglerDetector()
    last_full = None
    last_ticket = None
    for step, batch in enumerate(batches):
        if last_ticket is not None and last_ticket.step < step:
            # the save still holding an older state must let go of it
            # before this step makes another
            t0 = time.time()
            last_ticket.device_done.result()
            state.ckpt_seconds[-1] += time.time() - t0
        t0 = time.time()
        params, opt_state, metrics = train_step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        state.losses.append(loss)
        state.step = step + 1
        dt = time.time() - t0
        for nid in cluster.node_ids:
            cluster.heartbeat.beat(nid, step)
            sd.record(nid, dt)
        if (step + 1) % loop_cfg.ckpt_every == 0:
            # fail fast: a checkpoint that failed to COMMIT surfaces now
            cluster.tiered.raise_if_failed()
            t0 = time.time()
            base = last_full if loop_cfg.delta_ckpt else None
            last_ticket = cluster.tiered.save_async(
                step + 1, {"params": params, "opt": opt_state},
                base_step=base)
            if not loop_cfg.delta_ckpt or last_full is None:
                last_full = step + 1
            # what the step pays: the submit (+ slot backpressure)
            state.ckpt_seconds.append(time.time() - t0)
    # clean shutdown: strict barrier
    cluster.tiered.join()
    cluster.checkpointer.wait_async()
    if last_ticket is not None:
        state.final_ckpt_durability = last_ticket.durability()
    return state
