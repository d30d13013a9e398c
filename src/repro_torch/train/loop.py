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
loop pays for that checkpoint. In-flight saves and their buddy
replicates are joined at the end, and the final checkpoint's acknowledged
durability is recorded (``"REPLICATED"`` on a cluster of two or more
nodes).

With ``drain_every`` every save is also drained to the external store
(durability ``"DRAINED"``). ``fault_at`` kills the last node after that
step, as JAX's hook does: in-flight saves and their replicas are joined
first (``recovery.quiesce_inflight``), the newest recoverable checkpoint
is restored around the dead node onto the card (a delta step's shards
decoded there, wherever they were read), the replication factor is
restored (the running repair daemon's ``wait_for``, else an inline
``tiered.repair``), and the loop resumes from the restored state. The
live state is dropped before the restore, so the card still holds at
most one extra copy. ``repair_daemon`` runs the ``RepairDaemon`` for the
whole loop; the dead node gets no more heartbeats or step times.
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
    drain_every: int = 0         # 0 = no drains (any other: every save)
    heartbeat_node: str = "node0"
    # run the continuous RepairDaemon alongside training: node losses
    # are repaired in the background (below foreground I/O) instead of
    # waiting for the fault hook
    repair_daemon: bool = False
    daemon_poll_s: float = 0.02


@dataclass
class LoopState:
    step: int = 0
    losses: List[float] = field(default_factory=list)
    ckpt_seconds: List[float] = field(default_factory=list)
    recovered_at: List[int] = field(default_factory=list)
    # acknowledged durability of the final checkpoint at shutdown
    final_ckpt_durability: Optional[str] = None


def run(train_step_fn: Callable, params, opt_state,
        batches: Iterator[Dict[str, np.ndarray]], cluster: SimCluster,
        loop_cfg: LoopConfig,
        fault_at: Optional[int] = None) -> LoopState:
    """Drive training with asynchronous checkpoints. ``fault_at`` kills
    a node after that step to exercise recovery."""
    state = LoopState()
    sd = StragglerDetector()
    last_full = None
    last_ticket = None
    dead_nodes: set = set()
    daemon = cluster.start_repair_daemon(poll_s=loop_cfg.daemon_poll_s) \
        if loop_cfg.repair_daemon else None
    try:
        for step, batch in enumerate(batches):
            if last_ticket is not None and last_ticket.step < step:
                # the save still holding an older state must let go of
                # it before this step makes another
                t0 = time.time()
                last_ticket.device_done.result()
                state.ckpt_seconds[-1] += time.time() - t0
            t0 = time.time()
            params, opt_state, metrics = train_step_fn(params, opt_state,
                                                       batch)
            loss = float(metrics["loss"])
            state.losses.append(loss)
            state.step = step + 1
            dt = time.time() - t0
            for nid in cluster.node_ids:
                if nid in dead_nodes:
                    continue  # a dead node stays out of the fleet median
                cluster.heartbeat.beat(nid, step)
                sd.record(nid, dt)
            if (step + 1) % loop_cfg.ckpt_every == 0:
                # fail fast: a checkpoint that failed to COMMIT surfaces
                cluster.tiered.raise_if_failed()
                t0 = time.time()
                base = last_full if loop_cfg.delta_ckpt else None
                last_ticket = cluster.tiered.save_async(
                    step + 1, {"params": params, "opt": opt_state},
                    base_step=base, drain=bool(loop_cfg.drain_every))
                if not loop_cfg.delta_ckpt or last_full is None:
                    last_full = step + 1
                # what the step pays: the submit (+ slot backpressure)
                state.ckpt_seconds.append(time.time() - t0)
            if fault_at is not None and step + 1 == fault_at:
                # node loss at a replication-quiescent point: join the
                # in-flight saves and replicas (the dead node's errors
                # are kept on the recovery object) before the kill
                cluster.recovery.quiesce_inflight()
                victim = cluster.node_ids[-1]
                sd.forget(victim)
                dead_nodes.add(victim)
                cluster.kill_node(victim)
                # the restored state replaces the live one: drop it
                # first, so the card holds one copy beside the restore
                params = opt_state = None
                restored, _ = \
                    cluster.checkpointer.restore_latest_recoverable(
                        lost_nodes=[victim])
                # restore the replication factor before resuming: the
                # daemon's sweep, or an inline repair when there is no
                # daemon or its sweep does not converge in time
                if daemon is None or \
                        not daemon.wait_for([victim], timeout=60.0):
                    cluster.tiered.repair([victim])
                params, opt_state = restored["params"], restored["opt"]
                del restored
                state.recovered_at.append(step + 1)
                fault_at = None
    finally:
        if daemon is not None:
            cluster.stop_repair_daemon()
    # clean shutdown: strict barrier
    cluster.tiered.join()
    cluster.checkpointer.wait_async()
    if last_ticket is not None:
        state.final_ckpt_durability = last_ticket.durability()
    return state
