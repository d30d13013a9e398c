"""Simulated multi-node cluster wiring (one directory per node's B-APM).

PyTorch counterpart of ``repro/core/cluster.py``: per-node pools and
object stores, the external store (``external_bandwidth`` throttles it),
the data scheduler (stage-in, drain, replicate), the checkpointer with
buddy replication and drains, heartbeats, the DLM write-back cache over
the first node's store, the TieredIO engine ``tiered`` over all of them
and ``recovery`` (``FailureRecovery``), with JAX's arguments (``buddy``,
``dlm_capacity``, ``slots``, ``wire_codec``), ``kill_node``, ``repair``
and the repair daemon (``start_repair_daemon``). The dataset catalog,
workflows, serve sessions and the telemetry plane wait for later slices
(ROADMAP Queue A items 2(c), 2(d) and 10). ``device`` is where
checkpoints are encoded and restored and where the wire codec runs: the
card unless the caller asks for the CPU.
"""
from __future__ import annotations

import shutil
import time
from pathlib import Path
from typing import Dict, Optional

from repro_torch import resolve_device
from repro_torch.core.checkpoint import DistributedCheckpointer
from repro_torch.core.data_scheduler import DataScheduler, ExternalStore
from repro_torch.core.object_store import DistributedStore, PMemObjectStore
from repro_torch.core.pmem import PMemPool
from repro_torch.core.resilience import FailureRecovery, Heartbeat
from repro_torch.core.tiered_io import TieredIO
from repro_torch.core.tiering import DLMCache


class SimCluster:
    def __init__(self, root: Path, n_nodes: int = 4,
                 pmem_capacity: int = 1 << 32,
                 external_bandwidth: Optional[float] = None,
                 buddy: bool = True, delta: bool = False,
                 dlm_capacity: int = 1 << 28, slots: int = 2,
                 wire_codec=None, device="cuda"):
        self.root = Path(root)
        self.device = resolve_device(device)
        self.node_ids = [f"node{i}" for i in range(n_nodes)]
        self.pools: Dict[str, PMemPool] = {
            nid: PMemPool(self.root / "pmem", nid,
                          capacity_bytes=pmem_capacity)
            for nid in self.node_ids}
        self.stores: Dict[str, PMemObjectStore] = {
            nid: PMemObjectStore(pool, device=self.device)
            for nid, pool in self.pools.items()}
        self.external = ExternalStore(self.root / "external",
                                      bandwidth_bytes_s=external_bandwidth)
        self.scheduler = DataScheduler(self.stores, self.external)
        self.view = DistributedStore(self.stores)
        self.checkpointer = DistributedCheckpointer(
            self.stores, self.scheduler, self.external, buddy=buddy,
            delta=delta, slots=slots, device=self.device)
        self.heartbeat = Heartbeat(self.stores)
        self.dlm = DLMCache(self.stores[self.node_ids[0]],
                            capacity_bytes=dlm_capacity)
        # ``wire_codec=True`` (or a spec dict) turns on the delta-int8
        # wire codec for every replicate, drain and repair transfer
        self.tiered = TieredIO(self.checkpointer, self.scheduler, self.dlm,
                               wire_codec=wire_codec)
        self.recovery = FailureRecovery(self.checkpointer, self.heartbeat,
                                        tiered=self.tiered)

    def start_repair_daemon(self, **kw):
        """Start the background repair daemon (owned by ``recovery``):
        deaths seen through the heartbeats (``kill_node`` makes the pool
        unreachable) trigger rate-limited repair sweeps, rehydration
        included, without waiting for a recovery point. Returns the
        daemon (``wait_for``/``covers``/``report`` are its ledger)."""
        return self.recovery.start_daemon(**kw)

    def stop_repair_daemon(self) -> None:
        self.recovery.stop_daemon()

    def kill_node(self, nid: str) -> None:
        """Simulate a node failure: its pmem becomes unreachable."""
        pool = self.pools[nid]
        pool.fail()  # in-flight async writers now fail fast
        # an async writer may still be mid-create; retry until clean.
        # Raw directory removal IS the fault being injected: the one
        # sanctioned bypass of the PMemRegion discipline.
        for _ in range(50):
            shutil.rmtree(pool.root, ignore_errors=True)  # pmemlint: disable=raw-pool-path
            if not pool.root.exists():
                break
            time.sleep(0.02)

    def repair(self, lost_nodes, **kw) -> dict:
        """Restore the replication factor after ``kill_node``: quiesce
        in-flight I/O, then ``TieredIO.repair``."""
        self.tiered.quiesce()
        return self.tiered.repair(lost_nodes, **kw)

    def shutdown(self) -> None:
        self.recovery.stop_daemon()
        self.tiered.shutdown()
        self.scheduler.shutdown()
