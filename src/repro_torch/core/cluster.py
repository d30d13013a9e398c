"""Simulated multi-node cluster wiring (one directory per node's B-APM).

The part of ``repro/core/cluster.py`` that the training slice drives:
per-node pools and object stores, the external store, the data scheduler
(stage-in), the checkpointer, heartbeats and the asynchronous checkpoint
engine ``tiered``. The DLM cache, the dataset catalog, workflows, serve
sessions, repair and ``kill_node`` wait for later slices (ROADMAP Queue
A item 2). ``device`` is where checkpoints are encoded and restored: the
card unless the caller asks for the CPU.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

from repro_torch.core.checkpoint import DistributedCheckpointer
from repro_torch.core.data_scheduler import DataScheduler, ExternalStore
from repro_torch.core.object_store import PMemObjectStore
from repro_torch.core.pmem import PMemPool
from repro_torch.core.resilience import Heartbeat
from repro_torch.core.tiered_io import TieredIO


class SimCluster:
    def __init__(self, root: Path, n_nodes: int = 4,
                 pmem_capacity: int = 1 << 32, delta: bool = False, slots: int = 2, device="cuda"):
        self.root = Path(root)
        self.node_ids = [f"node{i}" for i in range(n_nodes)]
        self.pools: Dict[str, PMemPool] = {
            nid: PMemPool(self.root / "pmem", nid,
                          capacity_bytes=pmem_capacity)
            for nid in self.node_ids}
        self.stores: Dict[str, PMemObjectStore] = {
            nid: PMemObjectStore(pool) for nid, pool in self.pools.items()}
        self.external = ExternalStore(self.root / "external")
        self.scheduler = DataScheduler(self.stores, self.external)
        self.checkpointer = DistributedCheckpointer(
            self.stores, delta=delta, slots=slots, device=device)
        self.heartbeat = Heartbeat(self.stores)
        self.tiered = TieredIO(self.checkpointer)

    def shutdown(self) -> None:
        self.tiered.shutdown()
        self.scheduler.shutdown()
