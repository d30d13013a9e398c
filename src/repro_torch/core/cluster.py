"""Simulated multi-node cluster wiring (one directory per node's B-APM).

PyTorch counterpart of ``repro/core/cluster.py``: per-node pools and
object stores, the external store (``external_bandwidth`` throttles it),
the data scheduler (stage-in, drain, replicate), the checkpointer with
buddy replication and drains, heartbeats, the DLM write-back cache over
the first node's store, the TieredIO engine ``tiered`` over all of them
and ``recovery`` (``FailureRecovery``), with JAX's arguments (``buddy``,
``dlm_capacity``, ``slots``, ``wire_codec``), ``kill_node``, ``repair``
and the repair daemon (``start_repair_daemon``), and the persistent
dataset exchange over them: the ``catalog`` (attached to ``tiered``, so
its replicas ride the exchange channel and its leases pin the DLM cache),
the Fig. 8 ``workflows`` scheduler and the serve tier's ``sessions``
manager, all wired to one telemetry plane (``obs``: one metrics registry
and one pmem flight-recorder ring per node; ``telemetry=False`` keeps the
registry and records no ring event). ``device`` is where checkpoints are
encoded and restored and where the wire codec runs: the card unless the
caller asks for the CPU.
"""
from __future__ import annotations

import shutil
import time
from pathlib import Path
from typing import Dict, Optional

from repro_torch import resolve_device
from repro_torch.core.checkpoint import DistributedCheckpointer
from repro_torch.core.data_scheduler import DataScheduler, ExternalStore
from repro_torch.core.dataset_exchange import DatasetCatalog
from repro_torch.core.object_store import DistributedStore, PMemObjectStore
from repro_torch.core.pmem import PMemPool
from repro_torch.core.resilience import FailureRecovery, Heartbeat
from repro_torch.core.tiered_io import TieredIO
from repro_torch.core.tiering import DLMCache
from repro_torch.core.workflow import WorkflowScheduler
from repro_torch.obs.plane import TelemetryPlane


class SimCluster:
    def __init__(self, root: Path, n_nodes: int = 4,
                 pmem_capacity: int = 1 << 32,
                 external_bandwidth: Optional[float] = None,
                 buddy: bool = True, delta: bool = False,
                 dlm_capacity: int = 1 << 28, slots: int = 2,
                 wire_codec=None, telemetry: bool = True,
                 device="cuda"):
        self.root = Path(root)
        self.device = resolve_device(device)
        self.node_ids = [f"node{i}" for i in range(n_nodes)]
        self.pools: Dict[str, PMemPool] = {
            nid: PMemPool(self.root / "pmem", nid,
                          capacity_bytes=pmem_capacity)
            for nid in self.node_ids}
        # telemetry plane: one metrics registry + one crash-persistent
        # flight-recorder ring per node pool. telemetry=False keeps the
        # registry (cheap DRAM counters) but records no pmem events:
        # the baseline leg of the overhead measurement.
        self.obs = TelemetryPlane(self.pools, enabled=telemetry)
        self.stores: Dict[str, PMemObjectStore] = {
            nid: PMemObjectStore(pool, device=self.device)
            for nid, pool in self.pools.items()}
        self.external = ExternalStore(self.root / "external",
                                      bandwidth_bytes_s=external_bandwidth)
        self.scheduler = DataScheduler(self.stores, self.external,
                                       obs=self.obs)
        self.view = DistributedStore(self.stores)
        self.checkpointer = DistributedCheckpointer(
            self.stores, self.scheduler, self.external, buddy=buddy,
            delta=delta, slots=slots, device=self.device, obs=self.obs)
        self.heartbeat = Heartbeat(self.stores)
        self.dlm = DLMCache(self.stores[self.node_ids[0]],
                            capacity_bytes=dlm_capacity, obs=self.obs)
        # ``wire_codec=True`` (or a spec dict) turns on the delta-int8
        # wire codec for every replicate, drain and repair transfer
        self.tiered = TieredIO(self.checkpointer, self.scheduler, self.dlm,
                               wire_codec=wire_codec, obs=self.obs)
        self.recovery = FailureRecovery(self.checkpointer, self.heartbeat,
                                        tiered=self.tiered)
        # the persistent dataset exchange: catalog replication rides the
        # TieredIO exchange channel, leased datasets pin the DLM cache
        self.catalog = DatasetCatalog(self.stores)
        self.tiered.attach_catalog(self.catalog)
        self.workflows = WorkflowScheduler(self.stores, self.scheduler,
                                           self.external,
                                           tiered=self.tiered,
                                           catalog=self.catalog,
                                           obs=self.obs)
        # multi-tenant serve tier: sessions as leased catalog datasets
        # (imported here: serve/ sits above core/ in the layer order)
        from repro_torch.serve.sessions import SessionManager
        self.sessions = SessionManager(self.tiered, self.catalog,
                                       obs=self.obs)

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
        # clean shutdown: drop a metrics snapshot on every live pool.
        # After a crash this never runs: the flight-recorder rings are
        # then the diagnosis (python -m repro_torch.obs.report).
        self.obs.persist_snapshot()
