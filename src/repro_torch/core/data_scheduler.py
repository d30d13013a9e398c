"""Per-node asynchronous data scheduler (the paper's §V-B).

PyTorch counterpart of ``repro/core/data_scheduler.py``: the emulated
external store (with JAX's ``bandwidth_bytes_s`` throttle) and the
per-node mover daemons with their priority queues and work stealing,
with three channels:

  stage_in   - external store -> node pmem (burst-buffer pre-load, Fig. 8;
               drain-tier rehydration): a wire payload lands through
               ``import_object``, a pickled tree through ``put``
  drain      - node pmem -> external store through ``export_object``
               (asynchronous checkpoint flush), optionally encoded by the
               delta-int8 wire codec on the source store's device
  replicate  - node pmem -> buddy-node pmem through ``copy_object`` (the
               paper's remote B-APM access over the fabric, for failure
               tolerance)

Each channel's ``on_complete`` hook runs inside the task once the copy
is durable, so an ack never describes an unfinished transfer. The
external store pickles numpy trees and wire payloads (bytes, numbers,
strings), never a tensor, so JAX's ``ExternalStore`` reads what the port
drains and the other way round. ``run_job`` (workflow jobs) waits for
ROADMAP Queue A item 2(d); the per-channel byte counters, queue gauges
and ``span=`` for the telemetry plane (item 10).
"""
from __future__ import annotations

import pickle
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from repro_torch.analysis.annotations import rehydration_entry
from repro_torch.core.object_store import (PMemObjectStore, copy_object,
                                           export_object, import_object,
                                           is_wire_object)


class ExternalStore:
    """The 'external high performance filesystem' of Fig. 4, emulated as a
    directory of pickles with an optional artificial bandwidth."""

    def __init__(self, root: Path,
                 bandwidth_bytes_s: Optional[float] = None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.bandwidth = bandwidth_bytes_s

    def _path(self, name: str) -> Path:
        return self.root / (name.replace("/", "_") + ".pkl")

    def _throttle(self, nbytes: int) -> None:
        if self.bandwidth:
            time.sleep(nbytes / self.bandwidth)

    def put(self, name: str, tree) -> None:
        p = self._path(name)
        data = pickle.dumps(tree)
        self._throttle(len(data))
        tmp = p.with_suffix(".tmp")
        tmp.write_bytes(data)
        tmp.replace(p)

    def get(self, name: str):
        # the external store holds what this program (or the JAX package,
        # on the same directory) wrote: numpy trees and wire payloads
        data = self._path(name).read_bytes()
        self._throttle(len(data))
        return pickle.loads(data)

    def exists(self, name: str) -> bool:
        return self._path(name).exists()


@dataclass(order=True)
class _Task:
    priority: int
    seq: int
    fn: Callable = field(compare=False)
    future: Future = field(compare=False)


class DataScheduler:
    """Async movement daemons over {node_id -> PMemObjectStore}."""

    def __init__(self, stores: Dict[str, PMemObjectStore],
                 external: ExternalStore, workers_per_node: int = 1):
        self.stores = stores
        self.external = external
        self.queues: Dict[str, "queue.PriorityQueue[_Task]"] = {
            nid: queue.PriorityQueue() for nid in stores}
        self._seq = 0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        for nid in stores:
            for w in range(workers_per_node):
                t = threading.Thread(target=self._worker, args=(nid,),
                                     daemon=True, name=f"dsched-{nid}-{w}")
                t.start()
                self._threads.append(t)

    # ---- worker loop with work stealing ----
    def _worker(self, nid: str) -> None:
        while not self._stop.is_set():
            task = self._next_task(nid)
            if task is None:
                time.sleep(0.002)
                continue
            try:
                task.future.set_result(task.fn())
            except Exception as e:  # surfaced via the future
                task.future.set_exception(e)

    def _next_task(self, nid: str) -> Optional[_Task]:
        try:
            return self.queues[nid].get_nowait()
        except queue.Empty:
            pass
        # steal from the deepest queue (straggler mitigation)
        victim = max(self.queues, key=lambda n: self.queues[n].qsize())
        if victim != nid and self.queues[victim].qsize() > 1:
            try:
                return self.queues[victim].get_nowait()
            except queue.Empty:
                return None
        return None

    def _submit(self, nid: str, fn: Callable, priority: int) -> Future:
        fut: Future = Future()
        with self._lock:
            self._seq += 1
            seq = self._seq
        self.queues[nid].put(_Task(priority, seq, fn, fut))
        return fut

    # ---- public channels ----
    @rehydration_entry
    def stage_in(self, nid: str, external_name: str, obj_name: str,
                 version: int = 0, priority: int = 0,
                 meta: Optional[dict] = None,
                 on_complete: Optional[Callable[[Any], None]] = None
                 ) -> Future:
        """External -> pmem pre-load on ``nid``'s mover. ``meta`` stamps
        the staged object (a rehydrated checkpoint shard keeps its step
        tag, so restore's slot-reuse check still holds); ``on_complete``
        runs inside the task once the pmem copy is durable. A wire
        payload lands through ``import_object`` (an encoded one stays
        encoded); a pickled tree goes through ``put``."""
        def go():
            obj = self.external.get(external_name)
            if is_wire_object(obj):
                man = import_object(self.stores[nid], obj, obj_name,
                                    version, meta_update=meta)
            else:
                man = self.stores[nid].put(obj_name, obj, version,
                                           meta=meta)
            if on_complete is not None:
                on_complete(man)
            return man
        return self._submit(nid, go, priority)

    @rehydration_entry
    def drain(self, nid: str, obj_name: str, external_name: str,
              version: int = 0, priority: int = 1,
              delete_after: bool = False,
              expect_meta: Optional[dict] = None,
              on_complete: Optional[Callable[[Any], None]] = None,
              codec=None) -> Future:
        """pmem -> external store: ``export_object`` against one manifest
        snapshot (a source overwritten meanwhile raises
        ``SupersededError``; ``expect_meta`` pins the identity the caller
        meant, e.g. the checkpoint step), pickled once by the external
        store. ``codec`` encodes the exported leaves on the source
        store's device. ``on_complete`` runs inside the task after the
        external copy is durable: if it fails, the task fails and no one
        can mistake the object for drained."""
        def go():
            wire = export_object(self.stores[nid], obj_name, version,
                                 expect_meta=expect_meta, codec=codec)
            self.external.put(external_name, wire)
            if delete_after:
                self.stores[nid].delete(obj_name, version)
            if on_complete is not None:
                on_complete(external_name)
            return external_name
        return self._submit(nid, go, priority)

    @rehydration_entry
    def replicate(self, src: str, obj_name: str, dst: str,
                  version: int = 0, priority: int = 2,
                  dst_name: Optional[str] = None,
                  expect_meta: Optional[dict] = None,
                  on_complete: Optional[Callable[[Any], None]] = None,
                  codec=None) -> Future:
        """Copy an object to another node's pmem under ``dst_name``
        (defaults to replica/<src>/<obj> so it never shadows the
        destination's own objects). ``expect_meta`` pins the object
        identity the caller intended (e.g. the checkpoint step);
        ``on_complete`` runs inside the task once the replica is placed,
        so the replication channel records per-node acks through it.
        ``codec`` engages the delta-int8 wire codec at the source (an
        already-encoded source raw-streams, never double-encodes)."""
        name = dst_name or f"replica/{src}/{obj_name}"

        def go():
            # zero-copy raw path against ONE manifest snapshot; a source
            # overwritten meanwhile raises SupersededError before the
            # commit (benign: the newer object queues its own copy).
            # replica_of keeps the ORIGIN node across second hops.
            man = copy_object(
                self.stores[src], self.stores[dst], obj_name, version,
                dst_name=name, expect_meta=expect_meta, codec=codec,
                meta_update=lambda m: {
                    "replica_of": m.get("replica_of", src)})
            # ack hook after the replica is durable on ``dst``: a
            # failure here fails the task, never records a false ack
            if on_complete is not None:
                on_complete(man)
            return man
        return self._submit(src, go, priority)

    def run_job(self, *args, **kwargs) -> Future:
        raise NotImplementedError(
            "the compute channel for workflow jobs is not ported (ROADMAP "
            "Queue A item 2(d): core/workflow.py)")

    def shutdown(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
