"""Per-node asynchronous data scheduler (the paper's §V-B).

The part of ``repro/core/data_scheduler.py`` that the training slice
needs: the emulated external store and the per-node mover daemons with
their priority queues and work stealing, with the ``stage_in`` channel
(external store -> node pmem, the burst-buffer pre-load of the training
data). The ``drain``, ``replicate`` and ``run_job`` channels wait for the
replication slice (ROADMAP Queue A item 2), as do wire-codec payloads in
the external store; so do the external store's bandwidth throttle and the
byte counters of the JAX package's telemetry registry, which no path of
the port reads yet.
"""
from __future__ import annotations

import pickle
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

from repro_torch.analysis.annotations import rehydration_entry
from repro_torch.core.object_store import PMemObjectStore


class ExternalStore:
    """The 'external high performance filesystem' of Fig. 4, emulated as a
    directory of pickled trees."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, name: str) -> Path:
        return self.root / (name.replace("/", "_") + ".pkl")

    def put(self, name: str, tree) -> None:
        p = self._path(name)
        tmp = p.with_suffix(".tmp")
        tmp.write_bytes(pickle.dumps(tree))
        tmp.replace(p)

    def get(self, name: str):
        # the external store holds what this program (or the JAX package,
        # on the same directory) wrote: numpy trees
        return pickle.loads(self._path(name).read_bytes())

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
                 version: int = 0, priority: int = 0) -> Future:
        """External -> pmem pre-load on ``nid``'s mover."""
        def go():
            obj = self.external.get(external_name)
            if isinstance(obj, dict) and obj.get("__wire_object__") == 1:
                raise NotImplementedError(
                    f"{external_name} is a wire payload of the zero-copy "
                    f"drain path, which is not ported (ROADMAP Queue A "
                    f"item 2: replication and drain)")
            return self.stores[nid].put(obj_name, obj, version)
        return self._submit(nid, go, priority)

    def shutdown(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
