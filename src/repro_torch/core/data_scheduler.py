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
drains and the other way round. ``run_job`` is the compute channel:
workflow job bodies run on the node's mover worker, below every data
channel in priority. An idle worker steals from the deepest queue when
it holds more than one task, as in JAX, and also when it holds one and
its node's workers are all busy: two sibling jobs placed on one node
(the same input) then run side by side instead of one waiting out the
other. The per-channel byte counters (``stats``), the queue-depth gauges
and the queue-wait and task histograms live in the telemetry registry
(``obs``); a task given a ``span=`` context runs inside a
``sched.<label>`` child span on its node's flight ring.
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
from repro_torch.obs.metrics import StatsView, registry_of


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
                 external: ExternalStore, workers_per_node: int = 1,
                 obs=None):
        self.stores = stores
        self.external = external
        self.obs = obs
        self.queues: Dict[str, "queue.PriorityQueue[_Task]"] = {
            nid: queue.PriorityQueue() for nid in stores}
        self._seq = 0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        self._workers_per_node = workers_per_node
        # tasks each node's own workers are running now (work stealing
        # reads it: a node whose every worker is busy has a backlog)
        self._running: Dict[str, int] = {nid: 0 for nid in stores}
        # per-channel byte counters live in the telemetry registry;
        # ``stats`` keeps the dict shape as a read-through view
        reg = registry_of(obs)
        self._counters = {
            nid: {k: reg.counter(f"sched.{k}_bytes.{nid}")
                  for k in ("staged_in", "drained", "replicated")}
            for nid in stores}
        self.stats = {nid: StatsView(self._counters[nid])
                      for nid in stores}
        self._depth = {nid: reg.gauge(f"sched.queue_depth.{nid}")
                       for nid in stores}
        self._qwait = reg.histogram("sched.queue_wait_s")
        self._task_s = reg.histogram("sched.task_s")
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
            with self._lock:
                self._running[nid] += 1
            try:
                task.future.set_result(task.fn())
            except Exception as e:  # surfaced via the future
                task.future.set_exception(e)
            finally:
                with self._lock:
                    self._running[nid] -= 1

    def _next_task(self, nid: str) -> Optional[_Task]:
        try:
            return self.queues[nid].get_nowait()
        except queue.Empty:
            pass
        # steal from the deepest queue (straggler mitigation): one that
        # holds more than its next task, or whose every worker is busy,
        # so a task never waits behind a long one (a workflow job) on its
        # own node while this worker idles
        victim = max(self.queues, key=lambda n: self.queues[n].qsize())
        depth = self.queues[victim].qsize()
        with self._lock:
            busy = self._running[victim] >= self._workers_per_node
        if victim != nid and (depth > 1 or (depth == 1 and busy)):
            try:
                return self.queues[victim].get_nowait()
            except queue.Empty:
                return None
        return None

    def _submit(self, nid: str, fn: Callable, priority: int,
                label: str = "task",
                span: Optional[dict] = None) -> Future:
        fut: Future = Future()
        with self._lock:
            self._seq += 1
            seq = self._seq
        obs = self.obs
        t_enq = time.time()

        def run():
            # queue-depth/wait instruments + (when a caller threaded a
            # trace context through ``span=``) a child span bracketing
            # the task body on the executing node's flight ring
            self._qwait.observe(time.time() - t_enq)
            self._depth[nid].dec()
            sp = None
            if obs is not None and span is not None:
                sp = obs.begin(f"sched.{label}", node=nid,
                               trace=span.get("trace"),
                               parent=span.get("span", 0))
            t0 = time.time()
            try:
                out = fn()
            except Exception:
                self._task_s.observe(time.time() - t0)
                if sp is not None:
                    obs.end(sp, status="error")
                raise
            self._task_s.observe(time.time() - t0)
            if sp is not None:
                obs.end(sp)
            return out

        self._depth[nid].inc()
        self.queues[nid].put(_Task(priority, seq, run, fut))
        return fut

    # ---- public channels ----
    @rehydration_entry
    def stage_in(self, nid: str, external_name: str, obj_name: str,
                 version: int = 0, priority: int = 0,
                 meta: Optional[dict] = None,
                 on_complete: Optional[Callable[[Any], None]] = None,
                 span: Optional[dict] = None) -> Future:
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
            self._counters[nid]["staged_in"].inc(man["nbytes"])
            if on_complete is not None:
                on_complete(man)
            return man
        return self._submit(nid, go, priority, label="stage_in",
                            span=span)

    @rehydration_entry
    def drain(self, nid: str, obj_name: str, external_name: str,
              version: int = 0, priority: int = 1,
              delete_after: bool = False,
              expect_meta: Optional[dict] = None,
              on_complete: Optional[Callable[[Any], None]] = None,
              codec=None,
              span: Optional[dict] = None) -> Future:
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
                                 expect_meta=expect_meta, codec=codec,
                                 obs=self.obs)
            self.external.put(external_name, wire)
            self._counters[nid]["drained"].inc(
                wire["manifest"]["nbytes"])
            if delete_after:
                self.stores[nid].delete(obj_name, version)
            if on_complete is not None:
                on_complete(external_name)
            return external_name
        return self._submit(nid, go, priority, label="drain",
                            span=span)

    @rehydration_entry
    def replicate(self, src: str, obj_name: str, dst: str,
                  version: int = 0, priority: int = 2,
                  dst_name: Optional[str] = None,
                  expect_meta: Optional[dict] = None,
                  on_complete: Optional[Callable[[Any], None]] = None,
                  codec=None,
                  span: Optional[dict] = None) -> Future:
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
                    "replica_of": m.get("replica_of", src)},
                obs=self.obs)
            self._counters[src]["replicated"].inc(man["nbytes"])
            # ack hook after the replica is durable on ``dst``: a
            # failure here fails the task, never records a false ack
            if on_complete is not None:
                on_complete(man)
            return man
        return self._submit(src, go, priority, label="replicate",
                            span=span)

    def run_job(self, nid: str, fn: Callable, priority: int = 3,
                span: Optional[dict] = None) -> Future:
        """Compute channel: run a workflow job body on node ``nid``'s
        worker. Jobs ride the same priority queues as data movement
        (movement outranks them) and the same work stealing, so ready
        jobs placed on different nodes run concurrently while an
        overloaded node's backlog can drain elsewhere. A job that runs
        on the card waits for it through the watchdog
        (``kernels/watchdog.py``), never a bare synchronize."""
        return self._submit(nid, fn, priority, label="run_job",
                            span=span)

    def queue_depth(self, nid: str) -> int:
        return self.queues[nid].qsize()

    def shutdown(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
