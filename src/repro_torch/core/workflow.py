"""Workflow scheduling over the Persistent Dataset Exchange (§V-A, §VI).

PyTorch counterpart of ``repro/core/workflow.py``, with its journal
events, object names and report keys, so a workflow journaled by either
package is resumed by the other. A workflow is a DAG of jobs, executed
through the paper's Fig. 8 sequence: allocate nodes -> stage inputs into
node pmem (burst buffer) -> launch -> leave retained outputs in pmem for
dependent jobs (in-situ sharing, no external round trip) -> drain final
outputs -> reclaim. The scheduler runs that sequence CONCURRENTLY and
RECOVERABLY:

  * every ready job dispatches onto a ``DataScheduler`` worker
    (``run_job``) the moment its inputs are staged, so independent
    branches of the DAG (and independent workflows, each under its own
    namespace) overlap. A job that runs on the card waits for it through
    the watchdog (``kernels/watchdog.py``);
  * placement is data-affine BY BYTES: a job lands on the node holding
    the largest share of its input bytes (catalog records for datasets,
    store manifests for raw objects), tie-broken toward the least-loaded
    node so input-free jobs spread out;
  * all intermediates go through the ``DatasetCatalog``: versioned,
    lineage-stamped, replica-acked, lease-protected. ``cleanup`` is the
    catalog's refcount/lease GC, not a blanket scrub;
  * progress persists in a **workflow journal** (``wf/<id>/journal.log``,
    an append-only ``MetaLog`` replicated to every live pool). After a
    node loss, ``resume`` replays ONLY the jobs whose retained outputs
    the catalog's replica acks mark unrecoverable; the decision reads
    zero objects. Resume restores the replication factor first
    (``TieredIO.repair``, or the repair daemon's ledger when it covers
    the loss), so a SECOND loss still resumes without replays;
  * final-output drains are joined at the end of ``run``: a failed drain
    fails the workflow (``SupersededError`` stays benign).

Journal format (``wf/<id>/journal.log``, one entry per event):

  {"op": "begin",  "workflow": id, "ts": ...}      run/resume started
  {"op": "job",    "name": job, "entry": {...}, "ts": ...}
                                                   one job's terminal state
  {"op": "status", "status": done|failed, "ts": ...}

Job entries: ``{"status": "done", "nodes": [...], "outputs": {name:
version}, "retained": [names], "drain": [names], "ts": ...}`` (or
``{"status": "failed", "error": ...}``). ``journal(wf)`` replays the log
into ``{"workflow", "ts", "status", "jobs": {job: entry}}``, the latest
entry per job winning; a legacy ``wf/<id>/journal.json`` is read as the
replay base. With a telemetry plane (``obs``) every event of the feed is
also a ``wf.<kind>`` point on the flight ring, each ``run`` draws one
trace id for its whole DAG, and each job runs inside a ``wf.job`` span on
its node.
"""
from __future__ import annotations

import copy
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.annotations import metadata_only
from repro_torch.core.data_scheduler import DataScheduler, ExternalStore
from repro_torch.core.dataset_exchange import (DatasetCatalog, EXTERNAL_INPUT,
                                               Lease, live_pools,
                                               read_json_copies)
from repro_torch.core.meta_log import MetaLog
from repro_torch.core.object_store import (DistributedStore, PMemObjectStore,
                                           SupersededError)
from repro_torch.obs.trace import new_id

#: default lease TTL for a job's hold on its inputs while it runs
JOB_LEASE_TTL_S = 600.0


def _fold_journal(state: dict, ev: dict) -> None:
    """MetaLog reducer for workflow journals — rebuilds the merged
    journal dict (``{"workflow", "ts", "status", "jobs"}``); the latest
    ``job`` entry per job name wins (log order)."""
    op = ev["op"]
    if op == "begin":
        state["workflow"] = ev["workflow"]
        state["status"] = "running"
        state.setdefault("jobs", {})
    elif op == "status":
        state["status"] = ev["status"]
    elif op == "job":
        state.setdefault("jobs", {})[ev["name"]] = ev["entry"]
    state["ts"] = ev["ts"]


@dataclass
class JobSpec:
    name: str
    fn: Callable[["JobContext"], Dict[str, Any]]
    inputs: Tuple[str, ...] = ()        # dataset names (from deps or external)
    after: Tuple[str, ...] = ()         # job-name dependencies
    retain: Tuple[str, ...] = ()        # outputs kept in pmem for deps
    drain: Tuple[str, ...] = ()         # outputs drained to external at end
    n_nodes: int = 1
    memory_mode: str = "slm"            # slm | dlm (paper §V-A item 9)


@dataclass
class JobContext:
    job: JobSpec
    nodes: List[str]
    stores: Dict[str, PMemObjectStore]
    view: DistributedStore
    workflow: str = "default"
    catalog: Optional[DatasetCatalog] = None
    external: Optional[ExternalStore] = None

    def read(self, name: str, workflow: Optional[str] = None):
        """Resolve an input: catalog dataset (this workflow's namespace,
        or an explicit cross-workflow import), then raw pmem object
        (staged external input / pre-placed data)."""
        wf = workflow or self.workflow
        if self.catalog is not None and self.catalog.available(name, wf):
            try:
                return self.catalog.get(name, wf)
            except KeyError:
                pass  # reclaimed under us — fall back to raw pmem
        return self.view.get(name, prefer=self.nodes[0])


class WorkflowResult(dict):
    """``run``'s return value: job name -> outputs dict, plus the
    workflow id and (after ``resume``) the skipped/replayed split."""

    def __init__(self, workflow_id: str):
        super().__init__()
        self.workflow_id = workflow_id
        self.skipped: List[str] = []    # done jobs NOT re-invoked
        self.replayed: List[str] = []   # jobs re-run because outputs lost
        self.repair_report: dict = {}   # resume's TieredIO.repair report


class WorkflowScheduler:
    def __init__(self, stores: Dict[str, PMemObjectStore],
                 scheduler: DataScheduler, external: ExternalStore,
                 tiered=None, catalog: Optional[DatasetCatalog] = None,
                 obs=None):
        self.stores = stores
        self.obs = obs
        self.nodes = sorted(stores)
        self.dsched = scheduler
        self.external = external
        self.tiered = tiered
        self.catalog = catalog if catalog is not None \
            else DatasetCatalog(stores)
        self.view = DistributedStore(stores)
        self.events: List[Tuple[float, str, str]] = []  # (ts, kind, detail)
        self._ev_lock = threading.Lock()
        self._lock = threading.Lock()
        self._wf_seq = itertools.count()
        self._node_load: Dict[str, int] = {n: 0 for n in self.nodes}
        self._staged: Set[Tuple[str, str]] = set()   # (node, object name)
        self._workflows: Set[str] = set()            # namespaces run here
        self._jlogs: Dict[str, MetaLog] = {}         # wf -> journal log
        self._jlog_lock = threading.RLock()

    def _log(self, kind: str, detail: str) -> None:
        with self._ev_lock:
            self.events.append((time.time(), kind, detail))
        if self.obs is not None:
            # mirror the in-DRAM event feed onto the flight recorder so
            # a post-crash replay sees the workflow lifecycle too
            self.obs.event(f"wf.{kind}", detail=detail)

    # ---- journal (append-only MetaLog, replicated) -------------------
    @staticmethod
    def _journal_name(wf: str) -> str:
        """Legacy pre-log journal object (replay base only)."""
        return f"wf/{wf}/journal.json"

    def _live(self) -> List[str]:
        return live_pools(self.stores, self.nodes)

    @metadata_only
    def _legacy_journal(self, wf: str) -> dict:
        """Merged pre-log ``journal.json`` copies (the old read path) —
        the replay base for workflows begun before the MetaLog port."""
        try:
            copies = read_json_copies(self.stores, self.nodes,
                                      self._journal_name(wf))
        except (IOError, FileNotFoundError):
            return {}
        best = dict(max(copies, key=lambda c: c.get("ts", 0)))
        jobs: Dict[str, dict] = {}
        for c in copies:
            for jname, e in (c.get("jobs") or {}).items():
                if jname not in jobs or \
                        e.get("ts", 0) > jobs[jname].get("ts", 0):
                    jobs[jname] = e
        best["jobs"] = jobs
        return best

    def _jlog(self, wf: str) -> MetaLog:
        with self._jlog_lock:
            log = self._jlogs.get(wf)
            if log is None:
                log = MetaLog(self.stores, self.nodes,
                              f"wf/{wf}/journal.log", fold=_fold_journal,
                              base=lambda: self._legacy_journal(wf),
                              obs=self.obs)
                self._jlogs[wf] = log
            return log

    def _journal_append(self, wf: str, ev: dict) -> None:
        with self._jlog_lock:
            self._jlog(wf).append(ev)

    @metadata_only
    def journal(self, wf: str) -> dict:
        """The workflow journal folded from its replicated MetaLog:
        per-job entries in log order (latest event per job wins), the
        merged legacy ``journal.json`` as replay base for pre-log runs.
        Raises ``FileNotFoundError`` if no journal exists anywhere."""
        state = self._jlog(wf).state()
        if not state.get("workflow") and not state.get("jobs"):
            raise FileNotFoundError(self._journal_name(wf))
        return copy.deepcopy(state)

    # ---- placement: byte-weighted data affinity ----------------------
    def _place(self, job: JobSpec, wf: str) -> List[str]:
        """Nodes holding the largest share of the job's input BYTES
        (dataset sizes from catalog records, raw objects from store
        manifests — not input count), tie-broken toward the node with
        the fewest jobs in flight so input-free jobs spread out."""
        live = self._live()
        score: Dict[str, int] = {n: 0 for n in live}
        for obj in job.inputs:
            try:
                rec = self.catalog.record(obj, wf)
            except (KeyError, IOError, FileNotFoundError):
                rec = None
            if rec is not None and not rec.get("reclaimed"):
                nb = max(int(rec.get("nbytes", 0)), 1)
                home = rec.get("home")
                target = (rec.get("acks") or {}) \
                    .get("replica", {}).get("target")
                if home in score:
                    score[home] += nb
                elif target in score:  # home died: affinity follows replica
                    score[target] += nb
                continue
            for nid in self.view.locate(obj):
                if nid in score:
                    try:
                        score[nid] += max(
                            self.stores[nid].nbytes_of(obj), 1)
                    except (IOError, FileNotFoundError):
                        score[nid] += 1
        with self._lock:
            load = dict(self._node_load)
        ranked = sorted(live,
                        key=lambda n: (-score[n], load.get(n, 0), n))
        return ranked[:job.n_nodes]

    # ---- stage-in through TieredIO -----------------------------------
    def _stage_inputs(self, job: JobSpec, nodes: List[str],
                      wf: str) -> List:
        futs: List = []
        warm: List[str] = []
        for obj in job.inputs:
            if self.catalog.available(obj, wf):
                try:
                    producer = self.catalog.record(obj, wf)["lineage"]["job"]
                except (KeyError, IOError, FileNotFoundError):
                    producer = None
                self._log("in_situ", f"{wf}:{obj} in catalog "
                          f"(produced by {producer})")
                warm.append(obj)
                continue
            if self.view.locate(obj):
                self._log("in_situ", f"{obj} already in pmem")
                continue
            if not self.external.exists(obj):
                raise KeyError(f"input {obj} nowhere to be found")
            if self.tiered is not None:
                futs.extend(self.tiered.stage_in(nodes[0], [obj],
                                                 prefix=""))
            else:
                futs.append(self.dsched.stage_in(nodes[0], obj, obj))
            self._staged.add((nodes[0], obj))
            self._log("stage_in", f"{obj} -> {nodes[0]}")
        if warm and job.memory_mode == "dlm" and self.tiered is not None \
                and self.tiered.catalog is self.catalog:
            # DLM-mode job: warm the DRAM cache with its catalog inputs
            # so the first read hits DRAM, not pmem
            futs.append(self.tiered.prefetch_datasets(warm, wf))
            self._log("prefetch", f"{wf}:{','.join(warm)} -> dlm cache")
        return futs

    # ---- job body (runs on a DataScheduler worker) -------------------
    def _make_task(self, job: JobSpec, nodes: List[str], wf: str,
                   lineage: List[List], trace: int = 0):
        obs = self.obs

        def task():
            sp = None
            if obs is not None and trace:
                sp = obs.begin("wf.job", node=nodes[0], trace=trace,
                               job=job.name, workflow=wf)
            ctx = JobContext(job, nodes, self.stores, self.view,
                             workflow=wf, catalog=self.catalog,
                             external=self.external)
            try:
                outputs = job.fn(ctx) or {}
            except Exception:
                if obs is not None:
                    obs.end(sp, status="error")
                raise
            versions: Dict[str, int] = {}
            # outputs spread across the job's nodes; every one becomes a
            # catalog dataset (versioned + lineage-stamped + replicated)
            for i, (name, tree) in enumerate(sorted(outputs.items())):
                node = nodes[i % len(nodes)]
                retained = name in job.retain or name in job.drain
                rec = self.catalog.publish(
                    name, tree, workflow=wf, producer=job.name,
                    inputs=lineage, node=node, retained=retained)
                versions[name] = rec["version"]
                if name in job.retain:
                    self._log("retain", f"{wf}:{name}@v{rec['version']} "
                              f"on {rec['home']}")
            if obs is not None:
                obs.end(sp, outputs=len(outputs))
            return outputs, versions
        return task

    def _lineage_refs(self, job: JobSpec, wf: str,
                      leases: List[Lease]) -> List[List]:
        refs = [[l.name, l.workflow, l.version] for l in leases]
        leased = {l.name for l in leases}
        refs += [[EXTERNAL_INPUT, obj, 0] for obj in job.inputs
                 if obj not in leased]
        return refs

    # ---- Fig. 8 lifecycle, concurrent -------------------------------
    def run(self, jobs: Sequence[JobSpec], *,
            workflow: Optional[str] = None,
            max_concurrent: Optional[int] = None,
            _pre_done: Optional[Dict[str, dict]] = None) -> WorkflowResult:
        """Execute the DAG: every job whose dependencies are done (and
        inputs staged) dispatches onto a DataScheduler worker; jobs on
        different nodes run concurrently. ``max_concurrent=1`` recovers
        the old serial walk (bench_workflow.py measures the gap).
        Multiple ``run`` calls may execute concurrently — each workflow
        is namespaced and journaled independently."""
        wf = workflow if workflow is not None \
            else f"wf{next(self._wf_seq)}"
        # one trace id spans the whole DAG
        wf_trace = new_id() if self.obs is not None else 0
        with self._lock:
            self._workflows.add(wf)
        by_name = {j.name: j for j in jobs}
        if len(by_name) != len(jobs):
            raise ValueError("duplicate job names in workflow")
        result = WorkflowResult(wf)
        journal = {"workflow": wf, "status": "running", "jobs": {}}
        self._journal_append(wf, {"op": "begin", "workflow": wf})
        for jname, entry in (_pre_done or {}).items():
            journal["jobs"][jname] = entry
            result[jname] = {}  # outputs live in the catalog, not DRAM
            result.skipped.append(jname)
            self._journal_append(wf, {"op": "job", "name": jname,
                                      "entry": entry})

        cap = max_concurrent if max_concurrent else len(self.nodes)
        pending = [j for j in jobs if j.name not in journal["jobs"]]
        staging: Dict[str, Tuple[JobSpec, List[str], List]] = {}
        inflight: Dict[str, Tuple[Any, JobSpec, List[str],
                                  List[Lease]]] = {}
        drains: List[Tuple[str, Any]] = []
        done: Set[str] = set(journal["jobs"])

        def fail(jname: str, exc: Exception):
            journal["status"] = "failed"
            entry = {"status": "failed", "error": str(exc),
                     "ts": time.time()}
            journal.setdefault("jobs", {})[jname] = entry
            self._journal_append(wf, {"op": "job", "name": jname,
                                      "entry": entry})
            self._journal_append(wf, {"op": "status", "status": "failed"})
            # join the rest so no worker is left mutating state after
            # the caller sees the failure
            for name, (fut, _j, nodes, leases) in inflight.items():
                try:
                    fut.result(timeout=60)
                except Exception:  # noqa: BLE001 — first error wins
                    pass
                self._release(nodes, leases)
            # jobs still staging hold node_load (taken at allocate) but
            # no leases yet; their stage futures are joined so nothing
            # keeps writing pmem after the caller sees the failure
            for _j, nodes, futs in staging.values():
                for f in futs:
                    try:
                        f.result(timeout=60)
                    except Exception:  # noqa: BLE001
                        pass
                self._release(nodes, [])
            raise RuntimeError(
                f"workflow {wf}: job {jname} failed") from exc

        while pending or staging or inflight:
            progressed = False
            # (2-3) allocate + stage inputs for every ready job
            for job in list(pending):
                if len(staging) + len(inflight) >= cap:
                    break
                if not all(a in done for a in job.after):
                    continue
                pending.remove(job)
                nodes = self._place(job, wf)
                with self._lock:
                    self._node_load[nodes[0]] = \
                        self._node_load.get(nodes[0], 0) + 1
                self._log("allocate", f"{wf}:{job.name} -> {nodes} "
                          f"mode={job.memory_mode}")
                try:
                    stage_futs = self._stage_inputs(job, nodes, wf)
                except Exception as e:  # noqa: BLE001 — input missing
                    self._release(nodes, [])
                    fail(job.name, e)
                staging[job.name] = (job, nodes, stage_futs)
                progressed = True
            # (4-7) launch jobs whose stage-in finished
            for name in list(staging):
                job, nodes, futs = staging[name]
                if not all(f.done() for f in futs):
                    continue
                del staging[name]
                stage_err = None
                for f in futs:
                    try:
                        f.result()
                    except Exception as e:  # noqa: BLE001
                        stage_err = e
                if stage_err is not None:
                    self._release(nodes, [])  # allocate's load increment
                    fail(name, stage_err)
                # lease every catalog input for the job's duration: GC
                # cannot reclaim them mid-run, eviction keeps them warm
                leases = []
                for obj in job.inputs:
                    if self.catalog.available(obj, wf):
                        try:
                            leases.append(self.catalog.acquire(
                                obj, workflow=wf,
                                owner=f"{wf}/{job.name}",
                                ttl_s=JOB_LEASE_TTL_S))
                        except KeyError:
                            pass  # reclaimed between check and acquire:
                            # the job's read falls back like _stage_inputs
                task = self._make_task(
                    job, nodes, wf, self._lineage_refs(job, wf, leases),
                    trace=wf_trace)
                self._log("launch", f"{wf}:{job.name}")
                inflight[name] = (self.dsched.run_job(nodes[0], task),
                                  job, nodes, leases)
                progressed = True
            # (8) reap completions: journal, drains, lease release
            for name in list(inflight):
                fut, job, nodes, leases = inflight[name]
                if not fut.done():
                    continue
                del inflight[name]
                self._release(nodes, leases)
                if fut.exception() is not None:
                    fail(name, fut.exception())
                outputs, versions = fut.result()
                result[name] = outputs
                done.add(name)
                entry = {
                    "status": "done", "nodes": nodes,
                    "outputs": versions,
                    "retained": sorted(job.retain),
                    "drain": sorted(job.drain), "ts": time.time()}
                journal["jobs"][name] = entry
                self._journal_append(wf, {"op": "job", "name": name,
                                          "entry": entry})
                for oname in job.drain:
                    try:
                        rec = self.catalog.record(oname, wf,
                                                  versions.get(oname))
                    except (KeyError, IOError, FileNotFoundError) as e:
                        fail(name, e)
                    drains.append((oname, self.dsched.drain(
                        rec["home"], rec["object"], oname,
                        version=rec["version"])))
                    self._log("drain",
                              f"{wf}:{oname} {rec['home']} -> external")
                progressed = True
            if not progressed:
                if not staging and not inflight:
                    raise RuntimeError("workflow deadlock (cyclic or "
                                       "missing deps?)")
                time.sleep(0.002)
        # join final-output drains: a failed drain fails the workflow
        # instead of vanishing (SupersededError stays benign — the
        # newer version's own drain covers it)
        drain_errors: List[Tuple[str, Exception]] = []
        for oname, f in drains:
            try:
                f.result()
            except SupersededError:
                pass
            except Exception as e:  # noqa: BLE001 — re-raised below
                drain_errors.append((oname, e))
        if drain_errors:
            journal["status"] = "failed"
            self._journal_append(wf, {"op": "status", "status": "failed"})
            oname, err = drain_errors[0]
            raise RuntimeError(
                f"workflow {wf}: drain of final output {oname} "
                f"failed") from err
        journal["status"] = "done"
        self._journal_append(wf, {"op": "status", "status": "done"})
        return result

    def _release(self, nodes: List[str], leases: List[Lease]) -> None:
        with self._lock:
            self._node_load[nodes[0]] = \
                max(0, self._node_load.get(nodes[0], 0) - 1)
        for lease in leases:
            self.catalog.release(lease)

    # ---- resume after node loss --------------------------------------
    def resume(self, jobs: Sequence[JobSpec], workflow: str, *,
               lost_nodes: Sequence[str] = (),
               max_concurrent: Optional[int] = None,
               repair: bool = True) -> WorkflowResult:
        """Replay a journaled workflow after a node loss, re-running
        ONLY the jobs whose retained outputs are unrecoverable. The
        decision comes from the catalog's placement + replica acks —
        zero object-store probes: a done job whose outputs all survive
        (home alive, or acked replica on a survivor) is marked done from
        the journal and its function is NEVER re-invoked; consumers read
        the surviving copy (replica fallback) through the catalog.

        With ``repair`` (default) the resume first restores the
        replication factor (``TieredIO.repair``): surviving datasets the
        loss reduced to a single copy regain an acked buddy before the
        replay runs, so a SECOND loss during or after the resumed run is
        still recoverable without replays. The replay decision itself is
        unchanged by repair (both read the same acks); the repair's
        object reads are the copies it makes, never probes. When the
        continuous RepairDaemon is running and its ledger already covers
        ``lost_nodes``, its merged report is used instead of a redundant
        re-scan (the daemon repaired in the background between the loss
        and this resume). Report in ``result.repair_report``."""
        try:
            journal = self.journal(workflow)
        except (IOError, FileNotFoundError):
            journal = {"jobs": {}}
        with self._lock:
            self._workflows.add(workflow)
        repair_report: dict = {}
        if repair and lost_nodes and self.tiered is not None:
            # swallow foreground transfers that died with the node in
            # EITHER branch: a failed future left tracked would fail a
            # later strict join() on a successfully-resumed run
            self.tiered.quiesce()
            daemon = getattr(self.tiered, "repair_daemon", None)
            if daemon is not None and daemon.running:
                daemon.wait_for(lost_nodes, timeout=60.0)
            if daemon is not None and daemon.covers(lost_nodes):
                repair_report = daemon.report()
                self._log("repair",
                          f"{workflow}: daemon ledger covers "
                          f"{sorted(lost_nodes)} "
                          f"({repair_report.get('sweeps', 0)} sweeps) — "
                          f"no re-scan")
            else:
                repair_report = self.tiered.repair(lost_nodes)
                self._log(
                    "repair",
                    f"{workflow}: "
                    f"{len(repair_report.get('repaired', ()))} objects "
                    f"re-replicated after losing {sorted(lost_nodes)}")
        names = {j.name for j in jobs}
        pre_done: Dict[str, dict] = {}
        replayed: List[str] = []
        for jname, entry in journal.get("jobs", {}).items():
            if entry.get("status") != "done" or jname not in names:
                continue
            lost = [o for o in entry.get("retained", ())
                    if not self.catalog.recoverable(
                        o, workflow, entry.get("outputs", {}).get(o),
                        lost_nodes)]
            if lost:
                replayed.append(jname)
                self._log("replay", f"{workflow}:{jname} lost "
                          f"outputs {lost}")
            else:
                pre_done[jname] = entry
                self._log("skip", f"{workflow}:{jname} outputs "
                          f"recoverable (acked)")
        result = self.run(jobs, workflow=workflow,
                          max_concurrent=max_concurrent,
                          _pre_done=pre_done)
        # replayed = previously-done jobs re-run because outputs were
        # lost; jobs the journal never recorded as done (new, or failed
        # mid-run) ran too, but they are not loss-driven replays
        result.replayed = sorted(replayed)
        result.repair_report = repair_report
        return result

    # ---- lifecycle ---------------------------------------------------
    def cleanup(self, keep: Sequence[str] = ()) -> None:
        """Post-workflow reclaim (paper §V items 6/10) via the catalog's
        lease/refcount GC — NOT a blanket scrub: datasets named in
        ``keep`` stay retained, everything else this scheduler published
        is unretained and reclaimed only at refcount zero (an active
        lease from another consumer defers reclaim to its expiry).
        Staged external input copies are scrubbed too."""
        with self._lock:
            mine = set(self._workflows)
        for rec in self.catalog.records():
            if rec.get("reclaimed") or rec["workflow"] not in mine:
                continue
            if rec["name"] in keep:
                continue
            self.catalog.unretain(rec["name"], rec["workflow"],
                                  rec["version"])
        for wf, name, version in self.catalog.gc():
            self._log("cleanup", f"{wf}:{name}@v{version} reclaimed")
        for nid, name in sorted(self._staged):
            if name in keep:
                continue
            try:
                if self.stores[nid].exists(name):
                    self.stores[nid].delete(name)
                    self._log("cleanup", f"{name} on {nid}")
            except IOError:
                continue
        self._staged = {(n, o) for n, o in self._staged if o in keep}
