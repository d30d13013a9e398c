"""TieredIO: one nonblocking engine over the B-APM memory hierarchy.

PyTorch counterpart of ``repro/core/tiered_io.py`` with its contracts:

  save_async(step, tree)  -> SaveTicket: checkpoint writes on a dedicated
        FIFO I/O thread, double-buffered across the checkpointer's pmem
        slots (at most ``slots`` tickets in flight). Post-commit buddy
        replicates ride on the ticket (``post_commit``).
  offload(name, tree)     -> Future: persist an object (serve session
        state) through the DLM write-back cache; once durable in the home
        node's pmem, a buddy replica and its ack are queued.
  fetch(name) / fetch_leaf(name, leaf) / prefetch(names): demand, one
        leaf's byte range, and anticipatory reads through the DLM cache;
        a dead home pool falls back to the acked buddy replica.
  evict_cold(max_idle_s)  -> spill idle DRAM entries back to pmem; the
        attached catalog's leased datasets stay resident.
  stage_in(nid, names)    -> external store -> node pmem (Fig. 8 burst
        buffer), with resident objects counted as stage-in hits.
  attach_catalog(catalog) / prefetch_datasets(refs, workflow): the
        dataset exchange. The catalog's replica fan-out rides the
        ``ExchangeChannel`` (acked into the catalog record once
        durable), its reads admit into the DLM cache, and its live
        leases pin their entries there.
  quiesce() / join()      -> join every in-flight save, replicate,
        offload and prefetch, collecting errors (``join`` raises the
        first that is not a benign ``SupersededError``).

Replication (``ReplicationChannel``): every committed checkpoint's slot
object is copied to its ring buddy (and, for a save with ``drain=True``,
drained to the external store) through the data scheduler, and a
per-node ack lands in the checkpoint ack log (``ckpt/ackslog``) once the
copy is durable; ``SaveTicket.durability()`` reads those acks, so a save
reaches ``"REPLICATED"`` only when every shard owner has an acked replica
and ``"DRAINED"`` when every drain is acked (a failed copy records
nothing: the map under-promises, never over-promises). DLM objects get
the same discipline through ``DLMAckRegistry`` (``dlm/ackslog``). With ``wire_codec`` every replica
travels through the delta-int8 wire codec, which runs on the source
store's device (``core/wire_codec.py``). Every on-disk record (object
names, manifests, both ack logs) is the JAX package's, byte for byte.

The saved training state lives on the card, where the JAX loop hands
over a host copy. The writer runs a save's device phase (``prepare``:
device to host, or the delta encode) on its own CUDA stream, after the
caller's stream has produced the state, waits for it with the
watchdog's deadline (``kernels/watchdog.py``), then sets
``ticket.device_done`` (or its failure: a ``KernelTimeout`` of a hung
kernel) and lets go of the device tensors before it writes to pmem
(``commit``). The training loop waits on
``device_done`` before it would make a second newer state, so the card
holds at most one extra copy of the state.

Replica repair (``RepairChannel``, ``TieredIO.repair(lost_nodes)``)
restores the replication factor after a node loss: it scans the
checkpoint acks, the DLM ack registry and, when a catalog is attached,
the dataset catalog's records for objects whose acked copies the loss left
on ONE survivor, re-replicates each to a fresh live node through the
scheduler and re-acks it once durable. The scan decides from ack records
alone; the only object reads are the sources of the copies it makes. A
checkpoint shard whose every pmem copy died but whose drain was acked is
staged back from the external store (rehydration) and replicated again.
``max_inflight`` bounds the repair transfers in flight and ``priority``
ranks them below foreground I/O. ``RepairDaemon`` runs those sweeps in
the background on each new death the heartbeats show, and keeps a
ledger (``covers``, ``wait_for``, ``report``) that recovery points read
instead of scanning again. Every transfer of a ``wire_codec`` engine
encodes on its source store's device and every reader decodes on its
own, so a repair or rehydration on the card runs the codec kernels.

Telemetry (``obs``, a ``TelemetryPlane``; ``SimCluster`` wires one):
``save_async`` opens one ``ckpt.save`` trace per checkpoint, whose
context rides the manifest into the replication channel's
``ckpt.replicate``/``ckpt.drain`` child spans, the scheduler's
``sched.*`` spans and the ack records (``"trace"``); each durable ack is
a ``ckpt.ack.<kind>`` point on its transfer span. A repair sweep is one
``repair.sweep`` trace; prefetches and stage-ins open ``dlm.prefetch``,
``exch.prefetch`` and ``stage.stage_in`` spans. Counters and histograms
(``tiered.*``, ``ckpt.submit_to_ack_s``, ``ckpt.save_commit_s``,
``repair.*``) live in the plane's registry, and every span and event is
a slot of the node's pmem flight ring, as in the JAX package.
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import torch

from repro_torch.analysis.annotations import metadata_only, rehydration_entry
from repro_torch.core.checkpoint import DistributedCheckpointer
from repro_torch.core.data_scheduler import DataScheduler
from repro_torch.core.dataset_exchange import (ack_targets, cache_key,
                                               read_json_copies)
from repro_torch.core.meta_log import MetaLog
from repro_torch.core.object_store import SupersededError, _flatten
from repro_torch.core.tiering import DLMCache
from repro_torch.core.wire_codec import normalize_codec
from repro_torch.kernels import watchdog
from repro_torch.obs.metrics import StatsView, registry_of
from repro_torch.obs.trace import ctx as _span_ctx

#: acknowledged durability levels, weakest to strongest
DURABILITY_LEVELS = ("PENDING", "FAILED", "LOCAL", "REPLICATED", "DRAINED")
_LEVEL_RANK = {lvl: i for i, lvl in enumerate(DURABILITY_LEVELS)}


class SaveTicket:
    """Handle for one asynchronous checkpoint save. ``result()`` blocks
    until the pmem commit and returns the global manifest;
    ``device_done`` completes once the save holds no device tensor;
    ``post_commit`` holds the background replicate futures, which may
    complete (or fail, e.g. when a buddy node dies) long after the
    commit."""

    def __init__(self, step: int, slot: Optional[int] = None,
                 checkpointer: Optional[DistributedCheckpointer] = None):
        self.step = step
        self.slot = slot  # filled in once the writer allocates it
        self.future: Future = Future()
        self.device_done: Future = Future()
        self.post_commit: List[Future] = []
        self._checkpointer = checkpointer

    def result(self, timeout: Optional[float] = None) -> dict:
        return self.future.result(timeout)

    def done(self) -> bool:
        return self.future.done()

    def exception(self, timeout: Optional[float] = None):
        return self.future.exception(timeout)

    def wait_post_commit(self, timeout: Optional[float] = None
                         ) -> List[Exception]:
        """Join the replicates; returns their errors instead of raising
        (a dead replica target must not poison an otherwise-good save)."""
        errors: List[Exception] = []
        for f in self.post_commit:
            try:
                f.result(timeout)
            except Exception as e:  # noqa: BLE001 — collected for caller
                errors.append(e)
        return errors

    @metadata_only
    def durability(self) -> str:
        """Acknowledged durability of this save, from the persisted ack
        map; a delta is capped by its base chain's level."""
        if not self.future.done():
            return "PENDING"
        if self.future.exception() is not None:
            return "FAILED"
        ckpt = self._checkpointer
        if ckpt is None:
            return "LOCAL"
        man = self.future.result()
        return _acked_level(ckpt, self.step, man.get("nodes") or ckpt.nodes,
                            man.get("delta_base"))


@metadata_only
def _acked_level(ckpt: DistributedCheckpointer, step: int,
                 ring: Sequence[str], delta_base: Optional[int]) -> str:
    acks = ckpt.acks(step)
    if ring and all(acks.get(n, {}).get("drain") for n in ring):
        level = "DRAINED"
    elif len(ring) > 1 and \
            all(acks.get(n, {}).get("replica") for n in ring):
        level = "REPLICATED"
    else:
        level = "LOCAL"
    if delta_base is not None and delta_base < step:
        try:
            bman = ckpt._meta_get_json(
                f"ckpt/manifest_step{delta_base}.json")
        except (IOError, FileNotFoundError):
            return "LOCAL"  # base manifest gone: chain not protected
        base_level = _acked_level(ckpt, delta_base,
                                  bman.get("nodes") or ckpt.nodes,
                                  bman.get("delta_base"))
        if _LEVEL_RANK[base_level] < _LEVEL_RANK[level]:
            level = base_level
    return level


class ReplicationChannel:
    """Replicate and drain fan-out with per-node acks.

    One ``submit`` per committed checkpoint: every shard owner's slot
    object is replicated to its ring buddy (and drained to the external
    store with ``drain``) through the data scheduler, and each task
    records its ack into the ack log the moment the transfer is durable.
    A superseded or failed transfer records nothing."""

    def __init__(self, checkpointer: DistributedCheckpointer,
                 scheduler: DataScheduler, obs=None, codec=None):
        self.checkpointer = checkpointer
        self.scheduler = scheduler
        self.obs = obs
        # wire codec spec (already normalized by TieredIO): encodes at
        # the source of every replicate this channel submits
        self.codec = codec
        # submit -> durable-ack wall clock, per transfer
        self._ack_s = registry_of(obs).histogram("ckpt.submit_to_ack_s")

    def _begin(self, name: str, nid: str, tid: int, parent: int,
               **attrs):
        """Child span on ``nid``'s ring when the manifest carried a
        trace context (None otherwise: spans are opt-in per save)."""
        if self.obs is None or not tid:
            return None
        return self.obs.begin(name, node=nid, trace=tid, parent=parent,
                              **attrs)

    @rehydration_entry
    def submit(self, manifest: dict, *, drain: bool = False,
               sink: Optional[List[Future]] = None) -> List[Future]:
        ckpt = self.checkpointer
        step, slot = manifest["step"], manifest["slot"]
        ring = manifest.get("nodes") or ckpt.nodes
        obj = f"ckpt/slot{slot}"
        # trace context minted at save_async and stamped into the
        # manifest: every per-node transfer gets a child span, and the
        # trace id rides the ack info into the durable ack log
        trace = manifest.get("trace") or {}
        tid, root = trace.get("trace", 0), trace.get("span", 0)
        futs: List[Future] = []
        if ckpt.buddy and len(ring) > 1:
            for nid in ring:
                buddy = ckpt.buddy_of(nid, ring)
                sp = self._begin("ckpt.replicate", nid, tid, root,
                                 step=step, target=buddy)
                info = {"target": buddy, "targets": [buddy]}
                if tid:
                    info["trace"] = tid
                futs.append(self.scheduler.replicate(
                    nid, obj, buddy, expect_meta={"step": step},
                    codec=self.codec, span=_span_ctx(sp),
                    on_complete=self._ack(step, nid, "replica", info,
                                          span=sp)))
        if drain and ckpt.external is not None:
            for nid in ring:
                ext = f"ckpt_step{step}_{nid}"
                sp = self._begin("ckpt.drain", nid, tid, root,
                                 step=step, external=ext)
                info = {"external": ext}
                if tid:
                    info["trace"] = tid
                futs.append(self.scheduler.drain(
                    nid, obj, ext, expect_meta={"step": step},
                    codec=self.codec, span=_span_ctx(sp),
                    on_complete=self._ack(step, nid, "drain", info,
                                          span=sp)))
        if sink is not None:
            sink.extend(futs)
        return futs

    @rehydration_entry
    def replicate_object(self, src: str, name: str, dst: str,
                         dst_name: Optional[str] = None,
                         expect_meta: Optional[dict] = None,
                         on_complete=None) -> Future:
        """Replicate a non-checkpoint pmem object (a DLM session state)
        to a buddy node, readable as ``replica/<src>/<name>`` when the
        home pool dies. ``on_complete`` runs inside the task once the
        copy is durable: the DLM ack registry records acks through it."""
        return self.scheduler.replicate(src, name, dst, dst_name=dst_name,
                                        expect_meta=expect_meta,
                                        codec=self.codec,
                                        on_complete=on_complete)

    def _ack(self, step: int, nid: str, kind: str, info: dict,
             span=None):
        ckpt = self.checkpointer
        obs = self.obs
        t_submit = time.time()

        def record(_result) -> None:
            ckpt.record_ack(step, nid, kind, info)
            self._ack_s.observe(time.time() - t_submit)
            if obs is not None and span is not None:
                # the ack lands as a point event on the transfer's span,
                # then the span closes: submit -> durable ack, one arc
                obs.event(f"ckpt.ack.{kind}", node=nid,
                          trace=span.trace, parent=span.span, step=step)
                obs.end(span)
        return record


class ExchangeChannel:
    """Dataset replica fan-out with per-dataset acks, the dataset
    exchange's sibling of ``ReplicationChannel``. One ``submit`` per
    published dataset version: the home node's object is copied to a
    buddy through the data scheduler, and ``on_ack`` (the catalog's
    record updater) runs inside the task the moment the replica is
    durable. A failed or superseded transfer records nothing. TieredIO
    tracks the futures so ``quiesce``/``join`` cover in-flight dataset
    replication alongside checkpoints."""

    def __init__(self, scheduler: DataScheduler, track=None, codec=None):
        self.scheduler = scheduler
        self._track = track  # TieredIO future-tracking hook
        self.codec = codec   # wire codec for dataset replica fan-out

    @rehydration_entry
    def submit(self, src: str, obj: str, dst: str, *, version: int = 0,
               dst_name: Optional[str] = None,
               expect_meta: Optional[dict] = None,
               on_ack=None, priority: int = 2,
               span: Optional[dict] = None) -> Future:
        """``dst_name`` overrides the replica name: repair copies a
        surviving replica ``replica/<home>/<obj>`` from its HOLDER, so
        the destination name must keep the original home. ``priority``
        passes through to the scheduler (the repair daemon runs below
        foreground I/O); ``span`` is the caller's trace context."""
        fut = self.scheduler.replicate(src, obj, dst, version=version,
                                       dst_name=dst_name,
                                       expect_meta=expect_meta,
                                       codec=self.codec,
                                       on_complete=on_ack,
                                       priority=priority, span=span)
        if self._track is not None:
            self._track(fut)
        return fut


def _fold_dlm_acks(state: dict, ev: dict) -> None:
    """MetaLog reducer for the DLM ack registry: state maps the full
    object name to its ack record; a ``record`` event wins wholesale."""
    state[ev["name"]] = {"home": ev["home"],
                         "targets": list(ev["targets"]),
                         "ts": ev["ts"]}


class DLMAckRegistry:
    """Per-object replica acks for DLM objects: an append-only
    replicated pmem log (``dlm/ackslog``, a ``MetaLog``) whose folded
    state maps object names to their newest record,

      {"dlm/<name>": {"home": nid, "targets": [nids], "ts": ...}}

    ``record`` is called from scheduler worker threads inside the
    replicate task, after the buddy copy is durable. A legacy pre-log
    ``dlm/acks.json`` (if present) is folded in as the replay base."""

    NAME = "dlm/acks.json"  # legacy pre-log record (read-only base)
    LOG = "dlm/ackslog"

    def __init__(self, stores, nodes: Sequence[str], obs=None):
        self.stores = stores
        self.nodes = sorted(nodes)
        self._lock = threading.Lock()
        self._log = MetaLog(stores, self.nodes, self.LOG,
                            fold=_fold_dlm_acks, base=self._legacy_base,
                            obs=obs)

    def _legacy_base(self) -> Dict[str, dict]:
        try:
            copies = read_json_copies(self.stores, self.nodes, self.NAME)
        except (IOError, FileNotFoundError):
            return {}
        merged: Dict[str, dict] = {}
        for c in copies:
            for name, rec in (c.get("objects") or {}).items():
                if name not in merged or \
                        rec.get("ts", 0) > merged[name].get("ts", 0):
                    merged[name] = rec
        return merged

    def record(self, name: str, home: str, target: str,
               targets: Optional[Sequence[str]] = None) -> None:
        """Ack one durable buddy copy of ``name`` (a full store object
        name, e.g. ``dlm/serve/sess``). Default: ``target`` joins the
        existing target set; an explicit ``targets`` list REPLACES it."""
        with self._lock:
            if targets is None:
                targets = sorted(
                    set(ack_targets(self._log.state().get(name)))
                    | {target})
            self._log.append({"op": "record", "name": name,
                              "home": home,
                              "targets": sorted(targets)})

    def objects(self) -> Dict[str, dict]:
        """The merged per-object ack map ({} when nothing ever acked)."""
        with self._lock:
            return dict(self._log.state())

    def targets(self, name: str) -> List[str]:
        """Acked replica holders of ``name`` (possibly empty)."""
        with self._lock:
            return ack_targets(self._log.state().get(name))


class RepairChannel:
    """Ack-driven replica repair: restore the replication factor.

    ``repair(lost_nodes)`` scans the ack surfaces (checkpoint step acks,
    the DLM ack registry, and the dataset catalog's records when one is
    attached) for objects whose acked copy set, {home} plus the acked
    targets, ``lost_nodes`` reduced to exactly ONE survivor, and
    re-replicates each from that survivor to a fresh live node through
    scheduler tasks, re-acking (pruned targets plus the new one) only
    when the copy is durable. Decisions come from the persisted ack
    records alone; the only object reads are the sources of the copies
    made."""

    def __init__(self, tiered: "TieredIO"):
        self.tiered = tiered

    # ---- shared mechanics --------------------------------------------
    @staticmethod
    def _single_survivor(home: str, targets: Sequence[str],
                         lost: Set[str]) -> Optional[str]:
        """The lone surviving acked copy holder, or None when the object
        needs no repair (>= 2 survivors), was never replicated (nothing
        was promised), or lost every pmem copy."""
        pre = {home} | set(targets)
        cur = pre - lost
        if len(pre) >= 2 and len(cur) == 1:
            return next(iter(cur))
        return None

    def _new_target(self, live: Sequence[str], survivor: str,
                    exclude: Set[str]) -> Optional[str]:
        """The next live node after ``survivor`` in ring order that holds
        no copy yet (``buddy_of``'s rotation, so repair load spreads)."""
        ring = list(live)
        if survivor not in ring:
            return None
        i = ring.index(survivor)
        for k in range(1, len(ring)):
            cand = ring[(i + k) % len(ring)]
            if cand not in exclude:
                return cand
        return None

    def _live(self, lost: Set[str]) -> List[str]:
        ckpt = self.tiered.checkpointer
        nodes = ckpt._live_nodes() if ckpt is not None else \
            sorted(self.tiered.scheduler.stores)
        return [n for n in nodes if n not in lost]

    @metadata_only
    def _plan(self, home: str, targets: Sequence[str], lost: Set[str],
              live: Sequence[str], report: dict, *,
              drain_ok: bool = False
              ) -> Optional[Tuple[str, str, List[str]]]:
        """One object's repair decision and report accounting:
        (survivor, new_target, new_targets) when a re-replication is
        due, else None after counting the object ``healthy`` (>= 2
        surviving copies), ``skipped`` (never acked a replica) or
        ``unrepairable`` (no surviving pmem copy, or no live node to
        host a new one; also ``drain_only`` when an acked drain still
        covers it)."""
        survivor = self._single_survivor(home, targets, lost)
        if survivor is None:
            pre = {home} | set(targets)
            if len(pre) < 2:
                report["skipped"] += 1
            elif not (pre - lost):
                report["unrepairable"] += 1
                if drain_ok:
                    report["drain_only"] += 1
            else:
                report["healthy"] += 1
            return None
        new = self._new_target(live, survivor,
                               ({home} | set(targets)) - lost)
        if new is None:
            report["unrepairable"] += 1
            return None
        return survivor, new, sorted((set(targets) - lost) | {new})

    def _rehydrate_target(self, nid: str, live: Sequence[str],
                          exclude: Set[str]) -> Optional[str]:
        """Where a rehydrated shard of dead node ``nid`` lands: the first
        live node after ``nid`` in the full ring."""
        ckpt = self.tiered.checkpointer
        ring = ckpt.nodes if ckpt is not None else sorted(live)
        i = ring.index(nid) if nid in ring else 0
        for k in range(1, len(ring) + 1):
            cand = ring[(i + k) % len(ring)]
            if cand in live and cand not in exclude:
                return cand
        return None

    # ---- the scan ----------------------------------------------------
    @metadata_only
    def repair(self, lost_nodes: Sequence[str], *,
               max_inflight: Optional[int] = None,
               priority: Optional[int] = None,
               rehydrate: bool = True) -> dict:
        """Scan, re-replicate and join. The report: ``checkpoint``/
        ``dataset``/``dlm`` count completed re-acked copies,
        ``repaired`` lists them as (surface, object, survivor,
        new_target), ``rehydrated`` counts checkpoint shards staged back
        from their acked drain and replicated again, ``healthy`` objects
        still on >= 2 acked copies, ``superseded`` sources overwritten
        since their ack (benign), ``unrepairable`` objects with no
        surviving pmem copy or no live node to host one (``drain_only``
        those an acked drain covers that were not rehydrated),
        ``skipped`` objects that never acked a replica, ``peak_inflight``
        the most repair transfers at once, and ``errors`` real copy
        failures. ``max_inflight`` bounds the transfers queued or running
        at once, ``priority`` overrides their scheduler priority, and
        ``rehydrate=False`` only counts drain-only shards."""
        lost = set(lost_nodes)
        report = {"checkpoint": 0, "dataset": 0, "dlm": 0,
                  "rehydrated": 0, "healthy": 0, "superseded": 0,
                  "unrepairable": 0, "drain_only": 0, "skipped": 0,
                  "peak_inflight": 0, "repaired": [], "errors": []}
        obs = self.tiered.obs
        sweep_span = None
        if obs is not None:
            # one trace per sweep: scan + every copy/re-ack hangs off it
            sweep_span = obs.begin("repair.sweep", lost=sorted(lost))
        sctx = _span_ctx(sweep_span)
        live = self._live(lost)
        plans: collections.deque = collections.deque()
        if self.tiered.checkpointer is not None:
            self._scan_checkpoints(lost, live, report, plans,
                                   priority=priority, rehydrate=rehydrate,
                                   span=sctx)
        self._scan_dlm(lost, live, report, plans, priority=priority,
                       span=sctx)
        if self.tiered.catalog is not None:
            self._scan_datasets(lost, live, report, plans,
                                priority=priority, span=sctx)
        self._execute(plans, report, max_inflight)
        if obs is not None:
            for k in ("checkpoint", "dataset", "dlm", "rehydrated",
                      "healthy", "superseded", "unrepairable",
                      "drain_only", "skipped"):
                obs.counter(f"repair.{k}").inc(report[k])
            obs.counter("repair.errors").inc(len(report["errors"]))
            obs.end(sweep_span, repaired=len(report["repaired"]),
                    errors=len(report["errors"]))
        return report

    def _execute(self, plans: "collections.deque", report: dict,
                 max_inflight: Optional[int]) -> None:
        """Run repair plans through a bounded submission window. Each
        plan: {surface, counter, obj, survivor, new, submit, then?,
        on_error?}; ``then`` chains a follow-up plan on success
        (rehydration stages external -> pmem, then replicates) at the
        FRONT of the queue, so a chain completes before new objects
        start."""
        outstanding: collections.deque = collections.deque()
        while plans or outstanding:
            while plans and (max_inflight is None
                             or len(outstanding) < max_inflight):
                p = plans.popleft()
                outstanding.append((p, p["submit"]()))
                report["peak_inflight"] = max(report["peak_inflight"],
                                              len(outstanding))
            p, fut = outstanding.popleft()
            try:
                fut.result()
            except SupersededError:
                report["superseded"] += 1
            except Exception as e:  # noqa: BLE001 — reported, not raised
                report["errors"].append(e)
                if p.get("on_error") is not None:
                    p["on_error"](e)
            else:
                then = p.get("then")
                if then is not None:
                    plans.appendleft(then)
                    continue
                report[p["counter"]] += 1
                report["repaired"].append(
                    (p["surface"], p["obj"], p["survivor"], p["new"]))

    @metadata_only
    def _scan_checkpoints(self, lost: Set[str], live: List[str],
                          report: dict, plans: "collections.deque", *,
                          priority: Optional[int],
                          rehydrate: bool,
                          span: Optional[dict] = None) -> None:
        ckpt = self.tiered.checkpointer
        sched = self.tiered.scheduler
        prio = {} if priority is None else {"priority": priority}
        if span is not None:
            prio["span"] = span
        seen_slots: Set[int] = set()
        for step in sorted(ckpt.available_steps(), reverse=True):
            try:
                rec_map = ckpt.ack_record(step)
                if rec_map is None:
                    continue  # pre-ack step: nothing was promised
                slot = ckpt._meta_get_json(
                    f"ckpt/manifest_step{step}.json")["slot"]
            except (IOError, FileNotFoundError, KeyError):
                continue
            if slot in seen_slots:
                # a newer step reused this slot: its bytes are no longer
                # this step's; skip on metadata alone (rehydration too:
                # the replica name is keyed by slot)
                report["superseded"] += 1
                continue
            seen_slots.add(slot)
            ring = rec_map.get("ring") or ckpt.nodes
            acks = rec_map.get("acks") or {}
            obj = f"ckpt/slot{slot}"
            for nid in ring:
                targets = ack_targets(acks.get(nid, {}).get("replica"))
                drain_rec = acks.get(nid, {}).get("drain") \
                    if ckpt.external is not None else None
                if rehydrate and drain_rec and \
                        not (({nid} | set(targets)) - lost):
                    # every pmem copy died, the acked drain survives:
                    # stage it back into a live pool (the only external
                    # read the scan makes), then re-replicate
                    self._plan_rehydration(step, nid, slot, drain_rec,
                                           live, report, plans, prio)
                    continue
                plan = self._plan(nid, targets, lost, live, report,
                                  drain_ok=bool(drain_rec))
                if plan is None:
                    continue
                survivor, new, new_targets = plan
                src_obj = obj if survivor == nid else \
                    f"replica/{nid}/{obj}"

                def ack(_man, step=step, nid=nid, new=new,
                        new_targets=new_targets) -> None:
                    info = {"target": new, "targets": new_targets}
                    if span is not None:
                        info["trace"] = span["trace"]
                    ckpt.record_ack(step, nid, "replica", info)
                plans.append({"surface": "checkpoint",
                              "counter": "checkpoint",
                              "obj": f"step{step}/{nid}",
                              "survivor": survivor, "new": new,
                              "submit": lambda s=survivor, so=src_obj,
                              n=new, st=step, ni=nid, a=ack, o=obj:
                              sched.replicate(
                                  s, so, n, dst_name=f"replica/{ni}/{o}",
                                  expect_meta={"step": st},
                                  codec=self.tiered.wire_codec,
                                  on_complete=a, **prio)})

    def _plan_rehydration(self, step: int, nid: str, slot: int,
                          drain_rec: dict, live: List[str], report: dict,
                          plans: "collections.deque",
                          prio: dict) -> None:
        """Queue the two-stage rehydration of ``nid``'s shard at
        ``step``: (1) stage the acked drained copy into a live pool under
        the replica name (acked alone: one durable pmem copy), (2)
        replicate it to a second live node and re-ack the pair. A stage
        failing counts the object ``unrepairable``/``drain_only``; a
        later sweep re-plans from whatever the acks then say."""
        ckpt = self.tiered.checkpointer
        sched = self.tiered.scheduler
        t1 = self._rehydrate_target(nid, live, set())
        if t1 is None:
            report["unrepairable"] += 1
            report["drain_only"] += 1
            return
        t2 = self._rehydrate_target(nid, live, {t1})
        ext = drain_rec.get("external") or f"ckpt_step{step}_{nid}"
        rep = f"replica/{nid}/ckpt/slot{slot}"
        obj = f"step{step}/{nid}"

        def count_lost(_e) -> None:
            report["unrepairable"] += 1
            report["drain_only"] += 1

        def ack_stage(_man) -> None:
            # under-promise: a crash between the stages leaves a truthful
            # single-target record the next sweep extends
            ckpt.record_ack(step, nid, "replica",
                            {"target": t1, "targets": [t1]})

        stage = {"surface": "rehydrate", "counter": "rehydrated",
                 "obj": obj, "survivor": "external", "new": t1,
                 "on_error": count_lost,
                 "submit": lambda: sched.stage_in(
                     t1, ext, rep, meta={"step": step, "replica_of": nid},
                     on_complete=ack_stage, **prio)}
        if t2 is not None:
            def ack_pair(_man) -> None:
                ckpt.record_ack(step, nid, "replica",
                                {"target": t2, "targets": sorted((t1, t2))})
            stage["then"] = {
                "surface": "rehydrate", "counter": "rehydrated",
                "obj": obj, "survivor": "external", "new": t1,
                "on_error": count_lost,
                "submit": lambda: sched.replicate(
                    t1, rep, t2, dst_name=rep,
                    expect_meta={"step": step},
                    codec=self.tiered.wire_codec,
                    on_complete=ack_pair, **prio)}
        plans.append(stage)

    @metadata_only
    def _scan_dlm(self, lost: Set[str], live: List[str],
                  report: dict, plans: "collections.deque", *,
                  priority: Optional[int],
                  span: Optional[dict] = None) -> None:
        reg = self.tiered.dlm_acks
        if reg is None:
            return
        sched = self.tiered.scheduler
        prio = {} if priority is None else {"priority": priority}
        if span is not None:
            prio["span"] = span
        for name, rec in reg.objects().items():
            home = rec.get("home")
            targets = ack_targets(rec)
            plan = self._plan(home, targets, lost, live, report)
            if plan is None:
                continue
            survivor, new, new_targets = plan
            src_obj = name if survivor == home else \
                f"replica/{home}/{name}"

            def ack(_man, name=name, home=home, new=new,
                    new_targets=new_targets) -> None:
                reg.record(name, home, new, targets=new_targets)
            plans.append({"surface": "dlm", "counter": "dlm",
                          "obj": name, "survivor": survivor, "new": new,
                          "submit": lambda s=survivor, so=src_obj, n=new,
                          h=home, nm=name, a=ack: sched.replicate(
                              s, so, n, dst_name=f"replica/{h}/{nm}",
                              codec=self.tiered.wire_codec,
                              on_complete=a, **prio)})

    @metadata_only
    def _scan_datasets(self, lost: Set[str], live: List[str],
                       report: dict, plans: "collections.deque", *,
                       priority: Optional[int],
                       span: Optional[dict] = None) -> None:
        catalog = self.tiered.catalog
        prio = {} if priority is None else {"priority": priority}
        if span is not None:
            prio["span"] = span
        for rec in catalog.records():
            if rec.get("reclaimed"):
                continue
            home = rec["home"]
            targets = ack_targets((rec.get("acks") or {}).get("replica"))
            plan = self._plan(home, targets, lost, live, report)
            if plan is None:
                continue
            survivor, new, new_targets = plan
            wf, name, v = rec["workflow"], rec["name"], rec["version"]
            src_obj = rec["object"] if survivor == home else \
                f"replica/{home}/{rec['object']}"
            dst_name = f"replica/{home}/{rec['object']}"

            def ack(_man, wf=wf, name=name, v=v, new=new,
                    new_targets=new_targets) -> None:
                catalog.record_repair_ack(wf, name, v, target=new,
                                          targets=new_targets)
            key = f"exch/{wf}/{name}@v{v}"

            def submit(survivor=survivor, src_obj=src_obj, new=new,
                       v=v, name=name, dst_name=dst_name,
                       ack=ack) -> Future:
                # the exchange channel exists whenever a scheduler does
                return self.tiered.exchange.submit(
                    survivor, src_obj, new, version=v, dst_name=dst_name,
                    expect_meta={"dataset": name, "version": v},
                    on_ack=ack, **prio)
            plans.append({"surface": "dataset", "counter": "dataset",
                          "obj": key, "survivor": survivor, "new": new,
                          "submit": submit})


def _merge_sweep(acc: dict, sweep: dict) -> None:
    """Fold one sweep's report into the daemon's ledger: event counters
    (copies, rehydrations, supersedes, errors, repaired entries)
    accumulate; state counters (healthy, unrepairable, drain_only,
    skipped) are the last sweep's, since every sweep re-scans against
    the cumulative dead set."""
    for k in ("checkpoint", "dataset", "dlm", "rehydrated",
              "superseded"):
        acc[k] = acc.get(k, 0) + sweep.get(k, 0)
    for k in ("healthy", "unrepairable", "drain_only", "skipped"):
        acc[k] = sweep.get(k, 0)
    acc["peak_inflight"] = max(acc.get("peak_inflight", 0),
                               sweep.get("peak_inflight", 0))
    acc.setdefault("repaired", []).extend(sweep.get("repaired", ()))
    acc.setdefault("errors", []).extend(sweep.get("errors", ()))


class RepairDaemon:
    """Continuous, heartbeat-driven background repair sweeps.

    Polls ``Heartbeat.dead_nodes`` and, on every NEW death, runs
    ``RepairChannel.repair`` over the CUMULATIVE dead set:
    incrementally (handled deaths do not re-trigger), rate-limited
    (``max_inflight`` transfers, at scheduler ``priority`` below every
    foreground channel), newest checkpoint first, with rehydration on.
    It quiesces nothing: acks are written only after a transfer is
    durable, so a sweep coexists with in-flight foreground I/O. A sweep
    with errors (say a second loss mid-sweep) leaves the set unhandled
    and the next poll re-plans from the acks, up to ``max_retries``
    times. The ledger: ``covers(lost)``, ``wait_for(lost)`` and
    ``report()`` (the merged sweep reports, ``sweeps``, ``handled``).

    A sweep runs on the daemon's own thread; every device wait inside it
    (the wire codec's encodes and decodes) goes through the watchdog's
    deadline (``kernels/watchdog.py``)."""

    def __init__(self, tiered: "TieredIO", heartbeat, *,
                 timeout_s: float = 10.0, poll_s: float = 0.05,
                 max_inflight: int = 2, priority: int = 4,
                 max_retries: int = 3, rehydrate: bool = True):
        self.tiered = tiered
        self.hb = heartbeat
        self.timeout_s = timeout_s
        self.poll_s = poll_s
        self.max_inflight = max_inflight
        self.priority = priority
        self.max_retries = max_retries
        self.rehydrate = rehydrate
        self.handled: Set[str] = set()
        self._attempts: Dict[frozenset, int] = {}
        self._ledger: dict = {"sweeps": 0}
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- lifecycle ---------------------------------------------------
    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> "RepairDaemon":
        if self.running:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="repair-daemon")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=60.0)
            if t.is_alive():
                # a wedged sweep outlived the join: keep it visible so a
                # later start() cannot spawn a second daemon beside it
                return
            self._thread = None

    def _run(self) -> None:
        backoff = self.poll_s
        while not self._stop.is_set():
            try:
                self.poll_once()
                backoff = self.poll_s
            except Exception as e:  # noqa: BLE001 — the daemon survives
                # a sweep that RAISES (even the metadata scan failed):
                # record it and back off so a dead cluster does not fill
                # the ledger at poll rate
                with self._cv:
                    self._ledger.setdefault("errors", []).append(e)
                backoff = min(backoff * 2, 1.0)
            self._stop.wait(backoff)

    # ---- one poll/sweep ----------------------------------------------
    def poll_once(self, now: Optional[float] = None) -> Optional[dict]:
        """Detect new deaths and sweep if any, inline on the caller's
        thread; returns that sweep's report, or None."""
        dead = set(self.hb.dead_nodes(self.timeout_s, now))
        with self._cv:
            # a rejoined node may die again later
            self.handled &= dead
            new = dead - self.handled
        if not new:
            return None
        sweep = self.tiered.repair(sorted(dead),
                                   max_inflight=self.max_inflight,
                                   priority=self.priority,
                                   rehydrate=self.rehydrate)
        key = frozenset(dead)
        with self._cv:
            _merge_sweep(self._ledger, sweep)
            self._ledger["sweeps"] += 1
            if not sweep["errors"]:
                self.handled |= dead
                self._attempts.clear()
            else:
                self._attempts[key] = self._attempts.get(key, 0) + 1
                if self._attempts.get(key, 0) >= self.max_retries:
                    self.handled |= dead
            self._cv.notify_all()
        obs = self.tiered.obs
        if obs is not None:
            obs.counter("repair.daemon_sweeps").inc()
            obs.event("repair.daemon_sweep", dead=sorted(dead),
                      errors=len(sweep["errors"]))
        return sweep

    # ---- the ledger --------------------------------------------------
    def covers(self, lost_nodes: Sequence[str]) -> bool:
        """True when every node in ``lost_nodes`` has been swept."""
        with self._cv:
            return set(lost_nodes) <= self.handled

    def wait_for(self, lost_nodes: Sequence[str],
                 timeout: Optional[float] = None) -> bool:
        """Block until the ledger covers ``lost_nodes`` (or timeout)."""
        lost = set(lost_nodes)
        with self._cv:
            return self._cv.wait_for(lambda: lost <= self.handled,
                                     timeout)

    def report(self) -> dict:
        """The accumulated ledger: merged sweep reports plus ``sweeps``
        and ``handled``."""
        with self._cv:
            out = dict(self._ledger)
            out["repaired"] = list(self._ledger.get("repaired", ()))
            out["errors"] = list(self._ledger.get("errors", ()))
            out["handled"] = sorted(self.handled)
            return out


class TieredIO:
    """Async engine over checkpointer + scheduler + DLM cache."""

    def __init__(self, checkpointer: Optional[DistributedCheckpointer] = None,
                 scheduler: Optional[DataScheduler] = None,
                 cache: Optional[DLMCache] = None,
                 max_inflight_saves: Optional[int] = None,
                 wire_codec=None, obs=None):
        reg = registry_of(obs)
        self.checkpointer = checkpointer
        self.scheduler = scheduler
        self.cache = cache
        self.obs = obs
        # opt-in delta-int8 wire codec for every replicate this engine
        # submits (True -> defaults, or a spec dict); None keeps it raw
        self.wire_codec = normalize_codec(wire_codec)
        # the replication channel owns ALL replicate fan-out; the
        # checkpointer delegates to it at every save commit
        self.replication: Optional[ReplicationChannel] = None
        if checkpointer is not None and scheduler is not None:
            self.replication = ReplicationChannel(checkpointer, scheduler,
                                                  obs=obs,
                                                  codec=self.wire_codec)
            checkpointer.replication = self.replication
        # dataset-exchange fan-out (catalog attached via attach_catalog)
        self.exchange: Optional[ExchangeChannel] = None
        self.catalog = None
        if scheduler is not None:
            self.exchange = ExchangeChannel(scheduler,
                                            track=self._track_future,
                                            codec=self.wire_codec)
        # home node of the DLM cache (whose store it fronts): replica
        # fallback reads resolve relative to it
        self._home_nid: Optional[str] = None
        self.dlm_acks: Optional[DLMAckRegistry] = None
        self.repair_channel = RepairChannel(self)
        # the continuous RepairDaemon running against this engine, when
        # one is (FailureRecovery.start_daemon wires it): recovery points
        # read its ledger instead of scanning again
        self.repair_daemon: Optional[RepairDaemon] = None
        # dlm/<name>s the caller opted out of replicating (offload
        # replicate=False): dirty write-backs skip them too
        self._dlm_no_replicate: Set[str] = set()
        if checkpointer is not None:
            self._home_nid = checkpointer.nodes[0]
            self.dlm_acks = DLMAckRegistry(checkpointer.stores,
                                           checkpointer.nodes, obs=obs)
            if cache is not None:
                for nid, st in checkpointer.stores.items():
                    if st is cache.store:
                        self._home_nid = nid
                        break
                if cache.fallback_reader is None:
                    cache.fallback_reader = self._dlm_replica_read
                if cache.on_writeback is None:
                    # every durable DLM write-back (offload flush, dirty
                    # eviction) re-queues the buddy copy + ack
                    cache.on_writeback = self._queue_dlm_replica
        self.max_inflight = max_inflight_saves or (
            checkpointer.slots if checkpointer is not None else 2)
        self.errors: List[Exception] = []       # post-commit failures
        self.save_errors: List[Exception] = []  # checkpoint COMMIT failures
        self._counters = {k: reg.counter(f"tiered.{k}")
                          for k in ("saves", "offloads", "prefetch_hits",
                                    "prefetch_loads", "stage_in_hits",
                                    "stage_in_loads")}
        self.stats = StatsView(self._counters)
        self._g_inflight = reg.gauge("tiered.inflight_saves")
        self._t_commit = reg.histogram("ckpt.save_commit_s")
        self._tickets: "collections.deque[SaveTicket]" = collections.deque()
        self._retired: List[SaveTicket] = []  # committed, replicas may run
        self._futures: List[Future] = []   # offload/replicate/prefetch
        self._lock = threading.Lock()
        # one FIFO writer thread: serialises pmem writes (slot safety; a
        # delta's prepare reads its base only after the base committed).
        # Reads (prefetch warms) go through their own pool so a large
        # warm-up never delays the next checkpoint commit.
        self._io = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix="tiered-io-wr")
        self._read = ThreadPoolExecutor(max_workers=2,
                                        thread_name_prefix="tiered-io-rd")
        self._stream = None  # the writer's CUDA stream, made at first use

    def _writer_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.checkpointer.device)
        return self._stream

    def run_async(self, fn) -> Future:
        """Run ``fn`` on the engine's FIFO I/O thread, tracked like an
        offload: ``quiesce``/``join`` cover the returned future."""
        fut = self._io.submit(fn)
        self._track_future(fut)
        return fut

    def _track_future(self, fut: Future) -> None:
        with self._lock:
            self._prune_done_locked()
            self._futures.append(fut)

    def attach_catalog(self, catalog) -> None:
        """Wire a DatasetCatalog into the engine: its replica fan-out
        goes through the exchange channel (futures joined by quiesce),
        its reads admit into the DLM cache, and capacity eviction and
        ``evict_cold`` keep the catalog's actively leased datasets
        DRAM-resident."""
        self.catalog = catalog
        catalog.exchange = self.exchange
        if self.cache is not None:
            catalog.cache = self.cache
            if self.cache.protected is None:
                # lease-pinned admission: capacity-pressure LRU never
                # evicts a dataset someone holds a live lease on (serve
                # sessions mid-request, workflow consumers mid-lease)
                self.cache.protected = catalog.leased_cache_keys

    # ---- checkpoint channel ------------------------------------------
    def save_async(self, step: int, tree, *,
                   base_step: Optional[int] = None,
                   drain: bool = False) -> SaveTicket:
        """Nonblocking checkpoint of ``tree``, which must not be written
        to afterwards (the training state is replaced, never updated in
        place); returns at once modulo slot backpressure."""
        ckpt = self.checkpointer
        if ckpt is None:
            raise RuntimeError("no checkpointer attached")
        ticket = SaveTicket(step, checkpointer=ckpt)
        retiring: List[SaveTicket] = []
        with self._lock:
            self._prune_done_locked()
            # double-buffer backpressure: never exceed the slot count;
            # only the retiring ticket's COMMIT gates the caller, its
            # replicates keep overlapping
            while len(self._tickets) >= self.max_inflight:
                retiring.append(self._tickets.popleft())
            self._tickets.append(ticket)
            self._g_inflight.set(len(self._tickets))
        for old in retiring:  # wait outside the lock
            try:
                old.result()
            except Exception as e:  # noqa: BLE001 — surfaced by
                self.save_errors.append(e)  # raise_if_failed / quiesce
            with self._lock:
                self._retired.append(old)

        ready = None
        if ckpt.device.type == "cuda":
            # the writer's stream starts after the caller's has made the
            # state
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(ckpt.device))
        box = [tree]
        del tree
        obs = self.obs
        root = None
        if obs is not None:
            # root span of the whole checkpoint trace: commit + every
            # per-node replicate/drain/ack hangs off this id
            root = obs.begin("ckpt.save", node=self._home_nid,
                             step=step, drain=drain)
        trace = _span_ctx(root)

        def _save():
            t0 = time.time()
            try:
                device_err = None
                try:
                    if ready is None:
                        prep = ckpt.prepare(step, box.pop(),
                                            base_step=base_step,
                                            drain=drain, trace=trace)
                    else:
                        stream = self._writer_stream()
                        with torch.cuda.stream(stream):
                            stream.wait_event(ready)
                            prep = ckpt.prepare(step, box.pop(),
                                                base_step=base_step,
                                                drain=drain, trace=trace)
                        # a hung kernel (the delta encode) raises
                        # KernelTimeout here instead of hanging the writer
                        watchdog.synchronize(
                            stream, what=f"checkpoint step {step}'s device "
                                         f"phase")
                except BaseException as e:
                    device_err = e
                    raise
                finally:
                    box.clear()
                    # the loop waits on device_done: it gets the failure
                    if device_err is None:
                        ticket.device_done.set_result(None)
                    else:
                        ticket.device_done.set_exception(device_err)
                man = ckpt.commit(prep, post_commit=ticket.post_commit)
            except Exception:
                if obs is not None:
                    obs.end(root, status="error")
                raise
            self._t_commit.observe(time.time() - t0)
            ticket.slot = man["slot"]
            self._counters["saves"].inc()
            if obs is not None:
                obs.end(root, slot=man["slot"])
            return man

        def _chain(f: Future) -> None:
            e = f.exception()
            if e is not None:
                ticket.future.set_exception(e)
            else:
                ticket.future.set_result(f.result())

        try:
            self._io.submit(_save).add_done_callback(_chain)
        except RuntimeError:
            with self._lock:
                self._tickets.remove(ticket)
            raise
        return ticket

    def raise_if_failed(self) -> None:
        """Raise (and pop) the first pending checkpoint COMMIT failure.
        Replicate errors degrade durability and are not raised here."""
        with self._lock:
            for t in list(self._tickets):
                if t.done() and t.exception() is not None:
                    self.save_errors.append(t.exception())
                    self._tickets.remove(t)
            if self.save_errors:
                raise self.save_errors.pop(0)

    def _drain_ticket(self, ticket: SaveTicket) -> None:
        """Join one in-flight save: its commit (errors to
        ``save_errors``) and its replicates and drains (to ``errors``)."""
        try:
            ticket.result()
        except Exception as e:  # noqa: BLE001 — kept for quiesce callers
            self.save_errors.append(e)
        self.errors.extend(ticket.wait_post_commit())

    def _prune_done_locked(self) -> None:
        """Drop completed retired tickets and futures, folding their
        failures into ``errors`` first."""
        keep_t = []
        for t in self._retired:
            if all(f.done() for f in t.post_commit):
                for f in t.post_commit:
                    e = f.exception()
                    if e is not None:
                        self.errors.append(e)
            else:
                keep_t.append(t)
        self._retired = keep_t
        keep_f = []
        for f in self._futures:
            if f.done():
                e = f.exception()
                if e is not None:
                    self.errors.append(e)
            else:
                keep_f.append(f)
        self._futures = keep_f

    # ---- object channel (serve session state) ------------------------
    def _queue_dlm_replica(self, name: str) -> None:
        """Queue a buddy copy of ``dlm/<name>`` + its ack (into the DLM
        ack registry) the moment the home-pool bytes are durable. The
        buddy comes from the LIVE ring: after the static buddy dies,
        replicas land on a survivor."""
        ckpt, home = self.checkpointer, self._home_nid
        if (self.replication is None or ckpt is None or home is None
                or name in self._dlm_no_replicate):
            return
        ring = ckpt._live_nodes()
        if home not in ring or len(ring) < 2:
            return
        buddy = ckpt.buddy_of(home, ring)
        obj = f"dlm/{name}"
        reg = self.dlm_acks

        def ack(_man) -> None:
            if reg is not None:
                # REPLACE the target list: this copy carries the bytes
                # just written back, so every other acked copy is stale
                reg.record(obj, home, buddy, targets=[buddy])
        rfut = self.replication.replicate_object(
            home, obj, buddy, on_complete=ack)
        self._track_future(rfut)

    def offload(self, name: str, tree, *, replicate: bool = True) -> Future:
        """Persist an object through the DLM write-back cache (or the
        checkpointer's first store when no cache is attached). The future
        resolves once the object is durable in the home node's pmem;
        with ``replicate`` a buddy replica (acked into ``dlm/ackslog``)
        is then queued. ``replicate=False`` marks the object node-local:
        later dirty write-backs skip it too."""
        if replicate:
            self._dlm_no_replicate.discard(name)
        else:
            self._dlm_no_replicate.add(name)

        def _persist():
            if self.cache is not None:
                self.cache.put(name, tree)
                # write back just this object; the cache's write-back
                # hook queues the buddy replica + ack
                self.cache.flush(name)
            else:
                if self.checkpointer is None:
                    raise RuntimeError("no pmem backend attached")
                self.checkpointer._meta_store().put(f"dlm/{name}", tree)
                self._queue_dlm_replica(name)
            self._counters["offloads"].inc()
            return name

        fut = self._io.submit(_persist)
        self._track_future(fut)
        return fut

    def _dlm_candidates(self, name: str) -> Tuple[str, List[str]]:
        """Replica name + fallback read order for ``dlm/<name>``:
        ack-recorded targets first, then the home's ring buddy, then
        every other node (home itself excluded)."""
        ckpt = self.checkpointer
        home = self._home_nid
        rep = f"replica/{home}/dlm/{name}"
        acked = self.dlm_acks.targets(f"dlm/{name}") \
            if self.dlm_acks is not None else []
        order = acked + [ckpt.buddy_of(home)] + \
            [n for n in ckpt.nodes if n != home]
        out: List[str] = []
        seen: Set[str] = set()
        for nid in order:
            if nid not in seen and nid != home:
                seen.add(nid)
                out.append(nid)
        return rep, out

    def _dlm_replica_read(self, name: str):
        """Multi-node DLM fallback: when the home node's pool is dead,
        read the buddy replica placed by ``offload``, preferring the
        ack-recorded targets, then the ring buddy, then any survivor
        holding ``replica/<home>/dlm/<name>``."""
        ckpt = self.checkpointer
        rep, order = self._dlm_candidates(name)
        last: Optional[Exception] = None
        for nid in order:
            try:
                if ckpt.stores[nid].exists(rep):
                    return ckpt.stores[nid].get(rep)
            except IOError as e:  # that node is dead too: keep walking
                last = e
        if last is not None:
            raise last
        raise FileNotFoundError(
            f"dlm/{name} (home {self._home_nid} unreadable and no node "
            f"holds {rep})")

    def fetch_leaf(self, name: str, leaf: str):
        """Byte-range demand read: ONE leaf of ``dlm/<name>`` without
        touching its siblings. A DRAM-resident cache copy serves from
        memory; otherwise the leaf's bytes come from the home pool,
        falling back to acked replicas like ``fetch`` (decoding only that
        leaf's tiles when the copy travelled wire-encoded). Nothing is
        admitted into the cache. Raises ``KeyError`` for a missing
        leaf."""
        if self.cache is not None and self.cache.contains(name):
            flat = dict(_flatten(self.cache.get(name)))
            if leaf not in flat:
                raise KeyError(leaf)
            return flat[leaf]
        ckpt = self.checkpointer
        home = self._home_nid
        if ckpt is None or home is None:
            raise RuntimeError("no pmem backend attached")
        try:
            return ckpt.stores[home].get_leaf(f"dlm/{name}", leaf)
        except IOError:
            pass  # home pool dead or object gone: walk the replicas
        rep, order = self._dlm_candidates(name)
        last: Optional[Exception] = None
        for nid in order:
            try:
                if ckpt.stores[nid].exists(rep):
                    return ckpt.stores[nid].get_leaf(rep, leaf)
            except IOError as e:
                last = e
        if last is not None:
            raise last
        raise FileNotFoundError(f"dlm/{name} leaf {leaf!r} (home {home} "
                                f"unreadable and no node holds {rep})")

    def fetch(self, name: str):
        """Demand read through the DLM cache (hit/miss accounted), or
        straight from pmem when no cache is attached."""
        if self.cache is not None:
            return self.cache.get(name)
        if self.checkpointer is None:
            raise RuntimeError("no pmem backend attached")
        return self.checkpointer._meta_store().get(f"dlm/{name}")

    def prefetch(self, names: Iterable[str]) -> Future:
        """Warm DRAM with ``names`` from pmem in the background. The
        future resolves to ``{"hits": n_already_resident, "loads":
        n_pulled_from_pmem, "missing": n_not_in_pmem}``. Advisory: an
        absent object is counted, never raised."""
        if self.cache is None:
            raise RuntimeError("no DLM cache attached")
        names = list(names)

        def _warm():
            obs = self.obs
            sp = obs.begin("dlm.prefetch", node=self._home_nid,
                           n=len(names)) if obs is not None else None
            hits = loads = missing = 0
            for n in names:
                try:
                    if self.cache.prefetch(n):
                        hits += 1
                    else:
                        loads += 1
                except (IOError, FileNotFoundError, KeyError):
                    missing += 1
            self._counters["prefetch_hits"].inc(hits)
            self._counters["prefetch_loads"].inc(loads)
            if obs is not None:
                obs.end(sp, hits=hits, loads=loads, missing=missing)
            return {"hits": hits, "loads": loads, "missing": missing}

        fut = self._read.submit(_warm)
        self._track_future(fut)
        return fut

    def evict_cold(self, max_idle_s: float = 0.0) -> int:
        """Spill idle DRAM entries back to pmem; returns count evicted.
        Lease-aware: datasets the attached catalog holds live leases on
        stay pinned."""
        if self.cache is None:
            return 0
        keep = (self.catalog.leased_cache_keys()
                if self.catalog is not None else ())
        return self.cache.evict_cold(max_idle_s, keep=keep)

    def prefetch_datasets(self, refs, workflow: str = "default") -> Future:
        """Anticipatory dataset warm-up through the catalog: resolve each
        named dataset (home pmem or acked replica) on the read pool and
        admit it into the DLM cache, so a consumer job's first ``read``
        hits DRAM. Advisory like ``prefetch``: absent or reclaimed
        datasets are counted, never raised."""
        if self.catalog is None:
            raise RuntimeError("no catalog attached")
        refs = list(refs)

        def _warm():
            obs = self.obs
            sp = obs.begin("exch.prefetch", node=self._home_nid,
                           n=len(refs)) if obs is not None else None
            hits = loads = missing = 0
            for name in refs:
                try:
                    rec = self.catalog.record(name, workflow)
                    key = cache_key(workflow, name, rec["version"])
                    if self.cache is not None and self.cache.contains(key):
                        hits += 1
                        continue
                    self.catalog.get(name, workflow)
                    loads += 1
                except (KeyError, IOError, FileNotFoundError):
                    missing += 1
            self._counters["prefetch_hits"].inc(hits)
            self._counters["prefetch_loads"].inc(loads)
            if obs is not None:
                obs.end(sp, hits=hits, loads=loads, missing=missing)
            return {"hits": hits, "loads": loads, "missing": missing}

        fut = self._read.submit(_warm)
        self._track_future(fut)
        return fut

    def repair(self, lost_nodes: Sequence[str], **kw) -> dict:
        """Re-replicate every acked checkpoint shard, dataset (when a
        catalog is attached) and DLM object whose copies ``lost_nodes`` reduced to a single survivor, re-acked when
        durable, and rehydrate drain-only checkpoint shards into pmem;
        joins the copies and returns the ``RepairChannel`` report
        (``max_inflight``, ``priority`` and ``rehydrate`` pass through).
        Recovery points call it after quiescing in-flight work; the
        daemon calls it without, which is safe because acks only ever
        describe durable transfers."""
        return self.repair_channel.repair(lost_nodes, **kw)

    # ---- burst-buffer channel (external -> pmem) ---------------------
    def stage_in(self, nid: str, names: Sequence[str],
                 prefix: str = "staged/") -> List[Future]:
        """Pre-load external objects into node ``nid``'s pmem (Fig. 8
        steps 1-3). Objects already resident count as stage-in hits."""
        if self.scheduler is None:
            raise RuntimeError("no scheduler attached")
        obs = self.obs
        sp = obs.begin("stage.stage_in", node=nid,
                       n=len(names)) if obs is not None else None
        futs: List[Future] = []
        for name in names:
            obj = prefix + name
            if self.scheduler.stores[nid].exists(obj):
                self._counters["stage_in_hits"].inc()
                done: Future = Future()
                done.set_result(None)
                futs.append(done)
                continue
            self._counters["stage_in_loads"].inc()
            futs.append(self.scheduler.stage_in(nid, name, obj,
                                                span=_span_ctx(sp)))
        if obs is not None:
            obs.end(sp, submitted=len(futs))
        with self._lock:
            self._prune_done_locked()
            self._futures.extend(futs)
        return futs

    def stage_in_hit_rate(self) -> float:
        tot = self.stats["stage_in_hits"] + self.stats["stage_in_loads"]
        return self.stats["stage_in_hits"] / tot if tot else 0.0

    # ---- lifecycle ---------------------------------------------------
    def quiesce(self) -> List[Exception]:
        """Join every in-flight save, replicate, offload and prefetch.
        Errors are collected and returned, never raised."""
        while True:
            with self._lock:
                if self._tickets:
                    ticket, fresh = self._tickets.popleft(), True
                elif self._retired:
                    ticket, fresh = self._retired.pop(), False
                else:
                    break
            if fresh:
                self._drain_ticket(ticket)
            else:  # commit already joined at backpressure time
                self.errors.extend(ticket.wait_post_commit())
        while True:
            with self._lock:
                if not self._futures:
                    break
                fut = self._futures.pop()
            try:
                fut.result()
            except Exception as e:  # noqa: BLE001
                self.errors.append(e)
        with self._lock:
            errors = self.save_errors + self.errors
            self.save_errors, self.errors = [], []
        return errors

    def join(self) -> None:
        """Strict barrier: wait for all in-flight work, raising the first
        REAL error. A ``SupersededError`` (a replicate outpaced by slot
        reuse, covered by the newer save's own) is benign."""
        errors = [e for e in self.quiesce()
                  if not isinstance(e, SupersededError)]
        if errors:
            raise errors[0]

    def shutdown(self) -> None:
        self.quiesce()
        self._io.shutdown(wait=True)
        self._read.shutdown(wait=True)
