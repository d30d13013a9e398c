"""Persistent Dataset Exchange: a pmem-resident dataset catalog (§V-A).

PyTorch counterpart of ``repro/core/dataset_exchange.py``, with its
record schema, log events and object names, so a catalog written by
either package is read by the other. A producer leaves a dataset in
node-local persistent memory and consumers read it in place, skipping
the external-filesystem round trip (Fig. 8 "retain"). ``DatasetCatalog``
gives that sharing a contract:

  * every shared object is a named, versioned **Dataset** whose catalog
    record (small JSON, replicated to every live pool) persists name,
    version, producing job, workflow id, the input dataset versions it
    was derived from, a content digest (``content_digest`` of the
    manifest: the same on either package's bytes, bf16 included), byte
    size and the placement map (home node + acked buddy replicas);
  * consumers **acquire leases**; the refcount is the set of unexpired,
    unreleased leases. ``gc()`` reclaims pmem bytes only for datasets
    that are unretained AND lease-free, and keeps the record (minus
    bytes), so lineage queries survive garbage collection;
  * ``publish`` registers a buddy replica through the TieredIO exchange
    channel, whose ack is recorded into the catalog record the moment
    the transfer is durable. ``recoverable(name, lost_nodes)`` answers
    from the record alone, with zero object-store probes;
  * reads fall back to the acked replica (``replica/<home>/<obj>``) when
    the home pool is dead, and admit the tree into the DLM cache (when
    attached) so repeat consumers hit DRAM. Reads return host trees
    (numpy arrays, bf16 as ``torch.bfloat16`` CPU tensors); ``publish``
    takes leaves on the card or the host.

Record schema (``exch/<workflow>/<name>@v<version>.json``):

  {"name", "workflow", "version", "object", "home", "nbytes", "digest",
   "ts", "retained": bool, "reclaimed": bool,
   "lineage": {"job": producing job, "workflow": wf id,
               "inputs": [[name, workflow, version] | ["__external__",
                          external name, 0], ...]},
   "leases": {lease_id: {"owner", "expires", "ts",
                         "released": bool (terminal tombstone)}},
   "acks":   {"replica": {"target", "targets": [nids], "ts"}}}

``publish`` writes the full birth record once as a replicated JSON file
(``versions``/``records`` list these); every later mutation (replica
acks, lease grants, release tombstones, unretain, gc reclaim) is ONE
typed event appended to the replicated catalog log (``exch/catalog.log``,
a ``MetaLog``). ``record()`` reads the log's folded head state, falling
back to the cross-pool JSON merge only for records that predate the log.
GC decisions are computed once at decision time and recorded IN the
event, so replay never re-evaluates clocks; the tombstones are still
written, so a pool holding a stale pre-mutation JSON copy can never
resurrect a lease or a reclaimed record.

**Single-writer-per-record contract**: the read-check-then-append
sections (``acquire``'s reclaimed check, ``gc``'s keep/reclaim decision)
serialise on ``self._lock``, per process only. Concurrent mutators of the
SAME record in different processes are not ordered; one catalog writer
per record is the assumed topology, as ``SimCluster`` wires it.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.annotations import metadata_only
from repro_torch.core.meta_log import MetaLog
from repro_torch.core.object_store import PMemObjectStore, content_digest

#: lineage marker for inputs that came from outside the catalog
EXTERNAL_INPUT = "__external__"

DEFAULT_LEASE_TTL_S = 300.0

#: default clock-skew margin for GC expiry decisions (see DatasetCatalog)
DEFAULT_CLOCK_SKEW_S = 2.0


def ack_targets(rec: Optional[dict]) -> List[str]:
    """The acked replica holders recorded in one ack entry. Modern
    records carry the full ``targets`` list (repair prunes + extends
    it); legacy records carry a single ``target`` — read as a
    one-element list, so every consumer (recoverability checks, replica
    read order, the repair scan) handles both shapes identically."""
    if not rec:
        return []
    targets = rec.get("targets")
    if targets:
        return list(targets)
    target = rec.get("target")
    return [target] if target else []


@dataclass
class Lease:
    """One consumer's hold on a dataset version. The dataset's bytes
    cannot be reclaimed while any unexpired lease exists.

    ``expires`` is stamped with the ACQUIRING node's wall clock;
    ``expired`` here compares against the local clock and is only a
    local-process hint. The authoritative reclaim decision is
    ``DatasetCatalog.gc``, which pads expiry with the catalog's
    ``clock_skew_s`` margin before touching bytes."""
    lease_id: str
    name: str
    workflow: str
    version: int
    owner: str
    expires: float

    def expired(self, now: Optional[float] = None) -> bool:
        return (now if now is not None else time.time()) >= self.expires


def _rec_name(workflow: str, name: str, version: int) -> str:
    return f"exch/{workflow}/{name}@v{version}.json"


def live_pools(stores: Dict[str, PMemObjectStore],
               nodes: Sequence[str]) -> List[str]:
    """Nodes whose pmem is reachable (all of them when none are —
    let the writes themselves surface the outage)."""
    live = [n for n in nodes
            if getattr(stores[n].pool, "alive", True)]
    return list(live or nodes)


def put_json_all_pools(stores: Dict[str, PMemObjectStore],
                       nodes: Sequence[str], name: str, obj: dict) -> int:
    """Replicate a small metadata record to every live pool (the same
    discipline as checkpoint manifests) — shared by catalog records and
    workflow journals. Returns the number of pools written; raises when
    none were reachable."""
    wrote = 0
    for nid in live_pools(stores, nodes):
        try:
            stores[nid].pool.put_json(name, obj)
            wrote += 1
        except IOError:
            continue
    if not wrote:
        raise IOError(f"no reachable pool for metadata {name}")
    return wrote


def read_json_copies(stores: Dict[str, PMemObjectStore],
                     nodes: Sequence[str], name: str) -> List[dict]:
    """All readable pool copies of a replicated record (callers merge
    with their own semantics). Raises the last error when none read."""
    copies: List[dict] = []
    err: Optional[Exception] = None
    for nid in nodes:
        try:
            copies.append(stores[nid].pool.get_json(name))
        except (IOError, FileNotFoundError, ValueError) as e:
            # ValueError: a torn/truncated JSON copy (media damage on
            # one pool — put_json itself commits atomically). The
            # surviving well-formed copies still win the merge.
            err = e
    if not copies:
        raise err if err is not None else FileNotFoundError(name)
    return copies


def cache_key(workflow: str, name: str, version: int) -> str:
    """DLM-cache key for a dataset version (lease-aware eviction keys)."""
    return f"exch/{workflow}/{name}@v{version}"


def _fold_catalog(state: dict, ev: dict) -> None:
    """MetaLog reducer for catalog records: state maps the record name
    (``exch/<wf>/<name>@v<N>.json``) to the full record dict. Every
    event bumps the record's ``ts`` (the old every-update-advances-ts
    rule); records are copy-on-write so readers holding the previous
    dict keep a consistent snapshot. ``gc`` events carry the lease-keep
    list and the reclaim verdict VERBATIM — the decision was made once,
    under the writer's lock, against the writer's clock; replay only
    re-applies it."""
    op, rname = ev["op"], ev["rec"]
    if op == "put":
        rec = dict(ev["record"])
        rec["leases"] = dict(rec.get("leases") or {})
        rec["acks"] = dict(rec.get("acks") or {})
        state[rname] = rec
        return
    old = state.get(rname)
    if old is None:
        return  # event for a record the log never saw (pruned/foreign)
    rec = {**old, "leases": dict(old.get("leases") or {}),
           "acks": dict(old.get("acks") or {}), "ts": ev["ts"]}
    if op == "ack_add":
        targets = sorted(set(ack_targets(rec["acks"].get("replica")))
                         | {ev["target"]})
        rec["acks"]["replica"] = {"target": ev["target"],
                                  "targets": targets, "ts": ev["ts"]}
    elif op == "ack_put":
        rec["acks"]["replica"] = {"target": ev["target"],
                                  "targets": sorted(ev["targets"]),
                                  "ts": ev["ts"]}
    elif op == "lease":
        rec["leases"][ev["lid"]] = {"owner": ev["owner"],
                                    "expires": ev["expires"],
                                    "ts": ev["ts"]}
    elif op == "lease_release":
        old_l = rec["leases"].get(ev["lid"]) or {}
        rec["leases"][ev["lid"]] = {
            "owner": ev["owner"],
            "expires": old_l.get("expires", ev["expires"]),
            "released": True, "ts": ev["ts"]}
    elif op == "unretain":
        rec["retained"] = False
    elif op == "gc":
        keep = set(ev["keep"])
        rec["leases"] = {lid: l for lid, l in rec["leases"].items()
                         if lid in keep}
        if ev.get("reclaimed"):
            rec["reclaimed"] = True
    state[rname] = rec


class DatasetCatalog:
    """Pmem-resident catalog of named, versioned, leased datasets."""

    def __init__(self, stores: Dict[str, PMemObjectStore],
                 exchange=None, cache=None,
                 clock_skew_s: float = DEFAULT_CLOCK_SKEW_S):
        self.stores = stores
        self.nodes = sorted(stores)
        # GC expiry margin: lease `expires` stamps are written with the
        # PRODUCER's wall clock, so a consumer-side gc() must not trust
        # its own clock to the second. A lease is only treated as
        # expired (reclaimable / prunable) once local time passes
        # `expires + clock_skew_s` — bytes are never reclaimed while a
        # lease could still be live on a node up to clock_skew_s ahead.
        self.clock_skew_s = float(clock_skew_s)
        # TieredIO ExchangeChannel (replica fan-out with acks); attached
        # by TieredIO.attach_catalog, or left None for standalone use
        self.exchange = exchange
        self.cache = cache  # DLMCache: read path admits, leases pin
        # serialises every read-check-then-append on a record (see the
        # single-writer-per-record contract in the module docstring);
        # reentrant so gc/acquire can compose reads with event appends
        self._lock = threading.RLock()
        self._lease_seq = itertools.count(1)
        self._leases: Dict[str, Lease] = {}  # granted by THIS process
        self._version_cache: Dict[Tuple[str, str], int] = {}
        # records live in the replicated catalog log: the folded head
        # state IS the cache (replay rebuilds it cold). _rec_cache only
        # fronts legacy pre-log records written via _put_json_all.
        self._rec_cache: Dict[str, dict] = {}
        self._log = MetaLog(stores, self.nodes, "exch/catalog.log",
                            fold=_fold_catalog)
        self.stats = {"published": 0, "reclaimed": 0, "replica_reads": 0}

    # ---- replicated record I/O (same discipline as checkpoint meta) ---
    def _live(self) -> List[str]:
        return live_pools(self.stores, self.nodes)

    def _put_json_all(self, name: str, obj: dict) -> None:
        put_json_all_pools(self.stores, self.nodes, name, obj)
        self._rec_cache[name] = obj

    def _get_json_merged(self, name: str) -> dict:
        """One record's current state: the catalog log's folded head
        state (log replay + cache — the modern path), else the legacy
        cross-pool JSON union merge for records that predate the log
        (newest ``ts`` wins the scalar fields; ``leases`` and ``acks``
        are merged; ``released``/``reclaimed`` stay terminal)."""
        rec = self._log.state().get(name)
        if rec is not None:
            return rec
        cached = self._rec_cache.get(name)
        if cached is not None:
            return cached
        copies = read_json_copies(self.stores, self.nodes, name)
        best = dict(max(copies, key=lambda c: c.get("ts", 0)))
        leases: Dict[str, dict] = {}
        acks: Dict[str, dict] = {}
        for c in copies:
            for lid, rec in (c.get("leases") or {}).items():
                if lid not in leases or \
                        rec.get("ts", 0) > leases[lid].get("ts", 0):
                    leases[lid] = rec
                # release is TERMINAL, like reclaim: a stale pool copy
                # that missed the release write still holds the lease
                # live — without the tombstone winning the merge it
                # would resurrect and block gc() forever
                if rec.get("released"):
                    leases[lid] = {**leases[lid], "released": True}
            for kind, rec in (c.get("acks") or {}).items():
                if kind not in acks or \
                        rec.get("ts", 0) > acks[kind].get("ts", 0):
                    acks[kind] = rec
        # reclaim is terminal: a stale unreclaimed copy on a pool that
        # missed the GC write must not resurrect the bytes' record
        best["reclaimed"] = any(c.get("reclaimed") for c in copies)
        best["leases"], best["acks"] = leases, acks
        return best

    # ---- versions -----------------------------------------------------
    @metadata_only
    def versions(self, name: str, workflow: str) -> List[int]:
        """All published versions of (workflow, name), ascending."""
        prefix = f"exch/{workflow}/"
        out: Set[int] = set()
        tag = f"{name}@v"
        for nid in self.nodes:
            pool = self.stores[nid].pool
            if not getattr(pool, "alive", True):
                continue
            for f in pool.list(prefix):
                base = f[len(prefix):]
                if base.startswith(tag) and base.endswith(".json"):
                    out.add(int(base[len(tag):-len(".json")]))
        return sorted(out)

    @metadata_only
    def latest_version(self, name: str, workflow: str) -> Optional[int]:
        # publishes in this process keep the cache current; a cold
        # process (resume) falls through to the replicated pool records
        v = self._version_cache.get((workflow, name))
        if v is not None:
            return v
        vs = self.versions(name, workflow)
        if vs:
            with self._lock:
                # publish writes this cache under the catalog lock; the
                # cold-path fill must too (lockset discipline)
                self._version_cache[(workflow, name)] = vs[-1]
        return vs[-1] if vs else None

    def exists(self, name: str, workflow: str) -> bool:
        """A record exists for (workflow, name) — including reclaimed
        ones (records outlive bytes). Use ``available`` to ask whether
        the BYTES of the latest version are still held."""
        return self.latest_version(name, workflow) is not None

    def available(self, name: str, workflow: str) -> bool:
        """The latest version's bytes are still held (not reclaimed) —
        the readiness check for consumers; a reclaimed dataset must fall
        back to whatever external/raw copy the caller knows about."""
        try:
            return not self.record(name, workflow).get("reclaimed")
        except (KeyError, IOError, FileNotFoundError):
            return False

    # ---- publish ------------------------------------------------------
    def publish(self, name: str, tree, *, workflow: str = "default",
                producer: Optional[str] = None,
                inputs: Sequence[Sequence] = (),
                node: Optional[str] = None, retained: bool = True,
                replicate: bool = True,
                annotations: Optional[dict] = None,
                on_replica=None) -> dict:
        """Write a new version of ``name``: bytes to the home node's
        store, record to every live pool, buddy replica (acked) through
        the exchange channel. ``inputs`` are lineage refs —
        ``(name, workflow, version)`` tuples or ``(EXTERNAL_INPUT,
        external_name, 0)``. Returns the catalog record.

        ``annotations`` (small JSON dict) persists verbatim in the
        record — the serve tier stamps its session trace id here so one
        session's span tree reconnects across process restarts.
        ``on_replica`` is called (no args, from the replicate task's
        worker thread) after the buddy replica's ack has been recorded —
        the serve tier's spill-to-ack latency probe."""
        with self._lock:
            key = (workflow, name)
            v = self._version_cache.get(key)
            if v is None:
                v = self.latest_version(name, workflow) or 0
            v += 1
            self._version_cache[key] = v
        live = self._live()
        home = node if node in live else live[0]
        obj = f"wf/{workflow}/{name}"
        man = self.stores[home].put(
            obj, tree, version=v,
            meta={"dataset": name, "workflow": workflow, "version": v})
        rec = {
            "name": name, "workflow": workflow, "version": v,
            "object": obj, "home": home, "nbytes": man["nbytes"],
            "digest": content_digest(man), "ts": time.time(),
            "retained": bool(retained), "reclaimed": False,
            "lineage": {"job": producer, "workflow": workflow,
                        "inputs": [list(ref) for ref in inputs]},
            "leases": {}, "acks": {},
        }
        if annotations:
            rec["annotations"] = dict(annotations)
        rname = _rec_name(workflow, name, v)
        # birth record: ONE full JSON write for discovery (versions/
        # records list these files; legacy readers merge them) ...
        self._put_json_all(rname, rec)
        # ... then every mutation is an appended log event; the "put"
        # seeds the log's folded state with the same birth record
        with self._lock:
            self._log.append({"op": "put", "rec": rname, "record": rec,
                              "ts": rec["ts"]})
        self.stats["published"] += 1
        if replicate and self.exchange is not None and len(live) > 1:
            ring = live
            buddy = ring[(ring.index(home) + 1) % len(ring)]
            self.exchange.submit(
                home, obj, buddy, version=v,
                expect_meta={"dataset": name, "version": v},
                on_ack=self._ack_recorder(workflow, name, v, buddy,
                                          then=on_replica))
        return rec

    def _ack_recorder(self, workflow: str, name: str, version: int,
                      target: str, then=None):
        def record(_result) -> None:
            self._append_event(workflow, name, version,
                               {"op": "ack_add", "target": target})
            if then is not None:
                then()
        return record

    def record_repair_ack(self, workflow: str, name: str, version: int,
                          *, target: str, targets: Sequence[str]) -> None:
        """Record a repair's completed re-replication: REPLACES the
        target list (pruning holders lost with their nodes, adding the
        fresh buddy). Runs only after the new copy is durable — the
        RepairChannel calls this from inside the replicate task."""
        self._append_event(workflow, name, version,
                           {"op": "ack_put", "target": target,
                            "targets": sorted(targets)})

    def _append_event(self, workflow: str, name: str, version: int,
                      ev: dict) -> dict:
        """Append one mutation event for a record to the catalog log
        (the replacement for the old read-merge-rewrite of the whole
        JSON record). A record that predates the log is adopted first:
        its legacy cross-pool merge is logged as a ``put`` so the event
        lands on a complete base. Returns the record's new head state."""
        rname = _rec_name(workflow, name, version)
        with self._lock:
            if self._log.state().get(rname) is None:
                base = self._get_json_merged(rname)  # legacy/birth copy
                self._log.append({"op": "put", "rec": rname,
                                  "record": base,
                                  "ts": base.get("ts", time.time())})
            self._log.append({**ev, "rec": rname, "ts": time.time()})
            return self._log.state()[rname]

    # ---- read path ----------------------------------------------------
    @metadata_only
    def record(self, name: str, workflow: str = "default",
               version: Optional[int] = None) -> dict:
        if version is None:
            version = self.latest_version(name, workflow)
            if version is None:
                raise KeyError(f"dataset {workflow}/{name}: never published")
        return self._get_json_merged(_rec_name(workflow, name, version))

    def get(self, name: str, workflow: str = "default",
            version: Optional[int] = None):
        """Read a dataset version: DLM cache, then home pmem, then the
        acked buddy replica (then any node holding one) when the home
        pool is dead or lost the object."""
        rec = self.record(name, workflow, version)
        if rec.get("reclaimed"):
            raise KeyError(f"dataset {workflow}/{name}@v{rec['version']} "
                           f"was reclaimed (lease expired, refcount zero)")
        ckey = cache_key(workflow, name, rec["version"])
        if self.cache is not None:
            hit = self.cache.peek(ckey)
            if hit is not None:
                return hit
        tree = self._read_object(rec)
        if self.cache is not None:
            self.cache.admit(ckey, tree)
        return tree

    def _read_object(self, rec: dict):
        v, obj, home = rec["version"], rec["object"], rec["home"]
        try:
            if self.stores[home].exists(obj, v):
                return self.stores[home].get(obj, v)
        except IOError:
            pass  # home pool dead — fall through to replicas
        rep = f"replica/{home}/{obj}"
        order = ack_targets((rec.get("acks") or {}).get("replica")) + \
            [n for n in self.nodes if n != home]
        seen: Set[str] = set()
        last: Optional[Exception] = None
        for nid in order:
            if nid is None or nid in seen or nid == home:
                continue
            seen.add(nid)
            try:
                if self.stores[nid].exists(rep, v):
                    self.stats["replica_reads"] += 1
                    return self.stores[nid].get(rep, v)
            except IOError as e:
                last = e
        raise KeyError(
            f"dataset {rec['workflow']}/{rec['name']}@v{v}: home {home} "
            f"unreadable and no replica found") from last

    def get_leaf(self, name: str, leaf: str, workflow: str = "default",
                 version: Optional[int] = None):
        """Byte-range read of ONE leaf of a dataset version (a single
        KV page of a spilled serve session, the ``pos`` cursor) without
        rehydrating the rest of the tree. The read covers exactly that
        leaf's bytes (home pool first, then the ACKED replica holders
        when the home died — never a blind fan-out), decoding only its
        own tiles when the copy travelled wire-encoded. Nothing is
        admitted into the DLM cache. Raises ``KeyError`` for a
        reclaimed dataset or a leaf the object does not carry."""
        rec = self.record(name, workflow, version)
        if rec.get("reclaimed"):
            raise KeyError(f"dataset {workflow}/{name}@v{rec['version']} "
                           f"was reclaimed")
        v, obj, home = rec["version"], rec["object"], rec["home"]
        try:
            if self.stores[home].exists(obj, v):
                return self.stores[home].get_leaf(obj, leaf, v)
        except IOError:
            pass  # home pool dead — fall through to acked replicas
        rep = f"replica/{home}/{obj}"
        last: Optional[Exception] = None
        for nid in ack_targets((rec.get("acks") or {}).get("replica")):
            if nid == home:
                continue
            try:
                if self.stores[nid].exists(rep, v):
                    self.stats["replica_reads"] += 1
                    return self.stores[nid].get_leaf(rep, leaf, v)
            except IOError as e:
                last = e
        raise KeyError(
            f"dataset {workflow}/{name}@v{v} leaf {leaf!r}: home {home} "
            f"unreadable and no acked replica survives") from last

    # ---- recoverability (metadata only — the resume contract) ---------
    @metadata_only
    def recoverable(self, name: str, workflow: str = "default",
                    version: Optional[int] = None,
                    lost_nodes: Sequence[str] = ()) -> bool:
        """Would this dataset survive losing ``lost_nodes``? Decided from
        the catalog record's placement + replica ack alone — ZERO
        object-store probes (``WorkflowScheduler.resume`` ranks whole
        workflows with this, mirroring ``restore_latest_recoverable``)."""
        try:
            rec = self.record(name, workflow, version)
        except (KeyError, IOError, FileNotFoundError):
            return False
        if rec.get("reclaimed"):
            return False
        if rec["home"] not in lost_nodes:
            return True
        targets = ack_targets((rec.get("acks") or {}).get("replica"))
        return any(t not in lost_nodes for t in targets)

    # ---- leases / refcount / GC --------------------------------------
    def acquire(self, name: str, *, workflow: str = "default",
                version: Optional[int] = None, owner: str = "anon",
                ttl_s: float = DEFAULT_LEASE_TTL_S) -> Lease:
        """Take a lease on a dataset version; GC cannot reclaim its bytes
        until every lease is released or expired."""
        rec = self.record(name, workflow, version)
        v = rec["version"]
        lid = f"{owner}-{next(self._lease_seq)}"
        lease = Lease(lid, name, workflow, v, owner, time.time() + ttl_s)
        with self._lock:
            # checked under the catalog lock: a GC that won the race and
            # logged the reclaim must refuse the lease (the check and
            # the lease event are atomic w.r.t. gc's decide-and-append)
            if self.record(name, workflow, v).get("reclaimed"):
                raise KeyError(f"dataset {workflow}/{name}@v{v} "
                               f"already reclaimed")
            self._append_event(workflow, name, v,
                               {"op": "lease", "lid": lid,
                                "owner": owner,
                                "expires": lease.expires})
        self._leases[lid] = lease
        return lease

    def release(self, lease: Lease) -> None:
        """Release a lease by writing a TERMINAL tombstone (``released``,
        like ``reclaimed``) rather than deleting the entry: a pool that
        was down during this write keeps a stale copy with the lease
        still live, and a plain deletion loses against it in the
        cross-pool union — the lease would resurrect and block ``gc()``
        until its far-off expiry. The tombstone keeps the original
        ``expires`` and is pruned by gc once safely past it (when any
        stale live copy is expired too)."""
        self._leases.pop(lease.lease_id, None)
        try:
            self._append_event(lease.workflow, lease.name, lease.version,
                               {"op": "lease_release",
                                "lid": lease.lease_id,
                                "owner": lease.owner,
                                "expires": lease.expires})
        except (IOError, FileNotFoundError):
            pass  # record unreachable — expiry reclaims it eventually

    def refcount(self, name: str, workflow: str = "default",
                 version: Optional[int] = None,
                 now: Optional[float] = None) -> int:
        """Number of unexpired, unreleased leases on the dataset
        version (released tombstones no longer hold the bytes)."""
        rec = self.record(name, workflow, version)
        now = now if now is not None else time.time()
        return sum(1 for l in (rec.get("leases") or {}).values()
                   if l.get("expires", 0) > now and not l.get("released"))

    def unretain(self, name: str, workflow: str = "default",
                 version: Optional[int] = None) -> None:
        """Drop producer retention: the dataset becomes reclaimable as
        soon as its refcount reaches zero."""
        rec = self.record(name, workflow, version)
        self._append_event(workflow, name, rec["version"],
                           {"op": "unretain"})

    def leased_cache_keys(self, now: Optional[float] = None) -> Set[str]:
        """DLM-cache keys of datasets this process holds live leases on
        (TieredIO's lease-aware eviction keeps these DRAM-resident)."""
        now = now if now is not None else time.time()
        return {cache_key(l.workflow, l.name, l.version)
                for l in self._leases.values() if not l.expired(now)}

    def records(self, workflow: Optional[str] = None) -> List[dict]:
        """All catalog records (optionally one workflow's), merged."""
        names: Set[str] = set()
        prefix = f"exch/{workflow}/" if workflow else "exch/"
        for nid in self.nodes:
            pool = self.stores[nid].pool
            if not getattr(pool, "alive", True):
                continue
            names.update(f for f in pool.list(prefix)
                         if f.endswith(".json"))
        return [self._get_json_merged(n) for n in sorted(names)]

    def gc(self, now: Optional[float] = None,
           skew_s: Optional[float] = None) -> List[Tuple[str, str, int]]:
        """Reclaim pmem bytes of every dataset that is unretained AND has
        no unexpired lease. Expired leases are dropped; the record stays
        (marked ``reclaimed``) so lineage survives the bytes. Returns
        the reclaimed ``(workflow, name, version)`` triples.

        **Expiry contract**: lease ``expires`` stamps come from the
        PRODUCER's wall clock; this gc runs on the local one. A lease is
        treated as expired only once ``now > expires + skew_s`` (default
        ``self.clock_skew_s``), so a consumer node up to that margin
        ahead never has bytes reclaimed out from under a live lease.
        Released tombstones are pruned on the same schedule — only after
        any stale still-live pool copy of the lease is expired too, so
        pruning can never let one resurrect.

        The decision runs under the catalog lock against the CURRENT
        head state (not the scan snapshot), is recorded verbatim in the
        appended ``gc`` event (keep-list + reclaim verdict — replay
        re-applies the decision, never re-evaluates clocks), and the
        terminal ``reclaimed`` mark lands BEFORE any bytes are deleted —
        a lease acquired concurrently either lands first (and defers
        reclaim) or sees ``reclaimed`` and is refused; it is never
        silently destroyed."""
        now = now if now is not None else time.time()
        margin = self.clock_skew_s if skew_s is None else float(skew_s)
        reclaimed: List[Tuple[str, str, int]] = []
        for rec in self.records():
            if rec.get("reclaimed"):
                continue
            try:
                with self._lock:
                    # decide against the CURRENT head state (a lease may
                    # have landed since the scan snapshot)
                    r = self.record(rec["name"], rec["workflow"],
                                    rec["version"])
                    if r.get("reclaimed"):
                        continue
                    leases = r.get("leases") or {}
                    # keep everything not safely past expiry (skew
                    # margin), tombstones included; live = the subset
                    # actually holding the bytes (unexpired AND
                    # unreleased)
                    keep = {lid: l for lid, l in leases.items()
                            if l.get("expires", 0) + margin > now}
                    live = {lid: l for lid, l in keep.items()
                            if not l.get("released")}
                    reclaim = not r.get("retained") and not live
                    if reclaim or len(keep) != len(leases):
                        self._append_event(
                            rec["workflow"], rec["name"], rec["version"],
                            {"op": "gc", "keep": sorted(keep),
                             "reclaimed": reclaim})
            except (IOError, FileNotFoundError, KeyError):
                continue  # record unreachable right now — next sweep
            if reclaim:
                self._delete_bytes(rec)
                reclaimed.append(
                    (rec["workflow"], rec["name"], rec["version"]))
                self.stats["reclaimed"] += 1
        return reclaimed

    def _delete_bytes(self, rec: dict) -> None:
        v, obj, home = rec["version"], rec["object"], rec["home"]
        for nid, name in [(home, obj)] + \
                [(n, f"replica/{home}/{obj}") for n in self.nodes
                 if n != home]:
            try:
                if self.stores[nid].exists(name, v):
                    self.stores[nid].delete(name, v)
            except IOError:
                continue  # dead pool: its bytes died with it
        if self.cache is not None:
            self.cache.drop(cache_key(rec["workflow"], rec["name"], v))

    # ---- lineage ------------------------------------------------------
    def lineage(self, name: str, workflow: str = "default",
                version: Optional[int] = None) -> List[dict]:
        """The transitive derivation chain of a dataset version, root
        inputs last: each entry is the catalog record (which persists
        producing job, workflow, input versions and content digest).
        External inputs appear as ``{"external": <name>}`` markers.
        Works on reclaimed datasets too — records outlive bytes."""
        out: List[dict] = []
        seen: Set[Tuple[str, str, int]] = set()
        queue: List[Tuple[str, str, Optional[int]]] = [
            (name, workflow, version)]
        while queue:
            n, wf, v = queue.pop(0)
            try:
                rec = self.record(n, wf, v)
            except (KeyError, FileNotFoundError):
                continue
            key = (rec["workflow"], rec["name"], rec["version"])
            if key in seen:
                continue
            seen.add(key)
            out.append(rec)
            for ref in rec["lineage"]["inputs"]:
                if ref and ref[0] == EXTERNAL_INPUT:
                    marker = {"external": ref[1]}
                    if marker not in out:
                        out.append(marker)
                elif ref:
                    queue.append((ref[0], ref[1], ref[2]))
        return out
