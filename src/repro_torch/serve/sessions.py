"""Multi-tenant serve tier: sessions as leased exchange Datasets.

PyTorch counterpart of ``repro/serve/sessions.py``, with its dataset
names (``sess/<name>``, ``prefix/<name>``, workflow ``serve``), record
annotations and lineage, so a session spilled by either package is
adopted and resumed by the other. Every session's state and every
shared prefix cache is a *leased, versioned Dataset* in the exchange
catalog:

  * ``spill`` publishes the engine's exported state (a host copy) as
    version N+1 of dataset ``sess/<name>``: bytes to a home pool chosen
    by stable hash, record + content digest replicated, buddy replica
    acked through the ExchangeChannel. Lineage records the producing
    engine's ``label``, the previous version and the base prefix;
  * the manager holds a **lease** on the latest version of every live
    session, so ``catalog.gc`` never reclaims one out from under the
    fleet, and the DLM cache's lease-pinned admission keeps hot sessions
    DRAM-resident. Superseded versions are unretained and released at
    spill time;
  * eviction of cold sessions is *lease release* (``evict_cold``), not
    byte deletion: the bytes stay durable until ``end()`` unretains them;
  * ``resume`` re-acquires the lease BEFORE reading, then reads DLM ->
    home pmem -> acked replica and installs the state on the engine's
    device. A session published by another process (or package) is
    adopted from its catalog record alone;
  * shared prefix caches are datasets (``prefix/<name>``) a fleet forks
    sessions from;
  * the decision functions (``recoverable_sessions``,
    ``choose_evictions``, ``discover``) are ``@metadata_only``: they
    answer from catalog records and the in-DRAM session table, with zero
    object-store probes.

Instruments (``serve.sessions_active``, ``serve.resume_ms``,
``serve.spill_to_ack_s``, ``serve.spills``/``resumes``/``evictions``/
``adoptions``) live in ``registry``: the telemetry plane's when one is
given (``obs``), else a private one. With a plane every session lifetime
is ONE trace-span tree (a ``serve.session`` root with ``serve.spill`` and
``serve.resume`` children, ``serve.spill_ack`` and ``serve.evict``
points); the root's trace id is persisted in the record's ``trace``
annotation (0 without a plane), so an adopter in another process, or in
the JAX package, continues the same trace.

Repair needs no scan code of its own: session spills are ordinary
catalog records, so ``RepairChannel``'s dataset scan re-buddies them
after a node loss.
"""
from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.annotations import metadata_only
from repro_torch.core.dataset_exchange import (DEFAULT_LEASE_TTL_S,
                                               DatasetCatalog, Lease,
                                               live_pools)
from repro_torch.obs.metrics import registry_of

WORKFLOW = "serve"


def session_dataset(name: str) -> str:
    """Catalog dataset name for a session's spilled state."""
    return f"sess/{name}"


def prefix_dataset(name: str) -> str:
    """Catalog dataset name for a shared prefix/KV cache."""
    return f"prefix/{name}"


@dataclass
class _Session:
    """In-process view of one session's lifecycle state. The durable
    truth lives in the catalog record; this row caches the latest
    version, the lease the manager holds on it, and the engine binding."""
    name: str
    version: int = 0            # latest published version (0 = none yet)
    lease: Optional[Lease] = None
    engine: object = None       # bound ServeEngine while being served
    prefix: Optional[list] = None   # lineage ref of the base prefix ds
    span: object = None         # root span of the lifetime trace tree
    last_used: float = field(default_factory=time.time)
    spilling: object = None     # in-flight async publish future
    # host copy parked by a FAILED async suspend — the session state
    # would otherwise be lost with the engine DRAM already released
    pending_state: Optional[dict] = None


class SessionManager:
    """Checks sessions in and out of a fleet of ServeEngines, with the
    exchange catalog as the durable source of truth (see module doc)."""

    def __init__(self, tiered, catalog: DatasetCatalog, *,
                 workflow: str = WORKFLOW, owner: str = "serve",
                 lease_ttl_s: float = DEFAULT_LEASE_TTL_S, obs=None):
        self.tiered = tiered
        self.catalog = catalog
        self.workflow = workflow
        self.owner = owner
        self.lease_ttl_s = float(lease_ttl_s)
        self.obs = obs
        reg = self.registry = registry_of(obs)
        self._g_active = reg.gauge("serve.sessions_active")
        self._h_resume_ms = reg.histogram("serve.resume_ms")
        self._h_spill_to_ack = reg.histogram("serve.spill_to_ack_s")
        self._c_spills = reg.counter("serve.spills")
        self._c_resumes = reg.counter("serve.resumes")
        self._c_evictions = reg.counter("serve.evictions")
        self._c_adoptions = reg.counter("serve.adoptions")
        self._lock = threading.Lock()
        self._sessions: Dict[str, _Session] = {}

    # ---- telemetry helpers -------------------------------------------
    def _begin(self, name: str, sess: Optional[_Session] = None, **attrs):
        if self.obs is None:
            return None
        if sess is not None and sess.span is not None:
            return self.obs.begin(name, trace=sess.span.trace,
                                  parent=sess.span.span, **attrs)
        return self.obs.begin(name, **attrs)

    def _end(self, span, **attrs) -> None:
        if self.obs is not None and span is not None:
            self.obs.end(span, **attrs)

    # ---- placement ---------------------------------------------------
    def _home_for(self, key: str) -> str:
        """Stable-hash home placement: sessions spread across live pools
        instead of all landing on the catalog's default (first live)."""
        live = live_pools(self.catalog.stores, self.catalog.nodes)
        return live[zlib.crc32(key.encode()) % len(live)]

    # ---- session table -----------------------------------------------
    def _get(self, name: str) -> _Session:
        with self._lock:
            sess = self._sessions.get(name)
        if sess is None:
            raise KeyError(f"unknown session {name!r} "
                           f"(start/resume it first)")
        return sess

    def sessions(self) -> List[str]:
        with self._lock:
            return sorted(self._sessions)

    def active_sessions(self) -> List[str]:
        """Sessions currently bound to an engine (being served)."""
        with self._lock:
            return sorted(n for n, s in self._sessions.items()
                          if s.engine is not None)

    @metadata_only
    def discover(self) -> List[str]:
        """Session names known to the CATALOG (any process's spills) —
        the cross-process view a fresh fleet member resumes from. Pure
        record scan; latest-version bytes may or may not survive (ask
        ``recoverable_sessions``)."""
        tag = f"{session_dataset('')}"
        names = {rec["name"][len(tag):]
                 for rec in self.catalog.records(self.workflow)
                 if rec["name"].startswith(tag)}
        return sorted(names)

    # ---- prefix datasets (fleet-shared warm caches) ------------------
    def publish_prefix(self, name: str, source, *,
                       producer: Optional[str] = None) -> dict:
        """Publish a shared prefix/KV cache as dataset ``prefix/<name>``
        the whole fleet forks sessions from. ``source`` is an engine
        (its state is exported, DRAM kept) or a raw state tree."""
        state = source.export_state() if hasattr(source, "export_state") \
            else source
        ds = prefix_dataset(name)
        return self.catalog.publish(
            ds, state, workflow=self.workflow,
            producer=producer or getattr(source, "label", self.owner),
            node=self._home_for(ds), retained=True,
            annotations={"prefix": name})

    # ---- lifecycle ---------------------------------------------------
    def start(self, name: str, engine, *,
              prefix: Optional[str] = None) -> _Session:
        """Begin serving a NEW session on ``engine``, optionally seeding
        it from shared prefix dataset ``prefix/<prefix>`` (read under a
        short-lived lease so gc cannot reclaim it mid-read; the fork is
        recorded in the session's lineage)."""
        with self._lock:
            if name in self._sessions:
                raise KeyError(f"session {name!r} already exists "
                               f"(resume it instead)")
        sess = _Session(name=name)
        sess.span = self._begin("serve.session", session=name)
        if prefix is not None:
            ds = prefix_dataset(prefix)
            lease = self.catalog.acquire(ds, workflow=self.workflow,
                                         owner=self.owner,
                                         ttl_s=self.lease_ttl_s)
            try:
                state = self.catalog.get(ds, self.workflow, lease.version)
                engine.install_state(state)
                sess.prefix = [ds, self.workflow, lease.version]
            finally:
                self.catalog.release(lease)
        with self._lock:
            self._sessions[name] = sess
            sess.engine = engine
            sess.last_used = time.time()
        self._g_active.inc()
        return sess

    def _publish_spill(self, name: str, state: dict,
                       t_submit: float) -> dict:
        """Publish one spill as the session dataset's next version and
        hand the manager's lease old -> new. Runs synchronously or on
        the TieredIO I/O thread (async suspend); either way the lease
        handoff happens only AFTER the home-pmem write is durable."""
        sess = self._get(name)
        ds = session_dataset(name)
        with self._lock:
            prev_v = sess.version
            prefix = sess.prefix
            trace = sess.span.trace if sess.span is not None else 0
            producer = getattr(sess.engine, "label", None) or self.owner
        inputs = []
        if prev_v:
            inputs.append([ds, self.workflow, prev_v])
        if prefix:
            inputs.append(list(prefix))
        probe = self._ack_probe(name, t_submit)
        rec = self.catalog.publish(
            ds, state, workflow=self.workflow, producer=producer,
            inputs=inputs, node=self._home_for(ds), retained=True,
            annotations={"session": name, "trace": trace},
            on_replica=probe)
        new_lease = self.catalog.acquire(
            ds, workflow=self.workflow, version=rec["version"],
            owner=self.owner, ttl_s=self.lease_ttl_s)
        with self._lock:
            old_lease, sess.lease = sess.lease, new_lease
            sess.version = rec["version"]
            sess.spilling = None
            sess.pending_state = None
            sess.last_used = time.time()
        if old_lease is not None:
            self.catalog.release(old_lease)
        if prev_v:
            # the superseded spill is dead weight: unretain it so the
            # next gc sweep reclaims its bytes (the record survives —
            # lineage chains through it)
            self.catalog.unretain(ds, self.workflow, prev_v)
        self._c_spills.inc()
        return rec

    def _ack_probe(self, name: str, t_submit: float):
        """Called from the replicate worker after the buddy ack is in
        the record: the spill-to-ack latency the SLA cares about (a
        session is loss-of-one-node durable only past this point)."""
        def probe() -> None:
            self._h_spill_to_ack.observe(time.time() - t_submit)
            if self.obs is not None:
                self.obs.event("serve.spill_ack", session=name)
        return probe

    def spill(self, name: str, *, wait: bool = True):
        """Durable snapshot of a BOUND session (engine keeps serving
        from DRAM). Returns the catalog record, or the publish future
        when ``wait=False``."""
        return self._spill(name, release=False, wait=wait)

    def suspend(self, name: str, *, wait: bool = True):
        """Spill + unbind: the engine's DRAM copy is released and the
        engine freed for another session. With ``wait=False`` the
        publish rides the TieredIO I/O thread; a FAILED async publish
        parks the host copy in the session row (``pending_state``) so
        the state is never lost — the next ``resume`` installs it
        straight from DRAM and the next successful spill clears it."""
        return self._spill(name, release=True, wait=wait)

    def _spill(self, name: str, *, release: bool, wait: bool):
        sess = self._get(name)
        with self._lock:
            engine = sess.engine
            if engine is None:
                raise KeyError(f"session {name!r} is not bound to an "
                               f"engine (nothing to spill)")
            if sess.spilling is not None:
                raise RuntimeError(f"session {name!r} already has a "
                                   f"spill in flight")
        state = engine.export_state(release=release)
        if release:
            with self._lock:
                sess.engine = None
            self._g_active.dec()
        sp = self._begin("serve.spill", sess, session=name,
                         release=release)
        t0 = time.time()
        if wait or self.tiered is None:
            try:
                rec = self._publish_spill(name, state, t0)
            except Exception:
                with self._lock:
                    sess.pending_state = state
                self._end(sp, status="error")
                raise
            self._end(sp, version=rec["version"])
            return rec
        fut = self.tiered.run_async(
            lambda: self._publish_spill(name, state, t0))
        with self._lock:
            sess.spilling = fut

        def _done(f) -> None:
            if f.exception() is not None:
                with self._lock:
                    sess.pending_state = state
                    sess.spilling = None
                self._end(sp, status="error")
            else:
                self._end(sp, version=f.result()["version"])
        fut.add_done_callback(_done)
        return fut

    def resume(self, name: str, engine) -> None:
        """Install a session's state into ``engine`` and bind it. The
        lease is (re)acquired BEFORE the read — acquire's under-lock
        reclaimed check makes resume race-free against ``catalog.gc``.
        Read path: parked failed-spill DRAM copy, else DLM cache ->
        home pmem -> acked replica (the home node may be dead). A
        session this process has never seen is adopted from its catalog
        record, including the persisted trace id, so the lifetime span
        tree continues across processes."""
        t0 = time.perf_counter()
        sess = self._adopt(name)
        sp = self._begin("serve.resume", sess, session=name)
        with self._lock:
            if sess.engine is not None:
                raise RuntimeError(f"session {name!r} already bound")
            parked = sess.pending_state
        try:
            if parked is not None:
                state = parked  # failed spill never left DRAM
            else:
                self._ensure_lease(sess)
                state = self.catalog.get(session_dataset(name),
                                         self.workflow, sess.version)
            engine.install_state(state)
        except Exception:
            self._end(sp, status="error")
            raise
        with self._lock:
            sess.engine = engine
            sess.last_used = time.time()
        self._g_active.inc()
        self._c_resumes.inc()
        self._h_resume_ms.observe((time.perf_counter() - t0) * 1e3)
        self._end(sp, parked=parked is not None)

    def _adopt(self, name: str) -> _Session:
        """The session row, adopting catalog-only sessions published by
        another process (record -> latest version + persisted trace id)."""
        with self._lock:
            sess = self._sessions.get(name)
        if sess is not None:
            return sess
        rec = self.catalog.record(session_dataset(name), self.workflow)
        trace = (rec.get("annotations") or {}).get("trace") or None
        sess = _Session(name=name, version=rec["version"])
        if self.obs is not None:
            sess.span = self.obs.begin("serve.session", trace=trace,
                                       session=name, adopted=True)
        with self._lock:
            # two racing adopters: first one in wins, keep its row
            sess = self._sessions.setdefault(name, sess)
        self._c_adoptions.inc()
        return sess

    def _ensure_lease(self, sess: _Session) -> None:
        """Hold a live lease on the session's latest version (acquire
        before read; gc can then never reclaim it mid-resume)."""
        with self._lock:
            lease = sess.lease
        if lease is not None and not lease.expired():
            return
        new = self.catalog.acquire(session_dataset(sess.name),
                                   workflow=self.workflow,
                                   owner=self.owner,
                                   ttl_s=self.lease_ttl_s)
        with self._lock:
            sess.lease = new
            sess.version = new.version

    # ---- eviction (lease release, not byte deletion) -----------------
    @metadata_only
    def choose_evictions(self, max_idle_s: float,
                         now: Optional[float] = None) -> List[str]:
        """Cold-session eviction policy, decided purely from the in-DRAM
        session table: idle past the threshold, NOT bound to an engine,
        no spill in flight, and actually holding a lease to release. A
        live (bound or leased-and-busy) session is never chosen."""
        now = now if now is not None else time.time()
        with self._lock:
            return sorted(
                n for n, s in self._sessions.items()
                if s.engine is None and s.spilling is None
                and s.lease is not None and s.pending_state is None
                and now - s.last_used >= max_idle_s)

    def evict(self, name: str) -> None:
        """Evict ONE cold session by releasing the manager's lease: the
        DLM cache stops pinning it (capacity pressure may now drop the
        DRAM copy) — the pmem bytes stay durable until ``end()``."""
        sess = self._get(name)
        with self._lock:
            if sess.engine is not None or sess.spilling is not None:
                raise RuntimeError(f"session {name!r} is live — "
                                   f"refusing to evict")
            lease, sess.lease = sess.lease, None
        if lease is not None:
            self.catalog.release(lease)
        self._c_evictions.inc()
        if self.obs is not None:
            self.obs.event("serve.evict", session=name)

    def evict_cold(self, max_idle_s: float = 0.0) -> List[str]:
        """Release leases of every cold session (``choose_evictions``
        policy), then let TieredIO flush now-unpinned DLM entries. This
        REPLACES the old ad-hoc ``evict_cold`` spill loop for
        catalog-registered sessions: eviction is a metadata operation
        (lease release); the bytes were already durable at spill time."""
        victims = self.choose_evictions(max_idle_s)
        for name in victims:
            self.evict(name)
        if victims and self.tiered is not None:
            self.tiered.evict_cold(max_idle_s)
        return victims

    def end(self, name: str) -> None:
        """Terminate a session: release the lease, unretain EVERY
        version (the next gc sweep reclaims all its bytes) and close the
        lifetime span. The catalog records survive: lineage outlives the
        session."""
        sess = self._get(name)
        with self._lock:
            if sess.spilling is not None:
                raise RuntimeError(f"session {name!r} has a spill in "
                                   f"flight — join it before end()")
            engine = sess.engine
            lease, sess.lease = sess.lease, None
            sess.engine = None
        if engine is not None:
            engine.cache = None
            self._g_active.dec()
        if lease is not None:
            self.catalog.release(lease)
        ds = session_dataset(name)
        for v in self.catalog.versions(ds, self.workflow):
            try:
                self.catalog.unretain(ds, self.workflow, v)
            except (KeyError, IOError, FileNotFoundError):
                continue  # already reclaimed / record unreachable
        with self._lock:
            self._sessions.pop(name, None)
        self._end(sess.span, status="ok", versions=sess.version)

    # ---- inspection / recovery ---------------------------------------
    def peek(self, name: str, leaf: str):
        """Byte-range read of ONE leaf of a session's latest spill (a
        single KV page, the ``pos`` cursor) via the catalog: home pool
        first, then ACKED replica holders — never a blind fan-out, and
        nothing admitted into the DLM cache."""
        with self._lock:
            sess = self._sessions.get(name)
            version = sess.version if sess is not None and sess.version \
                else None
        return self.catalog.get_leaf(session_dataset(name), leaf,
                                     self.workflow, version)

    @metadata_only
    def recoverable_sessions(self,
                             lost_nodes: Sequence[str] = ()) -> List[str]:
        """Which catalog-known sessions would survive losing
        ``lost_nodes``? Decided from catalog records alone (placement +
        replica acks) — ZERO object-store probes, mirroring
        ``restore_latest_recoverable``. Sessions whose failed spill is
        parked in this process's DRAM count as recoverable too."""
        tag = session_dataset("")
        latest: Dict[str, int] = {}
        for rec in self.catalog.records(self.workflow):
            if not rec["name"].startswith(tag):
                continue
            nm = rec["name"][len(tag):]
            if rec["version"] > latest.get(nm, 0):
                latest[nm] = rec["version"]
        out = {nm for nm, v in latest.items()
               if self.catalog.recoverable(session_dataset(nm),
                                           self.workflow, v, lost_nodes)}
        with self._lock:
            out.update(n for n, s in self._sessions.items()
                       if s.pending_state is not None
                       or s.engine is not None)
        return sorted(out)

    def repair(self, lost_nodes) -> dict:
        """Re-buddy session/prefix datasets after a node loss. Session
        spills are ordinary catalog records, so the existing
        RepairChannel dataset scan covers them with zero new code; when
        the continuous RepairDaemon runs, its (rate-budgeted) sweep is
        joined instead of double-scanning."""
        if self.tiered is None:
            raise RuntimeError("repair needs a TieredIO engine")
        daemon = self.tiered.repair_daemon
        if daemon is not None and daemon.running:
            daemon.wait_for(lost_nodes, timeout=60.0)
        if daemon is not None and daemon.covers(lost_nodes):
            return daemon.report()
        return self.tiered.repair(lost_nodes)

    def join(self, timeout: Optional[float] = None) -> None:
        """Block until every in-flight async spill is durable (bench /
        shutdown barrier)."""
        with self._lock:
            futs = [s.spilling for s in self._sessions.values()
                    if s.spilling is not None]
        for f in futs:
            try:
                f.result(timeout)
            except Exception:
                pass  # parked in pending_state by the done-callback
