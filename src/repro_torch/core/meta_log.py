"""MetaLog: an append-only, replicated, pmem-resident record log.

The metadata plane's storage primitive (ROADMAP item 3). Every ack,
lease, catalog record and journal entry used to be a read-merge-rewrite
of a whole JSON blob replicated to every pool — O(state) bytes per
update, quadratic over a workload's lifetime. The paper's pitch for
byte-addressable persistent memory is exactly the opposite access
pattern: small persistent APPENDS (store + CLWB + SFENCE), not file
rewrites. ``MetaLog`` provides it:

  * **Entries** are fixed-header, length-prefixed, CRC-guarded JSON
    payloads appended via ``PMemRegion`` byte-range writes. Each entry
    carries a monotonically increasing ``seq``. The file header records
    a ``committed_tail``: an append writes entry bytes, flushes, THEN
    advances the tail and flushes again — bytes past the committed tail
    (a torn append) are invisible to replay by construction.
  * **Replication**: each entry is appended to a copy of the log on
    every live pool (same discipline as the old per-record JSON). A pool
    that is down misses entries; replay UNIONS entries by ``seq`` across
    all readable copies, so anything acked on any surviving pool is
    recovered. A pool that rejoins behind is reseeded with a snapshot of
    the current state before the next append lands on it.
  * **Replay** is deterministic: state = newest snapshot (or the
    ``base`` legacy loader for pre-log deployments), then every event
    with ``seq`` greater than the snapshot's, in ``seq`` order, through
    the caller's ``fold(state, event)`` reducer — the same reducer that
    maintains the in-memory head state live, so replay reproduces
    exactly the dict the old cross-pool merge functions returned.
  * **Per-pool read cursors**: the writer remembers (epoch, offset) per
    pool copy and reads only the new tail bytes when syncing — a
    foreign append (another process) is absorbed incrementally, never
    by re-scanning the whole log.
  * **Compaction** folds the prefix into one snapshot entry once the
    tail passes a size/entry threshold. Crash-safe in two phases: the
    snapshot file is written and flushed (acked) on every live pool
    FIRST, and only then atomically renamed over the live log (the
    prefix trim). A crash between the phases leaves the old log intact
    everywhere (the orphan snapshot file is ignored by replay and
    reclaimed by the next compaction); a crash mid-rename leaves each
    pool with either the old or the new log — both replay correctly,
    and the union across pools loses nothing.

This module is a copy of ``repro/core/meta_log.py``, kept so that the
port imports nothing of the JAX package: the bytes it appends are the
JAX package's, so a log written by either package replays in the other
(the checkpoint ack registry, ``ckpt/ackslog``, is read by both).

Concurrency: one writer per log per process (appends serialise on an
internal lock). Cross-process single-writer discipline is the callers'
documented contract (see ``DatasetCatalog``); the seq-union replay keeps
concurrent FOREIGN appends from being lost, but does not order them.
"""
from __future__ import annotations

import copy
import json
import os
import struct
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.metrics import registry_of

#: file header: magic(6) | version(u16) | committed_tail(u64) | epoch(u64)
_HDR = struct.Struct("<6sHQQ")
HDR_SIZE = 64  # header slot is padded: entries start 64-byte aligned
_MAGIC = b"MLOG1\x00"
_VERSION = 1
#: offset of committed_tail inside the header (little-endian u64)
_TAIL_OFF = 8

#: entry header: payload_len(u32) | crc32(u32) | seq(u64) | kind(u8) pad(7)
_ENTRY = struct.Struct("<IIQB7x")

KIND_EVENT = 0
KIND_SNAPSHOT = 1

#: initial region size for a fresh log file (doubles as it grows)
MIN_CAPACITY = 1 << 15


def _pack_entry(seq: int, kind: int, payload: bytes) -> bytes:
    return _ENTRY.pack(len(payload), zlib.crc32(payload), seq,
                       kind) + payload


def _u64le(value: int) -> np.ndarray:
    return np.frombuffer(struct.pack("<Q", value), dtype=np.uint8)


class MetaLog:
    """One replicated append-only log with a folded head state.

    ``fold(state, event)`` is the caller's reducer: it applies one event
    dict to the mutable ``state`` dict, both live (on append) and during
    replay — determinism of the reducer IS the determinism of replay
    (events carry their own ``ts``, stamped once at append time).
    ``base()`` (optional) loads the pre-log legacy state a cold replay
    starts from when no snapshot entry exists yet — the migration hook
    for surfaces that used to live in replicated JSON records.
    """

    def __init__(self, stores, nodes: Sequence[str], name: str, *,
                 fold: Callable[[dict, dict], None],
                 base: Optional[Callable[[], dict]] = None,
                 compact_entries: int = 2048,
                 compact_bytes: int = 1 << 20, obs=None):
        self.stores = stores
        self._obs = obs
        self.nodes = sorted(nodes)
        self.name = name
        self._fold = fold
        self._base = base
        self.compact_entries = compact_entries
        self.compact_bytes = compact_bytes
        self._lock = threading.RLock()
        self._state: Optional[dict] = None
        self._applied = 0        # highest seq folded into _state
        self._next_seq = 1
        self._entries_since_snap = 0
        # nid -> (epoch, committed_tail) as last seen by this writer
        self._cursors: Dict[str, Tuple[int, int]] = {}
        # pools whose log copy holds every entry this writer knows of
        self._synced: set = set()
        self.stats = {"appends": 0, "compactions": 0, "reseeds": 0,
                      "replay_bytes": 0, "snapshot_bytes": 0}
        # append/replay/compaction wall-clock histograms (shared across
        # every MetaLog on the same plane: acks, catalog, journals)
        reg = registry_of(obs)
        self._t_append = reg.histogram("metalog.append_s")
        self._t_replay = reg.histogram("metalog.replay_s")
        self._t_compact = reg.histogram("metalog.compact_s")

    # ---- plumbing -----------------------------------------------------
    def _pool(self, nid: str):
        return self.stores[nid].pool

    def _live(self) -> List[str]:
        live = [n for n in self.nodes
                if getattr(self._pool(n), "alive", True)]
        return live or self.nodes

    # ---- per-pool file access ----------------------------------------
    def _read_header(self, region) -> Tuple[int, int]:
        raw = bytes(region.read(0, _HDR.size))
        magic, version, tail, epoch = _HDR.unpack(raw)
        if magic != _MAGIC or version != _VERSION:
            raise IOError(f"{self.name}: bad log header")
        return tail, epoch

    def _read_entries(self, region, start: int, tail: int,
                      skip_snap_upto: int = -1
                      ) -> Tuple[List[Tuple[int, int, Optional[dict]]],
                                 int]:
        """Parse entries in [start, tail): (seq, kind, payload) triples
        plus the bytes actually read. Stops at the first corrupt entry —
        everything before the committed tail was flushed before the tail
        advanced, so corruption here means media damage, not a torn
        append; salvage the readable prefix.

        A snapshot entry's header ``seq`` equals its ``upto``, so a
        snapshot already dominated by a better copy (``seq <=
        skip_snap_upto``) is skipped WITHOUT reading its payload — the
        replay of N replicated copies costs one snapshot body plus N
        sets of headers, not N bodies. Skipped snapshots surface as
        ``(seq, KIND_SNAPSHOT, None)`` placeholders (cursor accounting
        still needs their position)."""
        out: List[Tuple[int, int, Optional[dict]]] = []
        nread = 0
        off = start
        while off + _ENTRY.size <= tail:
            ln, crc, seq, kind = _ENTRY.unpack(
                bytes(region.read(off, _ENTRY.size)))
            nread += _ENTRY.size
            end = off + _ENTRY.size + ln
            if end > tail:
                break
            if kind == KIND_SNAPSHOT and seq <= skip_snap_upto:
                out.append((seq, kind, None))
                off = end
                continue
            payload = bytes(region.read(off + _ENTRY.size, ln))
            nread += ln
            if zlib.crc32(payload) != crc:
                break
            try:
                out.append((seq, kind, json.loads(payload)))
            except ValueError:
                break
            off = end
        return out, nread

    def _write_fresh(self, nid: str, name: str,
                     blobs: Sequence[bytes]) -> Tuple[int, int]:
        """Create/overwrite region ``name`` on ``nid`` holding exactly
        ``blobs`` as its committed entries. Returns (epoch, tail)."""
        pool = self._pool(nid)
        body = b"".join(blobs)
        tail = HDR_SIZE + len(body)
        cap = MIN_CAPACITY
        while cap < tail:
            cap *= 2
        if pool.exists(name):
            pool.delete(name)
        region = pool.create(name, cap)
        epoch = int.from_bytes(os.urandom(8), "little")
        hdr = _HDR.pack(_MAGIC, _VERSION, HDR_SIZE, epoch)
        region.write(0, np.frombuffer(hdr.ljust(HDR_SIZE, b"\x00"),
                                      dtype=np.uint8))
        if body:
            region.write(HDR_SIZE, np.frombuffer(body, dtype=np.uint8))
        region.flush()
        # commit: advance the tail only after the entry bytes are durable
        region.write(_TAIL_OFF, _u64le(tail))
        region.flush()
        return epoch, tail

    def _append_pool(self, nid: str, blob: bytes) -> None:
        pool = self._pool(nid)
        epoch, tail = self._cursors[nid]
        new_tail = tail + len(blob)
        region = pool.open(self.name)
        if new_tail > region.nbytes:
            cap = max(region.nbytes, MIN_CAPACITY)
            while cap < new_tail:
                cap *= 2
            region = pool.extend(self.name, cap)
        # B-APM append discipline: entry bytes -> flush -> tail -> flush.
        # Torn writes land past the committed tail and never replay.
        region.write(tail, np.frombuffer(blob, dtype=np.uint8))
        region.flush()
        region.write(_TAIL_OFF, _u64le(new_tail))
        region.flush()
        self._cursors[nid] = (epoch, new_tail)

    def _snapshot_blob(self) -> bytes:
        payload = json.dumps({"state": self._state, "upto": self._applied},
                             separators=(",", ":")).encode()
        return _pack_entry(self._applied, KIND_SNAPSHOT, payload)

    def _reseed(self, nid: str) -> None:
        """Bring a behind/rejoined pool up to date: rewrite its log copy
        as one snapshot of the current state (everything it missed,
        folded). Atomic swap via the compaction rename path."""
        self._ensure_open()
        tmp = self.name + ".reseed"
        epoch, tail = self._write_fresh(nid, tmp, [self._snapshot_blob()])
        self._pool(nid).rename(tmp, self.name)
        self._cursors[nid] = (epoch, tail)
        self._synced.add(nid)
        self.stats["reseeds"] += 1

    # ---- replay -------------------------------------------------------
    def _scan_pool(self, nid: str, skip_snap_upto: int = -1
                   ) -> Tuple[List[Tuple[int, int, Optional[dict]]],
                              Optional[int], int]:
        """All committed entries of one pool copy + (epoch, tail).
        ``epoch is None`` means the pool has no log file at all."""
        pool = self._pool(nid)
        if not pool.exists(self.name):
            return [], None, 0
        region = pool.open(self.name)
        tail, epoch = self._read_header(region)
        entries, nread = self._read_entries(region, HDR_SIZE, tail,
                                            skip_snap_upto)
        self.stats["replay_bytes"] += HDR_SIZE + nread
        return entries, epoch, tail

    def _cold_read(self) -> None:
        """Replay from pool copies: newest snapshot (else legacy base),
        then the seq-union of newer events in order. Copies are scanned
        longest-first so shorter replicas' identical snapshots are
        skipped by header alone."""
        t0 = time.time()
        self.stats["replay_bytes"] = 0
        best_snap: Optional[dict] = None
        events: Dict[int, dict] = {}
        per_pool: Dict[str, Tuple[int, List[int]]] = {}

        def tail_of(nid: str) -> int:
            try:
                pool = self._pool(nid)
                if not pool.exists(self.name):
                    return -1
                return self._read_header(pool.open(self.name))[0]
            except (IOError, OSError):
                return -1

        for nid in sorted(self.nodes, key=tail_of, reverse=True):
            seen = best_snap["upto"] if best_snap is not None else -1
            try:
                entries, epoch, tail = self._scan_pool(nid, seen)
            except (IOError, OSError):
                continue
            if epoch is None:
                continue  # no file yet: reseeded before its first append
            self._cursors[nid] = (epoch, tail)
            snap_upto, seqs = 0, []
            for seq, kind, payload in entries:
                if kind == KIND_SNAPSHOT:
                    upto = seq if payload is None \
                        else payload.get("upto", 0)
                    snap_upto = max(snap_upto, upto)
                    if payload is not None and (
                            best_snap is None
                            or upto > best_snap["upto"]):
                        best_snap = payload
                else:
                    seqs.append(seq)
                    events.setdefault(seq, payload)
            per_pool[nid] = (snap_upto, seqs)
        if best_snap is not None:
            state = copy.deepcopy(best_snap["state"])
            applied = best_snap["upto"]
        else:
            state = copy.deepcopy(self._base()) if self._base else {}
            applied = 0
        for seq in sorted(events):
            if seq <= applied:
                continue
            self._fold(state, events[seq])
            applied = seq
        snap_floor = best_snap["upto"] if best_snap is not None else 0
        self._state = state
        self._applied = applied
        self._next_seq = applied + 1
        self._entries_since_snap = sum(1 for s in events if s > snap_floor)
        # a pool is synced iff its own copy covers every applied seq
        # contiguously from its snapshot — anything less must be
        # reseeded before the next append lands on it
        self._synced = set()
        for nid, (snap_upto, seqs) in per_pool.items():
            covered = snap_upto
            for seq in sorted(set(seqs)):
                if seq == covered + 1:
                    covered = seq
                elif seq > covered + 1:
                    break
            if covered == applied:
                self._synced.add(nid)
        self._t_replay.observe(time.time() - t0)

    def _ensure_open(self) -> None:
        if self._state is None:
            self._cold_read()

    def _sync_foreign(self) -> None:
        """Absorb entries appended by another process since our cursors
        (per-pool cursor reads — only NEW tail bytes are parsed)."""
        for nid in self._live():
            cur = self._cursors.get(nid)
            try:
                pool = self._pool(nid)
                if not pool.exists(self.name):
                    continue
                region = pool.open(self.name)
                tail, epoch = self._read_header(region)
                if cur is not None and epoch == cur[0]:
                    if tail <= cur[1]:
                        continue
                    fresh, _n = self._read_entries(region, cur[1], tail,
                                                   self._applied)
                else:
                    # epoch changed (foreign compaction/reseed replaced
                    # the file): re-read this copy wholesale
                    fresh, _n = self._read_entries(region, HDR_SIZE,
                                                   tail, self._applied)
            except (IOError, OSError):
                continue
            for seq, kind, payload in fresh:
                if kind == KIND_SNAPSHOT:
                    if payload is not None and \
                            payload.get("upto", 0) > self._applied:
                        self._state = copy.deepcopy(payload["state"])
                        self._applied = payload["upto"]
                elif seq > self._applied:
                    self._fold(self._state, payload)
                    self._applied = seq
            self._cursors[nid] = (epoch, tail)
            self._next_seq = max(self._next_seq, self._applied + 1)

    # ---- public API ---------------------------------------------------
    def state(self) -> dict:
        """The folded head state (callers treat it as read-only)."""
        with self._lock:
            self._ensure_open()
            return self._state

    def append(self, event: dict) -> int:
        """Durably append one event to every live pool copy and fold it
        into the head state. Returns the entry's seq. Raises IOError
        when no pool accepted the entry (nothing was persisted)."""
        t0 = time.time()
        with self._lock:
            self._ensure_open()
            self._sync_foreign()
            if "ts" not in event:
                event = {**event, "ts": time.time()}
            seq = self._next_seq
            blob = _pack_entry(seq, KIND_EVENT, json.dumps(
                event, separators=(",", ":")).encode())
            wrote = 0
            live = self._live()
            for nid in self.nodes:
                if nid not in live:
                    # a dead pool misses this entry: it must be reseeded
                    # (snapshot of the full state) if it ever rejoins
                    self._synced.discard(nid)
            for nid in live:
                try:
                    if nid not in self._synced:
                        self._reseed(nid)
                    self._append_pool(nid, blob)
                    wrote += 1
                except (IOError, OSError, AttributeError):
                    self._synced.discard(nid)
            if not wrote:
                raise IOError(f"no reachable pool for meta log "
                              f"{self.name}")
            self._next_seq = seq + 1
            self._fold(self._state, event)
            self._applied = seq
            self._entries_since_snap += 1
            self.stats["appends"] += 1
            if self._entries_since_snap >= self.compact_entries or \
                    self._tail_bytes() >= self.compact_bytes:
                self.compact()
            self._t_append.observe(time.time() - t0)
            return seq

    def _tail_bytes(self) -> int:
        return max((t for _e, t in self._cursors.values()), default=0)

    def compact(self, *, _crash_after_snapshot: bool = False) -> None:
        """Fold the whole prefix into one snapshot entry. Two phases:

        1. the snapshot file is written + flushed on every live pool
           (the durable ack — at this point the folded state survives
           any crash alongside the still-intact log);
        2. the snapshot file is atomically renamed over the live log on
           each pool (the prefix trim).

        ``_crash_after_snapshot`` stops between the phases (tests only:
        simulates the worst-case crash window)."""
        t0 = time.time()
        with self._lock:
            self._ensure_open()
            blob = self._snapshot_blob()
            tmp = self.name + ".cnew"
            seeded: Dict[str, Tuple[int, int]] = {}
            live = self._live()
            for nid in self.nodes:
                if nid not in live:
                    self._synced.discard(nid)
            for nid in live:
                try:
                    seeded[nid] = self._write_fresh(nid, tmp, [blob])
                except (IOError, OSError):
                    continue
            if not seeded:
                raise IOError(f"no reachable pool to compact "
                              f"{self.name}")
            self.stats["snapshot_bytes"] = HDR_SIZE + len(blob)
            if _crash_after_snapshot:
                return
            for nid, cursor in seeded.items():
                try:
                    self._pool(nid).rename(tmp, self.name)
                except (IOError, OSError):
                    self._synced.discard(nid)
                    continue
                self._cursors[nid] = cursor
                self._synced.add(nid)
            self._entries_since_snap = 0
            self.stats["compactions"] += 1
            self._t_compact.observe(time.time() - t0)

    def replay(self) -> dict:
        """A FRESH deterministic replay from the pool copies (ignoring
        the in-memory head state) — the recovery-scan path. Returns the
        replayed state; ``stats['replay_bytes']`` records the bytes
        read (the bench asserts compaction keeps this bounded)."""
        other = MetaLog(self.stores, self.nodes, self.name,
                        fold=self._fold, base=self._base, obs=self._obs)
        replayed = other.state()
        with self._lock:
            # stats writes elsewhere hold the append lock; a replay
            # racing a foreground append must not tear the dict
            self.stats["replay_bytes"] = other.stats["replay_bytes"]
        return replayed
