"""SLM / DLM memory-mode policies (paper §II-B).

PyTorch counterpart of ``repro/core/tiering.py``.

SLM (single-level): DRAM and B-APM are two explicit spaces. ``SLMTier``
places chosen leaves of a tree in pmem and stages them in and out
explicitly (optimizer-state offload, cold KV pages). ``offload`` takes
leaves on the card or the host; ``fetch`` returns the offloaded leaves as
the store reads them (numpy arrays, bf16 as ``torch.bfloat16`` CPU
tensors). The head pointer ``slm/<name>.head.json`` is JAX's, so either
package fetches what the other offloaded.

DLM (dual-level): ``DLMCache`` is an LRU write-back cache keyed by object
name over a node's object store, with a running byte total, an oversized
bypass (an object larger than the whole capacity is written straight
through and served uncached), a ``fallback_reader`` for a dead home pool
(TieredIO wires the buddy-replica read), an ``on_writeback`` hook after
every durable write-back (TieredIO queues the buddy replica and its ack),
``protected`` names that capacity eviction skips (TieredIO wires the
dataset catalog's leased keys), ``admit``/``drop`` for the catalog's
clean entries, ``prefetch`` reading pmem outside the lock, ``evict_cold``
and ``flush``. Entries are host trees (numpy arrays and CPU tensors: a
session's bf16 KV pages stay ``torch.bfloat16``). ``TieredKVCache`` is
the paged KV spill tier over it.
"""
from __future__ import annotations

import collections
import random
import threading
import time
from typing import Any, Callable, Container, Dict, Iterable, List, Optional

from repro_torch.core.object_store import (PMemObjectStore, _flatten,
                                           _leaf_nbytes, _unflatten)
from repro_torch.obs.metrics import registry_of


class SLMTier:
    """Explicit two-space placement: leaves listed in ``pmem_leaves`` live
    in the pool; the rest stay in DRAM (the returned tree).

    Every ``offload`` writes under a fresh per-tier version (threaded
    through the store's version namespace AND stamped in the object
    meta), and ``fetch`` validates both before merging: a racing offload
    from another tier instance over the same store and name is never
    merged silently into this instance's resident tree."""

    def __init__(self, store: PMemObjectStore, name: str):
        self.store = store
        self.name = name
        self._placed: Dict[str, int] = {}  # leaf path -> version tag
        self._version: Optional[int] = None  # store version of last offload
        # superseded-version reclaims that failed (leaked pmem bytes)
        self.cleanup_failures = 0

    def offload(self, tree, leaf_paths: Iterable[str]):
        """Move selected leaves to pmem; returns (resident_tree, handle).
        Offloaded leaves are left out of the resident tree."""
        paths = set(leaf_paths)
        leaves = dict(_flatten(tree))
        off = {p: leaves[p] for p in paths if p in leaves}
        version = random.getrandbits(31) or 1
        # reclaim the version we supersede: ours, or (after a process
        # restart) the one the head points at
        prev = self._version
        if prev is None:
            try:
                prev = self.store.pool.get_json(
                    f"slm/{self.name}.head.json")["v"]
            except (IOError, FileNotFoundError, KeyError):
                prev = None
        self.store.put(f"slm/{self.name}", off, version=version,
                       meta={"v": version})
        # head pointer: offloaded state survives a PROCESS restart
        self.store.pool.put_json(f"slm/{self.name}.head.json",
                                 {"v": version})
        if prev is not None and prev != version:
            try:
                self.store.delete(f"slm/{self.name}", prev)
            except OSError:
                # the new version is committed (the head points at it); a
                # failed reclaim only leaks the old bytes
                self.cleanup_failures += 1
        self._version = version
        resident = {p: v for p, v in leaves.items() if p not in paths}
        self._placed = {p: version for p in off}
        return _unflatten(resident), sorted(off)

    def fetch(self, resident_tree, handle: List[str]):
        """Stage offloaded leaves back in and merge with the resident
        part. Fails loudly if the pmem object is not the one THIS tier
        placed. A fresh instance (after a restart) adopts the persisted
        head pointer's version."""
        name = f"slm/{self.name}"
        if self._version is None:
            try:  # restart recovery: adopt the last committed offload
                self._version = self.store.pool.get_json(
                    f"{name}.head.json")["v"]
            except (IOError, FileNotFoundError, KeyError):
                raise RuntimeError(f"{name}: nothing offloaded")
        try:
            off_tree, man = self.store.get_with_manifest(
                name, version=self._version)
        except FileNotFoundError as e:
            raise IOError(
                f"{name}@v{self._version}: offloaded leaves vanished "
                f"(deleted or overwritten by a racing tier instance)"
            ) from e
        got = man.get("meta", {}).get("v")
        if got != self._version:
            raise IOError(
                f"{name}: version mismatch (placed v{self._version}, "
                f"found v{got}): racing offload from another tier "
                f"instance")
        leaves = dict(_flatten(resident_tree))
        leaves.update(dict(_flatten(off_tree)))
        return _unflatten(leaves)


class DLMCache:
    """LRU DRAM cache over a pmem object store (write-back).

    Occupancy is tracked as a RUNNING byte total (O(1) per admission,
    not O(n) re-sums per eviction), and objects larger than the whole
    capacity BYPASS DRAM: a ``put`` writes them straight through to
    pmem and a ``get`` serves them uncached, so one oversized object can
    never leave the cache permanently over budget. ``fallback_reader``
    (wired by TieredIO) serves misses from a buddy node's replica when
    the home pool is dead — the multi-node DLM read path."""

    def __init__(self, store: PMemObjectStore, capacity_bytes: int,
                 fallback_reader: Optional[Callable[[str], Any]] = None,
                 on_writeback: Optional[Callable[[str], None]] = None,
                 protected: Optional[Callable[[], Container[str]]] = None,
                 obs=None):
        self.store = store
        self.capacity = capacity_bytes
        self.fallback_reader = fallback_reader
        # lease-pinned admission: a callable returning the names that
        # capacity-pressure LRU eviction must skip (TieredIO's
        # attach_catalog wires the catalog's leased keys here).
        # ``evict_cold`` has its own explicit ``keep`` parameter; this
        # guards the implicit evictions ``put``/``get`` perform.
        # When every resident entry is protected the admission proceeds
        # over budget (like the oversized bypass, pressure is visible in
        # ``dlm.used_bytes``) rather than evicting a pinned entry.
        self.protected = protected
        # called with the object name after every durable write-back to
        # pmem (dirty eviction, flush, oversized bypass). TieredIO wires
        # it to queue a buddy replica + ack, so the replica tier tracks
        # every durable write instead of only the first offload — a
        # mutated object's buddy copy must never serve stale bytes after
        # the home pool dies. Must not call back into this cache.
        self.on_writeback = on_writeback
        self._cache: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self._sizes: Dict[str, int] = {}
        self._used = 0  # running sum of _sizes (cache-occupancy bytes)
        self._dirty: Dict[str, bool] = {}
        self._last_used: Dict[str, float] = {}
        self._gen: Dict[str, int] = {}  # bumped on put/evict (TOCTOU)
        self._lock = threading.RLock()
        # registry-backed counters; the legacy int attributes survive as
        # read-through properties so callers/tests keep reading ints
        reg = registry_of(obs)
        self._counters = {k: reg.counter(f"dlm.{k}")
                          for k in ("hits", "misses", "evictions",
                                    "prefetches", "prefetch_hits",
                                    "bypasses")}
        self._g_used = reg.gauge("dlm.used_bytes")

    @property
    def hits(self) -> int:
        return self._counters["hits"].value

    @property
    def misses(self) -> int:
        return self._counters["misses"].value

    @property
    def evictions(self) -> int:
        return self._counters["evictions"].value

    @property
    def prefetches(self) -> int:
        return self._counters["prefetches"].value

    @property
    def prefetch_hits(self) -> int:
        return self._counters["prefetch_hits"].value

    @property
    def bypasses(self) -> int:
        # oversized objects served/persisted uncached
        return self._counters["bypasses"].value

    def _bytes(self, tree) -> int:
        # tensors too (bf16 KV pages, which numpy cannot hold)
        return sum(_leaf_nbytes(a) for _, a in _flatten(tree))

    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    def _evict_one(self, name: str) -> None:
        """Drop ``name`` from DRAM (write-back if dirty). Lock held."""
        tree = self._cache.pop(name)
        if self._dirty.pop(name, False):
            self.store.put(f"dlm/{name}", tree)  # write-back
            if self.on_writeback is not None:
                self.on_writeback(name)
        self._used -= self._sizes.pop(name, 0)
        self._g_used.set(self._used)
        self._last_used.pop(name, None)
        self._gen[name] = self._gen.get(name, 0) + 1
        self._counters["evictions"].inc()

    def _evict_until_fits(self, incoming: int) -> None:
        pinned: Container[str] = ()
        if self.protected is not None:
            pinned = self.protected() or ()
        while self._cache and self._used + incoming > self.capacity:
            victim = next((n for n in self._cache if n not in pinned),
                          None)  # LRU order, pinned entries skipped
            if victim is None:
                return  # everything resident is pinned: admit over budget
            self._evict_one(victim)

    def _drop_stale(self, name: str) -> None:
        """Remove a superseded entry WITHOUT write-back (the caller is
        replacing it); keeps the running total exact. Lock held."""
        if name in self._cache:
            self._cache.pop(name)
            self._used -= self._sizes.pop(name, 0)
            self._g_used.set(self._used)
            self._dirty.pop(name, None)
            self._last_used.pop(name, None)

    def _insert(self, name: str, tree, nb: int, dirty: bool) -> None:
        """Admit ``name`` (lock held); caller has checked nb <= capacity."""
        self._drop_stale(name)
        self._evict_until_fits(nb)
        self._cache[name] = tree
        self._sizes[name] = nb
        self._used += nb
        self._g_used.set(self._used)
        self._dirty[name] = dirty
        self._last_used[name] = time.time()

    def put(self, name: str, tree) -> None:
        with self._lock:
            nb = self._bytes(tree)
            self._gen[name] = self._gen.get(name, 0) + 1
            if nb > self.capacity:
                # oversized: would evict EVERYTHING and still not fit —
                # bypass DRAM, persist straight to pmem (write-back now)
                self._drop_stale(name)
                self.store.put(f"dlm/{name}", tree)
                if self.on_writeback is not None:
                    self.on_writeback(name)
                self._counters["bypasses"].inc()
                return
            self._insert(name, tree, nb, dirty=True)

    def _read_through(self, name: str):
        """Pmem read with buddy-replica fallback when the home store is
        UNREACHABLE. A plain miss on a live pool (FileNotFoundError)
        fails fast — fanning the fabric out for every never-written name
        would multiply miss-path metadata traffic by node count."""
        try:
            return self.store.get(f"dlm/{name}")
        except FileNotFoundError:
            raise
        except IOError:
            if self.fallback_reader is None:
                raise
            return self.fallback_reader(name)

    def get(self, name: str):
        with self._lock:
            if name in self._cache:
                self._counters["hits"].inc()
                self._cache.move_to_end(name)
                self._last_used[name] = time.time()
                return self._cache[name]
            self._counters["misses"].inc()
            tree = self._read_through(name)
            nb = self._bytes(tree)
            if nb > self.capacity:
                self._counters["bypasses"].inc()  # serve uncached
                return tree
            self._insert(name, tree, nb, dirty=False)
            return tree

    def contains(self, name: str) -> bool:
        with self._lock:
            return name in self._cache

    def admit(self, name: str, tree) -> None:
        """Insert a CLEAN entry loaded by an external reader (the dataset
        catalog's read path): cached for reuse and dropped at eviction,
        never written back to ``dlm/``, since the reader owns the
        persistent copy. Oversized trees bypass DRAM."""
        with self._lock:
            nb = self._bytes(tree)
            self._gen[name] = self._gen.get(name, 0) + 1
            if nb > self.capacity:
                self._counters["bypasses"].inc()
                return
            self._insert(name, tree, nb, dirty=False)

    def peek(self, name: str):
        """The cached entry or None — no read-through (the caller owns
        the miss path, e.g. the catalog's home/replica resolution)."""
        with self._lock:
            if name in self._cache:
                self._counters["hits"].inc()
                self._cache.move_to_end(name)
                self._last_used[name] = time.time()
                return self._cache[name]
            self._counters["misses"].inc()
            return None

    def drop(self, name: str) -> None:
        """Forget an entry without write-back (its backing object was
        reclaimed: writing back would resurrect deleted bytes)."""
        with self._lock:
            self._gen[name] = self._gen.get(name, 0) + 1
            self._drop_stale(name)

    def prefetch(self, name: str) -> bool:
        """Warm ``name`` into DRAM without counting toward hit/miss demand
        stats. Returns True when the entry was already resident (a
        prefetch hit). Used by TieredIO to hide pmem->DRAM latency.

        The pmem read happens OUTSIDE the lock — a background warm must
        not stall concurrent demand gets on the serving hot path."""
        with self._lock:
            self._counters["prefetches"].inc()
            if name in self._cache:
                self._counters["prefetch_hits"].inc()
                self._cache.move_to_end(name)
                self._last_used[name] = time.time()  # warm != cold
                return True
            gen = self._gen.get(name, 0)
        tree = self._read_through(name)
        with self._lock:
            # insert only if nobody touched the entry while we read pmem
            # (a concurrent put+evict would make our snapshot stale)
            if name not in self._cache and \
                    self._gen.get(name, 0) == gen:
                nb = self._bytes(tree)
                if nb > self.capacity:
                    self._counters["bypasses"].inc()  # warmed bytes stay in pmem only
                else:
                    self._insert(name, tree, nb, dirty=False)
            return False

    def evict_cold(self, max_idle_s: float = 0.0,
                   now: Optional[float] = None,
                   keep: Container[str] = ()) -> int:
        """Spill entries idle for > ``max_idle_s`` back to pmem and drop
        them from DRAM (write-back for dirty ones). Returns the number of
        entries evicted. ``max_idle_s=0`` evicts everything. Names in
        ``keep`` are never evicted."""
        now = now if now is not None else time.time()
        with self._lock:
            cold = [n for n, ts in self._last_used.items()
                    if now - ts >= max_idle_s and n not in keep]
            for name in cold:
                self._evict_one(name)
            return len(cold)

    def flush(self, name: Optional[str] = None) -> None:
        """Write back dirty entries — all of them, or just ``name`` (so a
        single-object persist doesn't rewrite the whole cache while
        holding the lock)."""
        with self._lock:
            targets = [name] if name is not None else list(self._cache)
            for n in targets:
                if self._dirty.get(n) and n in self._cache:
                    self.store.put(f"dlm/{n}", self._cache[n])
                    self._dirty[n] = False
                    if self.on_writeback is not None:
                        self.on_writeback(n)


class TieredKVCache:
    """Paged KV spill tier for serving: hot pages in DRAM (DLM-cached),
    cold pages in pmem."""

    def __init__(self, store: PMemObjectStore, dram_capacity_bytes: int):
        self.cache = DLMCache(store, dram_capacity_bytes)

    @staticmethod
    def page_name(seq_id: int, layer: int, page: int) -> str:
        return f"kv/{seq_id}/{layer}/{page}"

    def put_page(self, seq_id: int, layer: int, page: int, kv) -> None:
        self.cache.put(self.page_name(seq_id, layer, page), kv)

    def get_page(self, seq_id: int, layer: int, page: int):
        return self.cache.get(self.page_name(seq_id, layer, page))

    def prefetch_page(self, seq_id: int, layer: int, page: int) -> bool:
        return self.cache.prefetch(self.page_name(seq_id, layer, page))

    def evict_cold(self, max_idle_s: float = 0.0) -> int:
        return self.cache.evict_cold(max_idle_s)

    @property
    def stats(self):
        return {"hits": self.cache.hits, "misses": self.cache.misses,
                "evictions": self.cache.evictions,
                "prefetches": self.cache.prefetches,
                "prefetch_hits": self.cache.prefetch_hits,
                "bypasses": self.cache.bypasses}
