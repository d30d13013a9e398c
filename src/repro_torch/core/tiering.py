"""DLM memory mode (paper §II-B): DRAM as a transparent write-back cache
over pmem.

PyTorch counterpart of the ``DLMCache`` of ``repro/core/tiering.py``: an
LRU cache keyed by object name over a node's object store, with a running
byte total, an oversized bypass (an object larger than the whole capacity
is written straight through and served uncached), a ``fallback_reader``
for a dead home pool (TieredIO wires the buddy-replica read), an
``on_writeback`` hook after every durable write-back (TieredIO queues the
buddy replica and its ack), ``protected`` names that capacity eviction
skips, ``prefetch`` reading pmem outside the lock, ``evict_cold`` and
``flush``. Entries are host trees (numpy arrays and CPU tensors: a
session's bf16 KV pages stay ``torch.bfloat16``). The SLM tier
(``SLMTier``) and the paged ``TieredKVCache`` are not on the serve path
and wait for ROADMAP Queue A item 2(a)'s remainder.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Container, Dict, Optional

from repro_torch.core.object_store import (PMemObjectStore, _flatten,
                                           _leaf_nbytes)
from repro_torch.obs.metrics import registry_of


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
        # capacity-pressure LRU eviction must skip (JAX's TieredIO wires
        # the dataset catalog's leased keys here, item 2(c)).
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

    def peek(self, name: str):
        """The cached entry or None — no read-through (the caller owns
        the miss path)."""
        with self._lock:
            if name in self._cache:
                self._counters["hits"].inc()
                self._cache.move_to_end(name)
                self._last_used[name] = time.time()
                return self._cache[name]
            self._counters["misses"].inc()
            return None

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
