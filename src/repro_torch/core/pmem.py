"""Byte-addressable persistent memory emulation (PMDK-style pools).

The paper's B-APM hardware is exposed to applications exactly the way PMDK
does it: named pools are mmap'd into the address space and accessed by
byte-granular loads/stores, with explicit flush (CLWB) + fence (SFENCE) for
persistence ordering. A pool region is an ``np.memmap`` over a file in the
node's pmem directory — the same mmap mechanism PMDK uses — and
``flush()`` is ``mmap.flush`` (msync). On a host with real B-APM the
identical API fronts /dev/dax or an NVMe-backed mount.

One ``PMemPool`` == one node's B-APM. This module is a copy of
``repro/core/pmem.py`` (numpy only), kept so that the port imports nothing
of the JAX package; pools written by either package read in the other.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
import warnings
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np


def scratch_root(prefix: str = "repro_pmem_") -> Path:
    """A fresh scratch directory for pmem-pool emulation, preferring
    DRAM-backed tmpfs (/dev/shm). B-APM latencies sit next to DRAM's;
    on a container whose default tmp lives on a slow 9p/overlay disk,
    per-commit fsyncs would otherwise cost ~10ms each and dominate any
    benchmark of the pmem data plane."""
    base = Path("/dev/shm")
    if base.is_dir() and os.access(base, os.W_OK):
        return Path(tempfile.mkdtemp(prefix=prefix, dir=str(base)))
    return Path(tempfile.mkdtemp(prefix=prefix))


class PMemRegion:
    """A named byte range inside a pool, accessed via numpy memmap."""

    def __init__(self, path: Path, nbytes: int, create: bool):
        self.path = path
        self.nbytes = nbytes
        mode = "w+" if create else "r+"
        self._mm = np.memmap(path, dtype=np.uint8, mode=mode, shape=(nbytes,))
        self._flushed = not create

    # ---- byte-addressable access ----
    def write(self, offset: int, data: np.ndarray) -> None:
        buf = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        self._mm[offset:offset + buf.nbytes] = buf
        self._flushed = False

    def read(self, offset: int, nbytes: int, dtype=np.uint8,
             shape=None) -> np.ndarray:
        raw = self._mm[offset:offset + nbytes]
        out = raw.view(dtype)
        return out.reshape(shape) if shape is not None else out

    @property
    def dirty(self) -> bool:
        """True while stores issued since the last ``flush()`` may still
        be sitting in the (emulated) CPU caches — i.e. bytes that a
        crash right now is allowed to lose."""
        return not self._flushed

    def flush(self) -> None:
        """CLWB+SFENCE analogue: force bytes to the persistent medium."""
        self._mm.flush()
        self._flushed = True

    def resize(self, nbytes: int) -> None:
        """Grow (or shrink) the region in place, preserving content up
        to ``min(old, new)`` bytes — the pool-extend primitive behind
        append-only logs. Flushes, remaps; existing offsets stay valid."""
        if nbytes == self.nbytes:
            return
        self._mm.flush()
        del self._mm
        with open(self.path, "r+b") as f:
            f.truncate(nbytes)
        self.nbytes = nbytes
        self._mm = np.memmap(self.path, dtype=np.uint8, mode="r+",
                             shape=(nbytes,))

    def close(self) -> None:
        if self.dirty:
            self.flush()
        del self._mm


class PMemPool:
    """A node's B-APM: a directory of named regions + usage accounting."""

    def __init__(self, root: Path, node_id: str = "node0",
                 capacity_bytes: int = 1 << 34):
        self.root = Path(root) / node_id
        self.node_id = node_id
        self.capacity_bytes = capacity_bytes
        self.root.mkdir(parents=True, exist_ok=True)
        self._root_norm = os.path.normpath(str(self.root))
        self._open: Dict[str, PMemRegion] = {}
        self._lock = threading.RLock()
        self._dead = False
        # put_json commits whose parent-directory fsync the filesystem
        # refused: the rename itself still happened, but its durability
        # is at the mercy of the journal. Counted (and warned once) so
        # a degraded mount is visible instead of silently best-effort.
        self.dir_fsync_failures = 0
        self._dir_fsync_warned = False

    @property
    def alive(self) -> bool:
        return not self._dead

    def fail(self) -> None:
        """Simulate the node's B-APM becoming unreachable (node death).
        Subsequent accesses raise IOError instead of racing with cleanup;
        in-flight async writers fail fast rather than resurrecting
        directories mid-teardown."""
        self._dead = True

    def _check_alive(self) -> None:
        if self._dead:
            raise IOError(f"pmem pool {self.node_id} unreachable")

    def _path(self, name: str) -> Path:
        # lexical containment check (normpath collapses any ".."): a
        # resolve() here costs a realpath syscall chain per metadata
        # access, which dominates small-object traffic on slow mounts
        p = os.path.normpath(os.path.join(self._root_norm, name))
        assert p.startswith(self._root_norm + os.sep), name
        return Path(p)

    def create(self, name: str, nbytes: int) -> PMemRegion:
        with self._lock:
            self._check_alive()
            if self.used_bytes() + nbytes > self.capacity_bytes:
                raise MemoryError(
                    f"pmem pool {self.node_id} over capacity: "
                    f"{self.used_bytes() + nbytes} > {self.capacity_bytes}")
            path = self._path(name)
            path.parent.mkdir(parents=True, exist_ok=True)
            region = PMemRegion(path, nbytes, create=True)
            self._open[name] = region
            return region

    def open(self, name: str) -> PMemRegion:
        with self._lock:
            self._check_alive()
            if name in self._open:
                return self._open[name]
            path = self._path(name)
            region = PMemRegion(path, path.stat().st_size, create=False)
            self._open[name] = region
            return region

    def open_or_create(self, name: str, nbytes: int) -> PMemRegion:
        """Open an existing region, or create it at ``nbytes`` — the
        idempotent entry point for append-only logs."""
        with self._lock:
            self._check_alive()
            if self.exists(name):
                return self.open(name)
            return self.create(name, nbytes)

    def extend(self, name: str, nbytes: int) -> PMemRegion:
        """Grow a region to at least ``nbytes`` (byte-range log growth —
        no whole-file rewrite). Returns the (possibly resized) region."""
        with self._lock:
            self._check_alive()
            region = self.open(name)
            if region.nbytes < nbytes:
                grow = nbytes - region.nbytes
                if self.used_bytes() + grow > self.capacity_bytes:
                    raise MemoryError(
                        f"pmem pool {self.node_id} over capacity: "
                        f"{self.used_bytes() + grow} > "
                        f"{self.capacity_bytes}")
                region.resize(nbytes)
            return region

    def rename(self, src: str, dst: str) -> None:
        """Atomically replace region ``dst`` with ``src`` (POSIX rename)
        — the commit point of log compaction and of every shadow-region
        data install: the new file becomes the name in one step, so a
        crash leaves either the old bytes or the new ones, never a torn
        mix. Open handles to both names are flushed (if dirty) and
        evicted from the cache — a re-``open`` maps the new file — but
        NOT unmapped: a concurrent reader still holding the old ``dst``
        region object keeps its own mapping of the replaced inode,
        which stays fully consistent (just superseded) instead of
        faulting mid-read. Copy writers recheck source-manifest
        freshness at their commit point for exactly this reason
        (object_store.copy_object)."""
        with self._lock:
            self._check_alive()
            for name in (src, dst):
                r = self._open.pop(name, None)
                if r is not None and r.dirty:
                    r.flush()
            os.replace(self._path(src), self._path(dst))

    def exists(self, name: str) -> bool:
        return not self._dead and self._path(name).exists()

    def delete(self, name: str) -> None:
        # same eviction discipline as rename: flush a dirty handle but
        # leave the mapping alive for any reader mid-stream on it
        with self._lock:
            r = self._open.pop(name, None)
            if r is not None and r.dirty:
                r.flush()
            p = self._path(name)
            if p.exists():
                p.unlink()

    def list(self, prefix: str = "") -> Iterator[str]:
        if self._dead:
            return
        # walk only the directory component of the prefix — a catalog
        # listing of exch/<wf>/ must not stat every checkpoint slot
        base = self.root
        dir_part = prefix.rpartition("/")[0]
        if dir_part:
            base = self.root / dir_part
            if not base.is_dir():
                return
        names = []
        for dirpath, _dirs, files in os.walk(base):
            rel_dir = os.path.relpath(dirpath, self.root)
            for f in files:
                rel = f if rel_dir == "." else f"{rel_dir}/{f}"
                if rel.startswith(prefix):
                    names.append(rel)
        yield from sorted(names)

    def used_bytes(self) -> int:
        total = 0
        for dirpath, _dirs, files in os.walk(self.root):
            for f in files:
                try:
                    total += os.stat(os.path.join(dirpath, f)).st_size
                except OSError:
                    continue  # e.g. a .tmp committed (renamed) mid-scan
        return total

    # ---- small atomic metadata (manifests) ----
    def put_json(self, name: str, obj) -> None:
        """Crash-consistent metadata commit: tmp write + fsync + rename
        + parent-dir fsync. A crash at ANY point leaves either the old
        complete record or the new complete record — never torn bytes —
        so the cross-pool merge readers can treat every readable copy as
        well-formed (and tolerate the unreadable ones)."""
        self._check_alive()
        path = self._path(name)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + ".tmp")
        with open(tmp, "w") as f:
            json.dump(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic on POSIX
        # persist the rename itself: without the directory fsync the
        # rename can be reordered past the crash and resurrect the tmp
        try:
            dfd = os.open(path.parent, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            # some filesystems refuse directory fsync; the commit is
            # still atomic (rename happened), only its durability
            # ordering is weakened — account for it instead of hiding it
            self.dir_fsync_failures += 1
            if not self._dir_fsync_warned:
                self._dir_fsync_warned = True
                warnings.warn(
                    f"pmem pool {self.node_id}: parent-directory fsync "
                    f"failed for {name!r}; metadata commits on this "
                    f"mount are rename-atomic but not "
                    f"durability-ordered (counted in "
                    f"dir_fsync_failures)", RuntimeWarning)

    def get_json(self, name: str):
        self._check_alive()
        with open(self._path(name)) as f:
            return json.load(f)
