"""Persistence-order sanitizer: a record-and-check shim over the port's
PMemRegion and PMemPool (``repro_torch/core/pmem.py``; a copy of
``repro/analysis/sanitizer.py``, which shims the JAX package's pmem).

While installed, every region write/flush/resize/close (and pool-level
delete/rename) is intercepted and logged as an event stream, and the
B-APM ordering discipline is checked *as it happens*:

  * **committed-tail discipline** — a MetaLog tail advance (an 8-byte
    write at the header's tail slot on a region carrying the MLOG magic)
    must never commit bytes that are still unflushed: every byte in
    ``[HDR_SIZE, new_tail)`` must have been flushed before the tail
    write lands. Violating this is exactly the torn-append crash bug the
    committed-tail design exists to rule out.
  * **no dirty drops** — a region must never be deleted, renamed-over or
    (at teardown) left live while dirty on a live pool. ``PMemRegion``
    tracks ``dirty`` (the surfaced ``_flushed`` flag); the sanitizer
    asserts nobody abandons dirty bytes.
  * **numpy at the region boundary** (the port's own rule) — every
    ``PMemRegion.write`` takes a numpy array. A torch tensor reaching it
    would be converted by numpy behind the writer's back (a CUDA or a
    bf16 one not at all), so the shim reports it as a violation.

With ``capture=True`` the shim additionally keeps the written bytes (also
across a ``resize``, where JAX's shim restarts the stream), so
``crash_images()`` can *enumerate torn-write crash states*: for every
prefix of the recorded stream it yields the byte image a crash there
could leave — unflushed stores not yet persistent, all persistent (cache
eviction wrote them back early), and a half-applied final store (a torn
write). Feeding those images back through ``MetaLog`` replay (see
``materialize``, tests/test_torch_analysis.py and the
``--torch-pmem-sanitize`` flag of ``repro_torch.analysis.pytest_plugin``)
proves replay lands on a
committed prefix for EVERY reachable crash state, not just the happy
path.

Violations are collected, not raised inline (an assert inside a
scheduler worker thread would be swallowed by the future); call
``raise_violations()`` — the pytest fixture does — to fail the test.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core import pmem as _pmem

_MLOG_MAGIC = b"MLOG1\x00"
# the obs flight recorder (repro_torch.obs.recorder) stores its committed
# tail at the same header slot under the same discipline — the tail
# check below covers both log formats
_OBS_MAGIC = b"OBSR1\x00"
_TAILED_MAGICS = (_MLOG_MAGIC, _OBS_MAGIC)
_TAIL_OFF = 8
_HDR_SIZE = 64


class _RegionState:
    __slots__ = ("path", "nbytes", "dirty", "unflushed", "events",
                 "initial", "pool_dead", "closed")

    def __init__(self, path: str, nbytes: int, initial: Optional[bytes]):
        self.path = path
        self.nbytes = nbytes
        self.dirty = False
        #: [start, end) byte ranges written since the last flush
        self.unflushed: List[Tuple[int, int]] = []
        #: (op, offset, payload-bytes-or-None) — capture mode keeps data
        self.events: List[Tuple[str, int, Optional[bytes]]] = []
        self.initial = initial
        self.pool_dead = False
        self.closed = False


class PMemSanitizer:
    """Monkeypatching shim; use as a context manager or via the
    ``--torch-pmem-sanitize`` pytest flag
    (``-p repro_torch.analysis.pytest_plugin``)."""

    def __init__(self, capture: bool = False,
                 max_capture_bytes: int = 8 << 20):
        self.capture = capture
        self.max_capture_bytes = max_capture_bytes
        self.violations: List[str] = []
        self.regions: Dict[str, _RegionState] = {}
        self.stats = {"writes": 0, "flushes": 0, "tail_advances": 0,
                      "closes": 0}
        self._lock = threading.RLock()
        self._orig: Dict[str, Callable] = {}
        self._installed = False

    # ---- lifecycle ---------------------------------------------------
    def install(self) -> "PMemSanitizer":
        if self._installed:
            return self
        san = self
        R, P = _pmem.PMemRegion, _pmem.PMemPool
        self._orig = {"r_init": R.__init__, "r_write": R.write,
                      "r_flush": R.flush, "r_resize": R.resize,
                      "r_close": R.close, "p_delete": P.delete,
                      "p_rename": P.rename}

        def r_init(self, path, nbytes, create):
            san._orig["r_init"](self, path, nbytes, create)
            san._on_open(self, create)

        def r_write(self, offset, data):
            san._on_boundary(self, data)
            san._orig["r_write"](self, offset, data)
            san._on_write(self, offset, data)

        def r_flush(self):
            san._orig["r_flush"](self)
            san._on_flush(self)

        def r_resize(self, nbytes):
            san._orig["r_resize"](self, nbytes)
            san._on_resize(self, nbytes)

        def r_close(self):
            san._on_close(self)
            san._orig["r_close"](self)

        def p_delete(self, name):
            san._on_drop(self, name, "delete")
            san._orig["p_delete"](self, name)

        def p_rename(self, src, dst):
            san._on_drop(self, dst, "rename-over")
            san._orig["p_rename"](self, src, dst)

        R.__init__, R.write, R.flush = r_init, r_write, r_flush
        R.resize, R.close = r_resize, r_close
        P.delete, P.rename = p_delete, p_rename
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        R, P = _pmem.PMemRegion, _pmem.PMemPool
        R.__init__ = self._orig["r_init"]
        R.write = self._orig["r_write"]
        R.flush = self._orig["r_flush"]
        R.resize = self._orig["r_resize"]
        R.close = self._orig["r_close"]
        P.delete = self._orig["p_delete"]
        P.rename = self._orig["p_rename"]
        self._installed = False

    def __enter__(self) -> "PMemSanitizer":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
        if not exc[0]:
            self.raise_violations()

    # ---- event hooks -------------------------------------------------
    def _state(self, region) -> _RegionState:
        key = str(region.path)
        st = self.regions.get(key)
        if st is None:
            st = _RegionState(key, region.nbytes, None)
            self.regions[key] = st
        return st

    def _on_open(self, region, create: bool) -> None:
        with self._lock:
            key = str(region.path)
            initial = None
            if self.capture and region.nbytes <= self.max_capture_bytes:
                initial = b"\x00" * region.nbytes if create \
                    else bytes(region._mm)
            st = _RegionState(key, region.nbytes, initial)
            st.events.append(("open", 0, None))
            self.regions[key] = st

    def _on_boundary(self, region, data) -> None:
        if not isinstance(data, np.ndarray):
            with self._lock:
                self.violations.append(
                    f"region-boundary: {region.path} written with a "
                    f"{type(data).__module__}.{type(data).__name__}, not "
                    f"a numpy array — writers hand the region host bytes "
                    f"(bridge.bf16_bits for bf16)")

    def _on_write(self, region, offset: int, data) -> None:
        buf = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        with self._lock:
            st = self._state(region)
            self.stats["writes"] += 1
            payload = buf.tobytes() if (
                st.initial is not None and
                buf.nbytes <= self.max_capture_bytes) else None
            # committed-tail discipline: a tail advance on an MLOG
            # region must not cover unflushed entry bytes
            if offset == _TAIL_OFF and buf.nbytes == 8 and \
                    self._is_mlog(region):
                self.stats["tail_advances"] += 1
                new_tail = int.from_bytes(buf.tobytes(), "little")
                bad = [iv for iv in st.unflushed
                       if iv[0] < new_tail and iv[1] > _HDR_SIZE]
                if bad:
                    self.violations.append(
                        f"committed-tail: {st.path} advanced tail to "
                        f"{new_tail} over unflushed byte ranges {bad} — "
                        f"a crash now replays bytes that were never "
                        f"flushed (write -> flush -> tail -> flush)")
            st.unflushed.append((offset, offset + buf.nbytes))
            st.dirty = True
            st.events.append(("write", offset, payload))

    def _on_flush(self, region) -> None:
        with self._lock:
            st = self._state(region)
            self.stats["flushes"] += 1
            st.unflushed = []
            st.dirty = False
            st.events.append(("flush", 0, None))

    def _on_resize(self, region, nbytes: int) -> None:
        with self._lock:
            st = self._state(region)
            # resize flushes + remaps in pmem.py
            st.unflushed = []
            st.dirty = False
            st.nbytes = nbytes
            # the stream goes on through the resize (a flush and a new
            # length on replay), so the writes before it stay enumerable:
            # the encoded copy writes its shadow, then shrinks it
            if nbytes > self.max_capture_bytes:
                st.initial = None
            st.events.append(("resize", nbytes, None))

    def _on_close(self, region) -> None:
        with self._lock:
            st = self._state(region)
            self.stats["closes"] += 1
            # PMemRegion.close flushes when dirty — but a shimmed close
            # observing dirty bytes means SOME path relied on close()
            # for durability instead of flushing at its commit point;
            # surface it (the flush in close still runs afterwards).
            if st.dirty:
                self.violations.append(
                    f"dirty-close: {st.path} closed while dirty — the "
                    f"writing path never flushed; durability leaned on "
                    f"close() which a crash never calls")
            st.closed = True

    def _on_drop(self, pool, name: str, how: str) -> None:
        with self._lock:
            try:
                key = str(pool._path(name))
            except Exception:
                return
            st = self.regions.get(key)
            if st is None:
                return
            if st.dirty and getattr(pool, "alive", True):
                self.violations.append(
                    f"dirty-drop: {st.path} {how} while dirty — "
                    f"unflushed bytes were abandoned")
            st.closed = True
            st.dirty = False

    @staticmethod
    def _is_mlog(region) -> bool:
        try:
            return bytes(region._mm[:len(_MLOG_MAGIC)]) in _TAILED_MAGICS
        except Exception:
            return False

    # ---- teardown checks --------------------------------------------
    def check_no_dirty_regions(self) -> None:
        """Assert no live region was left dirty (dropped without a
        flush). Regions of dead pools (simulated node loss) and files
        already removed are crash debris, not bugs."""
        import os
        with self._lock:
            for st in self.regions.values():
                if st.dirty and not st.closed and os.path.exists(st.path):
                    self.violations.append(
                        f"dirty-teardown: {st.path} still dirty at "
                        f"teardown — a write path exited without flush")
                    st.dirty = False

    def raise_violations(self) -> None:
        self.check_no_dirty_regions()
        if self.violations:
            msgs = "\n  ".join(self.violations)
            raise AssertionError(
                f"pmem sanitizer: {len(self.violations)} persistence-"
                f"order violation(s):\n  {msgs}")

    # ---- crash-state enumeration (capture mode) ---------------------
    def _replay_image(self, st: _RegionState, upto: int,
                      *, persist_pending: bool = True,
                      tear_last: bool = False) -> bytes:
        img = bytearray(st.initial or b"")
        pending: List[Tuple[int, bytes]] = []

        def apply(off: int, data: bytes) -> None:
            end = off + len(data)
            if end > len(img):
                img.extend(b"\x00" * (end - len(img)))
            img[off:end] = data

        for i, (op, off, payload) in enumerate(st.events[:upto]):
            if op == "write" and payload is not None:
                pending.append((off, payload))
            elif op in ("flush", "resize"):
                for o, d in pending:
                    apply(o, d)
                pending = []
                if op == "resize":  # ``off`` holds the new length
                    del img[off:]
                    img.extend(b"\x00" * (off - len(img)))
        if persist_pending:
            for k, (o, d) in enumerate(pending):
                if tear_last and k == len(pending) - 1:
                    apply(o, d[:len(d) // 2])
                else:
                    apply(o, d)
        return bytes(img)

    def crash_images(self, path_substr: str
                     ) -> Iterator[Tuple[str, bytes]]:
        """Enumerate byte images a crash could leave for every region
        whose path contains ``path_substr``. For each prefix of the
        event stream ending in a write, yields three states: ``lost``
        (no unflushed store persisted), ``persisted`` (cache eviction
        wrote everything back), and ``torn`` (the final store half-
        applied). Requires ``capture=True``."""
        if not self.capture:
            raise RuntimeError("crash_images needs PMemSanitizer("
                               "capture=True)")
        with self._lock:
            states = [st for st in self.regions.values()
                      if path_substr in st.path and st.initial is not None]
            for st in states:
                for i, (op, _off, _p) in enumerate(st.events):
                    if op != "write":
                        continue
                    upto = i + 1
                    yield (f"{st.path}@{upto}:lost",
                           self._replay_image(st, upto,
                                              persist_pending=False))
                    yield (f"{st.path}@{upto}:persisted",
                           self._replay_image(st, upto))
                    yield (f"{st.path}@{upto}:torn",
                           self._replay_image(st, upto, tear_last=True))

    @staticmethod
    def materialize(img: bytes, pool, name: str) -> None:
        """Write a crash image into ``pool`` under ``name`` through the
        sanctioned region API (create + write + flush), replacing any
        existing region — the replay half of crash-state enumeration."""
        if pool.exists(name):
            pool.delete(name)
        region = pool.create(name, max(len(img), 1))
        if img:
            region.write(0, np.frombuffer(img, dtype=np.uint8))
        region.flush()
