"""Crash-persistent flight recorder: a fixed-slot pmem ring buffer.

Each node owns one ring (``obs/flightring`` in its PMemPool). Events
are fixed-size binary slots written through ``PMemRegion`` byte-range
writes under the SAME committed-tail discipline ``MetaLog`` uses:

    slot bytes -> flush -> committed TAIL -> flush

so a crash can tear at most the not-yet-committed slot, which replay
never reads. The committed tail is stored as a *virtual byte offset*
(``HDR_SIZE + events_committed * slot_bytes``, monotone, never reduced
modulo the ring) — the persistence-order sanitizer can therefore apply
its MetaLog tail check verbatim: any slot write left unflushed when the
tail advances past it is a violation. Replay decodes the last
``min(committed, slots)`` events; a CRC guards each slot against media
damage, and ring wrap-around simply drops the oldest events.

Telemetry must never take down the data plane: a dead pool (or any
I/O error) turns ``record`` into a counted drop, not an exception.

A copy of ``repro/obs/recorder.py`` (numpy only), kept so that the port
imports nothing of the JAX package. The ring is byte for byte the JAX
package's, so a ring written by either package replays in the other.
"""
from __future__ import annotations

import json
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.obs.trace import EVT_BEGIN, EVT_END, EVT_POINT  # noqa: F401

_MAGIC = b"OBSR1\x00"
_VERSION = 1
# magic | version | committed TAIL (virtual byte offset) | slots |
# slot_bytes | epoch  — tail lives at byte 8, like MetaLog's, so the
# runtime sanitizer's committed-tail check covers the ring too.
_HDR = struct.Struct("<6sHQQQQ")
_TAIL_OFF = 8
HDR_SIZE = 64

# Per-slot event header:
# crc32 | seq | ts | trace | span | parent | kind | name_len | attrs_len
_EVT = struct.Struct("<IQdQQQBBH")

DEFAULT_SLOTS = 2048
DEFAULT_SLOT_BYTES = 192


def _u64le(v: int) -> np.ndarray:
    return np.frombuffer(struct.pack("<Q", v), dtype=np.uint8)


class FlightRecorder:
    """Per-node pmem event ring (see module docstring for the layout).

    ``record`` is safe from any thread; the internal lock serializes
    slot allocation and the two-write commit sequence.
    """

    def __init__(self, pool, name: str = "obs/flightring", *,
                 slots: int = DEFAULT_SLOTS,
                 slot_bytes: int = DEFAULT_SLOT_BYTES):
        self.pool = pool
        self.name = name
        self._lock = threading.Lock()
        self.drops = 0
        region = pool.open_or_create(
            name, HDR_SIZE + slots * slot_bytes)
        raw = bytes(region.read(0, _HDR.size))
        magic, ver, tail, h_slots, h_slot_bytes, _epoch = \
            _HDR.unpack(raw)
        if magic == _MAGIC and ver == _VERSION and h_slots:
            # adopt the on-pmem geometry + committed count (reopen
            # after restart: the ring keeps appending where it left off)
            self.slots = int(h_slots)
            self.slot_bytes = int(h_slot_bytes)
            self._seq = max(0, (int(tail) - HDR_SIZE)) // \
                self.slot_bytes
        else:
            self.slots = slots
            self.slot_bytes = slot_bytes
            self._seq = 0
            hdr = _HDR.pack(_MAGIC, _VERSION, HDR_SIZE, slots,
                            slot_bytes, int(time.time()))
            region.write(0, np.frombuffer(hdr.ljust(HDR_SIZE, b"\0"),
                                          dtype=np.uint8))
            region.flush()

    @property
    def committed(self) -> int:
        with self._lock:
            return self._seq

    def record(self, kind: int, name: str, *, ts: Optional[float] = None,
               trace: int = 0, span: int = 0, parent: int = 0,
               attrs: Optional[Dict[str, Any]] = None) -> bool:
        """Append one event; False means it was dropped (dead pool /
        I/O error), with ``self.drops`` incremented."""
        ts = time.time() if ts is None else ts
        nb = name.encode("utf-8")[:64]
        ab = b""
        if attrs:
            ab = json.dumps(attrs, separators=(",", ":"),
                            default=str).encode("utf-8")
        room = self.slot_bytes - _EVT.size - len(nb)
        if len(ab) > room:
            ab = b""  # attrs don't fit the slot: keep the event itself
        with self._lock:
            seq = self._seq
            body = _EVT.pack(0, seq, ts, trace, span, parent, kind,
                             len(nb), len(ab))[4:] + nb + ab
            blob = struct.pack("<I", zlib.crc32(body)) + body
            off = HDR_SIZE + (seq % self.slots) * self.slot_bytes
            new_tail = HDR_SIZE + (seq + 1) * self.slot_bytes
            try:
                region = self.pool.open(self.name)
                # B-APM ring discipline (same as MetaLog._append_pool):
                # slot bytes -> flush -> committed TAIL -> flush. A
                # crash between the flushes loses only this event.
                region.write(off, np.frombuffer(blob, dtype=np.uint8))
                region.flush()
                region.write(_TAIL_OFF, _u64le(new_tail))
                region.flush()
            except (IOError, OSError, ValueError):
                self.drops += 1
                return False
            self._seq = seq + 1
            return True

    # ---- replay (post-crash or live) --------------------------------
    @classmethod
    def replay(cls, pool, name: str = "obs/flightring") -> List[dict]:
        """Decode the committed events still in the ring, oldest first.

        Works on any pool a crash left behind: only slots below the
        committed tail are read, so a torn (pre-commit) slot write is
        invisible; CRC-corrupt slots (media damage) are skipped.
        """
        try:
            if not pool.exists(name):
                return []
            region = pool.open(name)
            raw = bytes(region.read(0, _HDR.size))
        except (IOError, OSError):
            return []
        magic, ver, tail, slots, slot_bytes, _epoch = _HDR.unpack(raw)
        if magic != _MAGIC or ver != _VERSION or not slots \
                or not slot_bytes:
            return []
        committed = max(0, (int(tail) - HDR_SIZE)) // int(slot_bytes)
        lo = max(0, committed - int(slots))
        events: List[dict] = []
        for seq in range(lo, committed):
            off = HDR_SIZE + (seq % int(slots)) * int(slot_bytes)
            try:
                blob = bytes(region.read(off, int(slot_bytes)))
            except (IOError, OSError, ValueError):
                continue
            crc = struct.unpack_from("<I", blob)[0]
            (_, eseq, ts, trace, span, parent, kind, nlen,
             alen) = _EVT.unpack_from(blob)
            end = _EVT.size + nlen + alen
            if eseq != seq or end > int(slot_bytes):
                continue  # stale or damaged slot
            if zlib.crc32(blob[4:end]) != crc:
                continue  # media damage: CRC is authoritative
            attrs: Dict[str, Any] = {}
            if alen:
                try:
                    attrs = json.loads(
                        blob[_EVT.size + nlen:end].decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    attrs = {}
            events.append({
                "seq": seq, "ts": ts, "kind": kind,
                "name": blob[_EVT.size:_EVT.size + nlen]
                .decode("utf-8", "replace"),
                "trace": trace, "span": span, "parent": parent,
                "attrs": attrs})
        return events
