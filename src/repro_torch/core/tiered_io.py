"""Asynchronous checkpoint I/O (the checkpoint channel of the paper's
tiered-I/O engine).

The part of ``repro/core/tiered_io.py`` that the training loop drives:
``TieredIO.save_async`` returns a ``SaveTicket`` at once (modulo slot
backpressure, as ``tiered_io.py:1330-1400``), and one FIFO writer thread
runs the saves in order, so a write overlaps the caller's next steps.
``raise_if_failed``, ``join``, ``quiesce`` and ``shutdown`` keep JAX's
contracts. There is no replication channel yet (ROADMAP Queue A item 2),
so a committed save's ``durability()`` is ``"LOCAL"`` unless acks were
recorded by hand.

The saved state lives on the card, where the JAX loop hands over a host
copy. The writer runs a save's device phase (``prepare``: device to
host, or the delta encode) on its own CUDA stream, after the caller's
stream has produced the state, then sets ``ticket.device_done`` and lets
go of the device tensors before it writes to pmem (``commit``). The
training loop waits on ``device_done`` before it would make a second
newer state, so the card holds at most one extra copy of the state.
"""
from __future__ import annotations

import collections
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional, Sequence

import torch

from repro_torch.core.checkpoint import DistributedCheckpointer

#: acknowledged durability levels, weakest to strongest
DURABILITY_LEVELS = ("PENDING", "FAILED", "LOCAL", "REPLICATED", "DRAINED")
_LEVEL_RANK = {lvl: i for i, lvl in enumerate(DURABILITY_LEVELS)}


class SaveTicket:
    """Handle for one asynchronous checkpoint save. ``result()`` blocks
    until the pmem commit and returns the global manifest;
    ``device_done`` completes once the save holds no device tensor. (JAX's
    ticket also carries the post-commit replicate/drain futures, which the
    port does not queue yet.)"""

    def __init__(self, step: int, slot: Optional[int] = None,
                 checkpointer: Optional[DistributedCheckpointer] = None):
        self.step = step
        self.slot = slot  # filled in once the writer allocates it
        self.future: Future = Future()
        self.device_done: Future = Future()
        self._checkpointer = checkpointer

    def result(self, timeout: Optional[float] = None) -> dict:
        return self.future.result(timeout)

    def done(self) -> bool:
        return self.future.done()

    def exception(self, timeout: Optional[float] = None):
        return self.future.exception(timeout)

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


class TieredIO:
    """Async checkpoint engine over a checkpointer."""

    def __init__(self, checkpointer: DistributedCheckpointer,
                 max_inflight_saves: Optional[int] = None):
        self.checkpointer = checkpointer
        self.max_inflight = max_inflight_saves or checkpointer.slots
        self.save_errors: List[Exception] = []  # checkpoint COMMIT failures
        self._tickets: "collections.deque[SaveTicket]" = collections.deque()
        self._lock = threading.Lock()
        # one FIFO writer thread: serialises pmem writes (slot safety; a
        # delta's prepare reads its base only after the base committed)
        self._io = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix="tiered-io-wr")
        self._stream = None  # the writer's CUDA stream, made at first use

    def _writer_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.checkpointer.device)
        return self._stream

    # ---- checkpoint channel ------------------------------------------
    def save_async(self, step: int, tree, *,
                   base_step: Optional[int] = None,
                   drain: bool = False) -> SaveTicket:
        """Nonblocking checkpoint of ``tree``, which must not be written
        to afterwards (the training state is replaced, never updated in
        place); returns at once modulo slot backpressure."""
        ckpt = self.checkpointer
        ticket = SaveTicket(step, checkpointer=ckpt)
        retiring: List[SaveTicket] = []
        with self._lock:
            # double-buffer backpressure: never exceed the slot count;
            # only the retiring ticket's COMMIT gates the caller
            while len(self._tickets) >= self.max_inflight:
                retiring.append(self._tickets.popleft())
            self._tickets.append(ticket)
        for old in retiring:  # wait outside the lock
            try:
                old.result()
            except Exception as e:  # noqa: BLE001 — surfaced by
                self.save_errors.append(e)  # raise_if_failed / quiesce

        ready = None
        if ckpt.device.type == "cuda":
            # the writer's stream starts after the caller's has made the
            # state
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(ckpt.device))
        box = [tree]
        del tree

        def _save():
            try:
                if ready is None:
                    prep = ckpt.prepare(step, box.pop(), base_step=base_step,
                                        drain=drain)
                else:
                    stream = self._writer_stream()
                    with torch.cuda.stream(stream):
                        stream.wait_event(ready)
                        prep = ckpt.prepare(step, box.pop(),
                                            base_step=base_step, drain=drain)
                    stream.synchronize()
            finally:
                box.clear()
                ticket.device_done.set_result(None)
            man = ckpt.commit(prep)
            ticket.slot = man["slot"]
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
        """Raise (and pop) the first pending checkpoint COMMIT failure."""
        with self._lock:
            for t in list(self._tickets):
                if t.done() and t.exception() is not None:
                    self.save_errors.append(t.exception())
                    self._tickets.remove(t)
            if self.save_errors:
                raise self.save_errors.pop(0)

    # ---- lifecycle ---------------------------------------------------
    def quiesce(self) -> List[Exception]:
        """Join every in-flight save; errors are collected and returned,
        never raised."""
        while True:
            with self._lock:
                if not self._tickets:
                    break
                ticket = self._tickets.popleft()
            try:
                ticket.result()
            except Exception as e:  # noqa: BLE001
                self.save_errors.append(e)
        with self._lock:
            errors, self.save_errors = self.save_errors, []
        return errors

    def join(self) -> None:
        """Strict barrier: wait for all in-flight work, raising the first
        error."""
        errors = self.quiesce()
        if errors:
            raise errors[0]

    def shutdown(self) -> None:
        self.quiesce()
        self._io.shutdown(wait=True)
