"""Per-request serving engine: prefill + batched decode (SLM mode).

PyTorch counterpart of ``repro/serve/engine.py``: the engine owns ONE
session's device state (``cache``/``pos``) at a time, and ``spill``/
``resume`` persist it under ``serve/<name>``. The state is the JAX
package's tree, leaf for leaf (``group{g}/p{i}/self/{k,v,kpos}`` for an
attention layer's bf16 ring KV, ``group{g}/p{i}/self/{h,conv}`` for an
RG-LRU or SSD layer's float32 recurrent state and bf16 conv window, plus
the ``pos`` cursor), so a session spilled by either package resumes in the
other.

Two backends, as in JAX:
  * direct store (``store=``): a synchronous object-store put/get;
  * TieredIO (``tiered=``): the spill goes through the DLM write-back
    cache on the engine's I/O thread (nonblocking with ``wait=False``,
    behind a ``SpillTicket`` that owns the host copy until the write is
    durable), gets a buddy replica with an ack, and
    ``prefetch_sessions`` warms cold session state from pmem into DRAM
    before the next request needs it (the paper's Fig. 8 prefetch);
    ``resume`` then reads DRAM, or the replica when the home pool died;
    ``repair`` gives spilled sessions a new replica after a node loss.
The SessionManager (``serve/sessions.py``) waits for ROADMAP Queue A
item 2(c).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import bridge, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.object_store import PMemObjectStore
from repro_torch.core.tiered_io import TieredIO
from repro_torch.models import transformer as tfm


class SpillTicket:
    """Future-like handle for a nonblocking ``ServeEngine.spill``.

    The ticket OWNS the host copy of the session state until the pmem
    write is durable: a failed offload parks the copy in
    ``engine.failed_spills[name]`` (the device copy is already freed)
    and ``result()`` raises a ``RuntimeError`` naming the session,
    chained on the real cause. ``restore_failed_spill`` re-installs the
    parked copy."""

    def __init__(self, name: str, state: dict, future,
                 engine: "ServeEngine"):
        self.name = name
        self._state = state
        self._future = future
        self._engine = engine
        self._lock = threading.Lock()
        future.add_done_callback(self._settle)

    def _settle(self, fut) -> None:
        """Once the offload is done, park the host copy if it failed.
        Runs from the future's callback on the I/O thread and again in
        ``result()``/``exception()`` (whichever comes first parks):
        concurrent.futures wakes the waiters before it runs callbacks,
        so a caller may see the failure before the callback ran."""
        with self._lock:
            if self._engine is None or not fut.done():
                return
            if fut.exception() is not None:
                # the spill never became durable: the host copy goes back
                # to the engine so the session is not lost
                self._engine.failed_spills[self.name] = self._state
            # durable (or parked): the ticket drops its refs, and so does
            # not keep the engine (its parameters on the card) alive
            # through the future's callback cycle
            self._state = self._engine = None

    def done(self) -> bool:
        return self._future.done()

    def exception(self, timeout: Optional[float] = None):
        exc = self._future.exception(timeout)
        self._settle(self._future)
        return exc

    def result(self, timeout: Optional[float] = None):
        try:
            return self._future.result(timeout)
        except Exception as e:  # noqa: BLE001 — re-raised with context
            raise RuntimeError(
                f"spill of session {self.name!r} never became durable; "
                f"host copy retained in "
                f"ServeEngine.failed_spills[{self.name!r}]") from e
        finally:
            self._settle(self._future)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, rt: tfm.ModelRuntime, params,
                 store: Optional[PMemObjectStore] = None,
                 tiered: Optional[TieredIO] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        # float32 matmuls and convolutions in full float32: TF32 would
        # keep ~3 decimal digits and break parity with the reference
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        tfm.check_supported(cfg)
        self.cfg = cfg
        self.rt = rt
        self.params = bridge.params_from_host(params, self.device)
        self.store = store
        self.tiered = tiered
        self.cache = None
        self.pos = 0
        # host copies of spills that failed after ``cache`` was freed
        # (see SpillTicket): {session name: state dict}
        self.failed_spills: Dict[str, dict] = {}

    # ---- lifecycle ----
    @torch.no_grad()
    def prefill(self, tokens: np.ndarray) -> np.ndarray:
        toks = torch.as_tensor(np.asarray(tokens), device=self.device)
        logits, cache = tfm.prefill(self.params, self.cfg, self.rt, toks)
        self.cache = cache
        self.pos = tokens.shape[1]
        return logits.argmax(dim=-1).to(torch.int32).cpu().numpy()

    @torch.no_grad()
    def decode(self, first_tokens: np.ndarray, steps: int) -> np.ndarray:
        toks = torch.as_tensor(np.asarray(first_tokens), device=self.device)
        out = [toks]
        for _ in range(steps):
            logits, self.cache = tfm.decode_step(
                self.params, self.cfg, self.rt, self.cache, toks, self.pos)
            toks = logits.argmax(dim=-1).to(torch.int32)
            self.pos += 1
            out.append(toks)
        return torch.stack(out, dim=1).cpu().numpy().astype(np.int32)

    # ---- session-state handoff ----
    def export_state(self, release: bool = False) -> dict:
        """Host copy of the session state (``{"cache", "pos"}``): owned
        CPU tensors in the JAX tree layout and an ``np.int32`` cursor.
        ``release`` frees the engine's device copy after the export."""
        if self.cache is None:
            raise RuntimeError("no session state resident")
        obj = {"cache": bridge.state_to_host(self.cache),
               "pos": np.int32(self.pos)}
        if release:
            self.cache = None
        return obj

    def install_state(self, obj: dict) -> None:
        """Adopt a session state tree from either package (numpy leaves,
        ml_dtypes bfloat16 included, or tensors); copies to the device,
        so decoding never writes into ``obj`` (a DLM cache entry, a
        parked spill)."""
        self.cache = bridge.state_from_host(obj["cache"], self.device)
        self.pos = int(obj["pos"])

    def restore_failed_spill(self, name: str) -> None:
        """Re-install the host copy a failed nonblocking spill parked
        (see SpillTicket)."""
        self.install_state(self.failed_spills.pop(name))

    # ---- pmem spill (SLM): persist serving state, restore later ----
    def spill(self, name: str, wait: bool = True, replicate: bool = True):
        """Persist the session's state (KV, recurrent state, cursor) to
        pmem and free device memory. The host copy is complete before the
        device copy is dropped. With a TieredIO engine the write happens
        on its I/O thread: ``wait=False`` returns a ``SpillTicket`` at
        once instead of blocking, and ``replicate`` (default) gives the
        spilled state an acked buddy-node replica, so ``resume`` and
        ``prefetch_sessions`` keep working when the home pool dies. The
        direct store writes synchronously and returns None."""
        if self.tiered is None and self.store is None:
            # check BEFORE dropping the state
            raise RuntimeError("no pmem backend attached")
        obj = self.export_state(release=True)
        if self.tiered is not None:
            fut = self.tiered.offload(f"serve/{name}", obj,
                                      replicate=replicate)
            if wait:
                fut.result()
                return None
            return SpillTicket(name, obj, fut, self)
        self.store.put(f"serve/{name}", obj)
        return None

    def resume(self, name: str) -> None:
        if self.tiered is not None:
            obj = self.tiered.fetch(f"serve/{name}")
        elif self.store is not None:
            obj = self.store.get(f"serve/{name}")
        else:
            raise RuntimeError("no pmem backend attached")
        self.install_state(obj)

    def peek_session(self, name: str, leaf: str):
        """Byte-range read of ONE leaf of a spilled session (a layer's KV
        page or recurrent state, or the ``pos`` cursor) without
        rehydrating the rest: through TieredIO (home pool first, then
        acked replicas, decoding only that leaf's tiles when the spill
        travelled wire-encoded; nothing is admitted into the DLM cache),
        or straight from the direct store."""
        if self.tiered is not None:
            return self.tiered.fetch_leaf(f"serve/{name}", leaf)
        if self.store is None:
            raise RuntimeError("no pmem backend attached")
        return self.store.get_leaf(f"serve/{name}", leaf)

    def prefetch_sessions(self, names: List[str]):
        """Warm cold session state pmem -> DRAM ahead of resume (Fig. 8
        prefetch). Returns the TieredIO future (hit/load counts)."""
        if self.tiered is None:
            raise RuntimeError("prefetch needs a TieredIO engine")
        return self.tiered.prefetch([f"serve/{n}" for n in names])

    def evict_cold_sessions(self, max_idle_s: float = 0.0) -> int:
        """Spill idle cached sessions back to pmem (DRAM pressure
        valve)."""
        if self.tiered is None:
            raise RuntimeError("eviction needs a TieredIO engine")
        return self.tiered.evict_cold(max_idle_s)

    def repair(self, lost_nodes) -> dict:
        """Restore the replication factor of spilled session state after
        a node loss: every ``dlm/serve/...`` object whose acked copies
        the loss left on one survivor gets a new replica
        (``TieredIO.repair`` reads ``dlm/ackslog``, no probing). With the
        repair daemon running, its sweep is joined (a bounded wait) and
        its ledger returned instead of scanning a second time."""
        if self.tiered is None:
            raise RuntimeError("repair needs a TieredIO engine")
        daemon = self.tiered.repair_daemon
        if daemon is not None and daemon.running:
            daemon.wait_for(lost_nodes, timeout=60.0)
        if daemon is not None and daemon.covers(lost_nodes):
            return daemon.report()
        return self.tiered.repair(lost_nodes)
