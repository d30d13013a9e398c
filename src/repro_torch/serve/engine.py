"""Per-request serving engine: prefill + batched decode (SLM mode).

PyTorch counterpart of ``repro/serve/engine.py`` in its direct-store
configuration: the engine owns ONE session's device state
(``cache``/``pos``) at a time, and ``spill``/``resume`` persist it through
a ``PMemObjectStore`` under ``serve/<name>``. The state is the JAX
package's tree, leaf for leaf (``group{g}/p{i}/self/{k,v,kpos}`` for an
attention layer's bf16 ring KV, ``group{g}/p{i}/self/{h,conv}`` for an
RG-LRU or SSD layer's float32 recurrent state and bf16 conv window, plus
the ``pos`` cursor), so a session spilled by either package resumes in the
other.

The TieredIO wiring (``tiered=``, nonblocking spills with ``SpillTicket``,
``prefetch_sessions``, ``evict_cold_sessions``, ``repair``) is not ported
yet (ROADMAP Queue A: TieredIO/SessionManager serve wiring).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import bridge, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.object_store import PMemObjectStore
from repro_torch.models import transformer as tfm


class ServeEngine:
    def __init__(self, cfg: ModelConfig, rt: tfm.ModelRuntime, params,
                 store: Optional[PMemObjectStore] = None,
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
        self.cache = None
        self.pos = 0

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
        ml_dtypes bfloat16 included, or tensors); copies to the device."""
        self.cache = bridge.state_from_host(obj["cache"], self.device)
        self.pos = int(obj["pos"])

    # ---- pmem spill (SLM): persist serving state, restore later ----
    def spill(self, name: str) -> None:
        """Persist the session's state (KV, recurrent state, cursor) to
        pmem and free device memory; the write is durable when this
        returns."""
        if self.store is None:  # check BEFORE dropping the KV
            raise RuntimeError("no pmem backend attached")
        self.store.put(f"serve/{name}", self.export_state(release=True))

    def resume(self, name: str) -> None:
        if self.store is None:
            raise RuntimeError("no pmem backend attached")
        self.install_state(self.store.get(f"serve/{name}"))

    def peek_session(self, name: str, leaf: str):
        """Byte-range read of ONE leaf of a spilled session (a layer's KV
        page or recurrent state, or the ``pos`` cursor) without
        rehydrating the rest."""
        if self.store is None:
            raise RuntimeError("no pmem backend attached")
        return self.store.get_leaf(f"serve/{name}", leaf)
