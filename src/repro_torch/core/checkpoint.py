"""Distributed node-local checkpointing on B-APM (paper §V item 8 + §III).

PyTorch counterpart of ``repro/core/checkpoint.py`` for a cluster with
no lost nodes: every node writes only its own shards to its own pmem
pool, two or more shadow slots rotate under an atomic manifest commit,
and a delta checkpoint stores ``int8 round((new - base) / scale)`` per
tile of 1024 elements against a full base (``path.__dq`` codes and
``path.__ds`` scales, as JAX names them). What either package writes, the
other restores bit for bit: the same shard plan, slot rotation, object
layout, manifest and ack log (``ckpt/ackslog``).

The state lives on the card. A save takes the step's device tensors and
runs in two phases (``prepare``, then ``commit``), so that a background
writer can let go of the device tensors before it writes to pmem:

* ``prepare`` allocates the slot and builds the manifest, then turns
  each node's shards into host payloads. A full save copies them to the
  host; a delta save reads each node's base shard from pmem
  (step-checked), brings it to the card leaf by leaf, encodes there with
  the Hopper codec kernel (``kernels/ckpt_codec``) and copies the codes
  and scales to the host. Device work runs on the current stream.
* ``commit`` writes the nodes' payloads (each node's pool on its own
  thread, as each node writes its own), then commits the manifest, the
  latest pointer and the ack-log seed on every pool.

``restore`` of a delta step decodes on the card; every restore returns
tensors on the checkpointer's device. The lost-node paths (buddy
replicas, the drained tier, partial and row-range restores) wait for the
replication slice (ROADMAP Queue A item 2) and raise.
"""
from __future__ import annotations

import collections
import functools
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.analysis.annotations import metadata_only
from repro_torch.bridge import to_torch
from repro_torch.core.meta_log import MetaLog
from repro_torch.core.object_store import (BF16_TAG, PMemObjectStore,
                                           _flatten, _unflatten)
from repro_torch.kernels.ckpt_codec import ops as codec

TILE = 1024

_LOST_NODES = ("restoring around lost nodes (buddy replicas, the drained "
               "tier) is not ported (ROADMAP Queue A item 2: replication, "
               "drain and repair)")


def _fold_ckpt_acks(state: dict, ev: dict) -> None:
    """MetaLog reducer for the checkpoint ack registry, as JAX's: state
    maps ``str(step)`` to ``{"step", "ts", "acks": {nid: {kind: rec}},
    "ring", "delta_base"}``; ``seed`` resets the step's record, ``ack``
    upserts one (nid, kind) entry, ``adopt`` migrates a legacy record."""
    op = ev["op"]
    if op == "seed":
        state[str(ev["step"])] = {
            "step": ev["step"], "ts": ev["ts"], "acks": {},
            "ring": ev.get("ring"), "delta_base": ev.get("delta_base")}
    elif op == "adopt":
        state.setdefault(str(ev["step"]), ev["rec_map"])
    elif op == "ack":
        key = str(ev["step"])
        rec_map = state.get(key) or {"step": ev["step"], "acks": {}}
        acks = {nid: dict(kinds)
                for nid, kinds in (rec_map.get("acks") or {}).items()}
        acks.setdefault(ev["nid"], {})[ev["kind"]] = ev["rec"]
        state[key] = {**rec_map, "acks": acks}


def _merge_acks(maps: Sequence[Dict[str, Dict[str, dict]]]
                ) -> Dict[str, Dict[str, dict]]:
    """Union per-node ack maps from divergent manifest copies; for the
    same (node, kind) the newest record (by its own ``ts``) wins."""
    merged: Dict[str, Dict[str, dict]] = {}
    for m in maps:
        for nid, kinds in m.items():
            if not isinstance(kinds, dict):
                continue
            cur = merged.setdefault(nid, {})
            for kind, rec in kinds.items():
                if kind not in cur or \
                        rec.get("ts", 0) > cur[kind].get("ts", 0):
                    cur[kind] = rec
    return merged


def _dtype_tag(leaf) -> str:
    """The manifest's dtype string: numpy's name, ``bfloat16`` for bf16."""
    if isinstance(leaf, torch.Tensor):
        return BF16_TAG if leaf.dtype == torch.bfloat16 else \
            str(leaf.dtype).replace("torch.", "")
    return leaf.dtype.name


#: bytes a staged copy moves per driver call (two pinned buffers of this)
_CHUNK = 1 << 26


def _copy_staged(src: torch.Tensor, dst: torch.Tensor) -> None:
    """Copy ``src`` into ``dst`` (same shape and dtype, one on the card,
    one in pageable host memory) through two pinned 64 MB buffers on the
    current stream. A single pageable copy of a GB-sized leaf holds the
    driver for its whole length and stalls every kernel launch of the
    training step meanwhile; chunked, the DMA of one chunk overlaps the
    host memcpy of the other."""
    s = src.reshape(-1).view(torch.uint8)
    d = dst.reshape(-1).view(torch.uint8)
    n = s.numel()
    if n == 0:
        return
    stream = torch.cuda.current_stream(src.device if src.is_cuda
                                       else dst.device)
    bufs = [torch.empty(min(_CHUNK, n), dtype=torch.uint8, pin_memory=True)
            for _ in range(2)]
    done = [torch.cuda.Event(), torch.cuda.Event()]
    spans = [(lo, min(_CHUNK, n - lo)) for lo in range(0, n, _CHUNK)]
    if dst.device.type == "cpu":  # card -> host
        def drain(j: int) -> None:
            lo, m = spans[j]
            done[j % 2].synchronize()
            d[lo:lo + m].copy_(bufs[j % 2][:m])

        for i, (lo, m) in enumerate(spans):
            # buffer i % 2 held chunk i - 2, drained at the last iteration
            bufs[i % 2][:m].copy_(s[lo:lo + m], non_blocking=True)
            done[i % 2].record(stream)
            if i:
                drain(i - 1)
        drain(len(spans) - 1)
    else:  # host -> card
        for i, (lo, m) in enumerate(spans):
            if i >= 2:  # the DMA of chunk i - 2 has left buffer i % 2
                done[i % 2].synchronize()
            bufs[i % 2][:m].copy_(s[lo:lo + m])
            d[lo:lo + m].copy_(bufs[i % 2][:m], non_blocking=True)
            done[i % 2].record(stream)
        for e in done:
            e.synchronize()


def _to_host(leaf):
    """A shard leaf as the host payload ``PMemObjectStore.put`` writes."""
    if not isinstance(leaf, torch.Tensor):
        return leaf
    if leaf.device.type == "cpu":
        return leaf.detach()
    out = torch.empty(leaf.shape, dtype=leaf.dtype)
    _copy_staged(leaf.detach().contiguous(), out)
    return out


def _to_device(host, device: torch.device) -> torch.Tensor:
    """A leaf read from pmem (an owned numpy array, or a CPU tensor for
    bf16) as a tensor on ``device``."""
    t = host if isinstance(host, torch.Tensor) else torch.from_numpy(host)
    if device.type == "cpu":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    _copy_staged(t.contiguous(), out)
    return out


def _read_ahead(reads: List, depth: int = 4):
    """Yield ``read()`` of each callable in order, running up to
    ``depth`` of them ahead on threads: pmem reads and CRC checks are
    host copies that release the GIL, and overlap the device work."""
    with ThreadPoolExecutor(depth, thread_name_prefix="ckpt-rd") as ex:
        futs = collections.deque(ex.submit(r) for r in reads[:depth])
        for r in reads[depth:] + [None] * len(futs):
            fut = futs.popleft()
            if r is not None:
                futs.append(ex.submit(r))
            yield fut.result()


@dataclass
class ShardInfo:
    node: str
    start_row: int
    n_rows: int


def plan_shards(path: str, shape: Tuple[int, ...],
                nodes: Sequence[str]) -> List[ShardInfo]:
    n = len(nodes)
    if shape and shape[0] >= n and shape[0] % n == 0:
        rows = shape[0] // n
        return [ShardInfo(nodes[i], i * rows, rows) for i in range(n)]
    owner = nodes[zlib.crc32(path.encode()) % n]
    return [ShardInfo(owner, 0, shape[0] if shape else 1)]


@dataclass
class PreparedSave:
    """A save whose payloads are on the host, ready to commit."""
    step: int
    slot: int
    base_step: Optional[int]
    manifest: Dict[str, Any]
    payloads: Dict[str, Dict[str, Any]]


class DistributedCheckpointer:
    def __init__(self, stores: Dict[str, PMemObjectStore],
                 delta: bool = False, slots: int = 2, device="cuda"):
        self.stores = stores
        self.nodes = sorted(stores)
        self.delta = delta
        if delta and slots < 2:
            raise ValueError(
                "delta checkpointing needs slots >= 2: the full base "
                "must survive while deltas rotate through other slots")
        self.slots = slots
        self.device = resolve_device(device)
        self._slot_counter: Optional[int] = None
        self._ack_lock = threading.Lock()
        self._ack_log: Optional[MetaLog] = None
        # step -> slot, so delta saves find the base slot without
        # re-reading its manifest; _slot_pin protects the active base
        self._slot_cache: Dict[int, int] = {}
        self._slot_pin: Optional[int] = None

    # ------------------------------------------------------------------
    def _meta_put_json(self, name: str, obj) -> None:
        """Replicate small metadata (manifests, latest-pointer) to every
        live node's pool."""
        wrote = 0
        for nid in self._live_nodes():
            try:
                self.stores[nid].pool.put_json(name, obj)
                wrote += 1
            except IOError:
                continue
        if not wrote:
            raise IOError(f"no reachable pool for metadata {name}")

    @metadata_only
    def _meta_get_json(self, name: str):
        """Resolve metadata across all reachable pools: the copy with the
        highest ``step`` (then newest ``ts``) wins, ack maps of that
        incarnation are union-merged."""
        copies: List[dict] = []
        err: Optional[Exception] = None
        for nid in self.nodes:
            try:
                copies.append(self.stores[nid].pool.get_json(name))
            except (IOError, FileNotFoundError, ValueError) as e:
                err = e
        if not copies:
            raise err if err is not None else FileNotFoundError(name)

        def rank(c) -> Tuple[float, float]:
            step = c.get("step") if isinstance(c, dict) else None
            ts = c.get("ts") if isinstance(c, dict) else None
            return (step if isinstance(step, (int, float)) else float("-inf"),
                    ts if isinstance(ts, (int, float)) else float("-inf"))

        best = max(copies, key=rank)
        if isinstance(best, dict) and isinstance(best.get("acks"), dict):
            best_rank = rank(best)
            best = dict(best)
            best["acks"] = _merge_acks(
                [c["acks"] for c in copies if isinstance(c, dict)
                 and isinstance(c.get("acks"), dict)
                 and rank(c) == best_rank])
        return best

    def _alloc_slot(self, avoid: Optional[int] = None) -> int:
        """Round-robin slot rotation from a per-save ordinal (initialised
        from the last committed manifest), never onto ``avoid``, the slot
        of the active delta base."""
        if self._slot_counter is None:
            step = self.latest_step()
            if step is None:
                self._slot_counter = 0
            else:
                try:
                    last = self._meta_get_json(
                        f"ckpt/manifest_step{step}.json")["slot"]
                except (IOError, FileNotFoundError, KeyError):
                    last = -1
                self._slot_counter = (last + 1) % self.slots
        slot = self._slot_counter
        if avoid is not None and slot == avoid:
            slot = (slot + 1) % self.slots
        self._slot_counter = (slot + 1) % self.slots
        return slot

    def _live_nodes(self) -> List[str]:
        live = [n for n in self.nodes
                if getattr(self.stores[n].pool, "alive", True)]
        return live or self.nodes

    # ------------------------------------------------------------------
    def save(self, step: int, tree, *, base_step: Optional[int] = None,
             drain: bool = False) -> dict:
        """Write one checkpoint of ``tree`` (tensors on any device, or
        numpy). ``base_step`` enables delta encoding against that step's
        full checkpoint. Returns the global manifest."""
        return self.commit(self.prepare(step, tree, base_step=base_step,
                                        drain=drain))

    def prepare(self, step: int, tree, *, base_step: Optional[int] = None,
                drain: bool = False) -> PreparedSave:
        """The device phase of a save: slot, manifest and every node's
        host payload. Holds no reference to ``tree`` once it returns."""
        if drain:
            raise NotImplementedError(
                "drain to the external store is not ported (ROADMAP Queue "
                "A item 2: replication, drain and repair)")
        leaves = _flatten(tree)
        delta = base_step is not None and self.delta
        avoid = None
        if delta:
            with self._ack_lock:
                avoid = self._slot_cache.get(base_step)
            if avoid is None:
                avoid = self._meta_get_json(
                    f"ckpt/manifest_step{base_step}.json")["slot"]
                with self._ack_lock:
                    self._slot_cache[base_step] = avoid
        slot = self._alloc_slot(avoid)
        ring = self._live_nodes()
        manifest: Dict[str, Any] = {
            "step": step, "slot": slot, "ts": time.time(),
            "delta_base": base_step, "leaves": {}, "nodes": ring}
        per_node: Dict[str, Dict[str, Any]] = {nid: {} for nid in ring}
        for path, arr in leaves:
            shape = tuple(arr.shape)
            shards = plan_shards(path, shape, ring)
            manifest["leaves"][path] = {
                "shape": list(shape), "dtype": _dtype_tag(arr),
                "shards": [[s.node, s.start_row, s.n_rows] for s in shards]}
            for s in shards:
                per_node[s.node][path] = \
                    arr[s.start_row:s.start_row + s.n_rows] if shape else arr
        del leaves, tree
        payloads = {}
        for nid in ring:
            part = per_node.pop(nid)
            payloads[nid] = self._encode_delta(nid, part, base_step, avoid) \
                if delta else {p: _to_host(a) for p, a in part.items()}
            del part
        return PreparedSave(step, slot, base_step if delta else None,
                            manifest, payloads)

    def commit(self, prep: PreparedSave) -> dict:
        """Write every node's payload to its own pool (one thread a node),
        then commit the manifest. Returns the global manifest."""
        obj = f"ckpt/slot{prep.slot}"
        ring = prep.manifest["nodes"]

        def write(nid: str) -> None:
            self.stores[nid].put(obj, prep.payloads.pop(nid), version=0,
                                 meta={"step": prep.step})

        with ThreadPoolExecutor(len(ring), thread_name_prefix="ckpt-wr") \
                as ex:
            for fut in [ex.submit(write, nid) for nid in ring]:
                fut.result()
        step, manifest = prep.step, prep.manifest
        # commit point after all node writes are flushed
        self._meta_put_json(f"ckpt/manifest_step{step}.json", manifest)
        self._meta_put_json("ckpt/latest.json",
                            {"step": step, "ts": manifest["ts"]})
        with self._ack_lock:
            # seed (and reset) the step's ack record
            self._acklog().append(
                {"op": "seed", "step": step, "ts": manifest["ts"],
                 "ring": ring, "delta_base": manifest["delta_base"]})
            self._slot_cache[step] = prep.slot
            self._slot_pin = prep.base_step if prep.base_step is not None \
                else step
            extra = [k for k in sorted(self._slot_cache)
                     if k != self._slot_pin]
            while len(self._slot_cache) > max(self.slots, 2) + 1 and extra:
                self._slot_cache.pop(extra.pop(0))
        return manifest

    # ---- per-node acknowledgement map --------------------------------
    def _acklog(self) -> MetaLog:
        if self._ack_log is None:
            self._ack_log = MetaLog(self.stores, self.nodes, "ckpt/ackslog",
                                    fold=_fold_ckpt_acks)
        return self._ack_log

    def record_ack(self, step: int, nid: str, kind: str,
                   info: Optional[dict] = None) -> None:
        """Record one completed replicate ("replica") or drain ("drain")
        for ``nid`` at ``step``: one entry appended to the ack log."""
        rec = dict(info or {})
        rec["ts"] = time.time()
        with self._ack_lock:
            self._acklog().append({"op": "ack", "step": step, "nid": nid,
                                   "kind": kind, "rec": rec})

    @metadata_only
    def ack_record(self, step: int) -> Optional[dict]:
        """The step's ack record from the log's folded state (None when
        the step never seeded one)."""
        return self._acklog().state().get(str(step))

    @metadata_only
    def acks(self, step: int) -> Dict[str, Dict[str, dict]]:
        """The merged per-node ack map for ``step`` ({} if unknown)."""
        rec_map = self.ack_record(step)
        if rec_map is None:
            return {}
        return dict(rec_map.get("acks") or {})

    def wait_async(self) -> None:
        """Join pending post-commit replicate/drain work: none is queued
        until the replication channel is ported (ROADMAP Queue A item 2),
        so this returns at once."""

    # ------------------------------------------------------------------
    def _encode_delta(self, nid: str, payload: Dict[str, Any],
                      base_step: int, base_slot: int) -> Dict[str, Any]:
        """One node's shards -> host payload of codes and scales against
        its base shard (step-checked), encoded on the card leaf by leaf
        while the next base leaves are read ahead. A leaf whose base is
        missing or of another shape is stored raw."""
        store = self.stores[nid]
        name = f"ckpt/slot{base_slot}"
        self._check_slot_step(store, name, base_step)
        base_man = store.manifest(name)
        paths = [p for p, a in payload.items()
                 if p in base_man["leaves"] and
                 tuple(base_man["leaves"][p]["shape"]) == tuple(a.shape)]
        out = {p: _to_host(a) for p, a in payload.items() if p not in paths}
        reads = [functools.partial(store.get_leaf, name, p, verify=False,
                                   man=base_man) for p in paths]
        for path, host in zip(paths, _read_ahead(reads)):
            base = _to_device(host, self.device)
            q, scale = codec.delta_encode(
                to_torch(payload[path], self.device).contiguous(), base)
            del base
            out[path + ".__dq"] = _to_host(q)
            out[path + ".__ds"] = _to_host(scale)
        return out

    def _decode_delta(self, q, scale, base, dtype: str) -> torch.Tensor:
        """One delta shard leaf, read from pmem, decoded on the card
        against its base shard (same shape) into the leaf's dtype."""
        base = _to_device(base, self.device)
        return codec.delta_decode(_to_device(q, self.device),
                                  _to_device(scale, self.device), base,
                                  shape=tuple(base.shape),
                                  dtype=_torch_dtype(dtype))

    # ------------------------------------------------------------------
    @metadata_only
    def latest_step(self) -> Optional[int]:
        try:
            return self._meta_get_json("ckpt/latest.json")["step"]
        except (IOError, FileNotFoundError):
            return None

    @metadata_only
    def available_steps(self) -> List[int]:
        """All committed checkpoint steps (manifest present on any
        reachable node), ascending."""
        steps = set()
        prefix, suffix = "ckpt/manifest_step", ".json"
        for nid in self.nodes:
            for name in self.stores[nid].pool.list("ckpt/"):
                if name.startswith(prefix) and name.endswith(suffix):
                    steps.add(int(name[len(prefix):-len(suffix)]))
        return sorted(steps)

    @staticmethod
    def _check_slot_step(store: PMemObjectStore, name: str,
                         step: int) -> None:
        """A manifest can point at a slot that a newer checkpoint has
        since overwritten; the per-node object records its step, and a
        mismatch fails the restore rather than mixing steps."""
        got = store.manifest(name).get("meta", {}).get("step")
        if got != step:
            raise IOError(
                f"{name} holds step {got}, wanted {step} (slot reused)")

    def restore(self, step: Optional[int] = None, *,
                lost_nodes: Sequence[str] = ()):
        """Reassemble the global tree on the device: (tree, manifest).
        Full shards are read leaf by leaf (CRC-verified byte ranges);
        delta shards are decoded on the card against their base."""
        if lost_nodes:
            raise NotImplementedError(_LOST_NODES)
        if step is None:
            step = self.latest_step()
        manifest = self._meta_get_json(f"ckpt/manifest_step{step}.json")
        return _unflatten(self._assemble(step, manifest)), manifest

    def _assemble(self, step: int, manifest: dict) -> Dict[str, Any]:
        """Every leaf's shards read from their nodes' pmem (read ahead,
        CRC-verified against one step-checked manifest snapshot a node),
        brought to the device, delta shards decoded there against their
        base, and concatenated along dim 0."""
        obj = f"ckpt/slot{manifest['slot']}"
        ring = manifest.get("nodes") or self.nodes
        obj_mans, base = {}, None
        for nid in ring:
            man = self.stores[nid].manifest(obj)
            got = man.get("meta", {}).get("step")
            if got != step:
                raise IOError(f"{obj} holds step {got}, wanted {step} "
                              f"(slot reused)")
            obj_mans[nid] = man
        if manifest.get("delta_base") is not None and self.delta:
            bstep = manifest["delta_base"]
            bname = "ckpt/slot" + str(self._meta_get_json(
                f"ckpt/manifest_step{bstep}.json")["slot"])
            base = {}
            for nid in ring:
                self._check_slot_step(self.stores[nid], bname, bstep)
                base[nid] = (bname, self.stores[nid].manifest(bname))

        def read(path: str, nid: str):
            store, man = self.stores[nid], obj_mans[nid]
            if base is None or path + ".__dq" not in man["leaves"]:
                return (store.get_leaf(obj, path, man=man),)
            bname, bman = base[nid]
            return (store.get_leaf(obj, path + ".__dq", man=man),
                    store.get_leaf(obj, path + ".__ds", man=man),
                    store.get_leaf(bname, path, verify=False, man=bman))

        work = [(path, nid) for path, ent in manifest["leaves"].items()
                for nid, _s, _n in ent["shards"]]
        parts: Dict[str, List[torch.Tensor]] = collections.defaultdict(list)
        for (path, nid), host in zip(work, _read_ahead(
                [functools.partial(read, p, n) for p, n in work])):
            dtype = manifest["leaves"][path]["dtype"]
            parts[path].append(_to_device(host[0], self.device)
                               if len(host) == 1 else
                               self._decode_delta(*host, dtype))
        leaves = {}
        for path, ent in manifest["leaves"].items():
            ps = parts.pop(path)
            whole = ps[0] if len(ps) == 1 else torch.cat(ps, 0)
            del ps
            leaves[path] = whole.reshape(tuple(ent["shape"])).to(
                _torch_dtype(ent["dtype"]))
        return leaves

    # ---- lost-node paths: the replication slice ----------------------
    def restore_latest_recoverable(self, *, lost_nodes: Sequence[str] = (),
                                   use_acks: bool = True):
        raise NotImplementedError(_LOST_NODES)

    def restore_leaves(self, step: int, paths: Sequence[str], *,
                       lost_nodes: Sequence[str] = ()):
        raise NotImplementedError(_LOST_NODES)

    def restore_shard(self, step: int, path: str, start_row: int,
                      n_rows: int, *, lost_nodes: Sequence[str] = ()):
        raise NotImplementedError(_LOST_NODES)

    def _locate_shard(self, *args, **kwargs):
        raise NotImplementedError(_LOST_NODES)

    def _drained_leaves(self, nid: str, step: int):
        raise NotImplementedError(_LOST_NODES)


def _torch_dtype(tag: str) -> torch.dtype:
    return getattr(torch, tag)
