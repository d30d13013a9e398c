"""Distributed node-local checkpointing on B-APM (paper §V item 8 + §III).

PyTorch counterpart of ``repro/core/checkpoint.py``: every node writes
only its own shards to its own pmem pool, two or more shadow slots
rotate under an atomic manifest commit, and a delta checkpoint stores ``int8 round((new - base) / scale)`` per
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
tensors on the checkpointer's device. The codec kernels take float32,
bfloat16 and int32: a leaf of another dtype (the int8 codes of the int8
AdamW moments) goes through the codec as int32 (or float32) and is cast
back after the decode, which truncates toward zero and wraps as JAX's
``astype`` of the float32 decode does.

With a ``scheduler`` and ``buddy`` (the defaults of ``SimCluster``), every
commit hands its manifest to the TieredIO ``ReplicationChannel``, which
copies each node's slot object to its ring buddy and records a per-node
ack when the copy is durable, so a save's durability reaches
``"REPLICATED"``; a save with ``drain=True`` and an ``external`` store
also drains each node's slot object and reaches ``"DRAINED"``.

Restores around lost nodes (``restore(lost_nodes=)``,
``restore_leaves``, ``restore_shard``) read a dead node's shard from an
ack-recorded replica holder, then its ring buddy, then its acked drained
copy, and decode a delta step's shards against a base found the same
way, on the device, wherever they were read.
``restore_latest_recoverable`` ranks steps by their acks first and
probes only the plausible ones (``last_restore_stats``).
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
from repro_torch.core.dataset_exchange import ack_targets
from repro_torch.core.meta_log import MetaLog
from repro_torch.core.object_store import (BF16_TAG, PMemObjectStore,
                                           SupersededError, _flatten,
                                           _unflatten, is_wire_object,
                                           wire_leaves)
from repro_torch.kernels.ckpt_codec import ops as codec
from repro_torch.obs.metrics import Registry, StatsView

TILE = 1024

#: the dtypes the codec kernels read and write
_CODEC_DTYPES = (torch.float32, torch.bfloat16, torch.int32)


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


def _codec_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a leaf goes through the codec in: its own, or float32 /
    int32 (exact for int8 codes and a step counter)."""
    if dtype in _CODEC_DTYPES:
        return dtype
    return torch.float32 if dtype.is_floating_point else torch.int32


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
    drain: bool = False


class DistributedCheckpointer:
    def __init__(self, stores: Dict[str, PMemObjectStore],
                 scheduler=None, external=None, buddy: bool = True,
                 delta: bool = False, slots: int = 2, device="cuda"):
        self.stores = stores
        self.nodes = sorted(stores)
        self.scheduler = scheduler
        self.external = external
        self.buddy = buddy
        self.delta = delta
        if delta and slots < 2:
            raise ValueError(
                "delta checkpointing needs slots >= 2: the full base "
                "must survive while deltas rotate through other slots")
        self.slots = slots
        self.device = resolve_device(device)
        self._pending: List = []
        self._slot_counter: Optional[int] = None
        # replicate fan-out is owned by a TieredIO ReplicationChannel
        # (attached by the engine, or created lazily for standalone use);
        # its ack writes serialise on this lock
        self.replication = None
        self._ack_lock = threading.Lock()
        self._ack_log: Optional[MetaLog] = None
        # step -> slot, so delta saves find the base slot without
        # re-reading its manifest; _slot_pin protects the active base
        self._slot_cache: Dict[int, int] = {}
        self._slot_pin: Optional[int] = None
        # restore-scan counters (reset per restore_latest_recoverable
        # call), read through ``last_restore_stats``
        reg = Registry()
        self._restore_counters = {
            "skipped_by_ack": reg.counter("restore.skipped_by_ack"),
            "probed": reg.counter("restore.probed")}
        self.last_restore_stats = StatsView(self._restore_counters)

    # ------------------------------------------------------------------
    def _meta_store(self) -> PMemObjectStore:
        return self.stores[self.nodes[0]]

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

    def buddy_of(self, nid: str, ring: Optional[Sequence[str]] = None
                 ) -> str:
        ring = list(ring) if ring else self.nodes
        i = ring.index(nid)
        return ring[(i + 1) % len(ring)]

    def _live_nodes(self) -> List[str]:
        live = [n for n in self.nodes
                if getattr(self.stores[n].pool, "alive", True)]
        return live or self.nodes

    # ------------------------------------------------------------------
    def save(self, step: int, tree, *, base_step: Optional[int] = None,
             drain: bool = False,
             post_commit: Optional[List] = None) -> dict:
        """Write one checkpoint of ``tree`` (tensors on any device, or
        numpy). ``base_step`` enables delta encoding against that step's
        full checkpoint; ``drain`` also drains every node's slot object
        to the external store. Returns the global manifest. The
        post-commit replicate and drain futures go to ``post_commit``
        when given (the TieredIO engine tracks them per save ticket),
        else to the list that ``wait_async`` joins."""
        return self.commit(self.prepare(step, tree, base_step=base_step,
                                        drain=drain),
                           post_commit=post_commit)

    def prepare(self, step: int, tree, *, base_step: Optional[int] = None,
                drain: bool = False) -> PreparedSave:
        """The device phase of a save: slot, manifest and every node's
        host payload. Holds no reference to ``tree`` once it returns."""
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
                            manifest, payloads, drain)

    def commit(self, prep: PreparedSave,
               post_commit: Optional[List] = None) -> dict:
        """Write every node's payload to its own pool (one thread a node),
        then commit the manifest and queue the buddy replicas (see
        ``save``). Returns the global manifest."""
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
        # post-commit work (never blocks the step loop): the replicate
        # and drain fan-out lives in the TieredIO replication channel,
        # which records per-node acks into the ack log
        sink = self._pending if post_commit is None else post_commit
        chan = self._replication_channel()
        if chan is not None:
            chan.submit(manifest, drain=prep.drain, sink=sink)
        return manifest

    def _replication_channel(self):
        """The attached TieredIO ReplicationChannel, or a lazily-made
        default one so a standalone checkpointer still replicates with
        acks. Imported here: tiered_io imports this module."""
        if self.replication is None and self.scheduler is not None:
            from repro_torch.core.tiered_io import ReplicationChannel
            self.replication = ReplicationChannel(self, self.scheduler)
        return self.replication

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
        """Join pending post-commit replicate work, raising real errors.
        A ``SupersededError`` is benign here: the source slot was reused
        by a NEWER save before the queued transfer read it, and that save
        queued its own replicate."""
        for f in self._pending:
            try:
                f.result()
            except SupersededError:
                pass
        self._pending = []

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
            new = to_torch(payload[path], self.device)
            dt = _codec_dtype(new.dtype)
            q, scale = codec.delta_encode(new.to(dt).contiguous(),
                                          base.to(_codec_dtype(base.dtype)))
            del base, new
            out[path + ".__dq"] = _to_host(q)
            out[path + ".__ds"] = _to_host(scale)
        return out

    def _decode_delta(self, q, scale, base, dtype: str) -> torch.Tensor:
        """One delta shard leaf, read from pmem, decoded on the card
        against its base shard (same shape) into the leaf's dtype."""
        base = _to_device(base, self.device)
        want = _torch_dtype(dtype)
        out = codec.delta_decode(_to_device(q, self.device),
                                 _to_device(scale, self.device),
                                 base.to(_codec_dtype(base.dtype)),
                                 shape=tuple(base.shape),
                                 dtype=_codec_dtype(want))
        return out.to(want)

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

    def restore_latest_recoverable(self, *, lost_nodes: Sequence[str] = (),
                                   use_acks: bool = True):
        """Walk committed steps newest-first and restore the first one
        whose shards (or their replicas or drained copies, for
        ``lost_nodes``) are all readable. With ``use_acks`` a step whose
        acks show a lost shard owner without a surviving replica or a
        drain is skipped on metadata alone, without a store read;
        ``last_restore_stats`` records the skipped/probed split."""
        last_err: Optional[Exception] = None
        stats = self._restore_counters
        for c in stats.values():
            c.set(0)
        for step in reversed(self.available_steps()):
            if use_acks and lost_nodes and \
                    not self._acks_plausible(step, lost_nodes):
                stats["skipped_by_ack"].inc()
                continue
            stats["probed"].inc()
            try:
                return self.restore(step, lost_nodes=lost_nodes)
            except (IOError, FileNotFoundError, KeyError) as e:
                last_err = e
        raise IOError(
            f"no recoverable checkpoint with lost_nodes={list(lost_nodes)}"
        ) from last_err

    @metadata_only
    def _acks_plausible(self, step: int,
                        lost_nodes: Sequence[str]) -> bool:
        """Metadata-only recoverability check: every lost node that held
        shards at ``step`` has an acked replica on a surviving node, or
        an acked drain to the external store, and so has the delta base
        chain. A step without an ack record stays plausible (the probing
        restore decides)."""
        rec_map = self.ack_record(step)
        if rec_map is None:
            return True
        ring = rec_map.get("ring") or self.nodes
        acks = rec_map.get("acks") or {}
        for nid in lost_nodes:
            if nid not in ring:
                continue  # held no shards at this step
            if acks.get(nid, {}).get("drain") and self.external is not None:
                continue  # the drained copy outlives any pmem loss
            targets = ack_targets(acks.get(nid, {}).get("replica"))
            if not targets:
                return False  # died between commit and replica ack
            if all(t in lost_nodes for t in targets):
                return False  # every acked replica on another dead node
        base = rec_map.get("delta_base")
        if base is not None and base < step:  # bases are strictly older
            return self._acks_plausible(base, lost_nodes)
        return True

    def restore(self, step: Optional[int] = None, *,
                lost_nodes: Sequence[str] = ()):
        """Reassemble the global tree on the device: (tree, manifest).
        Full shards are read leaf by leaf (CRC-verified byte ranges);
        delta shards are decoded on the card against their base. A lost
        node's shard (and its base) comes from a replica or the drained
        copy (``_locate_shard``, ``_drained_leaves``)."""
        if step is None:
            step = self.latest_step()
        manifest = self._meta_get_json(f"ckpt/manifest_step{step}.json")
        leaves = self._assemble(step, manifest, None, lost_nodes)
        return _unflatten(leaves), manifest

    def restore_leaves(self, step: int, paths: Sequence[str], *,
                       lost_nodes: Sequence[str] = ()
                       ) -> Dict[str, torch.Tensor]:
        """Partial restore: ONLY the named leaves, as a flat ``{path:
        tensor}`` on the device, each read from whichever tier holds its
        shards; sibling leaves are never read."""
        manifest = self._meta_get_json(f"ckpt/manifest_step{step}.json")
        missing = set(paths) - set(manifest["leaves"])
        if missing:
            raise KeyError(f"step {step} has no leaves {sorted(missing)}")
        return self._assemble(step, manifest, set(paths), lost_nodes)

    def _assemble(self, step: int, manifest: dict,
                  paths: Optional[set] = None,
                  lost_nodes: Sequence[str] = ()) -> Dict[str, Any]:
        """Every wanted leaf's shards read from where they live (read
        ahead, CRC-verified against one step-checked manifest snapshot a
        holder), brought to the device, delta shards decoded there
        against their base, and concatenated along dim 0."""
        obj = f"ckpt/slot{manifest['slot']}"
        ring = manifest.get("nodes") or self.nodes
        acks = self.acks(step) if lost_nodes else {}
        want = {path: ent for path, ent in manifest["leaves"].items()
                if paths is None or path in paths}
        need = [nid for nid in ring
                if any(nid == sh[0] for ent in want.values()
                       for sh in ent["shards"])]
        src = {}
        for nid in need:
            s = self._locate_shard(nid, obj, step, acks, ring, lost_nodes)
            if s is None:
                # drain-tier recovery: the shard and its replicas died;
                # the recorded drain ack says an external copy exists
                flat = self._drained_leaves(nid, step)
                if flat is None:
                    raise IOError(
                        f"no replica of {nid} on {self.buddy_of(nid, ring)}"
                        f" and no acknowledged drain for step {step}")
                s = ("flat", flat)
            src[nid] = s
        base = {}
        if manifest.get("delta_base") is not None and self.delta:
            bstep = manifest["delta_base"]
            bman = self._meta_get_json(f"ckpt/manifest_step{bstep}.json")
            base = {nid: self._base_source(nid, bstep, bman, lost_nodes)
                    for nid in need}

        def read(path: str, nid: str):
            s = src[nid]
            if not base or path + ".__dq" not in _names(s):
                return (_read_leaf(self.stores, s, path),)
            return (_read_leaf(self.stores, s, path + ".__dq"),
                    _read_leaf(self.stores, s, path + ".__ds"),
                    _read_leaf(self.stores, base[nid], path, verify=False))

        work = [(path, nid) for path, ent in want.items()
                for nid, _s, _n in ent["shards"]]
        parts: Dict[str, List[torch.Tensor]] = collections.defaultdict(list)
        for (path, nid), host in zip(work, _read_ahead(
                [functools.partial(read, p, n) for p, n in work])):
            dtype = manifest["leaves"][path]["dtype"]
            parts[path].append(_to_device(host[0], self.device)
                               if len(host) == 1 else
                               self._decode_delta(*host, dtype))
        leaves = {}
        for path, ent in want.items():
            ps = parts.pop(path)
            whole = ps[0] if len(ps) == 1 else torch.cat(ps, 0)
            del ps
            leaves[path] = whole.reshape(tuple(ent["shape"])).to(
                _torch_dtype(ent["dtype"]))
        return leaves

    def _locate_shard(self, nid: str, obj: str, step: int, acks: dict,
                      ring: Sequence[str],
                      lost_nodes: Sequence[str]) -> Optional[tuple]:
        """The pmem holder of ``nid``'s shard as ``("pmem", holder, name,
        manifest)``: the node's own slot, or for a lost node a replica
        from the ack-recorded targets (repair may have moved it off the
        ring buddy), then the ring buddy. The holder's object manifest is
        read once and step-checked. None when every pmem copy is gone
        (the caller consults the drain tier)."""
        if nid not in lost_nodes:
            man = self.stores[nid].manifest(obj)
            got = man.get("meta", {}).get("step")
            if got != step:
                raise IOError(f"{obj} holds step {got}, wanted {step} "
                              f"(slot reused)")
            return ("pmem", nid, obj, man)
        name = f"replica/{nid}/{obj}"
        cands = [t for t in ack_targets(acks.get(nid, {}).get("replica"))
                 if t not in lost_nodes]
        legacy = self.buddy_of(nid, ring)
        if legacy not in cands and legacy not in lost_nodes:
            cands.append(legacy)
        for holder in cands:
            try:
                if self.stores[holder].exists(name):
                    man = self.stores[holder].manifest(name)
                    got = man.get("meta", {}).get("step")
                    if got != step:
                        raise IOError(f"{name} holds step {got}, wanted "
                                      f"{step} (slot reused)")
                    return ("pmem", holder, name, man)
            except IOError:
                continue  # that holder's pool died too
        return None

    def _base_source(self, nid: str, base_step: int, base_man: dict,
                     lost_nodes: Sequence[str] = ()) -> tuple:
        """Where a delta chain's base shard of ``nid`` lives, walking the
        shard's own tiers: the node's slot, then the ack-recorded
        replica holders with the base ring's buddy last, then the acked
        drained copy."""
        base_name = f"ckpt/slot{base_man['slot']}"
        if nid not in lost_nodes:
            store = self.stores[nid]
            self._check_slot_step(store, base_name, base_step)
            return ("pmem", nid, base_name, store.manifest(base_name))
        rep = f"replica/{nid}/{base_name}"
        cands = [t for t in ack_targets(self.acks(base_step)
                                        .get(nid, {}).get("replica"))
                 if t not in lost_nodes]
        legacy = self.buddy_of(nid, base_man.get("nodes") or self.nodes)
        if legacy not in cands and legacy not in lost_nodes:
            cands.append(legacy)
        for holder in cands:
            try:
                if self.stores[holder].exists(rep):
                    self._check_slot_step(self.stores[holder], rep,
                                          base_step)
                    return ("pmem", holder, rep,
                            self.stores[holder].manifest(rep))
            except IOError:
                continue  # holder pool unreadable too: keep walking
        drained = self._drained_leaves(nid, base_step)
        if drained is not None:
            return ("flat", drained)
        raise IOError(f"no readable base (step {base_step}) for {nid}: "
                      f"pmem lost, replica lost, no drain ack")

    def _drained_leaves(self, nid: str,
                        step: int) -> Optional[Dict[str, Any]]:
        """The external drained copy of ``nid``'s shard at ``step`` as
        flat host leaves, consulted only when the recorded drain ack says
        it exists (no blind external probes); None otherwise. A wire
        payload is CRC-verified and its encoded leaves decoded on the
        checkpointer's device; a pickled tree flattens."""
        if self.external is None:
            return None
        rec = self.acks(step).get(nid, {}).get("drain")
        if not rec:
            return None
        ext = rec.get("external") or f"ckpt_step{step}_{nid}"
        try:
            obj = self.external.get(ext)
        except (IOError, OSError, FileNotFoundError):
            return None
        if is_wire_object(obj):
            return wire_leaves(obj, device=self.device)
        return dict(_flatten(obj))

    def restore_shard(self, step: int, path: str, start_row: int,
                      n_rows: int, *,
                      lost_nodes: Sequence[str] = ()) -> torch.Tensor:
        """Elastic restore primitive: rows [start_row, start_row +
        n_rows) of one leaf, read as byte ranges from the owning nodes'
        pmem (a dead owner's rows from its ack-recorded replica, only
        the covering tiles decoded when it is encoded, or from its
        drained copy), on the device."""
        manifest = self._meta_get_json(f"ckpt/manifest_step{step}.json")
        ent = manifest["leaves"][path]
        obj = f"ckpt/slot{manifest['slot']}"
        ring = manifest.get("nodes") or self.nodes
        acks = self.acks(step) if lost_nodes else {}
        pieces = []
        want_lo, want_hi = start_row, start_row + n_rows
        for nid, s0, nr in ent["shards"]:
            lo, hi = max(want_lo, s0), min(want_hi, s0 + nr)
            if lo >= hi:
                continue
            s = self._locate_shard(nid, obj, step, acks, ring, lost_nodes)
            if s is not None:
                _, holder, name, _man = s
                piece = self.stores[holder].read_leaf_slice(
                    name, path, lo - s0, hi - lo)
            else:
                flat = self._drained_leaves(nid, step)
                if flat is None:
                    raise IOError(
                        f"no copy of {nid}'s rows [{lo}, {hi}) for step "
                        f"{step}: pmem lost, replica lost, no drain ack")
                piece = flat[path][lo - s0:hi - s0]
            pieces.append(_to_device(piece, self.device))
        return torch.cat(pieces, 0).to(_torch_dtype(ent["dtype"]))


def _names(source: tuple):
    """The leaf names a shard source holds."""
    return source[3]["leaves"] if source[0] == "pmem" else source[1]


def _read_leaf(stores, source: tuple, path: str, verify: bool = True):
    """One leaf of a shard source: a byte-range read against the
    holder's manifest snapshot, or the drained copy's leaf."""
    if source[0] == "flat":
        return source[1][path]
    _, holder, name, man = source
    return stores[holder].get_leaf(name, path, verify=verify, man=man)


def _torch_dtype(tag: str) -> torch.dtype:
    return getattr(torch, tag)
