"""Cost analysis of one eager call: FLOPs, bytes, collectives, peak memory.

PyTorch counterpart of ``repro/launch/hlo_analysis.py``, which reads the
same quantities off XLA's optimized HLO. Here a ``TorchDispatchMode``
sees every aten op the call runs, on any device (``meta`` included), and
accumulates, per rank (every number is this process's, as the HLO
module's are per device):

  flops        - 2 * M * N * K per product (``torch.utils.flop_counter``'s
                 formulas, which take JAX's rule), plus what a hand-written
                 kernel reports through ``record_kernel`` (a launch through
                 ctypes is invisible to a dispatch mode)
  bytes        - operand bytes plus output bytes of every op that is no
                 view and no bare allocation. Eager PyTorch fuses nothing,
                 so this is JAX's ``bytes_unfused``, and ``bytes`` is the
                 same number: no fused estimate is made.
  collectives  - every hop of ``distributed/compat``'s collectives, under
                 JAX's kind names, its result bytes and JAX's ring-model
                 wire bytes over the hop's real group size
  peak_bytes   - the largest number of live storage bytes during the call:
                 the storages of ``held`` (the arguments a rank holds)
                 plus every storage an op creates, freed when the storage
                 dies (weak references to the storages, as
                 ``torch.distributed._tools.mem_tracker`` keeps them; a
                 storage counts once however many views it has). On a
                 card, sizes round up to the allocator's 512-byte blocks.

Each op is tagged by JAX's ``TAGS`` (attention, norm, loss, moe, ssm,
other) from the names of the Python functions on the stack and of the
op; an op the autograd engine runs in the backward pass takes the tag of
the forward op whose output its node differentiates.

On ``meta`` tensors a functional op (no view, no mutation) of inputs
whose shapes, strides and dtypes it has seen before is not run again:
its outputs are made empty with the shapes, strides and dtypes the first
run gave (``FakeTensorMode``'s dispatch cache does the same), which
saves the meta kernels' time on the repeated layers and blocks. The op
is still dispatched, counted and tagged as each run.

No trip-count recovery: XLA's cost analysis visits a ``while`` body once,
so JAX's analyzer scales each body by its loop's trip count; the port
runs every loop iteration eagerly (layers, microbatches, attention
blocks, cross-entropy chunks, the backward's recomputation), so each op
is counted as often as it runs.
"""
from __future__ import annotations

import json
import sys
import weakref
from collections import Counter
from pathlib import Path
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast", "reduce")
#: ``compat``'s kinds -> JAX's collective names (broadcast and reduce:
#: the port's own, for FSDP's layers of a stack cut on its layer dim)
KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
         "send_recv": "collective-permute", "broadcast": "broadcast",
         "reduce": "reduce"}
TAGS = (("attention", ("per_q_block", "kv_step", "_online_block",
                       "local_attention", "blockwise_attention",
                       "naive_attention", "attend", "_partial_attend")),
        ("norm", ("rms_norm", "layer_norm")),
        ("loss", ("chunked_ce", "log_softmax", "logsumexp")),
        ("moe", ("moe", "_dispatch", "_combine", "_expert_ffn", "router")),
        ("ssm", ("ssd", "rglru")))
#: ops that allocate and write nothing (their bytes are not traffic)
_ALLOCS = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                     "new_empty_strided"})
#: ops that return an alias of an input without a view schema
_VIEWS = frozenset({"detach", "alias", "_unsafe_view", "lift_fresh"})
_MIN_BLOCK = 512  # the CUDA caching allocator's rounding

_ACTIVE: List["OpAnalysis"] = []


_TAG_MEMO: Dict[str, str] = {}


def _tag_of(path: str) -> str:
    tag = _TAG_MEMO.get(path)
    if tag is None:
        tag = next((t for t, keys in TAGS if any(k in path for k in keys)),
                   "other")
        _TAG_MEMO[path] = tag
    return tag


_PKG = str(Path(__file__).resolve().parents[1])


def _stack_path(depth: int = 64) -> str:
    """The names of the port's Python functions on the stack (innermost
    first; torch's own frames are left out, as JAX's op names hold the
    traced program's functions)."""
    f = sys._getframe(2)
    names = []
    while f is not None and depth:
        if f.f_code.co_filename.startswith(_PKG) and \
                f.f_code.co_filename != __file__:
            names.append(f.f_code.co_name)
        f = f.f_back
        depth -= 1
    return " ".join(names)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flat(tree, out: list) -> list:
    """The tensors of nested tuples, lists and dicts (in order)."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _flat(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _flat(x, out)
    return out


def _tensors(tree) -> List[torch.Tensor]:
    from repro_torch.distributed.compat import local_of
    return [local_of(x) for x in _flat(tree, [])]


class OpAnalysis(TorchDispatchMode):
    """Accumulates the costs of every op run while it is active."""

    def __init__(self, record_ops: bool = False):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.flops_by_tag = {t: 0.0 for t, _ in TAGS}
        self.flops_by_tag["other"] = 0.0
        self.bytes_by_tag = dict(self.flops_by_tag)
        self.collectives = {k: {"count": 0.0, "bytes": 0.0,
                                "wire_bytes": 0.0} for k in COLLECTIVES}
        self.wire_by_axis: Dict[str, float] = {}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.ops = 0
        self.registry_flops = 0.0
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, Tuple[int, weakref.ref]] = {}
        self._out_tags = None
        self.record_ops = record_ops
        self.by_op: Counter = Counter()
        self.count_by_op: Counter = Counter()
        self._meta_cache: Dict[Any, Any] = {}

    # ---- the meta-op cache ----
    @staticmethod
    def _key(x):
        """A hashable description of an argument, or raise TypeError when
        the op cannot be served from the cache."""
        if isinstance(x, torch.Tensor):
            if type(x) is not torch.Tensor or not x.is_meta:
                raise TypeError
            return (x.shape, x.stride(), x.dtype)
        if isinstance(x, (list, tuple)):
            return (type(x),) + tuple(OpAnalysis._key(v) for v in x)
        if isinstance(x, dict):
            return tuple((k, OpAnalysis._key(v)) for k, v in sorted(
                x.items()))
        if x is None or isinstance(x, (bool, int, float, str, torch.dtype,
                                       torch.device, torch.memory_format,
                                       torch.layout)):
            return (type(x), x)
        raise TypeError

    @staticmethod
    def _describe(out):
        if isinstance(out, torch.Tensor):
            if type(out) is not torch.Tensor or not out.is_meta:
                raise TypeError
            return ("T", tuple(out.shape), out.stride(), out.dtype)
        if isinstance(out, (list, tuple)):
            return (type(out), [OpAnalysis._describe(o) for o in out])
        if out is None:
            return None
        raise TypeError

    @staticmethod
    def _build(desc):
        if desc is None:
            return None
        if desc[0] == "T":
            return torch.empty_strided(desc[1], desc[2], dtype=desc[3],
                                       device="meta")
        return desc[0](OpAnalysis._build(d) for d in desc[1])

    def _call(self, func, args, kwargs):
        schema = func._schema
        if func.is_view or schema.is_mutable or any(
                r.alias_info is not None for r in schema.returns):
            return func(*args, **kwargs)
        try:
            key = (func, self._key(args), self._key(kwargs))
        except TypeError:
            return func(*args, **kwargs)
        desc = self._meta_cache.get(key)
        if desc is not None:
            return self._build(desc)
        out = func(*args, **kwargs)
        try:
            self._meta_cache[key] = self._describe(out)
        except TypeError:
            pass
        return out

    # ---- memory ----
    def _size(self, st) -> int:
        n = st.nbytes()
        if st.device.type == "cuda":
            n = -(-n // _MIN_BLOCK) * _MIN_BLOCK
        return n

    def hold(self, tree) -> int:
        """Count the storages of ``tree``'s tensors as live from now on;
        returns their bytes (each storage once)."""
        before = self.live
        for t in _tensors(tree):
            self._track(t)
        return self.live - before

    def _track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = id(st)
        if key in self._storages and self._storages[key][1]() is st:
            return
        size = self._size(st)

        def gone(_ref, key=key, size=size):
            entry = self._storages.get(key)
            if entry is not None and entry[1] is _ref:
                del self._storages[key]
                self.live -= size

        self._storages[key] = (size, weakref.ref(st, gone))
        self.live += size
        self.peak = max(self.peak, self.live)

    # ---- tags ----
    def _tag(self, func_name: str) -> str:
        tag = _tag_of(func_name + " " + _stack_path())
        if tag == "other":
            node = torch._C._current_autograd_node()
            if node is not None:
                tag = node.metadata.get("op_analysis_tag", "other")
        return tag

    def _mark_inputs(self, args) -> None:
        """Give each input's autograd node the tag of the op that made
        the input, so the backward's ops of that node take it."""
        for a in args:
            if isinstance(a, torch.Tensor) and a.grad_fn is not None:
                md = a.grad_fn.metadata
                if "op_analysis_tag" not in md:
                    tag = self._out_tags.get(a)
                    if tag is not None:
                        md["op_analysis_tag"] = tag

    # ---- accounting ----
    def add(self, name: str, tag: str, flops: float, nbytes: float,
            shape: str = "") -> None:
        self.flops += flops
        self.flops_by_tag[tag] += flops
        self.bytes += nbytes
        self.bytes_by_tag[tag] += nbytes
        if self.record_ops:
            key = (name, shape, tag)
            self.by_op[key] += nbytes
            self.count_by_op[key] += 1

    def collective(self, op, kind, axis, size, inputs, outputs) -> None:
        name = KINDS[kind]
        b = sum(_nbytes(t) for t in outputs)
        ring = (max(size, 2) - 1) / max(size, 2)
        # a broadcast or a reduce (FSDP's layer of a stack cut on its
        # layer dim) pipelined along a chain: each rank receives, or
        # sends, the payload once
        factor = {"all-gather": ring, "reduce-scatter": ring,
                  "all-reduce": 2 * ring, "all-to-all": ring,
                  "collective-permute": 1.0, "broadcast": ring,
                  "reduce": ring}[name]
        rec = self.collectives[name]
        rec["count"] += 1
        rec["bytes"] += b
        rec["wire_bytes"] += b * factor
        self.wire_by_axis[axis] = self.wire_by_axis.get(axis, 0.0) + \
            b * factor

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        name = func.overloadpacket.__name__
        if func.is_view or name in _VIEWS:  # no bytes, FLOPs or storage
            return func(*args, **kwargs)
        out = self._call(func, args, kwargs)
        from torch.utils.flop_counter import flop_registry
        flat_in = _flat((args, kwargs), [])
        flat_out = _flat(out, [])
        self._mark_inputs(flat_in)
        # a DTensor's op runs on its block (inside DTensor's own dispatch,
        # below this mode): count the blocks
        flat_in, flat_out = _tensors(flat_in), _tensors(flat_out)
        tag = self._tag(name)
        for o in flat_out:
            self._out_tags[o] = tag
            self._track(o)
        flops = 0.0
        fn = flop_registry.get(func.overloadpacket)
        if fn is not None:
            flops = float(fn(*args, **kwargs, out_val=out))
            self.registry_flops += flops
        nbytes = 0.0
        if name not in _ALLOCS:
            nbytes = float(sum(_nbytes(t) for t in flat_in) +
                           sum(_nbytes(t) for t in flat_out))
        shape = str(tuple(flat_out[0].shape)) if flat_out else ""
        self.add(name, tag, flops, nbytes, shape)
        return out

    def __enter__(self):
        from repro_torch.distributed import compat
        from torch.utils.weak import WeakIdKeyDictionary
        self._out_tags = WeakIdKeyDictionary()
        compat.LISTENERS.append(self.collective)
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.distributed import compat
        _ACTIVE.remove(self)
        compat.LISTENERS.remove(self.collective)
        return super().__exit__(*exc)

    # ---- results ----
    def result(self) -> Dict[str, Any]:
        """JAX's ``analyze`` keys, plus ``peak_bytes`` and this port's
        ``kernels`` (calls, flops and bytes each wrapper reported)."""
        return {"flops": self.flops, "bytes": self.bytes,
                "bytes_unfused": self.bytes,
                "collectives": self.collectives,
                "wire_bytes": sum(c["wire_bytes"]
                                  for c in self.collectives.values()),
                "wire_by_axis": dict(self.wire_by_axis),
                "bytes_by_tag": dict(self.bytes_by_tag),
                "flops_by_tag": dict(self.flops_by_tag),
                "peak_bytes": self.peak, "ops": self.ops,
                "kernels": self.kernels}

    def save_ops(self, path) -> None:
        """The per-op byte totals, for ``op_debug.breakdown``."""
        rows = [{"op": k[0], "shape": k[1], "tag": k[2], "bytes": b,
                 "count": self.count_by_op[k]}
                for k, b in self.by_op.most_common()]
        with open(path, "w") as fh:
            json.dump({"bytes": self.bytes, "ops": rows}, fh)


def record_kernel(name: str, flops: float, nbytes: float) -> None:
    """Called by a kernel's wrapper for each call while an analysis is
    active (a ctypes launch, or a ``meta`` call that launches nothing):
    its FLOPs and the bytes it reads and writes."""
    if not _ACTIVE:
        return
    mode = _ACTIVE[-1]
    tag = _tag_of(name + " " + _stack_path())
    mode.add(name, tag, flops, nbytes)
    rec = mode.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                         "bytes": 0.0})
    rec["calls"] += 1
    rec["flops"] += flops
    rec["bytes"] += nbytes


def analyze(fn: Callable, *args, held=None, save_ops=None,
            **kwargs) -> Tuple[Any, Dict[str, Any]]:
    """Run ``fn(*args, **kwargs)`` under an ``OpAnalysis``; returns (its
    result, the analysis). ``held`` (default: the arguments) are the
    tensors this process holds during the call: their storages count
    toward the peak from the start (``held_bytes``). ``torch_raw`` is
    what ``FlopCounterMode`` counts: the total of
    ``torch.utils.flop_counter``'s formulas over the ops (the kernels a
    wrapper reports are not in it). With ``save_ops`` (a path) the
    per-op byte totals are written there for ``op_debug``."""
    mode = OpAnalysis(record_ops=save_ops is not None)
    held_bytes = mode.hold((args, kwargs) if held is None else held)
    with mode:
        out = fn(*args, **kwargs)
    res = mode.result()
    res["held_bytes"] = held_bytes
    res["torch_raw"] = {"flops": mode.registry_flops}
    if save_ops is not None:
        mode.save_ops(save_ops)
    return out, res
