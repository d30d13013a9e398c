"""``shard_map`` and JAX's named-axis collectives over ``torch.distributed``.

PyTorch counterpart of ``repro/distributed/compat.py``, and the one place
where a shard_map body and the ``lax`` collectives it calls get their
PyTorch meaning. Every process runs the same program (SPMD); a tensor
outside a shard_map is either

* a plain tensor, which holds the whole (global) value on every process
  (activations, and the replicated parameters: embeddings, norms, the
  dense attention and MLP weights), or
* a ``DTensor`` whose local tensor is this process's block of the global
  value, laid out by a ``P`` spec (the decode KV cache, the expert
  stacks; ``sharding.shard`` makes them).

``shard_map(f, mesh=, in_specs=, out_specs=)`` hands ``f`` each
argument's block under its spec: a DTensor's local tensor (its layout
must be the spec's, or shard a prefix of the spec's axes on each dim:
the block is then narrowed further, with no traffic), or the block of a
plain tensor (a view). An output
whose spec shards no axis of size > 1 comes back as it is (the body made
it equal on the processes that share it, by a ``psum`` or by
construction); any other output comes back as a DTensor over the local
block, so a sharded result stays sharded between calls, as GSPMD keeps
it. ``to_replicated`` gathers a DTensor into a plain tensor.

The collectives (``psum``, ``pmax``, ``pmean``, ``psum_scatter``,
``all_gather``, ``all_to_all``, ``ppermute``) take the axis names of the
enclosing shard_map's mesh, one name or a tuple, as JAX's do. An axis of
size 1 is the identity and moves nothing; a tuple of axes runs one hop
an axis. Sums of bf16 or fp16 run in float32 and round once, as XLA's
CPU collectives do (gloo would round at every hop), so they move 4
bytes an element. Each hop counts, per op name and axis, its calls, the
bytes this process hands the collective (its payload, not the wire
traffic, which depends on the algorithm) and the bytes it staged
through the host (``stats``, ``reset_stats``). When the axis's group
runs gloo and the tensor is on a card, a collective gloo has no CUDA
implementation for is copied through pinned host memory and back
(``_stages``: one rule, keyed on the backend and the op).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist


class P(tuple):
    """A PartitionSpec: per dim, None, a mesh axis name or a tuple of
    names (their product shards the dim, the first one outermost)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def _names(axis_name) -> Tuple[str, ...]:
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)


# ---------------------------------------------------------------------------
# The enclosing shard_map's mesh
# ---------------------------------------------------------------------------

_MESHES: List[Any] = []


@contextlib.contextmanager
def _entered(mesh):
    _MESHES.append(mesh)
    try:
        yield
    finally:
        _MESHES.pop()


def _mesh():
    if not _MESHES:
        raise RuntimeError("a named-axis collective outside shard_map")
    return _MESHES[-1]


def axis_size(axis_name) -> int:
    """Static size of a mapped mesh axis (or the product of a tuple's)."""
    mesh = _mesh()
    return math.prod(mesh.shape[a] for a in _names(axis_name))


def _flat_index(mesh, axes) -> int:
    coord = mesh.coordinate()
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + coord[a]
    return idx


def axis_index(axis_name) -> int:
    """This process's index along a mesh axis (a tuple: its flattened
    index, the first axis outermost)."""
    return _flat_index(_mesh(), _names(axis_name))


# ---------------------------------------------------------------------------
# Counters and the staging rule
# ---------------------------------------------------------------------------

#: (op, axis) -> [calls, payload bytes, bytes staged through the host]
_STATS: Dict[Tuple[str, str], List[int]] = {}

# the collectives gloo runs on CUDA tensors (read on an H100 with two
# ranks on one card, values checked: tests/test_torch_distributed.py::
# test_backends_on_one_card); its send/recv takes host tensors only (on a
# CUDA tensor it aborts the process), so ppermute is staged
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast", "all_gather",
                           "reduce_scatter", "all_to_all"})


def reset_stats() -> None:
    _STATS.clear()


def stats() -> Dict[str, Dict[str, Dict[str, int]]]:
    """``{op: {axis: {"calls", "bytes", "staged_bytes"}}}`` since the
    last ``reset_stats``."""
    out: Dict[str, Dict[str, Dict[str, int]]] = {}
    for (op, axis), (calls, nbytes, staged) in sorted(_STATS.items()):
        out.setdefault(op, {})[axis] = {"calls": calls, "bytes": nbytes,
                                        "staged_bytes": staged}
    return out


def bytes_over(axis: str) -> int:
    """Payload bytes of every collective over ``axis`` since the reset."""
    return sum(v[1] for (_, a), v in _STATS.items() if a == axis)


def _stages(group, kind: str, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo" and \
        kind not in GLOO_CUDA_OPS


def _run(op: str, kind: str, axis: str, group, inputs: Sequence,
         outputs: Sequence, call: Callable) -> None:
    """Count and run ``call(inputs, outputs)`` (a collective of kind
    ``kind`` over ``group``; an in-place one lists its tensor in both),
    through pinned host copies when the rule says so."""
    rec = _STATS.setdefault((op, axis), [0, 0, 0])
    rec[0] += 1
    rec[1] += sum(t.numel() * t.element_size() for t in inputs)
    if not _stages(group, kind, inputs[0]):
        call(inputs, outputs)
        return

    def host(t):
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)

    h_in = [host(t).copy_(t) for t in inputs]
    h_out = []
    for t in outputs:
        same = [h for s, h in zip(inputs, h_in) if s is t]
        h_out.append(same[0] if same else host(t))
    rec[2] += sum(t.numel() * t.element_size()
                  for t in list(inputs) + list(outputs))
    call(h_in, h_out)
    for dst, src in zip(outputs, h_out):
        dst.copy_(src)


def _live(axis_name, x: torch.Tensor, op: str) -> List[str]:
    """The axes of size > 1 among ``axis_name``. The collectives over them
    have no backward, so they refuse a tensor autograd would follow."""
    mesh = _mesh()
    live = [a for a in _names(axis_name) if mesh.shape[a] > 1]
    if live and x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            f"{op} over {live}: the collectives carry no gradient; run "
            f"under torch.no_grad() (ROADMAP Queue C)")
    return live


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """Sums of 16-bit floats run in float32 and round once, as XLA's CPU
    collectives add them (gloo would round after every addition)."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) \
        else dtype


def _all_reduce(x: torch.Tensor, axis: str, red, op: str) -> torch.Tensor:
    group = _mesh().group(axis)
    acc = _sum_dtype(x.dtype) if red == dist.ReduceOp.SUM else x.dtype
    y = x.detach().to(acc, copy=True, memory_format=torch.contiguous_format)
    _run(op, "all_reduce", axis, group, [y], [y],
         lambda i, o: dist.all_reduce(o[0], red, group=group))
    return y.to(x.dtype)


def psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    for a in _live(axis_name, x, "psum"):
        x = _all_reduce(x, a, dist.ReduceOp.SUM, "psum")
    return x


def pmax(x: torch.Tensor, axis_name) -> torch.Tensor:
    for a in _live(axis_name, x, "pmax"):
        x = _all_reduce(x, a, dist.ReduceOp.MAX, "pmax")
    return x


def pmean(x: torch.Tensor, axis_name) -> torch.Tensor:
    n = axis_size(axis_name)
    for a in _live(axis_name, x, "pmean"):
        x = _all_reduce(x, a, dist.ReduceOp.SUM, "pmean")
    return x / n if n > 1 else x


def all_gather(x: torch.Tensor, axis_name, *, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """Blocks of every process along the axes, in axis-index order:
    concatenated along ``axis`` (tiled) or stacked in a new one."""
    if not tiled:
        x = x.unsqueeze(axis)
    # inner axis first: outer-major
    for a in reversed(_live(axis_name, x, "all_gather")):
        group = _mesh().group(a)
        n = _mesh().shape[a]
        src = x.movedim(axis, 0).contiguous()
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        _run("all_gather", "all_gather", a, group, [src], [out],
             lambda i, o, g=group: dist.all_gather_into_tensor(
                 o[0], i[0], group=g))
        x = out.movedim(0, axis)
    return x


def psum_scatter(x: torch.Tensor, axis_name, *, scatter_dimension: int = 0,
                 tiled: bool = False) -> torch.Tensor:
    """Sum over the axis, each process keeping its block of
    ``scatter_dimension`` (tiled only, as the reference uses it)."""
    if not tiled:
        raise NotImplementedError("psum_scatter: tiled=True only")
    for a in _live(axis_name, x, "psum_scatter"):
        group = _mesh().group(a)
        n = _mesh().shape[a]
        src = x.movedim(scatter_dimension, 0).to(_sum_dtype(x.dtype)) \
            .contiguous()
        if src.shape[0] % n:
            raise ValueError(f"psum_scatter: dim {src.shape[0]} over {n}")
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        _run("psum_scatter", "reduce_scatter", a, group, [src], [out],
             lambda i, o, g=group: dist.reduce_scatter_tensor(
                 o[0], i[0], group=g))
        x = out.movedim(0, scatter_dimension).to(x.dtype)
    return x


def all_to_all(x: torch.Tensor, axis_name, split_axis: int,
               concat_axis: int, *, tiled: bool = False) -> torch.Tensor:
    """Split ``split_axis`` into one block a process, send block j to
    process j, concatenate the received blocks along ``concat_axis`` in
    source order (tiled only, as the reference uses it)."""
    if not tiled:
        raise NotImplementedError("all_to_all: tiled=True only")
    for a in _live(axis_name, x, "all_to_all"):
        group = _mesh().group(a)
        n = _mesh().shape[a]
        src = x.movedim(split_axis, 0)
        if src.shape[0] % n:
            raise ValueError(f"all_to_all: dim {src.shape[0]} over {n}")
        src = src.reshape((n, src.shape[0] // n) + tuple(src.shape[1:])) \
            .contiguous()
        out = torch.empty_like(src)
        _run("all_to_all", "all_to_all", a, group, [src], [out],
             lambda i, o, g=group: dist.all_to_all_single(
                 o[0], i[0], group=g))
        x = torch.cat([out[j].movedim(0, split_axis) for j in range(n)],
                      dim=concat_axis)
    return x


def ppermute(x: torch.Tensor, axis_name, perm) -> torch.Tensor:
    """Send this process's ``x`` to ``dst`` for each ``(src, dst)`` of
    ``perm`` with src == its index; a process no pair sends to gets
    zeros."""
    (a,) = _names(axis_name)
    mesh = _mesh()
    if not _live(a, x, "ppermute"):
        return x if any(s == d == 0 for s, d in perm) else torch.zeros_like(x)
    group = mesh.group(a)
    me = mesh.coordinate()[a]
    src = x.detach().contiguous()
    out = torch.zeros_like(src)
    if (me, me) in [tuple(p) for p in perm]:
        out.copy_(src)
    sends = [d for s, d in perm if s == me and d != me]
    recvs = [s for s, d in perm if d == me and s != me]

    def call(i, o):
        ops = [dist.P2POp(dist.isend, i[0], dist.get_global_rank(group, d),
                          group) for d in sends]
        ops += [dist.P2POp(dist.irecv, o[0], dist.get_global_rank(group, s),
                           group) for s in recvs]
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()

    _run("ppermute", "send_recv", a, group, [src], [out], call)
    return out


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------

def is_sharded_tensor(t) -> bool:
    """Whether ``t`` is a DTensor (a block of a global value)."""
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _spec_axes(spec, ndim: int, mesh) -> List[Tuple[str, ...]]:
    """Per dim, the mesh axes of size > 1 that shard it."""
    entries = list(spec) + [None] * (ndim - len(spec))
    if len(entries) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return [tuple(a for a in entry_axes(e) if mesh.shape[a] > 1)
            for e in entries]


def placements(spec, ndim: int, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh`` (one a mesh dim)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.axis_names]
    for d, axes in enumerate(_spec_axes(spec, ndim, mesh)):
        for a in axes:
            out[mesh.axis_names.index(a)] = Shard(d)
    return out


def _narrow(t: torch.Tensor, d: int, axes, mesh) -> torch.Tensor:
    """This process's block of dim ``d`` over ``axes`` (a view)."""
    n = math.prod(mesh.shape[a] for a in axes)
    if t.shape[d] % n:
        raise ValueError(f"dim {d} of {tuple(t.shape)} does not divide "
                         f"over {axes} ({n})")
    size = t.shape[d] // n
    return t.narrow(d, _flat_index(mesh, axes) * size, size)


def local_block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This process's block of the global value ``t`` under ``spec``: a
    view (narrowed along each sharded dim)."""
    for d, axes in enumerate(_spec_axes(spec, t.dim(), mesh)):
        if axes:
            t = _narrow(t, d, axes, mesh)
    return t


def _placement_axes(t, mesh) -> List[List[str]]:
    """Per dim of a DTensor, the mesh axes of size > 1 that shard it."""
    out: List[List[str]] = [[] for _ in range(t.dim())]
    for ax, pl in zip(mesh.axis_names, t.placements):
        if pl.is_shard() and mesh.shape[ax] > 1:
            out[pl.dim].append(ax)
    return out


def _global_shape(local_shape, spec, mesh) -> Tuple[int, ...]:
    return tuple(s * math.prod(mesh.shape[a] for a in axes)
                 for s, axes in zip(local_shape,
                                    _spec_axes(spec, len(local_shape),
                                               mesh)))


def from_local(t: torch.Tensor, spec, mesh):
    """A DTensor over this process's block ``t`` of a global value laid
    out by ``spec`` (``t`` itself when the spec shards nothing)."""
    if not any(_spec_axes(spec, t.dim(), mesh)):
        return t
    from torch.distributed.tensor import DTensor
    shape = _global_shape(t.shape, spec, mesh)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t, mesh.device_mesh,
                              placements(spec, t.dim(), mesh),
                              run_check=False, shape=shape, stride=stride)


def _to_local(a, spec, mesh):
    if not isinstance(a, torch.Tensor):
        return a
    if not is_sharded_tensor(a):
        return local_block(a, spec, mesh)
    # a DTensor: its layout must be the spec's, or a prefix of it on each
    # dim (then the local block is narrowed further, with no traffic)
    x = a.to_local()
    want = _spec_axes(spec, a.dim(), mesh)
    for d, (h, w) in enumerate(zip(_placement_axes(a, mesh), want)):
        if tuple(w[:len(h)]) != tuple(h):
            raise ValueError(f"a DTensor laid out {a.placements} where the "
                             f"spec {spec} wants {w} on dim {d}")
        if w[len(h):]:
            x = _narrow(x, d, w[len(h):], mesh)
    return x


def _map_specs(fn, tree, specs):
    """Apply ``fn(leaf, spec)`` over ``tree``; a ``P`` in ``specs`` covers
    every leaf of the matching subtree (JAX's spec prefixes)."""
    if isinstance(specs, P):
        if isinstance(tree, dict):
            return {k: _map_specs(fn, v, specs) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(_map_specs(fn, v, specs) for v in tree)
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, tree[k], specs[k]) for k in tree}
    if len(tree) != len(specs):
        raise ValueError(f"{len(tree)} values against {len(specs)} specs")
    return type(tree)(_map_specs(fn, v, s) for v, s in zip(tree, specs))


def shard_map(f, *, mesh, in_specs, out_specs, check_vma=None):
    """``f`` on each process's blocks; see the module docstring.
    ``check_vma`` is accepted for the reference's signature and
    ignored."""
    del check_vma

    def call(*args):
        local = _map_specs(lambda a, s: _to_local(a, s, mesh), tuple(args),
                           tuple(in_specs))
        with _entered(mesh):
            out = f(*local)
        return _map_specs(lambda o, s: from_local(o, s, mesh)
                          if isinstance(o, torch.Tensor) else o,
                          out, out_specs)

    return call


def to_replicated(t, mesh):
    """A plain tensor of the whole value of ``t`` on every process: a
    DTensor's blocks gathered over the axes that shard it (counted as
    ``all_gather``); a plain tensor as it is."""
    if not is_sharded_tensor(t):
        return t
    x = t.to_local()
    with _entered(mesh):
        for d, axes in enumerate(_placement_axes(t, mesh)):
            if axes:
                x = all_gather(x, tuple(axes), axis=d, tiled=True)
    return x
