"""``shard_map`` and JAX's named-axis collectives over ``torch.distributed``.

PyTorch counterpart of ``repro/distributed/compat.py``, and the one place
where a shard_map body and the ``lax`` collectives it calls get their
PyTorch meaning. Every process runs the same program (SPMD); a tensor
outside a shard_map is either

* a plain tensor, which holds the whole (global) value on every process
  (a batch handed to an entry point, the parameters the layout leaves
  whole: norms, ``wk``/``wv``, SSD's ``wbc``/``conv_bc``), or
* a ``DTensor`` whose local tensor is this process's block of the global
  value, laid out by a ``P`` spec (the dense weights' heads, MLP and
  vocabulary blocks, the expert stacks, the caches, the logits;
  ``sharding.shard`` and the model's entry points make them).

The model's entry points (``sharding.Layout.run``) run their whole body
in one shard_map, so inside it every activation is this process's rows
and every parameter its block, and a layer sums its row-parallel
products with ``psum``; the MoE and decode-attention hooks work on
those blocks only (``on_blocks``: outside a shard_map they run on a mesh
of one device alone).

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

Autograd goes through every collective JAX differentiates, with JAX's
transposes (those of a ``shard_map`` with ``check_vma=False``, as the
reference's hooks run): ``psum`` and ``pmean`` take a psum (pmean's
divided), ``all_gather`` a ``psum_scatter`` and the reverse,
``all_to_all`` the exchange with split and concat swapped, ``ppermute``
the inverse permutation; ``pmax`` has no gradient in JAX, and a backward
through it raises. At the boundary, as JAX's shard_map transposes: an
output's cotangent is divided by the size of the axes its spec leaves
whole, an argument's is summed over the axes its spec leaves whole and
gathered over those the cut narrowed; ``to_replicated`` hands back this
process's block of the cotangent. So a whole tensor's gradient is whole
and equal on every process and a DTensor's is its block, as JAX's global
gradient. The backward's collectives are counted as the forward's, under
the op they run.

FSDP and ZeRO-2 (``sharding.Layout(fsdp=True)``, ``train_step``'s
``grad_shardings``) have collectives of their own names, so that a
reader of ``stats`` sees a gradient's reduction over the batch axes as a
reduce-scatter and not as a psum: ``fsdp_gather`` (a parameter's block
gathered inside the body; its backward ``grad_scatter``),
``fsdp_broadcast`` (a layer that one process holds of a stack cut on its
layer dim; its backward ``grad_reduce`` onto that process), and a
``GradBlock`` argument, whose gradient is wanted on a finer block than
its value's (ZeRO-2: the cotangent reduce-scattered at the boundary,
``grad_scatter``, where a whole one is psum-ed).
"""
from __future__ import annotations

import contextlib
import functools
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


def on_mesh(mesh):
    """Run the named-axis collectives over ``mesh`` outside a shard_map
    (on blocks the caller cut itself, e.g. the optimizer's ZeRO-1)."""
    return _entered(mesh)


def bind_mesh(fn: Callable) -> Callable:
    """``fn`` run in the enclosing shard_map's mesh wherever it is called
    (``torch.utils.checkpoint`` recomputes a body, collectives included,
    in the backward pass, after the shard_map has returned)."""
    if not _MESHES:
        return fn
    mesh = _MESHES[-1]

    def call(*args, **kwargs):
        with _entered(mesh):
            return fn(*args, **kwargs)
    return call


def on_blocks(fn: Callable, mesh) -> Callable:
    """``fn``, a body that runs on blocks (a hook of ``distributed/``),
    callable inside a shard_map over ``mesh``, or outside one on a mesh of
    one device, where the whole tensors are the blocks; outside one on a
    larger mesh it refuses."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        if _MESHES:
            return fn(*args, **kwargs)
        if mesh.size != 1:
            raise ValueError(f"{fn.__qualname__} runs on blocks, inside "
                             f"the model's layout (sharding.Layout.run) "
                             f"on a mesh of {mesh.size} devices")
        with _entered(mesh):
            return fn(*args, **kwargs)
    return call


def in_shard_map() -> bool:
    """Whether the caller runs inside a ``shard_map`` body (on blocks)."""
    return bool(_MESHES)


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


#: callables ``fn(op, kind, axis, size, inputs, outputs)`` told of every
#: hop (``launch/op_analysis`` records the collectives of a call so)
LISTENERS: List[Callable] = []


def _run(op: str, kind: str, axis: str, group, inputs: Sequence,
         outputs: Sequence, call: Callable, size: int) -> None:
    """Count and run ``call(inputs, outputs)`` (a collective of kind
    ``kind`` over ``group``, ``size`` processes; an in-place one lists
    its tensor in both), through pinned host copies when the rule says
    so. A meta tensor has no bytes to move: the fake backend takes the
    collectives of meta tensors but not sends and receives, so a send of
    meta tensors is counted and not made."""
    rec = _STATS.setdefault((op, axis), [0, 0, 0])
    rec[0] += 1
    rec[1] += sum(t.numel() * t.element_size() for t in inputs)
    for fn in LISTENERS:
        fn(op, kind, axis, size, inputs, outputs)
    if inputs[0].is_meta and kind == "send_recv":
        return
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


def _live(axis_name, mesh=None) -> List[str]:
    """The axes of size > 1 among ``axis_name``."""
    mesh = mesh or _mesh()
    return [a for a in _names(axis_name) if mesh.shape[a] > 1]


# ---------------------------------------------------------------------------
# One hop of each collective over one axis (no autograd), and the backward
# that carries a gradient through it
# ---------------------------------------------------------------------------

def _sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """Sums of 16-bit floats run in float32 and round once, as XLA's CPU
    collectives add them (gloo would round after every addition)."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) \
        else dtype


def _reduce(x, mesh, axis: str, red, op: str) -> torch.Tensor:
    group = mesh.group(axis)
    acc = _sum_dtype(x.dtype) if red == dist.ReduceOp.SUM else x.dtype
    y = x.detach().to(acc, copy=True, memory_format=torch.contiguous_format)
    _run(op, "all_reduce", axis, group, [y], [y],
         lambda i, o: dist.all_reduce(o[0], red, group=group),
         mesh.shape[axis])
    return y.to(x.dtype)


def _gather(x, mesh, axis: str, dim: int,
            op: str = "all_gather") -> torch.Tensor:
    """The blocks of the axis's processes concatenated along ``dim``."""
    group, n = mesh.group(axis), mesh.shape[axis]
    src = x.detach().movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    _run(op, "all_gather", axis, group, [src], [out],
         lambda i, o: dist.all_gather_into_tensor(o[0], i[0], group=group),
         n)
    return out.movedim(0, dim)


def _scatter(x, mesh, axis: str, dim: int,
             op: str = "psum_scatter") -> torch.Tensor:
    """The sum over the axis, each process keeping its block of ``dim``."""
    group, n = mesh.group(axis), mesh.shape[axis]
    src = x.detach().movedim(dim, 0).to(_sum_dtype(x.dtype)).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"psum_scatter: dim {src.shape[0]} over {n}")
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    _run(op, "reduce_scatter", axis, group, [src], [out],
         lambda i, o: dist.reduce_scatter_tensor(o[0], i[0], group=group),
         n)
    return out.movedim(0, dim).to(x.dtype)


def _exchange(x, mesh, axis: str, split: int, concat: int,
              op: str = "all_to_all") -> torch.Tensor:
    """Block j of ``split`` to process j; the received blocks
    concatenated along ``concat`` in source order."""
    group, n = mesh.group(axis), mesh.shape[axis]
    src = x.detach().movedim(split, 0)
    if src.shape[0] % n:
        raise ValueError(f"all_to_all: dim {src.shape[0]} over {n}")
    src = src.reshape((n, src.shape[0] // n) + tuple(src.shape[1:])) \
        .contiguous()
    out = torch.empty_like(src)
    _run(op, "all_to_all", axis, group, [src], [out],
         lambda i, o: dist.all_to_all_single(o[0], i[0], group=group), n)
    return torch.cat([out[j].movedim(0, split) for j in range(n)],
                     dim=concat)


def _permute(x, mesh, axis: str, perm, op: str = "ppermute"):
    group = mesh.group(axis)
    me = mesh.coordinate()[axis]
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

    _run(op, "send_recv", axis, group, [src], [out], call,
         mesh.shape[axis])
    return out


def _bcast(x, mesh, axis: str, src: int) -> torch.Tensor:
    """The block of the process at index ``src`` along the axis, on every
    process of it."""
    group = mesh.group(axis)
    y = x.detach().contiguous().clone()
    _run("fsdp_broadcast", "broadcast", axis, group, [y], [y],
         lambda i, o: dist.broadcast(
             o[0], dist.get_global_rank(group, src), group=group),
         mesh.shape[axis])
    return y


def _reduce_onto(g, mesh, axis: str, dst: int) -> torch.Tensor:
    """The sum over the axis on the process at index ``dst`` (16-bit
    floats summed in float32, as ``_reduce``), zeros on the others."""
    group = mesh.group(axis)
    y = g.detach().to(_sum_dtype(g.dtype), copy=True,
                      memory_format=torch.contiguous_format)
    _run("grad_reduce", "reduce", axis, group, [y], [y],
         lambda i, o: dist.reduce(
             o[0], dist.get_global_rank(group, dst), group=group),
         mesh.shape[axis])
    if mesh.coordinate()[axis] != dst:
        y.zero_()
    return y.to(g.dtype)


class _Linear(torch.autograd.Function):
    """``fwd(x)``, a linear map, whose backward is ``bwd``: the transpose
    JAX's shard_map takes for the same collective (``check_vma=False``)."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


def _linear(x: torch.Tensor, fwd: Callable, bwd: Callable) -> torch.Tensor:
    """``fwd(x)``, carrying a gradient through ``bwd`` when autograd
    follows ``x``."""
    if x.requires_grad and torch.is_grad_enabled():
        return _Linear.apply(x, fwd, bwd)
    return fwd(x)


def _all_reduce(x: torch.Tensor, axis_name, red, op: str) -> torch.Tensor:
    """One all_reduce a live axis. A sum's backward is the same sum (the
    cotangent of a replicated output comes in divided by the axes' size,
    ``shard_map``'s rule, so the two make the global gradient); JAX
    defines no gradient for a max, so a backward through one raises."""
    mesh = _mesh()

    def refuse(g):
        raise NotImplementedError(
            f"Differentiation rule for '{op}' not implemented (nor is it "
            f"in JAX)")

    for a in _live(axis_name, mesh):
        fwd = functools.partial(_reduce, mesh=mesh, axis=a, red=red, op=op)
        x = _linear(x, fwd, fwd if red == dist.ReduceOp.SUM else refuse)
    return x


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    return _all_reduce(x, axis_name, dist.ReduceOp.SUM, "psum")


def pmax(x: torch.Tensor, axis_name) -> torch.Tensor:
    return _all_reduce(x, axis_name, dist.ReduceOp.MAX, "pmax")


def pmean(x: torch.Tensor, axis_name) -> torch.Tensor:
    n = axis_size(axis_name)
    x = _all_reduce(x, axis_name, dist.ReduceOp.SUM, "pmean")
    return x / n if n > 1 else x


def all_gather(x: torch.Tensor, axis_name, *, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """Blocks of every process along the axes, in axis-index order:
    concatenated along ``axis`` (tiled) or stacked in a new one. Its
    backward is ``psum_scatter`` of the cotangent."""
    mesh = _mesh()
    if not tiled:
        x = x.unsqueeze(axis)
    # inner axis first: outer-major
    for a in reversed(_live(axis_name, mesh)):
        x = _linear(x, lambda t, a=a: _gather(t, mesh, a, axis),
                    lambda g, a=a: _scatter(g, mesh, a, axis))
    return x


def psum_scatter(x: torch.Tensor, axis_name, *, scatter_dimension: int = 0,
                 tiled: bool = False) -> torch.Tensor:
    """Sum over the axis, each process keeping its block of
    ``scatter_dimension`` (tiled only, as the reference uses it). Its
    backward is ``all_gather`` of the cotangent."""
    if not tiled:
        raise NotImplementedError("psum_scatter: tiled=True only")
    mesh = _mesh()
    d = scatter_dimension
    for a in _live(axis_name, mesh):
        x = _linear(x, lambda t, a=a: _scatter(t, mesh, a, d),
                    lambda g, a=a: _gather(g, mesh, a, d))
    return x


def all_to_all(x: torch.Tensor, axis_name, split_axis: int,
               concat_axis: int, *, tiled: bool = False) -> torch.Tensor:
    """Split ``split_axis`` into one block a process, send block j to
    process j, concatenate the received blocks along ``concat_axis`` in
    source order (tiled only, as the reference uses it). Its backward is
    the same exchange with the two axes swapped."""
    if not tiled:
        raise NotImplementedError("all_to_all: tiled=True only")
    mesh = _mesh()
    for a in _live(axis_name, mesh):
        x = _linear(x, lambda t, a=a: _exchange(t, mesh, a, split_axis,
                                                concat_axis),
                    lambda g, a=a: _exchange(g, mesh, a, concat_axis,
                                             split_axis))
    return x


def ppermute(x: torch.Tensor, axis_name, perm) -> torch.Tensor:
    """Send this process's ``x`` to ``dst`` for each ``(src, dst)`` of
    ``perm`` with src == its index; a process no pair sends to gets
    zeros. Its backward sends the cotangent back along the inverse
    permutation."""
    (a,) = _names(axis_name)
    mesh = _mesh()
    if not _live(a, mesh):
        return x if any(s == d == 0 for s, d in perm) else torch.zeros_like(x)
    inverse = [(d, s) for s, d in perm]
    return _linear(x, lambda t: _permute(t, mesh, a, perm),
                   lambda g: _permute(g, mesh, a, inverse))


def psum_shards(x: torch.Tensor, like) -> torch.Tensor:
    """Sum ``x`` (this process's part of a quantity of the DTensor
    ``like``'s blocks, e.g. their sum of squares) over the mesh dims on
    which ``like`` is sharded, counted as ``psum``; outside any
    shard_map."""
    dm = like.device_mesh
    for i, pl in enumerate(like.placements):
        if pl.is_shard() and dm.size(i) > 1:
            group = dm.get_group(i)
            y = x.detach().to(_sum_dtype(x.dtype), copy=True)
            _run("psum", "all_reduce", dm.mesh_dim_names[i], group, [y], [y],
                 lambda i_, o, g=group: dist.all_reduce(o[0], group=g),
                 dm.size(i))
            x = y.to(x.dtype)
    return x


def fsdp_gather(x: torch.Tensor, axis_name, axis: int) -> torch.Tensor:
    """``all_gather(x, axis_name, axis=axis, tiled=True)`` of a
    parameter's FSDP block, counted as ``fsdp_gather``; its backward, the
    reduce-scatter of the gradient, as ``grad_scatter``."""
    mesh = _mesh()
    for a in reversed(_live(axis_name, mesh)):  # inner axis first
        x = _linear(x, lambda t, a=a: _gather(t, mesh, a, axis,
                                              "fsdp_gather"),
                    lambda g, a=a: _scatter(g, mesh, a, axis,
                                            "grad_scatter"))
    return x


def fsdp_broadcast(x: torch.Tensor, axis_name, src: int) -> torch.Tensor:
    """The ``x`` of the process at flattened index ``src`` along the axes
    (the first outermost), on every process of them: a layer that one
    process holds of a stack the layout cuts on its layer dim. Its
    backward sums the cotangents onto that process (zeros elsewhere)."""
    mesh = _mesh()
    live = _live(axis_name, mesh)
    coords = {}
    for a in reversed(live):
        coords[a] = src % mesh.shape[a]
        src //= mesh.shape[a]
    for a in live:
        x = _linear(x, lambda t, a=a: _bcast(t, mesh, a, coords[a]),
                    lambda g, a=a: _reduce_onto(g, mesh, a, coords[a]))
    return x


class GradBlock:
    """A shard_map argument whose value is ``value`` (a parameter as its
    layout holds it: a DTensor, or a whole tensor) and whose gradient is
    wanted on ``block``, a DTensor leaf over this process's block of a
    layout that refines the value's: ZeRO-2's gradient blocks. At the
    boundary the cotangent is reduce-scattered over the axes the block
    adds (``grad_scatter``) instead of psum-ed whole."""

    def __init__(self, value, block):
        self.value, self.block = value, block

    @property
    def shape(self):
        return self.value.shape

    def dim(self) -> int:
        return self.value.dim()


def _grad_block_local(a: GradBlock, spec, mesh):
    """The value's block under ``spec`` (which must be the value's own
    layout), tied to ``a.block``: its backward sums the cotangent over
    the axes ``spec`` leaves whole and the block does not cut, then
    reduce-scatters it over the axes the block adds, outer axis first."""
    ndim = a.dim()
    want = _spec_axes(spec, ndim, mesh)
    value = a.value.detach()
    have = _placement_axes(value, mesh) if is_sharded_tensor(value) \
        else [[] for _ in range(ndim)]
    if [tuple(h) for h in have] != [tuple(w) for w in want]:
        raise ValueError(f"a GradBlock's value laid out {have}, not as "
                         f"its spec {spec}")
    got = _placement_axes(a.block, mesh)
    added = []
    for d, (w, g) in enumerate(zip(want, got)):
        if tuple(g[:len(w)]) != tuple(w):
            raise ValueError(f"a GradBlock's block {a.block.placements} "
                             f"does not refine {spec} on dim {d}")
        added += [(d, ax) for ax in g[len(w):]]
    summed = [ax for ax in _unmentioned(spec, ndim, mesh)
              if ax not in {ax_ for _, ax_ in added}]
    x = local_of(value)

    def bwd(g):
        for ax in summed:
            g = _reduce(g, mesh, ax, dist.ReduceOp.SUM, "psum")
        for d, ax in added:
            g = _scatter(g, mesh, ax, d, "grad_scatter")
        return g

    return _linear(a.block.to_local(), lambda t: x.detach(), bwd)


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------

def is_sharded_tensor(t) -> bool:
    """Whether ``t`` is a DTensor (a block of a global value)."""
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local_of(t):
    """A DTensor's block; any other tensor as it is."""
    return t.to_local() if is_sharded_tensor(t) else t


def like_sharded(local: torch.Tensor, ref):
    """``local`` as the block of a DTensor laid out as ``ref`` (``local``
    itself when ``ref`` is no DTensor)."""
    if not is_sharded_tensor(ref):
        return local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def spec_axes(spec, ndim: int, mesh) -> List[Tuple[str, ...]]:
    """Per dim, the mesh axes of size > 1 that ``spec`` shards it over."""
    return _spec_axes(spec, ndim, mesh)


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
    stride, n = [], 1
    for d in reversed(shape):  # contiguous, computed (no allocation)
        stride.insert(0, n)
        n *= max(d, 1)
    return DTensor.from_local(t, mesh.device_mesh,
                              placements(spec, t.dim(), mesh),
                              run_check=False, shape=shape,
                              stride=tuple(stride))


def _unmentioned(spec, ndim: int, mesh) -> List[str]:
    """The mesh axes of size > 1 that ``spec`` does not shard."""
    used = {a for axes in _spec_axes(spec, ndim, mesh) for a in axes}
    return [a for a in mesh.axis_names
            if mesh.shape[a] > 1 and a not in used]


def _to_local(a, spec, mesh):
    """This process's block of an argument under its spec. Its backward
    is JAX's input rule: the cotangent summed over the axes the spec does
    not shard, then gathered over the axes this cut narrowed, so a
    whole tensor's gradient is whole on every process and a DTensor's is
    its block."""
    if isinstance(a, GradBlock):
        return _grad_block_local(a, spec, mesh)
    if not isinstance(a, torch.Tensor):
        return a
    want = _spec_axes(spec, a.dim(), mesh)
    if is_sharded_tensor(a):
        # a DTensor: its layout must be the spec's, or a prefix of it on
        # each dim (then the local block is narrowed further, with no
        # traffic)
        have = _placement_axes(a, mesh)
        x = a.to_local()
        for d, (h, w) in enumerate(zip(have, want)):
            if tuple(w[:len(h)]) != tuple(h):
                raise ValueError(f"a DTensor laid out {a.placements} where "
                                 f"the spec {spec} wants {w} on dim {d}")
    else:
        have, x = [()] * a.dim(), a
    extra = [w[len(h):] for h, w in zip(have, want)]
    summed = _unmentioned(spec, a.dim(), mesh)

    def fwd(t):
        for d, axes in enumerate(extra):
            if axes:
                t = _narrow(t, d, axes, mesh)
        return t.view_as(t)

    def bwd(g):
        for ax in summed:
            g = _reduce(g, mesh, ax, dist.ReduceOp.SUM, "psum")
        for d, axes in enumerate(extra):
            for ax in reversed(axes):  # inner axis first: outer-major
                g = _gather(g, mesh, ax, d)
        return g

    return _linear(x, fwd, bwd)


def _from_local(o, spec, mesh):
    """An output back from its block (``from_local``). Its backward is
    JAX's output rule: the cotangent divided by the size of the axes the
    spec does not shard (over which the output is one value)."""
    if not isinstance(o, torch.Tensor):
        return o
    n = math.prod(mesh.shape[a] for a in _unmentioned(spec, o.dim(), mesh))
    if n > 1:
        o = _linear(o, lambda t: t.view_as(t), lambda g: g / n)
    return from_local(o, spec, mesh)


#: a spec that hands a shard_map argument (or takes an output) over as it
#: is: a tree of DTensors the body reads through their own layout (the
#: decode caches, which the hooks write in place)
AS_IS = "as_is"


def _map_specs(fn, tree, specs):
    """Apply ``fn(leaf, spec)`` over ``tree``; a ``P`` in ``specs`` covers
    every leaf of the matching subtree (JAX's spec prefixes); ``AS_IS``
    leaves the subtree as it is."""
    if isinstance(specs, str) and specs == AS_IS:
        return tree
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
        return _map_specs(lambda o, s: _from_local(o, s, mesh), out,
                          out_specs)

    return call


def to_replicated(t, mesh):
    """A plain tensor of the whole value of ``t`` on every process: a
    DTensor's blocks gathered over the axes that shard it (counted as
    ``all_gather``); a plain tensor as it is. Its backward takes this
    process's block of the (whole, equal on every process) cotangent."""
    if not is_sharded_tensor(t):
        return t
    axes = _placement_axes(t, mesh)

    def fwd(x):
        for d, ax in enumerate(axes):
            for a in reversed(ax):  # inner axis first: outer-major
                x = _gather(x, mesh, a, d)
        return x

    def bwd(g):
        for d, ax in enumerate(axes):
            if ax:
                g = _narrow(g, d, ax, mesh)
        return g.contiguous()

    return _linear(t.to_local(), fwd, bwd)
