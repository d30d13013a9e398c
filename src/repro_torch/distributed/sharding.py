"""Sharding plans: logical param axes -> mesh specs + ModelRuntime.

PyTorch counterpart of ``repro/distributed/sharding.py``. ``models/*``
annotate every param/cache leaf with logical axis names
(``transformer.param_specs``, ``cache_specs``); this module is the single
place where those names meet the mesh: ``tree_shardings`` gives each leaf
the reference's per-dimension mesh axes (a ``NamedSharding`` of a ``P``),
``shard`` cuts a whole tree into this process's blocks (DTensors), and
``Plan.runtime`` builds the ``ModelRuntime`` injection (the ``Layout``,
flash-decoding attention, the expert-parallel MoE) for a (config, shape,
mesh) cell.

The port lays out the axes in ``LAID_OUT``: the attention heads, the MLP
and the vocabulary over ``model``, the expert stacks, the caches' rows
over the batch axes and their ring over ``model``; each process runs its
own rows of the batch (``Layout``; ``Plan.constrain`` by ``resid_spec``'s
batch entry) and holds ZeRO-1 AdamW moments (``train/optimizer.py``).
With ``fsdp`` (the caller's choice, as JAX's ``in_shardings`` are; the
reference's rule is ``launch/dryrun.plan_fsdp``) the parameters are
also cut over the batch axes as ``tree_shardings(..., zero1=True)`` cuts
them: the model gathers a layer's blocks inside its (recomputed) body
and the other leaves where they are used (``Layout.gather``), and a
gradient comes back as this process's reduce-scattered block. The
recurrent mixers' widths (``WHOLE_AXES``) and ``seq_parallel`` stay
whole on every process (ROADMAP item 13); the dry run records what that
costs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

from repro_torch.configs.base import (DECODE, ModelConfig, ParallelConfig,
                                      ShapeConfig)
from repro_torch.distributed.compat import (P, axis_index, fsdp_broadcast,
                                            fsdp_gather, from_local,
                                            in_shard_map, is_sharded_tensor,
                                            local_block, placements, psum,
                                            shard_map, spec_axes)
from repro_torch.distributed.mesh import batch_axes, model_axis_size

# logical axis name -> mesh axis ("__batch__" resolves to the batch axes)
LOGICAL_RULES: Dict[Optional[str], Optional[str]] = {
    None: None,
    "vocab": "model",
    "embed_shard": "model",       # in_embed d_model dim (local-gather lookup)
    "heads": "model",
    "mlp": "model",
    "rglru": "model",
    "rglru_heads": "model",
    "ssm_heads": "model",
    "ssm_flat": "model",
    "expert_slots": "model",
    "kv_batch": "__batch__",
    "kv_seq": "model",
    "zero_flat": "__all__",       # flattened optimizer blocks: all axes
    "expert_slots_dp": "__batch__",  # 2D expert parallelism (training)
}


class NamedSharding(NamedTuple):
    """A leaf's layout: its mesh and its ``P`` spec."""
    mesh: object
    spec: P

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The shape of one device's block of a global ``shape``, as
        JAX's ``NamedSharding.shard_shape``."""
        entries = list(self.spec) + [None] * (len(shape) - len(self.spec))
        out = []
        for d, e in zip(shape, entries):
            n = _axes_size(e, self.mesh)
            if d % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"divide over {e} ({n})")
            out.append(d // n)
        return tuple(out)


def spec_to_pspec(spec: Tuple, mesh,
                  overrides: Optional[Dict[str, str]] = None) -> P:
    axes = []
    for name in spec:
        tgt = (overrides or {}).get(name, LOGICAL_RULES.get(name))
        if tgt == "__batch__":
            axes.append(batch_axes(mesh) or None)
        elif tgt == "__all__":
            axes.append(tuple(a for a in mesh.axis_names
                              if mesh.shape[a] > 1) or None)
        elif tgt is not None and tgt in mesh.axis_names and \
                mesh.shape[tgt] > 1:
            axes.append(tgt)
        else:
            axes.append(None)
    return P(*axes)


def _axes_size(entry, mesh) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        n = 1
        for a in entry:
            n *= mesh.shape[a]
        return n
    return mesh.shape[entry]


def _fit_pspec(pspec: P, shape: Tuple[int, ...], mesh) -> P:
    """Drop mesh axes whose size does not divide the array dim (e.g. a
    batch=1 long-context cell cannot be data-sharded)."""
    entries = list(pspec) + [None] * (len(shape) - len(pspec))
    out = []
    for e, s in zip(entries, shape):
        out.append(e if s % _axes_size(e, mesh) == 0 else None)
    return P(*out)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and \
        all(isinstance(e, (str, type(None))) for e in x)


def _map2(fn, shapes, specs):
    """Map ``fn(shape_leaf, spec)`` over a shapes tree and its specs tree
    (a spec is a tuple of axis names: a leaf)."""
    if _is_spec(specs):
        return fn(shapes, specs)
    return {k: _map2(fn, shapes[k], specs[k]) for k in specs}


def tree_shardings(shapes, specs, mesh, zero1: bool = False,
                   overrides: Optional[Dict[str, str]] = None):
    """NamedShardings for a (tree of anything with ``.shape``,
    logical-axes tree) pair.

    zero1: additionally shard the first divisible replicated dim over the
    batch (data) axes — optimizer-state sharding.
    """
    baxes = batch_axes(mesh)
    dp = 1
    for a in baxes:
        dp *= mesh.shape[a]

    def one(sds, spec):
        shape = tuple(sds.shape)
        ps = _fit_pspec(spec_to_pspec(spec, mesh, overrides), shape, mesh)
        if zero1 and dp > 1:
            entries = list(ps) + [None] * (len(shape) - len(ps))
            used = set()
            for e in entries:
                for a in (e if isinstance(e, tuple) else (e,)):
                    if a:
                        used.add(a)
            if not used.intersection(baxes):
                for i, (e, s) in enumerate(zip(entries, shape)):
                    if e is None and s % dp == 0 and s > 0:
                        entries[i] = baxes if len(baxes) > 1 else baxes[0]
                        ps = P(*entries)
                        break
        return NamedSharding(mesh, ps)

    return _map2(one, shapes, specs)


#: logical axes the port lays out over the mesh (``shard``, ``Layout``):
#: the dense weights' heads, MLP and vocabulary over ``model``, the expert
#: stacks, the caches' rows and ring, and (with ``Plan.overrides`` on MoE
#: decode) the experts' FFN hidden dim over the batch axes
LAID_OUT = frozenset({"vocab", "embed_shard", "heads", "mlp", "expert_slots",
                      "expert_slots_dp", "expert_f", "kv_batch", "kv_seq"})

#: logical axes the reference cuts over ``model`` and the port keeps whole
#: (the recurrent mixers' widths: ROADMAP item 13's remainder)
WHOLE_AXES = frozenset({"rglru", "rglru_heads", "ssm_heads", "ssm_flat"})


def layout_overrides(overrides: Optional[Dict[str, str]] = None
                     ) -> Dict[str, Optional[str]]:
    """``tree_shardings`` overrides of the port's layout: ``WHOLE_AXES``
    whole, then the plan's own (``Plan.overrides``)."""
    out: Dict[str, Optional[str]] = dict.fromkeys(WHOLE_AXES)
    out.update(overrides or {})
    return out


def layout_shardings(tree, specs, mesh, overrides=None, zero1=False):
    """The port's layout of a tree: ``tree_shardings`` with the
    ``WHOLE_AXES`` whole."""
    return tree_shardings(tree, specs, mesh, zero1=zero1,
                          overrides=layout_overrides(overrides))


def shard(tree, specs, mesh, copy: bool = False,
          overrides: Optional[Dict[str, str]] = None, zero1: bool = False):
    """Cut a tree of whole tensors (the same values on every process)
    into this process's blocks under ``layout_shardings`` (with
    ``zero1``, its FSDP cut over the batch axes too): a leaf the
    layout cuts becomes a DTensor over its block (a view, or an owned
    copy with ``copy``, so that the whole tensor can be freed); a leaf it
    leaves whole stays as it is. A leaf that already is a block must be
    laid out as the layout says."""
    shardings = layout_shardings(tree, specs, mesh, overrides, zero1=zero1)

    def walk(t, ns):
        if not isinstance(ns, NamedSharding):
            return {k: walk(t[k], ns[k]) for k in ns}
        if is_sharded_tensor(t):
            if tuple(t.placements) != tuple(placements(ns.spec, t.dim(),
                                                       mesh)):
                raise ValueError(f"shard: a block laid out "
                                 f"{t.placements}, not as {ns.spec}")
            return t
        blk = local_block(t, ns.spec, mesh)
        if blk is t:
            return t
        return from_local(blk.clone() if copy else blk, ns.spec, mesh)

    return walk(tree, shardings)


def _spec_tree(shardings):
    if isinstance(shardings, NamedSharding):
        return shardings.spec
    return {k: _spec_tree(v) for k, v in shardings.items()}


def added_cut(base: P, finer: P, ndim: int, mesh):
    """(dim, axes) that ``finer`` cuts beyond ``base`` (one dim at most,
    as ``tree_shardings``' ZeRO-1 adds), or None when they are equal."""
    have, want = spec_axes(base, ndim, mesh), spec_axes(finer, ndim, mesh)
    for d, (h, w) in enumerate(zip(have, want)):
        if tuple(h) != tuple(w):
            if tuple(w[:len(h)]) != tuple(h):
                raise ValueError(f"{finer} does not refine {base}")
            return d, tuple(w[len(h):])
    return None


@dataclasses.dataclass(frozen=True)
class Layout:
    """The port's dense layout on a mesh: each process holds its block
    of every leaf (``shard``) and runs its own rows of the batch; the
    model's entry points run their body once a process on the blocks
    (``run``: a ``shard_map`` over the whole call), where the layers sum
    their row-parallel products over ``model`` (``tp_sum``)."""
    mesh: object
    override_items: Tuple[Tuple[str, str], ...] = ()
    #: the parameters also cut over the batch axes, as JAX's
    #: ``tree_shardings(..., zero1=True)`` (FSDP): the model gathers them
    #: where it uses them (``gather``)
    fsdp: bool = False

    @property
    def overrides(self) -> Dict[str, str]:
        return dict(self.override_items)

    @property
    def tp(self) -> int:
        return model_axis_size(self.mesh)

    @property
    def dp(self) -> int:
        n = 1
        for a in batch_axes(self.mesh):
            n *= self.mesh.shape[a]
        return n

    def axes(self) -> Tuple[str, ...]:
        """The logical axes this layout cuts (a dry run's ``layout``)."""
        cut = set(LAID_OUT) - {"expert_f"}  # expert_f: by override only
        cut |= {k for k, v in self.overrides.items() if v is not None}
        return tuple(sorted(cut))

    def specs(self, tree, logical, fsdp: Optional[bool] = None):
        """Each leaf's ``P`` under the layout (fitted to its shape); a
        parameter tree's with the layout's FSDP cut (``fsdp``: the
        layout's own unless given; a cache tree passes False)."""
        fsdp = self.fsdp if fsdp is None else fsdp
        return _spec_tree(layout_shardings(tree, logical, self.mesh,
                                           self.overrides, zero1=fsdp))

    def fsdp_cuts(self, tree, logical) -> Dict[str, Tuple[int, tuple]]:
        """``{path: (dim, batch axes)}`` of the leaves the FSDP cut adds
        a dim to (none without ``fsdp``)."""
        if not self.fsdp:
            return {}
        from repro_torch.bridge import tree_leaves
        base = dict(tree_leaves(self.specs(tree, logical, fsdp=False)))
        cut = dict(tree_leaves(self.specs(tree, logical)))
        shapes = dict(tree_leaves(tree))
        out = {}
        for path, spec in cut.items():
            c = added_cut(base[path], spec, len(shapes[path].shape),
                          self.mesh)
            if c is not None:
                out[path] = c
        return out

    def gather(self, t, cut):
        """Inside ``run``: the whole block (the layout without FSDP) of a
        leaf the FSDP cut ``(dim, axes)`` narrowed (``t`` as it is for
        None); its gradient is this process's reduce-scattered block."""
        if cut is None:
            return t
        d, axes = cut
        return fsdp_gather(t, axes, d)

    def layer(self, stack, cut, r: int):
        """Inside ``run``: layer ``r`` of a stacked leaf ``[reps, ...]``
        (this process's block of it), whole under the layout without
        FSDP. A stack cut on its layer dim holds ``reps / dp`` layers a
        process: layer r comes from the one that holds it
        (``fsdp_broadcast``); any other cut is gathered as ``gather``'s."""
        if cut is None:
            return stack[r]
        d, axes = cut
        if d == 0:
            k = stack.shape[0]
            return fsdp_broadcast(stack[r % k], axes, r // k)
        return fsdp_gather(stack[r], axes, d - 1)

    def cuts(self, axis: str, size: int) -> bool:
        """Whether the layout cuts a dim of logical ``axis`` and whole
        size ``size``: the model's layers then hold its block."""
        spec = _fit_pspec(spec_to_pspec((axis,), self.mesh,
                                        layout_overrides(self.overrides)),
                          (size,), self.mesh)
        return spec[0] is not None

    def shard(self, tree, logical, copy: bool = False,
              fsdp: Optional[bool] = None):
        """``shard`` under the layout (``fsdp`` as ``specs``')."""
        return shard(tree, logical, self.mesh, copy=copy,
                     overrides=self.overrides,
                     zero1=self.fsdp if fsdp is None else fsdp)

    def block(self, t, logical: Tuple):
        """This process's block of one whole leaf (an owned copy), for
        ``transformer.init_params(keep=...)``."""
        return self.shard({"x": t}, {"x": logical}, copy=True)["x"]

    def row_entry(self, batch: int):
        """The batch dim's entry of the specs: the batch axes when they
        divide ``batch``, else None (every process runs every row)."""
        baxes = batch_axes(self.mesh)
        if not baxes or batch % self.dp:
            return None
        return baxes if len(baxes) > 1 else baxes[0]

    def rows(self, x):
        """This process's rows of a whole batch ``x`` (the same on every
        process), as a DTensor over them."""
        spec = P(self.row_entry(x.shape[0]))
        return from_local(local_block(x, spec, self.mesh), spec, self.mesh)

    def run(self, fn, args, in_specs, out_specs):
        """``fn(*blocks)`` once a process (``compat.shard_map``)."""
        return shard_map(fn, mesh=self.mesh, in_specs=in_specs,
                         out_specs=out_specs)(*args)

    def tp_sum(self, x):
        """A row-parallel product's partial sums added over ``model``."""
        return psum(x, "model")

    def model_index(self) -> int:
        return axis_index("model") if self.tp > 1 else 0


@dataclasses.dataclass(frozen=True)
class Plan:
    """Sharding plan for one (model, shape, mesh) cell."""
    mesh: object
    cfg: ModelConfig
    shape: ShapeConfig
    parallel: ParallelConfig

    @property
    def tp(self) -> int:
        return model_axis_size(self.mesh)

    @property
    def batch(self) -> Tuple[str, ...]:
        return batch_axes(self.mesh)

    # ---- activation specs ----
    def resid_spec(self) -> P:
        if self.parallel.seq_parallel and self.shape.kind != DECODE:
            return P(self.batch or None, "model", None)
        return P(self.batch or None, None, None)

    def tokens_spec(self) -> P:
        return P(self.batch or None, None)

    def logits_spec(self) -> P:
        return P(self.batch or None, None, "model")

    def overrides(self) -> Optional[Dict[str, str]]:
        """The plan's layout overrides: on MoE decode the experts' FFN
        hidden dim over the batch axes (``make_moe_replicated``'s 2-D
        layout), as the reference's ``plan_shardings``, when the batch
        axes divide the batch (the route's own condition)."""
        if self.cfg.moe is not None and self.shape.kind == DECODE and \
                self.shape.global_batch % Layout(self.mesh).dp == 0:
            return {"expert_f": "__batch__"}
        return None

    def layout(self, fsdp: bool = False) -> Optional[Layout]:
        """The port's dense layout of this cell (None on a mesh of one
        device, where every leaf is whole); ``fsdp``: the parameters also
        cut over the batch axes (the reference's rule:
        ``launch/dryrun.plan_fsdp``)."""
        if self.mesh.size == 1:
            return None
        return Layout(self.mesh, tuple(sorted((self.overrides() or
                                               {}).items())),
                      fsdp=fsdp and Layout(self.mesh).dp > 1)

    def constrain(self, x, kind: str):
        """The reference's sharding constraint, by ``resid_spec``'s batch
        entry: a whole residual (outside the model's entry points) comes
        back as this process's rows (a DTensor); inside them
        (``Layout.run``) the residual already is the rows, and comes back
        as it is. ``seq_parallel``'s ``model`` entry is not laid out
        (ROADMAP item 13); the logits are laid out by ``lm_head``."""
        if kind != "resid" or x.dim() != 3:
            return x
        if is_sharded_tensor(x):
            raise ValueError(f"constrain({kind}): a sharded activation "
                             f"inside the model (a hook must return the "
                             f"rows as a plain tensor)")
        if in_shard_map() or self.mesh.size == 1:
            return x
        return Layout(self.mesh).rows(x)

    # ---- runtime (injection into models/transformer) ----
    def runtime(self, fsdp: bool = False):
        from repro_torch.distributed import decode_attn as da
        from repro_torch.distributed import moe_parallel as mp
        from repro_torch.models.moe import can_use_2d
        from repro_torch.models.transformer import ModelRuntime
        tp = self.tp
        decode_fn = None
        moe_fn = None
        moe_dp = 1
        baxes = self.batch
        dp = 1
        for a in baxes:
            dp *= self.mesh.shape[a]
        if tp > 1 or baxes:
            if self.shape.kind == DECODE:
                decode_fn = da.make_flash_decode(self.mesh)
                if self.cfg.moe:
                    moe_fn = mp.make_moe_replicated(
                        self.mesh, expert_2d=self.overrides() is not None)
            elif self.cfg.moe:
                last = self.mesh.shape[baxes[-1]] if baxes else 0
                if can_use_2d(self.cfg, tp, dp, last):
                    moe_fn = mp.make_moe_etp2d(self.mesh)
                    moe_dp = dp
                else:
                    moe_fn = mp.make_moe_etp(self.mesh)
        return ModelRuntime(
            tp=tp,
            attn_impl=self.parallel.attn_impl,
            moe_fn=moe_fn,
            decode_attn_fn=decode_fn,
            constrain=self.constrain,
            remat=(self.parallel.remat != "none"),
            remat_policy="dots" if self.parallel.remat == "dots" else "full",
            max_seq=self.shape.seq_len,
            moe_dp=moe_dp,
            layout=self.layout(fsdp),
        )
