"""Sharding plans: logical param axes -> mesh specs + ModelRuntime.

PyTorch counterpart of ``repro/distributed/sharding.py``. ``models/*``
annotate every param/cache leaf with logical axis names
(``transformer.param_specs``, ``cache_specs``); this module is the single
place where those names meet the mesh: ``tree_shardings`` gives each leaf
the reference's per-dimension mesh axes (a ``NamedSharding`` of a ``P``),
``shard`` cuts a whole tree into this process's blocks (DTensors), and
``Plan.runtime`` builds the ``ModelRuntime`` injection (flash-decoding
attention, the expert-parallel MoE) for a (config, shape, mesh) cell.

The port shards the attention KV cache and the expert stacks this way
(``BLOCK_AXES``); the dense weights, the recurrent states and the
activations stay whole on every process (values equal, memory not:
ROADMAP Queue C), so ``Plan.constrain`` lays out nothing, whatever
``resid_spec`` (JAX's, ``seq_parallel`` included) says; the dry run
measures what that costs. It checks that a hook handed back a whole
residual stream.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

from repro_torch.configs.base import (DECODE, ModelConfig, ParallelConfig,
                                      ShapeConfig)
from repro_torch.distributed.compat import (P, from_local, is_sharded_tensor,
                                            local_block)
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


#: logical axes of the leaves the port keeps in blocks: the expert stacks
#: (``moe_fn`` routes) and the attention KV ring (``decode_attn_fn``)
BLOCK_AXES = frozenset({"expert_slots", "expert_slots_dp", "kv_seq"})


def shard(tree, specs, mesh, copy: bool = False):
    """Cut a tree of whole tensors (the same values on every process)
    into this process's blocks: a leaf with a ``BLOCK_AXES`` axis becomes
    a DTensor over its block under ``tree_shardings(tree, specs, mesh)``
    (a view, or an owned copy with ``copy``, so that the whole tensor can
    be freed); every other leaf stays whole, as the port's dense layers
    take it."""
    shardings = tree_shardings(tree, specs, mesh)

    def walk(t, ns, spec):
        if not isinstance(ns, NamedSharding):
            return {k: walk(t[k], ns[k], spec[k]) for k in ns}
        if not BLOCK_AXES.intersection(spec):
            return t
        if is_sharded_tensor(t):
            raise ValueError("shard: the leaf is already a block")
        blk = local_block(t, ns.spec, mesh)
        if blk is t:
            return t
        return from_local(blk.clone() if copy else blk, ns.spec, mesh)

    return walk(tree, shardings, specs)


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

    def constrain(self, x, kind: str):
        """The reference's sharding constraint. The port keeps the
        residual stream and the logits whole on every process, so this
        lays out nothing; it raises if a hook handed back a block."""
        if is_sharded_tensor(x):
            raise ValueError(f"constrain({kind}): a sharded activation "
                             f"(a hook must return it whole)")
        return x

    # ---- runtime (injection into models/transformer) ----
    def runtime(self):
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
                    moe_fn = mp.make_moe_replicated(self.mesh,
                                                    expert_2d=True)
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
            max_seq=self.shape.seq_len,
            moe_dp=moe_dp,
        )
