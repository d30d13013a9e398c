"""Pipeline parallelism over the 'pod' axis (optional role, GPipe schedule).

PyTorch counterpart of ``repro/distributed/pipeline.py``. The multi-pod
mesh's "pod" axis defaults to data-parallel; this module lets it act as
a pipeline axis instead: layer groups are stacked [n_stages, ...] and
sharded P('pod'); microbatches stream through the stages with ppermute
hand-offs (the reference's ``lax.scan`` is a loop here). Fill/drain
bubbles are the standard (n_stages - 1) / (n_micro + n_stages - 1)
fraction.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed.compat import (P, axis_index, ppermute, psum,
                                            shard_map)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_apply(mesh, stage_fn: Callable, stage_params,
                   x_micro: torch.Tensor, axis: str = "pod") -> torch.Tensor:
    """Run ``stage_fn(params_stage, x) -> x`` over pipeline stages.

    stage_params: tree with leading [n_stages] dim (sharded on ``axis``).
    x_micro: [n_micro, mb, ...] microbatched activations (replicated on
    ``axis``). Returns [n_micro, mb, ...] outputs of the LAST stage, on
    every stage.
    """
    n_stages = mesh.shape[axis]

    def inner(params, xm):
        # params: leading dim 1 (my stage); xm [n_micro, mb, ...] replicated
        my_params = _tree_map(lambda a: a[0], params)
        sid = axis_index(axis)
        n_micro = xm.shape[0]
        total = n_micro + n_stages - 1
        perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
        buf = torch.zeros_like(xm[0])
        outs = torch.zeros_like(xm)
        for t in range(total):
            # stage 0 ingests microbatch t (if in range)
            if sid == 0:
                buf = xm[min(max(t, 0), n_micro - 1)]
            y = stage_fn(my_params, buf)
            # last stage emits microbatch t - (n_stages - 1)
            emit_idx = t - (n_stages - 1)
            if sid == n_stages - 1 and emit_idx >= 0:
                outs[emit_idx] = y
            buf = ppermute(y, axis, perm)
        # broadcast last stage's outputs to all stages for a clean out_spec
        return psum(outs if sid == n_stages - 1 else torch.zeros_like(outs),
                    axis)

    fn = shard_map(inner, mesh=mesh, in_specs=(P(axis), P()), out_specs=P(),
                   check_vma=False)
    return fn(stage_params, x_micro)
