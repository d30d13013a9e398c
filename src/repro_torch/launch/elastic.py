"""Elastic restart launcher: train on N nodes, checkpoint to node-local pmem,
then resume on a different node count from the same pools.

PyTorch counterpart of ``repro/launch/elastic.py``: the same flags and
defaults (JAX's smoke config, shape ``("cli", 32, 4, "train")``, AdamW lr
1e-3 with a 10-step warmup, ``ce_chunk`` 128), plus ``--device`` (``cuda``
unless the caller asks for ``cpu``; without a card ``cuda`` raises). The
flow is JAX's, in ``run``:

1. train ``steps`` steps on a ``nodes_before``-node cluster over
   ``<root>/phase1``, save parameters and optimizer state at step
   ``steps`` and wait for the buddy replicas;
2. open a second cluster over the same ``phase1`` pools (the first one
   still live, as in JAX) and ``restore(steps)`` there: each leaf is
   reassembled from its shards' byte ranges, on ``device``;
3. train ``steps`` more on a fresh ``nodes_after``-node cluster over
   ``<root>/phase2`` and save the parameters at ``2 * steps``;
4. raise unless the resumed first loss is below phase 1's first loss.

JAX's 1 x 1 mesh and sharding plan change nothing on one device; the step
is built as ``launch/train.py`` builds it. Parameters are random from a
seeded ``torch.Generator``, not JAX's. The pools live under ``--root``,
else in a fresh scratch directory that is removed at the end (JAX keeps
its ``tempfile.mkdtemp()``).

    PYTHONPATH=src python -m repro_torch.launch.elastic --device cpu
    PYTHONPATH=src python -m repro_torch.launch.elastic   # on the card
"""
from __future__ import annotations

import argparse
import shutil
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import ParallelConfig, ShapeConfig, registry
from repro_torch.core.cluster import SimCluster
from repro_torch.core.pmem import scratch_root
from repro_torch.data.pipeline import StagedDataset
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts


def _runtime(shape: ShapeConfig) -> tfm.ModelRuntime:
    par = ParallelConfig()
    return tfm.ModelRuntime(tp=1, attn_impl=par.attn_impl,
                            remat=par.remat != "none",
                            max_seq=shape.seq_len)


def _build(cfg, shape, lr):
    rt = _runtime(shape)
    adamw = opt.AdamWConfig(lr=lr, warmup=10)
    step_fn = ts.make_train_step(cfg, rt, adamw, ce_chunk=128)
    return rt, adamw, step_fn


def run(cfg, shape: ShapeConfig, params, device, *, root: Path,
        steps: int = 6, nodes_before: int = 4, nodes_after: int = 2,
        pmem_capacity: int = 1 << 32,
        check: Optional[Callable[[str, dict], None]] = None) -> dict:
    """Both phases from ``params`` (tensors on ``device``). ``check(kind,
    tree)``, when given, sees the state saved at step ``steps`` just after
    the save (``"saved"``) and the restored state (``"restored"``). The
    caller's reference to ``params`` should be its only one: the live
    phase-1 state is dropped after its save, so the card holds one state
    beside the restore. Returns the losses of both phases, the manifests
    and the seconds of the phase-1 steps, the save (its commit), its
    replicas (from the commit to ``wait_async``), the restore and the
    resume (its steps and its save)."""
    device = resolve_device(device)
    root = Path(root)
    _rt, adamw, step_fn = _build(cfg, shape, 1e-3)
    opt_state = opt.init_opt_state(params, adamw)
    clusters = []

    def cluster(sub: str, n: int) -> SimCluster:
        c = SimCluster(root / sub, n_nodes=n, pmem_capacity=pmem_capacity,
                       device=device)
        clusters.append(c)
        return c

    try:
        c1 = cluster("phase1", nodes_before)
        data = StagedDataset(c1, cfg, shape, n_shards=2, seqs_per_shard=16)
        losses = []
        t0 = time.perf_counter()
        for batch in data.batches(steps):
            params, opt_state, m = step_fn(params, opt_state, batch)
            losses.append(float(m["loss"]))
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        man1 = c1.checkpointer.save(steps, {"params": params,
                                            "opt": opt_state})
        save_s = time.perf_counter() - t0
        c1.checkpointer.wait_async()
        replicate_s = time.perf_counter() - t0 - save_s
        if check is not None:
            check("saved", {"params": params, "opt": opt_state})
        del params, opt_state
        print(f"phase1 ({nodes_before} nodes): loss {losses[0]:.3f} -> "
              f"{losses[-1]:.3f}; checkpoint written node-locally")

        # elastic: a second cluster over the same pools reassembles every
        # leaf from its shards' byte ranges
        c2 = cluster("phase1", nodes_before)
        t0 = time.perf_counter()
        restored, man = c2.checkpointer.restore(steps)
        restore_s = time.perf_counter() - t0
        if check is not None:
            check("restored", restored)
        params2, opt2 = restored.pop("params"), restored.pop("opt")
        # resume on the smaller cluster (new pools, new shard plan)
        c3 = cluster("phase2", nodes_after)
        data2 = StagedDataset(c3, cfg, shape, n_shards=2, seqs_per_shard=16)
        losses2 = []
        t0 = time.perf_counter()
        for batch in data2.batches(steps):
            params2, opt2, m = step_fn(params2, opt2, batch)
            losses2.append(float(m["loss"]))
        man3 = c3.checkpointer.save(2 * steps, {"params": params2})
        c3.checkpointer.wait_async()
        resume_s = time.perf_counter() - t0
        print(f"phase2 ({nodes_after} nodes): resumed, loss "
              f"{losses2[0]:.3f} -> {losses2[-1]:.3f}")
        if not losses2[0] < losses[0]:
            raise RuntimeError(f"resume lost progress: {losses2[0]} >= "
                               f"{losses[0]}")
    finally:
        for c in clusters:
            c.shutdown()
    return dict(losses=losses, losses2=losses2, saved=man1, restored=man,
                resumed=man3, train_s=train_s, save_s=save_s,
                replicate_s=replicate_s, restore_s=restore_s,
                resume_s=resume_s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--nodes-before", type=int, default=4)
    ap.add_argument("--nodes-after", type=int, default=2)
    ap.add_argument("--root", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = registry.get_smoke_config(args.arch)
    shape = ShapeConfig("cli", 32, 4, "train")
    gen = torch.Generator(device=device).manual_seed(0)
    root = Path(args.root) if args.root else scratch_root()
    try:
        return run(cfg, shape, tfm.init_params(cfg, _runtime(shape), gen,
                                               device=device),
                   device, root=root, steps=args.steps,
                   nodes_before=args.nodes_before,
                   nodes_after=args.nodes_after)
    finally:
        if not args.root:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
