"""End-to-end training driver: --arch <id> [--smoke] on the card.

PyTorch counterpart of ``repro/launch/train.py``: the same flags and
defaults, plus ``--device`` (``cuda`` unless the caller asks for ``cpu``;
without a card ``cuda`` raises). It builds the model, the train step
(blockwise attention, remat on each layer, ``ce_chunk`` 128, AdamW with a
10-step warmup), a ``SimCluster`` (staged data, asynchronous node-local
checkpoints, delta-int8 ones with ``--delta-ckpt``, whose codec runs in
the Hopper kernels on the card), runs the loop and checks that the loss
went down. Parameters are random from a seeded ``torch.Generator``, not
JAX's. The pools live under ``--root``, else in a fresh scratch directory
that is removed at the end. Every save is replicated to its ring buddy.
``--fault-at N`` kills the last node after step N, restores the newest
recoverable checkpoint around it (a delta step decoded on the card),
repairs the replicas and resumes (``recoveries=[N]`` in the summary).

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --delta-ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --smoke --delta-ckpt --fault-at 12
"""
from __future__ import annotations

import argparse
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ParallelConfig, ShapeConfig, registry
from repro_torch.core.cluster import SimCluster
from repro_torch.core.pmem import scratch_root
from repro_torch.data.pipeline import StagedDataset
from repro_torch.models import transformer as tfm
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--delta-ckpt", action="store_true")
    ap.add_argument("--fault-at", type=int, default=None)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--root", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = registry.get_smoke_config(args.arch) if args.smoke \
        else registry.get_config(args.arch)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    par = ParallelConfig(attn_impl="blockwise")
    rt = tfm.ModelRuntime(tp=1, attn_impl=par.attn_impl,
                          remat=par.remat != "none", max_seq=args.seq)
    params = tfm.init_params(cfg, rt, torch.Generator(device=device)
                             .manual_seed(0), device=device)
    adamw = opt.AdamWConfig(lr=args.lr, warmup=10)
    opt_state = opt.init_opt_state(params, adamw)
    step_fn = ts.make_train_step(cfg, rt, adamw,
                                 microbatches=par.microbatches, ce_chunk=128)

    base = Path(args.root) if args.root else scratch_root()
    cluster = SimCluster(base / str(int(time.time())), n_nodes=args.nodes,
                         delta=args.delta_ckpt, device=device)
    try:
        data = StagedDataset(cluster, cfg, shape, n_shards=4,
                             seqs_per_shard=max(args.batch * 2, 16))
        lc = train_loop.LoopConfig(steps=args.steps,
                                   ckpt_every=args.ckpt_every,
                                   delta_ckpt=args.delta_ckpt)
        t0 = time.time()
        state = train_loop.run(step_fn, params, opt_state,
                               data.batches(args.steps), cluster, lc,
                               fault_at=args.fault_at)
        dt = time.time() - t0
    finally:
        cluster.shutdown()
        if not args.root:
            shutil.rmtree(base, ignore_errors=True)
    print(f"arch={cfg.name} steps={state.step} "
          f"loss {state.losses[0]:.3f} -> {state.losses[-1]:.3f} "
          f"({dt:.1f}s, ckpt avg {np.mean(state.ckpt_seconds or [0]):.3f}s, "
          f"recoveries={state.recovered_at})")
    if not state.losses[-1] < state.losses[0]:
        raise RuntimeError(f"loss did not decrease: {state.losses}")
    return state


if __name__ == "__main__":
    main()
