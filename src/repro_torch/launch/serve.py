"""Serving driver: --arch <id> --smoke — batched prefill+decode with pmem
state spill/resume demo, on the card through the port's kernels.

PyTorch counterpart of ``repro/launch/serve.py``: the same flags and
defaults, plus ``--device`` (``cuda`` unless the caller asks for ``cpu``).
Prefill runs the Hopper kernels (``ModelRuntime``'s defaults: flash
attention, the RG-LRU and the SSD scans, and the grouped expert matmul,
which decode runs too), where the JAX CLI's smoke choices are ``naive``
attention, the ``jnp`` scans and the dense gshard MoE. As JAX's, it
builds a one-node ``SimCluster`` on a scratch pool (``--root``, else a
fresh directory that is removed at the end), spills the session through
its TieredIO write-back cache, warms it back with ``prefetch_sessions``
and resumes from DRAM.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch mamba2-1.3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch grok-1-314b
"""
from __future__ import annotations

import argparse
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.core.cluster import SimCluster
from repro_torch.core.pmem import scratch_root
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-72b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--root", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = registry.get_smoke_config(args.arch)
    max_seq = args.prompt_len + args.gen + 8
    rt = tfm.ModelRuntime(tp=1, attn_impl="pallas", max_seq=max_seq)
    gen = torch.Generator(device=device).manual_seed(0)
    params = tfm.init_params(cfg, rt, gen, device=device)
    root = Path(args.root) if args.root else scratch_root()
    cluster = None
    try:
        cluster = SimCluster(root, n_nodes=1, device=device)
        eng = ServeEngine(cfg, rt, params, store=cluster.stores["node0"],
                          tiered=cluster.tiered, device=device)
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab_size,
                               (args.batch, args.prompt_len)).astype(np.int32)
        t0 = time.time()
        first = eng.prefill(prompts)
        t_prefill = time.time() - t0
        t0 = time.time()
        out = eng.decode(first, args.gen)
        t_decode = time.time() - t0
        # pmem persistence of serving state: spill through the TieredIO
        # write-back cache, warm it back via prefetch, resume
        eng.spill("session0")
        eng.prefetch_sessions(["session0"]).result()
        eng.resume("session0")
        more = eng.decode(out[:, -1], 4)
        print(f"arch={cfg.name} batch={args.batch} prefill={t_prefill:.2f}s "
              f"decode={args.gen}tok/{t_decode:.2f}s "
              f"({args.batch * args.gen / max(t_decode, 1e-9):.1f} tok/s) "
              f"spill/resume ok, +4 more tokens: {more[:, 1:].shape}")
    finally:
        if cluster is not None:
            cluster.shutdown()
        if not args.root:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
