"""Multi-pod dry run of the port: trace every (arch x shape x mesh) cell.

PyTorch counterpart of ``repro/launch/dryrun.py``. For each cell it runs
the port's own program (the train step: forward, backward with remat and
AdamW; ``transformer.prefill``; ``transformer.decode_step``) on ``meta``
tensors, as rank 0 of a fake ``torch.distributed`` world the size of the
mesh (``torch.testing._internal.distributed.fake_pg``: every collective
completes at once and moves nothing), with the parameters, optimizer
state and caches cut by ``distributed/sharding.shard`` exactly as the
port's processes hold them (each rank its rows of the batch, its blocks
of the axes the plan's ``Layout`` cuts, the parameters FSDP-cut where
the reference's plan is (``plan_fsdp``), ZeRO-1 moments, the train
step's gradient accumulator ZeRO-2 blocks in JAX's ``accum_dtype``),
and records the call with ``launch/op_analysis``: FLOPs, bytes,
collectives and the peak of live storage bytes. Every rank runs the
same program on blocks of the same shapes, so rank 0's numbers stand
for every rank. Beside
them stand the reference's plan numbers, from the reference's own pure
functions over the plan's shardings (``_sharded_bytes``, ``analytic_memory``,
``pick_microbatches``: JAX's arithmetic, FSDP when a TP-only shard
exceeds 4 GB, ZeRO-1 for the optimizer state, experts 2-D on MoE decode),
so one JSON per cell under ``artifacts/dryrun/`` holds what JAX's plan
needs of an H100 (``memory.plan``) and what the port's processes really
hold (``memory.traced``). The roofline takes H100 SXM datasheet figures
(``HW``).

By design the dry run never touches a card, as JAX's runs on 512 host
devices: ``chip_smoke.py`` holds its trace to a real run (the same
prefill on the card, FLOPs and peak memory). A process holds one fake
world, so each mesh runs in a process of its own: ``--mesh both`` starts
two.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

JSON keys as JAX's, except: ``timing.trace_s`` for ``lower_s`` and
``compile_s``; ``torch_raw`` (FlopCounterMode's total) for ``xla_raw``;
``memory.plan`` (JAX's analytic numbers, ``fits_80GB_model``) and
``memory.traced`` (``arg_bytes``, ``peak_bytes``, ``fits_80GB_traced``)
for XLA's memory analysis; ``fits_80GB`` for ``fits_16GB``;
``held`` (the parameter and optimizer-state bytes a rank holds, traced
and planned) and ``layout`` (the logical axes the port cuts).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

from repro_torch.configs import SHAPES, base, registry
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.compat import P, local_of
from repro_torch.launch import op_analysis
from repro_torch.launch import specs as specmod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

# --- hardware figures: NVIDIA H100 SXM5 80 GB ---
HW = {
    # dense BF16 tensor-core peak (NVIDIA H100 datasheet, SXM5, no
    # sparsity)
    "peak_flops_bf16": 989e12,
    # HBM3 bandwidth (NVIDIA H100 datasheet, SXM5)
    "hbm_bw": 3.35e12,
    # NVLink 4: 900 GB/s per GPU both ways, 450e9 a direction (NVIDIA
    # H100 datasheet), for a group within one 8-GPU node (HGX H100)
    "nvlink_bw": 450e9,
    # one 400 Gb/s NDR InfiniBand adapter per GPU (the DGX H100 layout):
    # 50e9 bytes/s, for any group that spans nodes
    "ib_bw": 50e9,
    "node_gpus": 8,
    # HBM3 capacity (NVIDIA H100 datasheet, SXM5)
    "hbm_bytes": 80e9,
}

MESH_NAMES = {False: "16x16", True: "2x16x16"}


def _leaves(tree):
    """Leaves in a fixed order (dict keys sorted); a NamedSharding is a
    leaf."""
    if isinstance(tree, shd.NamedSharding) or isinstance(tree,
                                                        torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _sharded_bytes(shapes_tree, shardings_tree) -> int:
    """Exact per-device bytes of a sharded tree (via shard_shape)."""
    total = 0
    for sds, sh in zip(_leaves(shapes_tree), _leaves(shardings_tree)):
        shard = sh.shard_shape(tuple(sds.shape))
        n = 1
        for d in shard:
            n *= d
        total += n * sds.dtype.itemsize
    return total


def analytic_memory(cfg: base.ModelConfig, shape: base.ShapeConfig,
                    mesh, mb: int, arg_bytes: int) -> dict:
    """Per-device peak model: exact argument bytes + analytic transients.

    Transients (train): remat stores one residual per layer per microbatch
    + ~6 activation-sized f32 workspaces + one gathered layer's params.
    """
    tp = mesh.shape["model"]
    dp = mesh.size // tp
    s, b = shape.seq_len, shape.global_batch
    d = cfg.d_model
    layers = cfg.n_layers + cfg.n_enc_layers
    if shape.kind == "train":
        b_micro = max(b // dp // mb, 1)
        resid = layers * b_micro * s * d * 2
        work = 8 * b_micro * s * d * 4
        gbytes = 2 if cfg.param_count() > 4e11 else 4
        grads = gbytes * cfg.param_count(tp, padded=True) // tp // dp
        transient = resid + work + grads
    elif shape.kind == "prefill":
        b_loc = max(b // dp, 1)
        transient = 10 * b_loc * s * d * 2
    else:
        transient = int(0.5 * arg_bytes) + 64 * d * 4  # cache double-buffer
    peak = arg_bytes + transient
    return {"arg_bytes_exact": arg_bytes, "transient_model": transient,
            "peak_model": peak,
            "fits_80GB_model": bool(peak <= HW["hbm_bytes"])}


def pick_microbatches(cfg: base.ModelConfig, shape: base.ShapeConfig,
                      dp: int) -> int:
    """Heuristic: keep per-microbatch stored activations under ~3 GB/device
    (scan-remat stores one residual per layer)."""
    if shape.kind != "train":
        return 1
    b_loc = max(shape.global_batch // dp, 1)
    layers = cfg.n_layers + (cfg.n_enc_layers or 0)
    act = layers * b_loc * shape.seq_len * cfg.d_model * 2
    mb = 1
    while act / mb > 3e9 and mb < b_loc:
        mb *= 2
    return mb


def plan_fsdp(cfg, shape, mesh) -> bool:
    """The reference's FSDP rule: the parameters are also cut over the
    batch axes when a TP-only shard would exceed 4 GB a device; never on
    MoE decode (its experts are cut 2-D instead)."""
    if cfg.moe is not None and shape.kind == "decode":
        return False
    tp = mesh.shape["model"]
    return 2 * cfg.param_count(tp, padded=True) / tp > 4e9


def plan_shardings(cfg, shape, mesh, params_shapes, pspecs):
    """(param shardings, fsdp) of the reference's plan: FSDP as
    ``plan_fsdp``; on MoE decode the experts 2-D (model x data on the FFN
    hidden dim)."""
    fsdp = plan_fsdp(cfg, shape, mesh)
    overrides = {"expert_f": "__batch__"} \
        if cfg.moe is not None and shape.kind == "decode" else None
    return shd.tree_shardings(params_shapes, pspecs, mesh, zero1=fsdp,
                              overrides=overrides), fsdp


def batch_shardings(batch, mesh) -> dict:
    return {k: shd.NamedSharding(mesh, shd._fit_pspec(
        P(shd.batch_axes(mesh), *([None] * (v.dim() - 1))),
        tuple(v.shape), mesh)) for k, v in batch.items()}


def adamw_for(cfg) -> opt.AdamWConfig:
    return opt.AdamWConfig(
        moments_dtype="int8" if cfg.param_count() > 1.2e11 else "float32")


def plan_memory(cfg, shape, mesh, rt, mb: int) -> dict:
    """The reference's per-device plan numbers of a cell:
    ``analytic_memory`` over ``_sharded_bytes`` of the plan's
    shardings (train: parameters, optimizer state and batch; prefill:
    parameters, batch and the caches it makes; decode: parameters and
    cache), and ``fsdp``."""
    params_shapes, pspecs = tfm.abstract_params(cfg, rt)
    param_sh, fsdp = plan_shardings(cfg, shape, mesh, params_shapes, pspecs)
    held = {"param_bytes": _sharded_bytes(params_shapes, param_sh),
            "opt_bytes": 0}
    if shape.kind == "train":
        adamw = adamw_for(cfg)
        opt_shapes = opt.init_opt_state(params_shapes, adamw)
        opt_sh = shd.tree_shardings(opt_shapes,
                                    opt.opt_state_specs(pspecs, adamw),
                                    mesh, zero1=True)
        held["opt_bytes"] = _sharded_bytes(opt_shapes["moments"],
                                           opt_sh["moments"])
        batch, _ = specmod.input_specs(cfg, shape, rt)
        arg = _sharded_bytes((params_shapes, opt_shapes, batch),
                             (param_sh, opt_sh, batch_shardings(batch,
                                                                mesh)))
    elif shape.kind == "prefill":
        batch, _ = specmod.input_specs(cfg, shape, rt)
        cache, cspecs = specmod.abstract_cache(
            cfg, rt, shape.global_batch,
            shape.seq_len if cfg.enc_dec else 0)
        arg = _sharded_bytes((params_shapes, batch, cache),
                             (param_sh, batch_shardings(batch, mesh),
                              shd.tree_shardings(cache, cspecs, mesh)))
    else:
        inputs, cspecs = specmod.input_specs(cfg, shape, rt)
        arg = _sharded_bytes(
            (params_shapes, inputs["cache"]),
            (param_sh, shd.tree_shardings(inputs["cache"], cspecs, mesh)))
    return {**analytic_memory(cfg, shape, mesh, mb, arg), **held,
            "fsdp": fsdp}


def _held_bytes(tree) -> int:
    """Bytes of this process's blocks of a tree (its local tensors)."""
    return sum(local_of(t).numel() * t.element_size()
               for t in _leaves(tree))


def _group_bw(mesh, axis: str) -> float:
    """NVLink within one node, InfiniBand for a group that spans nodes
    (ranks laid out row-major over the mesh, ``node_gpus`` a node)."""
    names = list(mesh.axis_names)
    stride = math.prod(mesh.devices_shape[names.index(axis) + 1:])
    span = stride * mesh.shape[axis]
    return HW["nvlink_bw"] if span <= HW["node_gpus"] else HW["ib_bw"]


def _shapes_of(tree):
    return [tuple(t.shape) for t in _leaves(tree)]


def build_and_trace(arch: str, shape_name: str, multi_pod: bool,
                    parallel: base.ParallelConfig, mb_override=None, *,
                    shape: Optional[base.ShapeConfig] = None, mesh=None,
                    rt: Optional[tfm.ModelRuntime] = None,
                    mesh_name: Optional[str] = None,
                    cfg: Optional[base.ModelConfig] = None) -> dict:
    """Trace one cell on ``meta`` tensors as rank 0 of the current world
    (a production mesh over the fake world, or ``mesh``; ``shape``,
    ``rt`` and ``cfg`` override the cell's) and return its JSON
    record."""
    cfg = cfg or registry.get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod, device="cpu")
    plan = shd.Plan(mesh, cfg, shape, parallel)
    # the reference's runtime: its scans are the plain (jnp) routes, as
    # JAX's ModelRuntime defaults them (the scan kernels' wrappers have
    # no meta route yet: ROADMAP item 14), and its FSDP rule
    rt = rt or dataclasses.replace(
        plan.runtime(fsdp=plan_fsdp(cfg, shape, mesh)), rglru_impl="jnp",
        ssd_impl="jnp")
    n_dev = mesh.size
    dp = n_dev // mesh.shape["model"]

    params_shapes, pspecs = tfm.abstract_params(cfg, rt)
    # the port's processes: each its blocks under the plan's layout (the
    # recurrent mixers' widths whole: ROADMAP item 13), FSDP as the
    # runtime's layout has it
    params = shd.shard(params_shapes, pspecs, mesh, copy=True,
                       overrides=plan.overrides(),
                       zero1=rt.layout is not None and rt.layout.fsdp)
    held = {"param_bytes": _held_bytes(params), "opt_bytes": 0}
    save = os.environ.get("DRYRUN_SAVE_OPS")
    extra = {}
    mb = 1
    t0 = time.time()
    if shape.kind == "train":
        mb = mb_override or pick_microbatches(cfg, shape, dp)
        adamw = adamw_for(cfg)
        accum = torch.bfloat16 if cfg.param_count() > 4e11 else \
            torch.float32
        # ZeRO-2: the accumulator cut over the batch axes, as JAX's
        step = ts.make_train_step(cfg, rt, adamw, microbatches=mb,
                                  ce_chunk=parallel.ce_chunk,
                                  grad_shardings=ts.zero2_shardings(cfg, rt),
                                  accum_dtype=accum)
        opt_state = opt.init_opt_state(params, adamw,
                                       zero=ts.zero1_plan(cfg, rt, adamw))
        held["opt_bytes"] = _held_bytes(opt_state["moments"])
        batch, _ = specmod.input_specs(cfg, shape, rt)
        _, ana = op_analysis.analyze(step, params, opt_state, batch,
                                     save_ops=save)
        extra = {"microbatches": mb, "moments": adamw.moments_dtype}
    elif shape.kind == "prefill":
        batch, _ = specmod.input_specs(cfg, shape, rt)
        cache, _ = specmod.abstract_cache(
            cfg, rt, shape.global_batch,
            shape.seq_len if cfg.enc_dec else 0)

        def prefill_step(p, b):
            with torch.no_grad():
                return tfm.prefill(p, cfg, rt, b["tokens"],
                                   prefix_embeds=b.get("prefix_embeds"),
                                   enc_frames=b.get("enc_frames"))

        # a serving rank holds what prefill reads (not labels or a mask)
        inputs = {k: v for k, v in batch.items()
                  if k in ("tokens", "prefix_embeds", "enc_frames")}
        (logits, caches), ana = op_analysis.analyze(prefill_step, params,
                                                    inputs, save_ops=save)
        if _shapes_of(caches) != _shapes_of(cache) or \
                tuple(logits.shape) != (shape.global_batch,
                                        cfg.padded_vocab):
            raise RuntimeError(f"{arch}: prefill made caches or logits of "
                               f"other shapes than init_cache's")
    else:
        inputs, cspecs = specmod.input_specs(cfg, shape, rt)
        cache = shd.shard(inputs["cache"], cspecs, mesh, copy=True)
        pos = shape.seq_len - 1  # the last slot of a full context

        def serve_step(p, c, tokens):
            with torch.no_grad():
                return tfm.decode_step(p, cfg, rt, c, tokens, pos)

        (logits, _), ana = op_analysis.analyze(
            serve_step, params, cache, inputs["tokens"], save_ops=save)
        extra = {"pos": pos}
    t_trace = time.time() - t0
    pm = plan_memory(cfg, shape, mesh, rt, mb)
    extra["fsdp"] = pm.pop("fsdp")
    plan_held = {k: pm.pop(k) for k in ("param_bytes", "opt_bytes")}

    flops_dev = float(ana["flops"])
    bytes_dev = float(ana["bytes"])
    wire = float(ana["wire_bytes"])
    t_comp = flops_dev / HW["peak_flops_bf16"]
    t_mem = bytes_dev / HW["hbm_bw"]
    t_coll = sum(w / _group_bw(mesh, a)
                 for a, w in ana["wire_by_axis"].items())
    dominant = max(("compute", t_comp), ("memory", t_mem),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]

    n_par = cfg.param_count()
    n_act = cfg.active_param_count()
    if shape.kind == "train":
        model_flops = 6.0 * n_act * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        model_flops = 2.0 * n_act * shape.global_batch * shape.seq_len
    else:
        model_flops = 2.0 * n_act * shape.global_batch
    model_flops_dev = model_flops / n_dev
    peak = int(ana["peak_bytes"])
    return {
        "arch": arch, "shape": shape.name,
        "mesh": mesh_name or MESH_NAMES[multi_pod],
        "n_devices": n_dev,
        "rank": 0,
        "ranks": "every rank runs the same program on blocks of the same "
                 "shapes: rank 0's numbers stand for each",
        "kind": shape.kind,
        "params": n_par, "active_params": n_act,
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "torch_raw": ana["torch_raw"],
        "collectives": ana["collectives"],
        "collective_wire_bytes": wire,
        "collective_wire_by_axis": ana["wire_by_axis"],
        "bytes_by_tag": ana["bytes_by_tag"],
        "flops_by_tag": ana["flops_by_tag"],
        "kernels": ana["kernels"],
        "ops": ana["ops"],
        "memory": {
            "plan": pm,
            "traced": {"arg_bytes": int(ana["held_bytes"]),
                       "peak_bytes": peak,
                       "fits_80GB_traced": bool(peak <= HW["hbm_bytes"])},
            "fits_80GB": pm["fits_80GB_model"],
        },
        # the parameter and optimizer-state bytes a rank holds, the port's
        # (traced) beside the plan's (_sharded_bytes); the difference is
        # what the port keeps whole by design (ROADMAP item 13)
        "held": {"traced": held, "plan": plan_held,
                 "whole_by_design": sum(held.values()) -
                 sum(plan_held.values())},
        "layout": list(rt.layout.axes()) if rt.layout is not None else [],
        "roofline": {
            "compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll,
            "dominant": dominant,
            "model_flops_per_device": model_flops_dev,
            "useful_compute_ratio": model_flops_dev / max(flops_dev, 1.0),
            "roofline_fraction": model_flops_dev / HW["peak_flops_bf16"] /
            max(t_comp, t_mem, t_coll, 1e-12),
        },
        "timing": {"trace_s": t_trace},
        "seq_parallel": parallel.seq_parallel,
        **extra,
    }


def init_fake_world(size: int) -> None:
    """Join a fake world of ``size`` ranks as rank 0 (no process is
    started; every collective completes at once)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _run_meshes(argv, meshes) -> int:
    """``--mesh both``: one process a mesh (a process holds one fake
    world), side by side, their lines prefixed by the mesh."""
    procs = []
    for m in meshes:
        args = list(argv)
        i = args.index("--mesh")
        args[i + 1] = m
        procs.append((m, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun"] + args,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))

    def pump(tag, p):
        for line in p.stdout:
            print(f"[{tag}] {line}", end="", flush=True)

    threads = [threading.Thread(target=pump, args=mp) for mp in procs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return max(p.wait() for _, p in procs)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--mb", type=int, default=None)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--attn-impl", default="blockwise")
    ap.add_argument("--remat", default="block", choices=["block", "dots",
                                                         "none"])
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    if args.mesh == "both":
        if "--mesh" not in argv:
            argv += ["--mesh", "both"]
        return _run_meshes(argv, ("single", "multi"))

    torch.set_num_threads(1)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    multi = args.mesh == "multi"
    mesh_name = MESH_NAMES[multi]
    init_fake_world(512 if multi else 256)
    cells = list(registry.cells(args.arch, args.shape))
    parallel = base.ParallelConfig(seq_parallel=args.seq_parallel,
                                   attn_impl=args.attn_impl,
                                   remat=args.remat)
    failures = 0
    for cell in cells:
        tag = f"_{args.tag}" if args.tag else ""
        fname = outdir / (f"{cell.arch}_{cell.shape.name}_"
                          f"{mesh_name}{tag}.json")
        if cell.skip:
            with open(fname, "w") as fh:
                json.dump({"arch": cell.arch, "shape": cell.shape.name,
                           "mesh": mesh_name, "skipped": cell.skip}, fh,
                          indent=1)
            print(f"[skip] {cell.name} ({mesh_name}): {cell.skip}")
            continue
        print(f"[cell] {cell.name} ({mesh_name}) ...", flush=True)
        try:
            res = build_and_trace(cell.arch, cell.shape.name, multi,
                                  parallel, args.mb)
            with open(fname, "w") as fh:
                json.dump(res, fh, indent=1)
            r, m = res["roofline"], res["memory"]
            print(f"  ok: flops/dev={res['flops_per_device']:.3e} "
                  f"dom={r['dominant']} "
                  f"roofline={r['roofline_fraction']:.3f} "
                  f"fits={m['fits_80GB']} "
                  f"fits_traced={m['traced']['fits_80GB_traced']} "
                  f"trace={res['timing']['trace_s']:.1f}s", flush=True)
        except Exception as e:
            failures += 1
            print(f"  FAIL: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
