"""Gloo worlds for the port's distributed tests, and the port side of
their cases.

``run_world(target, world, tmp, *args)`` starts ``world`` processes with
``torch.multiprocessing`` (spawn) on the CPU, each joining a gloo world
through a ``FileStore`` under ``tmp`` (no port: six xdist workers run at
once), calls ``target(rank, world, tmp, *args)`` and returns what each
rank pickled into ``tmp/rank{r}.pkl``. This module imports neither JAX
nor the JAX package, so that the spawned processes stay light; the test
files hold the JAX side.
"""
from __future__ import annotations

import pickle
import traceback
from pathlib import Path

import numpy as np

WORLD_TIMEOUT_S = 240


def _entry(rank, target, world, tmp, args, device, backend):
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_world
    torch.set_num_threads(1)
    out = Path(tmp) / f"rank{rank}.pkl"
    try:
        init_world(rank, world, Path(tmp) / "store", device=device,
                   backend=backend)
        res = target(rank, world, Path(tmp), *args)
    except BaseException:
        out.write_bytes(pickle.dumps({"error": traceback.format_exc()}))
        raise
    out.write_bytes(pickle.dumps(res))
    if dist.get_backend() == "gloo":  # a refused NCCL world is left as is
        dist.destroy_process_group()


def run_world(target, world: int, tmp, *args, device="cpu",
              backend=None) -> list:
    import torch.multiprocessing as mp
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(
        _entry, args=(target, world, str(tmp), args, device, backend),
        nprocs=world, join=False, start_method="spawn")
    import time
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"world of {world} past "
                                   f"{WORLD_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    res = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
           for r in range(world)]
    for r in res:
        if isinstance(r, dict) and "error" in r:
            raise RuntimeError(r["error"])
    return res


def _np(t):
    from repro_torch.bridge import to_numpy
    from repro_torch.distributed.compat import is_sharded_tensor
    return to_numpy(t.to_local() if is_sharded_tensor(t) else t)


# ---------------------------------------------------------------------------
# test_torch_distributed.py: flash-decode, compression, pipeline
# ---------------------------------------------------------------------------

def distributed_cases(rank, world, tmp, inputs, extra):
    """Every case of ``inputs`` on its mesh, and the gradient cases of
    ``extra`` on (2, 2); returns {case: outputs}."""
    import torch
    from repro_torch.distributed import compat
    from repro_torch.distributed.compression import (
        compressed_psum_scatter_gather)
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.decode_attn import make_flash_decode
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh

    out = {}
    meshes = {}

    def mesh_of(shape, axes):
        key = (tuple(shape), tuple(axes))
        if key not in meshes:
            meshes[key] = make_mesh(shape, axes, "cpu")
        return meshes[key]

    for name, case in inputs.items():
        mesh = mesh_of(case["mesh"], case["axes"])
        t = {k: torch.from_numpy(np.array(v)) for k, v in case.items()
             if isinstance(v, np.ndarray)}
        if case["kind"] == "flash_decode":
            # inside the layout, as decode_step runs it: this rank's rows
            # and q heads, the caches as DTensors of their blocks
            fd = make_flash_decode(mesh)
            write = "kn" in t
            lay = shd.Layout(mesh)
            rows = lay.row_entry(t["kc"].shape[0])
            kv, kp = compat.P(rows, "model", None, None), \
                compat.P(rows, "model")
            caches = [compat.from_local(compat.local_block(x, s, mesh)
                                        .clone(), s, mesh)
                      for x, s in ((t["kc"], kv), (t["vc"], kv),
                                   (t["kpos"], kp))]
            compat.reset_stats()
            o, c = lay.run(
                lambda kc, vc, kpos, kn, vn, q: fd(
                    kc, vc, kpos, kn, vn, q, int(case["pos"]),
                    window=int(case["window"]), cap=float(case["cap"])),
                (*caches, t.get("kn"), t.get("vn"), t["q"]),
                (compat.AS_IS,) * 3 + (compat.P(rows, None, None),) * 2 +
                (compat.P(rows, "model", None),),
                (compat.P(rows, "model", None), compat.AS_IS))
            res = {"bytes_model": compat.bytes_over("model"),
                   "o": _np(compat.to_replicated(o, mesh))}
            for k, v in c.items():
                res[k] = _np(v)
                res[k + "_sharded"] = compat.is_sharded_tensor(v)
            res["write"] = write
            out[name] = res
        elif case["kind"] == "compression":
            def body(xl, el):
                y, e = compressed_psum_scatter_gather(xl[0], "data", el[0])
                return y[None], e[None]
            f = compat.shard_map(body, mesh=mesh,
                                 in_specs=(compat.P("data"), compat.P("data")),
                                 out_specs=(compat.P("data"),
                                            compat.P("data")))
            y, e = f(t["x"], t["err0"])
            acc = torch.zeros_like(t["x"][0])
            eacc = t["err0"]
            for _ in range(int(case["rounds"])):
                yy, eacc = f(t["x"], eacc)
                acc = acc + yy.to_local()[0]
            out[name] = {"y": _np(y.to_local()[0]), "err": _np(e.to_local()),
                         "acc": _np(acc)}
        elif case["kind"] == "pipeline":
            def stage_fn(w, h):
                return torch.tanh(h @ w)
            y = pipeline_apply(mesh, stage_fn, t["ws"], t["x"], axis="pod")
            out[name] = {"out": _np(y)}

    out.update(gradient_cases(mesh_of((2, 2), ("data", "model")), extra))
    return out


GRAD_NAMES = ["psum", "pmean", "pmax", "all_gather", "all_gather_stacked",
              "psum_scatter", "all_to_all", "ppermute"]
#: over the tuple ("data", "model"): meshes with a data axis
GRAD_NAMES_DM = ["psum_dm", "all_gather_dm"]


def _grad_def(name: str, tp: int):
    """(body, in_spec, out_spec) of a collective gradient case, as the
    JAX side of test_torch_distributed.py defines it."""
    from repro_torch.distributed import compat as c
    dm = ("data", "model")
    return {
        "psum": (lambda a: c.psum(a, "model"), c.P("model"), c.P()),
        "pmean": (lambda a: c.pmean(a, "model"), c.P("model"), c.P()),
        "pmax": (lambda a: c.pmax(a, "model"), c.P("model"), c.P()),
        "all_gather": (lambda a: c.all_gather(a, "model", axis=0,
                                              tiled=True),
                       c.P("model"), c.P()),
        "all_gather_stacked": (lambda a: c.all_gather(a, "model", axis=1),
                               c.P("model"), c.P()),
        "psum_scatter": (lambda a: c.psum_scatter(
            a, "model", scatter_dimension=0, tiled=True), c.P("model"),
            c.P("model")),
        "all_to_all": (lambda a: c.all_to_all(a, "model", 0, 1, tiled=True),
                       c.P("model"), c.P("model")),
        "ppermute": (lambda a: c.ppermute(
            a, "model", [(i, i + 1) for i in range(tp - 1)]), c.P("model"),
            c.P("model")),
        "psum_dm": (lambda a: c.psum(a, dm), c.P(dm), c.P()),
        "all_gather_dm": (lambda a: c.all_gather(a, dm, axis=0, tiled=True),
                          c.P(dm), c.P()),
    }[name]


def gradient_cases(mesh, extra) -> dict:
    """The collective gradient cases and the MoE training step of
    ``extra`` on ``mesh``: {"grads": {case: ...}, "moe_train": ...}."""
    import torch
    from repro_torch.distributed import compat
    grads = {}
    for name, case in extra["grads"].items():
        body, ins, outs = _grad_def(name.split("_", 1)[1],
                                    mesh.shape["model"])
        x = torch.from_numpy(case["x"]).requires_grad_()
        y = compat.to_replicated(compat.shard_map(
            body, mesh=mesh, in_specs=(ins,), out_specs=outs)(x), mesh)
        res = {"y": _np(y)}
        compat.reset_stats()
        try:
            (y * torch.from_numpy(case["w"])).sum().backward()
            res["grad"] = _np(x.grad)
        except NotImplementedError as e:
            res["error"] = str(e)
        res["backward_calls"] = sum(v["calls"] for ops in
                                    compat.stats().values()
                                    for v in ops.values())
        grads[name] = res
    return {"grads": grads, "moe_train": moe_train_case(mesh,
                                                        extra["moe_train"])}


def moe_train_case(mesh, ref) -> dict:
    """grok-1's smoke config: the training loss and the gradient of every
    parameter through the train plan's MoE hook, from JAX's float32
    parameters cut into this rank's blocks; DTensor gradients gathered
    whole."""
    import torch
    from repro_torch import bridge
    from repro_torch.configs import ParallelConfig, ShapeConfig, registry
    from repro_torch.distributed import compat
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as tfm
    from repro_torch.train import train_step

    cfg = registry.get_smoke_config("grok-1-314b")
    b, s = ref["batch"]["tokens"].shape
    rt = shd.Plan(mesh, cfg, ShapeConfig("t", s, b, "train"),
                  ParallelConfig()).runtime()
    tfm.check_trainable(cfg, rt)
    params = bridge.params_from_host(
        bridge.tree_from_leaves(ref["params"]), "cpu")
    params = shd.shard(params, tfm.param_specs(cfg, rt), mesh)
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    loss_fn = train_step.make_loss_fn(cfg, rt, 512)
    leaves = dict(bridge.tree_leaves(params))
    live = {k: t.detach().requires_grad_() for k, t in leaves.items()}
    loss, _ = loss_fn(bridge.tree_from_leaves(live), batch)
    compat.reset_stats()
    grads = torch.autograd.grad(loss, list(live.values()))
    calls = sum(v["calls"] for ops in compat.stats().values()
                for v in ops.values())
    with torch.no_grad():
        whole = {k: _np(compat.to_replicated(g, mesh))
                 for k, g in zip(live, grads)}
    return {"loss": float(loss.detach()), "grads": whole, "hook":
            rt.moe_fn.__qualname__, "backward_collectives": calls,
            "sharded": any(compat.is_sharded_tensor(t)
                           for t in leaves.values())}


def slice_case(rank, world, tmp, ref, extra):
    """grok-1's smoke config at (1, 2): prefill through the prefill
    plan, then decode steps through the decode plan, from JAX's float32
    parameters; returns the logits and each rank's block shapes, and the
    gradient cases of ``extra`` on (1, 2)."""
    import torch
    from repro_torch import bridge
    from repro_torch.configs import ParallelConfig, ShapeConfig, registry
    from repro_torch.distributed import compat
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm

    cfg = registry.get_smoke_config("grok-1-314b")
    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    b, s = ref["tokens"].shape
    ring = int(ref["ring"])
    pre = shd.Plan(mesh, cfg, ShapeConfig("p", ring, b, "prefill"),
                   ParallelConfig()).runtime()
    dec = shd.Plan(mesh, cfg, ShapeConfig("d", ring, b, "decode"),
                   ParallelConfig()).runtime()
    params = bridge.params_from_host(
        bridge.tree_from_leaves(ref["params"]), "cpu")
    params = shd.shard(params, tfm.param_specs(cfg, pre), mesh)
    wi = params["group0"]["p0"]["mlp"]["wi"]
    with torch.no_grad():
        logits, cache = tfm.prefill(params, cfg, pre,
                                    torch.from_numpy(ref["tokens"]))
        cache = shd.shard(cache, tfm.cache_specs(cfg, dec, b), mesh)
        k0 = cache["group0"]["p0"]["self"]["k"]
        steps = [_np(compat.to_replicated(logits, mesh))]
        for i, tok in enumerate(ref["decode_tokens"]):
            lg, cache = tfm.decode_step(params, cfg, dec, cache,
                                        torch.from_numpy(tok), s + i)
            steps.append(_np(compat.to_replicated(lg, mesh)))
    return {"logits": steps, "k_local": tuple(k0.to_local().shape),
            "k_global": tuple(k0.shape),
            "wi_local": tuple(wi.to_local().shape),
            "dense_local": {k: tuple(compat.local_of(t).shape) for k, t in
                            (("wq", params["group0"]["p0"]["mixer"]["wq"]),
                             ("wo", params["group0"]["p0"]["mixer"]["wo"]),
                             ("in_embed", params["in_embed"]),
                             ("out_embed", params["out_embed"]))},
            "kpos": _np(cache["group0"]["p0"]["self"]["kpos"]),
            **gradient_cases(mesh, extra)}


# ---------------------------------------------------------------------------
# test_torch_dense_layout.py
# ---------------------------------------------------------------------------

def _blocks(tree, specs) -> tuple:
    """({path: (local shape, whole shape)}, {path: logical spec})."""
    from repro_torch.bridge import tree_leaves
    from repro_torch.distributed.compat import local_of
    shapes = {k: (tuple(local_of(t).shape), tuple(t.shape))
              for k, t in tree_leaves(tree)}
    return shapes, dict(tree_leaves(specs))


def dense_layout_cases(rank, world, tmp, ref):
    """Every case of ``ref`` (``{mesh}_{arch}``: JAX's parameters, inputs
    and outputs) through the port's plans on its mesh over this world:
    prefill, the decode plan's prefill and greedy steps fed JAX's tokens,
    the loss and its gradients, one train step with ZeRO-1 moments; the
    outputs gathered whole, and each leaf's block shapes."""
    import dataclasses

    import torch
    from repro_torch import bridge
    from repro_torch.configs import ParallelConfig, ShapeConfig, registry
    from repro_torch.distributed import compat
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    meshes, out = {}, {}
    for case, r in ref.items():
        mname, arch = case.split("_", 1)
        shape = tuple(int(n) for n in mname.split("x"))
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("data", "model"), "cpu")
        mesh = meshes[shape]
        cfg = registry.get_smoke_config(arch)
        b, s = r["tokens"].shape
        ring = 2 * s
        rts = {k: dataclasses.replace(
            shd.Plan(mesh, cfg, ShapeConfig(k, n, b, k),
                     ParallelConfig()).runtime(),
            attn_impl="blockwise", rglru_impl="jnp", ssd_impl="jnp")
            for k, n in (("prefill", ring), ("decode", ring), ("train", s))}

        def whole(t):  # a copy: decode writes the caches in place
            t = compat.to_replicated(t, mesh)
            return np.array(_np(t.float() if t.is_floating_point() else t))

        def laid_out(kind):
            rt = rts[kind]
            params = bridge.params_from_host(
                bridge.tree_from_leaves(r["params"][kind]), "cpu")
            specs = tfm.param_specs(cfg, rt)
            return rt.layout.shard(params, specs), specs

        tokens = torch.from_numpy(r["tokens"])
        frames = None if r["frames"] is None else \
            torch.from_numpy(r["frames"])
        resid = shd.Plan(mesh, cfg, ShapeConfig("p", ring, b, "prefill"),
                         ParallelConfig()).constrain(torch.zeros(b, s, 4),
                                                     "resid")
        res = {"blocks": {}, "logical": {},
               "resid_rows": tuple(compat.local_of(resid).shape)}
        with torch.no_grad():
            p, specs = laid_out("prefill")
            res["blocks"]["params_prefill"], \
                res["logical"]["params_prefill"] = _blocks(p, specs)
            lg, _ = tfm.prefill(p, cfg, rts["prefill"], tokens,
                                enc_frames=frames)
            res["prefill_logits"] = whole(lg)
            rt = rts["decode"]
            p, specs = laid_out("decode")
            res["blocks"]["params_decode"], \
                res["logical"]["params_decode"] = _blocks(p, specs)
            lg, cache = tfm.prefill(p, cfg, rt, tokens, enc_frames=frames)
            res["blocks"]["cache"], res["logical"]["cache"] = _blocks(
                cache, tfm.cache_specs(cfg, rt, b))
            res["decode_prefill_logits"] = whole(lg)
            res["prefill_cache"] = {k: whole(t) for k, t in
                                    bridge.tree_leaves(cache)}
            greedy, steps = [whole(lg).argmax(-1)], []
            for i, tok in enumerate(r["decode_tokens"]):
                lg, cache = tfm.decode_step(p, cfg, rt, cache,
                                            torch.from_numpy(tok), s + i)
                steps.append(whole(lg))
                greedy.append(steps[-1].argmax(-1))
            res["greedy"] = greedy[:len(r["decode_tokens"])]
            res["decode_logits"] = steps
            res["decode_cache"] = {k: whole(t) for k, t in
                                   bridge.tree_leaves(cache)}
        rt = rts["train"]
        p, specs = laid_out("train")
        res["blocks"]["params_train"], \
            res["logical"]["params_train"] = _blocks(p, specs)
        batch = {k: torch.from_numpy(v) for k, v in r["batch"].items()}
        live = {k: t.detach().requires_grad_()
                for k, t in bridge.tree_leaves(p)}
        loss, _ = ts.make_loss_fn(cfg, rt, 512)(
            bridge.tree_from_leaves(live), batch)
        grads = torch.autograd.grad(loss, list(live.values()),
                                    allow_unused=True)
        with torch.no_grad():
            res["loss"] = float(loss)
            res["grads"] = {k: whole(g) if g is not None else
                            np.zeros(tuple(t.shape), np.float32)
                            for (k, t), g in zip(live.items(), grads)}
        adamw = opt.AdamWConfig()
        state = opt.init_opt_state(p, adamw, zero=ts.zero1_plan(cfg, rt,
                                                                adamw))
        ospecs = opt.opt_state_specs(specs, adamw)["moments"]
        blocks, logical = _blocks(state["moments"], ospecs)
        whole_shapes = dict(bridge.tree_leaves(
            opt.init_opt_state(tfm.abstract_params(cfg, rt)[0],
                               adamw)["moments"]))
        res["blocks"]["opt"] = {k: (v[0], tuple(whole_shapes[k].shape))
                                for k, v in blocks.items()}
        res["logical"]["opt"] = logical
        newp, _, metrics = ts.make_train_step(cfg, rt, adamw)(p, state,
                                                             r["batch"])
        with torch.no_grad():
            res["step_loss"] = float(metrics["loss"])
            res["new_params"] = {k: whole(t) for k, t in
                                 bridge.tree_leaves(newp)}
        if "int8_new_params" in r:  # the same step with int8 moments
            adamw = opt.AdamWConfig(moments_dtype="int8")
            state = opt.init_opt_state(p, adamw,
                                       zero=ts.zero1_plan(cfg, rt, adamw))
            blocks, logical = _blocks(state["moments"], opt.opt_state_specs(
                specs, adamw)["moments"])
            res["blocks"]["opt_int8"] = {k: (v[0], ()) for k, v in
                                         blocks.items()}
            res["logical"]["opt_int8"] = logical
            newp, _, _ = ts.make_train_step(cfg, rt, adamw)(p, state,
                                                            r["batch"])
            with torch.no_grad():
                res["int8_new_params"] = {k: whole(t) for k, t in
                                          bridge.tree_leaves(newp)}
        out[case] = res
    return out


# ---------------------------------------------------------------------------
# test_torch_fsdp.py
# ---------------------------------------------------------------------------

def fsdp_cases(rank, world, tmp, ref):
    """Every case of ``ref`` (``{mesh}_{arch}``: JAX's parameters, inputs
    and outputs) through the port's plans with FSDP (none on a MoE
    decode) and ZeRO-2 on its mesh over this world: prefill, the decode
    plan's prefill and greedy steps fed JAX's tokens, the gradients as
    ZeRO-2 blocks, one train step over two microbatches; the outputs
    gathered whole, each leaf's block shapes, the step's collectives."""
    import dataclasses

    import torch
    from repro_torch import bridge
    from repro_torch.configs import ParallelConfig, ShapeConfig, registry
    from repro_torch.distributed import compat
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts

    meshes, out = {}, {}
    for case, r in ref.items():
        mname, arch = case.split("_", 1)
        shape = tuple(int(n) for n in mname.split("x"))
        if shape not in meshes:
            axes = ("pod", "data", "model") if len(shape) == 3 else \
                ("data", "model")
            meshes[shape] = make_mesh(shape, axes, "cpu")
        mesh = meshes[shape]
        cfg = registry.get_smoke_config(arch)
        if "replicated" in r:  # the MoE decode pair: nothing dropped
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(r["cf"])))
        b, s = r["tokens"].shape
        ring = 2 * s

        def runtime(kind, n, fsdp=None):
            if fsdp is None:
                fsdp = not (cfg.moe is not None and kind == "decode")
            plan = shd.Plan(mesh, cfg, ShapeConfig(kind, n, b, kind),
                            ParallelConfig())
            return dataclasses.replace(plan.runtime(fsdp=fsdp),
                                       attn_impl="blockwise")

        rts = {k: runtime(k, n) for k, n in (("prefill", ring),
                                             ("decode", ring), ("train", s))}

        def whole(t):
            t = compat.to_replicated(t, mesh)
            return np.array(_np(t.float() if t.is_floating_point() else t))

        res = {"blocks": {}, "fsdp": {}, "fsdp_leaves": {}}

        def laid_out(kind):
            rt = rts[kind]
            params = bridge.params_from_host(
                bridge.tree_from_leaves(r["params"][kind]), "cpu")
            specs = tfm.param_specs(cfg, rt)
            p = rt.layout.shard(params, specs)
            res["blocks"][f"params_{kind}"] = {
                k: tuple(compat.local_of(t).shape)
                for k, t in bridge.tree_leaves(p)}
            res["fsdp"][kind] = rt.layout.fsdp
            res["fsdp_leaves"][kind] = len(tfm.fsdp_cuts(cfg, rt))
            return p, specs

        tokens = torch.from_numpy(r["tokens"])
        with torch.no_grad():
            if "prefill_logits" in r:
                p, _ = laid_out("prefill")
                lg, _ = tfm.prefill(p, cfg, rts["prefill"], tokens)
                res["prefill_logits"] = whole(lg)
            if "decode_logits" in r:
                rt = rts["decode"]
                p, _ = laid_out("decode")
                lg, cache = tfm.prefill(p, cfg, rt, tokens)
                res["decode_prefill_logits"] = whole(lg)
                greedy, steps = [whole(lg).argmax(-1)], []
                for i, tok in enumerate(r["decode_tokens"]):
                    lg, cache = tfm.decode_step(p, cfg, rt, cache,
                                                torch.from_numpy(tok), s + i)
                    steps.append(whole(lg))
                    greedy.append(steps[-1].argmax(-1))
                res["greedy"] = greedy[:len(r["decode_tokens"])]
                res["decode_logits"] = steps
        if "grads" in r:
            rt = rts["train"]
            p, specs = laid_out("train")
            batch = {k: torch.from_numpy(v) for k, v in r["batch"].items()}
            adamw = opt.AdamWConfig()
            gsh = ts.zero2_shardings(cfg, rt)
            zero = ts.zero1_plan(cfg, rt, adamw, gsh)
            grads, m = ts._grad_fn(ts.make_loss_fn(cfg, rt, 512), zero)(
                p, batch)
            res["blocks"]["accum"] = {k: tuple(compat.local_of(g).shape)
                                      for k, g in bridge.tree_leaves(grads)}
            with torch.no_grad():
                res["loss"] = float(m["nll"] / torch.clamp_min(m["ntok"], 1)
                                    + ts.AUX_WEIGHT * m["aux"])
                res["grads"] = {k: whole(g)
                                for k, g in bridge.tree_leaves(grads)}
            state = opt.init_opt_state(p, adamw, zero=zero)
            res["blocks"]["opt"] = {
                k: tuple(compat.local_of(t).shape)
                for k, t in bridge.tree_leaves(state["moments"])}
            compat.reset_stats()
            newp, _, metrics = ts.make_train_step(
                cfg, rt, adamw, microbatches=2, grad_shardings=gsh)(
                    p, state, r["batch"])
            res["step_stats"] = compat.stats()
            with torch.no_grad():
                res["step_loss"] = float(metrics["loss"])
                res["grad_norm"] = float(metrics["grad_norm"])
                res["new_params"] = {k: whole(t) for k, t in
                                     bridge.tree_leaves(newp)}
            # ZeRO-2 without FSDP: the parameters whole over the batch
            # axes, each gradient reduce-scattered at the boundary
            rt0 = runtime("train", s, fsdp=False)
            p0 = rt0.layout.shard(bridge.params_from_host(
                bridge.tree_from_leaves(r["params"]["train"]), "cpu"),
                specs)
            gsh0 = ts.zero2_shardings(cfg, rt0)
            zero0 = ts.zero1_plan(cfg, rt0, adamw, gsh0)
            g0, _ = ts._grad_fn(ts.make_loss_fn(cfg, rt0, 512), zero0)(
                p0, batch)
            compat.reset_stats()
            newp0, _, m0 = ts.make_train_step(
                cfg, rt0, adamw, microbatches=2, grad_shardings=gsh0)(
                    p0, opt.init_opt_state(p0, adamw, zero=zero0),
                    r["batch"])
            with torch.no_grad():
                res["zero2"] = {
                    "accum": {k: tuple(compat.local_of(g).shape)
                              for k, g in bridge.tree_leaves(g0)},
                    "grads": {k: whole(g) for k, g in
                              bridge.tree_leaves(g0)},
                    "new_params": {k: whole(t) for k, t in
                                   bridge.tree_leaves(newp0)},
                    "step_loss": float(m0["loss"]),
                    "grad_norm": float(m0["grad_norm"]),
                    "step_stats": compat.stats(),
                    "fsdp_leaves": len(tfm.fsdp_cuts(cfg, rt0))}
            if "int8_new_params" in r:  # the same step with int8 moments
                adamw = opt.AdamWConfig(moments_dtype="int8")
                state = opt.init_opt_state(
                    p, adamw, zero=ts.zero1_plan(cfg, rt, adamw, gsh))
                newp, _, _ = ts.make_train_step(
                    cfg, rt, adamw, microbatches=2, grad_shardings=gsh)(
                        p, state, r["batch"])
                with torch.no_grad():
                    res["int8_new_params"] = {k: whole(t) for k, t in
                                              bridge.tree_leaves(newp)}
        out[case] = res
    return out


# ---------------------------------------------------------------------------
# test_torch_moe_parallel.py
# ---------------------------------------------------------------------------

def moe_cases(rank, world, tmp, inputs):
    """Each MoE case on its mesh through the port's same route;
    returns {case: {"y", "aux", "pairs", "dropped"}}."""
    import torch
    from repro_torch.configs.base import (ATTN_GLOBAL, MLP_MOE, LayerSpec,
                                          ModelConfig, MoEConfig)
    from repro_torch.distributed import compat
    from repro_torch.distributed import moe_parallel as mp
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import ParamBuilder
    from repro_torch.models.moe import init_moe, make_moe_layout

    meshes = {}
    out = {}
    for name, case in inputs.items():
        key = (tuple(case["mesh"]), tuple(case["axes"]))
        if key not in meshes:
            meshes[key] = make_mesh(*key, "cpu")
        mesh = meshes[key]
        cfg = ModelConfig(
            name="m", family="moe", n_layers=1, d_model=case["d"],
            n_heads=4, n_kv_heads=2, d_ff=case["f"], vocab_size=128,
            pattern=(LayerSpec(mixer=ATTN_GLOBAL, mlp=MLP_MOE),),
            moe=MoEConfig(n_experts=case["e"], top_k=case["k"],
                          capacity_factor=case["cf"]))
        fn = {"etp": mp.make_moe_etp, "etp2d": mp.make_moe_etp2d,
              "replicated": mp.make_moe_replicated,
              "replicated_2d": lambda m: mp.make_moe_replicated(
                  m, expert_2d=True)}[case["fn"]](mesh)
        p = {k: torch.from_numpy(np.array(v))
             for k, v in case["params"].items()}
        x = torch.from_numpy(case["x"])
        pb = ParamBuilder(None, "meta")
        init_moe(pb, cfg, make_moe_layout(cfg, mesh.shape["model"],
                                          mesh.shape["data"]
                                          if case["fn"] == "etp2d" else 1))
        # the route inside the layout, as the model runs it: this rank's
        # rows and its blocks of the expert stacks (the decode route's 2-D
        # form with expert_f cut over the batch axes, Plan.overrides')
        lay = shd.Layout(mesh, (("expert_f", "__batch__"),)
                         if case["fn"] == "replicated_2d" else ())
        rows = lay.row_entry(x.shape[0])

        def run(params):
            y, aux = lay.run(lambda p_, x_: fn(p_, x_, cfg), (params, x),
                             (lay.specs(p, pb.specs),
                              compat.P(rows, None, None)),
                             (compat.P(rows, None, None), compat.P()))
            return compat.to_replicated(y, mesh), aux

        mp.reset_route_stats()
        y, aux = run(p)  # whole stacks, cut at the boundary
        out[name] = {"y": _np(y), "aux": _np(aux),
                     "pairs": int(mp.route_stats["pairs"]),
                     "dropped": int(mp.route_stats["dropped"])}
        # the same route on the expert stacks already cut into this rank's
        # blocks (DTensors laid out by their logical axes, as a served
        # model holds them)
        blocks = lay.shard(p, pb.specs)
        ys, _ = run(blocks)
        out[name]["y_blocks"] = _np(ys)
        out[name]["blocks"] = compat.is_sharded_tensor(blocks["wi"])
    return out


# ---------------------------------------------------------------------------
# test_torch_distributed.py on the card: the backends with two ranks on one
# device (a probe: each refusal is caught and recorded)
# ---------------------------------------------------------------------------

def _nccl_probe(rank, world, tmp):
    import torch
    import torch.distributed as dist
    x = torch.ones(4, device="cuda")
    try:
        dist.all_reduce(x)
        torch.cuda.synchronize()
        return {"refused": False}
    except Exception as e:  # the probe records the refusal
        return {"refused": True, "refusal": repr(e)[:400]}


GLOO_PROBE_OPS = ("all_reduce", "broadcast", "all_gather",
                  "reduce_scatter", "all_to_all", "send_recv")


def _gloo_probe(rank, world, tmp, op):
    """One collective on CUDA tensors (float32, then bf16) in a gloo world
    of two ranks on one card. A collective gloo has no CUDA route for
    raises or aborts the process (it writes from a device pointer)."""
    import torch
    import torch.distributed as dist
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.arange(4, device="cuda", dtype=dtype) + 4 * rank
        if op == "all_reduce":
            dist.all_reduce(x)
            want = [4.0 + 2 * i for i in range(4)]
        elif op == "broadcast":
            dist.broadcast(x, 0)
            want = [float(i) for i in range(4)]
        elif op == "all_gather":
            y = x.new_empty(8)
            dist.all_gather_into_tensor(y, x)
            x, want = y, [float(i) for i in range(8)]
        elif op == "reduce_scatter":
            y = x.new_empty(2)
            dist.reduce_scatter_tensor(y, x)
            x, want = y, [4.0 + 2 * i for i in range(2 * rank, 2 * rank + 2)]
        elif op == "all_to_all":
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            x, want = y, [float(2 * rank + j) for j in (0, 1)] + \
                [float(4 + 2 * rank + j) for j in (0, 1)]
        elif op == "send_recv":
            peer = 1 - rank
            y = torch.empty_like(x)
            for w in dist.batch_isend_irecv(
                    [dist.P2POp(dist.isend, x, peer),
                     dist.P2POp(dist.irecv, y, peer)]):
                w.wait()
            x, want = y, [float(4 * peer + i) for i in range(4)]
        torch.cuda.synchronize()
        if x.cpu().float().tolist() != want:
            raise AssertionError(f"{op} {dtype}: {x.tolist()} != {want}")
    dist.barrier()
    return {"ok": True}


def _compat_probe(rank, world, tmp):
    """compat's psum, all_to_all and ppermute over a (1, 2) mesh on the
    card (the ppermute staged through the host)."""
    import torch
    from repro_torch.distributed import compat
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 2), ("data", "model"), "cuda")
    x = torch.arange(8, device="cuda", dtype=torch.bfloat16) + 8 * rank

    def body(xl):
        return (compat.psum(xl, "model"),
                compat.all_to_all(xl, "model", 0, 0, tiled=True),
                compat.ppermute(xl, "model", [(0, 1), (1, 0)]))

    compat.reset_stats()
    s, a, p = compat.shard_map(body, mesh=mesh, in_specs=(compat.P(),),
                               out_specs=(compat.P(),) * 3)(x)
    return {"psum": s.cpu().float().tolist(),
            "all_to_all": a.cpu().float().tolist(),
            "ppermute": p.cpu().float().tolist(), "stats": compat.stats()}


def run_cuda_probe(tmp) -> dict:
    """NCCL with two ranks on one card; each collective of gloo on CUDA
    tensors in a world of its own (a refusal may abort the process);
    compat's staged path."""
    tmp = Path(tmp)
    nccl = run_world(_nccl_probe, 2, tmp / "nccl", device="cuda",
                     backend="nccl")
    gloo = {}
    for op in GLOO_PROBE_OPS:
        try:
            run_world(_gloo_probe, 2, tmp / f"gloo_{op}", op, device="cuda",
                      backend="gloo")
            gloo[op] = True
        except Exception as e:  # the probe records the refusal
            gloo[op] = False
            print(f"gloo {op} on CUDA tensors: {repr(e)[-300:]}")
    comp = run_world(_compat_probe, 2, tmp / "compat", device="cuda",
                     backend="gloo")
    return {"nccl_refused": all(r["refused"] for r in nccl),
            "nccl": nccl, "gloo_cuda": gloo, "compat": comp}
