"""The port's dense layout against JAX's GSPMD plan, on the CPU.

The JAX side runs once a (mesh, arch) pair, in a subprocess with four
host devices, as ``tests/test_torch_distributed.py`` runs it: it
``jax.jit``s ``prefill``, four greedy ``decode_step``s and one
``make_train_step`` step, with ``in_shardings`` from the plan's
``tree_shardings``: the parameters without FSDP (``zero1=False``), with
the MoE decode override on decode, the optimizer state with
``zero1=True``, the batch over the batch axes. It pickles float32
parameters, inputs, outputs and every leaf's ``shard_shape``. Mesh
(2, 2) runs seven smoke configs (gemma2: local and global layers,
softcaps; qwen2: qkv bias; starcoder2: LayerNorm, ``bo``, ``b2``;
grok-1: MoE through the hooks; whisper-tiny: cross-attention;
recurrentgemma: RG-LRU; mamba2: the vocabulary only); the other two run
the archs whose layout differs there: (1, 4) whisper-tiny (one head a
rank, cross-attention included) and deepseek-coder (6 q heads padded to
8, two a rank, each kv head read by two ranks), (4, 1) gemma2 (rows and
ZeRO-1 over four ranks, no model axis) and grok-1 (``make_moe_etp2d``
over four data ranks). gemma2 also steps with int8 moments on (2, 2).

The port side runs the same inputs on JAX's parameters in a gloo world
of four processes a mesh (``tests/torch_worlds.py``; each mesh's world
starts once its JAX pairs are done), through the port's
``Plan.runtime`` and its ``Layout``: every process runs its rows on its
blocks. Held to JAX (float32, 1e-5; whisper-tiny, whose encoder JAX
runs in bf16 only, 0.08):
the prefill and decode logits gathered whole, the greedy tokens, the
caches, the loss, every gradient and every updated parameter, and each
rank's block shape of every parameter, cache and optimizer-state leaf
against JAX's ``shard_shape``, except on the axes the port keeps whole
(``sharding.WHOLE_AXES``, named below).
"""
import os
import pickle
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

import torch_worlds
from repro_torch.distributed import sharding as shd
from repro_torch.train.optimizer import QBLOCK

REPO = Path(__file__).resolve().parents[1]
ARCHS = ["gemma2-9b", "qwen2-72b", "starcoder2-15b", "grok-1-314b",
         "whisper-tiny", "recurrentgemma-9b", "mamba2-1.3b"]
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
#: the archs each mesh runs: all on (2, 2), those whose layout differs on
#: the others
MESH_ARCHS = {"2x2": ARCHS, "1x4": ["whisper-tiny", "deepseek-coder-33b"],
              "4x1": ["gemma2-9b", "grok-1-314b"]}
CASES = [f"{m}_{a}" for m, archs in MESH_ARCHS.items() for a in archs]
#: JAX subprocesses at once (each compiles one pair's programs)
JAX_JOBS = 4
#: the limit of every comparison, by the dtype the arch runs in (JAX runs
#: whisper's encoder in bf16 only, so whisper keeps it bf16 and is held to
#: the bf16 limit of tests/test_torch_archs.py's slice tests; the rest is
#: float32); gradients and parameters are held relative to their leaf's
#: largest magnitude
TOLS = {"float32": 1e-5, "bfloat16": 0.08}
BF16_ARCHS = {"whisper-tiny"}

JAX_SIDE = r'''
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import registry
from repro.configs.base import ParallelConfig, ShapeConfig
from repro.distributed import sharding as shd
from repro.models import transformer as T
from repro.train import optimizer as opt
from repro.train import train_step as ts

ARCHS = sys.argv[2].split(",")
MESHES = {sys.argv[3]: tuple(int(n) for n in sys.argv[3].split("x"))}
B, S, RING, STEPS = 4, 8, 16, 4
INT8_ARCH = "gemma2-9b"


def leaves(t, pre=""):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{pre}{k}/"))
        else:
            out[f"{pre}{k}"] = v
    return out


def host(t):
    return {k: np.asarray(v) for k, v in leaves(t).items()}


def shapes_of(tree, sh):
    sh = leaves(sh)
    return {k: tuple(sh[k].shard_shape(tuple(np.shape(v))))
            for k, v in leaves(tree).items()}


def runtime(plan):
    import dataclasses
    return dataclasses.replace(plan.runtime(), attn_impl="blockwise")


out = {}
for mname, shape in MESHES.items():
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape),
                ("data", "model"))
    baxes = ("data",)
    for arch in ARCHS:
        cfg = registry.get_smoke_config(arch)
        rng = np.random.default_rng(0)
        plans = {k: shd.Plan(mesh, cfg, ShapeConfig(k, n, B, k),
                             ParallelConfig())
                 for k, n in (("prefill", RING), ("decode", RING),
                              ("train", S))}
        rts = {k: runtime(p) for k, p in plans.items()}
        tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        frames = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32) if cfg.enc_dec else None
        batch = {"tokens": tokens,
                 "labels": rng.integers(0, cfg.vocab_size, (B, S))
                 .astype(np.int32),
                 "loss_mask": (rng.random((B, S)) < 0.9).astype(np.float32)}
        if cfg.enc_dec:
            batch["enc_frames"] = frames
        res = {"tokens": tokens, "frames": frames, "batch": batch,
               "params": {}, "blocks": {}}

        drawn = {}

        def params_for(kind):
            # float32, but whisper's encoder (JAX runs it in bf16 only);
            # drawn once a shape of the tree (the plans differ in the MoE
            # layout's tp and moe_dp and in max_seq, which sizes whisper's
            # position table), under one jit (eager, each of init's small
            # ops would compile on its own)
            key = (rts[kind].tp, rts[kind].moe_dp, rts[kind].max_seq)
            if key not in drawn:
                got = {}

                def init(k_):
                    p_, got["specs"] = T.init_params(k_, cfg, rts[kind])
                    return {k: v if k == "encoder" else
                            jax.tree.map(lambda a: a.astype(jnp.float32), v)
                            for k, v in p_.items()}
                drawn[key] = (jax.jit(init)(jax.random.PRNGKey(0)),
                              got["specs"])
            p, specs = drawn[key]
            ov = {"expert_f": "__batch__"} if (cfg.moe is not None and
                                              kind == "decode") else None
            sh = shd.tree_shardings(p, specs, mesh, zero1=False,
                                    overrides=ov)
            res["params"][kind] = host(p)
            res["blocks"][f"params_{kind}"] = shapes_of(p, sh)
            return p, specs, sh

        tok_sh = NamedSharding(mesh, P(baxes, None))
        fr_sh = NamedSharding(mesh, P(baxes, None, None))
        # prefill
        p, specs, sh = params_for("prefill")
        rt = rts["prefill"]
        logits, cache = jax.jit(
            lambda p_, t, f: T.prefill(p_, cfg, rt, t, enc_frames=f),
            in_shardings=(sh, tok_sh, fr_sh if cfg.enc_dec else None))(
                p, tokens, frames)
        res["prefill_logits"] = np.asarray(logits)
        # decode: a MoE arch's own parameters (its prefill and decode
        # plans may lay its experts out differently) and its prefill
        # through the decode plan; then STEPS greedy steps
        if cfg.moe is not None:
            p, specs, sh = params_for("decode")
            rt = rts["decode"]
            logits, cache = jax.jit(
                lambda p_, t, f: T.prefill(p_, cfg, rt, t, enc_frames=f),
                in_shardings=(sh, tok_sh, fr_sh if cfg.enc_dec else None))(
                    p, tokens, frames)
        else:
            res["params"]["decode"] = res["params"]["prefill"]
            res["blocks"]["params_decode"] = res["blocks"]["params_prefill"]
            rt = rts["decode"]
        _, cspecs = T.init_cache(cfg, rt, B, enc_len=RING if cfg.enc_dec
                                 else 0)
        csh = shd.tree_shardings(cache, cspecs, mesh)
        res["blocks"]["cache"] = shapes_of(cache, csh)
        res["decode_prefill_logits"] = np.asarray(logits)
        res["prefill_cache"] = host(cache)
        step = jax.jit(lambda p_, c, t, pos: T.decode_step(p_, cfg, rt, c,
                                                            t, pos),
                       in_shardings=(sh, csh, NamedSharding(mesh, P(baxes)),
                                     None))
        toks, steps = [], []
        for i in range(STEPS):
            tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
            logits, cache = step(p, jax.device_put(cache, csh), tok,
                                 jnp.int32(S + i))
            toks.append(tok)
            steps.append(np.asarray(logits))
        res["decode_tokens"] = toks
        res["decode_logits"] = steps
        res["decode_cache"] = host(cache)
        # one train step
        p, specs, sh = params_for("train")
        rt, plan = rts["train"], plans["train"]
        adamw = opt.AdamWConfig()
        state = opt.init_opt_state(p, adamw)
        osh = shd.tree_shardings(state, opt.opt_state_specs(specs, adamw),
                                 mesh, zero1=True)
        res["blocks"]["opt"] = shapes_of(state["moments"], osh["moments"])
        bsh = {k: NamedSharding(mesh, P(baxes, *([None] * (np.ndim(v) - 1))))
               for k, v in batch.items()}
        loss_fn = ts.make_loss_fn(cfg, rt, plan.constrain, 512)
        train = ts.make_train_step(cfg, rt, plan.constrain, adamw)

        def both(p_, st, b):
            return (jax.value_and_grad(loss_fn, has_aux=True)(p_, b),
                    train(p_, st, b))
        ((loss, _), grads), (newp, _, metrics) = jax.jit(
            both, in_shardings=(sh, osh, bsh))(p, state, batch)
        res["loss"] = float(loss)
        res["step_loss"] = float(metrics["loss"])
        res["grads"] = host(grads)
        res["new_params"] = host(newp)
        if arch == INT8_ARCH and shape == (2, 2):
            # the same step with int8 moments, ZeRO-1 cutting them over
            # data and the parameters' blocks over model
            adamw = opt.AdamWConfig(moments_dtype="int8")
            state = opt.init_opt_state(p, adamw)
            osh = shd.tree_shardings(state, opt.opt_state_specs(specs,
                                                                adamw),
                                     mesh, zero1=True)
            res["blocks"]["opt_int8"] = shapes_of(state["moments"],
                                                  osh["moments"])
            train = ts.make_train_step(cfg, rt, plan.constrain, adamw)
            newp, _, _ = jax.jit(train, in_shardings=(sh, osh, bsh))(
                p, state, batch)
            res["int8_new_params"] = host(newp)
        out[f"{mname}_{arch}"] = res
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
'''


def _jax_pair(tmp: Path, mesh: str, arch: str) -> dict:
    """JAX's side of one (mesh, arch) pair, in a subprocess."""
    env = dict(os.environ)
    # LLVM's optimisation passes off: the programs compile in about half
    # the time (the HLO, and so what JAX computes, is the same)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        "--xla_backend_optimization_level=0 "
                        "--xla_llvm_disable_expensive_passes=true")
    env["PYTHONPATH"] = str(REPO / "src")
    path = tmp / f"{mesh}_{arch}.pkl"
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_SIDE),
                        str(path), arch, mesh],
                       capture_output=True, text=True, timeout=900, env=env)
    assert p.returncode == 0, f"stdout:\n{p.stdout}\nstderr:\n{p.stderr}"
    return pickle.loads(path.read_bytes())


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(JAX's results, each rank's port results) of every case: JAX's
    pairs ``JAX_JOBS`` at a time, each mesh's gloo world of four as soon
    as its pairs are done."""
    tmp = tmp_path_factory.mktemp("dense")
    with ThreadPoolExecutor(JAX_JOBS) as jobs, \
            ThreadPoolExecutor(len(MESHES)) as worlds:
        pairs = {m: [jobs.submit(_jax_pair, tmp, m, a) for a in archs]
                 for m, archs in MESH_ARCHS.items()}

        def mesh_side(m):
            ref = {}
            for f in pairs[m]:
                ref.update(f.result())
            return ref, torch_worlds.run_world(
                torch_worlds.dense_layout_cases, 4, tmp / f"port_{m}", ref)
        done = list(worlds.map(mesh_side, MESH_ARCHS))
    ref, port = {}, [{} for _ in range(4)]
    for r, ranks in done:
        ref.update(r)
        for mine, got in zip(port, ranks):
            mine.update(got)
    return ref, port


@pytest.fixture(scope="module")
def jax_side(sides):
    return sides[0]


@pytest.fixture(scope="module")
def port_side(sides):
    return sides[1]


def _tol(case: str) -> float:
    return TOLS["bfloat16" if case.split("_", 1)[1] in BF16_ARCHS
                else "float32"]


def _close(got, want, tol, rel=False, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if rel and want.size \
        else 1.0
    err = float(np.abs(got.astype(np.float64) - want).max()) \
        if want.size else 0.0
    assert err <= tol * scale, (what, err, tol * scale)


@pytest.mark.parametrize("case", CASES)
def test_serve_matches_jax(case, jax_side, port_side):
    """Prefill logits (the prefill plan), then the decode plan's prefill
    and four greedy steps: logits gathered whole within 1e-5 of JAX's on
    every rank, the greedy tokens equal (JAX's are fed), and the caches
    after prefill and after the last step gathered whole within 1e-5."""
    ref, tol = jax_side[case], _tol(case)
    for res in port_side:
        got = res[case]
        _close(got["prefill_logits"], ref["prefill_logits"], tol)
        _close(got["decode_prefill_logits"], ref["decode_prefill_logits"],
               tol)
        for g, w in zip(got["decode_logits"], ref["decode_logits"]):
            _close(g, w, tol)
        assert len(got["greedy"]) == len(ref["decode_tokens"])
        for g, w in zip(got["greedy"], ref["decode_tokens"]):
            np.testing.assert_array_equal(g, w)
        for which in ("prefill_cache", "decode_cache"):
            assert set(got[which]) == set(ref[which])
            for k, w in ref[which].items():
                _close(got[which][k], w, tol, what=f"{which} {k}")


@pytest.mark.parametrize("case", CASES)
def test_train_step_matches_jax(case, jax_side, port_side):
    """The loss (the masked mean over the global batch), the gradient of
    every parameter and every parameter after one AdamW step with
    ZeRO-1 moments, gathered whole, against JAX's: within the arch's
    limit (``TOLS``) of the leaf's largest magnitude."""
    ref, tol = jax_side[case], _tol(case)
    for res in port_side:
        got = res[case]
        assert abs(got["loss"] - ref["loss"]) <= tol * max(1, ref["loss"])
        assert abs(got["step_loss"] - ref["step_loss"]) <= \
            tol * max(1, ref["step_loss"])
        assert set(got["grads"]) == set(ref["grads"])
        for k, w in ref["grads"].items():
            _close(got["grads"][k], w, tol, rel=True, what=k)
        for k, w in ref["new_params"].items():
            _close(got["new_params"][k], w, tol, rel=True, what=k)
        for k, w in ref.get("int8_new_params", {}).items():
            _close(got["int8_new_params"][k], w, tol, rel=True, what=k)


def _whole_dims(spec) -> list:
    return [i for i, a in enumerate(spec) if a in shd.WHOLE_AXES]


@pytest.mark.parametrize("case", CASES)
def test_blocks_match_jax_shard_shapes(case, jax_side, port_side):
    """Every rank's block of every parameter (each plan's), cache and
    optimizer-state leaf has JAX's ``shard_shape`` under the same
    sharding, except on the dims of the axes the port keeps whole
    (``WHOLE_AXES``: recurrentgemma's ``rglru``/``rglru_heads``, mamba2's
    ``ssm_heads``/``ssm_flat``), which are whole, and int8 moment codes,
    cut as their scales; a cut leaf really is a block; and
    ``Plan.constrain`` hands a whole residual back as this rank's
    rows."""
    ref = jax_side[case]["blocks"]
    for res in port_side:
        got = res[case]["blocks"]
        specs = res[case]["logical"]
        assert set(got) == set(ref)
        for group, leaves in ref.items():
            assert set(got[group]) == set(leaves), group
            for k, want in leaves.items():
                have, whole = got[group][k]
                if group == "opt_int8" and k.endswith("/q"):
                    # int8 codes are cut as their scales (JAX's ZeRO-1
                    # may cut a code block's QBLOCK dim): never inside a
                    # quantisation block
                    scale = k[:-1] + ("scale" if "/m/" in k else "lo")
                    assert tuple(have) == tuple(leaves[scale]) + \
                        (QBLOCK,), (k, have, want)
                    continue
                spec = specs[group][k]
                if not _whole_dims(spec):
                    assert tuple(have) == tuple(want), (group, k)
                    continue
                assert group != "opt" or np.prod(have) <= np.prod(whole)
                for d, (h, w, g) in enumerate(zip(have, want, whole)):
                    expect = g if d in _whole_dims(spec) else w
                    if group != "opt":
                        assert h == expect, (group, k, d, have, want)
        # the residual by resid_spec's batch entry: this rank's rows
        dp, tp = MESHES[case.split("_")[0]]
        b, s = jax_side[case]["tokens"].shape
        assert res[case]["resid_rows"] == (b // dp, s, 4)
        # a model-cut leaf is a block on every mesh with a model axis
        if tp > 1:
            have, whole = got["params_train"]["in_embed"]
            assert have[0] * tp == whole[0]


def test_whole_axes_are_the_recurrent_mixers():
    """The axes the port keeps whole are the recurrent mixers' widths,
    and none of them is laid out (ROADMAP item 13's remainder)."""
    assert shd.WHOLE_AXES == {"rglru", "rglru_heads", "ssm_heads",
                              "ssm_flat"}
    assert not shd.WHOLE_AXES & shd.LAID_OUT


# ---------------------------------------------------------------------------
# remat "dots" and the dry run's held bytes (no JAX)
# ---------------------------------------------------------------------------

def _train_grads(policy: str, tmp_path):
    """gemma2's smoke config, one loss and its gradients on one device
    under ``remat_policy``, with the dry run's op counter; returns (the
    gradients, {op: calls})."""
    import json

    import torch
    from repro_torch import bridge
    from repro_torch.configs import registry
    from repro_torch.launch import op_analysis
    from repro_torch.models import transformer as tfm
    from repro_torch.train import train_step as ts
    cfg = registry.get_smoke_config("gemma2-9b")
    rt = tfm.ModelRuntime(attn_impl="blockwise", max_seq=64,
                          remat_policy=policy)
    params = bridge.tree_map(lambda t: t.float(), tfm.init_params(
        cfg, rt, torch.Generator().manual_seed(0), "cpu"))
    g = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(g.integers(0, cfg.vocab_size,
                                                   (2, 64))),
             "labels": torch.from_numpy(g.integers(0, cfg.vocab_size,
                                                   (2, 64))),
             "loss_mask": torch.ones(2, 64)}
    grad = ts._grad_fn(ts.make_loss_fn(cfg, rt))
    path = tmp_path / f"{policy}.json"
    (grads, _), _ = op_analysis.analyze(grad, params, batch, save_ops=path)
    calls = {}
    for row in json.loads(path.read_text())["ops"]:
        calls[row["op"]] = calls.get(row["op"], 0) + row["count"]
    return dict(bridge.tree_leaves(grads)), calls


def test_remat_dots_saves_the_matmuls(tmp_path):
    """``remat_policy="dots"`` (``--remat dots``) saves the products with
    no batch dimension: the backward recomputes none of the layers'
    ``mm``s (fewer calls than under ``full``) but the attention scores'
    ``bmm``s as ``full`` does; the gradients are equal."""
    full, full_calls = _train_grads("full", tmp_path)
    dots, dots_calls = _train_grads("dots", tmp_path)
    assert dots_calls["mm"] < full_calls["mm"], (dots_calls, full_calls)
    assert dots_calls["bmm"] == full_calls["bmm"]
    for k, g in full.items():
        np.testing.assert_array_equal(dots[k].numpy(), g.numpy(), err_msg=k)


def test_plan_runtime_passes_remat_policy():
    """``Plan.runtime`` sets ``remat_policy`` from ``ParallelConfig.remat``
    as JAX's does."""
    from repro_torch.configs import ParallelConfig, ShapeConfig, registry
    from repro_torch.launch import mesh as tmesh
    for remat, want in (("dots", "dots"), ("block", "full")):
        rt = shd.Plan(tmesh.Mesh((1, 1), ("data", "model")),
                      registry.get_config("gemma2-9b"),
                      ShapeConfig("t", 64, 4, "train"),
                      ParallelConfig(remat=remat)).runtime()
        assert rt.remat_policy == want and rt.remat


DRYRUN_CELL = r"""
import dataclasses, json, sys
from repro_torch.configs import ShapeConfig, base, registry
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
arch, kind, layers, shape = sys.argv[1], sys.argv[2], int(sys.argv[3]), (2, 2)
# a smoke config, or the full-width config cut to ``layers`` layers
cfg = dataclasses.replace(registry.get_config(arch), n_layers=layers) \
    if layers else registry.get_smoke_config(arch)
dryrun.init_fake_world(4)
res = dryrun.build_and_trace(
    arch, kind, False, base.ParallelConfig(), 1,
    shape=ShapeConfig(kind, 64, 8, kind),
    mesh=make_mesh(shape, ("data", "model"), "cpu"), mesh_name="2x2",
    cfg=cfg)
print(json.dumps({"held": res["held"], "layout": res["layout"],
                  "fsdp": res["fsdp"]}))
"""

#: the dry-run cells traced at full width, by arch: their depth (JAX's
#: rule gives qwen2-72b's 2 layers FSDP at tp 2: 2 x 4,246,765,568 / 2
#: bytes > 4e9)
DRYRUN_FULL_WIDTH = {"qwen2-72b": 2}


@pytest.mark.parametrize("arch,kind", [("gemma2-9b", "train"),
                                       ("starcoder2-15b", "decode"),
                                       ("qwen2-72b", "train")])
def test_dryrun_held_bytes_equal_the_plan(arch, kind):
    """A cell traced on a fake world of four at (2, 2): the parameter and
    optimizer-state bytes a rank holds equal the plan's
    ``_sharded_bytes`` exactly (no recurrent mixer), and the record names
    the axes the layout cuts. The smoke cells have no FSDP in their plan;
    qwen2-72b at full width (2 layers) has, and its traced parameters
    are the plan's FSDP blocks (nothing held whole by design)."""
    import json
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    layers = DRYRUN_FULL_WIDTH.get(arch, 0)
    p = subprocess.run([sys.executable, "-c", DRYRUN_CELL, arch, kind,
                        str(layers)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["fsdp"] is (arch in DRYRUN_FULL_WIDTH)
    held = res["held"]
    assert held["traced"] == held["plan"] and held["whole_by_design"] == 0
    assert held["traced"]["param_bytes"] > 0
    assert (held["traced"]["opt_bytes"] > 0) == (kind == "train")
    assert set(res["layout"]) == shd.LAID_OUT - {"expert_f"}
