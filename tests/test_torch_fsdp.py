"""FSDP of the parameters and the ZeRO-2 gradient accumulator on the
port's layout against JAX's GSPMD plan, on the CPU, and the MoE decode
route's rows over two batch axes.

The JAX side runs once a (mesh, arch) pair, in a subprocess with four or
eight host devices, as ``tests/test_torch_dense_layout.py`` runs it: it
``jax.jit``s ``prefill``, four greedy ``decode_step``s, the loss's
gradient and one ``make_train_step(..., microbatches=2,
grad_shardings=...)`` step with ``in_shardings`` from the plan's
``tree_shardings``: the parameters with FSDP (``zero1=True``; on MoE
decode without it and with the ``expert_f`` override, as JAX's dry run
plans it), the moments and ``grad_shardings`` with ``zero1=True``, the
batch over the batch axes. Meshes (2, 2) and (4, 1) run gemma2-9b,
qwen2-72b and grok-1-314b's smoke configs; (2, 2, 2) = (pod, data,
model) on eight devices runs gemma2's training and grok-1's decode
through the 2-D MoE route (capacity factor 8.0: nothing dropped). There
JAX's own ``make_moe_replicated`` slices out another process's rows (it
gathers the rows one batch axis at a time, pod first, and slices them
pod-major), so the port, which gathers them outer axis major, is held to
JAX's dense ``apply_moe_gshard`` route on the same plan, and the test
asserts that JAX's 2-D route differs from it.

The port side runs the same inputs on JAX's parameters in gloo worlds of
four and eight processes (``tests/torch_worlds.py``), through
``Plan.runtime(fsdp=...)``, ``train_step.zero2_shardings`` and
``make_train_step(..., grad_shardings=...)``. Held to JAX (float32,
1e-5): the prefill and decode logits gathered whole, the greedy tokens,
the loss, every gradient block and every updated parameter block
gathered whole, and each rank's block shape of the parameters, the
moments and the gradient accumulator (the gradients' blocks, which the
accumulator is allocated as) against JAX's ``shard_shape``. The train
cases also step with ZeRO-2 alone (the parameters not FSDP-cut), held
to the same JAX results.
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

REPO = Path(__file__).resolve().parents[1]
MESHES = {"2x2": (2, 2), "4x1": (4, 1), "2x2x2": (2, 2, 2)}
#: (mesh, arch, what the pair runs)
PAIRS = [(m, a, "all") for m in ("2x2", "4x1")
         for a in ("gemma2-9b", "qwen2-72b", "grok-1-314b")] + \
    [("2x2x2", "gemma2-9b", "train"), ("2x2x2", "grok-1-314b", "decode")]
CASES = [f"{m}_{a}" for m, a, _ in PAIRS]
SERVE_CASES = [f"{m}_{a}" for m, a, w in PAIRS if w != "train"]
TRAIN_CASES = [f"{m}_{a}" for m, a, w in PAIRS if w != "decode"]
#: JAX subprocesses at once (each compiles one pair's programs)
JAX_JOBS = 4
#: float32 throughout; gradients and parameters relative to their leaf's
#: largest magnitude
TOL = 1e-5
#: the MoE decode pair's capacity factor: no (token, choice) pair dropped,
#: so the 2-D route and the dense gshard route compute the same rows
DROPLESS_CF = 8.0

JAX_SIDE = r'''
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import registry
from repro.configs.base import ParallelConfig, ShapeConfig
from repro.distributed import sharding as shd
from repro.models import transformer as T
from repro.train import optimizer as opt
from repro.train import train_step as ts

arch, mname, what = sys.argv[2], sys.argv[3], sys.argv[4]
shape = tuple(int(n) for n in mname.split("x"))
axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
B, S, RING, STEPS, MICRO = 8, 8, 16, 4, 2
DROPLESS_CF = float(sys.argv[5])


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


mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
            axes)
baxes = tuple(a for a in axes if a != "model")
cfg = registry.get_smoke_config(arch)
if what == "decode":  # the pair held to the dense gshard route
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=DROPLESS_CF))
rng = np.random.default_rng(0)
plans = {k: shd.Plan(mesh, cfg, ShapeConfig(k, n, B, k), ParallelConfig())
         for k, n in (("prefill", RING), ("decode", RING), ("train", S))}
rts = {k: dataclasses.replace(p.runtime(), attn_impl="blockwise")
       for k, p in plans.items()}
tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
batch = {"tokens": tokens,
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "loss_mask": (rng.random((B, S)) < 0.9).astype(np.float32)}
res = {"tokens": tokens, "batch": batch, "params": {}, "blocks": {},
       "fsdp": {}}
drawn = {}


def params_for(kind):
    # float32, drawn once a shape of the tree (the plans differ in the MoE
    # layout's tp and moe_dp); FSDP as JAX's dry run plans it: none on a
    # MoE decode, whose experts are cut 2-D by the expert_f override
    rt = rts[kind]
    key = (rt.tp, rt.moe_dp)
    if key not in drawn:
        got = {}

        def init(k_):
            p_, got["specs"] = T.init_params(k_, cfg, rt)
            return jax.tree.map(lambda a: a.astype(jnp.float32), p_)
        drawn[key] = (jax.jit(init)(jax.random.PRNGKey(0)), got["specs"])
    p, specs = drawn[key]
    moe_decode = cfg.moe is not None and kind == "decode"
    ov = {"expert_f": "__batch__"} if moe_decode else None
    sh = shd.tree_shardings(p, specs, mesh, zero1=not moe_decode,
                            overrides=ov)
    res["params"][kind] = host(p)
    res["blocks"][f"params_{kind}"] = shapes_of(p, sh)
    res["fsdp"][kind] = not moe_decode
    return p, specs, sh


tok_sh = NamedSharding(mesh, P(baxes, None))


def serve(rt, p, sh, steps=STEPS):
    """prefill, then ``steps`` greedy decode steps through ``rt``."""
    logits, cache = jax.jit(lambda p_, t: T.prefill(p_, cfg, rt, t),
                            in_shardings=(sh, tok_sh))(p, tokens)
    _, cspecs = T.init_cache(cfg, rt, B)
    csh = shd.tree_shardings(cache, cspecs, mesh)
    step = jax.jit(lambda p_, c, t, pos: T.decode_step(p_, cfg, rt, c, t,
                                                        pos),
                   in_shardings=(sh, csh, NamedSharding(mesh, P(baxes)),
                                 None))
    out = {"prefill_logits": np.asarray(logits), "decode_tokens": [],
           "decode_logits": []}
    for i in range(steps):
        tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        logits, cache = step(p, jax.device_put(cache, csh), tok,
                             jnp.int32(S + i))
        out["decode_tokens"].append(tok)
        out["decode_logits"].append(np.asarray(logits))
    return out


if what == "all":
    p, specs, sh = params_for("prefill")
    res["prefill_logits"] = serve(rts["prefill"], p, sh,
                                  steps=0)["prefill_logits"]
if what in ("all", "decode"):
    p, specs, sh = params_for("decode")
    got = serve(rts["decode"], p, sh)
    res["decode_prefill_logits"] = got["prefill_logits"]
    res["decode_tokens"] = got["decode_tokens"]
    res["decode_logits"] = got["decode_logits"]
    if what == "decode":
        # the dense gshard route on the same plan and parameters: the rows
        # are right; the plan's own 2-D route (above) is kept beside it
        dense = serve(dataclasses.replace(rts["decode"], moe_fn=None), p,
                      sh)
        res["cf"] = DROPLESS_CF
        res["replicated"] = {k: res.pop(k) for k in
                             ("decode_prefill_logits", "decode_tokens",
                              "decode_logits")}
        res["decode_prefill_logits"] = dense["prefill_logits"]
        res["decode_tokens"] = dense["decode_tokens"]
        res["decode_logits"] = dense["decode_logits"]
if what in ("all", "train"):
    p, specs, sh = params_for("train")
    rt, plan = rts["train"], plans["train"]
    adamw = opt.AdamWConfig()
    state = opt.init_opt_state(p, adamw)
    osh = shd.tree_shardings(state, opt.opt_state_specs(specs, adamw),
                             mesh, zero1=True)
    grad_sh = shd.tree_shardings(p, specs, mesh, zero1=True)
    res["blocks"]["opt"] = shapes_of(state["moments"], osh["moments"])
    res["blocks"]["accum"] = shapes_of(p, grad_sh)
    bsh = {k: NamedSharding(mesh, P(baxes, *([None] * (np.ndim(v) - 1))))
           for k, v in batch.items()}
    loss_fn = ts.make_loss_fn(cfg, rt, plan.constrain, 512)
    train = ts.make_train_step(cfg, rt, plan.constrain, adamw,
                               microbatches=MICRO, grad_shardings=grad_sh,
                               accum_dtype=jnp.float32)

    def both(p_, st, b):
        (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(p_, b)
        g = jax.tree.map(jax.lax.with_sharding_constraint, g, grad_sh)
        return (loss, g), train(p_, st, b)
    (loss, grads), (newp, _, metrics) = jax.jit(
        both, in_shardings=(sh, osh, bsh))(p, state, batch)
    res["loss"] = float(loss)
    res["step_loss"] = float(metrics["loss"])
    res["grad_norm"] = float(metrics["grad_norm"])
    res["grads"] = host(grads)
    res["new_params"] = host(newp)
    if arch == "gemma2-9b" and mname in ("2x2", "4x1"):
        # the same step with int8 moments (ZeRO-1 over the FSDP blocks; on
        # (4, 1) out_embed's block is whole quantisation blocks)
        adamw = opt.AdamWConfig(moments_dtype="int8")
        state = opt.init_opt_state(p, adamw)
        osh = shd.tree_shardings(state, opt.opt_state_specs(specs, adamw),
                                 mesh, zero1=True)
        train = ts.make_train_step(cfg, rt, plan.constrain, adamw,
                                   microbatches=MICRO,
                                   grad_shardings=grad_sh,
                                   accum_dtype=jnp.float32)
        newp, _, _ = jax.jit(train, in_shardings=(sh, osh, bsh))(
            p, state, batch)
        res["int8_new_params"] = host(newp)
with open(sys.argv[1], "wb") as fh:
    pickle.dump({f"{mname}_{arch}": res}, fh)
'''


def _jax_pair(tmp: Path, mesh: str, arch: str, what: str) -> dict:
    """JAX's side of one (mesh, arch) pair, in a subprocess."""
    env = dict(os.environ)
    n = int(np.prod(MESHES[mesh]))
    # LLVM's optimisation passes off: the programs compile in about half
    # the time (the HLO, and so what JAX computes, is the same)
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={n} "
                        "--xla_backend_optimization_level=0 "
                        "--xla_llvm_disable_expensive_passes=true")
    env["PYTHONPATH"] = str(REPO / "src")
    path = tmp / f"{mesh}_{arch}.pkl"
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_SIDE),
                        str(path), arch, mesh, what, str(DROPLESS_CF)],
                       capture_output=True, text=True, timeout=900, env=env)
    assert p.returncode == 0, f"stdout:\n{p.stdout}\nstderr:\n{p.stderr}"
    return pickle.loads(path.read_bytes())


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(JAX's results, each rank's port results) of every case: JAX's
    pairs ``JAX_JOBS`` at a time; a gloo world of four for the (2, 2)
    and (4, 1) cases and one of eight for (2, 2, 2), each as soon as its
    pairs are done."""
    tmp = tmp_path_factory.mktemp("fsdp")
    worlds = {4: [p for p in PAIRS if p[0] != "2x2x2"],
              8: [p for p in PAIRS if p[0] == "2x2x2"]}
    with ThreadPoolExecutor(JAX_JOBS) as jobs, \
            ThreadPoolExecutor(len(worlds)) as runs:
        futs = {n: [jobs.submit(_jax_pair, tmp, m, a, w)
                    for m, a, w in pairs]
                for n, pairs in worlds.items()}

        def world(n):
            ref = {}
            for f in futs[n]:
                ref.update(f.result())
            return ref, torch_worlds.run_world(
                torch_worlds.fsdp_cases, n, tmp / f"port_{n}", ref)
        done = list(runs.map(world, worlds))
    ref, port = {}, {}
    for r, ranks in done:
        ref.update(r)
        for case in r:
            port[case] = [got[case] for got in ranks]
    return ref, port


@pytest.fixture(scope="module")
def jax_side(sides):
    return sides[0]


@pytest.fixture(scope="module")
def port_side(sides):
    return sides[1]


def _close(got, want, tol=TOL, rel=False, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if rel and want.size \
        else 1.0
    err = float(np.abs(got.astype(np.float64) - want).max()) \
        if want.size else 0.0
    assert err <= tol * scale, (what, err, tol * scale)


@pytest.mark.parametrize("case", SERVE_CASES)
def test_serve_matches_jax(case, jax_side, port_side):
    """The prefill plan's logits (FSDP: the layers gathered in their
    bodies), then the decode plan's prefill and four greedy steps: logits
    gathered whole within 1e-5 of JAX's on every rank and the greedy
    tokens equal (JAX's are fed). The (2, 2, 2) grok-1 case is held to
    JAX's dense gshard route on the same plan."""
    ref = jax_side[case]
    for got in port_side[case]:
        if "prefill_logits" in ref:
            _close(got["prefill_logits"], ref["prefill_logits"],
                   what="prefill")
        _close(got["decode_prefill_logits"], ref["decode_prefill_logits"],
               what="decode plan prefill")
        assert len(got["greedy"]) == len(ref["decode_tokens"])
        for i, (g, w) in enumerate(zip(got["decode_logits"],
                                       ref["decode_logits"])):
            _close(g, w, what=f"decode step {i}")
        for g, w in zip(got["greedy"], ref["decode_tokens"]):
            np.testing.assert_array_equal(g, w)


def test_reference_2d_moe_decode_swaps_rows(jax_side, port_side):
    """On (2, 2, 2) JAX's own 2-D MoE decode route gives other rows than
    its dense gshard route (the rows of (pod 0, data 1) and (pod 1,
    data 0) trade places), while the port's 2-D route gives the gshard
    rows: why the port departs from the reference there (ROADMAP)."""
    ref = jax_side["2x2x2_grok-1-314b"]
    rep, dense = ref["replicated"]["decode_prefill_logits"], \
        ref["decode_prefill_logits"]
    b, per = dense.shape[0], dense.shape[0] // 4
    gap = np.abs(rep - dense).max(axis=-1)
    assert gap.max() > 100 * TOL, gap
    # the rows of the processes at flat batch index 1 and 2 are swapped
    # (rows can still differ where experts route alike: compare wholes)
    moved = [i // per for i in range(b) if gap[i] > 100 * TOL]
    assert set(moved) <= {1, 2} and moved, moved
    for got in port_side["2x2x2_grok-1-314b"]:
        _close(got["decode_prefill_logits"], dense)
        assert np.abs(got["decode_prefill_logits"] - rep).max() > 100 * TOL


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_train_step_matches_jax(case, jax_side, port_side):
    """The loss; every gradient (the port's ZeRO-2 blocks, gathered
    whole) against JAX's global gradient; the step's loss and gradient
    norm over two microbatches; every parameter after one AdamW step
    (FSDP blocks and ZeRO-1 moments, the accumulator's blocks; gemma2
    also with int8 moments), gathered whole: within 1e-5 of the leaf's
    largest magnitude."""
    ref = jax_side[case]
    for got in port_side[case]:
        assert abs(got["loss"] - ref["loss"]) <= TOL * max(1, ref["loss"])
        assert abs(got["step_loss"] - ref["step_loss"]) <= \
            TOL * max(1, ref["step_loss"])
        assert abs(got["grad_norm"] - ref["grad_norm"]) <= \
            TOL * max(1, ref["grad_norm"])
        assert set(got["grads"]) == set(ref["grads"])
        for k, w in ref["grads"].items():
            _close(got["grads"][k], w, rel=True, what=k)
        for k, w in ref["new_params"].items():
            _close(got["new_params"][k], w, rel=True, what=k)
        for k, w in ref.get("int8_new_params", {}).items():
            _close(got["int8_new_params"][k], w, rel=True, what=k)


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_zero2_without_fsdp_matches_jax(case, jax_side, port_side):
    """ZeRO-2 on parameters the layout leaves whole over the batch axes
    (``fsdp=False``, ``grad_shardings`` as JAX's): each gradient is
    reduce-scattered at the shard_map's boundary (``compat.GradBlock``),
    so its blocks have JAX's accumulator ``shard_shape``; the gradients
    gathered whole, the step's loss, gradient norm and new parameters
    equal JAX's within 1e-5 (JAX's values do not depend on the
    shardings), and every psum over a batch axis is a scalar."""
    ref = jax_side[case]
    for got in port_side[case]:
        z = got["zero2"]
        assert z["fsdp_leaves"] == 0
        assert z["accum"] == {k: tuple(v) for k, v in
                              ref["blocks"]["accum"].items()}
        for k, w in ref["grads"].items():
            _close(z["grads"][k], w, rel=True, what=k)
        for k, w in ref["new_params"].items():
            _close(z["new_params"][k], w, rel=True, what=k)
        for k in ("step_loss", "grad_norm"):
            assert abs(z[k] - ref[k]) <= TOL * max(1, ref[k]), k
        st = z["step_stats"]
        assert st.get("grad_scatter") and not st.get("fsdp_gather"), st
        for ax in ("pod", "data"):
            psum = st.get("psum", {}).get(ax)
            if psum:
                assert psum["bytes"] <= 4 * psum["calls"], (case, ax, psum)


@pytest.mark.parametrize("case", CASES)
def test_blocks_match_jax_shard_shapes(case, jax_side, port_side):
    """Every rank's block of every parameter (each plan's: FSDP where
    JAX's plan has it), moment and gradient-accumulator leaf has JAX's
    ``shard_shape`` under the same sharding; an FSDP plan cuts some leaf
    over the batch axes on every rank, and the gradient blocks are those
    of ``grad_shardings`` even where the parameter is not cut."""
    ref = jax_side[case]
    for got in port_side[case]:
        assert set(got["blocks"]) == set(ref["blocks"])
        for group, leaves in ref["blocks"].items():
            assert set(got["blocks"][group]) == set(leaves), group
            for k, want in leaves.items():
                assert tuple(got["blocks"][group][k]) == tuple(want), \
                    (group, k, got["blocks"][group][k], want)
        for kind, fsdp in ref["fsdp"].items():
            assert got["fsdp"][kind] == fsdp, kind
            assert (got["fsdp_leaves"][kind] > 0) == fsdp, kind


def test_fsdp_gradients_move_no_psum_over_the_batch_axes(port_side):
    """Under FSDP + ZeRO-2 a gradient reaches the optimizer reduce-
    scattered over the batch axes (``grad_scatter``; a layer of a stack
    cut on its layer dim: ``grad_reduce``): every psum over a batch axis
    in the step is a float32 scalar (the loss's sums, the norm's
    squares)."""
    for case in TRAIN_CASES:
        for got in port_side[case]:
            st = got["step_stats"]
            assert st.get("grad_scatter"), (case, st)
            for ax in ("pod", "data"):
                psum = st.get("psum", {}).get(ax)
                if psum:
                    assert psum["bytes"] <= 4 * psum["calls"], (case, ax,
                                                                psum)
