"""The port's dry run against the JAX package's, on the CPU.

Held to JAX: the 40-cell registry, ``SHAPES``, ``ParallelConfig`` and
``RunConfig``; ``opt_state_specs`` and the optimizer state's shapes;
``input_specs`` of every cell (meta tensors against JAX's
``ShapeDtypeStruct``s); the plan numbers (``_sharded_bytes``,
``analytic_memory``, ``pick_microbatches``, FSDP) of every runnable cell
on both production meshes, JAX's through an ``AbstractMesh``, exactly;
``Plan.resid_spec`` with ``seq_parallel``; ``op_analysis`` at the sizes
of JAX's ``tests/test_hlo_analysis.py`` (a 10-step loop, nested 4 x 5
loops, remat counting 4x a layer) and a smoke prefill's FLOPs against
JAX's ``hlo_analysis`` of the same compiled prefill. Also the flash
wrapper's meta route and analysis hook, ``op_debug``, two dry-run
cells through the CLI (whisper-tiny decode_32k on the multi-pod mesh,
grok-1-314b train_4k on the single-pod mesh through the collectives'
backward at tp=16), each in a subprocess, and the smoke recurrent archs
traced on a fake world of four with their mixers laid out over
``model`` (held bytes equal to the plan's, the scan kernels' meta
routes).

JAX's ``launch/dryrun.py`` sets ``XLA_FLAGS`` to 512 host devices when
imported: it is imported only after this process's JAX backend has
started, and the variable is put back, so later JAX subprocesses of
this worker keep their own device counts.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.utils.checkpoint as ckpt
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as JSHAPES
from repro.configs import base as jbase
from repro.configs import registry as jregistry
from repro.distributed import sharding as jshd
from repro.launch import specs as jspecs
from repro.models import transformer as jT
from repro.train import optimizer as jopt
from repro_torch.configs import SHAPES, base, registry
from repro_torch.distributed import compat
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import dryrun, op_analysis, op_debug
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt

REPO = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(c.arch, c.shape.name) for c in jregistry.cells()]
RUNNABLE = [(c.arch, c.shape.name) for c in jregistry.cells() if not c.skip]


@functools.lru_cache(maxsize=None)
def _jdry():
    jax.devices()  # the backend starts with this process's device count
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdry
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jdry


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------

def test_cells_shapes_and_run_configs_match_jax():
    assert [(c.arch, c.shape, c.skip, c.name) for c in registry.cells()] == \
        [(c.arch, base.ShapeConfig(**dataclasses.asdict(c.shape)), c.skip,
          c.name) for c in jregistry.cells()]
    assert len(list(registry.cells())) == 40
    assert sum(1 for c in registry.cells() if c.skip) == 8
    assert all(c.shape.name == "long_500k" for c in registry.cells()
               if c.skip)
    assert list(registry.cells("gemma2-9b", "train_4k")) == \
        [registry.Cell("gemma2-9b", SHAPES["train_4k"])]
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert _fields(base.ParallelConfig) == _fields(jbase.ParallelConfig)
    mine = [(n, d) for n, d in _fields(base.RunConfig) if n != "parallel"]
    want = [(n, d) for n, d in _fields(jbase.RunConfig) if n != "parallel"]
    assert mine == want
    assert [f.name for f in dataclasses.fields(base.RunConfig)] == \
        [f.name for f in dataclasses.fields(jbase.RunConfig)]
    assert dataclasses.asdict(base.RunConfig(
        registry.get_config("gemma2-9b"), SHAPES["train_4k"]).parallel) == \
        dataclasses.asdict(jbase.ParallelConfig())


# ---------------------------------------------------------------------------
# optimizer state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moments", ["float32", "int8"])
@pytest.mark.parametrize("arch", jregistry.ARCH_IDS)
def test_opt_state_specs_match_jax(arch, moments):
    """``opt_state_specs`` leaf for leaf, and ``init_opt_state``'s shapes
    and dtypes on meta against JAX's ``eval_shape``."""
    jcfg, cfg = jregistry.get_config(arch), registry.get_config(arch)
    jshapes, jspecs_ = jT.abstract_params(jcfg, jT.ModelRuntime())
    shapes, pspecs = T.abstract_params(cfg, T.ModelRuntime())
    want = jopt.opt_state_specs(jspecs_, jopt.AdamWConfig(
        moments_dtype=moments))
    got = opt.opt_state_specs(pspecs, opt.AdamWConfig(
        moments_dtype=moments))
    want = jax.tree.map(tuple, want, is_leaf=lambda x: isinstance(x, tuple))
    assert _flat(got) == _flat(want)
    jstate = jax.eval_shape(lambda p: jopt.init_opt_state(
        p, jopt.AdamWConfig(moments_dtype=moments)), jshapes)
    state = opt.init_opt_state(shapes, opt.AdamWConfig(
        moments_dtype=moments))
    assert {k: (tuple(v.shape), _dtype(v.dtype))
            for k, v in _flat(state).items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(jstate).items()}


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

def _runtimes(arch, shape_name, mesh_name="16x16"):
    shape_, axes = MESHES[mesh_name]
    jplan = jshd.Plan(AbstractMesh(shape_, axes), jregistry.get_config(arch),
                      JSHAPES[shape_name], jbase.ParallelConfig())
    plan = shd.Plan(tmesh.Mesh(shape_, axes), registry.get_config(arch),
                    SHAPES[shape_name], base.ParallelConfig())
    return jplan, plan


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_input_specs_match_jax(arch, shape_name):
    """Every cell's meta inputs (and cache specs) have JAX's
    ShapeDtypeStructs' shapes and dtypes."""
    jplan, plan = _runtimes(arch, shape_name)
    want, wspecs = jspecs.input_specs(jplan.cfg, jplan.shape,
                                      jplan.runtime())
    got, gspecs = specs.input_specs(plan.cfg, plan.shape, plan.runtime())
    assert {k: (tuple(v.shape), _dtype(v.dtype), v.device.type)
            for k, v in _flat(got).items()} == \
        {k: (tuple(v.shape), str(v.dtype), "meta")
         for k, v in _flat(want).items()}
    if wspecs is None:
        assert gspecs is None
    else:
        assert _flat(gspecs) == _flat(jax.tree.map(
            tuple, wspecs, is_leaf=lambda x: isinstance(x, tuple)))


# ---------------------------------------------------------------------------
# the plan numbers
# ---------------------------------------------------------------------------

def _jax_plan(arch, shape_name, mesh_name):
    """JAX's dry run's plan numbers for one cell, through its own pure
    functions on an AbstractMesh (build_and_compile's shardings, without
    lowering; a prefill's caches have init_cache's shapes)."""
    jdry = _jdry()
    shape_, axes = MESHES[mesh_name]
    mesh = AbstractMesh(shape_, axes)
    cfg, shape = jregistry.get_config(arch), JSHAPES[shape_name]
    plan = jshd.Plan(mesh, cfg, shape, jbase.ParallelConfig())
    rt = plan.runtime()
    dp = mesh.size // mesh.shape["model"]
    params_shapes, pspecs = jT.abstract_params(cfg, rt)
    tp = mesh.shape["model"]
    overrides = None
    if cfg.moe is not None and shape.kind == "decode":
        fsdp, overrides = False, {"expert_f": "__batch__"}
    else:
        fsdp = 2 * cfg.param_count(tp, padded=True) / tp > 4e9
    param_sh = jshd.tree_shardings(params_shapes, pspecs, mesh, zero1=fsdp,
                                   overrides=overrides)

    def batch_sh(batch):
        return {k: NamedSharding(mesh, jshd._fit_pspec(
            JP(plan.batch, *([None] * (len(v.shape) - 1))), v.shape, mesh))
            for k, v in batch.items()}

    mb = 1
    if shape.kind == "train":
        mb = jdry.pick_microbatches(cfg, shape, dp)
        adamw = jopt.AdamWConfig(moments_dtype="int8" if
                                 cfg.param_count() > 1.2e11 else "float32")
        opt_shapes = jax.eval_shape(lambda p: jopt.init_opt_state(p, adamw),
                                    params_shapes)
        opt_sh = jshd.tree_shardings(opt_shapes,
                                     jopt.opt_state_specs(pspecs, adamw),
                                     mesh, zero1=True)
        batch, _ = jspecs.input_specs(cfg, shape, rt)
        arg = jdry._sharded_bytes((params_shapes, opt_shapes, batch),
                                  (param_sh, opt_sh, batch_sh(batch)))
    elif shape.kind == "prefill":
        batch, _ = jspecs.input_specs(cfg, shape, rt)
        cache, cspecs = jspecs.abstract_cache(
            cfg, rt, shape.global_batch,
            shape.seq_len if cfg.enc_dec else 0)
        arg = jdry._sharded_bytes(
            (params_shapes, batch, cache),
            (param_sh, batch_sh(batch),
             jshd.tree_shardings(cache, cspecs, mesh)))
    else:
        inputs, cspecs = jspecs.input_specs(cfg, shape, rt)
        arg = jdry._sharded_bytes(
            (params_shapes, inputs["cache"]),
            (param_sh, jshd.tree_shardings(inputs["cache"], cspecs, mesh)))
    return jdry.analytic_memory(cfg, shape, mesh, mb, arg), mb, fsdp


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch,shape_name", RUNNABLE)
def test_plan_numbers_match_jax(arch, shape_name, mesh_name):
    """_sharded_bytes, analytic_memory, pick_microbatches and the FSDP
    choice of every runnable cell equal JAX's exactly (only the fit is
    read against 80 GB, where JAX's reads 16)."""
    want, want_mb, want_fsdp = _jax_plan(arch, shape_name, mesh_name)
    shape_, axes = MESHES[mesh_name]
    mesh = tmesh.Mesh(shape_, axes)
    cfg, shape = registry.get_config(arch), SHAPES[shape_name]
    dp = mesh.size // mesh.shape["model"]
    mb = dryrun.pick_microbatches(cfg, shape, dp)
    assert mb == want_mb
    rt = shd.Plan(mesh, cfg, shape, base.ParallelConfig()).runtime()
    got = dryrun.plan_memory(cfg, shape, mesh, rt, mb)
    assert got.pop("fsdp") == want_fsdp
    for k in ("arg_bytes_exact", "transient_model", "peak_model"):
        assert got[k] == want[k], (k, got[k], want[k])
    assert got["fits_80GB_model"] == (want["peak_model"] <= 80e9)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_resid_spec_with_seq_parallel_matches_jax(kind):
    for shape_, axes in MESHES.values():
        for sp in (False, True):
            jp = jshd.Plan(AbstractMesh(shape_, axes),
                           jregistry.get_config("gemma2-9b"),
                           jbase.ShapeConfig("s", 64, 4, kind),
                           jbase.ParallelConfig(seq_parallel=sp))
            mp = shd.Plan(tmesh.Mesh(shape_, axes),
                          registry.get_config("gemma2-9b"),
                          base.ShapeConfig("s", 64, 4, kind),
                          base.ParallelConfig(seq_parallel=sp))
            norm = [tuple(compat.entry_axes(e)) for e in jp.resid_spec()]
            assert [tuple(compat.entry_axes(e))
                    for e in mp.resid_spec()] == norm, (kind, sp, axes)
    assert (kind != "decode") == (mp.resid_spec()[1] == "model")


# ---------------------------------------------------------------------------
# op_analysis at the sizes of JAX's tests/test_hlo_analysis.py
# ---------------------------------------------------------------------------

DEVICES = ["cpu", "meta"]


@pytest.mark.parametrize("device", DEVICES)
def test_loop_counts_every_step(device):
    w = torch.zeros(256, 256, device=device)
    x = torch.zeros(32, 256, device=device)

    def looped(x, w):
        for _ in range(10):
            x = torch.tanh(x @ w)
        return x

    _, res = op_analysis.analyze(looped, x, w)
    expect = 2 * 32 * 256 * 256 * 10
    assert abs(res["flops"] - expect) / expect < 1e-6
    assert res["torch_raw"]["flops"] == res["flops"]
    assert res["bytes"] == res["bytes_unfused"] > 0


@pytest.mark.parametrize("device", DEVICES)
def test_nested_loops(device):
    w = torch.zeros(128, 128, device=device)
    x = torch.zeros(16, 128, device=device)

    def nested(x, w):
        for _ in range(4):
            for _ in range(5):
                x = x @ w
        return x

    _, res = op_analysis.analyze(nested, x, w)
    expect = 2 * 16 * 128 * 128 * 20
    assert abs(res["flops"] - expect) / expect < 1e-6


@pytest.mark.parametrize("device", DEVICES)
def test_remat_counts_recompute(device):
    w = torch.zeros(128, 128, device=device, requires_grad=True)
    x = torch.zeros(16, 128, device=device)

    def grad(x, w):
        c = x
        for _ in range(6):
            c = ckpt.checkpoint(lambda a: torch.tanh(a @ w), c,
                                use_reentrant=False)
        return torch.autograd.grad((c.float() ** 2).sum(), w)

    _, res = op_analysis.analyze(grad, x, w)
    one = 2 * 16 * 128 * 128
    # fwd + recompute + 2 bwd matmuls = 4x per layer
    expect = 4 * one * 6
    assert 0.9 * expect < res["flops"] < 1.35 * expect, \
        (res["flops"], expect)


@pytest.mark.parametrize("device", DEVICES)
def test_one_product(device):
    a = torch.zeros(8, 8, device=device)
    _, res = op_analysis.analyze(lambda t: t @ t, a)
    assert res["flops"] == 2 * 8 * 8 * 8
    assert res["bytes"] == 3 * 8 * 8 * 4


def test_torch_raw_is_flop_counter_modes_count():
    from torch.utils.flop_counter import FlopCounterMode
    q = torch.zeros(2, 64, 4, 16)
    k = torch.zeros(2, 64, 2, 16)

    def fn():
        from repro_torch.models.attention import attend
        return attend(q, k, k, causal=True, impl="blockwise") @ \
            torch.zeros(16, 8)

    with FlopCounterMode(display=False) as counter:
        fn()
    _, res = op_analysis.analyze(fn)
    assert res["torch_raw"]["flops"] == counter.get_total_flops() > 0
    assert res["flops_by_tag"]["attention"] > 0


def test_peak_counts_live_storages_once():
    """Held arguments count from the start; views add nothing; a storage
    freed inside the call leaves the live count."""
    x = torch.zeros(1024, device="meta")  # 4 KiB

    def fn(x):
        a = x * 2            # +4 KiB
        b = a[::2]           # a view: +0
        del a
        c = b + 1            # +2 KiB, a's storage still held by b
        del b                # frees a's 4 KiB
        return c * 3         # +2 KiB

    _, res = op_analysis.analyze(fn, x)
    assert res["held_bytes"] == 4096
    assert res["peak_bytes"] == 4096 + 4096 + 2048


@pytest.mark.parametrize("arch", ["gemma2-9b", "starcoder2-15b"])
def test_smoke_prefill_flops_match_jax_hlo(arch):
    """A smoke config's prefill on one device: the port's FLOPs within 2%
    of JAX's trip-count-aware HLO analysis of the same compiled prefill
    (dots only, on both sides)."""
    from repro.launch import hlo_analysis
    from repro_torch import bridge
    jcfg, cfg = jregistry.get_smoke_config(arch), \
        registry.get_smoke_config(arch)
    jrt = jT.ModelRuntime(attn_impl="blockwise", max_seq=64)
    rt = T.ModelRuntime(attn_impl="blockwise", max_seq=64)
    params, _ = jT.init_params(jax.random.PRNGKey(0), jcfg, jrt)
    tokens = np.zeros((2, 64), np.int32)
    text = jax.jit(lambda p, t: jT.prefill(p, jcfg, jrt, t)).lower(
        params, tokens).compile().as_text()
    want = hlo_analysis.analyze(text, 1)["flops"]
    tparams = bridge.params_from_host(jax.tree.map(np.asarray, params),
                                      "cpu")
    with torch.no_grad():
        _, res = op_analysis.analyze(T.prefill, tparams, cfg, rt,
                                     torch.from_numpy(tokens))
    assert abs(res["flops"] - want) / want < 0.02, (res["flops"], want)


# ---------------------------------------------------------------------------
# the flash wrapper's meta route and hook; op_debug
# ---------------------------------------------------------------------------

def test_flash_meta_route_launches_nothing_and_reports():
    q = torch.empty(2, 64, 8, 128, device="meta", dtype=torch.bfloat16)
    k = torch.empty(2, 64, 4, 128, device="meta", dtype=torch.bfloat16)
    before = fa_ops.launches
    out, res = op_analysis.analyze(
        lambda: fa_ops.flash_attention(q, k, k, causal=True, window=16))
    assert out.device.type == "meta" and out.shape == q.shape
    assert out.dtype == torch.bfloat16 and fa_ops.launches == before
    pairs = 16 * 17 // 2 + (64 - 16) * 16
    assert fa_ops.visible_pairs(64, 64, True, 16) == pairs
    rec = res["kernels"]["flash_attention"]
    assert rec["calls"] == 1
    assert rec["flops"] == 4.0 * 2 * 8 * 128 * pairs
    assert rec["bytes"] == (2 * 2 * 64 * 8 * 128 + 2 * 2 * 64 * 4 * 128) * 2
    with pytest.raises(ValueError, match="head_dim"):  # _check on meta
        fa_ops.flash_attention(q[..., :48], k[..., :48], k[..., :48],
                               causal=True)
    # outside an analysis a meta call reports nothing and launches nothing
    fa_ops.flash_attention(q, k, k, causal=False)
    assert fa_ops.launches == before


def test_flash_other_devices_keep_their_routes():
    q = torch.randn(1, 16, 2, 16)
    k = torch.randn(1, 16, 1, 16)
    _, res = op_analysis.analyze(
        lambda: fa_ops.flash_attention(q, k, k, causal=True))
    assert res["kernels"] == {} and res["flops"] > 0  # the plain version
    with pytest.raises(ValueError, match="devices differ"):
        fa_ops.flash_attention(q.to("meta"), k, k, causal=True)


def test_op_debug_breakdown(tmp_path, capsys):
    w = torch.zeros(64, 64, device="meta")
    path = tmp_path / "cell.ops"
    op_analysis.analyze(lambda x: torch.tanh(x @ w) @ w,
                        torch.zeros(8, 64, device="meta"), save_ops=path)
    op_debug.breakdown(str(path), top=2)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("total bytes (unfused model): ")
    assert len(lines) == 3 and " mm (8, 64) x2 :: other" in lines[1]


# ---------------------------------------------------------------------------
# the CLI, one process a mesh
# ---------------------------------------------------------------------------

KEYS = ("flops_per_device", "bytes_per_device", "collectives",
        "collective_wire_bytes", "bytes_by_tag", "flops_by_tag",
        "roofline", "memory", "timing", "seq_parallel", "fsdp", "torch_raw")


def _cli(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--out", str(tmp_path), *args], capture_output=True,
                       text=True, timeout=240, env=env)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "  ok: " in p.stdout
    return p.stdout


def _check_cell(res, mesh, n):
    for k in KEYS:
        assert k in res, k
    assert res["mesh"] == mesh and res["n_devices"] == n
    assert set(res["memory"]) == {"plan", "traced", "fits_80GB"}
    assert {"arg_bytes", "peak_bytes", "fits_80GB_traced"} == \
        set(res["memory"]["traced"])
    assert res["memory"]["traced"]["peak_bytes"] >= \
        res["memory"]["traced"]["arg_bytes"] > 0
    assert res["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert res["timing"]["trace_s"] > 0


def test_cli_whisper_decode_on_the_multi_pod_mesh(tmp_path):
    out = _cli(tmp_path, "--arch", "whisper-tiny", "--shape", "decode_32k",
               "--mesh", "multi")
    res = json.loads((tmp_path /
                      "whisper-tiny_decode_32k_2x16x16.json").read_text())
    _check_cell(res, "2x16x16", 512)
    assert res["kind"] == "decode" and "fits=True" in out
    # flash-decoding: the (m, l, o) combine over 'model'; each rank runs
    # its own rows, so nothing moves over the batch axes
    assert res["collectives"]["all-reduce"]["count"] > 0
    assert set(res["collective_wire_by_axis"]) == {"model"}


def test_cli_grok_train_through_the_collectives_backward(tmp_path):
    _cli(tmp_path, "--arch", "grok-1-314b", "--shape", "train_4k",
         "--mesh", "single", "--mb", "1")
    res = json.loads((tmp_path /
                      "grok-1-314b_train_4k_16x16.json").read_text())
    _check_cell(res, "16x16", 256)
    assert res["moments"] == "int8" and res["microbatches"] == 1
    coll = res["collectives"]
    # forward and backward: two all_to_alls a MoE layer each way and
    # the inner ring's ppermute, the router's gradient summed
    assert coll["all-to-all"]["count"] >= 4 * 64
    assert coll["collective-permute"]["count"] >= 2 * 64
    assert coll["all-reduce"]["count"] > 0
    assert res["flops_by_tag"]["moe"] > 0
    assert res["memory"]["plan"]["fits_80GB_model"] is True


# ---------------------------------------------------------------------------
# the recurrent mixers laid out, and the scan kernels' meta routes, in a
# traced cell
# ---------------------------------------------------------------------------

RECURRENT_CELLS = r"""
import json, sys
from repro_torch.configs import ShapeConfig, base, registry
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
arch = sys.argv[1]
cfg = registry.get_smoke_config(arch)
dryrun.init_fake_world(4)
mesh = make_mesh((1, 4), ("data", "model"), "cpu")
out = {}
for kind, impl in (("prefill", "blockwise"), ("decode", "blockwise"),
                   ("train", "blockwise"), ("prefill", "pallas")):
    res = dryrun.build_and_trace(
        arch, kind, False, base.ParallelConfig(attn_impl=impl), 1,
        shape=ShapeConfig(kind, 64, 8, kind), mesh=mesh, mesh_name="1x4",
        cfg=cfg)
    out[f"{kind}_{impl}"] = {"held": res["held"], "layout": res["layout"],
                             "kernels": res["kernels"],
                             "flops_by_tag": res["flops_by_tag"]}
print(json.dumps(out))
"""


@pytest.mark.parametrize("arch,kernel,layers", [
    ("recurrentgemma-9b", "rglru", 2), ("mamba2-1.3b", "ssd", 2)])
def test_recurrent_cells_hold_the_plan_and_trace_their_kernels(
        arch, kernel, layers):
    """A smoke recurrent arch traced on a fake world of four at (1, 4):
    in every kind the parameter and optimizer-state bytes a rank holds
    equal the plan's (``whole_by_design`` 0: the mixers are laid out) and
    the record names the four recurrent axes; a prefill with the kernel
    runtime (``attn_impl="pallas"``) reports one scan-kernel call per
    recurrent layer through the meta route (recurrentgemma also one flash
    call for its attention layer), while the default run traces the plain
    scans (no kernel)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    p = subprocess.run([sys.executable, "-c", RECURRENT_CELLS, arch],
                       capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    cells = json.loads(p.stdout.strip().splitlines()[-1])
    for name, res in cells.items():
        held = res["held"]
        assert held["traced"] == held["plan"], name
        assert held["whole_by_design"] == 0, name
        assert {"rglru", "rglru_heads", "ssm_heads", "ssm_flat"} <= \
            set(res["layout"])
    kernels = cells["prefill_pallas"]["kernels"]
    assert kernels[kernel]["calls"] == layers
    assert kernels[kernel]["flops"] > 0
    assert cells["prefill_pallas"]["flops_by_tag"]["ssm"] >= \
        kernels[kernel]["flops"]
    if arch == "recurrentgemma-9b":
        assert kernels["flash_attention"]["calls"] == 1
    for name in ("prefill_blockwise", "decode_blockwise",
                 "train_blockwise"):
        assert kernel not in cells[name]["kernels"], name
