"""The port's ``distributed/`` against the JAX package's, on the CPU.

The JAX side runs once, in a subprocess with four host devices
(``--xla_force_host_platform_device_count``, as
``tests/test_distributed.py`` runs it), and pickles its inputs and
outputs; the port side runs the same inputs in gloo worlds of
``torch.multiprocessing`` processes (``tests/torch_worlds.py``), one
world a mesh size. Covered: flash-decoding (meshes (2,2) and (1,4),
window 0 and 8, cap 0 and 50, batch 1, writes owned by a later shard,
a ring that wrapped, a read without a write), the compressed reduction
at (4,) "data", the GPipe pipeline at (4,1), the sharding specs of all
ten archs against JAX's PartitionSpecs, the hooks ``Plan.runtime``
picks, the whole slice (grok-1's smoke config served at (1,2)), and
the collectives' backward: each collective's gradient at (1,2) and
(2,2) against ``jax.grad`` through JAX's shard_map, and grok-1's smoke
training gradients through its train plan's MoE hook.
One ``cuda`` test holds the backends on one card to what
``launch/mesh.py`` and ``compat.py`` assume of them.
"""
import functools
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import torch_worlds
from repro.configs import registry as jregistry
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import ShapeConfig as JShape
from repro.distributed import sharding as jshd
from repro.models import transformer as jT
from repro_torch.configs import ParallelConfig, ShapeConfig, registry
from repro_torch.distributed import compat
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as T

REPO = Path(__file__).resolve().parents[1]
FLASH_MESHES = {"2x2": ((2, 2), ("data", "model")),
                "1x4": ((1, 4), ("data", "model"))}
FLASH_CASES = [f"{m}_w{w}_cap{c}" for m in FLASH_MESHES for w in (0, 8)
               for c in (0, 50)] + \
    [f"{m}_{k}" for m in FLASH_MESHES for k in ("batch1", "wrapped",
                                                 "read_only")]
SPEC_MESHES = {"2x4": ((2, 4), ("data", "model")),
               "16x16": ((16, 16), ("data", "model")),
               "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RUNTIME_MESHES = {"1x1": (1, 1), "1x4": (1, 4), "2x2": (2, 2)}

JAX_SIDE = r'''
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import registry
from repro.configs.base import ParallelConfig, ShapeConfig
from repro.distributed import sharding as shd
from repro.distributed.compat import shard_map
from repro.distributed.compression import compressed_psum_scatter_gather
from repro.distributed.decode_attn import make_flash_decode
from repro.distributed.pipeline import pipeline_apply
from repro.models import transformer as T

def mesh(shape, axes):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)

rng = np.random.default_rng(0)
out = {"cases": {}, "results": {}}

def ring_kpos(b, sc, pos):
    kp = np.full((b, sc), -1, np.int32)
    for p in range(pos):
        kp[:, p % sc] = p
    return kp

B, SC, KH, H, DH = 4, 16, 2, 8, 16
for mname, (shape, axes) in {"2x2": ((2, 2), ("data", "model")),
                             "1x4": ((1, 4), ("data", "model"))}.items():
    m = mesh(shape, axes)
    fd = make_flash_decode(m)
    specs = [(f"w{w}_cap{c}", dict(b=B, pos=10, window=w, cap=c))
             for w in (0, 8) for c in (0, 50)]
    specs += [("batch1", dict(b=1, pos=10, window=0, cap=0)),
              ("wrapped", dict(b=B, pos=21, window=8, cap=50)),
              ("read_only", dict(b=B, pos=9, window=0, cap=0, write=False))]
    for tag, s in specs:
        b = s["b"]
        case = {"kind": "flash_decode", "mesh": shape, "axes": axes,
                "pos": s["pos"], "window": s["window"], "cap": s["cap"],
                "kc": rng.standard_normal((b, SC, KH, DH), np.float32),
                "vc": rng.standard_normal((b, SC, KH, DH), np.float32),
                "kpos": ring_kpos(b, SC, s["pos"]),
                "q": rng.standard_normal((b, H, DH), np.float32)}
        if s.get("write", True):
            case["kn"] = rng.standard_normal((b, KH, DH), np.float32)
            case["vn"] = rng.standard_normal((b, KH, DH), np.float32)
        o, c = jax.jit(lambda *a, s=s: fd(*a, window=s["window"],
                                          cap=float(s["cap"])))(
            jnp.asarray(case["kc"]), jnp.asarray(case["vc"]),
            jnp.asarray(case["kpos"]),
            jnp.asarray(case["kn"]) if "kn" in case else None,
            jnp.asarray(case["vn"]) if "vn" in case else None,
            jnp.asarray(case["q"]), jnp.int32(s["pos"]))
        name = f"{mname}_{tag}"
        out["cases"][name] = case
        out["results"][name] = {"o": np.asarray(o),
                                **{k: np.asarray(v) for k, v in c.items()}}

# compression at (4,) "data"
m = mesh((4,), ("data",))
n = 4 * 1024 * 2
x = (rng.standard_normal((4, n)) * 0.1).astype(np.float32)
err0 = np.zeros((4, n // 4), np.float32)
def f(xl, el):
    y, e = compressed_psum_scatter_gather(xl[0], "data", el[0])
    return y[None], e[None]
g = jax.jit(shard_map(f, mesh=m, in_specs=(P("data"), P("data")),
                      out_specs=(P("data"), P("data")), check_vma=False))
y, e = g(jnp.asarray(x), jnp.asarray(err0))
acc = jnp.zeros((n,)); eacc = jnp.asarray(err0)
for _ in range(8):
    yy, eacc = g(jnp.asarray(x), eacc)
    acc = acc + yy[0]
out["cases"]["compression"] = {"kind": "compression", "mesh": (4,),
                               "axes": ("data",), "x": x, "err0": err0,
                               "rounds": 8}
out["results"]["compression"] = {"y": np.asarray(y[0]), "err": np.asarray(e),
                                 "acc": np.asarray(acc)}

# pipeline at (4, 1) ("pod", "data")
m = mesh((4, 1), ("pod", "data"))
ws = (rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32)
xm = rng.standard_normal((8, 2, 16)).astype(np.float32)
po = jax.jit(lambda w_, x_: pipeline_apply(
    m, lambda w, h: jnp.tanh(h @ w), w_, x_, axis="pod"))(
        jnp.asarray(ws), jnp.asarray(xm))
out["cases"]["pipeline"] = {"kind": "pipeline", "mesh": (4, 1),
                            "axes": ("pod", "data"), "ws": ws, "x": xm}
out["results"]["pipeline"] = {"out": np.asarray(po)}

# the slice: grok-1's smoke config at (1, 2), prefill then 3 decode steps
cfg = registry.get_smoke_config("grok-1-314b")
m = mesh((1, 2), ("data", "model"))
ring, b, s = 16, 2, 8
pre = shd.Plan(m, cfg, ShapeConfig("p", ring, b, "prefill"),
               ParallelConfig()).runtime()
dec = shd.Plan(m, cfg, ShapeConfig("d", ring, b, "decode"),
               ParallelConfig()).runtime()
params, _ = T.init_params(jax.random.PRNGKey(0), cfg, pre)
params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
logits, cache = jax.jit(lambda p, t: T.prefill(p, cfg, pre, t))(
    params, jnp.asarray(tokens))
step = jax.jit(lambda p, c, t, pos: T.decode_step(p, cfg, dec, c, t, pos))
steps, toks = [np.asarray(logits)], []
for i in range(3):
    tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
    logits, cache = step(params, cache, jnp.asarray(tok), jnp.int32(s + i))
    toks.append(tok)
    steps.append(np.asarray(logits))
leaves = {}
def walk(t, pre=""):
    for k, v in t.items():
        if isinstance(v, dict):
            walk(v, f"{pre}{k}/")
        else:
            leaves[f"{pre}{k}"] = np.asarray(v)
walk(params)
out["slice"] = {"params": leaves, "tokens": tokens, "ring": ring,
                "decode_tokens": toks, "logits": steps,
                "kpos": np.asarray(cache["group0"]["p0"]["self"]["kpos"])}

# collective gradients: jax.grad of sum(w * y) through a shard_map with
# check_vma=False (as the MoE hooks run it), on (1, 2) and (2, 2)
def grad_defs(tp, dm):
    lax = jax.lax
    defs = {
        "psum": (lambda a: lax.psum(a, "model"), P("model"), P()),
        "pmean": (lambda a: lax.pmean(a, "model"), P("model"), P()),
        "pmax": (lambda a: lax.pmax(a, "model"), P("model"), P()),
        "all_gather": (lambda a: lax.all_gather(a, "model", axis=0,
                                                tiled=True), P("model"), P()),
        "all_gather_stacked": (lambda a: lax.all_gather(a, "model", axis=1),
                               P("model"), P()),
        "psum_scatter": (lambda a: lax.psum_scatter(
            a, "model", scatter_dimension=0, tiled=True), P("model"),
            P("model")),
        "all_to_all": (lambda a: lax.all_to_all(a, "model", 0, 1,
                                                tiled=True),
                       P("model"), P("model")),
        "ppermute": (lambda a: lax.ppermute(
            a, "model", [(i, i + 1) for i in range(tp - 1)]), P("model"),
            P("model")),
    }
    if dm:
        defs["psum_dm"] = (lambda a: lax.psum(a, ("data", "model")),
                           P(("data", "model")), P())
        defs["all_gather_dm"] = (lambda a: lax.all_gather(
            a, ("data", "model"), axis=0, tiled=True), P(("data", "model")),
            P())
    return defs

out["grads"] = {}
for mname, shape in (("1x2", (1, 2)), ("2x2", (2, 2))):
    m = mesh(shape, ("data", "model"))
    for name, (fn, ins, outs) in grad_defs(shape[1], shape[0] > 1).items():
        f = shard_map(fn, mesh=m, in_specs=ins, out_specs=outs,
                      check_vma=False)
        x = rng.standard_normal((8, 4)).astype(np.float32)
        y = jax.jit(f)(jnp.asarray(x))
        w = rng.standard_normal(y.shape).astype(np.float32)
        res = {"x": x, "w": w, "y": np.asarray(y), "mesh": shape}
        try:
            g = jax.jit(jax.grad(lambda a, f=f, w=w: (f(a) * w).sum()))(
                jnp.asarray(x))
            res["grad"] = np.asarray(g)
        except NotImplementedError as e:
            res["error"] = str(e)
        out["grads"][f"{mname}_{name}"] = res

# grok-1's smoke config trained through the train plan's MoE hook:
# make_moe_etp at (1, 2), make_moe_etp2d at (2, 2); float32 gradients of
# every parameter
from repro.train import train_step as ts
out["moe_train"] = {}
for mname, shape in (("1x2", (1, 2)), ("2x2", (2, 2))):
    m = mesh(shape, ("data", "model"))
    b, s = 4, 8
    plan = shd.Plan(m, cfg, ShapeConfig("t", s, b, "train"),
                    ParallelConfig())
    rt = plan.runtime()
    params, _ = T.init_params(jax.random.PRNGKey(1), cfg, rt)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                 np.int32),
             "loss_mask": (rng.random((b, s)) < 0.9).astype(np.float32)}
    loss_fn = ts.make_loss_fn(cfg, rt, plan.constrain, 512)
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves, gleaves = {}, {}
    def walk(t, d, pre=""):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, d, f"{pre}{k}/")
            else:
                d[f"{pre}{k}"] = np.asarray(v)
    walk(params, leaves)
    walk(grads, gleaves)
    out["moe_train"][mname] = {"mesh": shape, "params": leaves,
                               "batch": batch, "loss": float(loss),
                               "grads": gleaves,
                               "hook": rt.moe_fn.__qualname__}
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
'''


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_dist") / "ref.pkl"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = str(REPO / "src")
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_SIDE),
                        str(path)], capture_output=True, text=True,
                       timeout=600, env=env)
    assert p.returncode == 0, f"stdout:\n{p.stdout}\nstderr:\n{p.stderr}"
    return pickle.loads(path.read_bytes())


@pytest.fixture(scope="module")
def port_side(jax_side, tmp_path_factory):
    """Every flash-decode, compression and pipeline case in one world of
    four processes (meshes (2,2), (1,4), (4,) and (4,1) over it)."""
    return torch_worlds.run_world(
        torch_worlds.distributed_cases, 4,
        tmp_path_factory.mktemp("port_dist"), jax_side["cases"],
        _on_mesh(jax_side, "2x2"))


@pytest.fixture(scope="module")
def port_slice(jax_side, tmp_path_factory):
    return torch_worlds.run_world(torch_worlds.slice_case, 2,
                                  tmp_path_factory.mktemp("port_slice"),
                                  jax_side["slice"],
                                  _on_mesh(jax_side, "1x2"))


def _on_mesh(jax_side, mesh_name: str) -> dict:
    """The gradient cases of one mesh: the collectives' and the MoE
    training step's."""
    return {"grads": {k: v for k, v in jax_side["grads"].items()
                      if k.startswith(mesh_name + "_")},
            "moe_train": jax_side["moe_train"][mesh_name]}


@pytest.mark.parametrize("name", FLASH_CASES)
def test_flash_decode_matches_jax(name, jax_side, port_side):
    """Inside the layout (this rank's rows and q heads, the caches as
    DTensors of their blocks): outputs within 1e-5 (float32), the
    written caches bit-equal, the cache handed back sharded over
    ``model``, and the only traffic over ``model`` the gather of the q
    heads (this rank's block of them, as GSPMD reshards q for the
    reference's shard_map) and the (m, l, o) combine."""
    want = jax_side["results"][name]
    case = jax_side["cases"][name]
    (dp, tp), _ = FLASH_MESHES[name.split("_")[0]]
    for rank, res in enumerate(port_side):
        got = res[name]
        assert np.abs(got["o"] - want["o"]).max() < 1e-5
        rows = slice(None)
        if case["kc"].shape[0] % dp == 0:
            rows = slice((rank // tp) * case["kc"].shape[0] // dp,
                         (rank // tp + 1) * case["kc"].shape[0] // dp)
        sc = case["kc"].shape[1] // tp
        cols = slice((rank % tp) * sc, (rank % tp + 1) * sc)
        for k in ("k", "v", "kpos"):
            assert got[k + "_sharded"]
            np.testing.assert_array_equal(got[k], want[k][rows, cols])
        b = got["o"].shape[0] if rows == slice(None) else \
            case["kc"].shape[0] // dp
        h, d = case["q"].shape[1:]
        assert got["bytes_model"] == b * h * (4 + 4 + 4 * d) + \
            b * (h // tp) * d * 4


def test_flash_decode_write_lands_on_one_shard(jax_side, port_side):
    """pos 10 on the (2,2) ring of 16: the second model shard owns slot
    10. JAX's cache holds the new K there and nowhere else; on the
    port's ranks of that shard it lands at local slot 2 and nowhere
    else, and the first shard's blocks are as they came in."""
    name = "2x2_w0_cap0"
    case = jax_side["cases"][name]
    want = jax_side["results"][name]
    assert int(case["pos"]) == 10 and case["kc"].shape[1] == 16
    np.testing.assert_array_equal(want["k"][:, 10], case["kn"])
    np.testing.assert_array_equal(np.delete(want["k"], 10, axis=1),
                                  np.delete(case["kc"], 10, axis=1))
    b = case["kc"].shape[0] // 2
    for rank, res in enumerate(port_side):
        got = res[name]["k"]
        rows = slice((rank // 2) * b, (rank // 2 + 1) * b)
        block = case["kc"][rows, (rank % 2) * 8:(rank % 2 + 1) * 8]
        if rank % 2 == 0:
            np.testing.assert_array_equal(got, block)
        else:
            np.testing.assert_array_equal(got[:, 2], case["kn"][rows])
            np.testing.assert_array_equal(np.delete(got, 2, axis=1),
                                          np.delete(block, 2, axis=1))


def test_compressed_reduction(jax_side, port_side):
    """JAX's limits (0.02 after one round, 0.005 over 8 with error
    feedback) and JAX's output within one quantisation step a block."""
    case = jax_side["cases"]["compression"]
    want = jax_side["results"]["compression"]
    ref = case["x"].mean(0)
    from repro_torch.distributed.compression import BLOCK
    for res in port_side:
        got = res["compression"]
        rel = np.abs(got["y"] - ref).max() / np.abs(ref).max()
        assert rel < 0.02, rel
        rel8 = np.abs(got["acc"] / case["rounds"] - ref).max() / \
            np.abs(ref).max()
        assert rel8 < 0.005, rel8
        step = np.abs(want["y"]).reshape(-1, BLOCK).max(-1) / 127.0
        gap = np.abs(got["y"] - want["y"]).reshape(-1, BLOCK).max(-1)
        assert (gap <= step * (1 + 1e-6)).all()


def test_pipeline_matches_jax(jax_side, port_side):
    case = jax_side["cases"]["pipeline"]
    want = jax_side["results"]["pipeline"]["out"]
    seq = case["x"]
    for s in range(case["ws"].shape[0]):
        seq = np.tanh(seq @ case["ws"][s])
    for res in port_side:
        got = res["pipeline"]["out"]
        assert np.abs(got - want).max() < 1e-5
        assert np.abs(got - seq).max() < 1e-5


GRAD_CASES = [f"1x2_{n}" for n in torch_worlds.GRAD_NAMES] + \
    [f"2x2_{n}" for n in torch_worlds.GRAD_NAMES + torch_worlds.GRAD_NAMES_DM]


@pytest.mark.parametrize("name", GRAD_CASES)
def test_collective_grads_match_jax(name, jax_side, port_side, port_slice):
    """Each collective carries JAX's gradient: the port's autograd of
    sum(w * y) through ``compat.shard_map`` against ``jax.grad`` through
    JAX's shard_map (``check_vma=False``) on the same inputs, within
    1e-5, every rank the whole gradient; ``pmax`` refuses a backward on
    both sides (JAX defines no rule for it). The backward's collectives
    are counted."""
    want = jax_side["grads"][name]
    ranks = port_slice if name.startswith("1x2") else port_side
    for res in ranks:
        got = res["grads"][name]
        assert np.abs(got["y"] - want["y"]).max() < 1e-5
        if "error" in want:
            assert "pmax" in want["error"] and "pmax" in got["error"]
            continue
        assert "error" not in got, got.get("error")
        assert np.abs(got["grad"] - want["grad"]).max() < 1e-5, name
        assert got["backward_calls"] > 0


@pytest.mark.parametrize("mesh_name", ["1x2", "2x2"])
def test_moe_train_grads_match_jax(mesh_name, jax_side, port_side,
                                   port_slice):
    """grok-1's smoke config through its training plan (make_moe_etp at
    (1, 2), make_moe_etp2d at (2, 2)): the loss and every parameter's
    gradient within 1e-5 of JAX's in float32, on every rank; the expert
    stacks' gradients are each rank's block (gathered here)."""
    want = jax_side["moe_train"][mesh_name]
    ranks = port_slice if mesh_name == "1x2" else port_side
    for res in ranks:
        got = res["moe_train"]
        assert got["hook"] == want["hook"]
        assert abs(got["loss"] - want["loss"]) < 1e-5
        assert set(got["grads"]) == set(want["grads"])
        for k, g in want["grads"].items():
            assert got["grads"][k].shape == g.shape, k
            assert np.abs(got["grads"][k] - g).max() < 1e-5, k
        assert got["sharded"], "no expert stack was a DTensor"
        assert got["backward_collectives"] > 0


@pytest.mark.parametrize("mesh_name", RUNTIME_MESHES)
def test_check_trainable_accepts_the_moe_hook(mesh_name):
    """A MoE arch's training plan trains through its ``moe_fn`` hook on
    every mesh: the hook's collectives carry a gradient."""
    cfg = registry.get_smoke_config("grok-1-314b")
    rt = shd.Plan(tmesh.Mesh(RUNTIME_MESHES[mesh_name], ("data", "model")),
                  cfg, ShapeConfig("s", 64, 4, "train"),
                  ParallelConfig()).runtime()
    assert rt.moe_fn is not None
    T.check_trainable(cfg, rt)


@pytest.mark.parametrize("step", range(4), ids=["prefill", "decode1",
                                                "decode2", "decode3"])
def test_slice_matches_jax(step, jax_side, port_slice):
    """grok-1's smoke config on (1, 2): the prefill plan (etp, tokens
    sequence-sharded), then the decode plan (flash-decoding and the
    replicated expert_2d MoE) from JAX's float32 parameters built at
    tp=2; logits within 1e-5 of JAX's same calls, every rank the same."""
    want = jax_side["slice"]["logits"][step]
    for res in port_slice:
        assert np.abs(res["logits"][step] - want).max() < 1e-5


def test_slice_ranks_hold_blocks(jax_side, port_slice):
    """Each rank holds half the ring, its slot's experts, and its half of
    the dense blocks: the q heads of ``wq`` and ``wo``, the vocabulary
    rows of ``in_embed`` and columns of ``out_embed`` (grok-1's FFN is
    its experts: it has no ``w1``)."""
    ring = jax_side["slice"]["ring"]
    cfg = registry.get_smoke_config("grok-1-314b")
    dh, v = cfg.resolved_head_dim, cfg.padded_vocab
    for rank, res in enumerate(port_slice):
        assert res["k_global"][2] == ring and res["k_local"][2] == ring // 2
        assert res["wi_local"] == (cfg.n_layers, 1, cfg.moe.n_experts // 2,
                                   cfg.d_model, cfg.expert_d_ff)
        assert res["dense_local"] == {
            "wq": (cfg.n_layers, cfg.d_model, cfg.n_heads // 2, dh),
            "wo": (cfg.n_layers, cfg.n_heads // 2, dh, cfg.d_model),
            "in_embed": (v // 2, cfg.d_model),
            "out_embed": (cfg.d_model, v // 2)}
        half = slice(rank * ring // 2, (rank + 1) * ring // 2)
        np.testing.assert_array_equal(res["kpos"],
                                      jax_side["slice"]["kpos"][:, :, half])


# ---------------------------------------------------------------------------
# Specs and runtimes against JAX's, on stand-in meshes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_specs(arch: str):
    cfg = jregistry.get_config(arch)
    rt = jT.ModelRuntime(max_seq=64)
    shapes, specs = jT.abstract_params(cfg, rt)
    holder = {}

    def go():
        c, s = jT.init_cache(cfg, rt, 4, enc_len=8 if cfg.enc_dec else 0)
        holder["s"] = s
        return c

    cshapes = jax.eval_shape(go)
    return cfg, shapes, specs, cshapes, holder["s"]


def _norm(ps, ndim):
    entries = list(ps) + [None] * (ndim - len(ps))
    return tuple(compat.entry_axes(e) for e in entries)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("mesh_name", SPEC_MESHES)
@pytest.mark.parametrize("arch", jregistry.ARCH_IDS)
def test_tree_shardings_match_jax(arch, mesh_name):
    """spec_to_pspec / tree_shardings (zero1 off and on) give each leaf of
    ``param_specs`` and ``cache_specs`` the mesh axes JAX's
    PartitionSpec gives it, dim by dim."""
    shape, axes = SPEC_MESHES[mesh_name]
    jcfg, jshapes, jspecs, jcshapes, jcspecs = _jax_specs(arch)
    cfg = registry.get_config(arch)
    rt = T.ModelRuntime(max_seq=64)
    mshapes, mspecs = T.abstract_params(cfg, rt)
    enc = 8 if cfg.enc_dec else 0
    mcshapes = T.init_cache(cfg, rt, 4, enc_len=enc, device="meta")
    mcspecs = T.cache_specs(cfg, rt, 4, enc)
    jmesh = AbstractMesh(shape, axes)
    mine = tmesh.Mesh(shape, axes)
    for (js, jsp, ms, msp) in ((jshapes, jspecs, mshapes, mspecs),
                               (jcshapes, jcspecs, mcshapes, mcspecs)):
        assert _leaves(msp) == {k: tuple(v) for k, v in
                                _leaves(jax.tree.map(
                                    tuple, jsp, is_leaf=jshd._is_spec))
                                .items()}
        for zero1 in (False, True):
            want = _leaves(jshd.tree_shardings(js, jsp, jmesh,
                                               zero1=zero1))
            got = _leaves(shd.tree_shardings(ms, msp, mine, zero1=zero1))
            shapes_ = _leaves(ms)
            assert set(got) == set(want)
            for k in got:
                nd = len(shapes_[k].shape)
                assert tuple(shapes_[k].shape) == \
                    tuple(_leaves(js)[k].shape), k
                assert _norm(got[k].spec, nd) == _norm(want[k].spec, nd), \
                    (k, zero1, got[k].spec, want[k].spec)


def _hook(fn):
    return None if fn is None else fn.__qualname__


@pytest.mark.parametrize("mesh_name", RUNTIME_MESHES)
@pytest.mark.parametrize("arch", ["gemma2-9b", "grok-1-314b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_plan_runtime_hooks_match_jax(kind, arch, mesh_name):
    shape = RUNTIME_MESHES[mesh_name]
    axes = ("data", "model")
    jp = jshd.Plan(AbstractMesh(shape, axes), jregistry.get_config(arch),
                   JShape("s", 64, 4, kind), JParallel())
    mp = shd.Plan(tmesh.Mesh(shape, axes), registry.get_config(arch),
                  ShapeConfig("s", 64, 4, kind), ParallelConfig())
    want, got = jp.runtime(), mp.runtime()
    assert (got.tp, got.moe_dp, got.max_seq, got.remat) == \
        (want.tp, want.moe_dp, want.max_seq, want.remat)
    assert _hook(got.moe_fn) == _hook(want.moe_fn)
    assert _hook(got.decode_attn_fn) == _hook(want.decode_attn_fn)
    for name in ("resid_spec", "tokens_spec", "logits_spec"):
        mine, ref = getattr(mp, name)(), getattr(jp, name)()
        assert _norm(mine, 3) == _norm(ref, 3), name


def test_plan_runtime_etp2d_on_a_data_axis():
    """A MoE arch's training cell on (2, 2) takes etp2d with moe_dp 2,
    and its experts are built in the 2D layout, as JAX's."""
    shape, axes = (2, 2), ("data", "model")
    cfg = registry.get_config("grok-1-314b")
    mp = shd.Plan(tmesh.Mesh(shape, axes), cfg,
                  ShapeConfig("s", 64, 4, "train"), ParallelConfig())
    rt = mp.runtime()
    assert rt.moe_dp == 2 and "etp2d" in _hook(rt.moe_fn)
    small = registry.get_smoke_config("grok-1-314b")
    shapes, specs = T.abstract_params(small, rt)
    wi = shapes["group0"]["p0"]["mlp"]["wi"]
    jcfg = jregistry.get_smoke_config("grok-1-314b")
    jrt = jT.ModelRuntime(tp=2, moe_dp=2)
    jshapes, jspecs = jT.abstract_params(jcfg, jrt)
    assert tuple(wi.shape) == jshapes["group0"]["p0"]["mlp"]["wi"].shape
    assert specs["group0"]["p0"]["mlp"]["wi"] == \
        tuple(jspecs["group0"]["p0"]["mlp"]["wi"])


# ---------------------------------------------------------------------------
# Meshes and CLIs need no process group on one device
# ---------------------------------------------------------------------------

def test_one_device_mesh_needs_no_process_group():
    import torch.distributed as dist
    m = tmesh.make_mesh((1, 1), ("data", "model"))
    assert m.device_mesh is None and m.coordinate() == {"data": 0,
                                                        "model": 0}
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="world of 4"):
        tmesh.make_mesh((1, 4), ("data", "model"), "cpu")
    assert tmesh.backend_for(2, "cpu") == "gloo"


def test_train_cli_trains_a_moe_arch_through_etp(capsys):
    """``launch.train --smoke --arch grok-1-314b`` builds its runtime
    through the plan of a 1 x 1 mesh (``make_moe_etp`` at tp 1, as JAX's
    CLI) and its loss goes down; no process group is started."""
    import torch.distributed as dist
    from repro_torch.distributed import moe_parallel
    from repro_torch.launch import train
    moe_parallel.reset_route_stats()
    state = train.main(["--device", "cpu", "--smoke", "--arch",
                        "grok-1-314b"])
    assert state.losses[-1] < state.losses[0]
    assert moe_parallel.route_stats["pairs"] > 0  # the etp route ran
    assert not dist.is_initialized()
    assert "arch=grok1-smoke steps=20" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# On the card: what the backends take from two ranks on one device
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_backends_on_one_card(tmp_path):
    """NCCL refuses a world of two ranks on one card; gloo runs the
    collectives in ``compat.GLOO_CUDA_OPS`` on CUDA tensors (bf16 and
    float32, values checked) and refuses the others (send/recv aborts
    the process), which ``compat`` therefore stages through the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = torch_worlds.run_cuda_probe(tmp_path)
    print(res)
    assert res["nccl_refused"], res
    for op, ok in res["gloo_cuda"].items():
        assert ok == (op in compat.GLOO_CUDA_OPS), (op, res)
    x = [float(i + 8 * j) for j in (0, 1) for i in range(8)]
    for r, got in enumerate(res["compat"]):
        assert got["psum"] == [a + b for a, b in zip(x[:8], x[8:])]
        assert got["all_to_all"] == x[4 * r:4 * r + 4] + \
            x[8 + 4 * r:8 + 4 * r + 4]
        assert got["ppermute"] == x[8 * (1 - r):8 * (1 - r) + 8]
        assert got["stats"]["ppermute"]["model"]["staged_bytes"] > 0
        assert got["stats"]["all_to_all"]["model"]["staged_bytes"] == 0
