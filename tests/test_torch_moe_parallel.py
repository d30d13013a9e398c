"""The port's expert-parallel MoE routes against the JAX package's, on the
CPU, and MoE parameters carried across at tp > 1.

The JAX side runs once in a subprocess with four host devices and
pickles inputs and outputs; the port side runs every case in one gloo
world of four processes (``tests/torch_worlds.py``). Cases: the
sequence-sharded ETP route and the replicated decode route at (1,4)
(E=8; E=2 puts two FFN shards on a group: the ppermute ring), the 2D
routes at (2,2) (``make_moe_replicated(expert_2d=True)`` and
``make_moe_etp2d``), each at capacity factor 8.0 (nothing dropped) and
1.25 (drops), against JAX's same function within 1e-5 of the output's
scale (its largest |value|, at least 1: float32 products summed in
another order) and, where nothing drops, against JAX's dense
``apply_moe_gshard`` within JAX's 1e-4 on the same scale.
"""
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

import torch_worlds
from repro.configs import registry as jregistry
from repro.models import moe as jmoe
from repro.models import transformer as jT
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.models import moe

REPO = Path(__file__).resolve().parents[1]
# (route, mesh name, experts, top_k); each at capacity factor 8.0 and 1.25
ROUTES = [(fn, m, e, k) for fn, m in (("etp", "1x4"), ("replicated", "1x4"),
                                      ("replicated_2d", "2x2"),
                                      ("etp2d", "2x2"))
          for e, k in ((8, 2), (2, 2), (2, 1))]
CASES = [f"{fn}_{m}_e{e}k{k}_cf{cf}" for fn, m, e, k in ROUTES
         for cf in (8.0, 1.25)]

JAX_SIDE = r'''
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs.base import (ModelConfig, MoEConfig, LayerSpec,
                                ATTN_GLOBAL, MLP_MOE)
from repro.models.moe import init_moe, make_moe_layout, apply_moe_gshard
from repro.models.layers import ParamBuilder
from repro.distributed import moe_parallel as mp

ROUTES = %(routes)r
meshes = {"1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
rng = np.random.default_rng(0)
out = {"cases": {}, "results": {}}
for fn, mname, e, k in ROUTES:
    shape, axes = meshes[mname]
    m = Mesh(np.array(jax.devices()[:4]).reshape(shape), axes)
    tp, dp = shape[1], shape[0]
    for cf in (8.0, 1.25):
        cfg = ModelConfig(name="m", family="moe", n_layers=1, d_model=32,
                          n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128,
                          pattern=(LayerSpec(mixer=ATTN_GLOBAL, mlp=MLP_MOE),),
                          moe=MoEConfig(n_experts=e, top_k=k,
                                        capacity_factor=cf))
        pb = ParamBuilder(jax.random.PRNGKey(len(out["cases"])))
        init_moe(pb, cfg, make_moe_layout(cfg, tp,
                                          dp if fn == "etp2d" else 1))
        params = {n: v.astype(jnp.float32) for n, v in pb.params.items()}
        seq = 64 if fn.startswith("etp") else 16
        # a direction shared by every token skews the routing, so that
        # capacity 1.25 drops pairs
        x = (0.5 * (rng.standard_normal((4, seq, 32)) +
                    2.0 * rng.standard_normal(32))).astype(np.float32)
        route = {"etp": mp.make_moe_etp, "etp2d": mp.make_moe_etp2d,
                 "replicated": mp.make_moe_replicated,
                 "replicated_2d": lambda mm: mp.make_moe_replicated(
                     mm, expert_2d=True)}[fn](m)
        y, aux = jax.jit(lambda p, xx: route(p, xx, cfg))(params,
                                                          jnp.asarray(x))
        yg, auxg = apply_moe_gshard(params, jnp.asarray(x), cfg)
        name = f"{fn}_{mname}_e{e}k{k}_cf{cf}"
        out["cases"][name] = {
            "fn": fn, "mesh": shape, "axes": axes, "e": e, "k": k, "cf": cf,
            "d": 32, "f": 64, "x": x,
            "params": {n: np.asarray(v) for n, v in params.items()}}
        out["results"][name] = {"y": np.asarray(y), "aux": np.asarray(aux),
                                "y_gshard": np.asarray(yg),
                                "aux_gshard": np.asarray(auxg)}
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
'''


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_moe") / "ref.pkl"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = str(REPO / "src")
    code = textwrap.dedent(JAX_SIDE) % {"routes": ROUTES}
    p = subprocess.run([sys.executable, "-c", code, str(path)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert p.returncode == 0, f"stdout:\n{p.stdout}\nstderr:\n{p.stderr}"
    return pickle.loads(path.read_bytes())


@pytest.fixture(scope="module")
def port_side(jax_side, tmp_path_factory):
    return torch_worlds.run_world(torch_worlds.moe_cases, 4,
                                  tmp_path_factory.mktemp("port_moe"),
                                  jax_side["cases"])


@pytest.mark.parametrize("name", CASES)
def test_route_matches_jax(name, jax_side, port_side):
    """Every rank's output within 1e-5 of JAX's same route (capacity,
    ranks within an expert and drops as JAX's), the aux loss too."""
    want = jax_side["results"][name]
    scale = max(1.0, float(np.abs(want["y"]).max()))
    for res in port_side:
        got = res[name]
        assert np.abs(got["y"] - want["y"]).max() < 1e-5 * scale
        assert abs(float(got["aux"]) - float(want["aux"])) < 1e-5


@pytest.mark.parametrize("name", CASES)
def test_route_on_sharded_experts(name, port_side):
    """The route fed the expert stacks as this rank's blocks (``shard``
    of the logical specs: DTensors) gives the same output bit for bit
    as fed the whole stacks."""
    for res in port_side:
        assert res[name]["blocks"]
        np.testing.assert_array_equal(res[name]["y_blocks"], res[name]["y"])


@pytest.mark.parametrize("name", [c for c in CASES if c.endswith("cf8.0")])
def test_dropless_route_matches_gshard(name, jax_side, port_side):
    """At capacity factor 8.0 nothing is dropped, and every route equals
    the dense oracle within JAX's 1e-4."""
    want = jax_side["results"][name]
    scale = max(1.0, float(np.abs(want["y_gshard"]).max()))
    for res in port_side:
        got = res[name]
        assert got["dropped"] == 0 and got["pairs"] > 0
        assert np.abs(got["y"] - want["y_gshard"]).max() < 1e-4 * scale


def test_capacity_drops_are_exercised(jax_side, port_side):
    """At 1.25 every route drops pairs (but with 2 experts top-2, where
    each expert takes every token: never over capacity), and its output
    then differs from the dropless oracle, so the drop path is what the
    comparison with JAX held."""
    for name in CASES:
        if not name.endswith("cf1.25") or "e2k2" in name:
            continue
        dropped = sum(res[name]["dropped"] for res in port_side)
        assert dropped > 0, name
        want = jax_side["results"][name]
        assert np.abs(want["y"] - want["y_gshard"]).max() > 1e-4, name


# ---------------------------------------------------------------------------
# Parameters built at tp > 1, carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp,dp", [(2, 1), (4, 1), (8, 1), (16, 1), (2, 2)])
def test_logical_expert_weights_of_jax_layouts(tp, dp):
    """JAX trees built at ``rt.tp > 1`` (slot-major stacks, the 5-D 2D
    layout, padded heads) cross the bridge; the port's
    ``logical_expert_weights`` of each layer equals JAX's, and
    ``relayout_experts`` to one slot (and back to the JAX layout) keeps
    them."""
    cfg = registry.get_smoke_config("grok-1-314b")
    jcfg = jregistry.get_smoke_config("grok-1-314b")
    rt = jT.ModelRuntime(tp=tp, moe_dp=dp)
    jparams, _ = jT.init_params(jax.random.PRNGKey(tp * 10 + dp), jcfg, rt)
    host = jax.tree.map(np.asarray, jparams)
    params = bridge.params_from_host(host, "cpu")
    one = bridge.relayout_experts(params, cfg, tp=1)
    back = bridge.relayout_experts(one, cfg, tp=tp, dp=dp)
    jm = jparams["group0"]["p0"]["mlp"]
    assert params["group0"]["p0"]["mlp"]["wi"].shape == jm["wi"].shape
    assert one["group0"]["p0"]["mlp"]["wi"].shape[1] == 1
    for r in range(cfg.n_layers):
        want = jmoe.logical_expert_weights(
            jax.tree.map(lambda a: a[r], jm), jcfg)
        for tree in (params, one, back):
            mp = {k: v[r] for k, v in tree["group0"]["p0"]["mlp"].items()}
            got = moe.logical_expert_weights(mp, cfg)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(bridge.to_numpy(g),
                                              np.asarray(w).view(np.uint16))
    for k in ("wi", "wg", "wo"):
        np.testing.assert_array_equal(
            bridge.to_numpy(back["group0"]["p0"]["mlp"][k]),
            host["group0"]["p0"]["mlp"][k].view(np.uint16))


def test_relayout_to_one_slot_is_a_view():
    """tp=2 -> one slot (the card phase's single-device reference) is a
    reshape of the same storage: no copy of the expert stack."""
    cfg = registry.get_smoke_config("grok-1-314b")
    from repro_torch.models import transformer as T
    rt = T.ModelRuntime(tp=2)
    params = T.init_params(cfg, rt, torch.Generator().manual_seed(0), "cpu")
    one = bridge.relayout_experts(params, cfg, tp=1)
    for k in ("wi", "wg", "wo"):
        a, b = params["group0"]["p0"]["mlp"][k], one["group0"]["p0"]["mlp"][k]
        assert b.shape[1] == 1 and b.data_ptr() == a.data_ptr()
    assert one["in_embed"] is params["in_embed"]
