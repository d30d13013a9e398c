"""Port parity: the elastic restart (``repro_torch.launch.elastic``) against
JAX's ``repro.launch.elastic`` on the CPU.

JAX's CLI runs as it is, with ``--root`` under the test's directory; its
parameters are cast to float32 as they are made and its step records each
loss. The port's ``run`` starts from those parameters (through
``repro_torch.bridge``) on the same node counts and data seed. Both
phases' losses agree within ``tests/test_torch_train.py``'s float32
tolerance; each package restores the other's ``phase1`` checkpoint bit
for bit equal to that package's own restore; the CLI passes its own
check on the CPU and refuses to start without a card unless asked for the
CPU. Two live clusters over one set of pools (the elastic flow's first
two) mean two flight recorders over each node's ring, each appending from
its own in-memory tail: both packages replay such a ring alike.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cluster import SimCluster as JSimCluster
from repro.core.pmem import PMemPool as JPMemPool
from repro.launch import elastic as jelastic
from repro.models import transformer as jT
from repro.obs import report as jreport
from repro.obs.recorder import FlightRecorder as JFlightRecorder
from repro_torch import bridge
from repro_torch.configs import ShapeConfig, registry
from repro_torch.core.cluster import SimCluster
from repro_torch.core.pmem import PMemPool
from repro_torch.launch import elastic
from repro_torch.models import transformer as tfm
from repro_torch.obs import report
from repro_torch.obs.recorder import EVT_POINT, FlightRecorder

jax.config.update("jax_platform_name", "cpu")

STEPS = 3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's elastic CLI (float32 parameters, each loss recorded) and the
    port's ``run`` from the same parameters, each over its own root."""
    root = tmp_path_factory.mktemp("elastic")
    made, losses = {}, []
    init, build = jT.init_params, jelastic._build

    def init32(*a, **k):
        params, specs = init(*a, **k)
        made["params"] = jax.tree.map(lambda x: x.astype(jnp.float32),
                                      params)
        return made["params"], specs

    def recording_build(cfg, shape, lr):
        rt, adamw, step_fn = build(cfg, shape, lr)

        def step(p, o, batch):
            p, o, m = step_fn(p, o, batch)
            losses.append(float(m["loss"]))
            return p, o, m
        return rt, adamw, step

    mp = pytest.MonkeyPatch()
    mp.setattr(jT, "init_params", init32)
    mp.setattr(jelastic, "_build", recording_build)
    try:
        jelastic.main(["--steps", str(STEPS), "--root", str(root / "jax")])
    finally:
        mp.undo()
    params = bridge.params_from_host(
        jax.tree.map(np.asarray, made["params"]), "cpu")
    out = elastic.run(registry.get_smoke_config("gemma2-9b"),
                      ShapeConfig("cli", 32, 4, "train"), params, "cpu",
                      root=root / "port", steps=STEPS)
    return dict(root=root, jax_losses=losses, port=out)


def test_elastic_losses_match_jax(runs):
    """Phase 1 (4 nodes) and the resumed phase 2 (2 nodes): each step's
    loss within 1e-4 relative of JAX's (float32; ``test_torch_train.py``'s
    loop tolerance), and the resumed first loss below the first."""
    out = runs["port"]
    assert len(out["losses"]) == len(out["losses2"]) == STEPS
    np.testing.assert_allclose(out["losses"] + out["losses2"],
                               runs["jax_losses"], rtol=1e-4)
    assert out["losses2"][0] < out["losses"][0]
    assert out["saved"]["step"] == STEPS and \
        out["saved"]["nodes"] == [f"node{i}" for i in range(4)]
    assert out["resumed"]["step"] == 2 * STEPS and \
        out["resumed"]["nodes"] == ["node0", "node1"]
    assert sorted(out["resumed"]["leaves"]) == \
        sorted(p for p in out["saved"]["leaves"] if p.startswith("params"))


def _jax_restore(root):
    c = JSimCluster(root, n_nodes=4)
    try:
        tree, _ = c.checkpointer.restore(STEPS)
    finally:
        c.shutdown()
    return dict(bridge.tree_leaves(jax.tree.map(np.asarray, tree)))


def _port_restore(root):
    c = SimCluster(root, n_nodes=4, device="cpu")
    try:
        tree, _ = c.checkpointer.restore(STEPS)
    finally:
        c.shutdown()
    return dict(bridge.tree_leaves(tree))


def _bits(leaf):
    a = leaf.numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
    return a.dtype.str, a.shape, a.tobytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_phase1_checkpoint_restores_across_packages(runs, writer):
    """The ``phase1`` pools one package wrote: the port's restore and
    JAX's restore give the same leaves, bit for bit (parameters and
    AdamW state at step ``STEPS``)."""
    root = runs["root"] / writer / "phase1"
    port, ref = _port_restore(root), _jax_restore(root)
    assert sorted(port) == sorted(ref)
    assert any(p.startswith("opt") for p in port)
    for path in ref:
        assert _bits(port[path]) == _bits(ref[path]), path


def _raw(leaf):
    """Shape and bytes of a tensor of any dtype (bf16 included)."""
    t = leaf.detach().contiguous()
    return tuple(t.shape), t.reshape(-1).view(torch.uint8).numpy().tobytes()


def test_int8_moments_round_trip(tmp_path):
    """``run`` with int8 AdamW moments (the card's elastic phase): the
    state saved at step ``STEPS`` holds the moments' int8 codes, the
    second cluster's restore and a third's equal it bit for bit, and the
    resumed first loss is below the first (``run`` raises otherwise)."""
    cfg, shape = registry.get_smoke_config("gemma2-9b"), \
        ShapeConfig("cli", 32, 4, "train")
    params = tfm.init_params(cfg, elastic._runtime(cfg, shape),
                             torch.Generator().manual_seed(0), device="cpu")
    seen, dtypes = {}, {}

    def check(kind, tree):
        seen[kind] = {p: _raw(t) for p, t in bridge.tree_leaves(tree)}
        dtypes.update({p: t.dtype for p, t in bridge.tree_leaves(tree)})

    out = elastic.run(cfg, shape, params, "cpu", root=tmp_path,
                      steps=STEPS, moments_dtype="int8", check=check)
    saved = seen["saved"]
    assert seen["restored"] == saved
    assert any(p.startswith("opt") and d == torch.int8
               for p, d in dtypes.items())
    port = _port_restore(tmp_path / "phase1")
    assert {p: _raw(a) for p, a in port.items()} == saved
    assert out["losses2"][0] < out["losses"][0]


def test_cli_runs_on_the_cpu(tmp_path, capsys):
    out = elastic.main(["--device", "cpu", "--steps", "3",
                        "--root", str(tmp_path)])
    text = capsys.readouterr().out
    assert "phase1 (4 nodes)" in text and "phase2 (2 nodes): resumed" in text
    assert out["losses2"][0] < out["losses"][0]
    assert (tmp_path / "phase1" / "pmem" / "node3").is_dir()
    assert (tmp_path / "phase2" / "pmem" / "node1").is_dir()
    assert not (tmp_path / "phase2" / "pmem" / "node2").exists()


def test_cli_refuses_to_start_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        elastic.main(["--root", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def _two_recorders(pool_cls, rec_cls, root):
    """The elastic flow's ring: a recorder, then a second one opened over
    the same pool while the first is live, then each appends."""
    first = rec_cls(pool_cls(root, "node0"))
    first.record(EVT_POINT, "a0")
    second = rec_cls(pool_cls(root, "node0"))
    second.record(EVT_POINT, "b0")
    second.record(EVT_POINT, "b1")
    first.record(EVT_POINT, "a1")
    return [(e["seq"], e["name"]) for e in
            rec_cls.replay(pool_cls(root, "node0"))]


def test_two_live_recorders_over_one_ring_replay_alike(tmp_path):
    """The older recorder's append lands on the slot after its own tail
    and commits that tail, over the newer recorder's events: ``b1`` is
    lost and ``b0``'s slot holds ``a1``. JAX's ring does the same (a
    reference behaviour the port copies)."""
    port = _two_recorders(PMemPool, FlightRecorder, tmp_path / "port")
    ref = _two_recorders(JPMemPool, JFlightRecorder, tmp_path / "jax")
    assert port == ref == [(0, "a0"), (1, "a1")]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_elastic_phase1_rings_replay_alike(runs, writer):
    """Neither package's elastic flow records a ring event (its saves go
    through the checkpointer, not ``save_async``, and carry no trace):
    both report CLIs replay the phase-1 rings of either package empty,
    and read the same shutdown snapshot."""
    root = runs["root"] / writer / "phase1" / "pmem"
    events, snap = report.load_events(root)
    jevents, jsnap = jreport.load_events(root)
    assert events == jevents == []
    assert snap is not None and snap == jsnap
