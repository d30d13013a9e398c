"""Port parity: delta-int8 node-local checkpoints against the JAX package.

Full and delta round trips on a 4-node port ``SimCluster`` (CPU tensors,
so the codec runs its plain version), slot rotation that never lands on
the delta base, asynchronous saves through ``TieredIO``, and across
packages: a checkpoint the port writes (full or delta) restores bit for
bit in JAX's ``DistributedCheckpointer(delta=True)`` on the same pools,
with the ack log JAX's restore reads, and the reverse.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.checkpoint import DistributedCheckpointer as JCheckpointer
from repro.core.object_store import PMemObjectStore as JStore
from repro.core.pmem import PMemPool as JPool
from repro.kernels.ckpt_codec.ref import decode_ref as j_decode_ref
from repro_torch import bridge
from repro_torch.core.checkpoint import DistributedCheckpointer, plan_shards
from repro_torch.core.cluster import SimCluster
from repro_torch.kernels.ckpt_codec.ref import TILE

NODES = 4


def _state(seed: int, like=None):
    """A training-state-shaped tree of numpy leaves: bf16 parameters (one
    split across the 4 nodes, one ragged leaf on a single owner), float32
    moments, the int32 step. ``like`` gives a nearby state (a step
    later)."""
    rng = np.random.default_rng(seed)

    def f32(shape, base=None):
        x = rng.standard_normal(shape).astype(np.float32)
        return x if base is None else \
            (np.asarray(base, np.float32) + 0.01 * x).astype(np.float32)

    shapes = {"emb": (64, 40), "w": (8, 300), "norm": (7,)}
    p = (like or {}).get("params", {})
    m = (like or {}).get("opt", {}).get("moments", {})
    params = {k: f32(s, p.get(k)).astype(ml_dtypes.bfloat16)
              for k, s in shapes.items()}
    moments = {k: {"m": f32(s, m.get(k, {}).get("m")),
                   "v": np.abs(f32(s, m.get(k, {}).get("v")))}
               for k, s in shapes.items()}
    step = np.int32(2 if like is None else int(like["opt"]["step"]) + 2)
    return {"params": params, "opt": {"moments": moments, "step": step}}


def _torch(tree):
    return bridge.tree_map(lambda a: bridge.to_torch(a), tree)


def _bits_equal(a, b) -> bool:
    a, b = bridge.to_numpy(a), bridge.to_numpy(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


def _assert_tree_bits(got, want):
    gl, wl = bridge.tree_leaves(got), bridge.tree_leaves(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        assert _bits_equal(g, w), path


def _jax_checkpointer(root) -> JCheckpointer:
    """JAX's checkpointer over the pools a port SimCluster made at
    ``root``."""
    stores = {f"node{i}": JStore(JPool(root / "pmem", f"node{i}"))
              for i in range(NODES)}
    return JCheckpointer(stores, delta=True)


def _assert_within_codec_bound(restored, new, stores, step_slot):
    """Every element of a delta restore within its tile's scale / 2 plus
    half an ulp of the leaf dtype of the state it encoded."""
    for path, t in bridge.tree_leaves(restored):
        want = bridge.to_torch(_get(new, path)).double().numpy()
        got = t.double().numpy()
        if t.dtype == torch.int32:
            np.testing.assert_array_equal(got, want, err_msg=path)
            continue
        ulp = 2.0 ** -8 if t.dtype == torch.bfloat16 else 2.0 ** -24
        # the largest scale of the leaf's tiles bounds every element
        scale = max(float(np.asarray(s.get_leaf(step_slot, path + ".__ds"))
                          .max()) for s in stores.values()
                    if path + ".__ds" in s.manifest(step_slot)["leaves"])
        bound = scale / 2 + ulp * np.maximum(np.abs(got), np.abs(want)) \
            + 1e-7
        assert np.all(np.abs(got - want) <= bound), path


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def test_plan_shards_matches_jax():
    from repro.core.checkpoint import plan_shards as j_plan
    nodes = [f"node{i}" for i in range(NODES)]
    for path, shape in (("a", (64, 3)), ("b/c", (7,)), ("d", ()),
                        ("e", (2, 5)), ("f", (8,))):
        assert [tuple(vars(s).values()) for s in plan_shards(path, shape,
                                                             nodes)] == \
            [tuple(vars(s).values()) for s in j_plan(path, shape, nodes)]


def test_full_and_delta_round_trip_with_slot_avoidance(tmp_path):
    c = SimCluster(tmp_path, n_nodes=NODES, delta=True, slots=3,
                   device="cpu")
    ck = c.checkpointer
    try:
        s2 = _state(0)
        s4 = _state(1, like=s2)
        s6 = _state(2, like=s4)
        m2 = ck.save(2, _torch(s2))
        m4 = ck.save(4, _torch(s4), base_step=2)
        m6 = ck.save(6, _torch(s6), base_step=2)
        assert m2["delta_base"] is None and m4["delta_base"] == 2
        # slots rotate past the base: 0, 1, then 2 (never 0 while it
        # holds the base)
        assert (m2["slot"], m4["slot"], m6["slot"]) == (0, 1, 2)
        # the delta objects carry codes and scales under JAX's names
        names = set()
        for s in c.stores.values():
            names |= set(s.manifest(f"ckpt/slot{m4['slot']}")["leaves"])
        assert "params/emb.__dq" in names and "params/emb.__ds" in names
        assert "opt/step.__dq" in names
        got2, man = ck.restore(2)
        assert man["step"] == 2
        _assert_tree_bits(got2, s2)
        got4, _ = ck.restore(4)
        _assert_within_codec_bound(got4, s4, c.stores,
                                   f"ckpt/slot{m4['slot']}")
        assert int(got4["opt"]["step"]) == 4
        # the next delta skips slot 0 (the base) again
        m8 = ck.save(8, _torch(_state(3, like=s6)), base_step=2)
        assert m8["slot"] == 1
        assert ck.available_steps() == [2, 4, 6, 8]
        assert ck.latest_step() == 8
        # a restore of a reused slot fails instead of mixing steps
        with pytest.raises(IOError, match="slot reused"):
            ck.restore(4)
        ck.save(10, _torch(_state(4, like=s6)))
        m12 = ck.save(12, _torch(_state(5, like=s6)))
        assert m12["slot"] == 0
        with pytest.raises(IOError, match="slot reused"):
            ck.restore(2)
    finally:
        c.shutdown()


def test_async_save_restores_the_saved_state(tmp_path):
    """A save through TieredIO, then the state moves on (new tensors, as
    the functional optimizer makes them): restore returns the state at
    the save's step. The ticket's device phase completes before its
    commit, backpressure retires the oldest ticket, and once joined the
    delta's buddy replicas (and its base's) are acked: REPLICATED."""
    c = SimCluster(tmp_path, n_nodes=NODES, delta=True, device="cpu")
    try:
        s2 = _torch(_state(0))
        t2 = c.tiered.save_async(2, s2)
        s3 = bridge.tree_map(lambda t: t + 1, s2)
        t3 = c.tiered.save_async(3, s3, base_step=2)
        t3.device_done.result(timeout=60)
        assert t2.device_done.done()
        c.tiered.join()
        assert t2.result()["step"] == 2 and \
            t3.durability() == "REPLICATED"
        got, _ = c.checkpointer.restore(2)
        _assert_tree_bits(got, s2)
        # a failing save surfaces at the next checkpoint boundary
        bad = c.tiered.save_async(5, s3, base_step=99)
        with pytest.raises(FileNotFoundError):
            bad.result(timeout=60)
        with pytest.raises(FileNotFoundError):
            c.tiered.raise_if_failed()
        c.tiered.raise_if_failed()  # raised once, then popped
    finally:
        c.shutdown()


def test_port_checkpoints_restore_bit_for_bit_in_jax(tmp_path):
    """Full (step 2) and delta (step 4) written by the port, read by
    JAX's checkpointer on the same pools: every leaf's bits, the delta
    decoded by JAX's numpy oracle, and the ack log's seed records."""
    c = SimCluster(tmp_path, n_nodes=NODES, delta=True, device="cpu")
    try:
        s2 = _state(0)
        c.checkpointer.save(2, _torch(s2))
        c.checkpointer.save(4, _torch(_state(1, like=s2)), base_step=2)
        mine2, _ = c.checkpointer.restore(2)
        mine4, _ = c.checkpointer.restore(4)
    finally:
        c.shutdown()
    jck = _jax_checkpointer(tmp_path)
    assert jck.latest_step() == 4 and jck.available_steps() == [2, 4]
    for step, mine in ((2, mine2), (4, mine4)):
        theirs, man = jck.restore(step)
        _assert_tree_bits(mine, theirs)
        rec = jck.ack_record(step)
        assert rec["ring"] == [f"node{i}" for i in range(NODES)]
        assert rec["delta_base"] == (None if step == 2 else 2)
    _assert_tree_bits(mine2, s2)


def test_jax_checkpoints_restore_bit_for_bit_in_the_port(tmp_path):
    """The reverse: JAX writes full and delta from numpy trees (bf16 as
    ml_dtypes), the port restores the same bits; an ack JAX records is
    read by the port's log replay."""
    c = SimCluster(tmp_path, n_nodes=NODES, delta=True, device="cpu")
    c.shutdown()  # only its pools: JAX writes into them
    jck = _jax_checkpointer(tmp_path)
    s2 = _state(5)
    jck.save(2, s2)
    jck.save(4, _state(6, like=s2), base_step=2)
    jck.record_ack(4, "node1", "replica", {"targets": ["node2"]})
    theirs2, _ = jck.restore(2)
    theirs4, _ = jck.restore(4)
    c = SimCluster(tmp_path, n_nodes=NODES, delta=True, device="cpu")
    try:
        mine2, man2 = c.checkpointer.restore(2)
        mine4, man4 = c.checkpointer.restore(4)
        _assert_tree_bits(mine2, theirs2)
        _assert_tree_bits(mine4, theirs4)
        _assert_tree_bits(mine2, s2)
        assert c.checkpointer.acks(4)["node1"]["replica"]["targets"] == \
            ["node2"]
        # the port's next save rotates on from JAX's last slot
        m6 = c.checkpointer.save(6, _torch(_state(7, like=s2)),
                                 base_step=2)
        assert m6["slot"] != man2["slot"]
    finally:
        c.shutdown()


def test_delta_decode_matches_the_numpy_oracle_on_stored_codes(tmp_path):
    """A delta leaf restored by the port equals JAX's decode_ref applied
    to the codes, scales and base the port stored."""
    c = SimCluster(tmp_path, n_nodes=NODES, delta=True, device="cpu")
    try:
        s2 = _state(8)
        c.checkpointer.save(2, _torch(s2))
        m4 = c.checkpointer.save(4, _torch(_state(9, like=s2)), base_step=2)
        got, _ = c.checkpointer.restore(4)
        nid, start, rows = m4["leaves"]["params/w"]["shards"][1]
        store = c.stores[nid]
        q = store.get_leaf(f"ckpt/slot{m4['slot']}", "params/w.__dq")
        s = store.get_leaf(f"ckpt/slot{m4['slot']}", "params/w.__ds")
        base = np.asarray(s2["params"]["w"], np.float32)[start:start + rows]
        flat = np.pad(base.reshape(-1), (0, (-base.size) % TILE))
        want = j_decode_ref(q, s, flat.reshape(-1, TILE),
                            dtype=ml_dtypes.bfloat16).reshape(-1)[:base.size]
        assert _bits_equal(got["params"]["w"][start:start + rows].reshape(-1),
                           want)
    finally:
        c.shutdown()


def test_unported_paths_raise(tmp_path):
    ck = DistributedCheckpointer({}, device="cpu")
    for call in (lambda: ck.restore_latest_recoverable(lost_nodes=["n"]),
                 lambda: ck.restore(2, lost_nodes=["node3"]),
                 lambda: ck.restore_leaves(2, ["a"]),
                 lambda: ck.restore_shard(2, "a", 0, 1),
                 lambda: ck._drained_leaves("n", 2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    c = SimCluster(tmp_path, n_nodes=2, device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            c.checkpointer.save(2, {"a": torch.zeros(2)}, drain=True)
    finally:
        c.shutdown()
    with pytest.raises(ValueError, match="slots >= 2"):
        DistributedCheckpointer({}, delta=True, slots=1, device="cpu")
