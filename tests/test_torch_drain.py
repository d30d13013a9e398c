"""Port parity: the drain boundary and the drained tier against the JAX
package.

``export_object``/``import_object``/``wire_leaves`` against JAX's on the
same pools (the same wire payload, byte for byte, with the codec off and
on; a corrupt payload rejected; no tensor in a payload), the scheduler's
``drain`` and ``stage_in`` of a wire payload, partial restores, and the
checkpoint channel's drains: durability up to ``"DRAINED"``, a failed
drain that leaves a step REPLICATED, the restore's fallback to a drained
copy consulted only through its ack, ranked on the acks alone. Each
scenario runs on a JAX and a port cluster and both must agree. Drains
written by either package are staged in and restored by the other. CPU
tensors throughout (the codec's plain versions); one card test drains
and rehydrates a delta step through the codec kernels.
"""
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.checkpoint import DistributedCheckpointer as JCheckpointer
from repro.core.cluster import SimCluster as JSimCluster
from repro.core.data_scheduler import ExternalStore as JExternal
from repro.core.object_store import PMemObjectStore as JStore
from repro.core.object_store import content_digest as j_content_digest
from repro.core.object_store import export_object as j_export_object
from repro.core.object_store import import_object as j_import_object
from repro.core.object_store import wire_tree as j_wire_tree
from repro.core.pmem import PMemPool as JPool
from repro_torch import bridge
from repro_torch.core.checkpoint import DistributedCheckpointer
from repro_torch.core.cluster import SimCluster
from repro_torch.core.data_scheduler import ExternalStore
from repro_torch.core.object_store import (PMemObjectStore, content_digest,
                                           copy_object, export_object,
                                           import_object, is_wire_object,
                                           wire_tree)
from repro_torch.core.pmem import PMemPool

NODES = [f"node{i}" for i in range(4)]


def _tree(seed=0, n=256):
    r = np.random.RandomState(seed)
    return {"layer": {"w": r.randn(n, 8).astype(np.float32),
                      "b": r.randn(8).astype(np.float32)},
            "ids": np.arange(n, dtype=np.int32)}


def _qtree(seed=0, n=2048):
    """Integer-grid float leaves: they travel delta8 through the strict
    wire codec instead of falling back to raw."""
    r = np.random.RandomState(seed)
    return {"layer": {"w": r.randint(-100, 100, (n, 8)).astype(np.float32),
                      "b": r.randn(8).astype(np.float32)},
            "ids": np.arange(n, dtype=np.int32)}


def _rtree(seed=0):
    r = np.random.RandomState(seed)
    return {"w": r.randn(16, 8).astype(np.float32),
            "b": r.randn(8).astype(np.float32)}


def _np(x):
    return bridge.to_numpy(x)


def _assert_tree_equal(got, want):
    gl, wl = bridge.tree_leaves(got), bridge.tree_leaves(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        assert _np(g).tobytes() == _np(w).tobytes(), path


def _stores(root, names=("a", "b", "c")):
    port = {n: PMemObjectStore(PMemPool(Path(root), n), device="cpu")
            for n in names}
    jax_ = {n: JStore(JPool(Path(root), n)) for n in names}
    return port, jax_


def _plain(obj) -> bool:
    """Only bytes, numbers, strings, None, lists and dicts: what a host
    without CUDA unpickles."""
    if isinstance(obj, dict):
        return all(_plain(k) and _plain(v) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return all(_plain(v) for v in obj)
    return obj is None or isinstance(obj, (bytes, str, int, float, bool))


def _both(tmp_path, scenario, **kw):
    """``scenario(cluster)`` on a JAX cluster and on a port cluster (CPU),
    each shut down after; returns (jax result, port result)."""
    out = []
    for name, make in (("jax", lambda r: JSimCluster(r, **kw)),
                       ("port", lambda r: SimCluster(r, device="cpu", **kw))):
        c = make(tmp_path / name)
        try:
            out.append(scenario(c))
        finally:
            c.shutdown()
    return out


# ---------------------------------------------------------------------------
# the wire payload
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", [None, True], ids=["raw", "strict"])
def test_export_import_roundtrip_codec_on_and_off(codec, tmp_path):
    """The counterpart of tests/test_zero_copy.py's test: the port's
    payload equals JAX's of the same object byte for byte (strict codec
    tables included) and holds no tensor; it decodes to the tree, lands
    through ``import_object`` with the source's leaf table, and JAX reads
    what the port imported; the port imports JAX's payload."""
    port, jx = _stores(tmp_path)
    tree = _qtree(11)
    port["a"].put("obj", tree, meta={"step": 4})
    wire = export_object(port["a"], "obj", expect_meta={"step": 4},
                         codec=codec)
    theirs = j_export_object(jx["a"], "obj", expect_meta={"step": 4},
                             codec=codec)
    assert wire == theirs and _plain(wire) and is_wire_object(wire)
    if codec:
        assert wire["leaves"]["layer/w"]["mode"] == "delta8"
    _assert_tree_equal(wire_tree(wire, device="cpu"), tree)
    _assert_tree_equal(j_wire_tree(wire), tree)
    man = import_object(port["b"], wire, "staged")
    assert man["leaves"] == port["a"].manifest("obj")["leaves"]
    _assert_tree_equal(jx["b"].get("staged", verify=True), tree)
    import_object(port["c"], theirs, "staged")
    _assert_tree_equal(port["c"].get("staged", verify=True), tree)


def test_content_digest_matches_jax_and_ignores_the_codec(tmp_path):
    """The manifest-only digest equals JAX's, and an encoded replica or a
    staged drain of the same object keeps it."""
    port, _ = _stores(tmp_path)
    port["a"].put("obj", _qtree(13))
    man = port["a"].manifest("obj")
    enc = copy_object(port["a"], port["b"], "obj", codec=True)
    assert "wire_codec" in enc["meta"]
    staged = import_object(port["c"], export_object(port["a"], "obj",
                                                    codec=True), "staged")
    assert content_digest(man) == j_content_digest(man) == \
        content_digest(enc) == content_digest(staged)


def test_import_rejects_corrupt_wire_bytes(tmp_path):
    """A torn external blob is a real failure: IOError, nothing committed
    (JAX's import rejects the same bytes)."""
    port, jx = _stores(tmp_path)
    port["a"].put("obj", _tree(12))
    wire = export_object(port["a"], "obj")
    path = next(iter(wire["leaves"]))
    blob = bytearray(wire["leaves"][path]["data"])
    blob[0] ^= 0xFF
    wire["leaves"][path]["data"] = bytes(blob)
    with pytest.raises(IOError):
        import_object(port["b"], wire, "staged")
    assert not port["b"].exists("staged")
    with pytest.raises(IOError):
        j_import_object(jx["c"], wire, "staged")


def test_codec_drain_rehydrates_bit_equal(tmp_path):
    """A drained shard staged back through the scheduler carries its step
    tag and its bytes equal the node's own slot; JAX reads the staged
    object bit for bit."""
    c = SimCluster(tmp_path, n_nodes=4, wire_codec=True, device="cpu")
    try:
        t = c.tiered.save_async(2, _qtree(14), drain=True)
        t.result(timeout=30)
        assert c.tiered.quiesce() == []
        c.scheduler.stage_in("node2", "ckpt_step2_node0",
                             "staged/shard0").result(timeout=30)
        assert c.stores["node2"].manifest("staged/shard0")["meta"]["step"] \
            == 2
        own = c.stores["node0"].get("ckpt/slot0")
        _assert_tree_equal(c.stores["node2"].get("staged/shard0",
                                                 verify=True), own)
        _assert_tree_equal(JStore(JPool(tmp_path / "pmem", "node2"))
                           .get("staged/shard0", verify=True), own)
    finally:
        c.shutdown()


def test_restore_leaves_partial(tmp_path):
    """Only the named leaves, also around a lost node from the replica's
    byte ranges; JAX's restore_leaves on the same pools agrees."""
    state = _tree(15, n=512)
    c = SimCluster(tmp_path, n_nodes=4, device="cpu")
    try:
        c.checkpointer.save(1, state)
        c.checkpointer.wait_async()
        c.tiered.quiesce()
        out = c.checkpointer.restore_leaves(1, ["layer/w"])
        assert set(out) == {"layer/w"}
        np.testing.assert_array_equal(_np(out["layer/w"]),
                                      state["layer"]["w"])
        with pytest.raises(KeyError):
            c.checkpointer.restore_leaves(1, ["nope"])
        c.kill_node("node2")
        out = c.checkpointer.restore_leaves(1, ["ids"], lost_nodes=["node2"])
        np.testing.assert_array_equal(_np(out["ids"]), state["ids"])
    finally:
        c.shutdown()
    jstores = {n: JStore(JPool(tmp_path / "pmem", n)) for n in NODES}
    jstores["node2"].pool.fail()
    theirs = JCheckpointer(jstores).restore_leaves(1, ["ids"],
                                                   lost_nodes=["node2"])
    np.testing.assert_array_equal(theirs["ids"], state["ids"])


# ---------------------------------------------------------------------------
# the checkpoint channel's drains (tests/test_replication.py)
# ---------------------------------------------------------------------------

def test_durability_progression_to_drained(tmp_path):
    def scenario(c):
        t = c.tiered.save_async(1, _rtree(2), drain=True)
        t.result(timeout=30)
        c.tiered.quiesce()
        acks = c.checkpointer.acks(1)
        return t.durability(), {n: acks[n]["drain"]["external"]
                                for n in NODES}
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert mine[0] == "DRAINED" and \
        mine[1] == {n: f"ckpt_step1_{n}" for n in NODES}


def test_failed_drain_keeps_step_replicated_not_drained(tmp_path):
    def scenario(c):
        def boom(name, tree):
            raise IOError("external store died mid-drain")
        c.external.put = boom
        t = c.tiered.save_async(1, _rtree(4), drain=True)
        t.result(timeout=30)
        errors = t.wait_post_commit(timeout=30)
        acks = c.checkpointer.acks(1)
        return (len(errors), all("mid-drain" in str(e) for e in errors),
                t.durability(), any("drain" in acks.get(n, {})
                                    for n in NODES))
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == (4, True, "REPLICATED", False)


def test_restore_falls_back_to_drained_copy(tmp_path):
    """node2's shard owner AND its ring buddy (node3) die: the acked
    drain makes the step recoverable from the external store."""
    t = _rtree(10)

    def scenario(c):
        c.tiered.save_async(1, t, drain=True).result(timeout=30)
        c.tiered.quiesce()
        c.kill_node("node2")
        c.kill_node("node3")
        tree, man = c.checkpointer.restore_latest_recoverable(
            lost_nodes=["node2", "node3"])
        return man["step"], tree
    (jstep, theirs), (step, mine) = _both(tmp_path, scenario)
    assert step == jstep == 1
    _assert_tree_equal(mine, t)
    _assert_tree_equal(theirs, t)


def test_undrained_step_skipped_on_metadata_alone(tmp_path):
    """A step neither replica- nor drain-recoverable for the lost pair is
    skipped on its acks, landing on the older drained step."""
    def scenario(c):
        c.tiered.save_async(1, _rtree(11), drain=True).result(timeout=30)
        c.tiered.quiesce()
        c.checkpointer.buddy = False

        def boom(name, tree):
            raise IOError("external down")
        put, c.external.put = c.external.put, boom
        c.tiered.save_async(2, _rtree(12), drain=True).result(timeout=30)
        c.tiered.quiesce()
        c.external.put = put
        c.kill_node("node2")
        c.kill_node("node3")
        tree, man = c.checkpointer.restore_latest_recoverable(
            lost_nodes=["node2", "node3"])
        return man["step"], dict(c.checkpointer.last_restore_stats), \
            _np(tree["w"])
    theirs, mine = _both(tmp_path, scenario)
    assert mine[:2] == theirs[:2] == (1, {"skipped_by_ack": 1, "probed": 1})
    np.testing.assert_array_equal(mine[2], _rtree(11)["w"])


def test_drain_ack_alone_marks_step_plausible(tmp_path):
    """Replication off entirely: an acked drain still makes a lost node's
    step plausible and restorable."""
    def scenario(c):
        c.checkpointer.buddy = False
        c.tiered.save_async(1, _rtree(13), drain=True).result(timeout=30)
        c.tiered.quiesce()
        c.kill_node("node1")
        ok = c.checkpointer._acks_plausible(1, ["node1"])
        tree, man = c.checkpointer.restore_latest_recoverable(
            lost_nodes=["node1"])
        return ok, man["step"], _np(tree["w"])
    theirs, mine = _both(tmp_path, scenario)
    assert mine[:2] == theirs[:2] == (True, 1)
    np.testing.assert_array_equal(mine[2], _rtree(13)["w"])


# ---------------------------------------------------------------------------
# drains across packages
# ---------------------------------------------------------------------------

def _delta_pair(seed):
    base = _tree(seed, n=1024)
    new = {"layer": {k: v + np.float32(1e-3) for k, v in
                     base["layer"].items()}, "ids": base["ids"] + 1}
    return base, new


def _drained_cluster(c, base, new):
    """A full save at 1 and a delta at 2, both drained; then node2 and
    its buddy node3 die."""
    c.tiered.save_async(1, base, drain=True).result(timeout=30)
    c.tiered.save_async(2, new, base_step=1, drain=True).result(timeout=30)
    assert c.tiered.quiesce() == []
    c.kill_node("node2")
    c.kill_node("node3")


@pytest.mark.parametrize("codec", [None, True], ids=["raw", "strict"])
def test_port_drain_restores_in_jax(codec, tmp_path):
    """A port cluster drains a full and a delta step (through the wire
    codec when asked); JAX's checkpointer restores the delta step from
    the drained copies around the lost pair, equal to the port's own
    restore; JAX stages one drained shard in and reads it bit for bit."""
    base, new = _delta_pair(20)
    c = SimCluster(tmp_path, n_nodes=4, delta=True, wire_codec=codec,
                   device="cpu")
    try:
        _drained_cluster(c, base, new)
        mine, man = c.checkpointer.restore_latest_recoverable(
            lost_nodes=["node2", "node3"])
        assert man["step"] == 2
        own1 = c.stores["node0"].get("ckpt/slot0")
    finally:
        c.shutdown()
    ext = JExternal(tmp_path / "external")
    jstores = {n: JStore(JPool(tmp_path / "pmem", n)) for n in NODES}
    for n in ("node2", "node3"):
        jstores[n].pool.fail()
    jck = JCheckpointer(jstores, external=ext, delta=True)
    theirs, jman = jck.restore_latest_recoverable(
        lost_nodes=["node2", "node3"])
    assert jman["step"] == 2
    _assert_tree_equal(mine, theirs)
    j_import_object(jstores["node1"], ext.get("ckpt_step1_node0"), "staged")
    _assert_tree_equal(jstores["node1"].get("staged", verify=True), own1)


def test_jax_drain_restores_in_the_port(tmp_path):
    """A JAX cluster drains a full and a delta step; the port's
    checkpointer restores the delta step from JAX's drained copies
    (decoding it with the codec's plain version) equal to JAX's restore,
    and the port's scheduler stages a JAX drain in."""
    base, new = _delta_pair(21)
    c = JSimCluster(tmp_path, n_nodes=4, delta=True)
    try:
        _drained_cluster(c, base, new)
        theirs, _ = c.checkpointer.restore_latest_recoverable(
            lost_nodes=["node2", "node3"])
        own1 = c.stores["node0"].get("ckpt/slot0")
    finally:
        c.shutdown()
    ext = ExternalStore(tmp_path / "external")
    stores = {n: PMemObjectStore(PMemPool(tmp_path / "pmem", n),
                                 device="cpu") for n in NODES}
    for n in ("node2", "node3"):
        stores[n].pool.fail()
    ck = DistributedCheckpointer(stores, external=ext, delta=True,
                                 device="cpu")
    mine, man = ck.restore_latest_recoverable(lost_nodes=["node2", "node3"])
    assert man["step"] == 2
    _assert_tree_equal(mine, theirs)
    assert dict(ck.last_restore_stats) == {"skipped_by_ack": 0, "probed": 1}
    import_object(stores["node1"], ext.get("ckpt_step1_node0"), "staged")
    _assert_tree_equal(stores["node1"].get("staged", verify=True), own1)


def test_external_store_throttle_and_plain_pickles(tmp_path):
    """``bandwidth_bytes_s`` delays puts and gets as JAX's does, and a
    drained payload pickles without torch (JAX's store unpickles it)."""
    c = SimCluster(tmp_path, n_nodes=2, external_bandwidth=2e6,
                   device="cpu")
    try:
        c.tiered.save_async(1, {"w": torch.ones(64, 64)}, drain=True)
        assert c.tiered.quiesce() == []
        raw = (tmp_path / "external" / "ckpt_step1_node0.pkl").read_bytes()
        assert b"torch" not in raw
        assert is_wire_object(pickle.loads(raw))
        assert c.external.bandwidth == 2e6
        assert JExternal(tmp_path / "external").get("ckpt_step1_node1") \
            == c.external.get("ckpt_step1_node1")
    finally:
        c.shutdown()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the codec kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_drain_and_rehydrate_a_delta_step_on_card(cuda, tmp_path):
    """A delta step drained through the wire codec on the card; its home
    and buddy die; the restore decodes the drained delta with
    decode_tiles, repair rehydrates the drained shards and the next
    restore reads pmem alone, bit-identical, decoding on the card
    again."""
    from repro_torch.kernels import watchdog
    from repro_torch.kernels.ckpt_codec import ops as codec

    base, new = _delta_pair(30)
    c = SimCluster(tmp_path, n_nodes=4, delta=True, wire_codec=True,
                   device=cuda)
    try:
        c.tiered.save_async(1, bridge.tree_map(
            lambda a: torch.from_numpy(a).to(cuda), base), drain=True)
        watchdog.synchronize()
        e0 = codec.encode_launches
        c.tiered.save_async(2, bridge.tree_map(
            lambda a: torch.from_numpy(a).to(cuda), new), base_step=1,
            drain=True)
        assert c.tiered.quiesce() == []
        assert codec.encode_launches > e0
        c.kill_node("node2")
        c.kill_node("node3")
        lost = ["node2", "node3"]
        d0 = codec.decode_launches
        got, man = c.checkpointer.restore_latest_recoverable(lost_nodes=lost)
        watchdog.synchronize()
        assert man["step"] == 2 and codec.decode_launches > d0
        assert all(t.device.type == "cuda" for _, t in
                   bridge.tree_leaves(got))
        report = c.repair(lost)
        assert report["rehydrated"] > 0 and not report["errors"]
        c.external.get = None  # the next restore must not read it
        d1 = codec.decode_launches
        again, _ = c.checkpointer.restore_latest_recoverable(lost_nodes=lost)
        watchdog.synchronize()
        assert codec.decode_launches > d1
        _assert_tree_equal(again, got)
        np.testing.assert_allclose(_np(got["layer"]["w"]),
                                   new["layer"]["w"], atol=1e-5)
        np.testing.assert_array_equal(_np(got["ids"]), new["ids"])
    finally:
        c.shutdown()
