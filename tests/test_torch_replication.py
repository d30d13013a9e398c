"""Port parity: replication, the DLM write-back cache and TieredIO's DLM
channel against the JAX package.

``copy_object`` raw and through the wire codec (a replica made by either
package reads in the other, manifests equal apart from ``ts``), a second
hop that never encodes twice, a superseded source, byte-range reads of
encoded objects; the ``DLMCache`` and TieredIO counters under the same
operations as JAX's; DLM replicas with their ``dlm/ackslog`` acks read
across packages, the replica fallback after the home pool fails, the
live-ring buddy; checkpoint saves that reach REPLICATED and restore in
JAX from the port's replicas around a lost node. CPU tensors throughout,
so the wire codec runs its kernels' plain versions.
"""
import copy
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.checkpoint import DistributedCheckpointer as JCheckpointer
from repro.core.cluster import SimCluster as JSimCluster
from repro.core.object_store import PMemObjectStore as JStore
from repro.core.object_store import copy_object as j_copy_object
from repro.core.pmem import PMemPool as JPool
from repro.core.tiered_io import DLMAckRegistry as JAckRegistry
from repro.core.tiering import DLMCache as JDLMCache
from repro_torch import bridge
from repro_torch.core.cluster import SimCluster
from repro_torch.core.object_store import (PMemObjectStore, SupersededError,
                                           copy_object)
from repro_torch.core.pmem import PMemPool
from repro_torch.core.tiering import DLMCache

CODECS = [None, True, {"strict": False}]
CODEC_IDS = ["raw", "strict", "lossy"]


def _tree(seed=0, n=2048):
    """A session-shaped tree: a float32 leaf on an 8-bit grid (encodes
    in strict mode), float32 noise (ships raw in strict mode), a
    sub-tile float32 leaf, bf16 pages (always raw) and int32 ids."""
    rng = np.random.default_rng(seed)
    return {"layer": {"w": (rng.integers(-100, 100, (n, 8)) * 0.25)
                      .astype(np.float32),
                      "h": rng.standard_normal((n // 2, 8))
                      .astype(np.float32),
                      "b": rng.standard_normal(8).astype(np.float32)},
            "kv": rng.standard_normal((n // 4, 8)).astype(ml_dtypes.bfloat16),
            "ids": np.arange(n, dtype=np.int32)}


def _bits(x) -> np.ndarray:
    return bridge.to_numpy(x)


def _assert_tree_bits(got, want):
    gl, wl = bridge.tree_leaves(got), bridge.tree_leaves(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        g, w = _bits(g), _bits(w)
        assert g.shape == w.shape and g.tobytes() == w.tobytes(), path


def _stores(root, names=("a", "b", "c")):
    """Port and JAX stores over the same pools."""
    port = {n: PMemObjectStore(PMemPool(Path(root), n), device="cpu")
            for n in names}
    jax_ = {n: JStore(JPool(Path(root), n)) for n in names}
    return port, jax_


def _no_ts(man):
    return {k: v for k, v in man.items() if k != "ts"}


def _lossy(codec) -> bool:
    return isinstance(codec, dict) and not codec.get("strict", True)


# ---------------------------------------------------------------------------
# copy_object
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", CODECS, ids=CODEC_IDS)
def test_port_replica_reads_in_jax_and_matches_jax_copy(codec, tmp_path):
    """The same source copied by each package (port to b, JAX to c): the
    manifests agree apart from ``ts`` (the codec tables, encoded CRCs
    included), and JAX reads the port's replica as its own."""
    port, jx = _stores(tmp_path)
    tree = _tree(1)
    port["a"].put("obj", tree, meta={"step": 3})
    mine = copy_object(port["a"], port["b"], "obj", codec=codec,
                       expect_meta={"step": 3})
    theirs = j_copy_object(jx["a"], jx["c"], "obj", codec=codec,
                           expect_meta={"step": 3})
    assert _no_ts(mine) == _no_ts(theirs)
    assert _no_ts(jx["b"].manifest("obj")) == _no_ts(theirs)
    wc = mine["meta"].get("wire_codec")
    if codec is not None:  # w encodes; h in lossy mode only; the rest raw
        modes = {p: e["mode"] for p, e in wc["leaves"].items()}
        assert modes == {"ids": "raw", "kv": "raw", "layer/b": "raw",
                         "layer/h": "raw" if codec is True else "delta8",
                         "layer/w": "delta8"}
    _assert_tree_bits(jx["b"].get("obj", verify=True),
                      jx["c"].get("obj", verify=True))
    if not _lossy(codec):
        _assert_tree_bits(port["b"].get("obj", verify=True), tree)


@pytest.mark.parametrize("codec", CODECS, ids=CODEC_IDS)
def test_jax_replica_reads_in_the_port(codec, tmp_path):
    port, jx = _stores(tmp_path)
    tree = _tree(2)
    jx["a"].put("obj", tree)
    j_copy_object(jx["a"], jx["b"], "obj", codec=codec)
    got, man = port["b"].get_with_manifest("obj", verify=True)
    _assert_tree_bits(got, jx["b"].get("obj", verify=True))
    assert isinstance(got["kv"], torch.Tensor) and \
        got["kv"].dtype == torch.bfloat16
    if not _lossy(codec):
        _assert_tree_bits(got, tree)
    # a leaf alone, and a row range of an encoded leaf: the tiles that
    # cover it are decoded (rows 100..117 of 2048 x 8 cross a tile edge)
    np.testing.assert_array_equal(port["b"].get_leaf("obj", "layer/w"),
                                  jx["b"].get_leaf("obj", "layer/w"))
    for leaf, lo, n in (("layer/w", 100, 17), ("layer/h", 3, 200),
                        ("kv", 10, 7), ("ids", 1000, 30)):
        want = jx["b"].read_leaf_slice("obj", leaf, lo, n)
        got = port["b"].read_leaf_slice("obj", leaf, lo, n)
        assert _bits(got).tobytes() == _bits(want).tobytes(), leaf
        assert tuple(got.shape) == want.shape


def test_second_hop_copy_never_double_encodes(tmp_path):
    port, jx = _stores(tmp_path)
    tree = _tree(3)
    port["a"].put("obj", tree)
    man1 = copy_object(port["a"], port["b"], "obj", codec=True)
    man2 = copy_object(port["b"], port["c"], "obj", codec=True)
    # the encoded segment table raw-streams verbatim
    assert man2["meta"]["wire_codec"] == man1["meta"]["wire_codec"]
    _assert_tree_bits(port["c"].get("obj", verify=True), tree)
    _assert_tree_bits(jx["c"].get("obj", verify=True), tree)


def test_superseded_source_raises_and_commits_nothing(tmp_path):
    port, _ = _stores(tmp_path)
    port["a"].put("obj", _tree(5), meta={"step": 1})
    port["a"].put("obj", _tree(6), meta={"step": 2})  # overwritten
    with pytest.raises(SupersededError):
        copy_object(port["a"], port["b"], "obj", expect_meta={"step": 1})
    assert not port["b"].exists("obj")
    assert list(port["b"].pool.list("objects/")) == []  # no shadow left


def test_source_overwritten_mid_copy_is_superseded(tmp_path, monkeypatch):
    """The freshness recheck: the source manifest changes while the
    bytes stream (slot reuse); the copy raises and leaves no manifest."""
    from repro_torch.core import object_store as os_mod
    port, _ = _stores(tmp_path)
    port["a"].put("obj", _tree(7), meta={"step": 1})
    real = os_mod._copy_raw

    def racing(*args, **kwargs):
        out = real(*args, **kwargs)
        port["a"].put("obj", _tree(8), meta={"step": 1})
        return out
    monkeypatch.setattr(os_mod, "_copy_raw", racing)
    with pytest.raises(SupersededError, match="mid-copy"):
        copy_object(port["a"], port["b"], "obj")
    assert not port["b"].exists("obj")


def test_store_helpers_match_jax(tmp_path):
    port, jx = _stores(tmp_path)
    port["a"].put("x", _tree(9))
    port["a"].put("y", _tree(9), version=3)
    assert port["a"].list_objects() == jx["a"].list_objects() == \
        [("x", 0), ("y", 3)]
    assert port["a"].nbytes_of("x") == jx["a"].nbytes_of("x") > 0
    port["a"].delete("x")
    assert jx["a"].list_objects() == [("y", 3)]
    from repro_torch.core.object_store import DistributedStore
    view = DistributedStore(port)
    assert view.locate("y", 3) == ["a"]
    _assert_tree_bits(view.get("y", 3), _tree(9))
    assert view.nbytes_of("y", 3) == jx["a"].nbytes_of("y", 3)
    assert view.nbytes_of("nope") == 0


# ---------------------------------------------------------------------------
# DLMCache: the same operations, the same counters
# ---------------------------------------------------------------------------

def _obj(nbytes, seed=0):
    return {"x": np.full(nbytes // 4, seed, np.float32)}


def _counters(cache) -> dict:
    return {k: getattr(cache, k) for k in (
        "hits", "misses", "evictions", "prefetches", "prefetch_hits",
        "bypasses")} | {"used": cache.used_bytes()}


def _dlm_script(cache, store):
    """The JAX tests' DLM sequences (running total, oversized bypass,
    prefetch, cold eviction) as one script; the counters after each
    step."""
    out = []
    for i in range(8):
        cache.put(f"o{i}", _obj(1024, i))
        out.append(_counters(cache))
    cache.put("o7", _obj(2048, 99))  # replace with a bigger body
    cache.put("huge", _obj(8192, 2))  # > capacity: bypasses DRAM
    assert store.exists("dlm/huge") and not cache.contains("huge")
    out.append(_counters(cache))
    np.testing.assert_array_equal(cache.get("huge")["x"],
                                  _obj(8192, 2)["x"])
    cache.get("o7")
    out.append(_counters(cache))
    assert cache.prefetch("o7") is True
    assert cache.prefetch("o0") is False   # evicted earlier: loads it
    out.append(_counters(cache))
    np.testing.assert_array_equal(cache.get("o0")["x"], _obj(1024, 0)["x"])
    cache.flush()
    for idle in (3600.0, 0.0):
        evicted = cache.evict_cold(idle)
        out.append(_counters(cache) | {"evicted": evicted})
    return out


def test_dlm_cache_counters_match_jax(tmp_path):
    port, jx = _stores(tmp_path, ("p", "j"))
    mine = _dlm_script(DLMCache(port["p"], capacity_bytes=4096), port["p"])
    theirs = _dlm_script(JDLMCache(jx["j"], capacity_bytes=4096), jx["j"])
    assert mine == theirs
    assert mine[-1]["used"] == 0 and mine[-1]["evictions"] > 0


def test_dlm_cache_counts_bf16_tensor_bytes(tmp_path):
    port, _ = _stores(tmp_path, ("p",))
    cache = DLMCache(port["p"], capacity_bytes=1 << 20)
    cache.put("s", {"k": torch.zeros(64, 8, dtype=torch.bfloat16),
                    "pos": np.int32(3)})
    assert cache.used_bytes() == 64 * 8 * 2 + 4


# ---------------------------------------------------------------------------
# TieredIO's DLM channel
# ---------------------------------------------------------------------------

@pytest.fixture()
def port_cluster(tmp_path):
    c = SimCluster(tmp_path / "port", n_nodes=4, device="cpu")
    yield c
    c.shutdown()


def _tiered_script(c):
    """JAX's offload/prefetch/evict/fetch accounting test as a script:
    the prefetch results and stats along the way."""
    t = _tree(9)
    c.tiered.offload("serve/sessA", t).result(timeout=30)
    out = [c.tiered.prefetch(["serve/sessA"]).result(timeout=30)]
    out.append(c.tiered.evict_cold(max_idle_s=3600.0))
    out.append(c.tiered.evict_cold())
    out.append(c.tiered.prefetch(["serve/never-written", "serve/sessA"])
               .result(timeout=30))
    h0 = c.dlm.hits
    _assert_tree_bits(c.tiered.fetch("serve/sessA"), t)
    out.append(c.dlm.hits - h0)
    out.append(dict(c.tiered.stats))
    assert c.tiered.quiesce() == []
    return out


def test_tiered_dlm_accounting_matches_jax(port_cluster, tmp_path):
    jc = JSimCluster(tmp_path / "jax", n_nodes=4)
    try:
        theirs = _tiered_script(jc)
    finally:
        jc.shutdown()
    mine = _tiered_script(port_cluster)
    jstats = {k: theirs[-1][k] for k in mine[-1]}
    assert mine[:-1] == theirs[:-1] and mine[-1] == jstats
    assert mine[0] == {"hits": 1, "loads": 0, "missing": 0}
    assert mine[3] == {"hits": 0, "loads": 1, "missing": 1}


@pytest.mark.parametrize("codec", [None, True], ids=["raw", "strict"])
def test_dlm_replica_and_acks_read_in_jax(codec, tmp_path):
    """A port offload on a port cluster: the buddy replica on node1 and
    the ack in dlm/ackslog, read by JAX's store and ack registry."""
    c = SimCluster(tmp_path, n_nodes=4, device="cpu", wire_codec=codec)
    try:
        t = _tree(10)
        c.tiered.offload("serve/sess", t).result(timeout=30)
        assert c.tiered.quiesce() == []
        mine = c.tiered.dlm_acks.objects()
    finally:
        c.shutdown()
    assert list(mine) == ["dlm/serve/sess"]
    assert mine["dlm/serve/sess"]["home"] == "node0"
    assert mine["dlm/serve/sess"]["targets"] == ["node1"]
    jstores = {f"node{i}": JStore(JPool(tmp_path / "pmem", f"node{i}"))
               for i in range(4)}
    assert JAckRegistry(jstores, list(jstores)).objects() == mine
    rep = jstores["node1"].get_with_manifest(
        "replica/node0/dlm/serve/sess", verify=True)
    _assert_tree_bits(rep[0], t)
    assert rep[1]["meta"]["replica_of"] == "node0"
    assert ("wire_codec" in rep[1]["meta"]) == (codec is not None)


def test_jax_dlm_acks_read_in_the_port(tmp_path):
    jc = JSimCluster(tmp_path, n_nodes=4)
    try:
        jc.tiered.offload("serve/j", _tree(11)).result(timeout=30)
        jc.tiered.quiesce()
        theirs = jc.tiered.dlm_acks.objects()
    finally:
        jc.shutdown()
    c = SimCluster(tmp_path, n_nodes=4, device="cpu")
    try:
        assert c.tiered.dlm_acks.objects() == theirs
        assert c.tiered.dlm_acks.targets("dlm/serve/j") == ["node1"]
        # the port's replica read follows JAX's ack after node0 dies
        c.kill_node("node0")
        _assert_tree_bits(c.tiered.fetch("serve/j"), _tree(11))
    finally:
        c.shutdown()


@pytest.mark.parametrize("codec", [None, True], ids=["raw", "strict"])
def test_prefetch_and_fetch_leaf_fall_back_to_the_replica(codec, tmp_path):
    c = SimCluster(tmp_path, n_nodes=4, device="cpu", wire_codec=codec)
    try:
        t = _tree(12)
        obj = {"cache": t, "pos": np.int32(17)}
        c.tiered.offload("serve/sess", obj).result(timeout=30)
        assert c.tiered.quiesce() == []
        assert c.tiered.evict_cold() >= 1  # pmem is the only copy now
        np.testing.assert_array_equal(
            c.tiered.fetch_leaf("serve/sess", "cache/layer/w"),
            t["layer"]["w"])
        c.kill_node("node0")  # the DLM home node dies
        assert int(c.tiered.fetch_leaf("serve/sess", "pos")) == 17
        np.testing.assert_array_equal(
            c.tiered.fetch_leaf("serve/sess", "cache/layer/w"),
            t["layer"]["w"])
        assert c.tiered.prefetch(["serve/sess"]).result(timeout=30) == \
            {"hits": 0, "loads": 1, "missing": 0}
        _assert_tree_bits(c.tiered.fetch("serve/sess"), obj)
        with pytest.raises(KeyError):
            c.tiered.fetch_leaf("serve/sess", "nope")
        # missing everywhere stays advisory
        assert c.tiered.prefetch(["serve/nope"]).result(timeout=30) == \
            {"hits": 0, "loads": 0, "missing": 1}
        c.tiered.join()
    finally:
        c.shutdown()


def test_dlm_replica_lands_on_survivor_when_static_buddy_dead(
        port_cluster):
    c = port_cluster
    c.kill_node("node1")  # node0's static ring buddy
    t = _tree(13)
    c.tiered.offload("serve/sess2", t).result(timeout=30)
    assert c.tiered.quiesce() == []
    assert c.stores["node2"].exists("replica/node0/dlm/serve/sess2")
    assert c.tiered.dlm_acks.targets("dlm/serve/sess2") == ["node2"]
    c.tiered.evict_cold()
    c.kill_node("node0")
    _assert_tree_bits(c.tiered.fetch("serve/sess2"), t)


def test_offload_without_replica_stays_node_local(port_cluster):
    c = port_cluster
    c.tiered.offload("serve/local", _tree(14),
                     replicate=False).result(timeout=30)
    assert c.tiered.quiesce() == []
    assert not any(c.stores[n].exists("replica/node0/dlm/serve/local")
                   for n in c.node_ids)
    assert c.tiered.dlm_acks.targets("dlm/serve/local") == []


def test_dlm_cache_obs_raises_item_10(port_cluster):
    """A ``DLMCache`` given a telemetry plane (``obs``) keeps its
    instruments in the plane's registry, as JAX's does (the cluster's
    cache reads through to them); the exchange and compute channels work
    (tests/test_torch_dataset_exchange.py holds them against JAX)."""
    c = port_cluster
    cache = DLMCache(c.stores["node0"], 1024, obs=c.obs)
    reg = c.obs.registry
    for k in ("hits", "misses", "evictions", "prefetches",
              "prefetch_hits", "bypasses"):
        assert cache._counters[k] is reg.counter(f"dlm.{k}")
    assert cache._g_used is reg.gauge("dlm.used_bytes")
    hits = c.dlm.hits
    reg.counter("dlm.hits").inc()
    assert c.dlm.hits == cache.hits == hits + 1
    assert c.tiered.catalog is c.catalog and \
        c.catalog.exchange is c.tiered.exchange
    c.catalog.publish("d", {"x": np.arange(4.0)}, workflow="w")
    got = c.tiered.prefetch_datasets(["d"], "w").result(timeout=30)
    assert got == {"hits": 0, "loads": 1, "missing": 0}
    c.external.put("x", {"x": np.arange(3)})
    for f in c.tiered.stage_in("node0", ["x"]):
        f.result(timeout=30)
    assert c.stores["node0"].exists("staged/x")
    assert c.scheduler.run_job("node0", lambda: 7).result(timeout=30) == 7


# ---------------------------------------------------------------------------
# checkpoint replication
# ---------------------------------------------------------------------------

def _state(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((8, 300))
                       .astype(ml_dtypes.bfloat16),
                       "emb": (rng.integers(-60, 60, (64, 40)) * 0.5)
                       .astype(np.float32)},
            "opt": {"m": rng.standard_normal((8, 300)).astype(np.float32),
                    "step": np.int32(seed)}}


def _torch_tree(tree):
    return bridge.tree_map(lambda a: bridge.to_torch(a), tree)


def test_durability_progression_to_replicated(tmp_path):
    c = SimCluster(tmp_path, n_nodes=2, device="cpu")
    try:
        t = c.tiered.save_async(1, _torch_tree(_state(1)))
        t.result(timeout=30)
        assert t.wait_post_commit(timeout=30) == []
        c.tiered.join()
        assert t.durability() == "REPLICATED"
        acks = c.checkpointer.acks(1)
        for nid in c.node_ids:
            rec = acks[nid]["replica"]
            assert rec["target"] == c.checkpointer.buddy_of(nid, c.node_ids)
            assert rec["targets"] == [rec["target"]] and "ts" in rec
        hist = c.tiered.replication._ack_s
        assert hist.count == 2 and hist.sum >= 0
    finally:
        c.shutdown()


def test_durability_stays_local_without_replication(tmp_path):
    c = SimCluster(tmp_path, n_nodes=2, buddy=False, device="cpu")
    try:
        t = c.tiered.save_async(1, _torch_tree(_state(2)))
        t.result(timeout=30)
        c.tiered.join()
        assert t.durability() == "LOCAL"
        assert not c.stores["node1"].exists("replica/node0/ckpt/slot0")
    finally:
        c.shutdown()


def test_standalone_save_replicates_through_wait_async(tmp_path):
    """``checkpointer.save`` without the engine queues its replicates on
    the checkpointer's own list; ``wait_async`` joins them."""
    c = SimCluster(tmp_path, n_nodes=2, device="cpu")
    try:
        c.checkpointer.save(1, _torch_tree(_state(3)))
        c.checkpointer.wait_async()
        assert sorted(c.checkpointer.acks(1)) == ["node0", "node1"]
    finally:
        c.shutdown()


@pytest.mark.parametrize("codec", [None, True], ids=["raw", "strict"])
def test_jax_restores_a_port_checkpoint_around_a_lost_node(codec,
                                                           tmp_path):
    """Full (step 2) and delta (step 4) saves on a 4-node port cluster,
    replicated (through the wire codec when asked); node2 dies; JAX's
    checkpointer restores both steps with ``lost_nodes=["node2"]`` from
    the port's replicas, bit for bit against the port's own restore
    made before the loss."""
    c = SimCluster(tmp_path, n_nodes=4, delta=True, device="cpu",
                   wire_codec=codec)
    try:
        s2 = _state(4)
        s4 = copy.deepcopy(s2)
        s4["opt"]["m"] = s4["opt"]["m"] + np.float32(0.01)
        s4["opt"]["step"] = np.int32(4)
        c.tiered.save_async(2, _torch_tree(s2))
        t4 = c.tiered.save_async(4, _torch_tree(s4), base_step=2)
        c.tiered.join()
        assert t4.durability() == "REPLICATED"
        mine = {st: c.checkpointer.restore(st)[0] for st in (2, 4)}
        c.kill_node("node2")
    finally:
        c.shutdown()
    stores = {f"node{i}": JStore(JPool(tmp_path / "pmem", f"node{i}"))
              for i in range(4)}
    jck = JCheckpointer(stores, delta=True)
    for st in (2, 4):
        theirs, _ = jck.restore(st, lost_nodes=["node2"])
        _assert_tree_bits(mine[st], theirs)
    _assert_tree_bits(mine[2], s2)


# ---------------------------------------------------------------------------
# the scheduler's queue depth and TieredIO's newest save ticket
# ---------------------------------------------------------------------------

def _depth_and_ticket_script(c):
    """On a one-node cluster (nothing to steal): the queue depth behind a
    running job, then ``last_ticket`` before, during and after saves."""
    import threading
    sched, out = c.scheduler, []
    started, release = threading.Event(), threading.Event()

    def blocker():
        started.set()
        release.wait(30)

    out.append(sched.queue_depth("node0"))
    futs = [sched.run_job("node0", blocker)]
    assert started.wait(30)
    futs += [sched.run_job("node0", lambda: None) for _ in range(3)]
    out.append(sched.queue_depth("node0"))
    release.set()
    for f in futs:
        f.result(30)
    out.append(sched.queue_depth("node0"))
    out.append(c.tiered.last_ticket())
    t1 = c.tiered.save_async(1, _state(1))
    t2 = c.tiered.save_async(2, _state(2))
    last = c.tiered.last_ticket()
    out.append((last is t2, last.step, t1.step))
    c.tiered.join()
    out.append(c.tiered.last_ticket())
    return out


def test_queue_depth_and_last_ticket_match_jax(tmp_path):
    jc = JSimCluster(tmp_path / "jax", n_nodes=1, buddy=False)
    try:
        want = _depth_and_ticket_script(jc)
    finally:
        jc.shutdown()
    c = SimCluster(tmp_path / "port", n_nodes=1, buddy=False, device="cpu")
    try:
        got = _depth_and_ticket_script(c)
    finally:
        c.shutdown()
    assert got == want == [0, 3, 0, None, (True, 2, 1), None]
