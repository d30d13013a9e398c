"""Port parity: lost-node restore, replica repair, the repair daemon,
failure recovery and the training loop's fault hook against the JAX
package.

Each scenario of JAX's own tests (tests/test_checkpoint.py,
test_replication.py, test_repair.py, test_repair_daemon.py and
test_system.py; the cases that need no dataset catalog or workflow) runs
on a JAX cluster and on a port cluster with the same numpy inputs, and
both must give the same answers: restored trees, ``last_restore_stats``,
repair reports and the acked copy sets they leave. Checkpoints saved by
either package restore around lost nodes in the other, and a repair made
by one package is read by the other's restore. Last, the port's loop with
``fault_at`` against JAX's loop from the same parameters and batches, and
the CLI's ``--fault-at``. CPU tensors throughout.
"""
import time
from concurrent.futures import Future
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import data_scheduler as jds
from repro.core.checkpoint import DistributedCheckpointer as JCheckpointer
from repro.core.cluster import SimCluster as JSimCluster
from repro.core.object_store import PMemObjectStore as JStore
from repro.core.pmem import PMemPool as JPool
from repro.data.pipeline import StagedDataset as JStagedDataset
from repro.models import transformer as jT
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import bridge
from repro_torch.configs import ShapeConfig, registry
from repro_torch.core import data_scheduler as ds
from repro_torch.core.checkpoint import DistributedCheckpointer
from repro_torch.core.cluster import SimCluster
from repro_torch.core.dataset_exchange import ack_targets
from repro_torch.core.object_store import PMemObjectStore
from repro_torch.core.pmem import PMemPool
from repro_torch.core.resilience import StragglerDetector
from repro_torch.data.pipeline import StagedDataset
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import loop
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

jax.config.update("jax_platform_name", "cpu")

NODES = [f"node{i}" for i in range(4)]


def _tree(seed=0, n=64):
    return {"x": np.random.RandomState(seed).randn(n).astype(np.float32)}


def _rtree(seed=0):
    r = np.random.RandomState(seed)
    return {"w": r.randn(16, 8).astype(np.float32),
            "b": r.randn(8).astype(np.float32)}


def _ctree(seed=0):
    """tests/test_checkpoint.py's tree: split, whole and odd leaves."""
    r = np.random.RandomState(seed)
    return {"layer": {"w": r.randn(8, 8).astype(np.float32),
                      "b": r.randn(8).astype(np.float32)},
            "emb": r.randn(16, 4).astype(np.float32),
            "odd": r.randn(7, 3).astype(np.float32)}


def _np(x):
    return bridge.to_numpy(x)


def _flat(tree):
    return {p: _np(v) for p, v in bridge.tree_leaves(tree)}


def _assert_tree_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for path in w:
        assert g[path].tobytes() == w[path].tobytes(), path


def _summary(report: dict) -> dict:
    """A repair report without its exception objects."""
    out = {k: v for k, v in report.items() if k != "errors"}
    out["errors"] = len(report.get("errors", ()))
    if "repaired" in out:
        out["repaired"] = [tuple(r) for r in out["repaired"]]
    return out


def _port(root, **kw):
    return SimCluster(root, device="cpu", **kw)


def _both(tmp_path, scenario, **kw):
    """``scenario(cluster)`` on a JAX and on a port cluster (each shut
    down after): (jax result, port result)."""
    out = []
    for name, make in (("jax", JSimCluster), ("port", _port)):
        c = make(tmp_path / name, **kw)
        try:
            out.append(scenario(c))
        finally:
            c.shutdown()
    return out


def _beat_all(c, step=1):
    for nid in c.node_ids:
        c.heartbeat.beat(nid, step)


def _ckpt_copies(c, step, lost):
    """Surviving acked copy-holder sets per shard owner at ``step``."""
    acks = c.checkpointer.acks(step)
    rec = c.checkpointer._meta_get_json(f"ckpt/manifest_step{step}.json")
    return {nid: ({nid} | set(ack_targets(acks.get(nid, {})
                                          .get("replica")))) - set(lost)
            for nid in rec.get("nodes") or c.node_ids}


def _all_two_copies(c, step, lost) -> bool:
    return all(len(h) >= 2 for h in _ckpt_copies(c, step, lost).values())


def _record_store_reads(c):
    """Wrap every store's object-read/probe entry points, recording the
    object names touched (pool JSON, the ack records, stays allowed)."""
    reads = []

    def wrap(st):
        orig_get, orig_exists = st.get_with_manifest, st.exists

        def get_with_manifest(name, *a, **k):
            reads.append(name)
            return orig_get(name, *a, **k)

        def exists(name, *a, **k):
            reads.append(name)
            return orig_exists(name, *a, **k)
        st.get_with_manifest, st.exists = get_with_manifest, exists

    for st in c.stores.values():
        wrap(st)
    return reads


def _dead_replicate(src, obj, dst, **kw):
    f = Future()
    f.set_exception(IOError("fabric down"))
    return f


# ---------------------------------------------------------------------------
# lost-node restore (tests/test_checkpoint.py, tests/test_replication.py)
# ---------------------------------------------------------------------------

def test_buddy_recovery_any_single_node(tmp_path):
    t = _ctree(3)

    def scenario(c):
        c.checkpointer.save(4, t)
        c.checkpointer.wait_async()
        return [c.checkpointer.restore(4, lost_nodes=[v])[0]
                for v in c.node_ids]
    theirs, mine = _both(tmp_path, scenario)
    for j, p in zip(theirs, mine):
        _assert_tree_equal(p, t)
        _assert_tree_equal(j, t)


def test_elastic_shard_reads(tmp_path):
    """Row ranges crossing node boundaries, also around a lost owner (its
    rows from the replica), equal to JAX's reads."""
    t = _ctree(4)

    def scenario(c):
        c.checkpointer.save(1, t)
        c.checkpointer.wait_async()
        out = [_np(c.checkpointer.restore_shard(1, "emb", s, n))
               for s, n in [(0, 16), (3, 6), (7, 2), (12, 4)]]
        c.kill_node("node1")
        out.append(_np(c.checkpointer.restore_shard(
            1, "emb", 2, 9, lost_nodes=["node1"])))
        return out
    theirs, mine = _both(tmp_path, scenario)
    for (s, n), a, b in zip([(0, 16), (3, 6), (7, 2), (12, 4), (2, 9)],
                            mine, theirs):
        np.testing.assert_array_equal(a, t["emb"][s:s + n])
        np.testing.assert_array_equal(a, b)


def test_ack_skip_needs_no_store_reads(tmp_path):
    """A step whose acks show the lost node unreplicated is skipped on
    metadata alone: no object-store read touches its slot."""
    def scenario(c):
        c.tiered.save_async(1, _rtree(1)).result(timeout=30)
        c.tiered.quiesce()
        c.scheduler.replicate = _dead_replicate
        man2 = c.tiered.save_async(2, _rtree(2)).result(timeout=30)
        c.tiered.quiesce()
        victim = c.node_ids[-1]
        c.kill_node(victim)
        reads = _record_store_reads(c)
        out, man = c.checkpointer.restore_latest_recoverable(
            lost_nodes=[victim])
        slot2 = f"ckpt/slot{man2['slot']}"
        return (man["step"], dict(c.checkpointer.last_restore_stats),
                any(slot2 in name for name in reads), _np(out["w"]))
    theirs, mine = _both(tmp_path, scenario)
    assert mine[:3] == theirs[:3] == \
        (1, {"skipped_by_ack": 1, "probed": 1}, False)
    np.testing.assert_array_equal(mine[3], _rtree(1)["w"])


def test_probe_all_still_works_without_acks(tmp_path):
    def scenario(c):
        c.tiered.save_async(1, _rtree(1)).result(timeout=30)
        c.tiered.quiesce()
        c.checkpointer.buddy = False
        c.tiered.save_async(2, _rtree(2)).result(timeout=30)
        c.tiered.quiesce()
        c.kill_node(c.node_ids[-1])
        _, man = c.checkpointer.restore_latest_recoverable(
            lost_nodes=[c.node_ids[-1]], use_acks=False)
        return man["step"], dict(c.checkpointer.last_restore_stats)
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == (1, {"skipped_by_ack": 0, "probed": 2})


def test_replica_on_another_dead_node_is_skipped(tmp_path):
    def scenario(c):
        c.tiered.save_async(1, _rtree(1)).result(timeout=30)
        c.tiered.quiesce()
        victim = c.node_ids[-1]
        buddy = c.checkpointer.buddy_of(victim, c.node_ids)
        with pytest.raises(IOError):
            c.checkpointer.restore_latest_recoverable(
                lost_nodes=[victim, buddy])
        return dict(c.checkpointer.last_restore_stats)
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == {"skipped_by_ack": 1, "probed": 0}


def test_delta_chain_restore_via_buddy_replica(tmp_path):
    """A delta step restored for a lost node decodes against the BASE's
    buddy replica too; the port's decode equals JAX's bit for bit."""
    base = _rtree(5)
    t2 = {k: v + np.float32(1e-3) for k, v in base.items()}

    def scenario(c):
        c.checkpointer.save(1, base)
        c.checkpointer.save(2, t2, base_step=1)
        c.checkpointer.wait_async()
        c.kill_node(c.node_ids[-1])
        out, man = c.checkpointer.restore_latest_recoverable(
            lost_nodes=[c.node_ids[-1]])
        return (man["step"], man["delta_base"],
                dict(c.checkpointer.last_restore_stats), out)
    theirs, mine = _both(tmp_path, scenario, delta=True)
    assert mine[:3] == theirs[:3] == (2, 1, {"skipped_by_ack": 0,
                                             "probed": 1})
    _assert_tree_equal(mine[3], theirs[3])
    assert np.abs(_np(mine[3]["w"]) - t2["w"]).max() < 1e-4


def test_delta_durability_capped_by_unreplicated_base(tmp_path):
    def scenario(c):
        orig = c.scheduler.replicate
        c.scheduler.replicate = _dead_replicate
        base = _rtree(9)
        c.tiered.save_async(1, base).result(timeout=30)
        c.tiered.quiesce()
        c.scheduler.replicate = orig
        t2 = c.tiered.save_async(
            2, {k: v + np.float32(1e-3) for k, v in base.items()},
            base_step=1)
        t2.result(timeout=30)
        c.tiered.quiesce()
        acked = set(c.checkpointer.acks(2)) == set(c.node_ids)
        level = t2.durability()
        c.kill_node(c.node_ids[-1])
        with pytest.raises(IOError):
            c.checkpointer.restore_latest_recoverable(
                lost_nodes=[c.node_ids[-1]])
        return acked, level, dict(c.checkpointer.last_restore_stats)
    theirs, mine = _both(tmp_path, scenario, delta=True)
    assert mine == theirs == (True, "LOCAL", {"skipped_by_ack": 2,
                                              "probed": 0})


def test_ack_map_survives_node0_loss(tmp_path):
    def scenario(c):
        t = c.tiered.save_async(1, _rtree(6))
        t.result(timeout=30)
        c.tiered.quiesce()
        c.kill_node("node0")
        known = sorted(c.checkpointer.acks(1))
        out, man = c.checkpointer.restore_latest_recoverable(
            lost_nodes=["node0"])
        return (known, t.durability(), man["step"],
                dict(c.checkpointer.last_restore_stats), _np(out["w"]))
    theirs, mine = _both(tmp_path, scenario)
    assert mine[:4] == theirs[:4] == (NODES, "REPLICATED", 1,
                                      {"skipped_by_ack": 0, "probed": 1})
    np.testing.assert_array_equal(mine[4], _rtree(6)["w"])


# ---------------------------------------------------------------------------
# checkpoint repair (tests/test_repair.py)
# ---------------------------------------------------------------------------

def _acked_targets(c, step):
    acks = c.checkpointer.acks(step)
    return {nid: ack_targets(acks[nid].get("replica")) for nid in acks}


def test_checkpoint_repair_restores_replication_factor(tmp_path):
    """Repair after node1's loss: the same report and the same re-acked
    target lists as JAX's (dead targets pruned, the new one added)."""
    def scenario(c):
        c.tiered.save_async(1, _tree(1)).result(timeout=30)
        c.tiered.quiesce()
        c.kill_node("node1")
        before = any(len(h) == 1 for h in
                     _ckpt_copies(c, 1, ["node1"]).values())
        report = c.repair(["node1"])
        return before, _summary(report), _all_two_copies(c, 1, ["node1"]), \
            _acked_targets(c, 1)
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert mine[0] and mine[2]
    assert mine[3]["node0"] == ["node2"]  # node1 pruned, node2 added
    assert mine[1]["checkpoint"] == 2  # the victim's shard + its buddy's
    assert not mine[1]["errors"] and not mine[1]["unrepairable"]


def test_second_loss_of_new_buddy_still_restores(tmp_path):
    t = _tree(2)

    def scenario(c):
        c.tiered.save_async(1, t).result(timeout=30)
        c.tiered.quiesce()
        c.kill_node("node1")
        c.repair(["node1"])
        rec = c.checkpointer.acks(1)["node1"]["replica"]
        new = rec["target"]
        assert [x for x in rec["targets"] if x != new]
        c.kill_node(new)
        out, man = c.checkpointer.restore_latest_recoverable(
            lost_nodes=["node1", new])
        return new, man["step"], dict(c.checkpointer.last_restore_stats), \
            _np(out["x"])
    theirs, mine = _both(tmp_path, scenario)
    assert mine[:3] == theirs[:3]
    assert mine[1:3] == (1, {"skipped_by_ack": 0, "probed": 1})
    np.testing.assert_array_equal(mine[3], t["x"])


def test_unreplicated_step_is_not_repairs_business(tmp_path):
    def scenario(c):
        c.checkpointer.buddy = False
        c.tiered.save_async(1, _tree(3)).result(timeout=30)
        c.tiered.quiesce()
        return _summary(c.repair(["node1"]))
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert mine["checkpoint"] == 0 and not mine["errors"]


@pytest.mark.parametrize("package", ["jax", "port"])
def test_repair_scan_reads_only_the_copies_it_makes(package, tmp_path,
                                                    monkeypatch):
    """Zero blind probes: every object-store access during repair is the
    source of a raw-path copy actually made, and no copy builds a tree
    (a checkpoint and a DLM object; the dataset surface waits for the
    port's catalog)."""
    c = (JSimCluster if package == "jax" else _port)(tmp_path, n_nodes=4)
    mod = jds if package == "jax" else ds
    try:
        c.tiered.save_async(1, _tree(4)).result(timeout=30)
        c.tiered.offload("serve/sess", _tree(5)).result(timeout=30)
        c.tiered.quiesce()
        c.kill_node("node1")
        c.tiered.quiesce()
        reads = _record_store_reads(c)
        copies = []
        orig_copy = mod.copy_object

        def copy_object(src, dst, name, *a, **k):
            copies.append(name)
            return orig_copy(src, dst, name, *a, **k)
        monkeypatch.setattr(mod, "copy_object", copy_object)
        report = c.tiered.repair(["node1"])
        assert report["repaired"] and not report["errors"]
        assert len(copies) == len(report["repaired"]), (copies, report)
        assert reads == [], f"tree reads/probes during repair: {reads}"
        assert all(n.startswith(("ckpt/slot", "replica/", "dlm/"))
                   for n in copies), copies
    finally:
        c.shutdown()


def test_repair_skips_slot_reused_steps_on_metadata(tmp_path):
    def scenario(c):
        for s in (1, 2, 3):
            c.tiered.save_async(s, _tree(s)).result(timeout=30)
        c.tiered.quiesce()
        c.kill_node("node1")
        report = c.repair(["node1"])
        return _summary(report), [_all_two_copies(c, st, ["node1"])
                                  for st in (2, 3)]
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert mine[0]["superseded"] >= 1 and not mine[0]["errors"]
    assert mine[1] == [True, True]


# ---------------------------------------------------------------------------
# DLM objects (tests/test_repair.py)
# ---------------------------------------------------------------------------

def test_offload_records_dlm_ack(tmp_path):
    def scenario(c):
        c.tiered.offload("serve/sess", _tree(7)).result(timeout=30)
        c.tiered.quiesce()
        rec = c.tiered.dlm_acks.objects()["dlm/serve/sess"]
        return rec["home"], rec["targets"]
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == ("node0", ["node1"])


def test_dlm_repair_survives_loss_of_new_buddy(tmp_path):
    t = _tree(8)

    def scenario(c):
        c.tiered.offload("serve/sess", t).result(timeout=30)
        c.tiered.quiesce()
        c.kill_node("node0")
        report = c.repair(["node0"])
        rec = c.tiered.dlm_acks.objects()["dlm/serve/sess"]
        new = [x for x in rec["targets"] if x != "node1"][0]
        c.kill_node(new)
        c.tiered.evict_cold()
        return _summary(report), rec["targets"], _np(
            c.tiered.fetch("serve/sess")["x"])
    theirs, mine = _both(tmp_path, scenario)
    assert mine[:2] == theirs[:2]
    assert mine[0]["repaired"][0][:3] == ("dlm", "dlm/serve/sess", "node1")
    assert len(mine[1]) == 2 and "node1" in mine[1]
    np.testing.assert_array_equal(mine[2], t["x"])


def test_dirty_writeback_refreshes_replica(tmp_path):
    t2 = _tree(10)

    def scenario(c):
        c.tiered.offload("serve/sess", _tree(9)).result(timeout=30)
        c.tiered.quiesce()
        c.dlm.put("serve/sess", t2)
        evicted = c.tiered.evict_cold()
        c.tiered.quiesce()
        c.kill_node("node0")
        return evicted >= 1, _np(c.tiered.fetch("serve/sess")["x"])
    theirs, mine = _both(tmp_path, scenario)
    assert mine[0] and theirs[0]
    np.testing.assert_array_equal(mine[1], t2["x"])


def test_writeback_ack_replaces_stale_targets(tmp_path):
    t2 = _tree(21)

    def scenario(c):
        c.tiered.offload("serve/sess", _tree(20)).result(timeout=30)
        c.tiered.quiesce()
        first = c.tiered.dlm_acks.targets("dlm/serve/sess")
        c.kill_node("node1")
        c.dlm.put("serve/sess", t2)
        evicted = c.tiered.evict_cold()
        c.tiered.quiesce()
        after = c.tiered.dlm_acks.targets("dlm/serve/sess")
        c.kill_node("node0")
        return first, evicted >= 1, after, _np(
            c.tiered.fetch("serve/sess")["x"])
    theirs, mine = _both(tmp_path, scenario)
    assert mine[:3] == theirs[:3] == (["node1"], True, ["node2"])
    np.testing.assert_array_equal(mine[3], t2["x"])


def test_offload_replicate_false_objects_stay_node_local(tmp_path):
    def scenario(c):
        c.tiered.offload("serve/tmp", _tree(11), replicate=False) \
            .result(timeout=30)
        c.tiered.evict_cold()
        c.tiered.quiesce()
        return ("dlm/serve/tmp" in c.tiered.dlm_acks.objects(),
                c.stores["node1"].exists("replica/node0/dlm/serve/tmp"))
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == (False, False)


# ---------------------------------------------------------------------------
# failure recovery (tests/test_repair.py, test_repair_daemon.py,
# test_system.py)
# ---------------------------------------------------------------------------

def test_failure_recovery_runs_repair(tmp_path):
    state = _tree(13)

    def scenario(c):
        c.tiered.save_async(3, state).result(timeout=30)
        c.tiered.quiesce()
        _beat_all(c, 3)
        c.kill_node("node1")
        tree, _, dead = c.recovery.check_and_recover()
        return (dead, c.recovery.last_repair_report["checkpoint"],
                _all_two_copies(c, 3, dead), _np(tree["x"]))
    theirs, mine = _both(tmp_path, scenario)
    assert mine[:3] == theirs[:3] == (["node1"], 2, True)
    np.testing.assert_array_equal(mine[3], state["x"])


def test_failure_recovery_end_to_end(tmp_path):
    """tests/test_system.py's case: node1's heartbeat is gone with its
    pmem, so the monitor sees it dead and restores from the replicas."""
    state = {"w": np.random.RandomState(0).randn(8, 8).astype(np.float32)}

    def scenario(c):
        c.checkpointer.save(3, state)
        c.checkpointer.wait_async()
        _beat_all(c, 3)
        c.kill_node("node1")
        tree, manifest, dead = c.recovery.check_and_recover()
        return dead, manifest["step"], _np(tree["w"])
    theirs, mine = _both(tmp_path, scenario)
    assert mine[:2] == theirs[:2] == (["node1"], 3)
    np.testing.assert_array_equal(mine[2], state["w"])


def test_check_and_recover_only_new_deaths(tmp_path):
    t = _tree(1)

    def scenario(c):
        c.tiered.save_async(1, t).result(timeout=30)
        c.tiered.quiesce()
        _beat_all(c)
        c.kill_node("node1")
        first = c.recovery.check_and_recover()
        again = [c.recovery.check_and_recover() for _ in range(2)]
        c.kill_node("node2")
        second = c.recovery.check_and_recover()
        return first[2], again, sorted(second[2]), _np(second[0]["x"])
    theirs, mine = _both(tmp_path, scenario)
    assert mine[:3] == theirs[:3] == (["node1"], [None, None],
                                      ["node1", "node2"])
    np.testing.assert_array_equal(mine[3], t["x"])


def test_heartbeat_grace_for_unbeaten_node(tmp_path):
    def scenario(c):
        hb, t0 = c.heartbeat, time.time()
        out = [hb.dead_nodes(30.0, now=t0, grace_s=1.0)]
        hb.beat("node0", 1)
        out.append(hb.dead_nodes(30.0, now=t0 + 0.5, grace_s=1.0))
        out.append(hb.dead_nodes(30.0, now=t0 + 2.0, grace_s=1.0))
        return out
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == [[], [], ["node1", "node2", "node3"]]


def test_heartbeat_grace_cleared_by_first_beat(tmp_path):
    def scenario(c):
        t0 = time.time()
        c.heartbeat.dead_nodes(30.0, now=t0, grace_s=1.0)
        _beat_all(c)
        return c.heartbeat.dead_nodes(30.0, now=t0 + 5.0, grace_s=1.0)
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == []


def test_heartbeat_dead_pool_bypasses_grace(tmp_path):
    def scenario(c):
        t0 = time.time()
        c.heartbeat.dead_nodes(30.0, now=t0, grace_s=30.0)
        c.kill_node("node1")
        return c.heartbeat.dead_nodes(30.0, now=t0 + 0.01, grace_s=30.0)
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == ["node1"]


def test_straggler_detector_forget():
    sd = StragglerDetector(threshold=1.5)
    for _ in range(4):
        sd.record("slow", 10.0)
        sd.record("a", 1.0)
        sd.record("b", 1.0)
    assert sd.stragglers() == ["slow"]
    sd.forget("slow")
    assert sd.stragglers() == []
    sd.forget("slow")  # idempotent


def test_straggler_forget_unskews_median():
    sd = StragglerDetector(threshold=1.5)
    for _ in range(4):
        sd.record("fast_dead", 0.1)
        sd.record("fast_dead2", 0.1)
        sd.record("a", 1.0)
        sd.record("b", 1.1)
    assert "b" in sd.stragglers()
    sd.forget("fast_dead")
    sd.forget("fast_dead2")
    assert sd.stragglers() == []


# ---------------------------------------------------------------------------
# the repair daemon and rehydration (tests/test_repair_daemon.py)
# ---------------------------------------------------------------------------

def test_daemon_restores_rf_before_recovery_point(tmp_path):
    def scenario(c):
        c.tiered.save_async(1, _tree(1)).result(timeout=30)
        c.tiered.quiesce()
        _beat_all(c)
        daemon = c.start_repair_daemon(poll_s=0.01)
        c.kill_node("node1")
        assert daemon.wait_for(["node1"], timeout=30)
        r = daemon.report()
        return (r["checkpoint"], len(r["errors"]), r["handled"],
                _all_two_copies(c, 1, ["node1"]))
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == (2, 0, ["node1"], True)


def test_daemon_idempotent_across_polls(tmp_path):
    c = _port(tmp_path, n_nodes=4)
    try:
        c.tiered.save_async(1, _tree(2)).result(timeout=30)
        c.tiered.quiesce()
        _beat_all(c)
        daemon = c.start_repair_daemon(poll_s=0.005)
        c.kill_node("node1")
        assert daemon.wait_for(["node1"], timeout=30)
        sweeps = daemon.report()["sweeps"]
        time.sleep(0.1)  # ~20 more polls
        assert daemon.report()["sweeps"] == sweeps
    finally:
        c.shutdown()
    assert not daemon.running  # shutdown stopped it


def test_drain_rehydration_returns_shard_to_pmem(tmp_path):
    t = _tree(3)

    def scenario(c):
        c.tiered.save_async(1, t, drain=True).result(timeout=30)
        c.tiered.quiesce()
        c.kill_node("node1")
        c.kill_node("node2")
        report = c.repair(["node1", "node2"])
        targets = ack_targets(c.checkpointer.acks(1)["node1"]["replica"])
        out, man = c.checkpointer.restore_latest_recoverable(
            lost_nodes=["node1", "node2"])
        return (_summary(report), targets, man["step"],
                dict(c.checkpointer.last_restore_stats), _np(out["x"]))
    theirs, mine = _both(tmp_path, scenario)
    assert mine[:4] == theirs[:4]
    assert mine[0]["rehydrated"] == 1 and mine[0]["drain_only"] == 0 and \
        mine[0]["unrepairable"] == 0 and not mine[0]["errors"]
    assert mine[1:4] == (["node0", "node3"], 1,
                         {"skipped_by_ack": 0, "probed": 1})
    np.testing.assert_array_equal(mine[4], t["x"])


def test_rehydration_disabled_counts_drain_only(tmp_path):
    def scenario(c):
        c.tiered.save_async(1, _tree(4), drain=True).result(timeout=30)
        c.tiered.quiesce()
        c.kill_node("node1")
        c.kill_node("node2")
        return _summary(c.repair(["node1", "node2"], rehydrate=False))
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert mine["rehydrated"] == 0 and mine["drain_only"] == 1 and \
        mine["unrepairable"] >= 1


@pytest.mark.parametrize("package", ["jax", "port"])
def test_rehydration_scan_zero_blind_probes(package, tmp_path, monkeypatch):
    c = (JSimCluster if package == "jax" else _port)(tmp_path, n_nodes=4)
    mod = jds if package == "jax" else ds
    try:
        c.tiered.save_async(1, _tree(5), drain=True).result(timeout=30)
        c.tiered.quiesce()
        c.kill_node("node1")
        c.kill_node("node2")
        c.tiered.quiesce()
        reads = _record_store_reads(c)
        copies = []
        orig_copy = mod.copy_object

        def copy_object(src, dst, name, *a, **k):
            copies.append(name)
            return orig_copy(src, dst, name, *a, **k)
        monkeypatch.setattr(mod, "copy_object", copy_object)
        ext_reads = []
        orig_ext_get = c.external.get
        c.external.get = lambda name: (ext_reads.append(name),
                                       orig_ext_get(name))[1]
        report = c.repair(["node1", "node2"])
        assert report["rehydrated"] == 1 and not report["errors"]
        assert len(copies) == len(report["repaired"]), (copies, report)
        assert reads == [], f"tree reads/probes during repair: {reads}"
        assert all(n.startswith(("ckpt/slot", "replica/", "dlm/"))
                   for n in copies), copies
        assert ext_reads == ["ckpt_step1_node1"]
    finally:
        c.shutdown()


def test_daemon_rehydrates_drain_only_to_zero(tmp_path):
    def scenario(c):
        c.tiered.save_async(1, _tree(6), drain=True).result(timeout=30)
        c.tiered.quiesce()
        _beat_all(c)
        c.kill_node("node1")
        c.kill_node("node2")
        daemon = c.start_repair_daemon(poll_s=0.01)
        assert daemon.wait_for(["node1", "node2"], timeout=30)
        r = daemon.report()
        return (r["rehydrated"] >= 1, r["drain_only"],
                _all_two_copies(c, 1, ["node1", "node2"]))
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == (True, 0, True)


def test_daemon_sequential_losses_converge(tmp_path):
    def scenario(c):
        c.tiered.save_async(1, _tree(8), drain=True).result(timeout=30)
        c.tiered.quiesce()
        _beat_all(c)
        daemon = c.start_repair_daemon(poll_s=0.01)
        c.kill_node("node1")
        assert daemon.wait_for(["node1"], timeout=30)
        c.kill_node("node2")
        assert daemon.wait_for(["node1", "node2"], timeout=30)
        return (daemon.report()["drain_only"],
                _all_two_copies(c, 1, ["node1", "node2"]))
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == (0, True)


def test_second_loss_mid_sweep_replans(tmp_path):
    """Two losses under a one-transfer budget: the sweep re-plans the
    cumulative dead set from the acks and every acked object ends on two
    live copies (or rehydrated), and the newest step restores."""
    lost = {"node1", "node2"}

    def scenario(c):
        c.tiered.save_async(1, _tree(7), drain=True).result(timeout=30)
        for k in range(6):
            c.tiered.offload(f"serve/s{k}", _tree(10 + k)).result(timeout=30)
        c.tiered.quiesce()
        _beat_all(c)
        daemon = c.start_repair_daemon(poll_s=0.005, max_inflight=1)
        c.kill_node("node1")
        c.kill_node("node2")
        assert daemon.wait_for(sorted(lost), timeout=60)
        dlm_ok = all(len(({r["home"]} | set(ack_targets(r))) - lost) >= 2
                     for r in c.tiered.dlm_acks.objects().values())
        out, man = c.checkpointer.restore_latest_recoverable(
            lost_nodes=sorted(lost))
        return (_all_two_copies(c, 1, lost), dlm_ok, man["step"],
                _np(out["x"]))
    theirs, mine = _both(tmp_path, scenario)
    assert mine[:3] == theirs[:3] == (True, True, 1)
    np.testing.assert_array_equal(mine[3], _tree(7)["x"])


def test_rate_limiter_bounds_concurrent_repair_tasks(tmp_path):
    def scenario(c):
        for k in range(8):
            c.tiered.offload(f"serve/s{k}", _tree(20 + k)).result(timeout=30)
        c.tiered.quiesce()
        c.kill_node("node0")
        c.tiered.quiesce()
        outstanding, peak = [], [0]
        orig = c.scheduler.replicate

        def tracked(*a, **k):
            fut = orig(*a, **k)
            outstanding.append(fut)
            peak[0] = max(peak[0], sum(1 for f in outstanding
                                       if not f.done()))
            return fut
        c.scheduler.replicate = tracked
        report = c.tiered.repair(["node0"], max_inflight=2)
        return (report["dlm"], len(report["errors"]),
                report["peak_inflight"] <= 2, peak[0] <= 2)
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == (8, 0, True, True)


def test_repair_runs_at_background_priority(tmp_path):
    def scenario(c):
        c.tiered.offload("serve/s", _tree(30)).result(timeout=30)
        c.tiered.quiesce()
        c.kill_node("node0")
        c.tiered.quiesce()
        prios = []
        orig = c.scheduler.replicate

        def tracked(*a, **k):
            prios.append(k.get("priority", 2))
            return orig(*a, **k)
        c.scheduler.replicate = tracked
        report = c.tiered.repair(["node0"], priority=4)
        return report["dlm"], prios
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == (1, [4])


def test_check_and_recover_uses_daemon_ledger(tmp_path):
    state = _tree(41)

    def scenario(c):
        c.tiered.save_async(2, state).result(timeout=30)
        c.tiered.quiesce()
        _beat_all(c, step=2)
        daemon = c.start_repair_daemon(poll_s=0.01)
        c.kill_node("node1")
        assert daemon.wait_for(["node1"], timeout=30)
        rescans = []
        orig = c.tiered.repair
        c.tiered.repair = lambda *a, **k: (rescans.append(1),
                                           orig(*a, **k))[1]
        tree, _, dead = c.recovery.check_and_recover()
        rep = c.recovery.last_repair_report
        return (dead, len(rescans), rep.get("sweeps", 0) >= 1,
                rep["checkpoint"], _np(tree["x"]))
    theirs, mine = _both(tmp_path, scenario)
    assert mine[:4] == theirs[:4] == (["node1"], 0, True, 2)
    np.testing.assert_array_equal(mine[4], state["x"])


def test_serve_repair_uses_daemon_ledger(tmp_path):
    def scenario(c):
        c.tiered.offload("serve/sess", _tree(42)).result(timeout=30)
        c.tiered.quiesce()
        _beat_all(c)
        daemon = c.start_repair_daemon(poll_s=0.01)
        c.kill_node("node0")
        assert daemon.wait_for(["node0"], timeout=30)
        cls = JServeEngine if isinstance(c, JSimCluster) else ServeEngine
        eng = cls.__new__(cls)  # wiring only: no model
        eng.tiered = c.tiered
        report = eng.repair(["node0"])
        return report.get("sweeps", 0) >= 1, report["dlm"] >= 1
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == (True, True)


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

def _port_stores(root, lost=()):
    stores = {n: PMemObjectStore(PMemPool(Path(root) / "pmem", n),
                                 device="cpu") for n in NODES}
    for n in lost:
        stores[n].pool.fail()
    return stores


def _jax_stores(root, lost=()):
    stores = {n: JStore(JPool(Path(root) / "pmem", n)) for n in NODES}
    for n in lost:
        stores[n].pool.fail()
    return stores


def _full_and_delta(c):
    base = _ctree(50)
    new = {"layer": {k: v + np.float32(1e-3) for k, v in
                     base["layer"].items()},
           "emb": base["emb"] * np.float32(1.01), "odd": base["odd"]}
    c.tiered.save_async(1, base).result(timeout=30)
    c.tiered.save_async(2, new, base_step=1).result(timeout=30)
    assert c.tiered.quiesce() == []
    return new


def test_jax_checkpoint_restores_in_the_port_around_lost_nodes(tmp_path):
    """JAX saves a full and a delta step; node3 dies; the port restores
    the delta step with ``lost_nodes`` (ranked on JAX's acks, decoded by
    the plain codec) equal to JAX's own restore, bit for bit."""
    c = JSimCluster(tmp_path, n_nodes=4, delta=True)
    try:
        new = _full_and_delta(c)
        c.kill_node("node3")
        theirs, _ = c.checkpointer.restore_latest_recoverable(
            lost_nodes=["node3"])
    finally:
        c.shutdown()
    ck = DistributedCheckpointer(_port_stores(tmp_path, ["node3"]),
                                 delta=True, device="cpu")
    mine, man = ck.restore_latest_recoverable(lost_nodes=["node3"])
    assert man["step"] == 2
    assert dict(ck.last_restore_stats) == {"skipped_by_ack": 0, "probed": 1}
    _assert_tree_equal(mine, theirs)
    assert np.abs(_np(mine["emb"]) - new["emb"]).max() < 1e-3


def _int8_state(seed):
    """A training state with int8 AdamW moments (JAX's init and five
    updates), as numpy."""
    p = {"w": np.random.RandomState(seed).randn(64, 96).astype(np.float32)}
    cfg = jopt.AdamWConfig(lr=1e-2, warmup=1, moments_dtype="int8")
    jp = jax.tree.map(jnp.asarray, p)
    st = jopt.init_opt_state(jp, cfg)
    for i in range(5):
        g = {"w": jnp.asarray(np.random.RandomState(seed + i).randn(64, 96)
                              .astype(np.float32))}
        jp, st, _ = jopt.apply_updates(jp, g, st, cfg)
    return jax.tree.map(np.asarray, {"params": jp, "opt": st})


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_int8_moment_delta_restores_alike_in_both_packages(saver,
                                                           tmp_path):
    """A full and a delta checkpoint of states with int8 moment codes (the
    codes through the delta codec as JAX codes them, through float32),
    saved by either package; node2 dies; both packages restore the delta
    step around it bit for bit alike, int8 leaves int8 and within one
    code plus the tile's scale of the saved state."""
    s1 = _int8_state(60)
    s2 = _int8_state(61)
    s2["opt"]["step"] = np.asarray(s1["opt"]["step"] + 2, np.int32)
    make = JSimCluster if saver == "jax" else _port
    c = make(tmp_path, n_nodes=4, delta=True)
    try:
        c.tiered.save_async(1, s1).result(timeout=30)
        c.tiered.save_async(2, s2, base_step=1).result(timeout=30)
        assert c.tiered.quiesce() == []
        c.kill_node("node2")
    finally:
        c.shutdown()
    jck = JCheckpointer(_jax_stores(tmp_path, ["node2"]), delta=True)
    ck = DistributedCheckpointer(_port_stores(tmp_path, ["node2"]),
                                 delta=True, device="cpu")
    theirs, jman = jck.restore_latest_recoverable(lost_nodes=["node2"])
    mine, man = ck.restore_latest_recoverable(lost_nodes=["node2"])
    assert man["step"] == jman["step"] == 2
    _assert_tree_equal(mine, theirs)
    got = _flat(mine)
    for path, want in _flat(s2).items():
        assert got[path].dtype == want.dtype, path
        if want.dtype == np.int8:
            d = np.abs(got[path].astype(np.int32) - want.astype(np.int32))
            assert d.max() <= 3, path  # one code + scale/2 (scale <= 2)


def test_port_checkpoint_restores_in_jax_around_lost_nodes(tmp_path):
    c = _port(tmp_path, n_nodes=4, delta=True)
    try:
        _full_and_delta(c)
        c.kill_node("node3")
        mine, _ = c.checkpointer.restore_latest_recoverable(
            lost_nodes=["node3"])
    finally:
        c.shutdown()
    jck = JCheckpointer(_jax_stores(tmp_path, ["node3"]), delta=True)
    theirs, man = jck.restore_latest_recoverable(lost_nodes=["node3"])
    assert man["step"] == 2
    _assert_tree_equal(mine, theirs)


@pytest.mark.parametrize("repairer", ["jax", "port"])
def test_a_repair_by_one_package_serves_the_others_restore(repairer,
                                                           tmp_path):
    """A save on one package's cluster, node1 lost and repaired by that
    package; then the new buddy dies too, and the OTHER package's
    checkpointer restores around both losses from the copy repair made
    (its acks say where), decoding on metadata alone."""
    make = JSimCluster if repairer == "jax" else _port
    c = make(tmp_path, n_nodes=4, delta=True)
    try:
        _full_and_delta(c)
        c.kill_node("node1")
        report = c.repair(["node1"])
        assert report["checkpoint"] > 0 and not report["errors"]
        new = c.checkpointer.acks(2)["node1"]["replica"]["target"]
        c.kill_node(new)
        want, _ = c.checkpointer.restore_latest_recoverable(
            lost_nodes=["node1", new])
    finally:
        c.shutdown()
    lost = ["node1", new]
    if repairer == "jax":
        other = DistributedCheckpointer(_port_stores(tmp_path, lost),
                                        delta=True, device="cpu")
    else:
        other = JCheckpointer(_jax_stores(tmp_path, lost), delta=True)
    got, man = other.restore_latest_recoverable(lost_nodes=lost)
    assert man["step"] == 2
    assert dict(other.last_restore_stats) == {"skipped_by_ack": 0,
                                              "probed": 1}
    _assert_tree_equal(got, want)


# ---------------------------------------------------------------------------
# the training loop's fault hook and the CLI
# ---------------------------------------------------------------------------

ARCH = "gemma2-9b"
B, S = 4, 32


@pytest.fixture(scope="module")
def jax_init():
    jcfg = jregistry.get_smoke_config(ARCH)
    return jT.init_params(jax.random.PRNGKey(0), jcfg,
                          jT.ModelRuntime(tp=1, max_seq=S))[0]


def test_loop_fault_at_matches_jax_loop(jax_init, tmp_path):
    """The port's loop with ``fault_at=5`` (6 steps, a full save at 2 and
    deltas at 4 and 6, drains on) against JAX's loop from the same
    JAX-initialised float32 parameters and the same batches: both restore
    step 4 around node3, repair and resume; ``recovered_at`` equal,
    losses within 1e-4 relative (tests/test_torch_train.py's tolerance
    for the loop), the final save DRAINED on both."""
    jcfg = jregistry.get_smoke_config(ARCH)
    cfg = registry.get_smoke_config(ARCH)
    jrt = jT.ModelRuntime(tp=1, attn_impl="blockwise", max_seq=S)
    rt = T.ModelRuntime(tp=1, attn_impl="blockwise", max_seq=S)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jax_init)
    params = bridge.params_from_host(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    adam_j = jopt.AdamWConfig(lr=1e-3, warmup=10)
    adam = opt.AdamWConfig(lr=1e-3, warmup=10)
    kw = dict(steps=6, ckpt_every=2, delta_ckpt=True, drain_every=1)
    jc = JSimCluster(tmp_path / "jax", n_nodes=4, delta=True)
    try:
        jdata = JStagedDataset(jc, jcfg, JShapeConfig("t", S, B, "train"),
                               n_shards=4, seqs_per_shard=16)
        jstate = jloop.run(
            jax.jit(jts.make_train_step(jcfg, jrt, lambda x, kind: x,
                                        adam_j, ce_chunk=16)),
            jparams, jopt.init_opt_state(jparams, adam_j),
            jdata.batches(6), jc, jloop.LoopConfig(**kw), fault_at=5)
    finally:
        jc.shutdown()
    c = _port(tmp_path / "port", n_nodes=4, delta=True)
    try:
        data = StagedDataset(c, cfg, ShapeConfig("t", S, B, "train"),
                             n_shards=4, seqs_per_shard=16)
        state = loop.run(ts.make_train_step(cfg, rt, adam, ce_chunk=16),
                         params, opt.init_opt_state(params, adam),
                         data.batches(6), c, loop.LoopConfig(**kw),
                         fault_at=5)
        assert c.checkpointer.available_steps() == [2, 4, 6]
        assert _all_two_copies(c, 2, ["node3"])
    finally:
        c.shutdown()
    assert state.recovered_at == jstate.recovered_at == [5]
    assert state.step == jstate.step == 6
    np.testing.assert_allclose(state.losses, jstate.losses, rtol=1e-4)
    assert state.final_ckpt_durability == \
        jstate.final_ckpt_durability == "DRAINED"


def test_loop_with_the_repair_daemon(tmp_path):
    """``repair_daemon=True``: the daemon's sweep, not an inline repair,
    restores the replication factor after the fault, and the loop stops
    the daemon at its end."""
    cfg = registry.get_smoke_config(ARCH)
    rt = T.ModelRuntime(tp=1, attn_impl="blockwise", max_seq=S)
    params = T.init_params(cfg, rt, torch.Generator().manual_seed(0),
                           device="cpu")
    adam = opt.AdamWConfig(lr=1e-3, warmup=10, moments_dtype="int8")
    c = _port(tmp_path, n_nodes=4)
    try:
        data = StagedDataset(c, cfg, ShapeConfig("t", S, B, "train"),
                             n_shards=4, seqs_per_shard=16)
        inline = []
        orig = c.tiered.repair
        c.tiered.repair = lambda *a, **k: (inline.append(a), orig(*a, **k))[1]
        state = loop.run(ts.make_train_step(cfg, rt, adam, ce_chunk=16),
                         params, opt.init_opt_state(params, adam),
                         data.batches(4), c,
                         loop.LoopConfig(steps=4, ckpt_every=2,
                                         repair_daemon=True,
                                         daemon_poll_s=0.01), fault_at=3)
        daemon = c.recovery.daemon
        assert state.recovered_at == [3] and np.isfinite(state.losses).all()
        assert daemon.report()["handled"] == ["node3"]
        assert daemon.report()["checkpoint"] > 0
        assert len(inline) == daemon.report()["sweeps"]  # the daemon's own
        assert not daemon.running
    finally:
        c.shutdown()


def test_cli_recovers_from_a_fault_on_cpu(tmp_path, capsys):
    """``--device cpu --smoke --delta-ckpt --fault-at 12``: saves at 5
    (full) and 10 (delta), node3 lost after step 12, step 10 restored
    and the run resumes; the loss still goes down."""
    state = train_cli.main(["--device", "cpu", "--smoke", "--delta-ckpt",
                            "--fault-at", "12", "--root", str(tmp_path)])
    assert state.recovered_at == [12] and state.step == 20
    assert state.losses[-1] < state.losses[0]
    assert "recoveries=[12]" in capsys.readouterr().out
