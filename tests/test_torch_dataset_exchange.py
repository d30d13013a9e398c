"""Port parity: the persistent dataset exchange (catalog, leases, gc,
lineage, the exchange channel in TieredIO), the compute channel and the
Fig. 8 workflow scheduler against the JAX package.

Every case of ``tests/test_dataset_exchange.py`` runs as a scenario on a
JAX ``SimCluster`` and on a port one (``device="cpu"``) with the same
numpy inputs; both must give the same answers (gc verdicts, lineage
chains, records, replayed and skipped jobs, store-read audits). So do
the catalog cases of ``tests/test_meta_log.py``, the dataset and
skewed-clock gc cases of ``tests/test_repair.py``, the workflow resume
of ``tests/test_repair_daemon.py`` and ``tests/test_system.py``, and
``tests/test_tiered_io.py``'s stage-in hit rate. Across packages: a
dataset published by one package is read by the other's catalog over
the same pools with equal lineage and digest (bf16 included), and a
workflow journaled by one package is resumed by the other.
"""
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import ml_dtypes
import numpy as np
import pytest

from repro.core import dataset_exchange as jdx
from repro.core import object_store as jos
from repro.core import workflow as jwf
from repro.core.cluster import SimCluster as JSimCluster
from repro.core.object_store import PMemObjectStore as JStore
from repro.core.pmem import PMemPool as JPool
from repro_torch import bridge
from repro_torch.core import dataset_exchange as dx
from repro_torch.core import object_store as pos
from repro_torch.core import workflow as wf
from repro_torch.core.cluster import SimCluster
from repro_torch.core.data_scheduler import ExternalStore
from repro_torch.core.object_store import PMemObjectStore, is_wire_object
from repro_torch.core.object_store import wire_tree
from repro_torch.core.pmem import PMemPool

NODES = [f"node{i}" for i in range(4)]

# each package's names, so one scenario drives either
PK = {"jax": SimpleNamespace(name="jax", JobSpec=jwf.JobSpec,
                             Catalog=jdx.DatasetCatalog,
                             cache_key=jdx.cache_key,
                             content_digest=jos.content_digest),
      "port": SimpleNamespace(name="port", JobSpec=wf.JobSpec,
                              Catalog=dx.DatasetCatalog,
                              cache_key=dx.cache_key,
                              content_digest=pos.content_digest)}


def _tree(seed=0, n=64):
    return {"x": np.random.RandomState(seed).randn(n).astype(np.float32)}


def _np(x):
    return bridge.to_numpy(x)


def _port(root, **kw):
    return SimCluster(root, device="cpu", **kw)


def _both(tmp_path, scenario, **kw):
    """``scenario(cluster, pk)`` on a JAX and on a port cluster, each shut
    down after: (jax result, port result)."""
    out = []
    for name, make in (("jax", JSimCluster), ("port", _port)):
        c = make(tmp_path / name, **kw)
        try:
            out.append(scenario(c, PK[name]))
        finally:
            c.shutdown()
    return out


def _record_store_reads(cluster):
    """Wrap every store's object-read/probe entry points, recording the
    object names touched (pool JSON, the catalog records and journals,
    stays allowed)."""
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

    for st in cluster.stores.values():
        wrap(st)
    return reads


def _rec_view(rec):
    """A catalog record without its clocks and lease ids."""
    out = {k: rec[k] for k in ("name", "workflow", "version", "object",
                               "home", "nbytes", "digest", "retained",
                               "reclaimed", "lineage")}
    out["targets"] = jdx.ack_targets((rec.get("acks") or {}).get("replica"))
    out["leases"] = sorted((l["owner"], bool(l.get("released")))
                           for l in (rec.get("leases") or {}).values())
    return out


# ---------------------------------------------------------------------------
# catalog: leases, refcount, GC (tests/test_dataset_exchange.py)
# ---------------------------------------------------------------------------

def test_lease_blocks_gc_release_enables_it(tmp_path):
    def scenario(c, pk):
        cat = c.catalog
        cat.publish("ds", _tree(1), workflow="w", retained=False)
        lease = cat.acquire("ds", workflow="w", owner="consumer")
        out = [cat.refcount("ds", "w"), cat.gc(),
               _np(cat.get("ds", "w")["x"]).tolist()]
        cat.release(lease)
        out += [cat.refcount("ds", "w"), cat.gc(),
                cat.record("ds", "w")["reclaimed"]]
        with pytest.raises(KeyError):
            cat.get("ds", "w")
        return out
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert mine[0] == 1 and mine[1] == [] and mine[3] == 0
    assert mine[4] == [("w", "ds", 1)] and mine[5]
    np.testing.assert_array_equal(mine[2], _tree(1)["x"])


def test_expired_lease_is_reclaimed(tmp_path):
    def scenario(c, pk):
        cat = c.catalog
        cat.publish("ds", _tree(2), workflow="w", retained=False)
        cat.acquire("ds", workflow="w", owner="laggard", ttl_s=30.0)
        return [cat.gc(), cat.gc(now=time.time() + 60.0),
                cat.record("ds", "w")["reclaimed"]]
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == [[], [("w", "ds", 1)], True]


def test_retained_dataset_survives_gc_until_unretained(tmp_path):
    def scenario(c, pk):
        cat = c.catalog
        cat.publish("ds", _tree(3), workflow="w", retained=True)
        first = cat.gc()
        cat.unretain("ds", "w")
        return [first, cat.gc()]
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == [[], [("w", "ds", 1)]]


def test_reclaim_terminal_across_stale_pool_copies(tmp_path):
    """A pool that missed the GC write must not resurrect the record."""
    def scenario(c, pk):
        cat = c.catalog
        cat.publish("ds", _tree(4), workflow="w", retained=False)
        cat.gc()
        first = cat.record("ds", "w")["reclaimed"]
        rec = dict(cat.record("ds", "w"))
        rec["reclaimed"] = False
        c.stores["node2"].pool.put_json("exch/w/ds@v1.json", rec)
        return [first, cat.record("ds", "w")["reclaimed"],
                pk.Catalog(c.stores).record("ds", "w")["reclaimed"]]
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == [True, True, True]


# ---------------------------------------------------------------------------
# lineage
# ---------------------------------------------------------------------------

def test_lineage_round_trip_through_workflow(tmp_path):
    def scenario(c, pk):
        c.external.put("raw", _tree(0))

        def prep(ctx):
            return {"clean": {"x": _np(ctx.read("raw")["x"]) * 2}}

        def train(ctx):
            return {"model": {"w": _np(ctx.read("clean")["x"]) + 1}}

        res = c.workflows.run([
            pk.JobSpec("prep", prep, inputs=("raw",), retain=("clean",)),
            pk.JobSpec("train", train, inputs=("clean",), after=("prep",),
                       retain=("model",)),
        ])
        w = res.workflow_id
        # the replicas' acks land on mover threads: join them, so both
        # records hold their acked targets whatever the threads' timing
        c.tiered.quiesce()
        chain = c.catalog.lineage("model", w)
        rec = chain[0]
        man = c.stores[rec["home"]].manifest(rec["object"], rec["version"])
        assert rec["digest"] == pk.content_digest(man)
        return w, [r if "external" in r else _rec_view(r) for r in chain], \
            _np(c.catalog.get("model", w)["w"])
    theirs, mine = _both(tmp_path, scenario)
    assert mine[1] == theirs[1]
    np.testing.assert_array_equal(mine[2], theirs[2])
    w, chain = mine[0], mine[1]
    assert chain[0]["name"] == "model"
    assert chain[0]["lineage"]["job"] == "train"
    assert chain[0]["lineage"]["inputs"] == [["clean", w, 1]]
    assert chain[1]["name"] == "clean"
    assert chain[1]["lineage"]["job"] == "prep"
    assert {"external": "raw"} in chain


def test_lineage_survives_reclaim(tmp_path):
    def scenario(c, pk):
        cat = c.catalog
        cat.publish("a", _tree(1), workflow="w", retained=False)
        cat.publish("b", _tree(2), workflow="w", producer="jb",
                    inputs=[["a", "w", 1]], retained=False)
        c.tiered.quiesce()  # the replica acks land before the sweep
        cat.gc()
        return [_rec_view(r) for r in cat.lineage("b", "w")]
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert [r["name"] for r in mine] == ["b", "a"]
    assert all(r["reclaimed"] for r in mine)


# ---------------------------------------------------------------------------
# placement map durability: replica acks, fallback reads
# ---------------------------------------------------------------------------

def test_replica_fallback_read_after_home_loss(tmp_path):
    def scenario(c, pk):
        cat = c.catalog
        cat.publish("ds", _tree(5), workflow="w")
        c.tiered.quiesce()  # replica placed + acked
        rec = cat.record("ds", "w")
        target = rec["acks"]["replica"]["target"]
        assert target != rec["home"]
        c.kill_node(rec["home"])
        got = _np(cat.get("ds", "w")["x"])
        return rec["home"], target, got.tolist(), cat.stats["replica_reads"]
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    np.testing.assert_array_equal(mine[2], _tree(5)["x"])
    assert mine[3] == 1


def test_recoverable_is_metadata_only(tmp_path):
    def scenario(c, pk):
        cat = c.catalog
        cat.publish("ds", _tree(6), workflow="w")
        c.tiered.quiesce()
        rec = cat.record("ds", "w")
        home, target = rec["home"], rec["acks"]["replica"]["target"]
        reads = _record_store_reads(c)
        out = [cat.recoverable("ds", "w", lost_nodes=[home]),
               cat.recoverable("ds", "w", lost_nodes=[home, target])]
        return out, reads
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == ([True, False], [])


def test_unacked_dataset_not_recoverable_after_home_loss(tmp_path):
    """Replication still in flight (no ack) reads as unrecoverable: the
    catalog under-promises, never over-promises."""
    def scenario(c, pk):
        cat = c.catalog
        cat.exchange = None  # publish without any replica fan-out
        cat.publish("ds", _tree(7), workflow="w")
        rec = cat.record("ds", "w")
        return cat.recoverable("ds", "w", lost_nodes=[rec["home"]])
    theirs, mine = _both(tmp_path, scenario)
    assert mine is theirs is False


# ---------------------------------------------------------------------------
# lease-aware eviction (TieredIO + DLM cache)
# ---------------------------------------------------------------------------

def test_leased_dataset_pinned_through_evict_cold(tmp_path):
    def scenario(c, pk):
        cat, tio = c.catalog, c.tiered
        cat.publish("hot", _tree(8), workflow="w")
        cat.get("hot", "w")  # admitted into the DLM cache
        key = pk.cache_key("w", "hot", 1)
        out = [c.dlm.contains(key)]
        lease = cat.acquire("hot", workflow="w", owner="consumer")
        tio.evict_cold(0.0)
        out.append(c.dlm.contains(key))  # pinned by the live lease
        cat.release(lease)
        tio.evict_cold(0.0)
        out.append(c.dlm.contains(key))
        return out
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == [True, True, False]


def test_reclaim_drops_cache_entry_without_writeback(tmp_path):
    def scenario(c, pk):
        cat = c.catalog
        cat.publish("ds", _tree(9), workflow="w", retained=False)
        cat.get("ds", "w")
        key = pk.cache_key("w", "ds", 1)
        out = [c.dlm.contains(key)]
        cat.gc()
        out.append(c.dlm.contains(key))
        # no resurrection: the cache never wrote dlm/<key> back to pmem
        out.append(c.stores[c.node_ids[0]].exists(f"dlm/{key}"))
        return out
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == [True, False, False]


def test_prefetch_datasets_warms_cache(tmp_path):
    def scenario(c, pk):
        cat, tio = c.catalog, c.tiered
        cat.publish("warm", _tree(10), workflow="w")
        out = tio.prefetch_datasets(["warm", "absent"], "w") \
            .result(timeout=30)
        hit = c.dlm.contains(pk.cache_key("w", "warm", 1))
        out2 = tio.prefetch_datasets(["warm"], "w").result(timeout=30)
        return out, hit, out2, dict(tio.stats)
    theirs, mine = _both(tmp_path, scenario)
    assert mine[:3] == theirs[:3]
    assert mine[0]["loads"] == 1 and mine[0]["missing"] == 1
    assert mine[1] and mine[2]["hits"] == 1
    for k in ("prefetch_hits", "prefetch_loads"):
        assert mine[3][k] == theirs[3][k], k


# ---------------------------------------------------------------------------
# concurrent workflows
# ---------------------------------------------------------------------------

def test_two_workflows_run_concurrently_isolated(tmp_path):
    """Same dataset names in two workflows, run from two threads at once:
    each consumer sees ITS producer's bytes and the catalog keeps
    per-workflow records."""
    def scenario(c, pk):
        results, errors = {}, []

        def make_jobs(tag, scale):
            def produce(ctx):
                return {"data": {"x": np.full(32, float(scale))}}

            def consume(ctx):
                results[tag] = _np(ctx.read("data")["x"]).copy()
                return {"out": {"s": np.array(
                    [_np(ctx.read("data")["x"]).sum()])}}
            return [pk.JobSpec("produce", produce, retain=("data",)),
                    pk.JobSpec("consume", consume, inputs=("data",),
                               after=("produce",), retain=("out",))]

        def go(tag, scale):
            try:
                c.workflows.run(make_jobs(tag, scale), workflow=tag)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        t1 = threading.Thread(target=go, args=("wfA", 3))
        t2 = threading.Thread(target=go, args=("wfB", 7))
        t1.start(); t2.start(); t1.join(timeout=60); t2.join(timeout=60)
        assert not errors
        return (results["wfA"].tolist(), results["wfB"].tolist(),
                c.catalog.record("data", "wfA")["workflow"],
                c.catalog.record("data", "wfB")["workflow"],
                float(_np(c.catalog.get("out", "wfA")["s"])[0]),
                float(_np(c.catalog.get("out", "wfB")["s"])[0]))
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert mine[0] == [3.0] * 32 and mine[1] == [7.0] * 32
    assert mine[2:] == ("wfA", "wfB", 96.0, 224.0)


def test_independent_branches_overlap(tmp_path):
    """Ready jobs dispatch onto DataScheduler workers in parallel: two
    input-free branches overlap in time."""
    def scenario(c, pk):
        spans = {}

        def branch(tag):
            def fn(ctx):
                t0 = time.time()
                time.sleep(0.25)
                spans[tag] = (t0, time.time())
                return {f"out_{tag}": {"x": np.ones(4)}}
            return fn

        c.workflows.run([pk.JobSpec("b1", branch("b1")),
                         pk.JobSpec("b2", branch("b2"))])
        (s1, e1), (s2, e2) = spans["b1"], spans["b2"]
        return max(s1, s2) < min(e1, e2)
    theirs, mine = _both(tmp_path, scenario)
    assert mine is theirs is True, "branches never overlapped"


def test_sibling_jobs_placed_on_one_node_overlap(tmp_path):
    """Two ready jobs reading the same input land on its node (byte
    affinity) and still overlap: the port's scheduler steals a node's
    lone queued task while that node's worker is busy (JAX's steals only
    from a queue deeper than one, so there the second job may wait for
    the first: the Fig. 8 pipeline's train and stats branches)."""
    c = _port(tmp_path)
    try:
        c.stores["node1"].put("big", {"x": np.zeros(4096)})
        spans = {}

        def branch(tag):
            def fn(ctx):
                t0 = time.time()
                time.sleep(0.3)
                spans[tag] = (t0, time.time(), ctx.nodes)
                return {}
            return fn

        for _ in range(3):
            c.workflows.run([wf.JobSpec("a", branch("a"), inputs=("big",)),
                             wf.JobSpec("b", branch("b"), inputs=("big",))])
            (s1, e1, n1), (s2, e2, n2) = spans["a"], spans["b"]
            assert n1 == n2 == ["node1"]
            assert max(s1, s2) < min(e1, e2), "siblings never overlapped"
    finally:
        c.shutdown()


def test_serial_mode_never_overlaps(tmp_path):
    def scenario(c, pk):
        running, overlap = [], []

        def fn(ctx):
            running.append(1)
            if len(running) - len(overlap) > 1:
                overlap.append(1)
            time.sleep(0.05)
            running.pop()
            return {}

        c.workflows.run([pk.JobSpec(f"j{i}", fn) for i in range(4)],
                        max_concurrent=1)
        return overlap
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == []


# ---------------------------------------------------------------------------
# journal + resume after node loss
# ---------------------------------------------------------------------------

def _pinned_jobs(c, pk, calls):
    """Two independent producers pinned to different homes via pre-placed
    inputs, plus a sink consuming both (the inputs are on the external
    store too, so a replayed job can stage them back in)."""
    c.stores["node0"].put("seed_a", _tree(1))
    c.stores["node2"].put("seed_b", _tree(2))
    c.external.put("seed_a", _tree(1))
    c.external.put("seed_b", _tree(2))
    return _jobs(pk, calls)


def _jobs(pk, calls):
    def mk(tag, out, inputs):
        def fn(ctx):
            calls[tag] += 1
            for i in inputs:
                ctx.read(i)
            return {out: _tree(sum(map(ord, tag)) % 100)}
        return fn

    return [
        pk.JobSpec("pa", mk("pa", "da", ("seed_a",)), inputs=("seed_a",),
                   retain=("da",)),
        pk.JobSpec("pb", mk("pb", "db", ("seed_b",)), inputs=("seed_b",),
                   retain=("db",)),
        pk.JobSpec("sink", mk("sink", "dc", ("da", "db")),
                   inputs=("da", "db"), after=("pa", "pb"), retain=("dc",)),
    ]


def test_resume_replays_only_ack_unrecoverable_jobs(tmp_path):
    def scenario(c, pk):
        calls = {"pa": 0, "pb": 0, "sink": 0}
        jobs = _pinned_jobs(c, pk, calls)
        c.workflows.run(jobs, workflow="wfR")
        c.tiered.quiesce()  # replica acks land
        first = dict(calls)
        rec_b = c.catalog.record("db", "wfR")
        dead = {rec_b["home"], rec_b["acks"]["replica"]["target"]}
        for name in ("da", "dc"):
            rec = c.catalog.record(name, "wfR")
            assert not ({rec["home"],
                         rec["acks"]["replica"]["target"]} <= dead)
        for nid in dead:
            c.kill_node(nid)
        res2 = c.workflows.resume(jobs, "wfR", lost_nodes=sorted(dead))
        return (first, dict(calls), sorted(res2.skipped), res2.replayed,
                c.catalog.record("db", "wfR")["version"], sorted(dead))
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert mine[0] == {"pa": 1, "pb": 1, "sink": 1}
    assert mine[1] == {"pa": 1, "pb": 2, "sink": 1}  # ONLY pb re-invoked
    assert mine[2] == ["pa", "sink"] and mine[3] == ["pb"]
    assert mine[4] == 2


def test_resume_decision_makes_zero_object_store_probes(tmp_path):
    def scenario(c, pk):
        calls = {"pa": 0, "pb": 0, "sink": 0}
        jobs = _pinned_jobs(c, pk, calls)
        c.workflows.run(jobs, workflow="wfZ")
        c.tiered.quiesce()
        victim = c.catalog.record("db", "wfZ")["home"]
        c.kill_node(victim)
        reads = _record_store_reads(c)
        res = c.workflows.resume(jobs, "wfZ", lost_nodes=[victim],
                                 repair=False)
        return dict(calls), sorted(res.skipped), reads
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert mine == ({"pa": 1, "pb": 1, "sink": 1}, ["pa", "pb", "sink"], [])


def test_journal_survives_node0_loss(tmp_path):
    def scenario(c, pk):
        calls = {"pa": 0, "pb": 0, "sink": 0}
        c.workflows.run(_pinned_jobs(c, pk, calls), workflow="wfJ")
        c.kill_node("node0")
        j = c.workflows.journal("wfJ")
        return j["status"], sorted(j["jobs"]), \
            {k: sorted(e["outputs"].items()) for k, e in j["jobs"].items()}
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert mine[0] == "done" and mine[1] == ["pa", "pb", "sink"]


def test_failed_final_drain_fails_workflow(tmp_path):
    """Drain futures are joined at the end of run: a failed final-output
    drain fails the workflow instead of vanishing."""
    def scenario(c, pk):
        def boom(name, tree):
            raise IOError("external store died mid-drain")
        c.external.put = boom

        def job(ctx):
            return {"report": {"x": np.ones(4)}}

        with pytest.raises(RuntimeError, match="drain of final output"):
            c.workflows.run([pk.JobSpec("j", job, drain=("report",))])
        return c.workflows.journal("wf0")["status"]
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == "failed"


def test_byte_weighted_placement(tmp_path):
    """_place weights affinity by object BYTES: one big input on node3
    outranks two small ones on node1."""
    def scenario(c, pk):
        c.stores["node3"].put("big", {"x": np.zeros(4096)})
        c.stores["node1"].put("small1", {"x": np.zeros(4)})
        c.stores["node1"].put("small2", {"x": np.zeros(4)})
        placed = {}

        def job(ctx):
            placed["nodes"] = ctx.nodes
            return {}

        c.workflows.run([pk.JobSpec("j", job,
                                    inputs=("big", "small1", "small2"))])
        return placed["nodes"]
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == ["node3"]


# ---------------------------------------------------------------------------
# the catalog on the MetaLog (tests/test_meta_log.py)
# ---------------------------------------------------------------------------

def test_catalog_merge_tolerates_torn_legacy_copy(tmp_path):
    """One pool holding half a legacy JSON record must not poison the
    cross-pool merge: the readable copies win."""
    def scenario(c, pk):
        rec = {"workflow": "w", "name": "ds", "version": 1, "object": "o",
               "nbytes": 4, "home": "node1", "placement": ["node1"],
               "ts": 5.0, "leases": {}, "retained": True,
               "reclaimed": False, "acks": {}}
        rname = "exch/w/ds@v1.json"
        for nid in c.node_ids:
            c.pools[nid].put_json(rname, rec)
        path = c.pools["node0"]._path(rname)
        path.write_text(path.read_text()[: len(path.read_text()) // 2])
        merged = pk.Catalog(c.stores).record("ds", "w")
        return merged["nbytes"], merged["home"]
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == (4, "node1")


def test_concurrent_acquire_release_loses_no_lease_events(tmp_path):
    """Racing acquire/release threads balance exactly through the log:
    refcount 0 at the end, 40 distinct leases, still acquirable."""
    def scenario(c, pk):
        cat = c.catalog
        rec = cat.publish("ds", b"\x00" * 64, workflow="w", node="node0")
        errors = []

        def worker(i):
            try:
                for _ in range(10):
                    lease = cat.acquire("ds", workflow="w", owner=f"t{i}",
                                        ttl_s=60.0)
                    cat.release(lease)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        head = cat.record("ds", "w", rec["version"])
        live = [l for l in head["leases"].values() if not l.get("released")]
        out = [cat.refcount("ds", "w", rec["version"]), len(live),
               len(head["leases"])]
        lease = cat.acquire("ds", workflow="w", owner="after")
        out.append(cat.refcount("ds", "w", rec["version"]))
        cat.release(lease)
        return out
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == [0, 0, 40, 1]


def test_log_backed_record_replays_identically_in_fresh_catalog(tmp_path):
    """The state a fresh catalog replays from the log equals the live
    writer's head state (acks, leases, tombstones)."""
    def scenario(c, pk):
        cat = c.catalog
        cat.publish("ds", b"\x01" * 32, workflow="w", node="node0")
        lease = cat.acquire("ds", workflow="w", owner="me", ttl_s=60.0)
        cat.release(lease)
        cat.unretain("ds", "w")
        c.tiered.quiesce()
        head = cat.record("ds", "w")
        fresh = pk.Catalog(c.stores).record("ds", "w")
        assert fresh == head
        assert head["leases"][lease.lease_id]["released"] is True
        return _rec_view(fresh)
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert mine["retained"] is False


# ---------------------------------------------------------------------------
# datasets: repair, resume across two losses, tombstones, skewed clocks
# (tests/test_repair.py, tests/test_repair_daemon.py)
# ---------------------------------------------------------------------------

def test_dataset_repair_restores_replication_factor(tmp_path):
    def scenario(c, pk):
        c.catalog.publish("ds", _tree(12), workflow="w")
        c.tiered.quiesce()
        rec = c.catalog.record("ds", "w")
        home, target = rec["home"], rec["acks"]["replica"]["target"]
        c.kill_node(home)
        report = c.repair([home])
        targets = jdx.ack_targets(c.catalog.record("ds", "w")["acks"]
                                  ["replica"])
        new = [x for x in targets if x != target][0]
        c.kill_node(new)
        reads = _record_store_reads(c)
        ok = c.catalog.recoverable("ds", "w", lost_nodes=[home, new])
        no_reads = list(reads)
        got = _np(c.catalog.get("ds", "w")["x"])
        return (report["dataset"], [tuple(r) for r in report["repaired"]],
                targets, ok, no_reads, got.tolist())
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert mine[0] == 1 and len(mine[2]) == 2 and mine[3] and mine[4] == []
    np.testing.assert_array_equal(mine[5], _tree(12)["x"])


def test_resume_repairs_then_second_loss_replays_nothing(tmp_path):
    """Run, lose a node, resume (repair wired in, zero replays), lose the
    NEW buddy of a repaired dataset, resume again: still zero replays,
    decided on acks."""
    def scenario(c, pk):
        calls = {"pa": 0, "pb": 0, "sink": 0}
        jobs = _pinned_jobs(c, pk, calls)
        c.workflows.run(jobs, workflow="wfT")
        c.tiered.quiesce()
        victim = c.catalog.record("db", "wfT")["home"]
        c.kill_node(victim)
        res = c.workflows.resume(jobs, "wfT", lost_nodes=[victim])
        holders = {}
        for name in ("da", "db", "dc"):
            rec = c.catalog.record(name, "wfT")
            h = set(jdx.ack_targets(rec["acks"]["replica"]))
            h.add(rec["home"])
            holders[name] = sorted(h - {victim})
        rec = c.catalog.record("db", "wfT")
        second = [t for t in jdx.ack_targets(rec["acks"]["replica"])
                  if t != victim][-1]
        c.kill_node(second)
        res2 = c.workflows.resume(jobs, "wfT", lost_nodes=[victim, second])
        return (dict(calls), res.repair_report["dataset"], holders,
                sorted(res2.skipped), res2.replayed)
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert mine[0] == {"pa": 1, "pb": 1, "sink": 1}
    assert mine[1] >= 1 and all(len(h) >= 2 for h in mine[2].values())
    assert mine[3] == ["pa", "pb", "sink"] and mine[4] == []


def test_released_lease_does_not_resurrect_from_stale_pool(tmp_path):
    """A pool that missed the release write holds the lease live; a FRESH
    catalog lets the release win, and gc reclaims."""
    def scenario(c, pk):
        cat = c.catalog
        cat.publish("ds", _tree(14), workflow="w", retained=False)
        lease = cat.acquire("ds", workflow="w", owner="consumer",
                            ttl_s=3600.0)
        stale = dict(c.stores["node2"].pool.get_json("exch/w/ds@v1.json"))
        cat.release(lease)
        c.stores["node2"].pool.put_json("exch/w/ds@v1.json", stale)
        fresh = pk.Catalog(c.stores)
        return fresh.refcount("ds", "w"), fresh.gc()
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == (0, [("w", "ds", 1)])


def test_release_tombstone_pruned_after_expiry(tmp_path):
    def scenario(c, pk):
        cat = c.catalog
        cat.publish("ds", _tree(15), workflow="w", retained=True)
        lease = cat.acquire("ds", workflow="w", owner="c", ttl_s=30.0)
        cat.release(lease)
        cat.gc()  # the unexpired tombstone survives the sweep
        kept = cat.record("ds", "w")["leases"][lease.lease_id]["released"]
        cat.gc(now=time.time() + 30.0 + cat.clock_skew_s + 1.0)
        return kept, cat.record("ds", "w")["leases"]
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == (True, {})


def test_gc_skew_margin_defers_reclaim(tmp_path):
    """A lease just past ITS producer's expiry survives gc on a consumer
    whose clock may be ahead, until the skew margin passes."""
    def scenario(c, pk):
        cat = pk.Catalog(c.stores, clock_skew_s=5.0)
        cat.publish("ds", _tree(16), workflow="w", retained=False)
        cat.acquire("ds", workflow="w", owner="c", ttl_s=10.0)
        t0 = time.time()
        return [cat.gc(now=t0 + 11.0), cat.record("ds", "w")["reclaimed"],
                cat.gc(now=t0 + 16.0)]
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == [[], False, [("w", "ds", 1)]]


def test_gc_skew_configurable_per_call(tmp_path):
    def scenario(c, pk):
        cat = pk.Catalog(c.stores, clock_skew_s=60.0)
        cat.publish("ds", _tree(17), workflow="w", retained=False)
        cat.acquire("ds", workflow="w", owner="c", ttl_s=10.0)
        t0 = time.time()
        return [cat.gc(now=t0 + 20.0), cat.gc(now=t0 + 20.0, skew_s=0.0)]
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == [[], [("w", "ds", 1)]]


def test_resume_consults_daemon_ledger(tmp_path):
    def scenario(c, pk):
        calls = {"n": 0}

        def fn(ctx):
            calls["n"] += 1
            return {"da": _tree(40)}
        jobs = [pk.JobSpec("p", fn, retain=("da",))]
        c.workflows.run(jobs, workflow="wfD")
        c.tiered.quiesce()
        for nid in c.node_ids:
            c.heartbeat.beat(nid, 1)
        victim = c.catalog.record("da", "wfD")["home"]
        daemon = c.start_repair_daemon(poll_s=0.01)
        c.kill_node(victim)
        assert daemon.wait_for([victim], timeout=30)
        rescans = {"n": 0}
        orig = c.tiered.repair

        def counted(*a, **k):
            rescans["n"] += 1
            return orig(*a, **k)
        c.tiered.repair = counted
        res = c.workflows.resume(jobs, "wfD", lost_nodes=[victim])
        rec = c.catalog.record("da", "wfD")
        holders = ({rec["home"]} | set(jdx.ack_targets(
            rec["acks"]["replica"]))) - {victim}
        return (rescans["n"], res.repair_report.get("sweeps", 0) >= 1,
                calls["n"], res.replayed, len(holders) >= 2)
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == (0, True, 1, [], True)


# ---------------------------------------------------------------------------
# the Fig. 8 lifecycle (tests/test_system.py) and stage-in
# (tests/test_tiered_io.py)
# ---------------------------------------------------------------------------

def _external_tree(obj):
    if is_wire_object(obj):
        return wire_tree(obj, device="cpu")
    return obj


def test_fig8_sequence_end_to_end(tmp_path):
    """stage-in -> run -> retain -> in-situ reuse -> drain, asserted on
    the scheduler's event log; the drained report lands externally."""
    def scenario(c, pk):
        c.external.put("input_data", {"x": np.arange(100.0)})

        def sim(ctx):
            return {"fields": {"u": _np(ctx.read("input_data")["x"]) * 2.0}}

        def analyze(ctx):
            f = _np(ctx.read("fields")["u"])
            return {"report": {"mean": np.array([f.mean()])}}

        c.workflows.run([
            pk.JobSpec("sim", sim, inputs=("input_data",),
                       retain=("fields",)),
            pk.JobSpec("analyze", analyze, inputs=("fields",),
                       after=("sim",), drain=("report",)),
        ])
        kinds = [k for _, k, _ in c.workflows.events]
        order = kinds.index("stage_in") < kinds.index("in_situ") < \
            kinds.index("drain")
        for _ in range(100):
            if c.external.exists("report"):
                break
            time.sleep(0.02)
        rep = _external_tree(ExternalStore(c.external.root).get("report"))
        return kinds, order, float(_np(rep["mean"])[0])
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert mine[1] and abs(mine[2] - 99.0) < 1e-6


def test_data_affinity_placement(tmp_path):
    def scenario(c, pk):
        c.stores["node2"].put("big_input", {"x": np.zeros(16)})
        placed = {}

        def job(ctx):
            placed["nodes"] = ctx.nodes
            return {}

        c.workflows.run([pk.JobSpec("j", job, inputs=("big_input",))])
        return placed["nodes"]
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == ["node2"]


def test_cleanup_reclaims_unretained(tmp_path):
    """cleanup() is the catalog's refcount/lease GC: unretained bytes are
    reclaimed, the record (lineage) survives."""
    def scenario(c, pk):
        def job(ctx):
            return {"scratch": {"x": np.ones(4)}}

        res = c.workflows.run([pk.JobSpec("j", job)])
        w = res.workflow_id
        rec = c.catalog.record("scratch", w)
        before = c.view.locate(rec["object"], rec["version"])
        c.workflows.cleanup()
        rec = c.catalog.record("scratch", w)
        after = c.view.locate(rec["object"], rec["version"])
        chain = c.catalog.lineage("scratch", w)
        return (bool(before), rec["reclaimed"], after,
                chain[0]["lineage"]["job"])
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == (True, True, [], "j")


def test_stage_in_hit_rate(tmp_path):
    def scenario(c, pk):
        for i in range(3):
            c.external.put(f"shard{i}", {"x": np.arange(i + 1)})
        for names in (["shard0", "shard1"],
                      ["shard0", "shard1", "shard2"]):
            for f in c.tiered.stage_in("node0", names):
                f.result(timeout=30)
        return (c.tiered.stats["stage_in_hits"],
                c.tiered.stats["stage_in_loads"],
                c.tiered.stage_in_hit_rate(),
                _np(c.stores["node0"].get("staged/shard2")["x"]).tolist())
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert mine[:2] == (2, 3) and abs(mine[2] - 0.4) < 1e-9


# ---------------------------------------------------------------------------
# across packages: datasets and journals written by one, read by the other
# ---------------------------------------------------------------------------

def _port_stores(root):
    return {n: PMemObjectStore(PMemPool(Path(root) / "pmem", n),
                               device="cpu") for n in NODES}


def _jax_stores(root):
    return {n: JStore(JPool(Path(root) / "pmem", n)) for n in NODES}


def _mixed_tree(seed):
    """float32, int32 and bf16 leaves (bf16 is ml_dtypes in JAX, a
    ``torch.bfloat16`` tensor in the port: the digest must not care)."""
    r = np.random.default_rng(seed)
    return {"w": r.standard_normal((16, 8)).astype(np.float32),
            "ids": np.arange(12, dtype=np.int32),
            "kv": r.standard_normal((4, 32)).astype(ml_dtypes.bfloat16)}


def _publish_chain(c):
    c.catalog.publish("raw", _mixed_tree(1), workflow="x", producer="a",
                      inputs=[[jdx.EXTERNAL_INPUT, "corpus", 0]])
    c.catalog.publish("out", bridge.tree_map(bridge.to_torch,
                                             _mixed_tree(2))
                      if isinstance(c, SimCluster) else _mixed_tree(2),
                      workflow="x", producer="b", inputs=[["raw", "x", 1]])
    c.tiered.quiesce()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dataset_published_by_one_package_reads_in_the_other(writer,
                                                             tmp_path):
    """Lineage, digests and bytes of a catalog written by one package,
    read by the other's catalog over the same pools; the digest the
    reader computes from its own manifest read equals the record's."""
    make = JSimCluster if writer == "jax" else _port
    c = make(tmp_path)
    try:
        _publish_chain(c)
        want = [r if "external" in r else _rec_view(r)
                for r in c.catalog.lineage("out", "x")]
    finally:
        c.shutdown()
    if writer == "jax":
        reader, digest = dx.DatasetCatalog(_port_stores(tmp_path)), \
            pos.content_digest
    else:
        reader, digest = jdx.DatasetCatalog(_jax_stores(tmp_path)), \
            jos.content_digest
    got = [r if "external" in r else _rec_view(r)
           for r in reader.lineage("out", "x")]
    assert got == want
    assert [r.get("name") for r in got] == ["out", "raw", None]
    assert got[-1] == {"external": "corpus"}
    for rec, seed in zip(reader.lineage("out", "x")[:2], (2, 1)):
        man = reader.stores[rec["home"]].manifest(rec["object"],
                                                  rec["version"])
        assert digest(man) == rec["digest"]
        tree = reader.get(rec["name"], "x")
        for path, leaf in _mixed_tree(seed).items():
            assert _np(tree[path]).tobytes() == _np(leaf).tobytes(), path
    assert reader.recoverable("out", "x", lost_nodes=[want[0]["home"]])


def test_digest_equal_across_packages_bf16_included(tmp_path):
    """The same tree published by each package gets the same content
    digest (bf16 as ml_dtypes and as torch.bfloat16)."""
    digests = []
    for name, make in (("jax", JSimCluster), ("port", _port)):
        c = make(tmp_path / name)
        try:
            tree = _mixed_tree(3) if name == "jax" else \
                bridge.tree_map(bridge.to_torch, _mixed_tree(3))
            digests.append(c.catalog.publish("d", tree, workflow="w")
                           ["digest"])
        finally:
            c.shutdown()
    assert digests[0] == digests[1]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_workflow_journaled_by_one_package_resumes_in_the_other(writer,
                                                                tmp_path):
    """A workflow run and journaled by one package, then a node loss: the
    other package's scheduler resumes it from the journal and the
    catalog acks, replaying exactly what the writer's own resume
    would."""
    jpk, ppk = PK["jax"], PK["port"]
    wpk, rpk = (jpk, ppk) if writer == "jax" else (ppk, jpk)
    make_w = JSimCluster if writer == "jax" else _port
    make_r = _port if writer == "jax" else JSimCluster
    c = make_w(tmp_path)
    calls = {"pa": 0, "pb": 0, "sink": 0}
    try:
        c.workflows.run(_pinned_jobs(c, wpk, calls), workflow="wfX")
        c.tiered.quiesce()
        rec_b = c.catalog.record("db", "wfX")
        dead = sorted({rec_b["home"], rec_b["acks"]["replica"]["target"]})
    finally:
        c.shutdown()
    r = make_r(tmp_path)
    try:
        for nid in dead:
            r.kill_node(nid)
        res = r.workflows.resume(_jobs(rpk, calls), "wfX", lost_nodes=dead)
        assert calls == {"pa": 1, "pb": 2, "sink": 1}
        assert sorted(res.skipped) == ["pa", "sink"]
        assert res.replayed == ["pb"]
        assert r.catalog.record("db", "wfX")["version"] == 2
        assert r.workflows.journal("wfX")["status"] == "done"
    finally:
        r.shutdown()
