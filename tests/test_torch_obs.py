"""Port parity: the telemetry plane (trace spans, the pmem flight
recorder, the post-crash report) against the JAX package.

The flight ring is byte for byte JAX's: the same events with explicit
timestamps give the same slots, and each package replays the other's
ring. Wrap-around, reopen and the dead-pool drop behave alike; a torn
tail (a slot written past the committed tail, a tail not yet flushed)
replays to a committed prefix in both, for every crash point; and
``build_traces`` gives the same trees from the same events. Then JAX's
scenarios of ``tests/test_obs.py`` run on a JAX and a port
``SimCluster`` (the port with ``device="cpu"``) from the same numpy
inputs: trace ids are random, so the span trees are compared by
structure (span names, parent-name edges, roots, point events), the
trace ids by where they land (ack records, session records). Each
package's report CLI reads a pmem root the other wrote, a clean shutdown
writes the same metric names and counts, and a session suspended by one
package is adopted by the other inside the same trace.
"""
import json
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.core.cluster import SimCluster as JSimCluster
from repro.core.pmem import PMemPool as JPool
from repro.core.workflow import JobSpec as JJobSpec
from repro.obs import recorder as jrecorder
from repro.obs import report as jreport
from repro.obs import trace as jtrace
from repro_torch.core.cluster import SimCluster
from repro_torch.core.pmem import PMemPool
from repro_torch.core.workflow import JobSpec
from repro_torch.obs import recorder
from repro_torch.obs import report
from repro_torch.obs import trace
from repro_torch.obs.plane import TelemetryPlane

jax.config.update("jax_platform_name", "cpu")

REPO = Path(__file__).resolve().parents[1]


def _port_cluster(root, **kw):
    return SimCluster(root, device="cpu", **kw)


PK = {"jax": SimpleNamespace(Pool=JPool, Recorder=jrecorder.FlightRecorder,
                             trace=jtrace, report=jreport,
                             Cluster=JSimCluster, JobSpec=JJobSpec),
      "port": SimpleNamespace(Pool=PMemPool,
                              Recorder=recorder.FlightRecorder,
                              trace=trace, report=report,
                              Cluster=_port_cluster, JobSpec=JobSpec)}
BOTH = ["jax", "port"]

# events with explicit timestamps: a long name (cut at 64 bytes),
# unicode, nested attrs, attrs too large for the slot (dropped, the event
# kept), begin/end pairs and untraced points
EVENTS = [
    (recorder.EVT_BEGIN, "ckpt.save", dict(ts=1.5e9, trace=11, span=21,
                                           attrs={"step": 3, "drain": True})),
    (recorder.EVT_POINT, "ckpt.ack.replica", dict(ts=1.5e9 + 0.25, trace=11,
                                                  parent=21,
                                                  attrs={"step": 3})),
    (recorder.EVT_POINT, "x" * 90, dict(ts=1.5e9 + 0.5)),
    (recorder.EVT_POINT, "wf.launch", dict(ts=1.5e9 + 0.75,
                                           attrs={"detail": "wf0:p ü",
                                                  "lost": ["node1", "node2"],
                                                  "f": 0.125})),
    (recorder.EVT_POINT, "big", dict(ts=1.5e9 + 1.0,
                                     attrs={"blob": "y" * 400})),
    (recorder.EVT_END, "ckpt.save", dict(ts=1.5e9 + 2.0, trace=11, span=21,
                                         attrs={"status": "ok", "slot": 1})),
]


def _record(pk, pool, events=EVENTS, **kw):
    rec = pk.Recorder(pool, **kw)
    for kind, name, kwargs in events:
        assert rec.record(kind, name, **kwargs)
    return rec


def _ring_bytes(pool):
    region = pool.open("obs/flightring")
    return bytes(region.read(0, region.nbytes))


def _replay_cluster(c, pk):
    """Every ring of a cluster, replayed by ``pk``'s recorder and tagged
    with its node."""
    events = []
    for nid, pool in c.pools.items():
        for ev in pk.Recorder.replay(pool):
            ev["node"] = nid
            events.append(ev)
    return events


def _structure(tr):
    """A span tree without its random ids: span names, parent-name
    edges, root names and point-event names (multisets)."""
    spans = tr["spans"]
    edges = Counter((spans[sp["parent"]]["name"] if sp["parent"] in spans
                     else None, sp["name"]) for sp in spans.values())
    return {"spans": sorted(sp["name"] for sp in spans.values()),
            "edges": sorted(edges.items(), key=repr),
            "roots": sorted(spans[r]["name"] for r in tr["roots"]),
            "points": sorted(ev["name"] for ev in tr["points"])}


def _traces_rooted_at(traces, name):
    return {tid: tr for tid, tr in traces.items()
            if tid and any(tr["spans"][r]["name"] == name
                           for r in tr["roots"])}


def _both(tmp_path, scenario, **kw):
    """``scenario(cluster, pk)`` on a JAX and on a port 4-node cluster,
    each shut down after: (jax result, port result)."""
    out = []
    for name in BOTH:
        pk = PK[name]
        c = pk.Cluster(tmp_path / name, **{"n_nodes": 4, **kw})
        try:
            out.append(scenario(c, pk))
        finally:
            c.shutdown()
    return out


def _settle(c):
    c.tiered.quiesce()
    c.checkpointer.wait_async()


# ---------------------------------------------------------------------------
# (a) ring bytes, and each package replays the other's ring
# ---------------------------------------------------------------------------

def test_ring_bytes_are_jax_bytes(tmp_path):
    jpool = JPool(tmp_path / "jax", "node0")
    ppool = PMemPool(tmp_path / "port", "node0")
    _record(PK["jax"], jpool)
    _record(PK["port"], ppool)
    jb, pb = _ring_bytes(jpool), _ring_bytes(ppool)
    assert len(jb) == len(pb) == recorder.HDR_SIZE + \
        recorder.DEFAULT_SLOTS * recorder.DEFAULT_SLOT_BYTES
    # the header differs only in its creation epoch (seconds, bytes
    # 32:40); the committed tail sits at byte 8
    assert jb[:32] == pb[:32] and jb[40:] == pb[40:]
    tail = int.from_bytes(pb[8:16], "little")
    assert tail == recorder.HDR_SIZE + len(EVENTS) * \
        recorder.DEFAULT_SLOT_BYTES


@pytest.mark.parametrize("writer", BOTH)
def test_each_package_replays_the_others_ring(writer, tmp_path):
    wpk = PK[writer]
    rpk = PK["port" if writer == "jax" else "jax"]
    pool = wpk.Pool(tmp_path, "node0")
    _record(wpk, pool)
    mine = rpk.Recorder.replay(rpk.Pool(tmp_path, "node0"))
    theirs = wpk.Recorder.replay(pool)
    assert mine == theirs
    assert [e["name"] for e in mine] == [
        "ckpt.save", "ckpt.ack.replica", "x" * 64, "wf.launch", "big",
        "ckpt.save"]
    assert mine[3]["attrs"] == {"detail": "wf0:p ü",
                                "lost": ["node1", "node2"], "f": 0.125}
    assert mine[4]["attrs"] == {}  # too large: dropped, event kept
    # and the reader appends to the writer's ring where it left off
    rec = rpk.Recorder(rpk.Pool(tmp_path, "node0"))
    assert rec.committed == len(EVENTS)
    rec.record(recorder.EVT_POINT, "after", ts=1.6e9)
    assert [e["name"] for e in wpk.Recorder.replay(pool)][-1] == "after"


# ---------------------------------------------------------------------------
# (b) wrap-around, reopen, dead pool
# ---------------------------------------------------------------------------

def _lifecycle(pk, root):
    pool = pk.Pool(root, "node0")
    rec = pk.Recorder(pool, slots=8, slot_bytes=128)
    for i in range(25):
        assert rec.record(recorder.EVT_POINT, f"ev{i}", ts=float(i),
                          attrs={"i": i})
    wrapped = [(e["seq"], e["attrs"]["i"]) for e in pk.Recorder.replay(pool)]
    # a fresh process with other default geometry adopts the ring
    rec2 = pk.Recorder(pk.Pool(root, "node0"))
    adopted = (rec2.slots, rec2.slot_bytes, rec2.committed)
    rec2.record(recorder.EVT_POINT, "after-restart", ts=99.0)
    last = pk.Recorder.replay(pool)[-1]["name"]
    rec2.pool.fail()
    dropped = rec2.record(recorder.EVT_POINT, "dead")
    return wrapped, adopted, last, dropped, rec2.drops, rec2.committed


def test_wraparound_reopen_and_dead_pool_match_jax(tmp_path):
    theirs = _lifecycle(PK["jax"], tmp_path / "jax")
    mine = _lifecycle(PK["port"], tmp_path / "port")
    assert mine == theirs
    wrapped, adopted, last, dropped, drops, committed = mine
    assert wrapped == [(s, s) for s in range(17, 25)]
    assert adopted == (8, 128, 25)
    assert last == "after-restart"
    assert (dropped, drops, committed) == (False, 1, 26)


def test_plane_falls_back_to_home_ring_and_never_raises(tmp_path):
    """An event for a dead node lands on the home ring; spans on a dead
    home are counted drops; ``begin`` always returns a handle and ``end``
    records its histogram even when the plane is off."""
    pools = {n: PMemPool(tmp_path, n) for n in ("node0", "node1")}
    obs = TelemetryPlane(pools)
    pools["node1"].fail()
    obs.event("dying", node="node1", step=1)
    assert [e["name"] for e in recorder.FlightRecorder.replay(
        pools["node0"])] == ["dying"]
    assert obs.recorders["node1"].drops == 1
    pools["node0"].fail()
    sp = obs.begin("x", node="node0")
    obs.end(sp)
    assert obs.recorders["node0"].drops == 2
    off = TelemetryPlane({"node2": PMemPool(tmp_path, "node2")},
                         enabled=False)
    sp = off.begin("y")
    assert sp.trace and sp.span
    off.end(sp)
    assert off.registry.histogram("span.y.s").count == 1
    assert not off.recorders


# ---------------------------------------------------------------------------
# (c) torn tail, by hand: every crash point replays to a committed prefix
# ---------------------------------------------------------------------------

def _images(n, slots):
    """The ring after each of ``n`` commits (bytes), and the bytes of
    each slot as written."""
    root = Path(tempfile.mkdtemp(prefix="obs_torn_"))
    pool = PMemPool(root, "node0")
    rec = recorder.FlightRecorder(pool, slots=slots, slot_bytes=128)
    images = [_ring_bytes(pool)]
    for i in range(n):
        rec.record(recorder.EVT_POINT, f"ev{i}", ts=float(i),
                   attrs={"i": i})
        images.append(_ring_bytes(pool))
    return images


def _materialize(pk, root, blob):
    pool = pk.Pool(root, "node0")
    region = pool.create("obs/flightring", len(blob))
    region.write(0, np.frombuffer(blob, np.uint8))
    region.flush()
    return pool


@pytest.mark.parametrize("reader", BOTH)
def test_torn_tail_replays_a_committed_prefix(reader, tmp_path):
    pk = PK[reader]
    n, slots, sb = 10, 6, 128
    images = _images(n, slots)
    full = [e["attrs"]["i"] for e in recorder.FlightRecorder.replay(
        _materialize(PK["port"], tmp_path / "full", images[-1]))]
    assert full == list(range(n - slots, n))
    n_cases = 0
    for k in range(n):
        before, after = images[k], images[k + 1]
        off = recorder.HDR_SIZE + (k % slots) * sb
        slot = after[off:off + sb]
        # the slot written (whole or torn at any of a few cuts), the tail
        # not yet advanced or not yet flushed: replay sees the k commits
        for cut in (sb, sb // 2, 7, 1):
            blob = before[:off] + slot[:cut] + before[off + cut:]
            got = [e["attrs"]["i"] for e in pk.Recorder.replay(
                _materialize(pk, tmp_path / f"k{k}c{cut}", blob))]
            # past a wrap the write lands on the oldest committed slot,
            # which replay then skips (stale seq or bad CRC): what stays
            # is the newest committed events, in order, with no gap
            lo = max(0, k - slots)
            lo += k >= slots and blob[off:off + sb] != before[off:off + sb]
            assert got == list(range(lo, k)), (k, cut)
            n_cases += 1
        # the tail flushed: the k + 1 commits, a prefix of the whole run
        got = [e["attrs"]["i"] for e in pk.Recorder.replay(
            _materialize(pk, tmp_path / f"k{k}t", after))]
        assert got == list(range(max(0, k + 1 - slots), k + 1))
    assert n_cases == 4 * n


# ---------------------------------------------------------------------------
# (d) build_traces: the same trees from the same events
# ---------------------------------------------------------------------------

def test_build_traces_matches_jax(tmp_path):
    c = _port_cluster(tmp_path, n_nodes=4)
    try:
        c.tiered.save_async(0, {"w": np.arange(64, dtype=np.float32)},
                            drain=True).result()
        _settle(c)
        c.kill_node("node1")
        c.repair(["node1"])
        events = _replay_cluster(c, PK["port"])
    finally:
        c.shutdown()
    # a span whose BEGIN the ring lost is synthesized from its END
    events = [e for e in events
              if not (e["name"] == "ckpt.drain"
                      and e["kind"] == recorder.EVT_BEGIN)]
    mine, theirs = trace.build_traces(events), jtrace.build_traces(events)
    assert mine == theirs and len(mine) >= 2
    for tid, tr in mine.items():
        assert trace.span_names(tr) == jtrace.span_names(tr)
        for sid in tr["spans"]:
            assert trace.connected_to_root(tr, sid) == \
                jtrace.connected_to_root(tr, sid)


# ---------------------------------------------------------------------------
# (e) one save -> one connected ckpt.save tree, its trace in the acks
# ---------------------------------------------------------------------------

def test_save_async_span_tree_matches_jax(tmp_path):
    def scenario(c, pk):
        c.tiered.save_async(0, {"w": np.full(128, 1.0, np.float32)},
                            drain=True).result()
        _settle(c)
        saves = _traces_rooted_at(
            pk.trace.build_traces(_replay_cluster(c, pk)), "ckpt.save")
        assert len(saves) == 1
        (tid, tr), = saves.items()
        assert all(pk.trace.connected_to_root(tr, s) for s in tr["spans"])
        acked = sorted(ev["name"] for sp in tr["spans"].values()
                       for ev in sp["events"])
        rec = c.checkpointer.ack_record(0)
        for nid in rec["ring"]:
            assert rec["acks"][nid]["replica"]["trace"] == tid
            assert rec["acks"][nid]["drain"]["trace"] == tid
        man = c.checkpointer._meta_get_json("ckpt/manifest_step0.json")
        assert man["trace"]["trace"] == tid
        return _structure(tr), acked
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert mine[0]["roots"] == ["ckpt.save"]
    assert mine[1] == ["ckpt.ack.drain"] * 4 + ["ckpt.ack.replica"] * 4


# ---------------------------------------------------------------------------
# (f) the repair sweep is one trace
# ---------------------------------------------------------------------------

def test_repair_sweep_is_traced_like_jax(tmp_path):
    def scenario(c, pk):
        c.tiered.save_async(0, {"w": np.full(64, 2.0, np.float32)}).result()
        _settle(c)
        c.kill_node("node1")
        c.repair(["node1"])
        sweeps = _traces_rooted_at(
            pk.trace.build_traces(_replay_cluster(c, pk)), "repair.sweep")
        assert len(sweeps) == 1
        (_, tr), = sweeps.items()
        snap = c.obs.snapshot()["counters"]
        assert snap["repair.checkpoint"] >= 1
        return _structure(tr), {k: v for k, v in snap.items()
                                if k.startswith("repair.")}
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert "sched.replicate" in mine[0]["spans"]


# ---------------------------------------------------------------------------
# (g) each package's report CLI reads the other's post-crash pmem root
# ---------------------------------------------------------------------------

def _crash(c):
    c.tiered.save_async(0, {"w": np.full(128, 3.0, np.float32)},
                        drain=True).result()
    _settle(c)
    t = c.tiered.save_async(1, {"w": np.full(128, 4.0, np.float32)},
                            drain=True)
    c.kill_node("node2")  # crash while step 1's fan-out is in flight
    try:
        t.result()
    except Exception:
        pass
    c.tiered.quiesce()


@pytest.mark.parametrize("writer", BOTH)
def test_report_reads_the_other_packages_crash(writer, tmp_path, capsys):
    wpk = PK[writer]
    rpk = PK["port" if writer == "jax" else "jax"]
    c = wpk.Cluster(tmp_path, n_nodes=4)
    try:
        _crash(c)
        root = c.root / "pmem"
        rc = rpk.report.main([str(root)])
        out = capsys.readouterr().out
        assert rc == 0
        assert "ckpt.save" in out
        assert "last event per ring:" in out
        assert "no metrics snapshot found" in out
        mine, _ = rpk.report.load_events(root)
        theirs, _ = wpk.report.load_events(root)
        assert mine == theirs
        assert {"node0", "node1", "node3"} <= {e["node"] for e in mine}
        assert rpk.report.render(mine, None) == \
            wpk.report.render(theirs, None)
    finally:
        c.shutdown()


def test_report_cli_runs_as_a_module(tmp_path):
    c = _port_cluster(tmp_path, n_nodes=2)
    try:
        c.tiered.save_async(0, {"w": np.ones(16, np.float32)}).result()
        _settle(c)
    finally:
        c.shutdown()
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report",
         str(tmp_path / "pmem"), "--json"], capture_output=True, text=True,
        env=env, timeout=120, check=True).stdout
    dump = json.loads(out)
    assert dump["snapshot"]["counters"]["tiered.saves"] == 1
    assert "ckpt.save" in {e["name"] for e in dump["events"]}
    empty = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report",
         str(tmp_path / "nothing")], capture_output=True, text=True,
        env=env, timeout=120)
    assert empty.returncode == 1
    assert "no flight-recorder events" in empty.stdout


# ---------------------------------------------------------------------------
# (h) a clean shutdown persists the same metrics
# ---------------------------------------------------------------------------

def test_clean_shutdown_snapshot_matches_jax(tmp_path):
    snaps = []
    for name in BOTH:
        pk = PK[name]
        c = pk.Cluster(tmp_path / name, n_nodes=2)
        c.tiered.save_async(0, {"w": np.full(32, 5.0, np.float32)}).result()
        c.tiered.save_async(1, {"w": np.full(32, 6.0, np.float32)},
                            drain=True).result()
        _settle(c)
        c.shutdown()
        snaps.append(c.pools["node0"].get_json("obs/metrics.json"))
        assert snaps[-1] == c.pools["node1"].get_json("obs/metrics.json")
    theirs, mine = snaps
    assert mine["counters"]["tiered.saves"] == 2
    assert mine["counters"] == theirs["counters"]
    assert mine["gauges"] == theirs["gauges"]
    assert sorted(mine["histograms"]) == sorted(theirs["histograms"])
    assert {k: h["count"] for k, h in mine["histograms"].items()} == \
        {k: h["count"] for k, h in theirs["histograms"].items()}
    assert "ckpt.save_commit_s" in mine["histograms"]
    assert sorted(mine["recorder"]) == ["node0", "node1"]


# ---------------------------------------------------------------------------
# (i) the jobs of one workflow run share one trace
# ---------------------------------------------------------------------------

def test_workflow_jobs_share_one_trace(tmp_path):
    def scenario(c, pk):
        def produce(ctx):
            return {"out_a": {"x": np.full(16, 6.0, np.float32)}}

        def consume(ctx):
            ctx.read("out_a")
            return {}

        c.workflows.run([pk.JobSpec("p", produce),
                         pk.JobSpec("q", consume, after=["p"],
                                    inputs=["out_a"])])
        traces = pk.trace.build_traces(_replay_cluster(c, pk))
        wf = [tr for tid, tr in traces.items()
              if tid and "wf.job" in pk.trace.span_names(tr)]
        assert len(wf) == 1
        jobs = sorted(sp["attrs"]["job"] for sp in wf[0]["spans"].values()
                      if sp["name"] == "wf.job")
        untraced = sorted({ev["name"] for ev in traces[0]["points"]
                           if ev["name"].startswith("wf.")})
        return jobs, _structure(wf[0]), untraced
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert mine[0] == ["p", "q"]


# ---------------------------------------------------------------------------
# (j) a session suspended by one package continues its trace in the other
# ---------------------------------------------------------------------------

class _Engine:
    """The manager's state-handoff contract, nothing else."""

    def __init__(self, state=None):
        self.label = "fake"
        self.cache = None
        self.state = state

    def export_state(self, release=False):
        out, self.state = self.state, None if release else self.state
        return out

    def install_state(self, obj):
        self.state = obj


@pytest.mark.parametrize("writer", BOTH)
def test_adopted_session_continues_the_writers_trace(writer, tmp_path):
    wpk = PK[writer]
    rpk = PK["port" if writer == "jax" else "jax"]
    state = {"cache": {"k": np.arange(8, dtype=np.float32)},
             "pos": np.int32(5)}
    c = wpk.Cluster(tmp_path, n_nodes=3)
    try:
        c.sessions.start("s", _Engine(state))
        c.sessions.suspend("s")
        c.tiered.quiesce()
        tid = c.sessions._sessions["s"].span.trace
        rec = c.catalog.record("sess/s", "serve")
    finally:
        c.shutdown()
    assert rec["annotations"] == {"session": "s", "trace": tid}
    r = rpk.Cluster(tmp_path, n_nodes=3)
    try:
        eng = _Engine()
        r.sessions.resume("s", eng)
        assert int(eng.state["pos"]) == 5
        assert r.sessions._sessions["s"].span.trace == tid
        tr = rpk.trace.build_traces(_replay_cluster(r, rpk))[tid]
        by_name = {}
        for sid, sp in tr["spans"].items():
            by_name.setdefault(sp["name"], []).append((sid, sp))
        # the writer's lifetime root and spill, the adopter's root and
        # its resume under it: one trace across the two packages
        assert sorted(by_name) == ["serve.resume", "serve.session",
                                   "serve.spill"]
        assert len(by_name["serve.session"]) == 2
        (_, resume), = by_name["serve.resume"]
        adopter = [sid for sid, sp in by_name["serve.session"]
                   if sp["attrs"].get("adopted")]
        assert resume["parent"] == adopter[0]
        assert all(rpk.trace.connected_to_root(tr, s) for s in tr["spans"])
    finally:
        r.shutdown()


# ---------------------------------------------------------------------------
# (k) telemetry=False records nothing
# ---------------------------------------------------------------------------

def test_telemetry_off_records_nothing(tmp_path):
    def scenario(c, pk):
        c.tiered.save_async(0, {"w": np.full(32, 7.0, np.float32)}).result()
        _settle(c)
        assert all(pk.Recorder.replay(p) == [] for p in c.pools.values())
        assert not c.obs.recorders
        return c.tiered.stats["saves"], \
            c.obs.registry.histogram("span.ckpt.save.s").count
    theirs, mine = _both(tmp_path, scenario, telemetry=False)
    assert mine == theirs
    assert mine[0] == 1
