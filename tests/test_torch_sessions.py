"""Port parity: the multi-tenant serve tier (``SessionManager``: sessions
as leased exchange datasets) against the JAX package.

The manager cases of ``tests/test_serve_sessions.py`` run as scenarios on
a JAX ``SimCluster`` and on a port one (``device="cpu"``) with the same
``FakeEngine`` (the manager only ever sees the state handoff): versioned
spills with lineage, gc safety under leases, lease-release eviction,
adoption by a second manager, metadata-only recoverability, the replica
resume after the home node's death under a store-read audit (zero blind
probes), ``peek`` of a wire-encoded spill off the replica, a failed
asynchronous suspend parking its host copy, the manager's instruments
(read off each cluster's telemetry plane) and the ``serve.session``
span tree, whose trace id lands in the record's ``trace`` annotation
and is continued by an adopting manager.
``test_prefill_routes_through_jitted_path`` is about JAX's ``jax.jit``
and has no counterpart: the port's engine calls ``prefill`` directly.

Then the real engines at gemma2's smoke size in float32, as
``examples/serve_longcontext.py`` drives them: a prefix prefilled once
and published, two sessions forked from it on two workers, suspended,
the home of one killed, both adopted and resumed by the second worker's
manager; the port's tokens equal JAX's and an uninterrupted
reference's, and the next step's logits agree with JAX's within
``tests/test_torch_models.py``'s float32 tolerance. Last, a session
spilled by one package's manager is adopted and resumed by the other's.
"""
import time
from concurrent.futures import Future
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core.cluster import SimCluster as JSimCluster
from repro.models import transformer as jT
from repro.serve import engine as jengine
from repro.serve import sessions as jsessions
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.core.cluster import SimCluster
from repro_torch.core.dataset_exchange import ack_targets
from repro_torch.models import transformer as T
from repro_torch.serve import engine as pengine
from repro_torch.serve import sessions as psessions

jax.config.update("jax_platform_name", "cpu")

PK = {"jax": SimpleNamespace(name="jax", engine=jengine,
                             SessionManager=jsessions.SessionManager),
      "port": SimpleNamespace(name="port", engine=pengine,
                              SessionManager=psessions.SessionManager)}

F32_TOL = (2e-5, 2e-5)  # tests/test_torch_models.py's float32 (atol, rtol)


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


def _np(x):
    return bridge.to_numpy(x)


def _replay(pool):
    from repro_torch.obs.recorder import FlightRecorder
    return FlightRecorder.replay(pool)


def _state(seed=0, n=64):
    r = np.random.RandomState(seed)
    return {"cache": {"k": r.randn(2, n).astype(np.float32),
                      "v": r.randn(2, n).astype(np.float32)},
            "pos": np.int32(7 + seed)}


class FakeEngine:
    """export_state/install_state contract double: the manager never
    looks at the math, only at the state tree handoff."""

    def __init__(self, label="e0"):
        self.label = label
        self.cache = None
        self._state = None

    def export_state(self, release=False):
        assert self._state is not None, "no session state resident"
        out = {"cache": dict(self._state["cache"]),
               "pos": np.int32(self._state["pos"])}
        if release:
            self._state = None
        return out

    def install_state(self, obj):
        self._state = {"cache": {k: _np(v) for k, v in obj["cache"].items()},
                       "pos": int(obj["pos"])}

    def seed(self, tree):
        self.install_state(tree)
        return self

    @property
    def pos(self):
        return self._state["pos"]


def _record_store_reads(c):
    """Audit every object-store DATA read (get_with_manifest / exists /
    get_leaf) across the cluster; pool JSON reads are not data probes."""
    reads = []
    for nid, st in c.stores.items():
        for meth in ("get_with_manifest", "exists", "get_leaf"):
            orig = getattr(st, meth)

            def wrapped(name, *a, _orig=orig, _nid=nid, **kw):
                reads.append((_nid, name))
                return _orig(name, *a, **kw)

            setattr(st, meth, wrapped)
    return reads


def _registry(c, pk):
    """Where the manager's instruments live: the cluster's telemetry
    plane, in both packages."""
    return c.obs.registry


# ---------------------------------------------------------------------------
# lifecycle: spill publishes a leased dataset with lineage
# ---------------------------------------------------------------------------

def test_spill_publishes_versioned_dataset_with_lineage(tmp_path):
    def scenario(c, pk):
        sm = c.sessions
        sm.publish_prefix("sys", _state(1))
        eng = FakeEngine().seed(_state(2))
        sm.start("chat", eng, prefix="sys")
        forked = eng.pos  # the fork installed the prefix state
        rec = sm.spill("chat")
        rec2 = sm.spill("chat")
        chain = c.catalog.lineage("sess/chat", "serve")
        return (forked, rec["version"], bool(rec["digest"]),
                rec["lineage"], rec2["version"], rec2["lineage"],
                [r.get("name") for r in chain if "name" in r],
                rec["digest"] == rec2["digest"])
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert mine[0] == int(_state(1)["pos"]) and mine[1] == 1 and mine[2]
    assert ["prefix/sys", "serve", 1] in mine[3]["inputs"]
    assert mine[3]["job"] == "e0"  # the engine's label is the producer
    assert mine[4] == 2 and ["sess/chat", "serve", 1] in mine[5]["inputs"]
    assert "prefix/sys" in mine[6]


def test_gc_never_reclaims_live_leased_session(tmp_path):
    def scenario(c, pk):
        sm = c.sessions
        sm.start("live", FakeEngine().seed(_state(3)))
        sm.spill("live")
        c.tiered.quiesce()
        out = [c.catalog.gc()]
        sm.spill("live")
        c.tiered.quiesce()
        out.append(c.catalog.gc())
        out.append(c.catalog.record("sess/live", "serve", 1)["reclaimed"])
        sm.end("live")
        c.tiered.quiesce()
        out.append(c.catalog.gc())
        return out
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert mine[0] == [] and mine[1] == [("serve", "sess/live", 1)]
    assert mine[2] and ("serve", "sess/live", 2) in mine[3]


def test_eviction_releases_lease_instead_of_deleting(tmp_path):
    def scenario(c, pk):
        sm = c.sessions
        sm.start("cold", FakeEngine().seed(_state(4)))
        sm.suspend("cold")
        sm.start("hot", FakeEngine().seed(_state(5)))
        out = [sm.choose_evictions(0.0), sm.evict_cold(0.0),
               sm._sessions["cold"].lease is None]
        eng = FakeEngine("e1")
        sm.resume("cold", eng)
        out += [sm._sessions["cold"].lease is not None, eng.pos]
        c.tiered.quiesce()
        out.append(("serve", "sess/cold", 1) in c.catalog.gc())
        return out
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == [["cold"], ["cold"], True, True,
                              int(_state(4)["pos"]), False]


def test_resume_rejects_double_bind_and_unknown(tmp_path):
    def scenario(c, pk):
        sm = c.sessions
        sm.start("s", FakeEngine().seed(_state(6)))
        with pytest.raises(RuntimeError):
            sm.resume("s", FakeEngine())
        with pytest.raises(KeyError):
            sm.resume("nope", FakeEngine())
        with pytest.raises(KeyError):
            sm.start("s", FakeEngine())
        return sm.sessions(), sm.active_sessions()
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == (["s"], ["s"])


# ---------------------------------------------------------------------------
# fleet: cross-process adoption + replica resume with zero blind probes
# ---------------------------------------------------------------------------

def test_adoption_resumes_session_published_elsewhere(tmp_path):
    def scenario(c, pk):
        sm = c.sessions
        sm.start("shared", FakeEngine().seed(_state(7)))
        sm.suspend("shared")
        # "another process": a fresh manager over the same catalog
        sm2 = pk.SessionManager(c.tiered, c.catalog,
                                **({"obs": c.obs} if pk.name == "jax"
                                   else {}))
        eng2 = FakeEngine("e2")
        sm2.resume("shared", eng2)
        rec = c.catalog.record("sess/shared", "serve")
        return (eng2.pos, rec["annotations"]["session"], sm2.discover(),
                sm2._sessions["shared"].version,
                sm2._sessions["shared"].lease is not None)
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == (int(_state(7)["pos"]), "shared", ["shared"],
                              1, True)


def test_resume_from_acked_replica_zero_probes_after_home_death(tmp_path):
    def scenario(c, pk):
        sm = c.sessions
        sm.start("surv", FakeEngine().seed(_state(8)))
        sm.suspend("surv")
        c.tiered.quiesce()
        rec = c.catalog.record("sess/surv", "serve")
        home = rec["home"]
        buddy = rec["acks"]["replica"]["targets"][0]
        reads = _record_store_reads(c)
        recoverable = "surv" in sm.recoverable_sessions([home])
        decision_reads = list(reads)
        c.kill_node(home)
        sm.evict_cold(0.0)
        c.catalog.cache.drop(f"exch/serve/sess/surv@v{rec['version']}")
        del reads[:]
        eng2 = FakeEngine("e2")
        sm.resume("surv", eng2)
        data_reads = [(n, o) for n, o in reads
                      if not o.endswith(".json") and n != home]
        assert data_reads, "resume never touched pmem?"
        for nid, obj in data_reads:
            assert obj.startswith("replica/"), (nid, obj)
            assert nid == buddy, (nid, obj, buddy)
        return recoverable, decision_reads, eng2.pos, sorted(set(
            data_reads))
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert mine[0] and mine[1] == [] and mine[2] == int(_state(8)["pos"])


@pytest.fixture()
def codec_clusters(tmp_path):
    """A JAX and a port 4-node cluster with the delta-int8 wire codec on
    every replicate/drain/repair transfer."""
    out = {"jax": JSimCluster(tmp_path / "jax", n_nodes=4, wire_codec=True),
           "port": _port(tmp_path / "port", n_nodes=4, wire_codec=True)}
    yield out
    for c in out.values():
        c.shutdown()


def test_peek_session_wire_codec_replica_after_home_death(codec_clusters):
    """The engine's ``peek_session`` of a wire-encoded spill off the
    replica after the DLM home dies: every data read off a live node is
    the replica, in both packages."""
    state = _state(9, n=256)
    out = {}
    for name, c in codec_clusters.items():
        mod = PK[name].engine
        eng = mod.ServeEngine.__new__(mod.ServeEngine)
        eng.tiered, eng.store, eng.failed_spills = c.tiered, None, {}
        eng.cache = state["cache"] if name == "jax" else \
            bridge.tree_map(bridge.to_torch, state["cache"])
        eng.pos = int(state["pos"])
        eng.spill("wired")
        c.tiered.quiesce()
        c.tiered.evict_cold(0.0)
        c.kill_node("node0")
        reads = _record_store_reads(c)
        k = _np(eng.peek_session("wired", "cache/k"))
        pos = int(eng.peek_session("wired", "pos"))
        data_reads = [(n, o) for n, o in reads
                      if not o.endswith(".json") and n != "node0"]
        assert data_reads, "peek never touched pmem?"
        for nid, obj in data_reads:
            assert obj.startswith("replica/"), (nid, obj)
        out[name] = (k.tobytes(), pos, sorted(set(data_reads)))
    assert out["port"] == out["jax"]
    assert out["port"][0] == state["cache"]["k"].tobytes()
    assert out["port"][1] == int(state["pos"])


def test_manager_peek_wire_codec_replica_after_home_death(codec_clusters):
    state = _state(10, n=256)
    out = {}
    for name, c in codec_clusters.items():
        sm = c.sessions
        sm.start("wired2", FakeEngine().seed(state))
        sm.suspend("wired2")
        c.tiered.quiesce()
        rec = c.catalog.record("sess/wired2", "serve")
        c.kill_node(rec["home"])
        out[name] = (_np(sm.peek("wired2", "cache/v")).tobytes(),
                     int(sm.peek("wired2", "pos")),
                     c.catalog.stats["replica_reads"] >= 2, rec["home"])
    assert out["port"] == out["jax"]
    assert out["port"][0] == state["cache"]["v"].tobytes()
    assert out["port"][1:3] == (int(state["pos"]), True)


# ---------------------------------------------------------------------------
# failed async suspend parks the host copy
# ---------------------------------------------------------------------------

def test_failed_async_suspend_parks_state_and_resume_recovers(tmp_path):
    def scenario(c, pk):
        sm = c.sessions
        sm.start("flaky", FakeEngine().seed(_state(11)))
        orig = c.catalog.publish

        def boom(*a, **kw):
            raise IOError("injected publish failure")

        c.catalog.publish = boom
        try:
            fut = sm.suspend("flaky", wait=False)
            with pytest.raises(IOError):
                fut.result(timeout=30)
            sm.join()
            parked = sm._sessions["flaky"].pending_state is not None
            eng2 = FakeEngine("e2")
            sm.resume("flaky", eng2)
        finally:
            c.catalog.publish = orig
        sm.spill("flaky")
        return parked, eng2.pos, sm._sessions["flaky"].pending_state, \
            sm.recoverable_sessions()
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == (True, int(_state(11)["pos"]), None,
                              ["flaky"])


def test_engine_spill_ticket_owns_host_copy_on_failure():
    """spill(wait=False) frees the engine's copy before the offload is
    durable; the ticket parks the host copy when it fails and names the
    session in the error, in both packages."""
    class _FailingTiered:
        obs = None

        def offload(self, name, obj, replicate=True):
            fut = Future()
            fut.set_exception(IOError("pmem died mid-offload"))
            return fut

    state = _state(12)
    for name in ("jax", "port"):
        mod = PK[name].engine
        eng = mod.ServeEngine.__new__(mod.ServeEngine)
        eng.tiered, eng.store, eng.failed_spills = _FailingTiered(), None, {}
        if name == "port":
            eng.device = torch.device("cpu")
        eng.cache = state["cache"] if name == "jax" else \
            bridge.tree_map(bridge.to_torch, state["cache"])
        eng.pos = int(state["pos"])
        ticket = eng.spill("doomed", wait=False)
        assert isinstance(ticket, mod.SpillTicket)
        assert eng.cache is None
        with pytest.raises(RuntimeError, match="doomed"):
            ticket.result(timeout=30)
        assert "doomed" in eng.failed_spills
        eng.restore_failed_spill("doomed")
        np.testing.assert_array_equal(_np(eng.cache["k"]),
                                      state["cache"]["k"])
        assert eng.pos == int(state["pos"])


# ---------------------------------------------------------------------------
# instruments (no spans in the port)
# ---------------------------------------------------------------------------

def test_session_instruments(tmp_path):
    def scenario(c, pk):
        sm = c.sessions
        reg = _registry(c, pk)
        gauge = reg.gauge("serve.sessions_active")
        sm.start("obs1", FakeEngine().seed(_state(13)))
        out = [gauge.value]
        sm.suspend("obs1")
        out.append(gauge.value)
        sm.resume("obs1", FakeEngine("e2"))
        out.append(gauge.value)
        c.tiered.quiesce()
        deadline = time.time() + 10
        while time.time() < deadline and \
                reg.histogram("serve.spill_to_ack_s").count < 1:
            time.sleep(0.02)
        out += [reg.counter(k).value for k in
                ("serve.spills", "serve.resumes", "serve.adoptions")]
        out += [reg.histogram("serve.resume_ms").count,
                reg.histogram("serve.spill_to_ack_s").count]
        sm.end("obs1")
        out.append(gauge.value)
        return out
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == [1, 0, 1, 1, 1, 0, 1, 1, 0]


def test_manager_obs_waits_for_item_10(tmp_path):
    """The manager given a plane opens one ``serve.session`` span tree
    per lifetime, as JAX's does: the spill and resume spans hang off the
    root, the record's ``trace`` annotation is the root's trace, and a
    second manager adopting the session continues that trace."""
    from repro_torch.obs.trace import build_traces, connected_to_root

    def scenario(c, pk):
        if pk.name == "port":
            assert c.sessions.registry is c.obs.registry
        sm = c.sessions
        sm.start("s1", FakeEngine().seed(_state(3)))
        sm.suspend("s1")
        sm2 = pk.SessionManager(c.tiered, c.catalog, owner="w2",
                                obs=c.obs)
        sm2.resume("s1", FakeEngine("e2"))
        c.tiered.quiesce()
        rec = c.catalog.record("sess/s1", "serve")
        tid = sm._sessions["s1"].span.trace
        assert rec["annotations"]["trace"] == tid != 0
        assert sm2._sessions["s1"].span.trace == tid
        events = [ev for pool in c.pools.values()
                  for ev in _replay(pool)]
        tr = build_traces(events)[tid]
        names = sorted(sp["name"] for sp in tr["spans"].values())
        assert all(connected_to_root(tr, sid) for sid in tr["spans"])
        points = sorted({ev["name"] for ev in tr["points"]})
        return names, len(tr["roots"]), points
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert mine[0] == ["serve.resume", "serve.session", "serve.session",
                       "serve.spill"]


# ---------------------------------------------------------------------------
# the real engines: fork, suspend, node loss, adoption (float32)
# ---------------------------------------------------------------------------

ARCH, SYSTEM, STEPS, MAX_SEQ = "gemma2-9b", 24, 4, 48


def _models():
    jcfg = jregistry.get_smoke_config(ARCH)
    cfg = registry.get_smoke_config(ARCH)
    jrt = jT.ModelRuntime(tp=1, attn_impl="naive", max_seq=MAX_SEQ,
                          remat=False)
    rt = T.ModelRuntime(tp=1, attn_impl="pallas", max_seq=MAX_SEQ)
    jparams, _ = jT.init_params(jax.random.PRNGKey(0), jcfg, jrt)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    return (jcfg, jrt, jparams), (cfg, rt, jax.tree.map(np.asarray,
                                                        jparams))


def _engine(pk, model, c, label):
    cfg, rt, params = model
    if pk.name == "jax":
        return pk.engine.ServeEngine(cfg, rt, params, tiered=c.tiered,
                                     label=label)
    return pk.engine.ServeEngine(cfg, rt, params, tiered=c.tiered,
                                 label=label, device="cpu")


def _next_logits(pk, model, eng, tok):
    """The logits of one more decode step from the engine's state (the
    last thing done with it: the port decodes in place)."""
    cfg, rt, params = model
    if pk.name == "jax":
        logits, _ = jT.decode_step(params, cfg, rt, eng.cache,
                                   jnp.asarray(tok), jnp.int32(eng.pos))
        return np.asarray(logits)
    with torch.no_grad():
        logits, _ = T.decode_step(eng.params, cfg, rt, eng.cache,
                                  torch.as_tensor(tok), eng.pos)
    return logits.numpy()


def _fleet(c, pk, model, users, system):
    """examples/serve_longcontext.py's flow at smoke size on cluster
    ``c``; returns the tokens per user, the records' lineage producers,
    the recoverability answer, the peeked cursor and the next logits."""
    eng_a = _engine(pk, model, c, "workerA")
    eng_b = _engine(pk, model, c, "workerB")
    sm_a = c.sessions
    sm_b = pk.SessionManager(c.tiered, c.catalog, owner="workerB",
                             **({"obs": c.obs} if pk.name == "jax"
                                else {}))
    eng_a.prefill(system)
    sm_a.publish_prefix("system", eng_a)
    outs = {}
    for (user, tok), (sm, eng) in zip(users.items(),
                                      ((sm_a, eng_a), (sm_b, eng_b))):
        sm.start(user, eng, prefix="system")
        outs[user] = eng.decode(np.array([tok], np.int32), STEPS)
        sm.suspend(user)
    c.tiered.quiesce()
    producers = {u: c.catalog.record(f"sess/{u}", "serve")["lineage"]["job"]
                 for u in users}
    victim = c.catalog.record("sess/alice", "serve")["home"]
    reads = _record_store_reads(c)
    survivors = sm_b.recoverable_sessions([victim])
    assert reads == [], reads
    c.kill_node(victim)
    peeked = int(sm_b.peek("alice", "pos"))
    for user in users:
        r = c.catalog.record(f"sess/{user}", "serve")
        c.catalog.cache.drop(f"exch/serve/sess/{user}@v{r['version']}")
        sm_b.resume(user, eng_b)
        more = eng_b.decode(outs[user][:, -1], STEPS)
        outs[user] = np.concatenate([outs[user], more[:, 1:]], axis=1)
        if user == "bob":
            logits = _next_logits(pk, model, eng_b, outs[user][:, -1])
        else:
            sm_b.suspend(user)
    blind = [(n, o) for n, o in reads
             if not o.endswith(".json") and n != victim
             and not o.startswith(("replica/", "wf/serve/"))]
    assert not blind, f"blind probes: {blind}"
    return outs, producers, survivors, peeked, logits


def test_fleet_fork_node_loss_adoption_matches_jax(tmp_path):
    jmodel, model = _models()
    rng = np.random.default_rng(0)
    system = rng.integers(0, model[0].vocab_size,
                          (1, SYSTEM)).astype(np.int32)
    users = {"alice": int(rng.integers(0, model[0].vocab_size)),
             "bob": int(rng.integers(0, model[0].vocab_size))}
    jc = JSimCluster(tmp_path / "jax", n_nodes=3)
    try:
        want = _fleet(jc, PK["jax"], jmodel, users, system)
    finally:
        jc.shutdown()
    c = _port(tmp_path / "port", n_nodes=3)
    try:
        got = _fleet(c, PK["port"], model, users, system)
    finally:
        c.shutdown()
    for user in users:
        np.testing.assert_array_equal(got[0][user], want[0][user])
    # a suspend unbinds the engine before the publish, so JAX stamps the
    # manager's owner as the producer (a bound spill stamps the label)
    assert got[1] == want[1] == {"alice": "serve", "bob": "workerB"}
    assert got[2] == want[2] == ["alice", "bob"]
    assert got[3] == want[3] == SYSTEM + STEPS
    np.testing.assert_allclose(got[4], want[4], atol=F32_TOL[0],
                               rtol=F32_TOL[1])
    # an uninterrupted reference engine gives the same tokens
    cfg, rt, params = model
    ref = pengine.ServeEngine(cfg, rt, params, device="cpu")
    for user, tok in users.items():
        ref.prefill(system)
        full = ref.decode(np.array([tok], np.int32), 2 * STEPS)
        np.testing.assert_array_equal(full, got[0][user])


def test_engines_on_one_parameter_set_share_storage():
    """Two engines built from one tensor tree hold the same storage: a
    fleet keeps one copy of the weights."""
    _, (cfg, rt, params) = _models()
    tparams = bridge.params_from_host(params, "cpu")
    a = pengine.ServeEngine(cfg, rt, tparams, label="a", device="cpu")
    b = pengine.ServeEngine(cfg, rt, tparams, label="b", device="cpu")
    for (path, x), (_, y) in zip(bridge.tree_leaves(a.params),
                                 bridge.tree_leaves(b.params)):
        assert x.data_ptr() == y.data_ptr(), path
    assert (a.label, b.label) == ("a", "b")
    assert pengine.ServeEngine(cfg, rt, tparams, device="cpu").label == \
        "engine0"


# ---------------------------------------------------------------------------
# across packages: a session spilled by one manager, resumed by the other
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_session_spilled_by_one_package_resumes_in_the_other(writer,
                                                             tmp_path):
    """A real session prefilled, decoded and suspended through one
    package's SessionManager; the other package's manager, on a cluster
    over the same pools, adopts it from the catalog record and decodes
    on, token for token with the writer's own continuation."""
    jmodel, model = _models()
    prompt = np.random.default_rng(1).integers(
        0, model[0].vocab_size, (1, SYSTEM)).astype(np.int32)
    wpk, rpk = (PK["jax"], PK["port"]) if writer == "jax" else \
        (PK["port"], PK["jax"])
    wmodel, rmodel = (jmodel, model) if writer == "jax" else (model, jmodel)
    make_w = JSimCluster if writer == "jax" else _port
    make_r = _port if writer == "jax" else JSimCluster
    c = make_w(tmp_path, n_nodes=3)
    try:
        eng = _engine(wpk, wmodel, c, "writer")
        first = eng.prefill(prompt)
        toks = eng.decode(first, STEPS)
        c.sessions.start("s", eng)
        state = eng.export_state()
        c.sessions.suspend("s")
        c.tiered.quiesce()
        want = _engine(wpk, wmodel, c, "ref")
        want.install_state(state)
        want = want.decode(toks[:, -1], STEPS)
        rec = c.catalog.record("sess/s", "serve")
    finally:
        c.shutdown()
    r = make_r(tmp_path, n_nodes=3)
    try:
        assert r.sessions.discover() == ["s"]
        assert r.sessions.recoverable_sessions([rec["home"]]) == ["s"]
        eng = _engine(rpk, rmodel, r, "reader")
        r.sessions.resume("s", eng)
        assert eng.pos == SYSTEM + STEPS
        got = eng.decode(toks[:, -1], STEPS)
        np.testing.assert_array_equal(got, want)
        rec2 = r.sessions.spill("s")
        assert rec2["version"] == 2 and rec2["lineage"]["job"] == "reader"
        assert ["sess/s", "serve", 1] in rec2["lineage"]["inputs"]
        assert ack_targets(rec["acks"]["replica"])
    finally:
        r.shutdown()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the codec and SSD kernels have "
                    "no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_codec_session_peek_on_the_card(cuda, tmp_path):
    """A smoke mamba2 session on the card, suspended through the strict
    wire codec (decode_tiles runs its round trip), its home killed; the
    manager's ``peek`` of the float32 recurrent state off the codec
    replica equals the suspended state bit for bit, and a second manager
    resumes it on the card to the same tokens."""
    from repro_torch.kernels import watchdog
    from repro_torch.kernels.ckpt_codec import ops as codec

    cfg = registry.get_smoke_config("mamba2-1.3b")
    rt = T.ModelRuntime(tp=1, attn_impl="pallas", max_seq=64)
    params = T.init_params(cfg, rt, torch.Generator(device=cuda)
                           .manual_seed(0), device=cuda)
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 40)).astype(np.int32)
    c = SimCluster(tmp_path, n_nodes=3, wire_codec=True, device=cuda)
    try:
        eng = pengine.ServeEngine(cfg, rt, params, tiered=c.tiered,
                                  label="a", device=cuda)
        toks = eng.decode(eng.prefill(prompt), 3)
        watchdog.synchronize()
        c.sessions.start("m", eng)
        state = eng.export_state()
        d0 = codec.decode_launches
        c.sessions.suspend("m")
        assert c.tiered.quiesce() == []
        assert codec.decode_launches > d0  # the strict round trip
        rec = c.catalog.record("sess/m", "serve")
        c.kill_node(rec["home"])
        leaf = next(p for p, t in bridge.tree_leaves(state["cache"])
                    if t.dtype == torch.float32)
        got = c.sessions.peek("m", f"cache/{leaf}")
        want = dict(bridge.tree_leaves(state["cache"]))[leaf]
        assert _np(got).tobytes() == _np(want).tobytes()
        assert c.catalog.stats["replica_reads"] >= 1
        sm2 = psessions.SessionManager(c.tiered, c.catalog, owner="b")
        eng2 = pengine.ServeEngine(cfg, rt, params, tiered=c.tiered,
                                   label="b", device=cuda)
        sm2.resume("m", eng2)
        ref = pengine.ServeEngine(cfg, rt, params, device=cuda)
        ref.install_state(state)
        np.testing.assert_array_equal(eng2.decode(toks[:, -1], 3),
                                      ref.decode(toks[:, -1], 3))
        watchdog.synchronize()
    finally:
        c.shutdown()
