"""Port parity: serving through TieredIO against the JAX package's.

Each served arch at smoke size, both engines on a 2-node ``SimCluster``
of their own package (the port's on the CPU), from the same JAX
parameters: a nonblocking spill through the DLM write-back cache, its
buddy replica and ack, cold eviction, prefetch and a DRAM-hit resume give
the same tokens; a session spilled through either package's TieredIO
resumes in the other; ``peek_session`` reads the home pool and, after the
home node's loss, the replica; a spill onto a failed pool parks its host
copy; and the CLI serves through its one-node cluster.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import registry as jregistry
from repro.core.cluster import SimCluster as JSimCluster
from repro.models import transformer as jT
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.core.cluster import SimCluster
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine, SpillTicket

jax.config.update("jax_platform_name", "cpu")

B, PROMPT, GEN, EXTRA, MAX_SEQ = 2, 24, 3, 3, 40
ARCHS = ["gemma2-9b", "qwen2-72b", "recurrentgemma-9b", "mamba2-1.3b",
         "grok-1-314b", "arctic-480b"]


def _models(arch, dtype):
    jcfg = jregistry.get_smoke_config(arch)
    cfg = registry.get_smoke_config(arch)
    jrt = jT.ModelRuntime(tp=1, attn_impl="naive", max_seq=MAX_SEQ,
                          remat=False)
    rt = T.ModelRuntime(tp=1, attn_impl="pallas", max_seq=MAX_SEQ)
    jparams, _ = jT.init_params(jax.random.PRNGKey(0), jcfg, jrt)
    if dtype == jnp.float32:  # else bf16, and the f32 decay leaves stay
        jparams = jax.tree.map(lambda a: a.astype(dtype), jparams)
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    return (jcfg, jrt, jparams), (cfg, rt, jax.tree.map(np.asarray,
                                                        jparams)), prompts


def _bits(tree):
    return {p: bridge.to_numpy(a) for p, a in bridge.tree_leaves(tree)}


def _assert_bits(got, want):
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], path)


def _tiered_run(eng, cluster):
    """Prefill and decode, then a nonblocking spill, its replica ack,
    cold eviction, a prefetch and a resume from DRAM, and decode on.
    Returns the tokens and the DLM hit count of the resume."""
    out = eng.decode(eng.prefill(cluster["prompts"]), GEN)
    ticket = eng.spill("s", wait=False)
    ticket.result(timeout=60)
    assert eng.cache is None
    tiered = cluster["tiered"]
    assert tiered.quiesce() == []
    assert tiered.dlm_acks.targets("dlm/serve/s") == ["node1"]
    assert eng.evict_cold_sessions() == 1
    assert eng.prefetch_sessions(["s"]).result(timeout=60) == \
        {"hits": 0, "loads": 1, "missing": 0}
    h0 = tiered.cache.hits
    eng.resume("s")
    hits = tiered.cache.hits - h0
    more = eng.decode(out[:, -1], EXTRA)
    return np.concatenate([out, more[:, 1:]], axis=1), hits


@pytest.mark.parametrize("arch", ARCHS)
def test_tiered_spill_prefetch_resume_matches_jax(arch, tmp_path):
    """float32: the greedy tokens across the tiered spill/prefetch/resume
    are identical to JAX's tiered engine's, and the resume is a DRAM
    hit."""
    (jcfg, jrt, jparams), (cfg, rt, params), prompts = _models(
        arch, jnp.float32)
    jc = JSimCluster(tmp_path / "jax", n_nodes=2)
    try:
        jeng = JEngine(jcfg, jrt, jparams, store=jc.stores["node0"],
                       tiered=jc.tiered)
        want, jhits = _tiered_run(jeng, {"prompts": prompts,
                                         "tiered": jc.tiered})
    finally:
        jc.shutdown()
    c = SimCluster(tmp_path / "port", n_nodes=2, device="cpu")
    try:
        eng = ServeEngine(cfg, rt, params, store=c.stores["node0"],
                          tiered=c.tiered, device="cpu")
        got, hits = _tiered_run(eng, {"prompts": prompts,
                                      "tiered": c.tiered})
    finally:
        c.shutdown()
    np.testing.assert_array_equal(got, want)
    assert hits == jhits == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_tiered_sessions_resume_across_packages(arch, tmp_path):
    """bf16: a session spilled through JAX's TieredIO resumes through
    the port's (a cache miss read from the home pool), and one spilled
    through the port's resumes through JAX's, state bit for bit; the
    port's spill is byte-compatible: JAX re-spills it with the same
    leaf table."""
    (jcfg, jrt, jparams), (cfg, rt, params), prompts = _models(
        arch, jnp.bfloat16)
    jc = JSimCluster(tmp_path, n_nodes=2)
    try:
        jeng = JEngine(jcfg, jrt, jparams, store=jc.stores["node0"],
                       tiered=jc.tiered)
        jeng.decode(jeng.prefill(prompts), 2)
        jstate = _bits(jax.tree.map(np.asarray, jeng.export_state()))
        jeng.spill("j")
        jc.tiered.quiesce()
    finally:
        jc.shutdown()
    c = SimCluster(tmp_path, n_nodes=2, device="cpu")
    try:
        eng = ServeEngine(cfg, rt, params, tiered=c.tiered, device="cpu")
        eng.resume("j")
        _assert_bits(_bits(eng.export_state()), jstate)
        assert eng.pos == PROMPT + 2
        eng.decode(eng.prefill(prompts), 2)
        mine = _bits(eng.export_state())
        eng.spill("p", wait=False).result(timeout=60)
        assert c.tiered.quiesce() == []
    finally:
        c.shutdown()
    jc = JSimCluster(tmp_path, n_nodes=2)
    try:
        jeng = JEngine(jcfg, jrt, jparams, store=jc.stores["node0"],
                       tiered=jc.tiered)
        jeng.resume("p")
        _assert_bits(_bits(jax.tree.map(np.asarray, jeng.export_state())),
                     mine)
        jeng.spill("again")
        store = jc.stores["node0"]
        assert store.manifest("dlm/serve/p")["leaves"] == \
            store.manifest("dlm/serve/again")["leaves"]
        # the replica the port placed on node1, in JAX's layout
        assert jc.tiered.dlm_acks.targets("dlm/serve/p") == ["node1"]
        rep = jc.stores["node1"].get("replica/node0/dlm/serve/p")
        _assert_bits(_bits(jax.tree.map(np.asarray, rep)), mine)
    finally:
        jc.shutdown()


@pytest.mark.parametrize("codec", [None, True, {"strict": False}],
                         ids=["raw", "strict", "lossy"])
@pytest.mark.parametrize("arch", ["gemma2-9b", "mamba2-1.3b"])
def test_peek_and_resume_from_the_replica(arch, codec, tmp_path):
    """``peek_session`` of the cursor and of one state leaf from the
    home pool, then after the home node's loss from the (wire-encoded)
    replica, and a fresh engine's resume through the replica fallback:
    the same tokens as without the loss (the lossy codec: within its
    per-tile bound on float32 leaves, bf16 ships raw)."""
    _, (cfg, rt, params), prompts = _models(arch, jnp.float32)
    c = SimCluster(tmp_path, n_nodes=2, device="cpu", wire_codec=codec)
    try:
        eng = ServeEngine(cfg, rt, params, tiered=c.tiered, device="cpu")
        out = eng.decode(eng.prefill(prompts), GEN)
        state = eng.export_state()
        direct = eng.decode(out[:, -1], EXTRA)
        eng.install_state(state)
        eng.spill("x")
        assert c.tiered.quiesce() == []
        leaf = "cache/" + bridge.tree_leaves(state["cache"])[0][0]
        want = bridge.to_numpy(bridge.tree_leaves(state["cache"])[0][1])
        c.tiered.evict_cold()
        assert int(eng.peek_session("x", "pos")) == PROMPT + GEN
        np.testing.assert_array_equal(
            bridge.to_numpy(eng.peek_session("x", leaf)), want)
        c.kill_node("node0")
        assert int(eng.peek_session("x", "pos")) == PROMPT + GEN
        peeked = bridge.to_numpy(eng.peek_session("x", leaf))
        fresh = ServeEngine(cfg, rt, params, tiered=c.tiered, device="cpu")
        fresh.resume("x")
        back = _bits(fresh.export_state())
        lossy = isinstance(codec, dict)
        for path, want_leaf in _bits(state).items():
            got = back[path]
            if lossy and got.dtype == np.float32 and got.size >= 1024:
                scale = np.abs(want_leaf).max() / 127
                assert np.abs(got - want_leaf).max() <= scale / 2 + 1e-6
            else:
                np.testing.assert_array_equal(got, want_leaf, path)
        if not lossy:
            np.testing.assert_array_equal(peeked, want)
            np.testing.assert_array_equal(fresh.decode(out[:, -1], EXTRA),
                                          direct)
    finally:
        c.shutdown()


def test_failed_spill_parks_the_host_copy(tmp_path):
    """A spill onto a failed home pool: the ticket raises naming the
    session, the host copy waits in ``failed_spills``, and
    ``restore_failed_spill`` re-installs it bit for bit."""
    _, (cfg, rt, params), prompts = _models("gemma2-9b", jnp.bfloat16)
    c = SimCluster(tmp_path, n_nodes=2, device="cpu")
    try:
        eng = ServeEngine(cfg, rt, params, tiered=c.tiered, device="cpu")
        out = eng.decode(eng.prefill(prompts), GEN)
        copy = eng.export_state()
        before = _bits(copy)
        direct = eng.decode(out[:, -1], EXTRA)
        eng.install_state(copy)
        c.pools["node0"].fail()
        ticket = eng.spill("f", wait=False)
        assert isinstance(ticket, SpillTicket)
        with pytest.raises(RuntimeError, match="'f'"):
            ticket.result(timeout=60)
        assert eng.cache is None and "f" in eng.failed_spills
        eng.restore_failed_spill("f")
        assert "f" not in eng.failed_spills
        _assert_bits(_bits(eng.export_state()), before)
        np.testing.assert_array_equal(eng.decode(out[:, -1], EXTRA), direct)
    finally:
        c.shutdown()


def test_spill_ticket_parks_before_result_raises():
    """concurrent.futures wakes a waiter before it runs the done
    callbacks: the host copy must be parked by the time ``result()``
    raises, whether the callback ran yet or not. Here it never runs."""
    import concurrent.futures

    class LateCallbacks(concurrent.futures.Future):
        def add_done_callback(self, fn):
            pass

    class Engine:
        failed_spills = {}

    fut, eng, state = LateCallbacks(), Engine(), {"pos": np.int32(3)}
    ticket = SpillTicket("late", state, fut, eng)
    fut.set_exception(OSError("pool failed"))
    with pytest.raises(RuntimeError, match="'late'"):
        ticket.result(timeout=0)
    assert eng.failed_spills["late"] is state
    assert isinstance(ticket.exception(), OSError)


def test_decode_after_a_dram_hit_leaves_the_cached_entry(tmp_path):
    """Decoding writes the engine's device cache in place; the DLM entry
    a resume read (a DRAM hit) must keep its bytes."""
    _, (cfg, rt, params), prompts = _models("recurrentgemma-9b",
                                            jnp.bfloat16)
    c = SimCluster(tmp_path, n_nodes=2, device="cpu")
    try:
        eng = ServeEngine(cfg, rt, params, tiered=c.tiered, device="cpu")
        out = eng.decode(eng.prefill(prompts), GEN)
        eng.spill("d")
        h0 = c.dlm.hits
        eng.resume("d")
        assert c.dlm.hits == h0 + 1
        cached = _bits(c.dlm.peek("serve/d"))
        eng.decode(out[:, -1], EXTRA)
        _assert_bits(_bits(c.dlm.peek("serve/d")), cached)
    finally:
        c.shutdown()


def test_engine_needs_a_tiered_backend_for_prefetch(tmp_path):
    _, (cfg, rt, params), _ = _models("qwen2-72b", jnp.bfloat16)
    eng = ServeEngine(cfg, rt, params, device="cpu")
    for call in (lambda: eng.prefetch_sessions(["a"]),
                 lambda: eng.evict_cold_sessions(),
                 lambda: eng.resume("a")):
        with pytest.raises(RuntimeError, match="TieredIO|pmem"):
            call()
    with pytest.raises(RuntimeError, match="TieredIO"):
        eng.repair(["node1"])


def test_cli_serves_through_the_cluster_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.serve --device cpu``: the session
    spills through the one-node cluster's TieredIO (``dlm/serve/...`` on
    node0's pool), is prefetched and resumed."""
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "12",
                "--gen", "3", "--root", str(tmp_path)])
    assert "spill/resume ok" in capsys.readouterr().out
    assert (tmp_path / "pmem" / "node0" / "objects" / "dlm" / "serve" /
            "session0@v0.manifest").exists()
