"""The port's own pmemlint and persistence sanitizer (``repro_torch.analysis``)
against the JAX package's, on the CPU.

Lint: every golden snippet of ``tests/test_analysis.py`` gives the same
findings (rule, line, function, key) under both packages' passes and the
outcome JAX's test asserts; both linters give the same raw fingerprints on
``src/repro`` (on the port's own tree, ``tests/test_torch_lint.py``); the
baseline round trip and the CLI's exit codes. Sanitizer: JAX's sanitizer tests on the port's
pmem; the same four MetaLog appends through each package under its own
sanitizer give the same operations, crash images and reached prefixes;
the port's flight ring and a crash mid-``copy_object`` enumerated as in
``tests/test_obs.py`` and ``tests/test_zero_copy.py``; a 4-node port
cluster's drained saves, node loss, repair and shutdown run clean; a
MetaLog append without its entry flush is flagged; the pytest plugin in
a subprocess.
"""
import inspect
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import locks as jlocks
from repro.analysis import persistence as jpersistence
from repro.analysis import recovery as jrecovery
from repro.analysis.core import collect as jcollect
from repro.analysis.lint import run_lint as jrun_lint
from repro.analysis.sanitizer import PMemSanitizer as JPMemSanitizer
from repro.core.meta_log import MetaLog as JMetaLog
from repro.core.object_store import PMemObjectStore as JPMemObjectStore
from repro.core.pmem import PMemPool as JPMemPool
from repro_torch.analysis import PMemSanitizer, locks, persistence, recovery
from repro_torch.analysis.core import collect
from repro_torch.analysis.lint import main as lint_main
from repro_torch.analysis.lint import run_lint
from repro_torch.core import meta_log as meta_log_mod
from repro_torch.core.cluster import SimCluster
from repro_torch.core.meta_log import MetaLog
from repro_torch.core.object_store import PMemObjectStore, copy_object
from repro_torch.core.pmem import PMemPool
from repro_torch.obs.recorder import EVT_POINT, FlightRecorder

REPO = Path(__file__).resolve().parents[1]
PASSES = (persistence.run, recovery.run, locks.run)
JPASSES = (jpersistence.run, jrecovery.run, jlocks.run)

# ---- lint: the golden snippets of tests/test_analysis.py -------------

CASES = {
    "missing_flush": ("""
        def write_no_flush(pool, data):
            region = pool.create("x", 64)
            region.write(0, data)
    """, {"missing-flush"}, set()),
    "write_then_flush": ("""
        def write_flush(pool, data):
            region = pool.create("x", 64)
            region.write(0, data)
            region.flush()
    """, None, None),
    "commit_before_flush": ("""
        def commit_unflushed(pool, data):
            region = pool.open("x")
            region.write(0, data)
            pool.put_json("m.json", {"ok": 1})
    """, {"commit-before-flush"}, set()),
    "tail_advance_without_flush": ("""
        _TAIL_OFF = 8

        def torn_append(pool, blob, tail_bytes):
            region = pool.open("log")
            region.write(64, blob)
            region.write(_TAIL_OFF, tail_bytes)
            region.flush()
    """, {"commit-before-flush"}, set()),
    "disciplined_append": ("""
        _TAIL_OFF = 8

        def good_append(pool, blob, tail_bytes):
            region = pool.open("log")
            region.write(64, blob)
            region.flush()
            region.write(_TAIL_OFF, tail_bytes)
            region.flush()
    """, None, None),
    "raw_pool_path": ("""
        def raw_touch(pool):
            with open(pool.root / "obj.bin", "wb") as f:
                f.write(b"x")
    """, {"raw-pool-path"}, set()),
    "raw_pool_path_suppressed": ("""
        def raw_touch(pool):
            with open(pool.root / "obj.bin", "wb") as f:  # pmemlint: disable=raw-pool-path
                f.write(b"x")
    """, set(), {"raw-pool-path"}),
    "silent_swallow": ("""
        def persist(pool, obj):
            try:
                pool.put_json("m.json", obj)
            except IOError:
                pass
    """, {"silent-swallow"}, set()),
    "accounted_failure": ("""
        def persist(pool, obj, stats):
            try:
                pool.put_json("m.json", obj)
            except IOError:
                stats["put_failures"] += 1
    """, set(), {"silent-swallow"}),
    "metadata_only_direct_read": ("""
        from repro_torch.analysis.annotations import metadata_only

        class Catalog:
            @metadata_only
            def decide(self):
                return self.store.get("obj")
    """, {"metadata-only-read"}, set()),
    "metadata_only_transitive_read": ("""
        from repro_torch.analysis.annotations import metadata_only

        class Catalog:
            @metadata_only
            def decide(self):
                return self._probe()

            def _probe(self):
                return self.store.get("obj")
    """, {"metadata-only-read"}, set()),
    "metadata_only_stops_at_rehydration_entry": ("""
        from repro_torch.analysis.annotations import metadata_only, \\
            rehydration_entry

        class Catalog:
            @metadata_only
            def decide(self):
                return self._copy()

            @rehydration_entry
            def _copy(self):
                return self.store.get("obj")
    """, set(), {"metadata-only-read"}),
    "metadata_only_plain_dict_get": ("""
        from repro_torch.analysis.annotations import metadata_only

        class Catalog:
            @metadata_only
            def decide(self, rec):
                return rec.get("acks")
    """, set(), {"metadata-only-read"}),
    "metadata_only_closure_read": ("""
        from repro_torch.analysis.annotations import metadata_only

        class Catalog:
            @metadata_only
            def decide(self):
                def go():
                    return self.store.get("obj")
                return go
    """, {"metadata-only-read"}, set()),
    "unguarded_write": ("""
        import threading

        class Registry:
            def __init__(self):
                self.lock = threading.Lock()
                self.cache = {}

            def put(self, k, v):
                with self.lock:
                    self.cache[k] = v

            def fill(self, k, v):
                self.cache[k] = v
    """, {"unguarded-write"}, set()),
    "lock_held_helper": ("""
        import threading

        class Registry:
            def __init__(self):
                self.lock = threading.Lock()
                self.cache = {}

            def put(self, k, v):
                with self.lock:
                    self._insert(k, v)

            def drop(self, k):
                with self.lock:
                    self._insert(k, None)

            def _insert(self, k, v):
                self.cache[k] = v
    """, set(), {"unguarded-write"}),
    "closure_write_counts_as_unguarded": ("""
        import threading

        class Registry:
            def __init__(self):
                self.lock = threading.Lock()
                self.acked = {}

            def put(self, k, v):
                with self.lock:
                    self.acked[k] = v

            def make_callback(self, k):
                def cb(result):
                    self.acked[k] = result
                return cb
    """, {"unguarded-write"}, set()),
    "blocking_under_lock": ("""
        import threading

        class Channel:
            def __init__(self):
                self.lock = threading.Lock()

            def flush_one(self, fut):
                with self.lock:
                    return fut.result()
    """, {"blocking-under-lock"}, set()),
    "blocking_outside_lock": ("""
        import threading

        class Channel:
            def __init__(self):
                self.lock = threading.Lock()
                self.n = 0

            def flush_one(self, fut):
                with self.lock:
                    self.n += 1
                return fut.result()
    """, set(), {"blocking-under-lock"}),
    "string_join_not_blocking": ("""
        import threading

        class Fmt:
            def __init__(self):
                self.lock = threading.Lock()

            def render(self, parts):
                with self.lock:
                    return b"".join(parts)
    """, set(), {"blocking-under-lock"}),
}


def _key(findings):
    return [(f.rule, f.line, f.func, f.key) for f in findings]


def _both(tmp_path, source):
    f = tmp_path / "snippet.py"
    f.write_text(textwrap.dedent(source))
    port = [x for p in PASSES for x in p(collect([f], tmp_path))]
    ref = [x for p in JPASSES for x in p(jcollect([f], tmp_path))]
    return port, ref


@pytest.mark.parametrize("case", sorted(CASES))
def test_lint_snippet_matches_jax(tmp_path, case):
    """Both packages' passes give the same findings, and the port's the
    outcome ``tests/test_analysis.py`` asserts (``None``: no finding at
    all; else these rules flagged and those not)."""
    source, flagged, clean = CASES[case]
    port, ref = _both(tmp_path, source)
    assert _key(port) == _key(ref)
    assert [f.message for f in port] == [f.message for f in ref]
    rules = {f.rule for f in port}
    if flagged is None:
        assert port == []
    else:
        assert flagged <= rules and not (clean & rules), rules
    if case == "metadata_only_transitive_read":
        hit = [f for f in port if f.rule == "metadata-only-read"][0]
        assert hit.func == "Catalog.decide" and "_probe" in hit.message
    if case == "unguarded_write":
        hit = [f for f in port if f.rule == "unguarded-write"][0]
        assert hit.func == "Registry.fill"


def test_lint_raw_fingerprints_match_jax():
    """Both lints over JAX's package (the port's own tree, and a tree
    with a finding, are held in ``tests/test_torch_lint.py``)."""
    path = REPO / "src" / "repro"
    port = run_lint([path], REPO)
    ref = jrun_lint([path], REPO)
    assert sorted(f.fingerprint for f in port) == \
        sorted(f.fingerprint for f in ref)
    assert [f.render() for f in port] == [f.render() for f in ref]


def test_lint_main_baseline_roundtrip(tmp_path, capsys):
    snip = tmp_path / "bad.py"
    snip.write_text(textwrap.dedent("""
        def write_no_flush(pool, data):
            region = pool.create("x", 64)
            region.write(0, data)
    """))
    base = tmp_path / "baseline.json"
    assert lint_main([str(snip), "--no-baseline"]) == 1
    assert lint_main([str(snip), "--baseline", str(base),
                      "--update-baseline"]) == 0
    assert lint_main([str(snip), "--baseline", str(base)]) == 0
    snip.write_text(snip.read_text() + textwrap.dedent("""
        def persist(pool, obj):
            try:
                pool.put_json("m.json", obj)
            except IOError:
                pass
    """))
    assert lint_main([str(snip), "--baseline", str(base)]) == 1
    # the port's checked-in baseline is empty, as JAX's is
    assert json.loads((REPO / "src" / "repro_torch" / "analysis" /
                       "baseline.json").read_text())["findings"] == []
    assert lint_main(["no/such/dir"]) == 2
    assert "no such path" in capsys.readouterr().err


# ---- sanitizer: live ordering checks on the port's pmem --------------

_MAGIC = b"MLOG1\x00"


def _mk_pool(path, cls=PMemPool):
    return cls(path, "node0", capacity_bytes=1 << 24)


def _absolve(request):
    """Tests below stage violations on purpose. Under the plugin's
    ``--torch-pmem-sanitize`` the autouse shim records them too: clear
    it so the deliberate bad sequence does not fail the run."""
    try:
        outer = request.getfixturevalue("_torch_pmem_sanitize")
    except pytest.FixtureLookupError:
        return
    if outer is not None:
        outer.violations.clear()
        for st in outer.regions.values():
            st.dirty = False


def _u8(b):
    return np.frombuffer(b, dtype=np.uint8)


def test_sanitizer_flags_tail_advance_over_unflushed(tmp_path, request):
    san = PMemSanitizer().install()
    try:
        region = _mk_pool(tmp_path).create("t/log", 4096)
        region.write(0, _u8(_MAGIC))
        region.flush()
        region.write(64, np.full(16, 7, dtype=np.uint8))
        region.write(8, _u8((80).to_bytes(8, "little")))
        region.flush()
    finally:
        san.uninstall()
    assert any("committed-tail" in v for v in san.violations)
    with pytest.raises(AssertionError, match="committed-tail"):
        san.raise_violations()
    _absolve(request)


def test_sanitizer_accepts_disciplined_append(tmp_path):
    san = PMemSanitizer().install()
    try:
        region = _mk_pool(tmp_path).create("t/log", 4096)
        region.write(0, _u8(_MAGIC))
        region.flush()
        region.write(64, np.full(16, 7, dtype=np.uint8))
        region.flush()
        region.write(8, _u8((80).to_bytes(8, "little")))
        region.flush()
    finally:
        san.uninstall()
    assert san.violations == []
    assert san.stats["tail_advances"] == 1
    san.raise_violations()


@pytest.mark.parametrize("how", ["close", "delete"])
def test_sanitizer_flags_dirty_drop(tmp_path, request, how):
    san = PMemSanitizer().install()
    try:
        pool = _mk_pool(tmp_path)
        region = pool.create("t/x", 64)
        region.write(0, np.full(8, 1, dtype=np.uint8))
        if how == "close":
            region.close()  # close() flushes, but a crash never calls it
        else:
            pool.delete("t/x")
    finally:
        san.uninstall()
    want = "dirty-close" if how == "close" else "dirty-drop"
    assert any(want in v for v in san.violations), san.violations
    _absolve(request)


def test_sanitizer_flags_a_tensor_at_the_region_boundary(tmp_path, request):
    """The port's own rule: a torch tensor handed to ``region.write`` is a
    violation (numpy would convert a float32 one silently)."""
    san = PMemSanitizer().install()
    try:
        region = _mk_pool(tmp_path).create("t/x", 64)
        region.write(0, torch.ones(4, dtype=torch.float32))
        region.flush()
        region.write(16, np.ones(4, np.float32))
        region.flush()
    finally:
        san.uninstall()
    assert len(san.violations) == 1 and \
        "region-boundary" in san.violations[0] and \
        "torch.Tensor" in san.violations[0], san.violations
    assert san.stats["writes"] == 2
    _absolve(request)


def test_metalog_append_passes_sanitizer(tmp_path):
    san = PMemSanitizer().install()
    try:
        stores = {"node0": PMemObjectStore(_mk_pool(tmp_path), device="cpu")}
        log = MetaLog(stores, ["node0"], "t/log", fold=_fold)
        for i in range(6):
            log.append({"i": i, "v": i * 10})
        assert log.state() == {str(i): i * 10 for i in range(6)}
    finally:
        san.uninstall()
    san.raise_violations()
    assert san.stats["tail_advances"] >= 6


def test_crash_images_requires_capture():
    with pytest.raises(RuntimeError):
        list(PMemSanitizer().crash_images("x"))


# ---- crash-state enumeration -----------------------------------------

def _fold(state, ev):
    state[str(ev["i"])] = ev["v"]


def _metalog_images(tmp_path, san_cls, pool_cls, store_cls, log_cls, n,
                    **store_kw):
    """``n`` appends to a one-node MetaLog under a capture-mode sanitizer,
    then every crash image replayed. Returns (the log region's operations,
    image count, reached prefix lengths, stats)."""
    san = san_cls(capture=True).install()
    try:
        stores = {"node0": store_cls(_mk_pool(tmp_path / "live", pool_cls),
                                     **store_kw)}
        log = log_cls(stores, ["node0"], "t/log", fold=_fold)
        for i in range(n):
            log.append({"i": i, "v": i * 10})
    finally:
        san.uninstall()
    san.raise_violations()
    prefixes = [{str(j): j * 10 for j in range(k)} for k in range(n + 1)]
    images = list(san.crash_images("t/log"))
    reached = set()
    for label, img in images:
        rpool = _mk_pool(tmp_path / "replay", pool_cls)
        san_cls.materialize(img, rpool, "t/log")
        state = dict(log_cls({"node0": store_cls(rpool, **store_kw)},
                             ["node0"], "t/log", fold=_fold).state())
        assert state in prefixes, \
            f"crash state {label} replayed to non-prefix {state}"
        reached.add(len(state))
    [st] = [s for s in san.regions.values() if s.path.endswith("t/log")]
    ops = [("tail" if op == "write" and off == 8 and p is not None and
            len(p) == 8 else op) for op, off, p in st.events]
    return ops, len(images), reached, dict(san.stats)


def test_crash_images_replay_to_committed_prefix(tmp_path):
    """Every crash state of the port's MetaLog append sequence replays to
    a committed prefix of the appended events, and the enumeration
    reaches more than the final state."""
    n = 4
    _ops, count, reached, _ = _metalog_images(
        tmp_path, PMemSanitizer, PMemPool, PMemObjectStore, MetaLog, n,
        device="cpu")
    assert count >= 3 * n
    assert len(reached) > 1


def test_metalog_crash_images_match_jax(tmp_path):
    """The same four appends through JAX's MetaLog under JAX's sanitizer
    and through the port's under the port's: the same operations on the
    log region (write / flush / tail advance), the same number of crash
    images and the same reached prefix lengths (bytes differ by the
    random epoch and the timestamps)."""
    port = _metalog_images(tmp_path / "port", PMemSanitizer, PMemPool,
                           PMemObjectStore, MetaLog, 4, device="cpu")
    ref = _metalog_images(tmp_path / "jax", JPMemSanitizer, JPMemPool,
                          JPMemObjectStore, JMetaLog, 4)
    assert port[0] == ref[0]
    assert "tail" in port[0] and "flush" in port[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2] == set(range(5))
    assert port[3] == ref[3]


def test_flight_ring_torn_tail_replay_is_committed_prefix(tmp_path):
    """``tests/test_obs.py``'s torn-tail test on the port's ring: every
    image the sanitizer enumerates replays to a clean prefix of the
    committed events."""
    san = PMemSanitizer(capture=True).install()
    try:
        pool = PMemPool(tmp_path / "live", "node0")
        rec = FlightRecorder(pool, slots=8, slot_bytes=128)
        for i in range(6):
            rec.record(EVT_POINT, f"ev{i}", attrs={"i": i})
        full = [e["attrs"]["i"] for e in FlightRecorder.replay(pool)]
        assert full == list(range(6))
        spool = PMemPool(tmp_path / "replay", "node0")
        lens = set()
        n_images = 0
        for label, img in san.crash_images("flightring"):
            n_images += 1
            san.materialize(img, spool, "obs/flightring")
            got = [e["attrs"]["i"] for e in FlightRecorder.replay(spool)]
            assert got == full[:len(got)], label
            lens.add(len(got))
    finally:
        san.uninstall()
    san.raise_violations()
    # one header write and 2 writes a record: 13 writes, 3 images each
    assert n_images == 3 * 13
    assert lens == set(range(7))


def _tree(seed=0, n=256):
    r = np.random.RandomState(seed)
    return {"layer": {"w": r.randn(n, 8).astype(np.float32),
                      "b": r.randn(8).astype(np.float32)},
            "ids": np.arange(n, dtype=np.int32)}


def _crash_mid_copy(tmp, san, codec=None):
    """``tests/test_zero_copy.py``'s crash mid-copy on the port's stores:
    the commit fails, nothing is acked, and no crash image of the
    destination's writes makes the object visible. Returns the image
    count."""
    st = {n: PMemObjectStore(PMemPool(tmp, n), device="cpu")
          for n in ("a", "b")}
    st["a"].put("obj", _tree(7), meta={"step": 3})
    acked = []
    orig = st["b"].pool.put_json

    def failing_put_json(name, obj):
        if name.endswith(".manifest"):
            raise IOError("injected crash at the commit point")
        return orig(name, obj)

    st["b"].pool.put_json = failing_put_json
    with pytest.raises(IOError):
        acked.append(copy_object(st["a"], st["b"], "obj",
                                 expect_meta={"step": 3}, chunk_bytes=1024,
                                 codec=codec))
    st["b"].pool.put_json = orig
    assert acked == [] and not st["b"].exists("obj")
    images = [(label, img) for label, img
              in san.crash_images("b/objects/obj") if ".data" in label]
    assert images, "no destination write states captured"
    for label, img in images:
        assert ".shadow" in label
        san.materialize(img, st["b"].pool, "objects/obj@v0.data")
        assert not st["b"].exists("obj"), label
    man = copy_object(st["a"], st["b"], "obj", expect_meta={"step": 3},
                      codec=codec)
    out = st["b"].get("obj", verify=True)
    assert man["meta"]["step"] == 3
    got = out["layer"]["w"]
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    if codec is None:
        np.testing.assert_array_equal(got, _tree(7)["layer"]["w"])
    return len(images)


@pytest.mark.parametrize("codec", [None, {"strict": False}],
                         ids=["raw", "lossy_codec"])
def test_crash_mid_copy_never_commits_partial_replica(tmp_path, codec):
    san = PMemSanitizer(capture=True).install()
    try:
        n = _crash_mid_copy(tmp_path, san, codec)
    finally:
        san.uninstall()
    san.raise_violations()
    assert n >= 3


def test_cluster_saves_node_loss_and_repair_run_clean(tmp_path):
    """A 4-node port cluster: three drained saves, node3 lost, repair and
    shutdown, every pmem write under the sanitizer: no violation (regions
    of the dead pool are crash debris, not faults)."""
    san = PMemSanitizer().install()
    try:
        c = SimCluster(tmp_path, n_nodes=4, device="cpu")
        try:
            for step in (1, 2, 3):
                tree = {"w": torch.randn(64, 32, generator=torch.Generator()
                                         .manual_seed(step)),
                        "b": torch.arange(step, step + 16,
                                          dtype=torch.int32)}
                c.tiered.save_async(step, tree, drain=True).result()
            c.tiered.join()
            c.kill_node("node3")
            report = c.repair(["node3"])
            assert not report.get("errors"), report
            got, _ = c.checkpointer.restore(3, lost_nodes=["node3"])
            assert torch.equal(got["b"], torch.arange(3, 19,
                                                      dtype=torch.int32))
        finally:
            c.shutdown()
    finally:
        san.uninstall()
    san.raise_violations()
    assert san.stats["writes"] > 100 and san.stats["tail_advances"] > 10


def test_metalog_append_without_its_entry_flush_is_flagged(
        tmp_path, monkeypatch, request):
    """A negative control: the port's ``MetaLog._append_pool`` with the
    flush between the entry bytes and the tail advance taken out is
    caught as a committed-tail violation."""
    src = textwrap.dedent(inspect.getsource(MetaLog._append_pool))
    entry = ("region.write(tail, np.frombuffer(blob, dtype=np.uint8))\n"
             "    region.flush()\n")
    assert src.count(entry) == 1
    ns = {}
    exec(compile(src.replace(entry, entry.split("\n")[0] + "\n"),
                 meta_log_mod.__file__, "exec"), vars(meta_log_mod), ns)
    monkeypatch.setattr(MetaLog, "_append_pool", ns["_append_pool"])
    san = PMemSanitizer().install()
    try:
        stores = {"node0": PMemObjectStore(_mk_pool(tmp_path), device="cpu")}
        log = MetaLog(stores, ["node0"], "t/log", fold=_fold)
        log.append({"i": 0, "v": 0})
    finally:
        san.uninstall()
    assert any(v.startswith("committed-tail") for v in san.violations), \
        san.violations
    _absolve(request)


# ---- the pytest plugin -----------------------------------------------

PLUGIN_TESTS = '''
import numpy as np
from repro_torch.core.meta_log import MetaLog
from repro_torch.core.object_store import PMemObjectStore
from repro_torch.core.pmem import PMemPool


def _fold(state, ev):
    state[str(ev["i"])] = ev["v"]


def test_port_crash_images(tmp_path, torch_pmem_sanitizer,
                           _torch_pmem_sanitize):
    assert _torch_pmem_sanitize is not None
    pool = PMemPool(tmp_path / "live", "node0")
    log = MetaLog({"node0": PMemObjectStore(pool, device="cpu")}, ["node0"],
                  "t/log", fold=_fold)
    for i in range(3):
        log.append({"i": i, "v": i})
    images = list(torch_pmem_sanitizer.crash_images("t/log"))
    for label, img in images:
        rpool = PMemPool(tmp_path / "replay", "node0")
        torch_pmem_sanitizer.materialize(img, rpool, "t/log")
        state = MetaLog({"node0": PMemObjectStore(rpool, device="cpu")},
                        ["node0"], "t/log", fold=_fold).state()
        assert dict(state) in [{str(j): j for j in range(k)}
                               for k in range(4)], label
    assert len(images) >= 9


def test_leaves_a_region_dirty(tmp_path):
    region = PMemPool(tmp_path, "node0").create("x", 64)
    region.write(0, np.ones(8, np.uint8))
'''


def test_pytest_plugin_runs_tests_under_the_sanitizer(tmp_path):
    """``-p repro_torch.analysis.pytest_plugin --torch-pmem-sanitize``: a
    port crash test passes, a test that leaves a region dirty fails at
    teardown; without the flag both pass."""
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    (tmp_path / "test_plugin_cases.py").write_text(PLUGIN_TESTS)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    base = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
            "-p", "repro_torch.analysis.pytest_plugin",
            "--rootdir", str(tmp_path), str(tmp_path)]
    on = subprocess.run(base + ["--torch-pmem-sanitize"], cwd=tmp_path,
                        env=env, capture_output=True, text=True,
                        timeout=120)
    assert on.returncode == 1, on.stdout + on.stderr
    # the dirty test's body passes, its teardown errors
    assert "2 passed, 1 error" in on.stdout, on.stdout
    assert "dirty-teardown" in on.stdout, on.stdout
    assert "test_leaves_a_region_dirty" in on.stdout
    off = subprocess.run(base + ["-k", "dirty"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert off.returncode == 0 and "1 passed" in off.stdout, off.stdout
