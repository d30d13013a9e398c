"""Port parity: the SLM tier (``SLMTier``) and the paged KV tier
(``TieredKVCache``) against the JAX package.

The five SLM cases of ``tests/test_replication.py`` run on a JAX store
and on a port store with the same numpy inputs (and on the card's
behalf, tensor leaves: bf16 stays ``torch.bfloat16``); the paged KV tier
runs JAX's put/get/prefetch/evict sequence on both with equal ``stats``;
and an offload by one package is fetched by a fresh tier of the other
through the ``slm/<name>.head.json`` pointer. CPU tensors throughout.
"""
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.object_store import PMemObjectStore as JStore
from repro.core.pmem import PMemPool as JPool
from repro.core.tiering import SLMTier as JSLMTier
from repro.core.tiering import TieredKVCache as JTieredKVCache
from repro_torch import bridge
from repro_torch.core.object_store import PMemObjectStore
from repro_torch.core.pmem import PMemPool
from repro_torch.core.tiering import SLMTier, TieredKVCache


def _stores(root):
    """(JAX store, port store) over the same pool."""
    return (JStore(JPool(Path(root), "node0")),
            PMemObjectStore(PMemPool(Path(root), "node0"), device="cpu"))


def _np(x):
    return bridge.to_numpy(x)


def _both(tmp_path, scenario):
    """``scenario(store, tier_cls)`` on a JAX store and on a port store:
    (jax result, port result)."""
    j, _ = _stores(tmp_path / "jax")
    _, p = _stores(tmp_path / "port")
    return scenario(j, JSLMTier), scenario(p, SLMTier)


def _opt_tree(seed=0):
    r = np.random.default_rng(seed)
    return {"m": r.standard_normal(8).astype(np.float32),
            "v": np.ones(4, np.float32), "p": np.zeros(2, np.float32),
            "emb": r.standard_normal((6, 5)).astype(ml_dtypes.bfloat16)}


def _flat(tree):
    return {p: _np(v) for p, v in bridge.tree_leaves(tree)}


# ---------------------------------------------------------------------------
# tests/test_replication.py's SLM cases
# ---------------------------------------------------------------------------

def test_slm_roundtrip_and_isolation(tmp_path):
    def scenario(st, Tier):
        tree = _opt_tree(1)
        a = Tier(st, "opt")
        resident, handle = a.offload(tree, ["m", "v", "emb"])
        assert sorted(resident) == ["p"]
        return handle, _flat(a.fetch(resident, handle))
    theirs, mine = _both(tmp_path, scenario)
    assert mine[0] == theirs[0] == ["emb", "m", "v"]
    assert sorted(mine[1]) == sorted(theirs[1])
    for path, want in _flat(_opt_tree(1)).items():
        assert mine[1][path].tobytes() == want.tobytes() == \
            theirs[1][path].tobytes(), path


def test_slm_offload_of_tensors_fetches_host_leaves(tmp_path):
    """Leaves on the device (CPU tensors here) offload like numpy ones;
    fetch returns the store's host leaves: numpy, bf16 as a
    ``torch.bfloat16`` tensor, bit for bit."""
    _, st = _stores(tmp_path)
    tree = bridge.tree_map(bridge.to_torch, _opt_tree(2))
    t = SLMTier(st, "opt")
    resident, handle = t.offload(tree, ["m", "emb"])
    out = t.fetch(resident, handle)
    assert isinstance(out["m"], np.ndarray)
    assert isinstance(out["emb"], torch.Tensor) and \
        out["emb"].dtype == torch.bfloat16 and out["emb"].device.type == "cpu"
    assert out["p"] is tree["p"]  # resident leaves are not copied
    for path, want in _flat(_opt_tree(2)).items():
        assert _np(out[path]).tobytes() == want.tobytes(), path


def test_slm_offload_survives_process_restart(tmp_path):
    """A FRESH tier instance (new process) recovers the leaves through
    the persisted head pointer."""
    def scenario(st, Tier):
        tree = {"m": np.arange(8, dtype=np.float32)}
        resident, handle = Tier(st, "opt").offload(tree, ["m"])
        return _np(Tier(st, "opt").fetch(resident, handle)["m"]).tolist()
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == list(range(8))


def test_slm_fetch_before_offload_fails_loudly(tmp_path):
    def scenario(st, Tier):
        with pytest.raises(RuntimeError):
            Tier(st, "opt").fetch({}, [])
        return True
    assert _both(tmp_path, scenario) == (True, True)


def test_slm_racing_offload_detected(tmp_path):
    """Another writer clobbering our versioned object with a different
    tag fails fetch instead of silently merging."""
    def scenario(st, Tier):
        a = Tier(st, "opt")
        resident, handle = a.offload(
            {"m": np.arange(8, dtype=np.float32)}, ["m"])
        st.put("slm/opt", {"m": np.zeros(8, np.float32)},
               version=a._version, meta={"v": 12345})
        with pytest.raises(IOError):
            a.fetch(resident, handle)
        return True
    assert _both(tmp_path, scenario) == (True, True)


def test_slm_two_instances_stay_isolated(tmp_path):
    def scenario(st, Tier):
        a, b = Tier(st, "opt"), Tier(st, "opt")
        tree_a = {"m": np.full(8, 1.0, np.float32)}
        tree_b = {"m": np.full(8, 2.0, np.float32)}
        res_a, h_a = a.offload(tree_a, ["m"])
        res_b, h_b = b.offload(tree_b, ["m"])
        out = [_np(b.fetch(res_b, h_b)["m"]).tolist()]
        # a's fetch returns a's own leaves or raises, never b's data
        try:
            out.append(_np(a.fetch(res_a, h_a)["m"]).tolist())
        except IOError:
            out.append("raised")
        return out
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs
    assert mine[0] == [2.0] * 8 and mine[1] in ([1.0] * 8, "raised")


def test_slm_offload_reclaims_the_superseded_version(tmp_path):
    """A second offload deletes the first version's bytes (in both
    packages), and a fresh tier's offload reclaims what the head
    pointed at."""
    def scenario(st, Tier):
        a = Tier(st, "opt")
        a.offload({"m": np.ones(4, np.float32)}, ["m"])
        v1 = a._version
        a.offload({"m": np.zeros(4, np.float32)}, ["m"])
        v2 = a._version
        Tier(st, "opt").offload({"m": np.ones(4, np.float32)}, ["m"])
        return [st.exists("slm/opt", v1), st.exists("slm/opt", v2),
                a.cleanup_failures]
    theirs, mine = _both(tmp_path, scenario)
    assert mine == theirs == [False, False, 0]


# ---------------------------------------------------------------------------
# across packages: the head pointer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_slm_offload_fetched_by_the_other_package(writer, tmp_path):
    """An offload by one package, fetched by a FRESH tier of the other
    through ``slm/<name>.head.json``; the head's format is JAX's."""
    jst, pst = _stores(tmp_path)
    tree = _opt_tree(3)
    if writer == "jax":
        resident, handle = JSLMTier(jst, "opt").offload(tree, ["m", "emb"])
        out = SLMTier(pst, "opt").fetch(resident, handle)
    else:
        ptree = bridge.tree_map(bridge.to_torch, tree)
        resident, handle = SLMTier(pst, "opt").offload(ptree, ["m", "emb"])
        out = JSLMTier(jst, "opt").fetch(
            bridge.tree_map(_np, resident), handle)
    head = jst.pool.get_json("slm/opt.head.json")
    assert sorted(head) == ["v"] and isinstance(head["v"], int)
    assert handle == ["emb", "m"]
    for path, want in _flat(tree).items():
        assert _np(out[path]).tobytes() == want.tobytes(), path


# ---------------------------------------------------------------------------
# the paged KV tier
# ---------------------------------------------------------------------------

def _kv(seed):
    r = np.random.default_rng(seed)
    return {"k": r.standard_normal((2, 16)).astype(ml_dtypes.bfloat16),
            "v": r.standard_normal((2, 16)).astype(np.float32)}


def _kv_script(tier, to_leaf):
    """Put six pages into a cache holding about four, read some back
    (hits and misses through pmem), prefetch cold and warm pages, evict
    the idle ones; the stats along the way and every page read."""
    out, reads = [], {}
    for p in range(6):
        tier.put_page(0, p % 2, p, bridge.tree_map(to_leaf, _kv(p)))
    out.append(dict(tier.stats))
    for p in (5, 0, 1, 5):
        reads[p] = {k: _np(v) for k, v in tier.get_page(0, p % 2, p).items()}
    out.append(dict(tier.stats))
    out.append([tier.prefetch_page(0, 0, 2), tier.prefetch_page(0, 1, 5)])
    out.append(dict(tier.stats))
    out.append(tier.evict_cold(0.0))
    out.append(dict(tier.stats))
    for p in (2, 3):
        reads[p] = {k: _np(v) for k, v in tier.get_page(0, p % 2, p).items()}
    out.append(dict(tier.stats))
    return out, reads


def test_tiered_kv_cache_put_get_prefetch_evict(tmp_path):
    page = sum(_np(a).nbytes for a in _kv(0).values())
    jst, _ = _stores(tmp_path / "jax")
    _, pst = _stores(tmp_path / "port")
    theirs, jreads = _kv_script(JTieredKVCache(jst, 4 * page),
                                lambda a: a)
    mine, preads = _kv_script(TieredKVCache(pst, 4 * page),
                              bridge.to_torch)
    assert mine == theirs
    assert mine[-1]["evictions"] > 0 and mine[-1]["misses"] > 0 and \
        mine[-1]["hits"] > 0
    for p, kv in preads.items():
        for k, want in _kv(p).items():
            assert kv[k].tobytes() == _np(want).tobytes() == \
                jreads[p][k].tobytes(), (p, k)
    assert TieredKVCache.page_name(3, 1, 7) == \
        JTieredKVCache.page_name(3, 1, 7) == "kv/3/1/7"
