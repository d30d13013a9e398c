"""Fleet serving on persistent memory, on the PyTorch port: two workers
share a warm prefix dataset, a node dies mid-traffic, and every session
resumes from its acked replica, bit-exactly, with zero blind object-store
probes.

The counterpart of ``examples/serve_longcontext.py`` (same flow, same
printed lines), through ``repro_torch``'s ServeEngine, SessionManager and
SimCluster:

  1. worker A prefills a shared system prompt ONCE and publishes the
     state as catalog dataset ``prefix/system``;
  2. workers A and B each start a user session forked from that prefix
     and decode some traffic;
  3. both sessions are suspended: each becomes a leased version of
     dataset ``sess/<name>``, home pmem write + buddy replica acked
     through the exchange channel;
  4. a node is killed. ``recoverable_sessions`` answers from catalog
     records alone which sessions survive (all of them);
  5. worker B resumes BOTH sessions, including the one worker A created
     (adoption from the catalog record), off the dead node's acked
     replicas. A store-read audit shows zero blind probes, and the
     continuation matches an uninterrupted reference run bit-exactly.

The model is qwen2-72b's smoke config with random weights from a seeded
``torch.Generator``; the engines run on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_serve_longcontext.py [--device cpu]
"""
import argparse
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.cluster import SimCluster  # noqa: E402
from repro_torch.core.dataset_exchange import ack_targets  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.sessions import SessionManager  # noqa: E402


def _audit_store_reads(cluster):
    reads = []
    for nid, st in cluster.stores.items():
        for meth in ("get_with_manifest", "exists", "get_leaf"):
            orig = getattr(st, meth)

            def wrapped(name, *a, _orig=orig, _nid=nid, **kw):
                reads.append((_nid, name))
                return _orig(name, *a, **kw)

            setattr(st, meth, wrapped)
    return reads


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = registry.get_smoke_config("qwen2-72b")
    rt = T.ModelRuntime(tp=1, attn_impl="pallas", max_seq=128)
    params = T.init_params(cfg, rt, torch.Generator(device=device)
                           .manual_seed(0), device=device)
    root = Path(tempfile.mkdtemp(prefix="repro_torch_fleet_"))
    cluster = SimCluster(root, n_nodes=3, device=device)
    try:
        # two fleet workers: each has its own engine + session manager,
        # but they share the SAME catalog (and the same weights)
        eng_a = ServeEngine(cfg, rt, params, tiered=cluster.tiered,
                            label="workerA", device=device)
        eng_b = ServeEngine(cfg, rt, params, tiered=cluster.tiered,
                            label="workerB", device=device)
        sm_a = cluster.sessions
        sm_b = SessionManager(cluster.tiered, cluster.catalog,
                              owner="workerB", obs=cluster.obs)

        rng = np.random.default_rng(0)
        system = rng.integers(0, cfg.vocab_size, (1, 24)).astype(np.int32)
        users = {"alice": int(rng.integers(0, cfg.vocab_size)),
                 "bob": int(rng.integers(0, cfg.vocab_size))}

        # 1. shared warm prefix: prefilled once, published for the fleet
        eng_a.prefill(system)
        rec = sm_a.publish_prefix("system", eng_a)
        print(f"prefix/system published: v{rec['version']}, "
              f"{rec['nbytes']} bytes, home {rec['home']}")

        # 2. fork one session per user (worker A and worker B), decode
        outs = {}
        for (user, tok), (sm, eng) in zip(
                users.items(), ((sm_a, eng_a), (sm_b, eng_b))):
            sm.start(user, eng, prefix="system")
            outs[user] = eng.decode(np.array([tok], np.int32), 6)
            sm.suspend(user)  # 3. leased dataset sess/<user>, acked
        cluster.tiered.quiesce()
        for user in users:
            r = cluster.catalog.record(f"sess/{user}", "serve")
            print(f"sess/{user}: v{r['version']} home {r['home']} "
                  f"replicas {ack_targets(r['acks'].get('replica'))}")

        # 4. a node dies mid-traffic: one that homes a session
        victim = cluster.catalog.record("sess/alice", "serve")["home"]
        survivors = sm_b.recoverable_sessions([victim])
        print(f"killing {victim}; catalog says recoverable: {survivors} "
              f"(zero store probes)")
        assert survivors == sorted(users), survivors
        cluster.kill_node(victim)

        # one byte-range read of the cursor off the acked replica
        print(f"peek sess/alice pos = {int(sm_b.peek('alice', 'pos'))}")

        # 5. worker B resumes BOTH sessions off the replicas, audited
        reads = _audit_store_reads(cluster)
        for user in users:
            r = cluster.catalog.record(f"sess/{user}", "serve")
            cluster.catalog.cache.drop(
                f"exch/serve/sess/{user}@v{r['version']}")
            sm_b.resume(user, eng_b)
            more = eng_b.decode(outs[user][:, -1], 6)
            outs[user] = np.concatenate([outs[user], more[:, 1:]], axis=1)
            sm_b.suspend(user)
        blind = [(n, o) for n, o in reads
                 if not o.endswith(".json") and n != victim
                 and not o.startswith(("replica/", "wf/serve/"))]
        assert not blind, f"blind probes: {blind}"
        print(f"both sessions resumed on worker B "
              f"({len(reads)} audited reads, 0 blind probes)")

        # 6. reference: an uninterrupted engine gives the same tokens
        ref = ServeEngine(cfg, rt, params, device=device)
        for user, tok in users.items():
            ref.prefill(system)
            full = ref.decode(np.array([tok], np.int32), 12)
            assert (full == outs[user]).all(), f"{user} diverged!"
        print("bit-exact continuation across fork + node loss + "
              "cross-worker resume — OK")
    finally:
        cluster.shutdown()
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
