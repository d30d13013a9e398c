"""The paper's Fig. 8 workflow, end to end, on the PyTorch port, over the
Persistent Dataset Exchange: data-prep -> {train, corpus-stats}
(concurrent branches) -> eval, sharing intermediates through node-local
B-APM (zero external round trips between stages). Every intermediate is
a catalog dataset (versioned, lineage-stamped, replica-acked), so after
killing a node the workflow resumes WITHOUT re-running jobs whose outputs
survive on replicas.

The counterpart of ``examples/workflow_pipeline.py`` (same jobs, same
printed lines). The train job runs ``repro_torch.train.train_step`` on
one device, as ``repro_torch/launch/train.py`` does, with random initial
weights from a seeded ``torch.Generator``; on the card every job waits
for it through the watchdog (``kernels/watchdog.py``). ``make_jobs`` is
also what ``chip_smoke.py``'s workflow phase runs at full width.

    PYTHONPATH=src python examples/torch_workflow_pipeline.py [--device cpu]
"""
import argparse
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import bridge, resolve_device  # noqa: E402
from repro_torch.configs import ShapeConfig, registry  # noqa: E402
from repro_torch.core.cluster import SimCluster  # noqa: E402
from repro_torch.core.workflow import JobSpec  # noqa: E402
from repro_torch.data.pipeline import make_batch, synthetic_shard  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402


def device_wait(device) -> None:
    """Wait for the work queued on the card, with the watchdog's deadline
    (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        from repro_torch.kernels import watchdog
        watchdog.synchronize()


def make_jobs(cfg, rt, shape, device, *, steps: int, ce_chunk: int,
              out: dict):
    """The four jobs of the pipeline. ``out`` collects each job's wall
    span (``spans``), the train losses, the trained parameters (still on
    the device) and the eval loss."""
    adamw = opt.AdamWConfig(lr=1e-3, warmup=5)
    step = ts.make_train_step(cfg, rt, adamw, ce_chunk=ce_chunk)
    loss_fn = ts.make_loss_fn(cfg, rt, ce_chunk)
    spans = out.setdefault("spans", {})

    def timed(name, fn):
        def job(ctx):
            t0 = time.time()
            try:
                return fn(ctx)
            finally:
                spans[name] = (t0, time.time())
        return job

    def prep(ctx):
        raw = ctx.read("raw_corpus")
        rng = np.random.default_rng(0)
        return {"train_set": raw,
                "eval_batch": make_batch(raw, cfg, shape, rng)}

    def train(ctx):
        shard = ctx.read("train_set")
        rng = np.random.default_rng(1)
        params = T.init_params(cfg, rt, torch.Generator(device=device)
                               .manual_seed(0), device=device)
        ost = opt.init_opt_state(params, adamw)
        losses = []
        for _ in range(steps):
            params, ost, m = step(params, ost,
                                  make_batch(shard, cfg, shape, rng))
            device_wait(device)
            losses.append(float(m["loss"]))
        del ost
        out["losses"], out["params"] = losses, params
        print(f"  [train] loss {losses[0]:.3f} -> {losses[-1]:.3f}")
        return {"model": params}

    def stats(ctx):
        # independent analysis branch: runs CONCURRENTLY with train
        tok = np.asarray(ctx.read("train_set")["tokens"])
        return {"corpus_stats": {"mean": np.array([float(tok.mean())]),
                                 "max": np.array([float(tok.max())])}}

    def evaluate(ctx):
        params = bridge.params_from_host(ctx.read("model"), device)
        batch = {k: torch.as_tensor(bridge.to_numpy(v), device=device)
                 for k, v in ctx.read("eval_batch").items()}
        with torch.no_grad():
            loss = loss_fn(params, batch)[0]
        device_wait(device)
        loss = float(loss)
        del params
        out["eval_loss"] = loss
        print(f"  [eval] in-situ eval loss {loss:.3f}")
        return {"eval_report": {"loss": np.array([loss])}}

    return [
        JobSpec("prep", timed("prep", prep), inputs=("raw_corpus",),
                retain=("train_set", "eval_batch")),
        JobSpec("train", timed("train", train), inputs=("train_set",),
                after=("prep",), retain=("model",)),
        JobSpec("stats", timed("stats", stats), inputs=("train_set",),
                after=("prep",), retain=("corpus_stats",)),
        JobSpec("eval", timed("eval", evaluate),
                inputs=("model", "eval_batch"), after=("train",),
                drain=("eval_report",), retain=("eval_report",)),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = registry.get_smoke_config("qwen2-72b")
    shape = ShapeConfig("wf", 48, 4, "train")
    rt = T.ModelRuntime(tp=1, attn_impl="naive", remat=False,
                        max_seq=shape.seq_len)
    root = Path(tempfile.mkdtemp(prefix="repro_torch_wf_"))
    cluster = SimCluster(root, n_nodes=4, device=device)
    try:
        # raw corpus starts on the external filesystem (Fig. 8 step 1a)
        cluster.external.put("raw_corpus", synthetic_shard(
            0, 64, shape.seq_len, cfg.vocab_size))
        jobs = make_jobs(cfg, rt, shape, device, steps=15, ce_chunk=16,
                         out={})
        cluster.workflows.run(jobs, workflow="pipeline")

        print("\nworkflow event log (paper Fig. 8 sequence, concurrent):")
        for _ts, kind, detail in cluster.workflows.events:
            print(f"  {kind:9s} {detail}")

        print("\nlineage of eval_report (catalog records, digests "
              "persisted):")
        for rec in cluster.catalog.lineage("eval_report", "pipeline"):
            if "external" in rec:
                print(f"  <- external:{rec['external']}")
            else:
                print(f"  {rec['name']}@v{rec['version']} "
                      f"produced by {rec['lineage']['job']} "
                      f"on {rec['home']} digest={rec['digest']}")

        # node loss: every retained dataset has an acked replica, so
        # resume replays NOTHING; consumers read the surviving replicas
        cluster.tiered.quiesce()  # replica acks land
        victim = cluster.catalog.record("model", "pipeline")["home"]
        cluster.kill_node(victim)
        res2 = cluster.workflows.resume(jobs, "pipeline",
                                        lost_nodes=[victim])
        print(f"\nafter killing {victim}: resume skipped "
              f"{sorted(res2.skipped)} (outputs ack-recoverable), "
              f"replayed {res2.replayed}")
        cluster.tiered.evict_cold(0.0)  # drop DRAM residency: pmem path
        cluster.catalog.get("model", "pipeline")  # home dead: replica
        print(f"  model served from replica "
              f"({cluster.catalog.stats['replica_reads']} replica reads)")

        cluster.workflows.cleanup(keep=())
    finally:
        cluster.shutdown()
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
