"""Training-data pipeline with pmem staging (the paper's burst-buffer path).

A copy of ``repro/data/pipeline.py``: shards of synthetic tokens live in
the external store, the data scheduler stages upcoming shards into
node-local pmem ahead of consumption, and batches are drawn from the
staged shard with the same numpy generator, so the same seed gives the
same batches as the JAX package's pipeline. Batches are numpy arrays;
the train step moves them to its device.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.cluster import SimCluster


def synthetic_shard(seed: int, n_seqs: int, seq_len: int,
                    vocab: int) -> Dict[str, np.ndarray]:
    """Deterministic synthetic LM data (zipf-ish token distribution)."""
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(1.3, size=(n_seqs, seq_len + 1)).astype(np.int64)
    tokens = (ranks % vocab).astype(np.int32)
    return {"tokens": tokens}


def make_batch(shard: Dict[str, np.ndarray], cfg: ModelConfig,
               shape: ShapeConfig, rng: np.random.Generator
               ) -> Dict[str, np.ndarray]:
    toks = shard["tokens"]
    idx = rng.integers(0, toks.shape[0], size=shape.global_batch)
    seqs = toks[idx, :shape.seq_len + 1]
    text_len = shape.seq_len - cfg.prefix_len
    batch = {
        "tokens": seqs[:, :text_len].astype(np.int32),
        "labels": np.concatenate(
            [seqs[:, 1:shape.seq_len + 1]], axis=1).astype(np.int32),
        "loss_mask": np.ones((shape.global_batch, shape.seq_len),
                             np.float32),
    }
    batch["loss_mask"][:, -1] = 0.0
    if cfg.prefix_len:
        batch["loss_mask"][:, :cfg.prefix_len] = 0.0
        batch["prefix_embeds"] = rng.standard_normal(
            (shape.global_batch, cfg.prefix_len, cfg.d_model)
        ).astype(np.float32) * 0.02
    if cfg.enc_dec:
        batch["enc_frames"] = rng.standard_normal(
            (shape.global_batch, shape.seq_len, cfg.d_model)
        ).astype(np.float32) * 0.02
    return batch


class StagedDataset:
    """Iterates batches; shards are staged into pmem ``prefetch`` ahead."""

    def __init__(self, cluster: SimCluster, cfg: ModelConfig,
                 shape: ShapeConfig, n_shards: int = 8,
                 seqs_per_shard: int = 64, prefetch: int = 2, seed: int = 0):
        self.cluster = cluster
        self.cfg = cfg
        self.shape = shape
        self.n_shards = n_shards
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)
        self._futures: Dict[int, object] = {}
        # populate the external store (normally done by the data-prep job)
        for i in range(n_shards):
            name = f"data_shard_{i}"
            if not cluster.external.exists(name):
                cluster.external.put(name, synthetic_shard(
                    seed + i, seqs_per_shard, shape.seq_len,
                    cfg.vocab_size))

    def _node_for(self, i: int) -> str:
        # stable home node per shard; only a dead home is re-targeted
        ids = self.cluster.node_ids
        nid = ids[i % len(ids)]
        if getattr(self.cluster.pools[nid], "alive", True):
            return nid
        live = [n for n in ids
                if getattr(self.cluster.pools[n], "alive", True)]
        live = live or ids
        return live[i % len(live)]

    def _ensure_staged(self, i: int) -> None:
        i = i % self.n_shards
        nid = self._node_for(i)
        name = f"data_shard_{i}"
        if self.cluster.stores[nid].exists(name) or i in self._futures:
            return
        self._futures[i] = self.cluster.scheduler.stage_in(nid, name, name)

    def batches(self, steps: int) -> Iterator[Dict[str, np.ndarray]]:
        for step in range(steps):
            i = step % self.n_shards
            # prefetch upcoming shards (async, burst-buffer semantics)
            for ahead in range(self.prefetch + 1):
                self._ensure_staged(i + ahead)
            fut = self._futures.pop(i, None)
            if fut is not None:
                try:
                    fut.result()  # only blocks if prefetch fell behind
                except IOError:
                    pass  # target node died mid-stage; re-stage below
            name = f"data_shard_{i}"
            nid = self._node_for(i)
            if not self.cluster.stores[nid].exists(name):
                self.cluster.scheduler.stage_in(nid, name, name).result()
            shard = self.cluster.stores[nid].get(name)
            yield make_batch(shard, self.cfg, self.shape, self.rng)
