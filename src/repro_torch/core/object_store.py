"""Versioned tree object store over PMem pools (the paper's §V-C).

The part of ``repro/core/object_store.py`` that ``put``, ``get``,
``get_leaf`` and ``exists`` need, with the same on-disk
format: every leaf (float, int8, int32, 0-d included) is a byte range of
one data region, and a JSON manifest (committed atomically after
the data is flushed) indexes the leaves by path with shape, dtype tag,
offset, size and CRC. An object written by either package reads in the
other, byte for byte.

bfloat16 leaves are written and read as their uint16 bit patterns under
the dtype tag ``"bfloat16"``: the JAX package resolves that tag with
``np.dtype("bfloat16")``, which needs ``ml_dtypes``; the port reads it
back as a ``torch.bfloat16`` CPU tensor instead. Other leaves are numpy
arrays. Objects encoded by the delta-int8 wire codec, the zero-copy
``copy_object``/``export_object``/``import_object`` paths and the
``DistributedStore`` union view are not ported yet (ROADMAP Queue A
item 2: replication, drain and the TieredIO serve wiring).
"""
from __future__ import annotations

import itertools
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import bf16_bits, is_bf16_array
from repro_torch.core.pmem import PMemPool

BF16_TAG = "bfloat16"

_SHADOW_SEQ = itertools.count()


def _shadow_name(data_name: str) -> str:
    """Unique landing name for a data-region write: a writer streams into
    its own shadow file and installs it with one atomic ``pool.rename``,
    never truncating a file a reader may still have mapped."""
    return f"{data_name}.shadow{next(_SHADOW_SEQ)}"


def _leaf_bytes(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as (array of its bytes' carrier, dtype tag)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return bf16_bits(leaf), BF16_TAG
        arr = leaf.detach().cpu().numpy()
    else:
        arr = np.asarray(leaf)
        if is_bf16_array(arr):
            return arr.view(np.uint16), BF16_TAG
    return arr, str(arr.dtype)


def _flatten(tree, prefix="") -> List[Tuple[str, object]]:
    """``[(path, leaf), ...]`` in sorted path order, leaves as given (a
    tensor stays where it lies until ``put`` writes it)."""
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out += _flatten(v, f"{prefix}{i}/")
    elif tree is None:
        pass
    else:
        out.append((prefix[:-1], tree))
    return out


def _leaf_nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return np.asarray(leaf).nbytes


def _unflatten(leaves: Dict[str, object]):
    tree: Dict[str, object] = {}
    for path, v in leaves.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _crc(buf) -> int:
    return zlib.crc32(buf) & 0xFFFFFFFF


def _materialize_leaf(region, man: dict, path: str, ent: dict,
                      verify: bool):
    """Read ONE leaf into an owned array (never a live memmap view)."""
    if man.get("meta", {}).get("wire_codec"):
        raise NotImplementedError(
            f"{man['name']} is encoded by the delta-int8 wire codec, which "
            f"is not ported (ROADMAP Queue A item 2: the wire codec)")
    shape, tag = tuple(ent["shape"]), ent["dtype"]
    raw = np.array(region.read(ent["offset"], ent["nbytes"]), copy=True)
    if raw.nbytes != ent["nbytes"]:
        raise IOError(f"short read for {man['name']}:{path}")
    if verify and _crc(raw) != ent["crc"]:
        raise IOError(f"crc mismatch for {man['name']}:{path}")
    if tag == BF16_TAG:  # raw is owned: the tensor takes its bytes as is
        return torch.from_numpy(raw.view(np.int16).reshape(shape)) \
            .view(torch.bfloat16)
    return raw.view(np.dtype(tag)).reshape(shape)


class PMemObjectStore:
    """One node's object store."""

    def __init__(self, pool: PMemPool):
        self.pool = pool

    # ---- write path ----
    def put(self, name: str, tree, version: int = 0,
            meta: Optional[dict] = None) -> dict:
        leaves = _flatten(tree)
        region_name = f"objects/{name}@v{version}.data"
        total = sum(_leaf_nbytes(leaf) for _, leaf in leaves)
        shadow = _shadow_name(region_name)
        region = self.pool.create(shadow, max(total, 1))
        manifest = {"name": name, "version": version, "ts": time.time(),
                    "meta": meta or {}, "leaves": {}, "nbytes": total}
        off = 0
        for path, leaf in leaves:
            # one leaf on the host at a time: a device tensor is copied
            # to the host here, just before its bytes are written
            arr, tag = _leaf_bytes(leaf)
            region.write(off, arr)
            manifest["leaves"][path] = {
                "shape": list(arr.shape), "dtype": tag,
                "offset": off, "nbytes": arr.nbytes,
                "crc": _crc(np.ascontiguousarray(arr).reshape(-1)
                            .view(np.uint8)),
            }
            off += arr.nbytes
        region.flush()  # CLWB+SFENCE before the commit point
        # install the flushed shadow under the real data name (atomic)
        self.pool.rename(shadow, region_name)
        # commit point: manifest rename is atomic
        self.pool.put_json(f"objects/{name}@v{version}.manifest", manifest)
        return manifest

    # ---- read path ----
    def manifest(self, name: str, version: int = 0) -> dict:
        return self.pool.get_json(f"objects/{name}@v{version}.manifest")

    def exists(self, name: str, version: int = 0) -> bool:
        return self.pool.exists(f"objects/{name}@v{version}.manifest")

    def get(self, name: str, version: int = 0, verify: bool = False):
        tree, _ = self.get_with_manifest(name, version, verify=verify)
        return tree

    def get_with_manifest(self, name: str, version: int = 0,
                          verify: bool = True):
        """Read (tree, manifest) against ONE manifest snapshot,
        CRC-verifying every leaf against it when ``verify``."""
        man = self.manifest(name, version)
        region = self.pool.open(f"objects/{name}@v{version}.data")
        leaves = {}
        for path, ent in man["leaves"].items():
            leaves[path] = _materialize_leaf(region, man, path, ent, verify)
        return _unflatten(leaves), man

    def get_leaf(self, name: str, leaf: str, version: int = 0,
                 verify: bool = True, man: Optional[dict] = None):
        """Byte-range read of ONE leaf without touching its siblings."""
        if man is None:
            man = self.manifest(name, version)
        region = self.pool.open(f"objects/{name}@v{version}.data")
        return _materialize_leaf(region, man, leaf, man["leaves"][leaf],
                                 verify)
