"""Versioned tree object store over PMem pools (the paper's §V-C).

PyTorch counterpart of ``repro/core/object_store.py`` with the same
on-disk format: every leaf (float, int8, int32, 0-d included) is a byte
range of one data region, and a JSON manifest (committed atomically after
the data is flushed) indexes the leaves by path with shape, dtype tag,
offset, size and CRC. An object written by either package reads in the
other, byte for byte.

bfloat16 leaves are written and read as their uint16 bit patterns under
the dtype tag ``"bfloat16"``: the JAX package resolves that tag with
``np.dtype("bfloat16")``, which needs ``ml_dtypes``; the port reads it
back as a ``torch.bfloat16`` CPU tensor instead. Other leaves are numpy
arrays.

``copy_object`` is the pmem -> pmem raw path of replication: it streams
the backing region in bounded chunks (each flushed before the manifest
commit), checks a rolling CRC against the source manifest's own CRCs and
commits that manifest verbatim, so a source overwritten mid-copy raises
``SupersededError`` and commits nothing. With a ``codec`` it encodes at
the source through the delta-int8 wire codec (``wire_codec.py``), on the
source store's ``device``; readers of an encoded object (``get``,
``get_leaf``, ``read_leaf_slice``) decode on their store's ``device``.
A store's ``device`` is the card unless the caller asks for the CPU, and
is resolved only when a leaf is encoded or decoded. ``DistributedStore``
unions per-node stores.

The drain boundary: ``export_object`` reads an object once into a
self-describing wire payload (``{"__wire_object__": 1, "manifest",
"codec", "leaves"}``, per-leaf raw bytes or encoded ``q``/``scales``
segments, each CRC-checked against the manifest as it streams out) that
the external store pickles exactly once; with a ``codec`` it encodes at
the source on the store's ``device``. The payload holds only bytes,
numbers and strings, never a tensor, so a host without CUDA (JAX's
``ExternalStore``) unpickles it. ``import_object`` lands a payload back
in pmem (encoded payloads stay encoded), and ``wire_leaves`` decodes one
without a pool, on the ``device`` it is given. Payloads written by
either package read in the other.
"""
from __future__ import annotations

import itertools
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.analysis.annotations import rehydration_entry
from repro_torch.bridge import bf16_bits, is_bf16_array, to_host
from repro_torch.core.pmem import PMemPool
from repro_torch.core.wire_codec import (codec_meta, decode_leaf,
                                         decode_leaf_tiles, encodable,
                                         encode_leaf, normalize_codec)

BF16_TAG = "bfloat16"

#: bounded copy granularity of the raw path: large enough to amortize
#: call overhead, small enough that a torn source is caught within one
#: chunk and peak extra memory stays bounded
DEFAULT_CHUNK_BYTES = 8 << 20

class SupersededError(IOError):
    """A queued transfer found its source already overwritten by a newer
    version (e.g. checkpoint slot reuse outpacing a replicate). Benign:
    the newer object's own transfer covers it. Collected, never fatal."""


_SHADOW_SEQ = itertools.count()


def _shadow_name(data_name: str) -> str:
    """Unique landing name for a data-region write: a writer streams into
    its own shadow file and installs it with one atomic ``pool.rename``,
    never truncating a file a reader may still have mapped."""
    return f"{data_name}.shadow{next(_SHADOW_SEQ)}"


def _check_expect_meta(man: dict, expect_meta: Optional[dict],
                       verb: str, obj_name: str) -> None:
    """Pin the object identity a queued transfer was meant for: raise
    SupersededError when the snapshotted meta no longer matches (the
    source was rewritten between submit and run)."""
    if not expect_meta:
        return
    got = man.get("meta", {})
    stale = {k: got.get(k) for k in expect_meta
             if got.get(k) != expect_meta[k]}
    if stale:
        raise SupersededError(
            f"{verb} {obj_name}: source changed before {verb} ran "
            f"(wanted {expect_meta}, found {stale})")


def _leaf_bytes(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as (array of its bytes' carrier, dtype tag)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return bf16_bits(leaf), BF16_TAG
        arr = to_host(leaf).numpy()
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


def content_digest(manifest: dict) -> str:
    """Content digest of an object from its manifest alone: the CRC32 of
    the sorted per-leaf ``path:crc`` pairs (encoded replicas keep the
    original leaf CRCs, so the digest does not depend on the codec)."""
    acc = 0
    for path in sorted(manifest.get("leaves", {})):
        ent = manifest["leaves"][path]
        acc = zlib.crc32(f"{path}:{ent['crc']}".encode(), acc)
    return f"{acc & 0xFFFFFFFF:08x}"


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


def _itemsize(tag: str) -> int:
    return 2 if tag == BF16_TAG else np.dtype(tag).itemsize


def _from_raw(raw: np.ndarray, tag: str, shape):
    """Owned raw bytes -> the leaf: a numpy array, or a CPU
    ``torch.bfloat16`` tensor for the ``bfloat16`` tag."""
    if tag == BF16_TAG:  # raw is owned: the tensor takes its bytes as is
        return torch.from_numpy(raw.view(np.int16).reshape(shape)) \
            .view(torch.bfloat16)
    return raw.view(np.dtype(tag)).reshape(shape)


def _wc_of(man: dict) -> Optional[dict]:
    return man.get("meta", {}).get("wire_codec")


def _physical_segments(man: dict) -> Tuple[List[Tuple[int, int, int]], int]:
    """The physical byte ranges backing an object as
    ``([(offset, nbytes, crc), ...], region_size)``: the manifest leaf
    table for a plain object, the encoded segment table for a
    codec-encoded one. The raw copy path streams exactly these ranges
    and verifies exactly these CRCs, so a second-hop copy of an encoded
    replica never double-encodes."""
    wc = _wc_of(man)
    if not wc:
        return ([(e["offset"], e["nbytes"], e["crc"])
                 for e in man["leaves"].values()],
                int(man.get("nbytes", 0)))
    segs = []
    for path, ce in wc["leaves"].items():
        if ce["mode"] == "delta8":
            segs.append((ce["offset"], ce["q_nbytes"], ce["q_crc"]))
            segs.append((ce["scales_offset"], ce["scales_nbytes"],
                         ce["scales_crc"]))
        else:
            segs.append((ce["offset"], ce["nbytes"],
                         man["leaves"][path]["crc"]))
    return segs, int(wc["nbytes_encoded"])


def _materialize_leaf(region, man: dict, path: str, ent: dict,
                      verify: bool, device):
    """Read ONE leaf into an owned array (never a live memmap view),
    decoding on ``device`` when the object is codec-encoded. The CRC is
    computed over the owned snapshot, exactly the bytes returned."""
    shape, tag = tuple(ent["shape"]), ent["dtype"]
    wc = _wc_of(man)
    ce = wc["leaves"].get(path) if wc else None
    if ce is not None and ce["mode"] == "delta8":
        q = np.array(region.read(ce["offset"], ce["q_nbytes"]), copy=True)
        sc = np.array(region.read(ce["scales_offset"],
                                  ce["scales_nbytes"]), copy=True)
        if q.nbytes != ce["q_nbytes"] or sc.nbytes != ce["scales_nbytes"]:
            raise IOError(f"short encoded read for {man['name']}:{path}")
        if verify and (_crc(q) != ce["q_crc"] or
                       _crc(sc) != ce["scales_crc"]):
            raise IOError(
                f"encoded crc mismatch for {man['name']}:{path}")
        raw = decode_leaf(q, sc, ce["tiles"], tag, ent["nbytes"],
                          device=device)
        if verify and wc.get("strict", True) and _crc(raw) != ent["crc"]:
            raise IOError(f"crc mismatch for {man['name']}:{path}")
        return _from_raw(raw, tag, shape)
    off = ce["offset"] if ce is not None else ent["offset"]
    raw = np.array(region.read(off, ent["nbytes"]), copy=True)
    if raw.nbytes != ent["nbytes"]:
        raise IOError(f"short read for {man['name']}:{path}")
    if verify and _crc(raw) != ent["crc"]:
        raise IOError(f"crc mismatch for {man['name']}:{path}")
    return _from_raw(raw, tag, shape)


class PMemObjectStore:
    """One node's object store. ``device`` is where the wire codec runs
    for this store's encoded objects (the card unless the caller asks
    for the CPU)."""

    def __init__(self, pool: PMemPool, device="cuda"):
        self.pool = pool
        self.device = device

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
        CRC-verifying every leaf against it when ``verify``; encoded
        objects decode transparently."""
        man = self.manifest(name, version)
        region = self.pool.open(f"objects/{name}@v{version}.data")
        leaves = {}
        for path, ent in man["leaves"].items():
            leaves[path] = _materialize_leaf(region, man, path, ent, verify,
                                             self.device)
        return _unflatten(leaves), man

    def get_leaf(self, name: str, leaf: str, version: int = 0,
                 verify: bool = True, man: Optional[dict] = None):
        """Byte-range read of ONE leaf without touching its siblings."""
        if man is None:
            man = self.manifest(name, version)
        region = self.pool.open(f"objects/{name}@v{version}.data")
        return _materialize_leaf(region, man, leaf, man["leaves"][leaf],
                                 verify, self.device)

    def read_leaf_slice(self, name: str, leaf: str, start_row: int,
                        n_rows: int, version: int = 0):
        """Byte-range read of rows [start_row, start_row+n_rows) of a
        leaf, as an OWNED copy. On a codec-encoded object only the tiles
        covering the requested rows are read and decoded."""
        man = self.manifest(name, version)
        ent = man["leaves"][leaf]
        shape, tag = tuple(ent["shape"]), ent["dtype"]
        row_elems = 1
        for d in shape[1:]:
            row_elems *= d
        row_bytes = _itemsize(tag) * row_elems
        region = self.pool.open(f"objects/{name}@v{version}.data")
        wc = _wc_of(man)
        ce = wc["leaves"].get(leaf) if wc else None
        if ce is not None and ce["mode"] == "delta8":
            tile = wc["tile"]
            e_lo = start_row * row_elems
            e_hi = (start_row + n_rows) * row_elems
            t_lo, t_hi = e_lo // tile, -(-e_hi // tile)
            q = np.array(region.read(ce["offset"] + t_lo * tile,
                                     (t_hi - t_lo) * tile), copy=True)
            sc = np.array(region.read(ce["scales_offset"] + t_lo * 4,
                                      (t_hi - t_lo) * 4), copy=True)
            dec = decode_leaf_tiles(q, sc, t_lo, t_hi, tag,
                                    device=self.device)
            out = dec[e_lo - t_lo * tile:
                      e_lo - t_lo * tile + n_rows * row_elems]
            return out.reshape((n_rows,) + shape[1:]).copy()
        off = (ce["offset"] if ce is not None else ent["offset"]) \
            + start_row * row_bytes
        raw = np.array(region.read(off, n_rows * row_bytes), copy=True)
        return _from_raw(raw, tag, (n_rows,) + shape[1:])

    def nbytes_of(self, name: str, version: int = 0) -> int:
        """Object size from the manifest alone (no data reads)."""
        return int(self.manifest(name, version).get("nbytes", 0))

    def delete(self, name: str, version: int = 0) -> None:
        self.pool.delete(f"objects/{name}@v{version}.manifest")
        self.pool.delete(f"objects/{name}@v{version}.data")

    def list_objects(self) -> List[Tuple[str, int]]:
        out = []
        for f in self.pool.list("objects/"):
            if f.endswith(".manifest"):
                base = f[len("objects/"):-len(".manifest")]
                name, _, v = base.rpartition("@v")
                out.append((name, int(v)))
        return sorted(out)


# ---- zero-copy byte-range transfer primitives ------------------------

def _obs_instruments(obs):
    if obs is None:
        return None, None, None
    reg = obs.registry
    return (reg.counter("tiered.bytes_raw"),
            reg.counter("tiered.bytes_encoded"),
            reg.histogram("copy.chunk"))


def _write_seg(region, off: int, buf: np.ndarray, chunk_bytes: int,
               hist) -> int:
    """Write one segment in bounded chunks, flushing each chunk before
    the next (and therefore before any later commit point)."""
    pos = 0
    n = buf.nbytes
    while pos < n:
        step = min(chunk_bytes, n - pos)
        region.write(off + pos, buf[pos:pos + step])
        region.flush()
        if hist is not None:
            hist.observe(step)
        pos += step
    return off + n


@rehydration_entry
def copy_object(src: PMemObjectStore, dst: PMemObjectStore, name: str,
                version: int = 0, *, dst_name: Optional[str] = None,
                dst_version: Optional[int] = None,
                meta_update: Union[dict, Callable, None] = None,
                expect_meta: Optional[dict] = None,
                chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                codec=None, verify: bool = True, obs=None) -> dict:
    """The pmem -> pmem raw path: stream the backing region of
    ``name@version`` from ``src`` to ``dst`` in bounded chunks and
    commit the *source manifest verbatim* (new name/version/meta, same
    leaf table, same CRCs). A rolling CRC over the streamed chunks is
    checked against the manifest's own segment CRCs, and the source
    manifest is read again just before the commit, so a source
    overwritten mid-copy raises :class:`SupersededError` instead of
    committing a stale replica. Every chunk is flushed before the
    manifest ``put_json``.

    ``meta_update`` merges extra keys into the copied meta (a callable
    receives the source meta). ``codec`` (spec dict or ``True``) engages
    the delta-int8 wire codec at the source, on ``src.device``; an
    already-encoded source is raw-streamed as-is (never double-encoded).
    Source-side failures (gone/torn/short) raise SupersededError;
    destination-side failures propagate. With a telemetry plane
    (``obs``) the copy counts its raw and encoded bytes and each chunk."""
    dst_name = dst_name or name
    dst_version = version if dst_version is None else dst_version
    codec = normalize_codec(codec)
    try:
        man = src.manifest(name, version)
        src_region = src.pool.open(f"objects/{name}@v{version}.data")
    except (OSError, ValueError, KeyError) as e:
        raise SupersededError(
            f"copy {name}: source gone before copy ran ({e})") from e
    _check_expect_meta(man, expect_meta, "copy", name)
    raw_ctr, enc_ctr, hist = _obs_instruments(obs)
    data_dst = f"objects/{dst_name}@v{dst_version}.data"
    encode = codec is not None and _wc_of(man) is None and any(
        encodable(e["dtype"], e["nbytes"]) for e in man["leaves"].values())
    shadow = _shadow_name(data_dst)
    try:
        if encode:
            wc_new, phys = _copy_encoded(src_region, man, dst.pool, shadow,
                                         codec, chunk_bytes, src.device,
                                         hist)
        else:
            wc_new = None
            phys = _copy_raw(src_region, man, dst.pool, shadow,
                             chunk_bytes, hist, verify)
        # freshness recheck while the bytes are still in the shadow: a
        # source slot reused mid-copy streams a consistent OLD mapping
        # that passes its own (old) manifest CRCs; this recheck keeps
        # that snapshot from being committed over a fresher replica
        try:
            cur = src.manifest(name, version)
        except (OSError, ValueError, KeyError) as e:
            raise SupersededError(
                f"copy {name}: source manifest gone at commit "
                f"({e})") from e
        if (cur.get("ts"), cur.get("content_digest")) != \
                (man.get("ts"), man.get("content_digest")):
            raise SupersededError(
                f"copy {name}: source superseded mid-copy (manifest "
                f"changed before commit)")
    except BaseException:
        # every chunk is flushed as it lands, so dropping the
        # uncommitted shadow is clean: no manifest ever pointed at it
        dst.pool.delete(shadow)
        raise
    if raw_ctr is not None:
        raw_ctr.inc(int(man.get("nbytes", 0)))
        if encode or _wc_of(man) is not None:
            enc_ctr.inc(phys)
    meta = dict(man.get("meta", {}))
    if callable(meta_update):
        meta.update(meta_update(man.get("meta", {})) or {})
    elif meta_update:
        meta.update(meta_update)
    if wc_new is not None:
        meta["wire_codec"] = wc_new
    new_man = {**man, "name": dst_name, "version": dst_version,
               "ts": time.time(), "meta": meta}
    # install + commit: all chunk flushes above precede the data rename,
    # and the manifest rename (put_json) makes the new bytes reachable
    dst.pool.rename(shadow, data_dst)
    dst.pool.put_json(f"objects/{dst_name}@v{dst_version}.manifest",
                      new_man)
    return new_man


def _copy_raw(src_region, man: dict, dst_pool: PMemPool, shadow: str,
              chunk_bytes: int, hist, verify: bool) -> int:
    """Stream the manifest's physical segments into the shadow region
    in bounded chunks. The caller owns commit sequencing (freshness
    recheck, rename, manifest put) and shadow cleanup on raise."""
    segs, phys = _physical_segments(man)
    dst_region = dst_pool.create(shadow, max(phys, 1))
    for off, nbytes, want in segs:
        acc = 0
        pos, end = off, off + nbytes
        while pos < end:
            n = min(chunk_bytes, end - pos)
            try:
                buf = src_region.read(pos, n)
            except (OSError, ValueError, AttributeError) as e:
                raise SupersededError(
                    f"copy {man['name']}: source read failed at "
                    f"{pos} ({e})") from e
            if buf.nbytes != n:
                raise SupersededError(
                    f"copy {man['name']}: short source read at "
                    f"{pos} (source resized mid-copy)")
            acc = zlib.crc32(buf, acc)
            dst_region.write(pos, buf)
            dst_region.flush()
            if hist is not None:
                hist.observe(n)
            pos += n
        if verify and nbytes and (acc & 0xFFFFFFFF) != want:
            raise SupersededError(
                f"copy {man['name']}: source bytes diverged from "
                f"manifest crc at offset {off} (source rewritten "
                f"mid-copy)")
    dst_region.flush()
    return phys


def _copy_encoded(src_region, man: dict, dst_pool: PMemPool,
                  shadow: str, codec: dict, chunk_bytes: int,
                  device, hist) -> Tuple[dict, int]:
    """Encode-at-source variant of the copy loop: each leaf is
    snapshotted once, CRC-checked against the manifest, encoded on
    ``device`` (or passed through raw when not exactly invertible in
    strict mode) and packed sequentially into the shadow region. The
    caller owns commit sequencing and shadow cleanup on raise."""
    tile, strict = codec["tile"], bool(codec.get("strict", True))
    bound = 0
    for e in man["leaves"].values():
        n = e["nbytes"] // max(_itemsize(e["dtype"]), 1)
        t = -(-n // tile) if n else 0
        bound += max(e["nbytes"], t * tile) + 4 * t
    dst_region = dst_pool.create(shadow, max(bound, 1))
    wc_leaves: Dict[str, dict] = {}
    off = 0
    for path, ent in man["leaves"].items():
        try:
            view = src_region.read(ent["offset"], ent["nbytes"])
        except (OSError, ValueError, AttributeError) as e:
            raise SupersededError(
                f"copy {man['name']}: source read failed for "
                f"{path} ({e})") from e
        # one owned snapshot per leaf: CRC, encode and write all see
        # the same bytes even if the source is overwritten now
        raw = np.array(view, copy=True)
        if raw.nbytes != ent["nbytes"]:
            raise SupersededError(
                f"copy {man['name']}: short source read for {path}")
        if ent["nbytes"] and _crc(raw) != ent["crc"]:
            raise SupersededError(
                f"copy {man['name']}: source bytes diverged from "
                f"manifest crc for {path} (rewritten mid-copy)")
        enc = encode_leaf(raw, ent["dtype"], strict=strict, device=device)
        if enc is None:
            wc_leaves[path] = {"mode": "raw", "offset": off,
                               "nbytes": ent["nbytes"]}
            off = _write_seg(dst_region, off, raw, chunk_bytes, hist)
        else:
            q, scales, tiles = enc
            qb = q.view(np.uint8).reshape(-1)
            sb = scales.view(np.uint8).reshape(-1)
            ce = {"mode": "delta8", "tiles": tiles, "offset": off,
                  "q_nbytes": qb.nbytes, "q_crc": _crc(qb)}
            off = _write_seg(dst_region, off, qb, chunk_bytes, hist)
            ce.update({"scales_offset": off,
                       "scales_nbytes": sb.nbytes,
                       "scales_crc": _crc(sb)})
            off = _write_seg(dst_region, off, sb, chunk_bytes, hist)
            wc_leaves[path] = ce
    dst_region.flush()
    dst_region.resize(max(off, 1))  # shrink to the packed size
    return codec_meta(codec, wc_leaves, off), off


def _read_seg(region, off: int, nbytes: int, want_crc: int, man: dict,
              path: str) -> bytes:
    try:
        data = region.read(off, nbytes).tobytes()
    except (OSError, ValueError) as e:
        raise SupersededError(
            f"export {man['name']}: source read failed for {path} "
            f"({e})") from e
    if len(data) != nbytes:
        raise SupersededError(
            f"export {man['name']}: short source read for {path}")
    if nbytes and _crc(data) != want_crc:
        raise SupersededError(
            f"export {man['name']}: source bytes diverged from manifest "
            f"crc for {path} (rewritten mid-export)")
    return data


@rehydration_entry
def export_object(store: PMemObjectStore, name: str, version: int = 0, *,
                  expect_meta: Optional[dict] = None, codec=None,
                  obs=None) -> dict:
    """Read an object ONCE into a self-describing wire payload for the
    external (drain) boundary: ``{"__wire_object__": 1, "manifest",
    "codec", "leaves"}`` with per-leaf raw bytes or encoded (q, scales)
    segments, verified against the manifest CRCs as they stream out. An
    already-encoded source ships its encoded segments verbatim; with a
    ``codec`` a plain one is encoded here, on ``store.device``. With a
    telemetry plane (``obs``) the export counts its raw and encoded
    bytes."""
    codec = normalize_codec(codec)
    try:
        man = store.manifest(name, version)
        region = store.pool.open(f"objects/{name}@v{version}.data")
    except (OSError, ValueError, KeyError) as e:
        raise SupersededError(
            f"export {name}: source gone before export ran ({e})") from e
    _check_expect_meta(man, expect_meta, "export", name)
    raw_ctr, enc_ctr, _hist = _obs_instruments(obs)
    wc = _wc_of(man)
    leaves: Dict[str, dict] = {}
    spec = None
    enc_bytes = 0
    if wc:
        spec = {"name": wc["name"], "tile": wc["tile"],
                "strict": wc.get("strict", True)}
        for path, ce in wc["leaves"].items():
            if ce["mode"] == "delta8":
                q = _read_seg(region, ce["offset"], ce["q_nbytes"],
                              ce["q_crc"], man, path)
                sc = _read_seg(region, ce["scales_offset"],
                               ce["scales_nbytes"], ce["scales_crc"],
                               man, path)
                leaves[path] = {"mode": "delta8", "tiles": ce["tiles"],
                                "q": q, "scales": sc,
                                "q_crc": ce["q_crc"],
                                "scales_crc": ce["scales_crc"]}
                enc_bytes += len(q) + len(sc)
            else:
                data = _read_seg(region, ce["offset"], ce["nbytes"],
                                 man["leaves"][path]["crc"], man, path)
                leaves[path] = {"mode": "raw", "data": data}
                enc_bytes += len(data)
    else:
        strict = bool(codec.get("strict", True)) if codec else True
        for path, ent in man["leaves"].items():
            data = _read_seg(region, ent["offset"], ent["nbytes"],
                             ent["crc"], man, path)
            # a writable copy: torch refuses read-only buffers
            enc = encode_leaf(np.frombuffer(bytearray(data), np.uint8),
                              ent["dtype"], strict=strict,
                              device=store.device) if codec else None
            if enc is None:
                leaves[path] = {"mode": "raw", "data": data}
                enc_bytes += len(data)
            else:
                q, scales, tiles = enc
                qb, sb = q.tobytes(), scales.tobytes()
                leaves[path] = {"mode": "delta8", "tiles": tiles,
                                "q": qb, "scales": sb,
                                "q_crc": _crc(qb), "scales_crc": _crc(sb)}
                enc_bytes += len(qb) + len(sb)
        if codec:
            spec = {"name": codec["name"], "tile": codec["tile"],
                    "strict": strict}
    if raw_ctr is not None:
        raw_ctr.inc(int(man.get("nbytes", 0)))
        if spec is not None:
            enc_ctr.inc(enc_bytes)
    # the shipped manifest carries no wire_codec: the sink's import
    # re-packs the segments and records its own physical layout
    m = dict(man)
    mm = dict(man.get("meta", {}))
    mm.pop("wire_codec", None)
    m["meta"] = mm
    return {"__wire_object__": 1, "manifest": m, "codec": spec,
            "leaves": leaves}


def is_wire_object(obj) -> bool:
    return isinstance(obj, dict) and obj.get("__wire_object__") == 1


@rehydration_entry
def import_object(store: PMemObjectStore, wire: dict,
                  name: Optional[str] = None,
                  version: Optional[int] = None,
                  meta_update: Optional[dict] = None,
                  chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> dict:
    """Wire payload -> pmem (stage-in, rehydration): write the carried
    leaf bytes (chunked, each chunk flushed before the manifest commit)
    and commit the carried manifest (plus ``meta_update``). Encoded
    payloads are stored encoded, their layout in ``meta["wire_codec"]``,
    and decoded by readers. Corrupt wire bytes (a CRC mismatch against
    the carried manifest) raise IOError: a torn external blob is a real
    failure, not a benign supersede."""
    man = wire["manifest"]
    name = name or man["name"]
    version = man["version"] if version is None else version
    data_name = f"objects/{name}@v{version}.data"
    spec = wire.get("codec")
    encoded = spec is not None and any(
        lf["mode"] == "delta8" for lf in wire["leaves"].values())
    wc = None
    shadow = _shadow_name(data_name)
    try:
        if encoded:
            phys = sum(len(lf["data"]) if lf["mode"] == "raw"
                       else len(lf["q"]) + len(lf["scales"])
                       for lf in wire["leaves"].values())
            region = store.pool.create(shadow, max(phys, 1))
            wc_leaves: Dict[str, dict] = {}
            off = 0
            for path in man["leaves"]:
                lf = wire["leaves"][path]
                if lf["mode"] == "raw":
                    data = np.frombuffer(lf["data"], np.uint8)
                    if data.nbytes and _crc(data) != \
                            man["leaves"][path]["crc"]:
                        raise IOError(f"import {name}: wire bytes corrupt "
                                      f"for {path}")
                    wc_leaves[path] = {"mode": "raw", "offset": off,
                                       "nbytes": data.nbytes}
                    off = _write_seg(region, off, data, chunk_bytes,
                                     None)
                else:
                    q = np.frombuffer(lf["q"], np.uint8)
                    sc = np.frombuffer(lf["scales"], np.uint8)
                    if _crc(q) != lf["q_crc"] or \
                            _crc(sc) != lf["scales_crc"]:
                        raise IOError(f"import {name}: wire bytes corrupt "
                                      f"for {path}")
                    ce = {"mode": "delta8", "tiles": lf["tiles"],
                          "offset": off, "q_nbytes": q.nbytes,
                          "q_crc": lf["q_crc"]}
                    off = _write_seg(region, off, q, chunk_bytes, None)
                    ce.update({"scales_offset": off,
                               "scales_nbytes": sc.nbytes,
                               "scales_crc": lf["scales_crc"]})
                    off = _write_seg(region, off, sc, chunk_bytes, None)
                    wc_leaves[path] = ce
            region.flush()
            wc = codec_meta(spec, wc_leaves, off)
        else:
            region = store.pool.create(shadow,
                                       max(int(man.get("nbytes", 0)), 1))
            for path, ent in man["leaves"].items():
                data = np.frombuffer(wire["leaves"][path]["data"], np.uint8)
                if data.nbytes and _crc(data) != ent["crc"]:
                    raise IOError(
                        f"import {name}: wire bytes corrupt for {path}")
                _write_seg(region, ent["offset"], data, chunk_bytes,
                           None)
            region.flush()
    except BaseException:
        # torn wire blob: drop the flushed, uncommitted shadow; a
        # previously committed version of this object stays intact
        store.pool.delete(shadow)
        raise
    store.pool.rename(shadow, data_name)
    meta = dict(man.get("meta", {}))
    meta.pop("wire_codec", None)
    if wc is not None:
        meta["wire_codec"] = wc
    if meta_update:
        meta.update(meta_update)
    new_man = {**man, "name": name, "version": version, "ts": time.time(),
               "meta": meta}
    store.pool.put_json(f"objects/{name}@v{version}.manifest", new_man)
    return new_man


def wire_leaves(wire: dict, verify: bool = True, *,
                device="cuda") -> Dict[str, object]:
    """Decode a wire payload to its flat ``{path: leaf}`` host leaves
    without writing to any pool (restore's drain-tier read): encoded
    leaves decode on ``device``; leaves come back as every store read
    returns them (numpy, a CPU ``torch.bfloat16`` tensor for bf16)."""
    man = wire["manifest"]
    spec = wire.get("codec")
    strict = bool(spec.get("strict", True)) if spec else True
    out: Dict[str, object] = {}
    for path, ent in man["leaves"].items():
        lf = wire["leaves"][path]
        shape, tag = tuple(ent["shape"]), ent["dtype"]
        if lf["mode"] == "delta8":
            # writable copies: torch refuses read-only buffers
            q = np.frombuffer(bytearray(lf["q"]), np.uint8)
            sc = np.frombuffer(bytearray(lf["scales"]), np.uint8)
            if verify and (_crc(q) != lf["q_crc"] or
                           _crc(sc) != lf["scales_crc"]):
                raise IOError(f"wire crc mismatch for {path}")
            raw = decode_leaf(q, sc, lf["tiles"], tag, ent["nbytes"],
                              device=device)
            if verify and strict and _crc(raw) != ent["crc"]:
                raise IOError(f"wire crc mismatch for {path}")
        else:
            raw = np.frombuffer(lf["data"], np.uint8).copy()
            if verify and raw.nbytes and _crc(raw) != ent["crc"]:
                raise IOError(f"wire crc mismatch for {path}")
        out[path] = _from_raw(raw, tag, shape)
    return out


def wire_tree(wire: dict, verify: bool = True, *, device="cuda"):
    """A wire payload as the tree it carries (the pmem ingest path is
    :func:`import_object`)."""
    return _unflatten(wire_leaves(wire, verify=verify, device=device))


class DistributedStore:
    """Union view over per-node stores (the distributed B-APM filesystem)."""

    def __init__(self, stores: Dict[str, PMemObjectStore]):
        self.stores = stores

    def locate(self, name: str, version: int = 0) -> List[str]:
        return [nid for nid, st in self.stores.items()
                if st.exists(name, version)]

    def get(self, name: str, version: int = 0, prefer: Optional[str] = None):
        nodes = self.locate(name, version)
        if not nodes:
            raise KeyError(f"{name}@v{version} not on any node")
        nid = prefer if prefer in nodes else nodes[0]
        return self.stores[nid].get(name, version)

    def nbytes_of(self, name: str, version: int = 0) -> int:
        """Size of an object wherever it lives (0 when nowhere)."""
        for nid in self.locate(name, version):
            try:
                return self.stores[nid].nbytes_of(name, version)
            except (IOError, FileNotFoundError):
                continue
        return 0
