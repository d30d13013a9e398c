"""Delta-int8 wire codec: the ``ckpt_codec`` tile codec as an opt-in
compression stage on the copy channels (replicate, and later drain and
rehydrate).

PyTorch counterpart of ``repro/core/wire_codec.py``, with its names,
arguments and wire format: int8 codes in tiles of ``TILE`` elements and
one float32 scale a tile, against a zero base (both ends of a copy share
it), recorded in the object manifest under ``meta["wire_codec"]``.
Encoding happens at the source of a copy, decoding when a reader asks
for leaf bytes. In the default ``strict`` mode each tile's scale is the
power of two at or above ``absmax / 127`` and every leaf is decoded back
at the source: a leaf whose round trip is not bit-identical ships raw,
so nothing is lost (values on an 8-bit integer grid times a power of two
travel at a quarter of their float32 bytes). ``strict=False`` encodes
with the kernel's own ``absmax / 127`` scale, the lossy semantics of the
delta checkpoints.

Where JAX runs the numpy oracle, the port runs the Hopper kernels of
``kernels/ckpt_codec`` on ``device``: the strict round trip and every
decode through ``decode_tiles`` (given, and adding, a zero base, so that
-0.0 decodes to +0.0 as ``decode_ref`` makes it), the non-strict encode
through ``encode_tiles``. On the CPU the kernels' plain versions run.
The strict quantizer (``_encode_pow2``) is plain torch: JAX computes it
in numpy, outside any TPU kernel. Copies run on scheduler and I/O
threads, so the device work of each call runs on its thread's own
stream of ``device``, waited on with the watchdog's deadline
(``kernels/watchdog.py``), and the codes come back to the host before
the caller writes them.

bfloat16 leaves always ship raw, as in JAX, where ``np.dtype("bfloat16")``
has kind ``'V'``: the codec tables of both packages then agree leaf for
leaf and either package reads the other's replicas.
"""
from __future__ import annotations

import contextlib
import threading
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import watchdog
from repro_torch.kernels.ckpt_codec import ops as codec
from repro_torch.kernels.ckpt_codec.ref import TILE

#: codec spec used when a caller opts in with ``wire_codec=True``
DEFAULT_CODEC = {"name": "delta8", "tile": TILE, "strict": True}

#: dtypes worth quantizing (ints, bools and bfloat16 ship raw)
_FLOAT_KINDS = ("f",)

#: the float dtypes a leaf may have, and their bit patterns for the
#: strict mode's byte comparison
_TORCH = {np.dtype(np.float16): (torch.float16, torch.int16),
          np.dtype(np.float32): (torch.float32, torch.int32),
          np.dtype(np.float64): (torch.float64, torch.int64)}

_local = threading.local()


def normalize_codec(codec) -> Optional[dict]:
    """``None``/falsy -> None, ``True`` -> DEFAULT_CODEC, dict -> the
    dict with defaults filled in."""
    if not codec:
        return None
    if codec is True:
        return dict(DEFAULT_CODEC)
    out = dict(DEFAULT_CODEC)
    out.update(codec)
    return out


def encodable(dtype, nbytes: int) -> bool:
    """Only float leaves (a numpy dtype or a manifest's dtype tag, never
    bfloat16) with at least one full tile's worth of elements."""
    if str(dtype) == "bfloat16":
        return False
    dtype = np.dtype(dtype)
    return dtype.kind in _FLOAT_KINDS and \
        nbytes >= TILE * dtype.itemsize


@contextlib.contextmanager
def _stream(device: torch.device):
    """The calling thread's own stream of ``device`` (on the card), with
    the device set: copies call the codec from mover and I/O threads."""
    if device.type != "cuda":
        yield
        return
    streams = getattr(_local, "streams", None)
    if streams is None:
        streams = _local.streams = {}
    stream = streams.get(device.index)
    if stream is None:
        stream = streams[device.index] = torch.cuda.Stream(device)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


def _wait(device: torch.device) -> None:
    """Wait for this thread's codec stream with the watchdog's deadline
    before a result is read: a kernel that does not finish raises
    ``KernelTimeout`` in the copy instead of hanging its thread."""
    if device.type == "cuda":
        watchdog.synchronize()


def _encode_pow2(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Strict-mode quantizer: the kernel's tile/q/scale wire format, but
    with each tile's scale snapped UP to the nearest power of two at or
    above absmax/127, as JAX's ``np.exp2(np.ceil(np.log2(absmax /
    127)))``. Computed exactly from the exponent of absmax: with absmax =
    m * 2**e (0.5 <= m < 1), the least s with 127 * 2**s >= absmax is e -
    7, or e - 6 when m > 127/128. A pow2 scale is exactly representable
    and ``q * scale`` multiplies exactly, so values on an <= 8-bit
    integer grid (times any pow2) decode bit-identically through the
    unmodified decode kernel."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    m, e = torch.frexp(absmax)
    s = e - 7 + (m > 127.0 / 128.0).to(e.dtype)
    # 2**s as float32 bits: normal, subnormal, or 0 below 2**-149
    # (numpy's float64 -> float32 cast of np.exp2 rounds it so)
    sub = torch.bitwise_left_shift(torch.ones_like(s),
                                   (s + 149).clamp(0, 22))
    bits = torch.where(s >= -126, (s + 127) << 23,
                       torch.where(s >= -149, sub, torch.zeros_like(s)))
    scale = torch.where(absmax > 0, bits.view(torch.float32),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def encode_leaf(buf: np.ndarray, dtype, strict: bool = True, *,
                device="cuda"
                ) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """Encode one leaf's raw bytes (uint8 view/copy) into
    ``(q[int8, tiles*TILE], scales[f32, tiles], tiles)`` against a zero
    base, on ``device``. Returns None when the leaf should ship raw:
    non-float dtype, sub-tile size, or (strict mode) a round trip that is
    not bit-identical to the source bytes."""
    if not encodable(dtype, buf.nbytes):
        return None
    dtype = np.dtype(dtype)
    dt, bits = _TORCH[dtype]
    dev = resolve_device(device)
    flat = np.asarray(buf).view(dtype).reshape(-1)
    n = flat.size
    tiles = -(-n // TILE)
    with _stream(dev):
        src = torch.from_numpy(flat).to(dev)
        x = torch.zeros((tiles, TILE), dtype=torch.float32, device=dev)
        x.view(-1)[:n] = src.to(torch.float32)
        zero = torch.zeros_like(x)
        if strict:
            q, scale = _encode_pow2(x)
            dec = codec.decode_tiles(q, scale, zero, dtype=torch.float32)
            dec = dec.view(-1)[:n].to(dt)
            _wait(dev)
            if not torch.equal(dec.view(bits), src.view(bits)):
                return None  # not exactly invertible -> raw passthrough
        else:
            q, scale = codec.encode_tiles(x, zero)
            _wait(dev)
        return (q.reshape(-1).cpu().numpy(), scale.reshape(-1).cpu().numpy(),
                tiles)


def _decode(q, scales, tiles: int, dtype: np.dtype, n: int,
            device) -> np.ndarray:
    """Decode kernel on ``device``: ``tiles`` tiles of codes and scales
    (raw segment bytes) -> the first ``n`` values in ``dtype``."""
    dev = resolve_device(device)
    with _stream(dev):
        qm = torch.from_numpy(np.asarray(q).view(np.int8)
                              .reshape(tiles, TILE)).to(dev)
        sm = torch.from_numpy(np.asarray(scales).view(np.float32)
                              .reshape(tiles, 1)).to(dev)
        dec = codec.decode_tiles(qm, sm, torch.zeros(
            (tiles, TILE), dtype=torch.float32, device=dev),
            dtype=torch.float32)
        out = dec.view(-1)[:n].to(_TORCH[dtype][0])
        _wait(dev)
        return out.cpu().numpy()


def decode_leaf(q: np.ndarray, scales: np.ndarray, tiles: int, dtype,
                nbytes: int, *, device="cuda") -> np.ndarray:
    """Inverse of :func:`encode_leaf`: raw uint8 leaf bytes from the
    encoded segments (drops the zero padding of the last tile)."""
    dtype = np.dtype(dtype)
    return _decode(q, scales, tiles, dtype, nbytes // dtype.itemsize,
                   device).view(np.uint8).reshape(-1)


def decode_leaf_tiles(q: np.ndarray, scales: np.ndarray, tile_lo: int,
                      tile_hi: int, dtype, *, device="cuda") -> np.ndarray:
    """Decode only tiles [tile_lo, tile_hi) of a leaf: the byte-range
    primitive under ``read_leaf_slice`` on encoded objects. ``q`` and
    ``scales`` are the raw segment bytes for exactly that tile range."""
    tiles = tile_hi - tile_lo
    return _decode(q, scales, tiles, np.dtype(dtype), tiles * TILE, device)


def crc(buf) -> int:
    return zlib.crc32(buf) & 0xFFFFFFFF


def codec_meta(spec: dict, leaves: Dict[str, dict],
               nbytes_encoded: int) -> dict:
    """The ``meta["wire_codec"]`` record: codec params + the physical
    (encoded) segment table with encoded CRCs, everything a repair scan
    or a second-hop copy needs without touching payload bytes."""
    return {"name": spec["name"], "tile": spec["tile"],
            "strict": bool(spec.get("strict", True)),
            "leaves": leaves, "nbytes_encoded": int(nbytes_encoded)}
