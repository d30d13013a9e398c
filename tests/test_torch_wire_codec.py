"""Port parity: the delta-int8 wire codec against the JAX package's.

``repro_torch.core.wire_codec`` against ``repro.core.wire_codec`` on the
same leaf bytes, made from a numpy seed: which leaves ship raw, the int8
codes and float32 scales, the decoded bytes and the tile-range decode,
all bit for bit, in strict and non-strict mode. On the CPU the port runs
the codec kernels' plain versions; the card test holds the kernels to
them.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import wire_codec as jwc
from repro_torch.core import wire_codec as wc
from repro_torch.kernels import watchdog
from repro_torch.kernels.ckpt_codec import ops as codec_ops

TILE = wc.TILE


def _values(kind: str, rng) -> np.ndarray:
    """One leaf's float64 values of a kind (cast to the leaf dtype by
    the caller)."""
    if kind == "normal":
        return rng.standard_normal(3 * TILE) * 3.0
    if kind == "grid":        # 8-bit integer grid times a power of two
        return rng.integers(-127, 128, 3 * TILE) * 2.0 ** -5
    if kind == "ragged":      # a ragged last tile, on a grid
        return rng.integers(-100, 100, 2 * TILE + 77) * 0.5
    if kind == "neg_zero":    # -0.0 decodes to +0.0: ships raw
        v = rng.integers(-50, 50, 2 * TILE) * 1.0
        v[5] = -0.0
        return v
    if kind == "wide":        # tiles far apart in magnitude (within
        # float16's range), one of them on a grid
        v = rng.standard_normal(4 * TILE) * \
            np.repeat(10.0 ** np.array([-4, 4, 0, 2]), TILE)
        v[2 * TILE:3 * TILE] = np.round(v[2 * TILE:3 * TILE] * 16)
        return v
    if kind == "sub_tile":    # under one tile: never encodable
        return rng.standard_normal(TILE - 1)
    raise ValueError(kind)


KINDS = ["normal", "grid", "ragged", "neg_zero", "wide", "sub_tile"]


def _leaf(kind: str, dtype) -> np.ndarray:
    rng = np.random.default_rng(KINDS.index(kind))
    return _values(kind, rng).astype(dtype)


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("kind", KINDS)
def test_encode_decode_match_jax(kind, dtype, strict):
    leaf = _leaf(kind, dtype)
    buf = leaf.view(np.uint8)
    with np.errstate(all="ignore"):
        want = jwc.encode_leaf(buf, leaf.dtype, strict=strict)
    got = wc.encode_leaf(buf, leaf.dtype, strict=strict, device="cpu")
    assert (got is None) == (want is None)
    if want is None:
        return
    q, s, tiles = got
    assert tiles == want[2] == -(-leaf.size // TILE)
    assert _bits_equal(q, want[0]) and _bits_equal(s, want[1])
    raw = wc.decode_leaf(q, s, tiles, leaf.dtype, buf.nbytes, device="cpu")
    assert _bits_equal(raw, jwc.decode_leaf(q, s, tiles, leaf.dtype,
                                            buf.nbytes))
    if strict:  # exactly invertible, or it would have shipped raw
        assert raw.tobytes() == buf.tobytes()
    lo, hi = 1, tiles
    part = wc.decode_leaf_tiles(q[lo * TILE:hi * TILE], s[lo:hi], lo, hi,
                                leaf.dtype, device="cpu")
    assert _bits_equal(part, jwc.decode_leaf_tiles(
        q[lo * TILE:hi * TILE], s[lo:hi], lo, hi, leaf.dtype))


def test_which_leaves_ship_raw_match_jax():
    """The raw/delta8 decision of both packages per leaf kind, and the
    kinds that must encode (a grid, its ragged form) or must not (-0.0,
    arbitrary float noise in strict mode, a sub-tile leaf)."""
    decided = {}
    for kind in KINDS:
        leaf = _leaf(kind, np.float32)
        with np.errstate(all="ignore"):
            j = jwc.encode_leaf(leaf.view(np.uint8), leaf.dtype)
        p = wc.encode_leaf(leaf.view(np.uint8), leaf.dtype, device="cpu")
        assert (j is None) == (p is None), kind
        decided[kind] = p is not None
    assert decided == {"normal": False, "grid": True, "ragged": True,
                       "neg_zero": False, "wide": False, "sub_tile": False}


@pytest.mark.parametrize("dtype", [ml_dtypes.bfloat16, np.int32, np.int8,
                                   np.bool_])
def test_non_float_leaves_ship_raw(dtype):
    """bfloat16 (kind 'V' to numpy), ints and bools are not encodable in
    either package; the port also refuses the manifest's bf16 tag."""
    leaf = np.zeros(4 * TILE, dtype)
    assert not jwc.encodable(leaf.dtype, leaf.nbytes)
    assert not wc.encodable(leaf.dtype, leaf.nbytes)
    assert not wc.encodable(leaf.dtype.name, leaf.nbytes)
    assert wc.encode_leaf(leaf.view(np.uint8), leaf.dtype,
                          device="cpu") is None


def test_specs_and_records_match_jax():
    for spec in (None, False, True, {"strict": False}, {"tile": TILE}):
        assert wc.normalize_codec(spec) == jwc.normalize_codec(spec)
    leaves = {"a": {"mode": "raw", "offset": 0, "nbytes": 8}}
    spec = wc.normalize_codec({"strict": False})
    assert wc.codec_meta(spec, leaves, 8) == jwc.codec_meta(spec, leaves, 8)
    b = np.arange(100, dtype=np.uint8)
    assert wc.crc(b) == jwc.crc(b)
    assert wc.encodable(np.float32, TILE * 4) and \
        not wc.encodable(np.float32, TILE * 4 - 1)


def test_the_port_codec_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    leaf = _leaf("grid", np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wc.encode_leaf(leaf.view(np.uint8), leaf.dtype)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("kind", ["grid", "ragged", "normal", "wide"])
def test_kernels_match_plain_on_card(cuda, kind, strict):
    """The wire codec through the kernels (encode_tiles for strict=False,
    decode_tiles for the strict round trip and every decode) against its
    plain version, bit for bit, with one launch a call."""
    leaf = _leaf(kind, np.float32)
    buf = leaf.view(np.uint8)
    want = wc.encode_leaf(buf, leaf.dtype, strict=strict, device="cpu")
    e0, d0 = codec_ops.encode_launches, codec_ops.decode_launches
    got = wc.encode_leaf(buf, leaf.dtype, strict=strict, device=cuda)
    watchdog.synchronize()
    assert (codec_ops.encode_launches - e0, codec_ops.decode_launches - d0) \
        == ((0, 1) if strict else (1, 0))
    assert (got is None) == (want is None)
    if want is None:
        return
    assert _bits_equal(got[0], want[0]) and _bits_equal(got[1], want[1])
    d0 = codec_ops.decode_launches
    raw = wc.decode_leaf(*got, leaf.dtype, buf.nbytes, device=cuda)
    watchdog.synchronize()
    assert codec_ops.decode_launches - d0 == 1
    assert _bits_equal(raw, wc.decode_leaf(*want, leaf.dtype, buf.nbytes,
                                           device="cpu"))
