"""Port parity: the delta-int8 checkpoint codec against the JAX package.

The plain PyTorch codec (what a CPU tensor runs) must equal JAX's numpy
oracle, which the live checkpoint path runs, bit for bit: codes, scales
and decoded bits, in float32, bfloat16 and int32, at ragged sizes, with
exact half-way ties and all-zero tiles. Against JAX's Pallas kernels in
interpret mode it is held to JAX's own tolerance (tests/test_kernels.py):
more than 99.9% of the codes, scales to 1e-6. On the card the kernels are
held to the plain version exactly.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.ckpt_codec import ops as jops
from repro.kernels.ckpt_codec.ref import decode_ref as j_decode_ref
from repro.kernels.ckpt_codec.ref import encode_ref as j_encode_ref
from repro_torch import bridge
from repro_torch.kernels.ckpt_codec import ops
from repro_torch.kernels import watchdog
from repro_torch.kernels.ckpt_codec.ref import TILE, decode_ref, encode_ref

jax.config.update("jax_platform_name", "cpu")

SIZES = [1, 1000, 1024, 2048, 5000]
DTYPES = ["float32", "bfloat16", "int32"]


def _pair(n: int, dtype: str, seed: int = 0):
    """(new, base) numpy arrays of n elements in ``dtype``: the first
    tile holds exact half-way ties (max |d| = 127 makes scale 1.0, so
    d = 2.5, 3.5, -2.5, -0.5 divide to halves); a second tile, where
    there is one, is all-zero (new == base, scale 1e-12); the rest is
    random."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        base = rng.integers(-1000, 1000, n).astype(np.int32)
        new = base + rng.integers(-300, 300, n).astype(np.int32)
    else:
        base = rng.standard_normal(n).astype(np.float32)
        new = base + rng.standard_normal(n).astype(np.float32) * 0.01
        if n >= 8:
            base[:8] = 0.0
            new[:8] = [127.0, 2.5, 3.5, -2.5, -0.5, 0.5, 1.5, -127.0]
    if n >= 2 * TILE:
        new[TILE:2 * TILE] = base[TILE:2 * TILE]
    if dtype == "bfloat16":
        return new.astype(ml_dtypes.bfloat16), base.astype(ml_dtypes.bfloat16)
    return new, base


def _padded_f32(a: np.ndarray) -> np.ndarray:
    """JAX's checkpoint path: float32, flat, zero-padded to whole tiles."""
    f = np.asarray(a, np.float32).reshape(-1)
    return np.pad(f, (0, (-f.size) % TILE)).reshape(-1, TILE)


def _bits(a) -> np.ndarray:
    """Either package's array as comparable bits (bf16 as uint16)."""
    return bridge.to_numpy(a)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_plain_codec_matches_numpy_oracle(n, dtype):
    new, base = _pair(n, dtype)
    want_q, want_s = j_encode_ref(_padded_f32(new), _padded_f32(base))
    tn, tb = bridge.to_torch(new), bridge.to_torch(base)
    q, s = ops.delta_encode(tn, tb)
    np.testing.assert_array_equal(q.numpy(), want_q)
    assert s.dtype == torch.float32 and s.shape == want_s.shape
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  want_s.view(np.uint32))
    if n >= 8 and dtype != "int32":
        # half-way ties round to even, as np.round does
        assert s[0, 0].item() == 1.0
        assert q[0, :8].tolist() == [127, 2, 4, -2, 0, 0, 2, -127]
    if n >= 2 * TILE:
        assert s[1, 0].item() == np.float32(1e-12)
        assert not q[1].any()
    want = j_decode_ref(want_q, want_s, _padded_f32(base),
                        dtype=np.dtype(dtype)).reshape(-1)[:n]
    got = ops.delta_decode(q, s, tb, shape=(n,),
                           dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_tile_functions_match_numpy_oracle(dtype):
    """encode_tiles/decode_tiles and the ref functions on [n, TILE]."""
    new, base = _pair(3 * TILE, dtype, seed=1)
    new, base = new.reshape(3, TILE), base.reshape(3, TILE)
    want_q, want_s = j_encode_ref(new, base)
    tn, tb = bridge.to_torch(new), bridge.to_torch(base)
    for q, s in (ops.encode_tiles(tn, tb), encode_ref(tn, tb)):
        np.testing.assert_array_equal(q.numpy(), want_q)
        np.testing.assert_array_equal(s.numpy(), want_s)
    want = j_decode_ref(want_q, want_s, base, dtype=np.dtype(dtype))
    dt = getattr(torch, dtype)
    for got in (ops.decode_tiles(q, s, tb, dtype=dt),
                decode_ref(q, s, tb, dt)):
        assert got.shape == (3, TILE)
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n,dtype", [(5000, "float32"), (2048, "bfloat16"),
                                     (1024, "float32")])
def test_delta_codec_matches_jax_interpret(n, dtype):
    """JAX's Pallas kernels in interpret mode, at JAX's own tolerance:
    its interpret path rounds (new - base) / scale another way, so codes
    may sit one apart at ties (tests/test_kernels.py)."""
    new, base = _pair(n, dtype, seed=2)
    jq, js = jops.delta_encode(jnp.asarray(new), jnp.asarray(base),
                               interpret=True)
    tn, tb = bridge.to_torch(new), bridge.to_torch(base)
    q, s = ops.delta_encode(tn, tb)
    assert (q.numpy() == np.asarray(jq)).mean() > 0.999
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jdec = jops.delta_decode(jq, js, jnp.asarray(base), shape=(n,),
                             dtype=jdt, interpret=True)
    dec = ops.delta_decode(q, s, tb, shape=(n,), dtype=getattr(torch, dtype))
    # each side within its tile's scale of new (test_kernels.py's bound)
    bound = np.repeat(s.numpy()[:, 0], TILE)[:n] + 1e-6
    for got in (dec.float().numpy(), np.asarray(jdec, np.float32)):
        assert (np.abs(got - np.asarray(new, np.float32)) <= bound).all()


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(2, TILE)
    with pytest.raises(ValueError, match="n_tiles"):
        ops.encode_tiles(torch.zeros(2, 100), torch.zeros(2, 100))
    with pytest.raises(TypeError, match="dtype"):
        ops.delta_encode(torch.zeros(5, dtype=torch.float64),
                         torch.zeros(5, dtype=torch.float64))
    with pytest.raises(ValueError, match="elements"):
        ops.delta_encode(torch.zeros(5), torch.zeros(6))
    with pytest.raises(ValueError, match="contiguous"):
        ops.delta_encode(x.t(), x.t())
    q, s = ops.delta_encode(x, x)
    with pytest.raises(ValueError, match="cover"):
        ops.delta_decode(q, s, torch.zeros(3 * TILE), shape=(3 * TILE,))
    with pytest.raises(TypeError, match="int8"):
        ops.delta_decode(q.float(), s, x, shape=x.shape)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES + [5 * TILE + 3, 1 << 20])
def test_kernels_match_plain_on_card(cuda, n, dtype):
    """Codes, scales and decoded bits equal to the plain version's and to
    the numpy oracle's; a view one element into its storage takes the
    unaligned path."""
    new, base = _pair(n + 1, dtype, seed=3)
    tn, tb = bridge.to_torch(new).to(cuda), bridge.to_torch(base).to(cuda)
    for off in (0, 1):
        a, b = tn[off:off + n], tb[off:off + n]
        e0, d0 = ops.encode_launches, ops.decode_launches
        q, s = ops.delta_encode(a, b)
        watchdog.synchronize()
        pq, ps = ops.delta_encode(a, b, interpret=True)
        assert ops.encode_launches == e0 + 1
        assert torch.equal(q, pq) and torch.equal(s, ps)
        want_q, want_s = j_encode_ref(_padded_f32(new[off:off + n]),
                                      _padded_f32(base[off:off + n]))
        np.testing.assert_array_equal(q.cpu().numpy(), want_q)
        np.testing.assert_array_equal(s.cpu().numpy(), want_s)
        got = ops.delta_decode(q, s, b, shape=(n,), dtype=a.dtype)
        watchdog.synchronize()
        want = ops.delta_decode(q, s, b, shape=(n,), dtype=a.dtype,
                                interpret=True)
        assert ops.decode_launches == d0 + 1
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_mixed_dtypes_on_card(cuda):
    """new and base of different dtypes, and a decode into another dtype
    than the base's (the kernel's nine instances)."""
    new, base = _pair(3000, "float32", seed=4)
    tn, tb = torch.from_numpy(new).to(cuda), torch.from_numpy(base).to(cuda)
    kinds = (torch.float32, torch.bfloat16, torch.int32)
    for dn in kinds:
        for db in kinds:
            a, b = (tn * 100).to(dn), (tb * 100).to(db)
            q, s = ops.delta_encode(a, b)
            watchdog.synchronize()
            pq, ps = ops.delta_encode(a, b, interpret=True)
            assert torch.equal(q, pq) and torch.equal(s, ps), (dn, db)
            got = ops.delta_decode(q, s, b, shape=(3000,), dtype=dn)
            watchdog.synchronize()
            want = ops.delta_decode(q, s, b, shape=(3000,), dtype=dn,
                                    interpret=True)
            assert torch.equal(got, want), (dn, db)
