"""Port parity: repro_torch.kernels.flash_attention against the JAX kernel.

On the CPU the port's wrapper takes the plain version, held against the
JAX Pallas kernel in interpret mode at the shapes of
``tests/test_kernels.py``. The tests marked ``cuda`` hold the Hopper
kernel against the plain version on the card and skip without one.
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro_torch import bridge
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.kernels import watchdog

jax.config.update("jax_platform_name", "cpu")

SHAPES = [
    # b, s, kh, g, dh, causal, window, cap, dtype
    (2, 128, 2, 4, 64, True, 0, 0.0, "bfloat16"),
    (1, 256, 1, 8, 128, True, 64, 50.0, "bfloat16"),
    (2, 128, 4, 1, 64, False, 0, 0.0, "float32"),
    (1, 256, 2, 2, 64, True, 128, 0.0, "float32"),
    (1, 128, 2, 3, 32, True, 0, 30.0, "bfloat16"),  # odd group
]
# as tests/test_kernels.py: bf16 outputs carry 8 mantissa bits and the
# kernels round p to bf16 before p.v; float32 differs by summation order
TOL = {"bfloat16": 2e-2, "float32": 2e-5}


def _inputs(b, s, kh, g, dh, dtype, seed=0, qscale=1.0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, kh * g, dh), (b, s, kh, dh), (b, s, kh, dh))]
    arrs[0] *= qscale
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tx = [bridge.to_torch(np.asarray(a)) for a in jx]
    return jx, tx


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,s,kh,g,dh,causal,window,cap,dtype", SHAPES)
def test_plain_path_matches_jax_kernel(b, s, kh, g, dh, causal, window, cap,
                                       dtype):
    (jq, jk, jv), (q, k, v) = _inputs(b, s, kh, g, dh, dtype)
    want = j_flash(jq, jk, jv, causal=causal, window=window, cap=cap,
                   interpret=True, bq=64, bk=64)
    before = ops.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window, cap=cap)
    assert ops.launches == before  # the CPU path launches no kernel
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


# cross-attention and non-causal shapes, Sq != Sk: whisper's decoder over
# its encoder's frames (D=64), its encoder, and starcoder2's group of 12
# q heads on one kv head (the wgmma kernel's CTA order walks the group)
CROSS_SHAPES = [
    # b, sq, sk, kh, g, dh, causal, dtype
    (2, 24, 16, 4, 1, 64, False, "bfloat16"),
    (2, 16, 48, 2, 3, 64, False, "float32"),
    (1, 64, 64, 1, 12, 128, True, "bfloat16"),
]


def _cross_inputs(b, sq, sk, kh, g, dh, dtype, seed=0, qscale=1.0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, sq, kh * g, dh), (b, sk, kh, dh),
                          (b, sk, kh, dh))]
    arrs[0] *= qscale
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    return jx, [bridge.to_torch(np.asarray(a)) for a in jx]


@pytest.mark.parametrize("b,sq,sk,kh,g,dh,causal,dtype", CROSS_SHAPES)
def test_plain_path_matches_jax_kernel_across_lengths(b, sq, sk, kh, g, dh,
                                                      causal, dtype):
    """Sq != Sk (and the group of 12) through the plain path, against
    JAX's Pallas kernel in interpret mode with whole blocks of 8."""
    (jq, jk, jv), (q, k, v) = _cross_inputs(b, sq, sk, kh, g, dh, dtype)
    want = j_flash(jq, jk, jv, causal=causal, interpret=True, bq=8, bk=8)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_interpret_attention_is_the_plain_version():
    """attn_impl 'interpret' runs the kernel's plain version, as JAX's
    runs the Pallas kernel without the TPU; short prompts take it too."""
    from repro_torch.models import attention
    for s in (40, 5):
        _, (q, k, v) = _inputs(1, s, 2, 2, 64, "bfloat16", seed=4)
        kw = dict(causal=True, window=16, cap=50.0)
        got = attention.attend(q, k, v, impl="interpret", **kw)
        assert torch.equal(got, ops.reference(q, k, v, **kw))
        assert torch.equal(got, attention.attend(q, k, v, impl="pallas",
                                                 **kw))


@pytest.mark.parametrize("b,s,kh,g,dh,causal,window,cap,dtype", SHAPES)
def test_ref_matches_jax_ref(b, s, kh, g, dh, causal, window, cap, dtype):
    """Both oracles compute in float32 and round once at the end, so
    they agree to float32 summation order even for bf16 inputs (the
    output rounding can still flip one bf16 ulp, 2**-8 relative)."""
    (jq, jk, jv), (q, k, v) = _inputs(b, s, kh, g, dh, dtype, seed=1)
    tr = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
    want = j_ref(tr(jq), tr(jk), tr(jv), causal=causal, window=window,
                 cap=cap)
    got = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            cap=cap)
    tol = 2 ** -8 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_wrapper_rejects_unaligned_rows():
    """Storage one element off a 16-byte boundary is refused: the kernel
    loads its tiles 16 bytes at a time."""
    for dtype in (torch.bfloat16, torch.float32):
        buf = torch.empty(1 * 8 * 4 * 64 + 1, device="meta", dtype=dtype)
        q = buf[1:].view(1, 8, 4, 64)
        k = torch.empty(1, 8, 2, 64, device="meta", dtype=dtype)
        with pytest.raises(ValueError, match="16-byte"):
            ops._check(q, k, k)
        with pytest.raises(ValueError, match="16-byte"):
            ops._check(k.repeat(1, 1, 2, 1), q[:, :, :2], k)
        ops._check(k.repeat(1, 1, 2, 1), k, k)


# Scores of randn q and k have a spread of about 1, where cap*tanh(s/cap)
# at cap 30 or 50 differs from s by under 1e-3, and the softmax spreads
# over thousands of keys, so one key more or less moves an output by a few
# parts in 1e3 of the row. q scaled by 8 reaches the tanh's bend and
# concentrates the softmax: there a missing softcap or a window one key
# off moves each row far beyond BF16_ROW_TOL.
SENSITIVE = [
    # b, s, kh, g, dh, causal, window, cap, qscale
    (1, 300, 2, 2, 256, True, 0, 50.0, 8.0),
    (1, 300, 2, 2, 256, True, 128, 50.0, 8.0),
]


@pytest.mark.parametrize("b,s,kh,g,dh,causal,window,cap,qscale", SENSITIVE)
def test_row_error_tells_a_wrong_kernel_from_a_sound_one(b, s, kh, g, dh,
                                                          causal, window,
                                                          cap, qscale):
    """The plain version with the cap left out, or the window one key
    off, stands in for a wrong kernel: at the scaled cases each misses
    BF16_ROW_TOL by far."""
    _, (q, k, v) = _inputs(b, s, kh, g, dh, "bfloat16", seed=2,
                           qscale=qscale)
    want = ops.reference(q, k, v, causal=causal, window=window, cap=cap)
    wrong = [dict(causal=causal, window=window, cap=0.0)]
    if window:
        wrong += [dict(causal=causal, window=window + 1, cap=cap),
                  dict(causal=causal, window=window - 1, cap=cap)]
    for kw in wrong:
        got = ops.reference(q, k, v, **kw)
        assert ref.row_error(got, want) > 4 * ref.BF16_ROW_TOL, kw


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 4, 48, device="meta")
    k = torch.zeros(1, 8, 2, 48, device="meta")
    # a meta call (the dry run's) is checked as a CUDA call is
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="devices differ"):
        ops.flash_attention(torch.zeros(1, 8, 4, 64, device="meta"),
                            torch.zeros(1, 8, 2, 64),
                            torch.zeros(1, 8, 2, 64), causal=True)
    with pytest.raises(ValueError, match="head_dim"):
        ops._check(q, k, k)
    q = torch.zeros(1, 8, 4, 64, device="meta")
    with pytest.raises(ValueError, match="shape"):
        ops._check(q, k, k)
    k = torch.zeros(1, 8, 3, 64, device="meta")
    with pytest.raises(ValueError, match="group"):
        ops._check(q, k, k)
    k = torch.zeros(1, 8, 2, 64, device="meta", dtype=torch.float16)
    with pytest.raises(TypeError, match="dtypes"):
        ops._check(q, k, k)
    k = torch.zeros(1, 8, 64, 2, device="meta").transpose(2, 3)
    with pytest.raises(ValueError, match="stride"):
        ops._check(q, k, k)


ROUTE_CASES = [  # dtype, head_dim, the route
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, 16, "mma_sync"),
    (torch.bfloat16, 32, "mma_sync"),
] + [(torch.float32, d, "f32") for d in ops.HEAD_DIMS]


@pytest.mark.parametrize("dtype,dh,want", ROUTE_CASES)
def test_route_follows_dtype_and_head_dim(dtype, dh, want):
    q = torch.empty(2, 40, 8, dh, device="meta", dtype=dtype)
    k = torch.empty(2, 40, 2, dh, device="meta", dtype=dtype)
    assert ops.route(q, k) == want
    assert want in ops.ROUTES


@pytest.mark.parametrize("qdtype,kdtype,dh,exc", [
    (torch.float16, torch.float16, 64, TypeError),
    (torch.bfloat16, torch.float32, 64, TypeError),
    (torch.bfloat16, torch.bfloat16, 48, ValueError),
    (torch.float32, torch.float32, 512, ValueError),
])
def test_route_raises_for_inputs_no_kernel_takes(qdtype, kdtype, dh, exc):
    q = torch.empty(1, 8, 2, dh, device="meta", dtype=qdtype)
    k = torch.empty(1, 8, 2, dh, device="meta", dtype=kdtype)
    with pytest.raises(exc):
        ops.route(q, k)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


# b, s, kh, g, dh, causal, window, cap, dtype, qscale
CARD_SHAPES = [shape + (1.0,) for shape in SHAPES] + [
    (2, 37, 8, 2, 256, True, 0, 50.0, "bfloat16", 1.0),     # ragged, gemma2
    (1, 300, 8, 2, 256, True, 128, 50.0, "bfloat16", 1.0),  # window, ragged
    (2, 77, 2, 2, 16, True, 16, 50.0, "float32", 1.0),      # smoke D, ragged
    (2, 77, 2, 2, 16, True, 16, 50.0, "bfloat16", 1.0),
    (1, 64, 2, 8, 128, False, 0, 0.0, "bfloat16", 1.0),     # qwen2 D
    (1, 200, 2, 2, 256, False, 64, 0.0, "bfloat16", 1.0),   # window, acausal
    (1, 100, 2, 2, 256, True, 32, 50.0, "float32", 1.0),    # gemma2 D, f32
    # the wgmma route's edges (BN = 64 keys at D=256, 128 at D=128 and 64)
    (1, 200, 2, 2, 256, True, 0, 50.0, "bfloat16", 1.0),    # Sk % BN != 0
    (2, 300, 2, 2, 128, True, 0, 0.0, "bfloat16", 1.0),     # Sk % BN != 0
    (1, 50, 2, 4, 128, True, 0, 0.0, "bfloat16", 1.0),      # Sq < 128
    (2, 100, 1, 2, 64, False, 0, 0.0, "bfloat16", 1.0),     # Sq < 128
    (1, 300, 2, 2, 256, True, 16, 50.0, "bfloat16", 8.0),   # window < tile
    (1, 300, 2, 2, 128, False, 40, 0.0, "bfloat16", 8.0),   # window < tile
    (1, 260, 2, 6, 128, True, 0, 0.0, "bfloat16", 1.0),     # group of 6
    (1, 333, 1, 7, 128, True, 0, 30.0, "bfloat16", 8.0),    # group of 7
] + [shape[:8] + ("bfloat16", shape[8]) for shape in SENSITIVE]


def _want_route(dtype, dh):
    if dtype == "float32":
        return "f32"
    return "wgmma" if dh in (64, 128, 256) else "mma_sync"


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,kh,g,dh,causal,window,cap,dtype,qscale",
                         CARD_SHAPES)
def test_kernel_matches_plain_on_card(cuda, b, s, kh, g, dh, causal, window,
                                      cap, dtype, qscale):
    _, (q, k, v) = _inputs(b, s, kh, g, dh, dtype, seed=2, qscale=qscale)
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    before = ops.launches
    by_route = dict(ops.launches_by_route)
    got = ops.flash_attention(q, k, v, causal=causal, window=window, cap=cap)
    watchdog.synchronize()
    assert ops.launches == before + 1
    route = _want_route(dtype, dh)
    assert ops.launches_by_route == {**by_route, route: by_route[route] + 1}
    want = ops.reference(q, k, v, causal=causal, window=window, cap=cap)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])
    if dtype == "bfloat16":
        assert ref.row_error(got, want) <= ref.BF16_ROW_TOL


# b, sq, sk, kh, g, dh, causal, dtype, qscale
CARD_CROSS_SHAPES = [
    (8, 64, 1500, 6, 1, 64, False, "bfloat16", 1.0),    # whisper cross
    (2, 1500, 1500, 6, 1, 64, False, "bfloat16", 1.0),  # whisper encoder
    (2, 64, 1500, 6, 1, 64, False, "bfloat16", 8.0),
    (2, 37, 333, 2, 3, 64, False, "bfloat16", 1.0),     # ragged both ways
    (2, 200, 70, 2, 2, 128, False, "bfloat16", 1.0),    # Sk < one tile
    (2, 24, 77, 2, 2, 64, False, "float32", 1.0),
    (1, 300, 300, 1, 12, 128, True, "bfloat16", 1.0),   # starcoder2 group
    (2, 260, 260, 2, 12, 128, True, "bfloat16", 8.0),
] + [shape + (1.0,) for shape in CROSS_SHAPES]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,kh,g,dh,causal,dtype,qscale",
                         CARD_CROSS_SHAPES)
def test_cross_and_grouped_kernel_match_plain_on_card(cuda, b, sq, sk, kh, g,
                                                      dh, causal, dtype,
                                                      qscale):
    """Non-causal attention with Sq != Sk (whisper's cross-attention and
    encoder at D=64, ragged tails on both sides) and a group of 12 q heads
    a kv head, on the route ``route`` names, against the plain version."""
    _, (q, k, v) = _cross_inputs(b, sq, sk, kh, g, dh, dtype, seed=6,
                                 qscale=qscale)
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    by_route = dict(ops.launches_by_route)
    got = ops.flash_attention(q, k, v, causal=causal)
    watchdog.synchronize()
    route = _want_route(dtype, dh)
    assert ops.launches_by_route == {**by_route, route: by_route[route] + 1}
    want = ops.reference(q, k, v, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])
    if dtype == "bfloat16":
        assert ref.row_error(got, want) <= ref.BF16_ROW_TOL


@pytest.mark.cuda
def test_kernel_reads_strided_views_on_card(cuda):
    """q/k/v as slices of one fused projection (non-contiguous heads)."""
    _, (q, k, v) = _inputs(1, 50, 2, 2, 64, "bfloat16", seed=3)
    fused = torch.cat([q, k, v], dim=2).to(cuda)
    q2, k2, v2 = fused[:, :, :4], fused[:, :, 4:6], fused[:, :, 6:]
    got = ops.flash_attention(q2, k2, v2, causal=True, cap=30.0)
    want = ops.flash_attention(q2.contiguous(), k2.contiguous(),
                               v2.contiguous(), causal=True, cap=30.0)
    watchdog.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128, 256])
def test_wgmma_reads_strided_views_on_card(cuda, dh):
    """The wgmma route's tensor maps over slices of one fused projection
    (non-contiguous heads, a ragged Sq), against the contiguous copies and
    the plain version."""
    _, (q, k, v) = _inputs(2, 150, 2, 3, dh, "bfloat16", seed=5)
    fused = torch.cat([q, k, v], dim=2).to(cuda)
    q2, k2, v2 = fused[:, :, :6], fused[:, :, 6:8], fused[:, :, 8:]
    before = ops.launches_by_route["wgmma"]
    got = ops.flash_attention(q2, k2, v2, causal=True, cap=50.0)
    want = ops.flash_attention(q2.contiguous(), k2.contiguous(),
                               v2.contiguous(), causal=True, cap=50.0)
    watchdog.synchronize()
    assert ops.launches_by_route["wgmma"] == before + 2
    assert torch.equal(got, want)
    plain = ops.reference(q2, k2, v2, causal=True, cap=50.0)
    assert ref.row_error(got, plain) <= ref.BF16_ROW_TOL


@pytest.mark.cuda
def test_interpret_attention_launches_no_kernel_on_card(cuda):
    """attn_impl 'interpret' is the plain version on the card too."""
    from repro_torch.models import attention
    _, (q, k, v) = _inputs(1, 40, 2, 2, 64, "bfloat16", seed=4)
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    before = ops.launches
    got = attention.attend(q, k, v, causal=True, window=16, cap=50.0,
                           impl="interpret")
    watchdog.synchronize()
    assert ops.launches == before
    assert torch.equal(got, ops.reference(q, k, v, causal=True, window=16,
                                          cap=50.0))


@pytest.mark.cuda
def test_kernel_raises_instead_of_falling_back_on_card(cuda):
    q = torch.zeros(1, 8, 4, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q[:, :, :2], q[:, :, :2], causal=True)
    lib = ops._library()
    strides = (ctypes.c_longlong * 12)(*([0] * 12))
    # an unsupported head_dim reaches the C side as cudaErrorInvalidValue
    assert lib.repro_flash_attention_fwd(0, 48, 0, 0, 0, 0, strides, 1, 1,
                                         1, 1, 1, 1, 0, 1.0, 0.0, 0) != 0
