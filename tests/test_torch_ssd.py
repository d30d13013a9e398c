"""Port parity: repro_torch's SSD kernel and Mamba2 block against JAX's.

On the CPU the port's wrapper takes the plain version, held against the
JAX Pallas kernel in interpret mode, the JAX oracle and the JAX model's
``ssd_chunked`` at the shapes of ``tests/test_kernels.py``. The tests
marked ``cuda`` hold the Hopper kernel against the plain version on the
card and skip without one.
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.kernels.ssd.ops import ssd as j_ssd
from repro.kernels.ssd.ref import ssd_ref as j_ref
from repro.models import ssm as jS
from repro.models import transformer as jT
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.kernels.ssd import ops, ref
from repro_torch.kernels import watchdog
from repro_torch.models import ssm as S

jax.config.update("jax_platform_name", "cpu")

# b, s, h, p, g, n, chunk (tests/test_kernels.py)
SHAPES = [(2, 64, 4, 16, 2, 32, 16), (1, 48, 2, 8, 1, 16, 16),
          (1, 64, 4, 16, 4, 16, 32)]
# float32: the chunked and the sequential forms differ in summation order;
# 1e-4 as tests/test_kernels.py
TOL = 1e-4


def _inputs(b, s, h, p, g, n, seed=2, dtype=np.float32):
    """As tests/test_kernels.py: randn x, softplus(randn) dt, a in
    -exp(0.3 randn), B and C of scale 0.3."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    bb = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    cc = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    return x.astype(dtype), dt, a, bb.astype(dtype), cc.astype(dtype)


def _torch(arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES)
def test_plain_path_matches_jax_kernel(b, s, h, p, g, n, chunk):
    arrs = _inputs(b, s, h, p, g, n)
    want_y, want_st = j_ssd(*map(jnp.asarray, arrs), chunk=chunk,
                            interpret=True)
    before = ops.launches
    y, st = ops.ssd(*_torch(arrs), chunk=chunk)
    assert ops.launches == before  # the CPU path launches no kernel
    assert y.shape == (b, s, h, p) and st.shape == (b, h, p, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(want_st), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES)
def test_ref_matches_jax_ref(b, s, h, p, g, n, chunk):
    """Both oracles run the same sequential recurrence, kernel layout."""
    x, dt, a, bb, cc = _inputs(b, s, h, p, g, n, seed=3)
    tr = (lambda t: t.transpose(0, 2, 1, 3))  # noqa: E731
    args = (tr(x), dt.transpose(0, 2, 1), a, tr(bb), tr(cc))
    want_y, want_st = j_ref(*map(jnp.asarray, args))
    y, st = ref.ssd_ref(*_torch(args))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(want_st), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("s", [64, 50])
def test_ssd_matches_jax_model_chunked(s):
    """The port's model-layout ``ops.ssd`` against JAX's ``ssd_chunked``,
    as tests/test_kernels.py:86 holds the JAX kernel (two independent
    implementations); 50 is ragged against the chunk of 16."""
    arrs = _inputs(2, s, 4, 8, 1, 16, seed=4)
    want_y, want_st = jS.ssd_chunked(*map(jnp.asarray, arrs), 16)
    y, st = ops.ssd(*_torch(arrs), chunk=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(want_st), atol=TOL,
                               rtol=TOL)


# bf16: both sides round the same intermediates (x dt, the chunk terms) to
# bf16, but sum them in another order; a few bf16 ulps of y's ~5
CHUNKED_TOL = {"float32": 1e-5, "bfloat16": 6e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,chunk", [(64, 16), (50, 16), (40, 64)])
def test_ssd_chunked_matches_jax(s, chunk, dtype):
    """The port's ``ssd_chunked`` against JAX's, ragged tails included,
    from a nonzero initial state."""
    x, dt, a, bb, cc = _inputs(2, s, 4, 8, 2, 16, seed=5)
    h0 = np.random.default_rng(6).standard_normal((2, 4, 8, 16)) \
        .astype(np.float32)
    jx = [jnp.asarray(t).astype(getattr(jnp, dtype)) for t in (x, bb, cc)]
    want_y, want_st = jS.ssd_chunked(jx[0], jnp.asarray(dt), jnp.asarray(a),
                                     jx[1], jx[2], chunk,
                                     h0=jnp.asarray(h0))
    tx = [bridge.to_torch(np.asarray(t)) for t in jx]
    y, st = S.ssd_chunked(tx[0], torch.from_numpy(dt), torch.from_numpy(a),
                          tx[1], tx[2], chunk, h0=torch.from_numpy(h0))
    assert y.dtype == tx[0].dtype and st.dtype == torch.float32
    tol = CHUNKED_TOL[dtype]
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want_y, np.float32), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(st.numpy(), np.asarray(want_st), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_step_matches_jax(dtype):
    rng = np.random.default_rng(7)
    h = rng.standard_normal((2, 4, 8, 16)).astype(np.float32)
    x, dt, a, bb, cc = _inputs(2, 1, 4, 8, 2, 16, seed=8)
    d_skip = rng.standard_normal(4).astype(np.float32)
    jd = getattr(jnp, dtype)
    jx, jb, jc, jdk = (jnp.asarray(t).astype(jd) for t in
                       (x[:, 0], bb[:, 0], cc[:, 0], d_skip))
    want_y, want_h = jS.ssd_decode_step(jnp.asarray(h), jx, jnp.asarray(
        dt[:, 0]), jnp.asarray(a), jb, jc, jdk)
    tx, tb, tc, tdk = (bridge.to_torch(np.asarray(t))
                       for t in (jx, jb, jc, jdk))
    y, h_new = S.ssd_decode_step(torch.from_numpy(h), tx, torch.from_numpy(
        dt[:, 0]), torch.from_numpy(a), tb, tc, tdk)
    tol = 1e-5 if dtype == "float32" else 2e-2  # bf16: one ulp of y's ~1
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want_y, np.float32), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(h_new.numpy(), np.asarray(want_h),
                               atol=1e-5, rtol=1e-5)


def test_interpret_ssd_is_the_plain_version():
    jcfg = jregistry.get_smoke_config("mamba2-1.3b")
    cfg = registry.get_smoke_config("mamba2-1.3b")
    jparams, _ = jT.init_params(jax.random.PRNGKey(0), jcfg,
                                jT.ModelRuntime(max_seq=32, remat=False))
    lp = bridge.params_from_host(jax.tree.map(
        lambda t: np.asarray(t[0]), jparams["group0"]["p0"]["mixer"]), "cpu")
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (1, 21, 64)).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        a, sa = S.apply_ssd(lp, x, cfg, impl="interpret", return_state=True)
        b, sb = S.apply_ssd(lp, x, cfg, impl="pallas", return_state=True)
    assert torch.equal(a, b) and torch.equal(sa["h"], sb["h"])
    assert sa["h"].dtype == torch.float32 and sa["conv"].dtype == x.dtype
    with pytest.raises(ValueError, match="ssd_impl"):
        S.apply_ssd(lp, x, cfg, impl="chunked")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    def meta(*shape, dtype=torch.float32):
        return torch.zeros(shape, device="meta", dtype=dtype)
    x, dt, a = meta(2, 8, 4, 16), meta(2, 8, 4), meta(4)
    b = meta(2, 8, 2, 32)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.ssd(x, dt, a, b, b)
    ops._check(x, dt, a, b, b)
    with pytest.raises(ValueError, match="head_dim"):
        ops._check(meta(2, 8, 4, 32), dt, a, b, b)
    with pytest.raises(ValueError, match="d_state"):
        ops._check(x, dt, a, meta(2, 8, 2, 64), meta(2, 8, 2, 64))
    with pytest.raises(ValueError, match="group"):
        ops._check(x, dt, a, meta(2, 8, 3, 32), meta(2, 8, 3, 32))
    with pytest.raises(ValueError, match="mismatch"):
        ops._check(x, meta(2, 7, 4), a, b, b)
    with pytest.raises(TypeError, match="alike"):
        ops._check(x, dt, a, b.to(torch.bfloat16), b)
    with pytest.raises(ValueError, match="stride"):
        ops._check(meta(2, 8, 16, 4).transpose(2, 3), dt, a, b, b)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


# float32: the kernel's fused multiply-adds and its read-out order against
# the oracle's, ~1e-6 relative after hundreds of steps; bfloat16: y rounds
# once on each side, so it may differ by one bf16 ulp (2**-7 relative)
CARD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 2 ** -7 + 1e-3)}

CARD_SHAPES = [shape[:6] + ("float32",) for shape in SHAPES] + [
    (1, 77, 16, 8, 1, 16, "bfloat16"),     # mamba2-smoke, ragged S
    (2, 50, 4, 16, 2, 32, "bfloat16"),     # groups, ragged S
    (2, 300, 8, 64, 1, 128, "float32"),    # mamba2 P and N
    (1, 1, 4, 8, 1, 16, "float32"),        # one step
    (2, 4000, 64, 64, 1, 128, "bfloat16"),  # mamba2-1.3b prefill
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,g,n,dtype", CARD_SHAPES)
def test_kernel_matches_plain_on_card(cuda, b, s, h, p, g, n, dtype):
    x, dt, a, bb, cc = (t.to(cuda) for t in _torch(_inputs(
        b, s, h, p, g, n, seed=10)))
    if dtype == "bfloat16":
        x, bb, cc = (t.to(torch.bfloat16) for t in (x, bb, cc))
    before = ops.launches
    y, st = ops.ssd(x, dt, a, bb, cc)
    watchdog.synchronize()
    assert ops.launches == before + 1
    want_y, want_st = ops.reference(x, dt, a, bb, cc)
    atol, rtol = CARD_TOL[dtype]
    assert y.dtype == x.dtype
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               want_y.float().cpu().numpy(), atol=atol,
                               rtol=rtol)
    np.testing.assert_allclose(st.cpu().numpy(), want_st.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


def _card_inputs(cuda, b, s, h, p, g, n, dtype, seed=12):
    x, dt, a, bb, cc = (t.to(cuda) for t in _torch(_inputs(
        b, s, h, p, g, n, seed=seed)))
    if dtype == "bfloat16":
        x, bb, cc = (t.to(torch.bfloat16) for t in (x, bb, cc))
    return x, dt, a, bb, cc


def _launch(*args):
    before = ops.launches
    out = ops.ssd(*args)
    watchdog.synchronize()
    assert ops.launches == before + 1
    return out


def _assert_plain(got, args, dtype):
    want_y, want_st = ops.reference(*args)
    atol, rtol = CARD_TOL[dtype]
    assert got[0].dtype == args[0].dtype
    np.testing.assert_allclose(got[0].float().cpu().numpy(),
                               want_y.float().cpu().numpy(), atol=atol,
                               rtol=rtol)
    np.testing.assert_allclose(got[1].cpu().numpy(), want_st.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", ops.STATE_DIMS)
@pytest.mark.parametrize("p", ops.HEAD_DIMS)
def test_kernel_covers_every_p_and_n_on_card(cuda, p, n, dtype):
    args = _card_inputs(cuda, 2, 70, 4, p, 2, n, dtype)
    _assert_plain(_launch(*args), args, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [5, 31, 32, 33, 96, 135, 200])
def test_kernel_ring_tails_on_card(cuda, s):
    """S shorter than one 32-step tile, one tile, one step past it, and
    tile counts that are and are not multiples of the ring's 3 stages."""
    args = _card_inputs(cuda, 2, s, 4, 16, 1, 32, "bfloat16")
    _assert_plain(_launch(*args), args, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,g,n,dtype", [
    (2, 90, 8, 64, 4, 128, "bfloat16"), (1, 40, 8, 16, 8, 32, "float32"),
    (2, 77, 6, 8, 3, 16, "bfloat16")])
def test_kernel_groups_on_card(cuda, b, s, h, p, g, n, dtype):
    args = _card_inputs(cuda, b, s, h, p, g, n, dtype)
    _assert_plain(_launch(*args), args, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_kernel_reads_the_conv_output_on_card(cuda, offset):
    """x, B and C as slices of one [B, S, H*P + 2*G*N] bf16 buffer at
    mamba2's head and state widths, as apply_ssd passes them; offset 1
    shifts every row off 16-byte alignment (plain loads). Against the
    plain version, and bit for bit against contiguous copies."""
    b, s, h, p, g, n = 2, 100, 8, 64, 1, 128
    x, dt, a, bb, cc = _card_inputs(cuda, b, s, h, p, g, n, "bfloat16")
    parts = [x.flatten(2), bb.flatten(2), cc.flatten(2)]
    width = sum(t.shape[-1] for t in parts)
    buf = torch.zeros((b, s, width + offset), dtype=torch.bfloat16,
                      device=cuda)
    fused = buf[..., offset:]
    fused.copy_(torch.cat(parts, dim=-1))
    xv = fused[..., :h * p].unflatten(-1, (h, p))
    bv = fused[..., h * p:h * p + g * n].unflatten(-1, (g, n))
    cv = fused[..., h * p + g * n:].unflatten(-1, (g, n))
    assert not xv.is_contiguous()
    got = _launch(xv, dt, a, bv, cv)
    _assert_plain(got, (xv, dt, a, bv, cv), "bfloat16")
    want = _launch(x, dt, a, bb, cc)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,g,n,dtype", [
    (2, 500, 64, 64, 1, 128, "bfloat16"), (1, 77, 16, 8, 1, 16, "float32")])
def test_kernel_is_bit_identical_over_launches_on_card(cuda, b, s, h, p, g,
                                                       n, dtype):
    args = _card_inputs(cuda, b, s, h, p, g, n, dtype)
    first = _launch(*args)
    again = _launch(*args)
    assert torch.equal(first[0], again[0]) and \
        torch.equal(first[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fast", ["none", "second_half"])
def test_kernel_steps_runs_whose_decay_underflows_on_card(cuda, fast,
                                                          dtype):
    """dt 30x larger: a 16-step run's decay product leaves the rescaled
    form's range, and those runs take the step-by-step form; with
    "second_half" the first half of S keeps the usual dt, so both forms
    meet in one launch."""
    x, dt, a, bb, cc = _card_inputs(cuda, 2, 120, 4, 16, 1, 32, dtype)
    big = dt * 30
    if fast == "second_half":
        big[:, :60] = dt[:, :60]
    args = (x, big, a, bb, cc)
    _assert_plain(_launch(*args), args, dtype)


@pytest.mark.cuda
def test_kernel_reads_strided_views_on_card(cuda):
    """x, B and C as slices of one conv output, as apply_ssd passes
    them."""
    x, dt, a, bb, cc = (t.to(cuda) for t in _torch(_inputs(
        2, 70, 4, 16, 1, 32, seed=11)))
    fused = torch.cat([x.flatten(2), bb.flatten(2), cc.flatten(2)], dim=-1)
    xv = fused[..., :64].unflatten(-1, (4, 16))
    bv = fused[..., 64:96].unflatten(-1, (1, 32))
    cv = fused[..., 96:].unflatten(-1, (1, 32))
    assert not xv.is_contiguous()
    got = ops.ssd(xv, dt, a, bv, cv)
    want = ops.ssd(x, dt, a, bb, cc)
    watchdog.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_kernel_raises_instead_of_falling_back_on_card(cuda):
    x, dt, a, bb, cc = (t.to(cuda) for t in _torch(_inputs(
        1, 8, 2, 32, 1, 16)))
    with pytest.raises(ValueError, match="head_dim"):
        ops.ssd(x, dt, a, bb, cc)
    lib = ops._library()
    strides = (ctypes.c_longlong * 14)(*([0] * 14))
    # an unsupported head_dim reaches the C side as cudaErrorInvalidValue
    assert lib.repro_ssd_scan(1, 0, 0, 0, 0, 0, 0, 0, strides, 1, 8, 2, 1,
                              32, 16, 0) != 0
