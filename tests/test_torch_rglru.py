"""Port parity: repro_torch's RG-LRU kernel and block against the JAX ones.

On the CPU the port's wrapper takes the plain version, held against the
JAX Pallas kernel in interpret mode and the JAX oracle at the shapes of
``tests/test_kernels.py``; the block's scans against JAX's. The tests
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
from repro.kernels.rglru.ops import rglru as j_rglru
from repro.kernels.rglru.ref import rglru_ref as j_ref
from repro.models import rglru as jR
from repro.models import transformer as jT
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.kernels.rglru import ops, ref
from repro_torch.kernels import watchdog
from repro_torch.models import rglru as R

jax.config.update("jax_platform_name", "cpu")

SHAPES = [(2, 64, 32, 16), (1, 128, 64, 32), (3, 96, 16, 32)]  # b, s, w, block
# float32 throughout: the kernels and oracles differ only in the order of
# the multiply-adds (blocked doubling scan vs sequential), ~1e-7 relative
TOL = 1e-5


def _inputs(b, s, w, seed=1):
    """log_a in (-0.2, 0) and randn gated, as tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    log_a = (-np.abs(rng.standard_normal((b, s, w))) * 0.2 - 1e-3) \
        .astype(np.float32)
    gated = rng.standard_normal((b, s, w)).astype(np.float32)
    return log_a, gated


@pytest.mark.parametrize("b,s,w,block", SHAPES)
def test_plain_path_matches_jax_kernel(b, s, w, block):
    log_a, gated = _inputs(b, s, w)
    want = j_rglru(jnp.asarray(log_a), jnp.asarray(gated), block=block,
                   interpret=True)
    before = ops.launches
    got = ops.rglru(torch.from_numpy(log_a), torch.from_numpy(gated),
                    block=block)
    assert ops.launches == before  # the CPU path launches no kernel
    assert got.dtype == torch.float32 and got.shape == (b, s, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("b,s,w,block", SHAPES)
def test_ref_matches_jax_ref(b, s, w, block):
    """Both oracles run the same sequential multiply-adds."""
    log_a, gated = _inputs(b, s, w, seed=2)
    want = j_ref(jnp.asarray(log_a), jnp.asarray(gated))
    got = ref.rglru_ref(torch.from_numpy(log_a), torch.from_numpy(gated))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("s", [1, 37, 64, 96])
def test_rglru_scan_matches_jax(s):
    """The port's doubling scan against JAX's associative scan, ragged
    lengths included (neither needs a block multiple)."""
    log_a, gated = _inputs(2, s, 24, seed=3)
    want = jR.rglru_scan(jnp.asarray(log_a), jnp.asarray(gated))
    got = R.rglru_scan(torch.from_numpy(log_a), torch.from_numpy(gated))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(
        got.numpy(), ref.rglru_ref(torch.from_numpy(log_a),
                                   torch.from_numpy(gated)).numpy(),
        atol=TOL, rtol=TOL)


def _block(dtype):
    """The first RG-LRU layer of recurrentgemma-smoke, JAX-initialised."""
    jcfg = jregistry.get_smoke_config("recurrentgemma-9b")
    cfg = registry.get_smoke_config("recurrentgemma-9b")
    jrt = jT.ModelRuntime(tp=1, max_seq=32, remat=False)
    jparams, _ = jT.init_params(jax.random.PRNGKey(0), jcfg, jrt)
    jp = jax.tree.map(lambda a: a[0].astype(dtype),
                      jparams["group0"]["p0"]["mixer"])
    tp = bridge.params_from_host(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


# port impl -> JAX impl computing the same thing
IMPLS = {"pallas": "interpret", "interpret": "interpret", "jnp": "jnp"}


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_apply_rglru_prefill_and_decode_match_jax(impl):
    """The block in float32: prefill (S=32, a multiple of the JAX
    kernel's block of 8) through each scan, then one decode step from the
    prefill state; 2e-5 as the model-level float32 logits."""
    jcfg, cfg, jp, tp = _block(jnp.float32)
    x = np.random.default_rng(4).standard_normal((2, 33, 64)) \
        .astype(np.float32) * 0.5
    jy, jst = jR.apply_rglru(jp, jnp.asarray(x[:, :32]), jcfg,
                             impl=IMPLS[impl], return_state=True)
    with torch.no_grad():
        y, st = R.apply_rglru(tp, torch.from_numpy(x[:, :32]), cfg,
                              impl=impl, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-5,
                               rtol=2e-5)
    for n in ("h", "conv"):
        np.testing.assert_allclose(st[n].numpy(), np.asarray(jst[n]),
                                   atol=2e-5, rtol=2e-5, err_msg=n)
    jy1, jst1 = jR.apply_rglru(jp, jnp.asarray(x[:, 32:]), jcfg, state=jst)
    with torch.no_grad():
        y1, st1 = R.apply_rglru(tp, torch.from_numpy(x[:, 32:]), cfg,
                                state=st)
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy1), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(st1["h"].numpy(), np.asarray(jst1["h"]),
                               atol=2e-5, rtol=2e-5)


def test_interpret_rglru_is_the_plain_version():
    _, cfg, _, tp = _block(jnp.float32)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 21, 64)).astype(np.float32))
    with torch.no_grad():
        a, _ = R.apply_rglru(tp, x, cfg, impl="interpret")
        b, _ = R.apply_rglru(tp, x, cfg, impl="pallas")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="rglru_impl"):
        R.apply_rglru(tp, x, cfg, impl="blocked")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 8, 16, device="meta")
    # a CPU log_a beside a meta gated: neither the plain version nor a route
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.rglru(torch.zeros(2, 8, 16), x)
    # all on meta: the dry run's route, checked and launching nothing
    before = ops.launches
    assert ops.rglru(x, x).device.type == "meta" and ops.launches == before
    with pytest.raises(ValueError, match="B,S,W"):
        ops._check(x, x[:, :4])
    with pytest.raises(TypeError, match="float32"):
        ops._check(x.to(torch.bfloat16), x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="stride"):
        y = torch.zeros(2, 16, 8, device="meta").transpose(1, 2)
        ops._check(y, y)
    ops._check(x, x)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


CARD_SHAPES = [
    (2, 64, 32), (1, 128, 64), (3, 96, 16),   # tests/test_kernels.py
    (3, 37, 100),                             # ragged S and W
    (2, 32, 64),                              # recurrentgemma-smoke
    (1, 1, 5),                                # one step
    (2, 3000, 4096),                          # recurrentgemma-9b prefill
    (1, 20000, 256),                          # 313 sequence tiles chained
    (2, 64, 4),                               # one tile, W of one lane
    (2, 65, 130),                             # one step past a tile
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,w", CARD_SHAPES)
def test_kernel_matches_plain_on_card(cuda, b, s, w):
    log_a, gated = (torch.from_numpy(t).to(cuda)
                    for t in _inputs(b, s, w, seed=6))
    before = ops.launches
    got = ops.rglru(log_a, gated)
    watchdog.synchronize()
    assert ops.launches == before + 1
    want = ops.reference(log_a, gated)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=TOL, rtol=TOL)


@pytest.mark.cuda
def test_kernel_reads_strided_views_on_card(cuda):
    """Batch and sequence strides of a larger buffer."""
    log_a, gated = (torch.from_numpy(t).to(cuda)
                    for t in _inputs(2, 80, 48, seed=7))
    both = torch.stack([log_a, gated], dim=1)  # [B, 2, S, W]
    got = ops.rglru(both[:, 0], both[:, 1])
    want = ops.rglru(log_a, gated)
    watchdog.synchronize()
    assert torch.equal(got, want)


def _launch(log_a, gated):
    before = ops.launches
    got = ops.rglru(log_a, gated)
    watchdog.synchronize()
    assert ops.launches == before + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("w,pad", [(37, 1), (64, 1), (100, 3)])
def test_kernel_reads_unaligned_rows_on_card(cuda, w, pad):
    """Rows that break 16-byte alignment (the channel slice starts 4 pad
    bytes into a row of W + pad + 3 floats), W a multiple of 4 or not:
    against the plain version, and bit for bit against the contiguous
    copy (which may take the aligned loads)."""
    bufs = []
    for t in _inputs(2, 150, w + pad + 3, seed=9):
        bufs.append(torch.from_numpy(t).to(cuda)[..., pad:pad + w])
    log_a, gated = bufs
    assert log_a.data_ptr() % 16 and not log_a.is_contiguous()
    got = _launch(log_a, gated)
    want = ops.reference(log_a, gated)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=TOL, rtol=TOL)
    assert torch.equal(got, _launch(log_a.contiguous(), gated.contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,w", [(2, 3000, 4096), (1, 20000, 256),
                                   (3, 37, 100)])
def test_kernel_is_bit_identical_over_launches_on_card(cuda, b, s, w):
    """Each tile waits for its predecessor's inclusive state, whatever
    order the blocks run in, so two launches give the same bits."""
    log_a, gated = (torch.from_numpy(t).to(cuda)
                    for t in _inputs(b, s, w, seed=10))
    first = _launch(log_a, gated)
    assert torch.equal(first, _launch(log_a, gated))


@pytest.mark.cuda
def test_kernel_raises_instead_of_falling_back_on_card(cuda):
    x = torch.zeros(1, 8, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        ops.rglru(x, x)
    lib = ops._library()
    strides = (ctypes.c_longlong * 6)(*([0] * 6))
    # an empty width reaches the C side as cudaErrorInvalidValue
    assert lib.repro_rglru_scan(0, 0, 0, strides, 1, 8, 0, 0, 0) != 0
    n = ctypes.c_longlong()
    assert lib.repro_rglru_scratch(1, 8, 0, ctypes.byref(n)) < 0
