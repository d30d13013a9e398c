"""Port parity: repro_torch's grouped matmul, sorted-token layout and MoE
layer against the JAX ones.

On the CPU the port's ``gmm`` wrapper takes the plain version, held
against the JAX Pallas kernel in interpret mode at JAX-legal shapes; the
port's ``moe_ffn_sorted`` against JAX's; the port's layout against its
own invariants; ``apply_moe`` (sorted route) and ``apply_moe_gshard``
against JAX's ``apply_moe_gshard`` on grok-1 and arctic smoke layers;
router ties against ``jax.lax.top_k``. The tests marked ``cuda`` hold the
Hopper kernel against the plain version on the card and skip without one.

Tolerances. float32: the two sides differ in summation order only, about
1e-6 relative; held to 1e-5. bfloat16: every gmm output is a float32 sum
rounded once to bf16 on both sides, so a gmm output may differ by one
bf16 ulp (2**-7 relative at most) where the float32 sums straddle a
rounding boundary; through the FFN (silu, product, a second gmm) and the
combine, a few ulps (stated per test).
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.kernels.moe_gmm.kernel import gmm as j_gmm
from repro.kernels.moe_gmm.ops import moe_ffn_sorted as j_moe_ffn_sorted
from repro.models import moe as jmoe
from repro.models import transformer as jT
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.kernels.moe_gmm import ops, ref
from repro_torch.kernels import watchdog
from repro_torch.models import moe
from repro_torch.models import transformer as T

jax.config.update("jax_platform_name", "cpu")

F32_TOL = 1e-5
BF16_ULP = 2.0 ** -7
ARCHS = ["grok-1-314b", "arctic-480b"]


def _np(x):
    return np.asarray(x, np.float32)


def _bf16(a):
    """numpy float32 -> (jnp bf16, torch bf16) with the same values."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, bridge.to_torch(np.asarray(j))


def _assert_f32(got, want):
    """Within F32_TOL of each value and of the largest one: the expert
    weights are unit-normal (JAX's fan-in over the slot axis), so outputs
    reach hundreds and a small one carries the rounding of its big
    neighbours' sums."""
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=F32_TOL,
                               atol=F32_TOL * np.abs(want).max())


def _assert_ulps(got, want, ulps, atol=0.0, msg=""):
    """|got - want| <= ulps bf16 ulps of |want| (+ atol)."""
    got, want = _np(got), _np(want)
    bound = ulps * BF16_ULP * np.abs(want) + atol
    bad = np.abs(got - want) > bound
    assert not bad.any(), (f"{msg} {bad.sum()} of {bad.size} beyond "
                           f"{ulps} ulp: max |diff| "
                           f"{np.abs(got - want).max()}")


# ---------------------------------------------------------------------------
# gmm: the plain version against the JAX kernel
# ---------------------------------------------------------------------------

GMM_SHAPES = [(64, 32, 4, 64, 8), (32, 16, 2, 32, 8),   # test_kernels.py
              (96, 48, 3, 96, 16), (128, 64, 8, 128, 32)]


def _gmm_inputs(t, d, e, f, bt, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) * 0.1).astype(np.float32)
    be = rng.integers(0, e, t // bt).astype(np.int32)
    return x, w, be


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d,e,f,bt", GMM_SHAPES)
def test_plain_gmm_matches_jax_kernel(t, d, e, f, bt, dtype):
    x, w, be = _gmm_inputs(t, d, e, f, bt)
    if dtype == "bfloat16":
        (jx, tx), (jw, tw) = _bf16(x), _bf16(w)
    else:
        jx, jw, tx, tw = (jnp.asarray(x), jnp.asarray(w),
                          torch.from_numpy(x), torch.from_numpy(w))
    want = j_gmm(jx, jw, jnp.asarray(be), bt=bt, bf=min(32, f),
                 interpret=True)
    before = ops.launches
    got = ops.gmm(tx, tw, torch.from_numpy(be), bt=bt, bf=min(32, f))
    assert ops.launches == before  # the CPU path launches no kernel
    assert got.dtype == tx.dtype and got.shape == (t, f)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), _np(want), atol=F32_TOL,
                                   rtol=F32_TOL)
    else:  # one rounding of a float32 sum on each side
        _assert_ulps(got.float(), want, 1, atol=1e-6)


def test_plain_gmm_gives_zeros_for_empty_blocks():
    x, w, be = _gmm_inputs(64, 32, 4, 40, 16, seed=1)
    be[-2:] = -1
    got = ref.gmm_ref(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(be), 16)
    assert torch.count_nonzero(got[-32:]) == 0
    want = np.concatenate([x[i * 16:(i + 1) * 16] @ w[be[i]]
                           for i in range(2)])
    np.testing.assert_allclose(got[:32].numpy(), want, atol=F32_TOL,
                               rtol=F32_TOL)


# ---------------------------------------------------------------------------
# the sorted layout and the expert FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,e,bt", [(50, 4, 16), (7, 8, 16), (300, 16, 32),
                                    (1, 8, 16), (256, 3, 128)])
def test_sorted_layout_invariants(t, e, bt):
    rng = np.random.default_rng(t + e)
    ids = rng.integers(0, e, t)
    ids[ids == e - 1] = 0  # the last expert is empty
    x = torch.from_numpy(rng.standard_normal((t, 12)).astype(np.float32))
    buf, be, (order, slots) = ops.sort_tokens_by_expert(
        x, torch.from_numpy(ids), e, bt)
    rows = buf.shape[0]
    assert rows == ops.padded_rows(t, e, bt) and rows % bt == 0
    assert rows <= -(-(t + e * (bt - 1)) // bt) * bt
    assert be.dtype == torch.int32 and be.shape == (rows // bt,)
    be, slots, order = be.numpy(), slots.numpy(), order.numpy()
    # every token's row sits in a block of its own expert, in sorted order
    np.testing.assert_array_equal(be[slots // bt], ids[order])
    assert np.all(np.diff(ids[order]) >= 0)
    np.testing.assert_array_equal(buf.numpy()[slots], x.numpy()[order])
    # pad rows are zero
    pad = np.setdiff1d(np.arange(rows), slots)
    assert not buf.numpy()[pad].any()
    # -1 marks only trailing blocks; groups start on block boundaries
    live = be >= 0
    assert live.sum() == sum(-(-np.sum(ids == k) // bt) for k in range(e))
    assert np.all(live[:live.sum()]) and not np.any(live[live.sum():])
    assert np.all(np.diff(be[live]) >= 0)
    assert e - 1 not in be
    back = ops.unsort(buf, (torch.from_numpy(order), torch.from_numpy(slots)),
                      t)
    assert torch.equal(back, x)


def test_choose_bt():
    assert ops.choose_bt(12000, 8) == 128      # grok-1 prefill
    assert ops.choose_bt(12000, 128) == 128    # arctic prefill
    assert ops.choose_bt(4, 8) == 16           # a decode step
    assert ops.choose_bt(300, 16) == 32
    assert ops.choose_bt(40, 8) == 16          # the smoke layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,e", [(64, 4), (40, 8)])
def test_moe_ffn_sorted_matches_jax(t, e, dtype):
    """The port's padding (bt 16 from choose_bt) against JAX's worst-case
    layout (bt 8): the same function."""
    d, f = 32, 64
    rng = np.random.default_rng(5)
    x = rng.standard_normal((t, d)).astype(np.float32)
    ids = rng.integers(0, e, t).astype(np.int32)
    ws = [(rng.standard_normal(s) * 0.2).astype(np.float32)
          for s in ((e, d, f), (e, d, f), (e, f, d))]
    if dtype == "bfloat16":
        pairs = [_bf16(a) for a in [x] + ws]
    else:
        pairs = [(jnp.asarray(a), torch.from_numpy(a)) for a in [x] + ws]
    (jx, tx), *jw = pairs
    want = j_moe_ffn_sorted(jx, jnp.asarray(ids), *(j for j, _ in jw),
                            n_experts=e, bt=8, bf=32, interpret=True)
    got = ops.moe_ffn_sorted(tx, torch.from_numpy(ids), *(t_ for _, t_ in jw),
                             n_experts=e)
    assert got.dtype == tx.dtype and got.shape == (t, d)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), _np(want), atol=F32_TOL,
                                   rtol=F32_TOL)
    else:
        # h and g one ulp apart at most, silu(g) h rounded once more, then
        # a second gmm: bounded by 4 ulps of the output row's scale
        scale = np.abs(_np(want)).max(axis=1, keepdims=True)
        assert np.all(np.abs(got.float().numpy() - _np(want)) <=
                      4 * BF16_ULP * scale)


# ---------------------------------------------------------------------------
# the MoE layer against JAX's gshard
# ---------------------------------------------------------------------------

def _layer(arch, dtype, s=9, b=2, seed=6):
    """A smoke config's first MoE layer from JAX's init, and an input."""
    jcfg = jregistry.get_smoke_config(arch)
    cfg = registry.get_smoke_config(arch)
    jparams, _ = jT.init_params(
        jax.random.PRNGKey(0), jcfg,
        jT.ModelRuntime(tp=1, attn_impl="naive", max_seq=32, remat=False))
    jp = jax.tree.map(lambda a: a[0], jparams["group0"]["p0"]["mlp"])
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    else:
        jx, tx = _bf16(x)
    p = bridge.params_from_host(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, p, jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["pallas", "gshard"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax_gshard(arch, impl, dtype):
    jcfg, cfg, jp, p, jx, tx = _layer(arch, dtype)
    want, jaux = jmoe.apply_moe_gshard(jp, jx, jcfg)
    # the routing itself: both packages pick the same experts
    _, jids, _ = jmoe.router_probs(jp, jx, jcfg)
    _, ids, _ = moe.router_probs(p, tx, cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    before = ops.launches
    with torch.no_grad():
        got, aux = moe.apply_moe(p, tx, cfg, impl=impl)
    assert ops.launches == before
    assert got.dtype == tx.dtype and got.shape == tx.shape
    # the load-balance loss from the same routing: float32 sums in another
    # order; in bf16 a router logit may round one ulp apart, which moves a
    # probability by ~2**-8 of itself
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(aux.item(), float(jaux),
                               rtol=1e-5 if dtype == "float32" else 1e-2)
    if dtype == "float32":
        _assert_f32(got, want)
    else:
        # the routes round h, g, silu and y in bf16 at other places (JAX's
        # gshard takes silu in bf16, the sorted route in float32); held to
        # 6 ulps of each token's largest output
        scale = np.abs(_np(want)).max(axis=-1, keepdims=True)
        assert np.all(np.abs(got.float().numpy() - _np(want)) <=
                      6 * BF16_ULP * scale)


def test_apply_moe_routes_agree_on_the_port():
    """pallas and interpret are the same route on the CPU; gshard the
    dense oracle."""
    _, cfg, _, p, _, tx = _layer("arctic-480b", "float32", s=13)
    with torch.no_grad():
        a, aux_a = moe.apply_moe(p, tx, cfg, impl="pallas")
        b, aux_b = moe.apply_moe(p, tx, cfg, impl="interpret")
        c, aux_c = moe.apply_moe(p, tx, cfg, impl="gshard")
    assert torch.equal(a, b)
    assert torch.equal(aux_a, aux_b) and torch.equal(aux_a, aux_c)
    _assert_f32(a, c)
    with pytest.raises(ValueError, match="moe_impl"):
        moe.apply_moe(p, tx, cfg, impl="etp")


@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_break_like_jax_top_k(arch):
    """Router columns that repeat give equal probabilities; jax.lax.top_k
    keeps the lower index first, and so must the port."""
    jcfg, cfg, jp, p, jx, tx = _layer(arch, "bfloat16", s=16)
    e = cfg.moe.n_experts
    rng = np.random.default_rng(8)
    base = rng.standard_normal((cfg.d_model, 3)).astype(np.float32)
    cols = base[:, rng.integers(0, 3, e)]      # every expert ties with others
    cols[:, : e // 2] *= 0.0                   # half of them tie at zero
    jr, tr = _bf16(cols)
    jp = dict(jp, router=jr)
    p = dict(p, router=tr)
    jg, jids, _ = jmoe.router_probs(jp, jx, jcfg)
    g, ids, _ = moe.router_probs(p, tx, cfg)
    jprobs = np.asarray(jmoe.router_probs(jp, jx, jcfg)[2])
    top = np.sort(jprobs, axis=-1)[..., ::-1]
    assert (top[..., 1] == top[..., 2]).any() or \
        (top[..., 0] == top[..., 1]).any()  # the case has real ties
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(g.numpy(), _np(jg), atol=1e-6, rtol=1e-6)


def test_moe_layout_is_single_device():
    cfg = registry.get_smoke_config("grok-1-314b")
    lay = moe.make_moe_layout(cfg, 1)
    assert (lay.slots, lay.e_loc, lay.f_loc) == (1, 4, 128)
    with pytest.raises(NotImplementedError, match="tp=2"):
        moe.make_moe_layout(cfg, 2)


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_jax(arch, getter):
    mine = getattr(registry, getter)(arch)
    ref_cfg = getattr(jregistry, getter)(arch)
    assert mine.param_count() == ref_cfg.param_count()
    assert mine.active_param_count() == ref_cfg.active_param_count()
    assert mine.active_param_count() < mine.param_count()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(64, 32, device="meta", dtype=torch.bfloat16)
    w = torch.zeros(4, 32, 48, device="meta", dtype=torch.bfloat16)
    be = torch.zeros(4, device="meta", dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.gmm(x, w, be, bt=16)
    with pytest.raises(ValueError, match="multiple of 16"):
        ops._check(x, w, torch.zeros(8, device="meta", dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="block_expert"):
        ops._check(x, w, be.long(), 16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        ops._check(x.half(), w.half(), be, 16)
    with pytest.raises(ValueError, match="multiples of 8"):
        ops._check(x[:, :30], w[:, :30], be, 16)
    with pytest.raises(ValueError, match="stride 1"):
        ops._check(x, w.transpose(1, 2).contiguous().transpose(1, 2), be, 16)
    ops._check(x, w, be, 16)


@pytest.mark.parametrize("dtype,bt,want", [
    (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, 192, "wgmma"),
    (torch.bfloat16, 16, "mma_sync"),
    (torch.bfloat16, 32, "mma_sync"),
    (torch.bfloat16, 96, "mma_sync"),
    (torch.float32, 16, "f32"),
    (torch.float32, 128, "f32"),
])
def test_gmm_route_follows_dtype_and_row_block(dtype, bt, want):
    x = torch.empty(4 * bt, 64, device="meta", dtype=dtype)
    w = torch.empty(3, 64, 48, device="meta", dtype=dtype)
    assert ops.gmm_route(x, w, bt) == want
    assert want in ops.ROUTES


@pytest.mark.parametrize("xdtype,wdtype,bt,exc", [
    (torch.float16, torch.float16, 64, TypeError),
    (torch.bfloat16, torch.float32, 64, TypeError),
    (torch.bfloat16, torch.bfloat16, 8, ValueError),
    (torch.float32, torch.float32, 0, ValueError),
])
def test_gmm_route_raises_for_inputs_no_kernel_takes(xdtype, wdtype, bt,
                                                     exc):
    x = torch.empty(64, 32, device="meta", dtype=xdtype)
    w = torch.empty(2, 32, 16, device="meta", dtype=wdtype)
    with pytest.raises(exc):
        ops.gmm_route(x, w, bt)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _routed(t, d, f, e, bt, dtype, dev, seed=9, empty=True):
    """A routed layout on the card: x of t tokens sorted into blocks of bt
    (expert 1 left empty, trailing -1 blocks), unit-scale outputs."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, e, (t,), generator=g, device=dev)
    if empty:
        ids[ids == 1] = 0
    x = torch.randn((t, d), generator=g, device=dev)
    w = torch.randn((e, d, f), generator=g, device=dev) / d ** 0.5
    buf, be, _ = ops.sort_tokens_by_expert(x.to(dtype), ids, e, bt)
    return buf, w.to(dtype), be


def _check_card(got, want, dtype):
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=5e-5, rtol=5e-5)
    else:
        _assert_ulps(got.float().cpu(), want.float().cpu(), 1, atol=1e-4)


CARD_CASES = [  # t, d, f, e, bt
    (100, 200, 328, 5, 16),      # D and F ragged against every tile
    (300, 64, 128, 8, 32),
    (700, 96, 200, 4, 64),
    (1000, 256, 520, 3, 128),
    (4, 6144, 4096, 8, 16),      # a decode step at grok-1's width (F cut)
    # the wgmma route (bt 64 and 128): F off the 256-column tile, D off the
    # 64-deep K tile, expert 1 empty, trailing -1 blocks
    (1000, 200, 328, 5, 128),
    (600, 200, 200, 4, 64),
    (2000, 512, 776, 6, 128),
    (900, 1024, 264, 3, 64),
]


def _want_route(dtype, bt):
    if dtype == torch.float32:
        return "f32"
    return "wgmma" if bt % 64 == 0 else "mma_sync"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("t,d,f,e,bt", CARD_CASES)
def test_kernel_matches_plain_on_card(cuda, t, d, f, e, bt, dtype):
    buf, w, be = _routed(t, d, f, e, bt, dtype, cuda)
    assert (be == -1).any() or buf.shape[0] == ops.padded_rows(t, e, bt)
    before = ops.launches
    by_route = dict(ops.launches_by_route)
    got = ops.gmm(buf, w, be, bt=bt)
    watchdog.synchronize()
    assert ops.launches == before + 1
    route = _want_route(dtype, bt)
    assert ops.launches_by_route == {**by_route, route: by_route[route] + 1}
    want = ops.reference(buf, w, be, bt)
    _check_card(got, want, dtype)
    pad = (be.repeat_interleave(bt) < 0)
    assert torch.count_nonzero(got[pad]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_kernel_reads_strided_views_on_card(cuda, dtype):
    """x rows of a wider buffer, w a column slice of wider experts."""
    buf, w, be = _routed(200, 64, 136, 4, 16, dtype, cuda, seed=10)
    wide_x = torch.zeros((buf.shape[0], 96), dtype=dtype, device=cuda)
    wide_x[:, 16:80] = buf
    wide_w = torch.zeros((4, 64, 200), dtype=dtype, device=cuda)
    wide_w[:, :, 8:144] = w
    got = ops.gmm(wide_x[:, 16:80], wide_w[:, :, 8:144], be, bt=16)
    want = ops.gmm(buf, w, be, bt=16)
    watchdog.synchronize()
    assert torch.equal(got, want)
    _check_card(got, ops.reference(buf, w, be, 16), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("bt", [64, 128])
def test_wgmma_reads_strided_views_on_card(cuda, bt):
    """The wgmma route's tensor maps over x rows of a wider buffer and w a
    column slice of wider experts, with trailing -1 blocks."""
    buf, w, be = _routed(700, 192, 264, 4, bt, torch.bfloat16, cuda,
                         seed=11)
    assert (be == -1).any()
    wide_x = torch.zeros((buf.shape[0], 256), dtype=buf.dtype, device=cuda)
    wide_x[:, 32:224] = buf
    wide_w = torch.zeros((4, 192, 400), dtype=w.dtype, device=cuda)
    wide_w[:, :, 64:328] = w
    before = ops.launches_by_route["wgmma"]
    got = ops.gmm(wide_x[:, 32:224], wide_w[:, :, 64:328], be, bt=bt)
    want = ops.gmm(buf, w, be, bt=bt)
    watchdog.synchronize()
    assert ops.launches_by_route["wgmma"] == before + 2
    assert torch.equal(got, want)
    _check_card(got, ops.reference(buf, w, be, bt), torch.bfloat16)
    pad = (be.repeat_interleave(bt) < 0)
    assert torch.count_nonzero(got[pad]) == 0


@pytest.mark.cuda
def test_moe_layer_kernel_matches_plain_on_card(cuda):
    """The sorted route through the kernel against the same route's plain
    version and the dense oracle, on an arctic smoke layer in float32."""
    _, cfg, _, p, _, tx = _layer("arctic-480b", "float32", s=33)
    p = bridge.tree_map(lambda t: t.to(cuda), p)
    x = tx.to(cuda)
    before = ops.launches
    with torch.no_grad():
        a, _ = moe.apply_moe(p, x, cfg, impl="pallas")
        watchdog.synchronize()
        assert ops.launches == before + 3
        b, _ = moe.apply_moe(p, x, cfg, impl="interpret")
        c, _ = moe.apply_moe(p, x, cfg, impl="gshard")
    assert ops.launches == before + 3
    _assert_f32(a.cpu(), b.cpu())
    _assert_f32(a.cpu(), c.cpu())


@pytest.mark.cuda
def test_kernel_raises_instead_of_falling_back_on_card(cuda):
    x = torch.zeros(32, 16, device=cuda, dtype=torch.float16)
    w = torch.zeros(2, 16, 16, device=cuda, dtype=torch.float16)
    be = torch.zeros(2, device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        ops.gmm(x, w, be, bt=16)
    lib = ops._library()
    strides = (ctypes.c_longlong * 4)(*([0] * 4))
    # bt not a multiple of 16 reaches the C side as cudaErrorInvalidValue
    assert lib.repro_gmm(0, 0, 0, 0, 0, strides, 32, 16, 16, 2, 8, 0) != 0
