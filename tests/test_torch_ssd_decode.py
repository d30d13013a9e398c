"""The SSD decode-step kernel's wrapper (``kernels/ssd_decode``).

On the CPU the wrapper takes the plain version (``ref.py``, the model's
``ssd_decode_step``) and writes its new state in place, as the kernel
does on the card; these tests hold it to that version exactly, check what
the wrapper refuses (once per layout) and its ``meta`` route, and hold a
mamba2 smoke decode through it to JAX's. The tests marked ``cuda`` hold
the Hopper kernel to the plain version on the card and skip without one. This file imports JAX only inside the
one CPU test that compares with it, so the card tests collect without it.
"""
import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.kernels import watchdog
from repro_torch.kernels.ssd_decode import ops
from repro_torch.launch import op_analysis
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, h, p, g, n, dtype, device="cpu", seed=4, d_dtype=None):
    """The decode step's arguments as ``apply_ssd`` passes them: x, B and
    C slices of one conv output [B, 1, H P + 2 G N] (strided views), dt
    [B, H] a slice of [B, 1, H], a float32 state of scale 1, a in
    -exp(0.3 randn), dt softplus(randn), d_skip in ``d_dtype``."""
    rng = np.random.default_rng(seed)
    conv = torch.from_numpy(rng.standard_normal(
        (b, 1, h * p + 2 * g * n)).astype(np.float32) * 0.5)
    conv = conv.to(device=device, dtype=DTYPES[dtype])
    x = conv[..., :h * p].reshape(b, 1, h, p)[:, 0]
    bb = conv[..., h * p:h * p + g * n].reshape(b, 1, g, n)[:, 0]
    cc = conv[..., h * p + g * n:].reshape(b, 1, g, n)[:, 0]
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal(
        (b, 1, h)))).astype(np.float32)).to(device)[:, 0]
    a = torch.from_numpy(-np.exp(rng.standard_normal(h) * 0.3).astype(
        np.float32)).to(device)
    st = torch.from_numpy(rng.standard_normal((b, h, p, n)).astype(
        np.float32)).to(device)
    d_skip = torch.from_numpy(rng.standard_normal(h).astype(np.float32))
    d_skip = d_skip.to(device=device, dtype=DTYPES[d_dtype or dtype])
    return st, x, dt, a, bb, cc, d_skip


# b, h, p, g, n: mamba2-smoke (one group), two groups, mamba2's P and N
CPU_SHAPES = [(2, 16, 8, 1, 16), (3, 8, 16, 2, 32), (2, 4, 64, 2, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,p,g,n", CPU_SHAPES)
def test_cpu_route_is_the_plain_step(b, h, p, g, n, dtype):
    args = _inputs(b, h, p, g, n, dtype)
    assert not args[1].is_contiguous() and not args[4].is_contiguous()
    want_y, want_h = S.ssd_decode_step(*args)  # out of place
    ptr, before = args[0].data_ptr(), ops.launches
    y, h_new = ops.ssd_decode_step(*args)
    assert torch.equal(y, want_y) and torch.equal(h_new, want_h)
    assert y.dtype == DTYPES[dtype] and h_new.dtype == torch.float32
    # in place, as on the card: the caller's state is the new state
    assert h_new is args[0] and args[0].data_ptr() == ptr
    assert ops.launches == before


@pytest.mark.parametrize("impl", ["pallas", "interpret"])
def test_apply_ssd_decode_aliasing_is_the_same_on_every_device(impl):
    """``apply_ssd``'s decode with ``pallas`` writes ``state['h']`` in
    place and returns it on the CPU as on the card; ``interpret`` leaves
    the state as it was and returns a new ``h``, equal to the kernel
    route's."""
    cfg = registry.get_smoke_config("mamba2-1.3b")
    rt = T.ModelRuntime(tp=1, ssd_impl=impl, max_seq=8)
    gen = torch.Generator().manual_seed(2)
    params = T.init_params(cfg, rt, gen, device="cpu")
    lp = bridge.tree_map(lambda t: t[0], params["group0"]["p0"]["mixer"])
    d_inner, nh, p, g, n = S.ssm_dims(cfg)
    dtype = lp["wx"].dtype
    xin = torch.randn((2, 1, cfg.d_model), generator=gen).to(dtype)
    state = {"h": torch.randn((2, nh, p, n), generator=gen),
             "conv": torch.randn((2, cfg.ssm.conv_width - 1,
                                  d_inner + 2 * g * n),
                                 generator=gen).to(dtype)}
    before = state["h"].clone()
    with torch.no_grad():
        want_y, want = S.apply_ssd(lp, xin, cfg, {
            k: v.clone() for k, v in state.items()}, "interpret")
        y, new = S.apply_ssd(lp, xin, cfg, state, impl)
    assert torch.equal(y, want_y) and torch.equal(new["h"], want["h"])
    assert (new["h"] is state["h"]) == (impl == "pallas")
    if impl == "interpret":
        assert torch.equal(state["h"], before)


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, device="meta", dtype=dtype)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    h, x, dt, a = _meta(2, 4, 16, 32), _meta(2, 4, 16), _meta(2, 4), \
        _meta(4)
    b, d = _meta(2, 2, 32), _meta(4)
    ops._check(h, x, dt, a, b, b, d)
    # a CPU state beside meta inputs: neither the plain version nor a route
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.ssd_decode_step(torch.zeros(2, 4, 16, 32), x, dt, a, b, b, d)
    with pytest.raises(ValueError, match=r"h \[B,H,P,N\]"):
        ops._check(_meta(2, 4, 16), x, dt, a, b, b, d)
    with pytest.raises(ValueError, match="mismatch"):
        ops._check(h, _meta(3, 4, 16), dt, a, b, b, d)
    with pytest.raises(ValueError, match="mismatch"):
        ops._check(h, x, dt, a, _meta(2, 2, 16), _meta(2, 2, 16), d)
    with pytest.raises(ValueError, match="group"):
        ops._check(h, x, dt, a, _meta(2, 3, 32), _meta(2, 3, 32), d)
    with pytest.raises(ValueError, match="head_dim"):
        ops._check(_meta(2, 4, 32, 32), _meta(2, 4, 32), dt, a, b, b, d)
    with pytest.raises(ValueError, match="d_state"):
        ops._check(_meta(2, 4, 16, 64), x, dt, a, _meta(2, 2, 64),
                   _meta(2, 2, 64), d)
    with pytest.raises(TypeError, match="alike"):
        ops._check(h, x, dt, a, b.to(torch.bfloat16), b, d)
    with pytest.raises(TypeError, match="alike"):
        ops._check(h, x.half(), dt, a, b.half(), b.half(), d)
    with pytest.raises(TypeError, match="float32"):
        ops._check(h.to(torch.bfloat16), x, dt, a, b, b, d)
    with pytest.raises(TypeError, match="float32"):
        ops._check(h, x, dt.to(torch.bfloat16), a, b, b, d)
    with pytest.raises(ValueError, match="devices"):
        ops._check(h, x, dt, torch.zeros(4), b, b, d)
    with pytest.raises(ValueError, match="stride"):
        ops._check(h, _meta(2, 16, 4).transpose(1, 2), dt, a, b, b, d)
    # the state's rows of N must be contiguous (float4 loads and stores)
    with pytest.raises(ValueError, match="rows"):
        ops._check(_meta(2, 16, 4, 32).permute(0, 2, 1, 3), x, dt, a, b,
                   b, d)
    with pytest.raises(ValueError, match="rows"):
        ops._check(_meta(2, 4, 16, 33)[..., :32], x, dt, a, b, b, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_meta_route_checks_and_reports_its_work(dtype):
    """The dry run's route: a checked call that launches nothing, returns
    an empty y and the state itself, and reports the kernel's work."""
    b, h, p, g, n = 4, 8, 64, 2, 128
    dt_ = DTYPES[dtype]
    st, x, dt, a = _meta(b, h, p, n), _meta(b, h, p, dtype=dt_), \
        _meta(b, h), _meta(h)
    bb, d = _meta(b, g, n, dtype=dt_), _meta(h)
    before = ops.launches
    (y, h_new), res = op_analysis.analyze(
        lambda: ops.ssd_decode_step(st, x, dt, a, bb, bb, d))
    assert ops.launches == before
    assert y.device.type == "meta" and tuple(y.shape) == (b, h, p)
    assert y.dtype == dt_ and h_new is st
    item = 2 if dtype == "bfloat16" else 4
    flops, nbytes = ops.work(b, h, p, g, n, item)
    assert res["kernels"]["ssd_decode"] == {"calls": 1, "flops": flops,
                                            "bytes": nbytes}
    assert flops == 5.0 * b * h * p * n
    assert nbytes == 8 * b * h * p * n + (2 * b * h * p + 2 * b * g * n) * \
        item + 4 * (b * h + 2 * h)
    with pytest.raises(ValueError, match="head_dim"):
        ops.ssd_decode_step(_meta(b, h, 32, n), _meta(b, h, 32), dt, a,
                            bb.float(), bb.float(), d)


def test_checks_run_once_per_layout(monkeypatch):
    """A second call with the same layout reuses the checked plan; a new
    layout is checked again, and a bad one still raises."""
    seen = []
    check = ops._check
    monkeypatch.setattr(ops, "_check", lambda *t: (seen.append(
        tuple(t[0].shape)), check(*t)))
    monkeypatch.setattr(ops, "_PLANS", {})
    b, h, p, g, n = 2, 4, 16, 2, 32
    args = (_meta(b, h, p, n), _meta(b, h, p), _meta(b, h), _meta(h),
            _meta(b, g, n), _meta(b, g, n), _meta(h))
    for _ in range(3):
        ops.ssd_decode_step(*args)
    assert seen == [(b, h, p, n)]
    ops.ssd_decode_step(_meta(b + 1, h, p, n), _meta(b + 1, h, p),
                        _meta(b + 1, h), *args[3:4], _meta(b + 1, g, n),
                        _meta(b + 1, g, n), args[6])
    assert seen == [(b, h, p, n), (b + 1, h, p, n)]
    with pytest.raises(ValueError, match="mismatch"):
        ops.ssd_decode_step(args[0], _meta(b, h, p + 1), *args[2:])
    assert len(ops._PLANS) == 2


def test_smoke_decode_through_the_kernel_route_matches_jax():
    """mamba2's smoke config, prefill and three decode steps with
    ``ssd_impl="pallas"`` (the kernel's route, its plain version on the
    CPU) against JAX's, in float32; the cache's states equal those of the
    port's plain route (``interpret``) exactly."""
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as jregistry
    from repro.models import transformer as jT
    jax.config.update("jax_platform_name", "cpu")

    arch, s, steps, b = "mamba2-1.3b", 32, 3, 2
    jcfg = jregistry.get_smoke_config(arch)
    cfg = registry.get_smoke_config(arch)
    jrt = jT.ModelRuntime(tp=1, attn_impl="interpret", ssd_impl="interpret",
                          max_seq=s + steps, remat=False)
    jparams, _ = jT.init_params(jax.random.PRNGKey(0), jcfg, jrt)
    jparams = jax.tree.map(lambda t: t.astype(jnp.float32), jparams)
    params = bridge.params_from_host(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (b, s + steps)).astype(np.int32)

    jlog, jcache = jT.prefill(jparams, jcfg, jrt, jnp.asarray(tokens[:, :s]))
    caches = {}
    for impl in ("pallas", "interpret"):
        rt = T.ModelRuntime(tp=1, attn_impl="pallas", ssd_impl=impl,
                            max_seq=s + steps)
        with torch.no_grad():
            _, cache = T.prefill(params, cfg, rt,
                                 torch.from_numpy(tokens[:, :s]))
            for i in range(steps):
                log, cache = T.decode_step(
                    params, cfg, rt, cache,
                    torch.from_numpy(tokens[:, s + i]), s + i)
                if impl == "pallas":
                    jlog, jcache = jT.decode_step(
                        jparams, jcfg, jrt, jcache,
                        jnp.asarray(tokens[:, s + i]), jnp.int32(s + i))
                    # float32: summation order and libm (test_torch_models)
                    np.testing.assert_allclose(
                        log.numpy(), np.asarray(jlog, np.float32),
                        atol=2e-5, rtol=2e-5, err_msg=f"step {i}")
        caches[impl] = cache
    jleaves = bridge.tree_leaves(jax.tree.map(np.asarray, jcache))
    leaves = bridge.tree_leaves(caches["pallas"])
    plain = dict(bridge.tree_leaves(caches["interpret"]))
    assert [p for p, _ in jleaves] == [p for p, _ in leaves]
    for (path, ja), (_, t) in zip(jleaves, leaves):
        np.testing.assert_allclose(t.float().numpy(), np.asarray(
            ja, np.float32), atol=2e-5, rtol=2e-5, err_msg=path)
        assert torch.equal(t, plain[path]), path


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value's magnitude (8 significant bits)."""
    m = v.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


CARD_SHAPES = [
    (256, 64, 64, 1, 128),   # mamba2-1.3b's decode cell
    (64, 32, 64, 1, 128),    # a rank's block of the heads (dense layout)
    (4, 16, 8, 1, 16),       # mamba2-smoke
    (3, 8, 16, 2, 32),       # two groups
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,p,g,n", CARD_SHAPES)
def test_kernel_matches_plain_on_card(cuda, b, h, p, g, n, dtype):
    """The new state bit-identical to the plain route's (the same
    roundings, in the same order, and the same expf); y within the
    read-out's reordered float32 sum: one ulp of the sum rounded to x's
    dtype plus one of the skip's add in bf16, a float32 reordering bound
    (128 terms, 2**-17 of their absolute sum) in float32."""
    # d_skip as the model holds it (the parameters' dtype), and float32
    # beside bf16 x at the smoke shape (rounded to bf16 in the kernel)
    d_dtype = "float32" if p == 8 else dtype
    args = _inputs(b, h, p, g, n, dtype, cuda, seed=11, d_dtype=d_dtype)
    st = args[0]
    want_y, want_h = S.ssd_decode_step(st.clone(), *args[1:])
    g_rep = h // g
    read = (want_h.to(args[1].dtype).float() * torch.repeat_interleave(
        args[5], g_rep, dim=1).float()[:, :, None, :])
    ptr, before = st.data_ptr(), ops.launches
    y, h_new = ops.ssd_decode_step(*args)
    watchdog.synchronize()
    assert ops.launches == before + 1
    assert h_new is st and st.data_ptr() == ptr
    assert torch.equal(h_new, want_h)
    assert y.dtype == args[1].dtype and y.shape == (b, h, p)
    diff = (y.float() - want_y.float()).abs()
    if dtype == "bfloat16":
        tol = _bf16_ulp(read.sum(-1)) + _bf16_ulp(want_y)
    else:
        tol = read.abs().sum(-1) * 2.0 ** -17 + 1e-30
    assert bool((diff <= tol).all()), float((diff - tol).max())


@pytest.mark.cuda
def test_kernel_refuses_a_misaligned_state_on_card(cuda):
    """h one float32 off a 16-byte boundary: the layout was checked on an
    aligned state, and the call with the same layout still raises."""
    args = _inputs(2, 4, 16, 1, 32, "float32", cuda)
    ops.ssd_decode_step(*args)
    flat = torch.zeros(args[0].numel() + 1, device=cuda)
    h = flat[1:].view(args[0].shape)
    assert h.stride() == args[0].stride()
    before = ops.launches
    with pytest.raises(ValueError, match="aligned"):
        ops.ssd_decode_step(h, *args[1:])
    assert ops.launches == before


@pytest.mark.cuda
def test_decode_step_writes_the_cache_in_place_on_card(cuda):
    """mamba2-smoke on the card: one ``decode_step`` through the kernel
    route launches the kernel once per SSD layer, leaves the layers'
    states in the cache's own storage, and equals the plain route's new
    state exactly (one step from the same prefilled cache: both read the
    same state and inputs)."""
    cfg = registry.get_smoke_config("mamba2-1.3b")
    n_ssd = sum(1 for i in range(cfg.n_layers)
                if cfg.pattern[i % len(cfg.pattern)].mixer == "ssd")
    assert n_ssd == 2
    gen = torch.Generator(device=cuda).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (4, 17), device=cuda,
                           generator=gen)
    rts = {impl: T.ModelRuntime(tp=1, attn_impl="pallas", ssd_impl=impl,
                                max_seq=32)
           for impl in ("pallas", "interpret")}
    params = T.init_params(cfg, rts["pallas"], torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    with torch.no_grad():
        _, prefilled = T.prefill(params, cfg, rts["pallas"], tokens[:, :16])
    states = {}
    for impl, rt in rts.items():
        cache = bridge.tree_map(torch.clone, prefilled)
        h = _state(cache)  # the stacked [layers, B, H, P, N] leaf
        ptr, before = h.data_ptr(), ops.launches
        with torch.no_grad():
            _, cache = T.decode_step(params, cfg, rt, cache, tokens[:, 16],
                                     16)
        watchdog.synchronize()
        assert _state(cache) is h and h.data_ptr() == ptr
        assert h.shape[0] == n_ssd
        assert ops.launches - before == (n_ssd if impl == "pallas" else 0)
        states[impl] = h
    assert not torch.equal(states["pallas"], _state(prefilled))
    assert torch.equal(states["pallas"], states["interpret"])


def _state(cache):
    (h,) = [t for path, t in bridge.tree_leaves(cache) if path.endswith("/h")]
    return h
