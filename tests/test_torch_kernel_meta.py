"""The scan and gmm wrappers' ``meta`` routes and analysis hooks.

A ``meta`` call of ``ssd``, ``rglru`` or ``gmm`` (the dry run's trace)
checks its inputs as a CUDA call does, returns empty ``meta`` outputs of
the kernel's shapes and dtypes and launches nothing; under
``launch/op_analysis`` it reports one call with its ``work``'s FLOPs and
bytes (the formulas ``chip_smoke.py``'s bounds use), as the flash
wrapper's does (``tests/test_torch_dryrun.py``). ``sort_tokens_by_expert``
and the sorted MoE FFN run on ``meta`` too: the buffer's size is static.
No JAX here: these are the port's own routes.
"""
import pytest
import torch

from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.rglru import ops as rg_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import op_analysis


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 3000, 2048), (3, 37, 100)])
def test_rglru_meta_route_reports_its_work(shape):
    """Shapes and dtype of h, no launch, one call of ``work``'s numbers:
    5 operations an element and three float32 arrays moved once."""
    b, s, w = shape
    log_a, gated = _meta(*shape), _meta(*shape)
    before = rg_ops.launches
    h, res = op_analysis.analyze(lambda: rg_ops.rglru(log_a, gated))
    assert h.device.type == "meta" and tuple(h.shape) == shape
    assert h.dtype == torch.float32 and rg_ops.launches == before
    assert res["kernels"] == {"rglru": {"calls": 1,
                                        "flops": 5.0 * b * s * w,
                                        "bytes": 12.0 * b * s * w}}
    assert res["flops_by_tag"].get("ssm") == 5.0 * b * s * w
    # outside an analysis: nothing reported, nothing launched
    rg_ops.rglru(log_a, gated)
    assert rg_ops.launches == before


@pytest.mark.parametrize("bad,err", [
    (lambda a: (a, a[:, :, :8]), ValueError),          # shapes differ
    (lambda a: (a.bfloat16(), a.bfloat16()), TypeError),  # not float32
    (lambda a: (a.transpose(1, 2), a.transpose(1, 2)), ValueError),  # stride
])
def test_rglru_meta_route_checks_as_cuda(bad, err):
    with pytest.raises(err):
        rg_ops.rglru(*bad(_meta(2, 16, 16)))


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [(2, 4000, 32, 64, 1, 128, torch.bfloat16),
                                  (1, 77, 16, 8, 1, 16, torch.float32)])
def test_ssd_meta_route_reports_its_work(case):
    """y in x's dtype and the float32 end state, no launch, one call of
    ``work``'s numbers: 4 P N operations a token and head; x, y, B, C,
    dt, a and the state moved once."""
    b, s, h, p, g, n, dtype = case
    x, bb = _meta(b, s, h, p, dtype=dtype), _meta(b, s, g, n, dtype=dtype)
    dt, a = _meta(b, s, h), _meta(h)
    before = ssd_ops.launches
    (y, st), res = op_analysis.analyze(lambda: ssd_ops.ssd(x, dt, a, bb,
                                                           bb))
    assert y.device.type == "meta" and tuple(y.shape) == (b, s, h, p)
    assert y.dtype == dtype and st.dtype == torch.float32
    assert tuple(st.shape) == (b, h, p, n) and ssd_ops.launches == before
    item = torch.tensor([], dtype=dtype).element_size()
    want_bytes = (2 * b * s * h * p + 2 * b * s * g * n) * item + \
        4 * (b * s * h + h + b * h * p * n)
    assert res["kernels"] == {"ssd": {"calls": 1,
                                      "flops": 4.0 * b * s * h * p * n,
                                      "bytes": float(want_bytes)}}
    assert ssd_ops.work(b, s, h, p, g, n, item) == (
        4.0 * b * s * h * p * n, float(want_bytes))


@pytest.mark.parametrize("bad,match", [
    ({"p": 12}, "head_dim"),          # no kernel for P = 12
    ({"n": 24}, "d_state"),           # nor for N = 24
    ({"g": 3}, "groups"),             # 16 heads over 3 groups
    ({"bdtype": torch.float32}, "dtypes"),  # x bf16, B and C float32
])
def test_ssd_meta_route_checks_as_cuda(bad, match):
    b, s, h = 1, 32, 16
    p, n, g = bad.get("p", 8), bad.get("n", 16), bad.get("g", 1)
    x = _meta(b, s, h, p, dtype=torch.bfloat16)
    bb = _meta(b, s, g, n, dtype=bad.get("bdtype", torch.bfloat16))
    with pytest.raises((ValueError, TypeError), match=match):
        ssd_ops.ssd(x, _meta(b, s, h), _meta(h), bb, bb)


# ---------------------------------------------------------------------------
# gmm and the sorted MoE FFN
# ---------------------------------------------------------------------------

def test_sort_tokens_by_expert_runs_on_meta():
    """Every op of the sort has a meta kernel and a static output size:
    the buffer is ``padded_rows(T, E, bt)`` rows, ``block_expert`` one
    int32 a block."""
    t, d, e, bt = 100, 64, 8, 16
    buf, be, (order, slots) = gmm_ops.sort_tokens_by_expert(
        _meta(t, d, dtype=torch.bfloat16), _meta(t, dtype=torch.long), e, bt)
    rows = gmm_ops.padded_rows(t, e, bt)
    assert buf.device.type == "meta" and tuple(buf.shape) == (rows, d)
    assert tuple(be.shape) == (rows // bt,) and be.dtype == torch.int32
    assert tuple(order.shape) == (t,) and tuple(slots.shape) == (t,)


@pytest.mark.parametrize("dtype,bt,route", [(torch.bfloat16, 128, "wgmma"),
                                            (torch.bfloat16, 16, "mma_sync"),
                                            (torch.float32, 64, "f32")])
def test_gmm_meta_route_reports_its_work(dtype, bt, route):
    """The sorted FFN of 100 routed rows on meta: three gmm calls, none
    launched, each reporting 2 D F operations a routed row and the rows'
    and every expert's weights' bytes (an upper bound), from shapes only;
    the output is [T, D] in x's dtype."""
    t, d, f, e = 100, 64, 128, 8
    x = _meta(t, d, dtype=dtype)
    ids = _meta(t, dtype=torch.long)
    wi, wo = _meta(e, d, f, dtype=dtype), _meta(e, f, d, dtype=dtype)
    before = (gmm_ops.launches, dict(gmm_ops.launches_by_route))
    assert gmm_ops.gmm_route(x, wi, bt) == route
    y, res = op_analysis.analyze(lambda: gmm_ops.moe_ffn_sorted(
        x, ids, wi, wi, wo, n_experts=e, bt=bt))
    assert y.device.type == "meta" and tuple(y.shape) == (t, d)
    assert y.dtype == dtype
    assert (gmm_ops.launches, gmm_ops.launches_by_route) == before
    item = x.element_size()
    up = gmm_ops.work(t, d, f, e, item)
    down = gmm_ops.work(t, f, d, e, item)
    assert up == (2.0 * t * d * f, float((t * d + t * f + e * d * f) * item))
    assert res["kernels"] == {"gmm": {"calls": 3,
                                      "flops": 2 * up[0] + down[0],
                                      "bytes": 2 * up[1] + down[1]}}


def test_gmm_meta_route_checks_as_cuda():
    """The CUDA route's refusals hold on meta: bt not a multiple of 16,
    ``block_expert`` of the wrong length or dtype, mixed dtypes."""
    x = _meta(64, 32, dtype=torch.bfloat16)
    w = _meta(4, 32, 48, dtype=torch.bfloat16)
    be = _meta(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="bt"):
        gmm_ops.gmm(x, w, be, bt=24)
    with pytest.raises(ValueError, match="block_expert"):
        gmm_ops.gmm(x, w, _meta(3, dtype=torch.int32), bt=16)
    with pytest.raises(ValueError, match="block_expert"):
        gmm_ops.gmm(x, w, _meta(4, dtype=torch.long), bt=16)
    with pytest.raises(TypeError, match="dtypes"):
        gmm_ops.gmm(x, w.float(), be, bt=16)
    out = gmm_ops.gmm(x, w, be, bt=16)  # a sound call: an empty output
    assert out.device.type == "meta" and tuple(out.shape) == (64, 48)


@pytest.mark.parametrize("kernel", ["rglru", "ssd", "gmm"])
def test_cpu_calls_report_no_kernel(kernel):
    """A CPU call runs the plain version, whose ops the analysis sees
    directly: no kernel is reported and the ops' FLOPs are counted."""
    g = torch.Generator().manual_seed(0)
    if kernel == "rglru":
        a = -torch.rand(1, 8, 16, generator=g)
        fn = lambda: rg_ops.rglru(a, torch.randn(1, 8, 16, generator=g))
    elif kernel == "ssd":
        x = torch.randn(1, 8, 2, 8, generator=g)
        bb = torch.randn(1, 8, 1, 16, generator=g)
        fn = lambda: ssd_ops.ssd(x, torch.rand(1, 8, 2, generator=g),
                                 -torch.rand(2, generator=g), bb, bb)
    else:
        x = torch.randn(16, 8, generator=g)
        w = torch.randn(2, 8, 8, generator=g)
        fn = lambda: gmm_ops.gmm(x, w, torch.zeros(1, dtype=torch.int32),
                                 bt=16)
    _, res = op_analysis.analyze(fn)
    assert res["kernels"] == {}
