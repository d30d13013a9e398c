"""The trace's reduction and the per-layer readers, on a made-up trace
with hand-counted answers."""
import json

import pytest

from portbench import harness, trace
from portbench.tests.smokebench import PB, REPO
from portbench.work import gmm, model, peaks, ssd


def _reader(name):
    return harness.Bench(REPO).reader(name)


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _x("pb.stretch", "user_annotation", 1000, 1000),
    _x("pb.request", "user_annotation", 1000, 600),
    _x("pb.prefill", "user_annotation", 1010, 500),
    _x("pb.prompt_gen", "user_annotation", 1550, 40),
    _x("pb.request", "user_annotation", 1600, 400),
    _x("pb.prefill", "user_annotation", 1600, 390),
    _x("void gmm_wgmma_kernel<128>(CUtensorMap)", "kernel", 1100, 300),
    _x("sm90_xmma_gemm_bf16", "kernel", 1350, 100),     # overlaps gmm
    _x("Memcpy HtoD", "gpu_memcpy", 1020, 10),
    _x("void ssd_scan_kernel<bf16>(Params)", "kernel", 1700, 200),
    _x("gpu side of a range", "gpu_user_annotation", 1000, 1000),
    _x("aten::mm", "cpu_op", 1100, 5),
    _x("before the stretch", "kernel", 500, 100),
]


def test_busy_idle_and_gaps_by_host_range():
    t = trace.reduce_events(EVENTS)
    assert t.window_s == pytest.approx(1e-3)
    # busy: 1020-1030, 1100-1450, 1700-1900 -> 560 us
    assert t.busy_s == pytest.approx(560e-6)
    assert t.idle_share == pytest.approx(0.44)
    # gaps: 1000-1020 and 1030-1100 under the first pb.prefill,
    # 1450-1700 (its middle, 1575, under pb.prompt_gen), 1900-2000 under
    # the second pb.prefill
    gaps = dict(t.breakdown()["idle_gaps"])
    assert gaps["pb.prefill"] == pytest.approx(190e-6)
    assert gaps["pb.prompt_gen"] == pytest.approx(250e-6)
    assert sum(gaps.values()) == pytest.approx(440e-6)
    ops = dict(t.breakdown()["device_ops"])
    assert ops["void gmm_wgmma_kernel<128>(CUtensorMap)"] == \
        pytest.approx(300e-6)
    assert "before the stretch" not in ops
    assert t.kernel_seconds(r"\bgmm_(wgmma|mma|f32)_kernel") == \
        pytest.approx(300e-6)
    assert t.kernel_seconds(r"\bssd_scan_kernel") == pytest.approx(200e-6)


def test_a_trace_without_its_stretch_or_device_work_is_refused():
    with pytest.raises(ValueError):
        trace.reduce_events(EVENTS[1:])
    with pytest.raises(ValueError):
        trace.reduce_events([EVENTS[0]])


def _ctx(cfg_name, kind, reqs, chunks=()):
    cfg = json.loads((PB / "configs" / f"{cfg_name}.json").read_text())
    return harness.Context(cfg, {"kind": kind}, 1.0, 2.0, list(reqs),
                           list(chunks), trace.reduce_events(EVENTS))


def test_rooflines_and_mfu_from_the_stretch_by_hand():
    reqs = [{"rows": 1, "prompt_len": 1000, "stretch": True},
            {"rows": 1, "prompt_len": 3000, "stretch": False}]
    ctx = _ctx("grok-1-314b-4L", "prefill", reqs)
    least = 3 * 4 * gmm.least_seconds(2000, 6144, 32768, 8)
    assert _reader("gmm_roofline")(ctx) == pytest.approx(
        100 * least / 300e-6)
    assert _reader("mfu.prefill")(ctx) == pytest.approx(
        100 * model.prefill_flops(ctx.cfg, 1, 1000) /
        (1e-3 * peaks.BF16_FLOPS))
    assert _reader("idle_share.prefill")(ctx) == pytest.approx(44.0)
    assert _reader("idle_share.decode")(ctx) is None
    ctx = _ctx("mamba2-1.3b", "prefill", reqs)
    assert _reader("ssd_roofline")(ctx) == pytest.approx(
        100 * 48 * ssd.least_seconds(1, 1000, 64, 64, 1, 128) / 200e-6)


def test_decode_mfu_from_the_stretch_s_chunks():
    chunks = [{"t0": 0, "t1": 1, "steps": 32, "rows": 64, "pos": 1024,
               "stretch": True},
              {"t0": 1, "t1": 2, "steps": 32, "rows": 64, "pos": 1056,
               "stretch": False}]
    ctx = _ctx("mamba2-1.3b", "decode", [], chunks)
    assert _reader("mfu.decode")(ctx) == pytest.approx(
        100 * 32 * model.decode_step_least_seconds(ctx.cfg, 64, 1024) /
        1e-3)
    # attention reads more of its cache at every step
    ctx = _ctx("grok-1-314b-4L", "decode", [], chunks)
    steps = sum(model.decode_step_least_seconds(ctx.cfg, 64, 1024 + j)
                for j in range(32))
    assert _reader("mfu.decode")(ctx) == pytest.approx(100 * steps / 1e-3)
    assert steps > 32 * model.decode_step_least_seconds(ctx.cfg, 64, 1024)


def test_readers_find_nothing_without_a_trace_or_kernels():
    reqs = [{"rows": 1, "prompt_len": 1000, "stretch": True}]
    ctx = _ctx("mamba2-1.3b", "prefill", reqs)
    assert _reader("gmm_roofline")(
        harness.Context(ctx.cfg, ctx.traffic, 1, 1, reqs, [], None)) is None
    t = trace.reduce_events([e for e in EVENTS if "ssd" not in e["name"]])
    no_ssd = harness.Context(ctx.cfg, ctx.traffic, 1, 1, reqs, [], t)
    assert _reader("ssd_roofline")(no_ssd) is None
