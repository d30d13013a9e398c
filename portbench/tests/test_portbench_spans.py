"""The stretch split by the program's spans (``portbench/spans.py``), on a
made-up trace with hand-counted answers: program spans inside
``pb.prefill`` take the gaps under way inside them, and nothing else of
the reduction moves."""
import pytest

from portbench import spans, trace
from portbench.tests.test_portbench_trace import EVENTS, _x

# the first request of test_portbench_trace's trace (pb.prefill at
# 1010-1510) with the program's spans inside, on the same clock:
#   serve.prefill 1010-1505
#     model.step 1012-1470
#       model.embed 1012-1018
#       model.mixer.attn_global 1040-1090 (no device work in it)
#       model.mlp.moe 1090-1460
#         moe.sort 1092-1099
#     sync.wait 1470-1505
# and in the second (pb.prefill at 1600-1990): serve.prefill 1600-1985,
# sync.wait 1900-1985
PROGRAM = [
    _x("serve.prefill", "user_annotation", 1010, 495),
    _x("model.step", "user_annotation", 1012, 458),
    _x("model.embed", "user_annotation", 1012, 6),
    _x("model.mixer.attn_global", "user_annotation", 1040, 50),
    _x("model.mlp.moe", "user_annotation", 1090, 370),
    _x("moe.sort", "user_annotation", 1092, 7),
    _x("sync.wait", "user_annotation", 1470, 35),
    _x("serve.prefill", "user_annotation", 1600, 385),
    _x("sync.wait", "user_annotation", 1900, 85),
    _x("another.namespace", "user_annotation", 1000, 1000),
]


def test_device_time_and_idle_share_read_as_the_harness_s():
    old = trace.reduce_events(EVENTS + PROGRAM)
    new = spans.reduce_events(EVENTS + PROGRAM)
    assert new.window_s == old.window_s
    assert new.busy_s == old.busy_s
    assert new.idle_share == old.idle_share
    assert new.ops == old.ops
    assert new.breakdown()["device_ops"] == old.breakdown()["device_ops"]
    for rx in (r"\bgmm_(wgmma|mma|f32)_kernel", r"\bssd_scan_kernel"):
        assert new.kernel_seconds(rx) == old.kernel_seconds(rx)
    # the harness's own reduction ignores the program's ranges
    assert old.idle_by_label == trace.reduce_events(EVENTS).idle_by_label


def test_gaps_take_the_innermost_program_span_by_hand():
    t = spans.reduce_events(EVENTS + PROGRAM)
    gaps = t.idle_by_label
    # 1000-1020 (middle 1010: serve.prefill starts there, the innermost
    # range under way); 1030-1100 (middle 1065, in the mixer); 1450-1700
    # (middle 1575: pb.prompt_gen, outside the program); 1900-2000
    # (middle 1950: sync.wait of the second request)
    assert gaps == pytest.approx({"serve.prefill": 20e-6,
                                  "model.mixer.attn_global": 70e-6,
                                  "pb.prompt_gen": 250e-6,
                                  "sync.wait": 100e-6})
    assert "another.namespace" not in gaps
    assert t.program_ranges == 9
    assert spans.idle_in(t, ("sync.",)) == pytest.approx(100e-6)
    assert spans.idle_in(t, ("model.", "moe.")) == pytest.approx(70e-6)
    split = spans.split(t, "prefill")
    # over the stretch of 1000 us
    assert split == pytest.approx({"idle_in_sync.prefill": 10.0,
                                   "idle_in_dispatch.prefill": 7.0})
    assert sum(split.values()) <= 100 * t.idle_share
    # the harness put 190 us under pb.prefill; all of it is named now
    old = trace.reduce_events(EVENTS + PROGRAM)
    assert spans.named_share(old, t) == pytest.approx(1.0)


def test_a_gap_in_a_request_outside_the_program_keeps_the_harness_label():
    # without the first request's serve.prefill and its children, its
    # gaps stay under pb.prefill
    t = spans.reduce_events(EVENTS + PROGRAM[7:])
    old = trace.reduce_events(EVENTS)
    assert t.idle_by_label["pb.prefill"] == pytest.approx(90e-6)
    assert spans.named_share(old, t) == pytest.approx(100 / 190)


def test_a_program_without_spans_reads_nothing():
    t = spans.reduce_events(EVENTS, ())
    assert t.idle_by_label == trace.reduce_events(EVENTS).idle_by_label
    assert spans.split(t, "decode") == {"idle_in_sync.decode": None,
                                        "idle_in_dispatch.decode": None}
    assert spans.idle_in_percent(None, ("sync.",)) is None
    assert spans.idle_in_percent(trace.reduce_events(EVENTS),
                                 ("sync.",)) is None
    # the names default to the program's own
    from repro_torch.obs.spans import NAMESPACES
    assert spans.namespaces() == NAMESPACES
    full = spans.reduce_events(EVENTS + PROGRAM)
    assert full.program_ranges == 9


def _call(name, cat, ts, dur, tid=1):
    return dict(_x(name, cat, ts, dur), tid=tid)


def test_gaps_by_span_and_host_call_by_hand():
    calls = [
        # a blocking copy in the mixer: the runtime's wait inside the op
        _call("aten::copy_", "cpu_op", 1035, 60),
        _call("cudaStreamSynchronize", "cuda_runtime", 1050, 30),
        _call("aten::add", "cpu_op", 1031, 3),
        # the poll's sleep runs no operator; each thread's innermost range
        # under way is a candidate, and the shortest names the gap
        _call("aten::zeros", "cpu_op", 1930, 40, tid=2),
        _call("aten::empty", "cpu_op", 1000, 1000, tid=2),
    ]
    got = spans.idle_by_call(EVENTS + PROGRAM + calls)
    assert got == pytest.approx({
        "serve.prefill | aten::empty": 20e-6,
        "model.mixer.attn_global | cudaStreamSynchronize": 70e-6,
        "pb.prompt_gen | aten::empty": 250e-6,
        "sync.wait | aten::zeros": 100e-6})
    assert sum(got.values()) == pytest.approx(
        (1 - trace.reduce_events(EVENTS).busy_s / 1e-3) * 1e-3)
    # without host calls every gap keeps its span, with no call
    bare = spans.idle_by_call(EVENTS + PROGRAM)
    assert bare == pytest.approx({"serve.prefill | -": 20e-6,
                                  "model.mixer.attn_global | -": 70e-6,
                                  "pb.prompt_gen | -": 250e-6,
                                  "sync.wait | -": 100e-6})
