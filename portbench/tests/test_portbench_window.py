"""Window arithmetic: exact percentiles and rates, the window's close,
and a stall inside the window moving the rate and the tail."""
import time

import numpy as np
import pytest

from portbench import check, harness, loadgen, window
from portbench.tests.smokebench import PREFILL, REPO


def _reader(name):
    return harness.Bench(REPO).reader(name)


def test_nearest_rank_percentiles():
    xs = list(range(1, 101))
    assert window.percentile(xs, 95) == 95
    assert window.percentile(xs, 50) == 50
    assert window.percentile([3.0], 95) == 3.0
    assert window.percentile([5, 1, 4, 2, 3], 95) == 5
    assert window.percentile([5, 1, 4, 2, 3], 50) == 3
    with pytest.raises(ValueError):
        window.percentile([], 50)


def test_rate_counts_the_whole_window():
    assert window.rate([100, 300], 2.0) == 200.0
    with pytest.raises(ValueError):
        window.rate([1], 0.0)


class FakeEngine:
    """Prefill takes ``per_token`` seconds a token; every ``every``-th
    request takes ``stall`` seconds more."""

    def __init__(self, per_token, every=0, stall=0.0):
        self.per_token, self.every, self.stall = per_token, every, stall
        self.n, self.cache = 0, {"x": np.zeros(1)}

    def prefill(self, tokens):
        delay = tokens.shape[1] * self.per_token
        if self.every and self.n % self.every == self.every - 1:
            delay += self.stall
        self.n += 1
        time.sleep(delay)
        return np.zeros(tokens.shape[0], np.int32)


def _window(engine, seconds=0.6):
    gen = loadgen.Traffic(PREFILL, 4, 100)
    sampler = check.Sampler(1, 4, 1)
    sampler._hold = lambda i, p, s, c: {"i": i, "prompt": p}
    reqs, _, t0, t1 = harness.Bench.loop("prefill").run(
        engine, gen, seconds, sampler, None, False)
    ctx = harness.Context({}, PREFILL, 0.0, t1 - t0, reqs, [], None)
    return reqs, t0, t1, ctx


def test_the_window_closes_with_the_request_that_crosses_its_end():
    reqs, t0, t1, _ = _window(FakeEngine(2e-4))
    assert reqs[-1]["t_first"] >= t0 + 0.6
    assert all(r["t_first"] < t0 + 0.6 for r in reqs[:-1])
    assert t1 == reqs[-1]["t_done"]


def test_a_stall_moves_the_rate_and_the_tail():
    _, _, _, calm = _window(FakeEngine(2e-4))
    _, _, _, stalled = _window(FakeEngine(2e-4, every=5, stall=0.05),
                               seconds=1.0)
    rate, p95 = _reader("prompt_tokens_per_s"), _reader("ttft_p95_s")
    assert rate(stalled) < 0.8 * rate(calm)
    assert p95(stalled) >= 0.05
    assert p95(calm) < 0.03
    assert _reader("ttft_p50_s")(stalled) < 0.03


def test_decode_readers_count_every_chunk():
    chunks = [{"t0": 0.0, "t1": 0.3, "steps": 32, "rows": 64,
               "stretch": False},
              {"t0": 0.3, "t1": 0.9, "steps": 32, "rows": 64,
               "stretch": False}]
    reqs = [{"rows": 64, "prompt_len": 1024, "tokens_out": 64 * 65,
             "t_issue": 0.0, "t_first": 0.1, "t_done": 0.9,
             "stretch": False}]
    ctx = harness.Context({}, {"kind": "decode"}, 1.0, 2.0, reqs, chunks,
                          None)
    assert _reader("decode_step_ms")(ctx) == pytest.approx(900 / 64)
    assert _reader("output_tokens_per_s")(ctx) == pytest.approx(64 * 65 /
                                                                2.0)
    assert _reader("ttft_p95_s")(ctx) is None
    assert _reader("mfu.decode")(ctx) is None
