"""The traffic generator repeats by seed and deals the same work to
every seed."""
import json
import math
import statistics

import numpy as np
import pytest

from portbench import loadgen
from portbench.tests.smokebench import PB

MIXES = sorted(p.stem for p in (PB / "traffic").glob("*.json"))


def _mix(name):
    return json.loads((PB / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("mix", MIXES)
def test_a_seed_repeats_its_requests(mix):
    a = loadgen.Traffic(_mix(mix), 2 ** 31 + 11, 1000)
    b = loadgen.Traffic(_mix(mix), 2 ** 31 + 11, 1000)
    for i in (0, 1, 63, 64, 200):
        assert np.array_equal(a.prompt(i), b.prompt(i))
    c = loadgen.Traffic(_mix(mix), 5, 1000)
    assert not np.array_equal(a.prompt(3), c.prompt(3))


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_gets_the_same_lengths_in_another_order(mix):
    spec = _mix(mix)
    m = len(loadgen.Traffic(spec, 0, 10).levels)
    rounds = []
    for seed in (1, 2, 2 ** 33 + 1):
        g = loadgen.Traffic(spec, seed, 10)
        rounds.append([g.length(i) for i in range(2 * m)])
        assert sorted(rounds[-1][:m]) == g.levels
        assert sorted(rounds[-1][m:]) == g.levels
    if m > 1:
        assert rounds[0] != rounds[1]


def test_each_block_holds_one_length_of_every_band():
    spec = _mix("prefill_loguniform_512_8192")
    g = loadgen.Traffic(spec, 9, 10)
    k = spec["prompt_len"]["strata"]
    bands = [set(g.levels[j * 64 // k:(j + 1) * 64 // k]) for j in range(k)]
    for blk in range(16):
        got = [g.length(blk * k + j) for j in range(k)]
        assert all(sum(x in band for x in got) == 1 for band in bands)


@pytest.mark.parametrize("mix,mean,p95", [
    ("prefill_loguniform_512_8192", (8192 - 512) / math.log(16), 7134),
    ("prefill_loguniform_1024_16384", (16384 - 1024) / math.log(16),
     14268)])
def test_log_uniform_levels_have_the_law_s_mean_and_tail(mix, mean, p95):
    g = loadgen.Traffic(_mix(mix), 0, 10)
    assert abs(statistics.mean(g.levels) - mean) / mean < 0.01
    assert abs(statistics.quantiles(g.levels, n=20)[-1] - p95) / p95 < 0.03


def test_ids_lie_in_the_vocabulary_and_shapes_follow_the_mix():
    spec = _mix("decode_b256_p1024_g128")
    g = loadgen.Traffic(spec, 3, 50277)
    p = g.prompt(0)
    assert p.shape == (256, 1024) and p.dtype == np.int32
    assert p.min() >= 0 and p.max() < 50277
    assert g.warmup_lengths() == [1024]


def test_a_mix_of_a_kind_with_no_loop_is_refused():
    from portbench import harness
    assert harness.Bench.loop("prefill").run
    with pytest.raises(ModuleNotFoundError):
        harness.Bench.loop("open_poisson")
