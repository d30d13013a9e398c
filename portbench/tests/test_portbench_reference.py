"""The plain reference against the port's plain routes, the control, and
runs of the harness with the timed path broken underneath (CPU, smoke
widths)."""
import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.tests import smokebench


@pytest.fixture(scope="module")
def f32_bench(tmp_path_factory):
    return harness.Bench(smokebench.make(tmp_path_factory.mktemp("f32")))


@pytest.fixture(scope="module")
def bf16_bench(tmp_path_factory):
    return harness.Bench(smokebench.make(tmp_path_factory.mktemp("bf16"),
                                         dtype="bfloat16"))


def _run(bench, cell, seed=7, **kw):
    return harness.run_cell(bench, cell, seed, 0.3, False, device="cpu",
                            log=lambda s: None, **kw)


@pytest.mark.parametrize("cell", list(smokebench.CELLS))
def test_reference_matches_the_port_in_float32(f32_bench, cell):
    """float32 weights: the port's plain routes (flash, gmm and SSD's
    plain versions on the CPU) give what the reference gives, up to
    summation order, in the served tokens and in the held state."""
    out = _run(f32_bench, cell)
    r = out["readings"]
    assert r["state_err"] < 1e-5, r
    assert r["token_gap"] == 0.0, r
    assert r.get("kpos_mismatch", 0) == 0
    assert out["result"]["correct"]


@pytest.mark.parametrize("cell", list(smokebench.CELLS))
def test_the_control_reads_far_above_the_program(bf16_bench, cell):
    """The program in bf16 against the control (the reference with
    float8 e4m3 weights in its place) on the same seed: the control's
    state errors are several times the program's. Its token gap is read
    at the served positions only, as the program's is: one a request in
    a prefill mix, where it may well be 0."""
    prog = _run(bf16_bench, cell, seed=3)["readings"]
    ctl = _run(bf16_bench, cell, seed=3, control=True)["readings"]
    assert ctl["state_err"] > 3 * prog["state_err"], (prog, ctl)
    assert ctl["state_err_p90"] > 3 * prog["state_err_p90"], (prog, ctl)
    if cell == "m.dec":
        assert ctl["token_gap"] > 0, ctl


def _alter_tokens(engine):
    """A token altered where it is produced."""
    prefill, decode = engine.prefill, engine.decode

    def bad_prefill(tokens, **kw):
        return (prefill(tokens, **kw) + 1) % engine.cfg.padded_vocab

    def bad_decode(first, steps):
        out = decode(first, steps)
        out[:, -1] = (out[:, -1] + 1) % engine.cfg.padded_vocab
        return out
    engine.prefill, engine.decode = bad_prefill, bad_decode


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _stale_prefill(engine):
    """A step that returns its state unchanged: prefill leaves the
    fresh, empty state."""
    from repro_torch.models import transformer as tfm
    prefill = engine.prefill

    def bad(tokens, **kw):
        out = prefill(tokens, **kw)
        engine.cache = tfm.init_cache(engine.cfg, engine.rt,
                                      tokens.shape[0], device="cpu",
                                      dtype=engine.cache_dtype)
        return out
    engine.cache_dtype = next(iter(engine.params.values())).dtype
    engine.prefill = bad


def _stale_decode(engine):
    """A step that returns its state unchanged: a decode chunk leaves the
    state it found."""
    decode = engine.decode

    def bad(first, steps):
        before = _clone(engine.cache)
        out = decode(first, steps)
        engine.cache = before
        return out
    engine.decode = bad


def _half_batch(engine):
    """Half of the batch left out: the second half of the rows gets the
    first half's state and tokens."""
    prefill = engine.prefill

    def bad_prefill(tokens, **kw):
        half = tokens.shape[0] // 2
        out = prefill(tokens[:half], **kw)
        engine.cache = {g: {p: {k: {n: torch.cat([t, t], 1)
                                    for n, t in leaf.items()}
                                for k, leaf in sub.items()}
                            for p, sub in grp.items()}
                        for g, grp in engine.cache.items()}
        return np.concatenate([out, out])
    engine.prefill = bad_prefill


@pytest.mark.parametrize("cell,fault", [
    ("g.pre", _alter_tokens), ("m.pre", _alter_tokens),
    ("m.dec", _alter_tokens), ("g.pre", _stale_prefill),
    ("m.pre", _stale_prefill), ("m.dec", _stale_decode),
    ("m.dec", _half_batch)])
def test_a_broken_timed_path_is_not_correct(f32_bench, cell, fault):
    """The whole run but the look for a card, with the timed path broken
    underneath: ``correct`` comes out false. (The cells run on one chip,
    so no exchange between chips can be left out.)"""
    out = _run(f32_bench, cell, engine_hook=fault)
    assert not out["result"]["correct"], out["readings"]


def _minority_positions(engine):
    """A fault at a fifth of the positions: the first layer's K at the
    last fifth of the written slots scaled by 1.5."""
    prefill = engine.prefill

    def bad(tokens, **kw):
        out = prefill(tokens, **kw)
        s = tokens.shape[1]
        engine.cache["group0"]["p0"]["self"]["k"][:, :, s - s // 5:s] *= 1.5
        return out
    engine.prefill = bad


def _minority_rows(engine):
    """A fault in one row of four: its recurrent state scaled by 1.5 after
    each decode chunk."""
    decode = engine.decode

    def bad(first, steps):
        out = decode(first, steps)
        engine.cache["group0"]["p0"]["self"]["h"][:, 0] *= 1.5
        return out
    engine.decode = bad


@pytest.mark.parametrize("cell,fault", [("g.pre", _minority_positions),
                                        ("m.dec", _minority_rows)])
def test_a_fault_at_a_minority_shows_in_the_p90(f32_bench, cell, fault):
    """The median over positions and rows misses a fault at a minority
    of them; the 90th percentile does not."""
    out = _run(f32_bench, cell, engine_hook=fault)
    r, lim = out["readings"], smokebench.F32_LIMITS
    assert r["state_err"] <= lim["state_err"]["limit"], r
    assert r["state_err_p90"] > 100 * lim["state_err_p90"]["limit"], r
    assert not out["result"]["correct"]


def test_fp8_weights_round_each_column_on_its_scale():
    w = torch.tensor([[1.0, 100.0], [0.5, -300.0], [0.26, 7.0]])
    q = check.fp8_weights(w)
    assert torch.equal(q.abs().amax(0), w.abs().amax(0))
    assert float((q - w).abs().max()) > 0      # 0.26 and 7 are not on it
    rel = ((q - w).abs() / w.abs()).max()
    assert float(rel) <= 2 ** -4               # e4m3: 3 mantissa bits


def test_the_sampler_keeps_the_longest_and_repeats_by_seed():
    def picks(seed):
        s = check.Sampler(2, seed, batch=1)
        for i, n in enumerate([5, 9, 3, 12, 4, 7, 12, 6]):
            s.offer(i, np.zeros((1, n), np.int32), np.zeros((1, 1),
                                                            np.int32),
                    {"x": torch.zeros(1, 1)})
        return [x["i"] for x in s.samples()]
    assert picks(1) == picks(1)
    assert 3 in picks(1) and 3 in picks(2)   # the first 12-token prompt
    assert len(picks(1)) <= 3
