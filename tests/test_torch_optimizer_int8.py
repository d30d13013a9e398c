"""Port parity: AdamW's int8 blockwise moments against the JAX package.

``repro_torch.train.optimizer`` against ``repro.train.optimizer`` on the
same numpy inputs: the signed absmax codes of the first moment bit for
bit, the log-space codes of the second moment within one code where the
two frameworks' ``log2`` round differently, the zero state of
``init_opt_state`` leaf for leaf, five ``apply_updates`` steps, the
slabbed update equal to the whole-leaf one, and int8 moments tracking
float32 ones as JAX's own test holds them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch import bridge
from repro_torch.train import optimizer as opt

# leading dims kept out of the blocks (3-d and 4-d), ragged last blocks,
# a 0-d leaf, a vector
SHAPES = [(3, 300), (2, 5, 70), (1, 6, 4, 16), (600, 13), (7,), ()]


def _x(shape, seed, scale=1e-3):
    rng = np.random.default_rng(seed)
    return np.asarray(rng.standard_normal(shape), np.float32) * \
        np.float32(scale)


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ulps(a, b) -> np.ndarray:
    """Distance in float32 ulps (same-sign finite values)."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_q8_encode_matches_jax_bit_for_bit(shape):
    """The same float32 division by 127 and round-half-even: ``q`` and
    ``scale`` bit for bit, and the decode too (one multiply)."""
    x = _x(shape, 1)
    j = _np(jopt._q8_encode(jnp.asarray(x)))
    t = opt._q8_encode(_t(x))
    np.testing.assert_array_equal(t["q"].numpy(), j["q"])
    np.testing.assert_array_equal(t["scale"].numpy().view(np.int32),
                                  j["scale"].view(np.int32))
    np.testing.assert_array_equal(
        opt._q8_decode(t, shape).numpy().view(np.int32),
        np.asarray(jopt._q8_decode(jax.tree.map(jnp.asarray, j), shape))
        .view(np.int32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_q8v_encode_matches_jax_within_one_code(shape):
    """log2 is rounded by each framework's own routine: a code may differ
    by 1 where log2(v) lands on a rounding boundary (share stated below:
    none on these inputs), ``lo`` within 1 ulp, and ``rng`` = max - lo
    within one ulp of each of the two log2 values it is the difference
    of."""
    v = _x(shape, 2, scale=1.0) ** 2 * np.float32(1e-6)
    j = _np(jopt._q8v_encode(jnp.asarray(v)))
    t = opt._q8v_encode(_t(v))
    dq = np.abs(t["q"].numpy().astype(np.int32) - j["q"].astype(np.int32))
    assert dq.max() <= 1
    assert (dq > 0).mean() == 0.0  # share of codes that differ
    assert _ulps(t["lo"].numpy(), j["lo"]).max() <= 1
    ends = np.spacing(np.abs(j["lo"])) + \
        np.spacing(np.abs(j["lo"] + j["rng"]))
    assert (np.abs(t["rng"].numpy() - j["rng"]) <= ends).all()
    jd = np.asarray(jopt._q8v_decode(jax.tree.map(jnp.asarray, j), shape))
    td = opt._q8v_decode({k: _t(a) for k, a in j.items()}, shape).numpy()
    np.testing.assert_allclose(td, jd, rtol=2e-6, atol=0)


def _params(seed=3):
    return {"w": _x((2, 5, 300), seed, 1.0), "e": _x((40, 30), seed + 1, 1.0),
            "b": _x((7,), seed + 2, 1.0), "s": _x((), seed + 3, 1.0)}


def test_init_opt_state_int8_matches_jax():
    """The zero state: JAX's tree, leaf for leaf, bit for bit (the port
    encodes one block of zeros and fills it in)."""
    p = _params()
    j = bridge.tree_leaves(_np(jopt.init_opt_state(
        jax.tree.map(jnp.asarray, p), jopt.AdamWConfig(moments_dtype="int8"))))
    t = bridge.tree_leaves(opt.init_opt_state(
        bridge.tree_map(_t, p), opt.AdamWConfig(moments_dtype="int8")))
    assert [k for k, _ in t] == [k for k, _ in j]
    for (path, a), (_, b) in zip(j, t):
        assert tuple(b.shape) == a.shape, path
        np.testing.assert_array_equal(bridge.to_numpy(b), a, err_msg=path)


def _run(params, grads, cfg_j, cfg_t):
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_opt_state(jp, cfg_j)
    tp = bridge.tree_map(_t, params)
    ts = opt.init_opt_state(tp, cfg_t)
    for g in grads:
        jp, js, jn = jopt.apply_updates(jp, jax.tree.map(jnp.asarray, g),
                                        js, cfg_j)
        tp, ts, tn = opt.apply_updates(tp, bridge.tree_map(_t, g), ts, cfg_t)
    return _np(jp), _np(js), float(jn), tp, ts, float(tn)


def test_apply_updates_int8_matches_jax_over_five_steps():
    """Five steps with int8 moments from the same parameters and
    gradients: parameters within 1e-6 absolute (a few float32 ulps of
    the update: the decoded second moments pass through each framework's
    exp2 and log2), first-moment codes equal, second-moment codes within
    one code."""
    p = _params()
    grads = [{k: _x(a.shape, 20 + i, 1.0) for k, a in p.items()}
             for i in range(5)]
    kw = dict(lr=1e-2, warmup=1, moments_dtype="int8")
    jp, js, jn, tp, ts, tn = _run(p, grads, jopt.AdamWConfig(**kw),
                                  opt.AdamWConfig(**kw))
    assert tn == pytest.approx(jn, rel=1e-6)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), jp[k], rtol=0, atol=1e-6,
                                   err_msg=k)
        tm, jm = ts["moments"][k], js["moments"][k]
        np.testing.assert_array_equal(tm["m"]["q"].numpy(), jm["m"]["q"])
        dq = np.abs(tm["v"]["q"].numpy().astype(np.int32) -
                    jm["v"]["q"].astype(np.int32))
        assert dq.max() <= 1, k
    assert int(ts["step"]) == int(js["step"]) == 5


def test_int8_update_in_slabs_equals_the_whole_leaf(monkeypatch):
    """A leaf larger than the slab is updated a run of whole blocks at a
    time; the codes and parameters equal those of one whole-leaf pass."""
    p = _params()
    g = {k: _x(a.shape, 40, 1.0) for k, a in p.items()}
    cfg = opt.AdamWConfig(lr=1e-2, warmup=1, moments_dtype="int8")
    outs = []
    for slab in (1 << 27, 300):
        monkeypatch.setattr(opt, "_SLAB", slab)
        tp = bridge.tree_map(_t, p)
        newp, st, _ = opt.apply_updates(tp, bridge.tree_map(_t, g),
                                        opt.init_opt_state(tp, cfg), cfg)
        outs.append({"params": newp, "opt": st})
    for (path, a), (_, b) in zip(bridge.tree_leaves(outs[0]),
                                 bridge.tree_leaves(outs[1])):
        assert torch.equal(a, b), path


def test_int8_moments_track_float32():
    """The counterpart of tests/test_train.py::
    test_int8_moments_track_float32 on the port: after five steps the
    int8-moment parameters stay within 15% of the float32-moment ones'
    movement, and the port's int8 run equals JAX's within 1e-6."""
    p = {"w": np.random.RandomState(0).randn(512).astype(np.float32)}
    grads = [{"w": np.random.RandomState(i + 10).randn(512)
              .astype(np.float32)} for i in range(5)]
    kw = dict(lr=1e-2, warmup=1, clip_norm=0.0)
    out = {}
    for dt in ("int8", "float32"):
        jp, _, _, tp, _, _ = _run(p, grads,
                                  jopt.AdamWConfig(moments_dtype=dt, **kw),
                                  opt.AdamWConfig(moments_dtype=dt, **kw))
        np.testing.assert_allclose(tp["w"].numpy(), jp["w"], rtol=0,
                                   atol=1e-6)
        out[dt] = tp["w"].numpy()
    diff = np.abs(out["int8"] - out["float32"]).max()
    scale = np.abs(out["float32"] - p["w"]).max()
    assert diff < 0.15 * scale, (diff, scale)
