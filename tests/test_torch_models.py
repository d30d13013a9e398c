"""Port parity: repro_torch.models against repro.models on the CPU.

Inputs come from a numpy seed; parameters are the JAX package's
``init_params`` carried over through the bridge. JAX runs its Pallas
kernels (flash attention, RG-LRU, SSD) in interpret mode, the port its
kernel wrappers, which on a CPU tensor take the plain versions.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import layers as jlayers
from repro.models import transformer as jT
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.models import layers
from repro_torch.models import transformer as T

jax.config.update("jax_platform_name", "cpu")

S = 24        # prompt; longer than gemma2-smoke's window of 16: ring roll
# JAX's RG-LRU and SSD Pallas kernels assert S % block == 0 and
# S % chunk == 0 (recurrentgemma-smoke's block 8, mamba2-smoke's chunk 16);
# 32 is also longer than recurrentgemma-smoke's window of 16
PROMPT = {"recurrentgemma-9b": 32, "mamba2-1.3b": 32}
RAGGED_S = 21  # for the scans that take any length (impl "jnp")
B = 2
MAX_SEQ = 32
DECODE_STEPS = 3
# (atol, rtol). float32 checks the algorithm: the two sides differ only in
# summation order and libm; measured ~3e-6 on logits of magnitude ~3.5.
# bfloat16 checks rounding: XLA and torch round bf16 intermediates at
# different places, one bf16 ulp is 0.0156 at the logits' magnitude, and
# the differences compound over two layers and the LM head; measured
# <= 0.04, held to 0.08 (about five ulps).
TOLS = {"float32": (2e-5, 2e-5), "bfloat16": (0.08, 0.0)}
# recurrentgemma's gelu gate and conv round differently again (one bf16
# ulp per block output); measured <= 0.082 on logits of ~3.6, held to 0.16
BF16_ATOL = {"recurrentgemma-9b": 0.16}
ARCHS = ["gemma2-9b", "qwen2-72b", "recurrentgemma-9b", "mamba2-1.3b",
         "grok-1-314b", "arctic-480b"]


def _np(x):
    return np.asarray(x, np.float32)


def test_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, 4, 16)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    for theta in (10_000.0, 1_000_000.0):
        want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        # float32 sin/cos of angles up to 23 rad: a few ulp of the angle
        np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("gemma_scale", [True, False])
def test_rms_norm_matches_jax(gemma_scale):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    w = (rng.standard_normal(64) * 0.1).astype(np.float32)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w),
                            gemma_scale=gemma_scale)
    got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                          gemma_scale=gemma_scale)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["geglu", "swiglu"])
def test_mlp_matches_jax(kind):
    """jax.nn.gelu is the tanh approximation; F.gelu(approximate='tanh')."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    p = {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for n, s in (("w1", (64, 128)), ("w3", (64, 128)),
                      ("w2", (128, 64)))}
    want = jlayers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), kind)
    got = layers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), kind)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)


def test_softcap_matches_jax():
    x = np.linspace(-200, 200, 1001).astype(np.float32)
    for cap in (30.0, 50.0, 0.0):
        want = jlayers.softcap(jnp.asarray(x), cap)
        got = layers.softcap(torch.from_numpy(x), cap)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5,
                                   rtol=1e-6)


def _setup(arch, dtype, s=S, scan_impl=("interpret", "pallas"),
           steps=DECODE_STEPS):
    """JAX and port models from one JAX init, in ``dtype`` (bf16 leaves
    stay bf16 and the recurrences' float32 leaves float32 unless the
    whole tree is cast to float32). ``scan_impl``: the JAX and the port
    ``rglru_impl``/``ssd_impl``; tokens for a prompt of ``s`` and
    ``steps`` decode steps."""
    jcfg = jregistry.get_smoke_config(arch)
    cfg = registry.get_smoke_config(arch)
    jrt = jT.ModelRuntime(tp=1, attn_impl="interpret",
                          rglru_impl=scan_impl[0], ssd_impl=scan_impl[0],
                          max_seq=MAX_SEQ, remat=False)
    rt = T.ModelRuntime(tp=1, attn_impl="pallas", rglru_impl=scan_impl[1],
                        ssd_impl=scan_impl[1], max_seq=MAX_SEQ)
    jparams, _ = jT.init_params(jax.random.PRNGKey(0), jcfg, jrt)
    if dtype == jnp.float32:
        jparams = jax.tree.map(lambda a: a.astype(dtype), jparams)
    params = bridge.params_from_host(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (B, s + steps)) \
        .astype(np.int32)
    return jcfg, jrt, jparams, cfg, rt, params, tokens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_logits_match_jax(arch, dtype):
    _check_prefill_decode(arch, dtype, PROMPT.get(arch, S))


@pytest.mark.parametrize("arch,prompt,steps,scan_impl", [
    ("gemma2-9b", 1, 20, ("interpret", "pallas")),
    ("gemma2-9b", 12, 12, ("interpret", "pallas")),
    ("gemma2-9b", 16, 8, ("interpret", "pallas")),
    ("recurrentgemma-9b", 8, 16, ("interpret", "pallas")),
    # JAX's RG-LRU kernel takes whole blocks of 8: its associative scan
    ("recurrentgemma-9b", 5, 16, ("jnp", "jnp"))])
def test_decode_across_the_window_matches_jax(arch, prompt, steps,
                                              scan_impl):
    """float32, prompts shorter than the window of 16 (gemma2-smoke's
    local layers, recurrentgemma-smoke's local attention), decoded until
    the ring crosses the window boundary (gemma2's prompt 16 fills it
    exactly): every logit and the final caches against JAX's."""
    _check_prefill_decode(arch, "float32", prompt, scan_impl, steps)


@pytest.mark.parametrize("arch", ["gemma2-9b", "grok-1-314b",
                                  "arctic-480b"])
def test_forward_returns_aux_as_jax(arch):
    """``forward`` returns (hidden, caches, aux) as JAX's does: aux is the
    MoE load-balance loss summed over the layers (float32; 0 without MoE
    layers; the recurrent families have none either), hidden as
    before."""
    jcfg, jrt, jparams, cfg, rt, params, tokens = _setup(arch, jnp.float32,
                                                         S)
    jh, jc, jaux = jT.forward(jparams, jcfg, jrt, jnp.asarray(tokens[:, :S]))
    with torch.no_grad():
        h, c, aux = T.forward(params, cfg, rt, torch.from_numpy(tokens[:, :S]))
    assert c is None and jc is None
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(h.numpy(), _np(jh), atol=2e-5, rtol=2e-5)
    if cfg.moe is None:
        assert aux.item() == float(jaux) == 0.0
    else:
        assert aux.item() > 0
        # the same routing; the probabilities' means sum in another order
        np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-1.3b"])
def test_ragged_prompt_scans_match_jax(arch, dtype):
    """A prompt ragged against every block and chunk, through the
    scans both packages run at any length: JAX's associative scan and
    ``ssd_chunked`` against the port's doubling scan and ``ssd_chunked``
    (the kernels' plain versions are held at this length by the card
    tests and chip_smoke.py)."""
    _check_prefill_decode(arch, dtype, RAGGED_S, scan_impl=("jnp", "jnp"))


def _check_prefill_decode(arch, dtype, S, scan_impl=("interpret", "pallas"),
                          steps=DECODE_STEPS):
    """Prefill, then ``steps`` decode steps: logits and caches of the
    port against JAX's. Three steps catch a decode that reads stale
    state (the port writes recurrent state into the stacked cache in
    place)."""
    jdtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    atol, rtol = TOLS[dtype]
    if dtype == "bfloat16":
        atol = BF16_ATOL.get(arch, atol)
    jcfg, jrt, jparams, cfg, rt, params, tokens = _setup(arch, jdtype, S,
                                                         scan_impl, steps)

    jlog, jcache = jT.prefill(jparams, jcfg, jrt, jnp.asarray(tokens[:, :S]))
    with torch.no_grad():
        log, cache = T.prefill(params, cfg, rt,
                               torch.from_numpy(tokens[:, :S]))
    np.testing.assert_allclose(log.numpy(), _np(jlog), atol=atol, rtol=rtol)

    # the cache tree is the JAX one: same paths, shapes, dtypes, and the
    # ring layout puts every position in the same slot
    jleaves = bridge.tree_leaves(jax.tree.map(np.asarray, jcache))
    leaves = bridge.tree_leaves(cache)
    assert [p for p, _ in jleaves] == [p for p, _ in leaves]
    for (path, ja), (_, t) in zip(jleaves, leaves):
        assert tuple(ja.shape) == tuple(t.shape), path
        assert ja.dtype.name == str(t.dtype).replace("torch.", ""), path
        if path.endswith("kpos"):
            np.testing.assert_array_equal(t.numpy(), ja, err_msg=path)
        else:
            np.testing.assert_allclose(t.float().numpy(), _np(ja),
                                       atol=atol, rtol=rtol, err_msg=path)

    for step in range(steps):
        pos = S + step
        jlog, jcache = jT.decode_step(jparams, jcfg, jrt, jcache,
                                      jnp.asarray(tokens[:, pos]),
                                      jnp.int32(pos))
        with torch.no_grad():
            log, cache = T.decode_step(params, cfg, rt, cache,
                                       torch.from_numpy(tokens[:, pos]),
                                       pos)
        np.testing.assert_allclose(log.numpy(), _np(jlog), atol=atol,
                                   rtol=rtol, err_msg=f"decode step {step}")
    # the decode steps wrote the state that JAX returned
    jleaves = bridge.tree_leaves(jax.tree.map(np.asarray, jcache))
    for (path, ja), (_, t) in zip(jleaves, bridge.tree_leaves(cache)):
        if path.endswith("kpos"):
            np.testing.assert_array_equal(t.numpy(), ja, err_msg=path)
        else:
            np.testing.assert_allclose(t.float().numpy(), _np(ja),
                                       atol=atol, rtol=rtol, err_msg=path)


def _deterministic(path: str) -> bool:
    """Leaves that both inits fill with constants: norm weights and
    biases, the RG-LRU conv bias and the SSD skip."""
    name = path.split("/")[-1]
    return "norm" in path or name in ("b1", "b2", "bq", "bk", "bv", "bo",
                                      "conv_b", "d_skip") or \
        name.endswith("_bias") and name != "dt_bias"


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax(arch):
    """The port's own init builds the JAX tree: names, shapes, dtypes
    (bfloat16, and float32 for the recurrences' decay parameters), and
    the deterministic leaves (norm weights, biases) exactly."""
    jcfg = jregistry.get_smoke_config(arch)
    cfg = registry.get_smoke_config(arch)
    jrt = jT.ModelRuntime(tp=1, attn_impl="naive", max_seq=MAX_SEQ,
                          remat=False)
    rt = T.ModelRuntime(tp=1, attn_impl="naive", max_seq=MAX_SEQ)
    jparams, _ = jT.init_params(jax.random.PRNGKey(0), jcfg, jrt)
    params = T.init_params(cfg, rt, torch.Generator().manual_seed(0),
                           device="cpu")
    jleaves = bridge.tree_leaves(jax.tree.map(np.asarray, jparams))
    leaves = bridge.tree_leaves(params)
    assert [p for p, _ in jleaves] == [p for p, _ in leaves]
    for (path, ja), (_, t) in zip(jleaves, leaves):
        assert tuple(ja.shape) == tuple(t.shape), path
        assert str(t.dtype) == f"torch.{ja.dtype.name}", path
        assert t.dtype in (torch.bfloat16, torch.float32), path
        if _deterministic(path):
            np.testing.assert_array_equal(bridge.to_numpy(t),
                                          bridge.to_numpy(ja), err_msg=path)
    assert cfg.param_count() == jcfg.param_count()


def _decay_ranges(tree):
    """What the recurrences' inits promise, from either package's tree:
    RG-LRU a = exp(-8 softplus(lam)) in [0.9, 0.999]; SSD A = exp(a_log)
    in [1, 16]; dt = softplus(dt_bias) in [1e-3, 0.1]."""
    out = {}
    for path, a in bridge.tree_leaves(tree):
        v = np.asarray(a, np.float64)
        name = path.split("/")[-1]
        if name == "lam":
            out[name] = np.exp(-8.0 * np.logaddexp(v, 0.0))
        elif name == "a_log":
            out[name] = np.exp(v)
        elif name == "dt_bias":
            out[name] = np.logaddexp(v, 0.0)
    return out


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-1.3b"])
def test_init_decay_parameters_match_jax_ranges(arch):
    jcfg = jregistry.get_smoke_config(arch)
    cfg = registry.get_smoke_config(arch)
    jparams, _ = jT.init_params(jax.random.PRNGKey(0), jcfg,
                                jT.ModelRuntime(max_seq=MAX_SEQ,
                                                remat=False))
    params = T.init_params(cfg, T.ModelRuntime(max_seq=MAX_SEQ),
                           torch.Generator().manual_seed(0), device="cpu")
    bounds = {"lam": (0.9, 0.999), "a_log": (1.0, 16.0),
              "dt_bias": (1e-3, 0.1)}
    mine = _decay_ranges(bridge.params_to_host(params))
    ref = _decay_ranges(jax.tree.map(np.asarray, jparams))
    assert sorted(mine) == sorted(ref) and mine
    for name, vals in list(mine.items()) + list(ref.items()):
        lo, hi = bounds[name]
        assert lo * (1 - 1e-5) <= vals.min() and \
            vals.max() <= hi * (1 + 1e-5), name


@pytest.mark.parametrize("init", ["normal", "fan_in"])
def test_normal_leaves_are_drawn_slab_by_slab(monkeypatch, init):
    """Every normal leaf goes through one slab loop: a leaf within a slab
    gets the numbers of one draw of its shape, a larger one its slabs'
    draws in order, no element skipped or drawn twice, scaled as JAX
    scales (0.02, or 1/sqrt of the unstacked shape's first axis); a bf16
    leaf rounds the same float32 numbers once."""
    monkeypatch.setattr(layers, "_SLAB", 64)

    def build(dtype):
        pb = layers.ParamBuilder(torch.Generator().manual_seed(5), "cpu",
                                 dtype, lead=(3,))
        return pb.param("small", (2, 8), init=init), \
            pb.param("big", (10, 7), init=init)  # 210: 64, 64, 64, 18

    def scaled(z, fan):
        return z * 0.02 if init == "normal" else z / math.sqrt(fan)

    ref = torch.Generator().manual_seed(5)
    want_small = scaled(torch.randn((3, 2, 8), generator=ref), 2)
    want_big = scaled(torch.cat([torch.randn(n, generator=ref)
                                 for n in (64, 64, 64, 18)]), 10)
    want_big = want_big.reshape(3, 10, 7)
    small, big = build(torch.float32)
    assert torch.equal(small, want_small) and torch.equal(big, want_big)
    small, big = build(torch.bfloat16)
    assert big.dtype == torch.bfloat16
    assert torch.equal(small, want_small.to(torch.bfloat16))
    assert torch.equal(big, want_big.to(torch.bfloat16))


def test_cache_tree_matches_jax_init_cache():
    jcfg = jregistry.get_smoke_config("gemma2-9b")
    cfg = registry.get_smoke_config("gemma2-9b")
    jrt = jT.ModelRuntime(tp=1, max_seq=MAX_SEQ, remat=False)
    rt = T.ModelRuntime(tp=1, max_seq=MAX_SEQ)
    jcache, _ = jT.init_cache(jcfg, jrt, B)
    cache = T.init_cache(cfg, rt, B, device="cpu")
    jleaves = bridge.tree_leaves(jax.tree.map(np.asarray, jcache))
    leaves = bridge.tree_leaves(cache)
    assert [p for p, _ in jleaves] == [p for p, _ in leaves]
    for (path, ja), (_, t) in zip(jleaves, leaves):
        np.testing.assert_array_equal(bridge.to_numpy(t),
                                      bridge.to_numpy(ja), err_msg=path)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-1.3b"])
def test_recurrent_cache_tree_matches_jax_init_cache(arch):
    """float32 ``h`` and bfloat16 ``conv``, zeros, in the JAX layout."""
    jcfg = jregistry.get_smoke_config(arch)
    cfg = registry.get_smoke_config(arch)
    jrt = jT.ModelRuntime(tp=1, max_seq=MAX_SEQ, remat=False)
    rt = T.ModelRuntime(tp=1, max_seq=MAX_SEQ)
    jcache, _ = jT.init_cache(jcfg, jrt, B)
    cache = T.init_cache(cfg, rt, B, device="cpu")
    jleaves = bridge.tree_leaves(jax.tree.map(np.asarray, jcache))
    leaves = bridge.tree_leaves(cache)
    assert [p for p, _ in jleaves] == [p for p, _ in leaves]
    assert any(p.endswith("self/h") for p, _ in leaves)
    for (path, ja), (_, t) in zip(jleaves, leaves):
        assert str(t.dtype) == f"torch.{ja.dtype.name}", path
        np.testing.assert_array_equal(bridge.to_numpy(t),
                                      bridge.to_numpy(ja), err_msg=path)


def test_unported_paths_raise(monkeypatch):
    cfg = registry.get_smoke_config("gemma2-9b")
    with pytest.raises(KeyError, match="ROADMAP"):
        registry.get_config("whisper-tiny")
    from repro_torch.core.checkpoint import DistributedCheckpointer
    # lost-node restore is ported: with nothing saved it fails as JAX's
    with pytest.raises(IOError, match="no recoverable checkpoint"):
        DistributedCheckpointer({}, device="cpu").restore_latest_recoverable(
            lost_nodes=["node3"])
    # the entry points default to the card and never fall back silently
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_params(cfg, T.ModelRuntime(), torch.Generator())
