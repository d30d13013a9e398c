"""Port parity: repro_torch.models against repro.models on the CPU.

Inputs come from a numpy seed; parameters are the JAX package's
``init_params`` carried over through the bridge. JAX runs the Pallas
flash kernel in interpret mode, the port its kernel wrapper, which on a
CPU tensor takes the plain version.
"""
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


def _setup(arch, dtype):
    jcfg = jregistry.get_smoke_config(arch)
    cfg = registry.get_smoke_config(arch)
    jrt = jT.ModelRuntime(tp=1, attn_impl="interpret", max_seq=MAX_SEQ,
                          remat=False)
    rt = T.ModelRuntime(tp=1, attn_impl="pallas", max_seq=MAX_SEQ)
    jparams, _ = jT.init_params(jax.random.PRNGKey(0), jcfg, jrt)
    jparams = jax.tree.map(lambda a: a.astype(dtype), jparams)
    params = bridge.params_from_host(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + DECODE_STEPS)) \
        .astype(np.int32)
    return jcfg, jrt, jparams, cfg, rt, params, tokens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen2-72b"])
def test_prefill_decode_logits_match_jax(arch, dtype):
    jdtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    atol, rtol = TOLS[dtype]
    jcfg, jrt, jparams, cfg, rt, params, tokens = _setup(arch, jdtype)

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

    for step in range(DECODE_STEPS):
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


@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen2-72b"])
def test_init_params_tree_matches_jax(arch):
    """The port's own init builds the JAX tree: names, shapes, dtypes,
    and the deterministic leaves (norm weights, biases) exactly."""
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
        assert t.dtype == torch.bfloat16, path
        if "norm" in path or path.split("/")[-1].startswith("b"):
            np.testing.assert_array_equal(bridge.to_numpy(t),
                                          ja.view(np.uint16), err_msg=path)
    assert cfg.param_count() == jcfg.param_count()


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


def test_unported_paths_raise(monkeypatch):
    cfg = registry.get_smoke_config("gemma2-9b")
    with pytest.raises(KeyError, match="ROADMAP"):
        registry.get_config("mamba2-1.3b")
    from repro_torch.models import attention
    q = torch.zeros(1, 16, 4, 16)
    k = torch.zeros(1, 16, 2, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attention.attend(q, k, k, causal=True, impl="blockwise")
    # the entry points default to the card and never fall back silently
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_params(cfg, T.ModelRuntime(), torch.Generator())
