"""Port parity for the archs with a frontend or a LayerNorm: whisper-tiny
(encoder-decoder, learned positions, cross-attention over the encoded
frames) and internvl2-26b with its prefix of precomputed embeddings,
against the JAX package on the CPU; starcoder2-15b's LayerNorm; and the
serve CLI and the training loss for all four archs that joined the
registry with them (deepseek-coder-33b, starcoder2-15b, internvl2-26b,
whisper-tiny). The frontend-free cases of those archs ride the
parametrised lists of ``tests/test_torch_{models,serve,bridge}.py``.

Parameters are JAX-initialised and carried over through the bridge;
inputs come from numpy with a seed. JAX runs flash attention in interpret
mode, the port its wrapper, which takes the plain version on a CPU
tensor. JAX's encoder casts the frames to bf16 and its layer scan keeps
the carry's dtype, so JAX cannot run whisper's encoder with float32
parameters: the float32 cases keep the encoder's parameters in bf16 and
give both decoders JAX's encoder output, so that float32 holds the
decoder's algorithm; the encoder itself is held in bf16 and, layer by
layer, in float32 (``_run_groups`` on float32 inputs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core.object_store import PMemObjectStore as JStore
from repro.core.pmem import PMemPool as JPool
from repro.data import pipeline as jpipeline
from repro.models import layers as jlayers
from repro.models import transformer as jT
from repro.serve.engine import ServeEngine as JEngine
from repro.train import train_step as jts
from repro_torch import bridge
from repro_torch.configs import ShapeConfig, registry
from repro_torch.core.cluster import SimCluster
from repro_torch.core.object_store import PMemObjectStore
from repro_torch.core.pmem import PMemPool
from repro_torch.data import pipeline
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import train_step as ts

jax.config.update("jax_platform_name", "cpu")

B, S, FRAMES, MAX_SEQ, STEPS = 2, 24, 16, 32, 3
# tests/test_torch_models.py's limits. bf16 LayerNorm rounds its output
# at other places in XLA and torch, as RMSNorm does: measured <= 0.031 on
# whisper's and starcoder2's logits of ~3.8 (two ulps), inside the 0.08
# held for the RMSNorm archs; the encoder's output (~3.5) also 0.031
TOLS = {"float32": (2e-5, 2e-5), "bfloat16": (0.08, 0.0)}
NEW_ARCHS = ["deepseek-coder-33b", "starcoder2-15b", "internvl2-26b",
             "whisper-tiny"]


def _np(x):
    return np.asarray(x, np.float32)


def _models(arch, dtype, attn=("interpret", "pallas"), max_seq=MAX_SEQ):
    """JAX and port models from one JAX init. float32 casts every leaf
    but the encoder's (see the module docstring)."""
    jcfg = jregistry.get_smoke_config(arch)
    cfg = registry.get_smoke_config(arch)
    jrt = jT.ModelRuntime(tp=1, attn_impl=attn[0], max_seq=max_seq,
                          remat=False)
    rt = T.ModelRuntime(tp=1, attn_impl=attn[1], max_seq=max_seq)
    jparams, _ = jT.init_params(jax.random.PRNGKey(0), jcfg, jrt)
    if dtype == "float32":
        enc = jparams.pop("encoder", None)
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
        if enc is not None:
            jparams["encoder"] = enc
    host = jax.tree.map(np.asarray, jparams)
    return (jcfg, jrt, jparams), (cfg, rt, host)


def _frontend(cfg, seed=3, frames=FRAMES, prefix=True):
    """Seeded numpy frontends, as ``data/pipeline.py`` makes them:
    ``enc_frames`` for whisper, ``prefix_embeds`` (x 0.02) for
    internvl2."""
    rng = np.random.default_rng(seed)
    kw = {}
    if cfg.enc_dec:
        kw["enc_frames"] = rng.standard_normal(
            (B, frames, cfg.d_model)).astype(np.float32)
    if cfg.prefix_len and prefix:
        kw["prefix_embeds"] = (rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model)) * 0.02).astype(np.float32)
    return kw


def _same_encoder(monkeypatch, jparams, jcfg, jrt, frames):
    """Both packages' ``encode`` return JAX's encoder output on
    ``frames``: the float32 cases then compare the decoders alone."""
    jenc = jT.encode(jparams, jcfg, jrt, jnp.asarray(frames))
    tenc = bridge.to_torch(np.asarray(jenc))
    monkeypatch.setattr(jT, "encode", lambda *a: jenc)
    monkeypatch.setattr(T, "encode", lambda *a: tenc.to(a[3].device))


def _leaves_close(jtree, tree, atol, rtol):
    jleaves = bridge.tree_leaves(jax.tree.map(np.asarray, jtree))
    leaves = bridge.tree_leaves(tree)
    assert [p for p, _ in jleaves] == [p for p, _ in leaves]
    for (path, ja), (_, t) in zip(jleaves, leaves):
        assert tuple(ja.shape) == tuple(t.shape), path
        assert ja.dtype.name == str(t.dtype).replace("torch.", ""), path
        if path.endswith("kpos"):
            np.testing.assert_array_equal(t.numpy(), ja, err_msg=path)
        else:
            np.testing.assert_allclose(t.float().numpy(), _np(ja),
                                       atol=atol, rtol=rtol, err_msg=path)
    return [p for p, _ in leaves]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    """float32 statistics, eps 1e-5, w and b, cast back: float32 to
    summation order, bf16 inputs to one rounding of the output."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((B, S, 64)) * 3 + 1).astype(np.float32)
    w = (1 + rng.standard_normal(64) * 0.1).astype(np.float32)
    b = (rng.standard_normal(64) * 0.1).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = jlayers.layer_norm(jx, jnp.asarray(w), jnp.asarray(b))
    got = layers.layer_norm(bridge.to_torch(np.asarray(jx)),
                            torch.from_numpy(w), torch.from_numpy(b))
    assert str(got.dtype) == f"torch.{dtype}"
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol)
    p = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    assert torch.equal(layers.apply_norm(p, torch.from_numpy(x),
                                         "layernorm", False),
                       layers.layer_norm(torch.from_numpy(x), p["w"],
                                         p["b"]))


# ---------------------------------------------------------------------------
# whisper: the encoder, prefill and decode, the cross caches
# ---------------------------------------------------------------------------

def test_encode_matches_jax_bf16():
    (jcfg, jrt, jparams), (cfg, rt, host) = _models("whisper-tiny",
                                                    "bfloat16")
    frames = _frontend(cfg)["enc_frames"]
    want = jT.encode(jparams, jcfg, jrt, jnp.asarray(frames))
    with torch.no_grad():
        got = T.encode(bridge.params_from_host(host, "cpu"), cfg, rt,
                       torch.from_numpy(frames))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    atol, rtol = TOLS["bfloat16"]
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=atol,
                               rtol=rtol)


def test_encoder_layers_match_jax_float32():
    """The encoder's non-causal layers in float32 (both packages'
    ``_run_groups`` over the ``encoder`` subtree, then its final norm)."""
    jcfg = jregistry.get_smoke_config("whisper-tiny")
    cfg = registry.get_smoke_config("whisper-tiny")
    jrt = jT.ModelRuntime(tp=1, attn_impl="interpret", max_seq=MAX_SEQ,
                          remat=False)
    rt = T.ModelRuntime(tp=1, attn_impl="pallas", max_seq=MAX_SEQ)
    jparams, _ = jT.init_params(jax.random.PRNGKey(0), jcfg, jrt)
    jenc = jax.tree.map(lambda a: a.astype(jnp.float32), jparams["encoder"])
    enc = bridge.params_from_host(jax.tree.map(np.asarray, jenc), "cpu")
    x = np.random.default_rng(2).standard_normal(
        (B, FRAMES, cfg.d_model)).astype(np.float32)
    jx, _, _ = jT._run_groups(jenc, jcfg, jrt, jnp.asarray(x), mode="full",
                              positions=jnp.arange(FRAMES),
                              groups=((jcfg.pattern[:1],
                                       jcfg.n_enc_layers),),
                              causal=False)
    jx = jlayers.apply_norm(jenc["final_norm"], jx, jcfg.norm, False)
    with torch.no_grad():
        tx, _, _ = T._run_groups(enc, cfg, rt, torch.from_numpy(x),
                                 mode="full",
                                 positions=torch.arange(FRAMES),
                                 groups=T._encoder_groups(cfg),
                                 causal=False)
        tx = layers.apply_norm(enc["final_norm"], tx, cfg.norm, False)
    np.testing.assert_allclose(tx.numpy(), _np(jx), atol=2e-5, rtol=2e-5)


def test_whisper_init_cache_matches_jax():
    """``init_cache(enc_len=)``: the self rings and the ``cross`` caches
    over ``enc_len`` frames (kpos 0, as JAX's), leaf for leaf."""
    jcfg = jregistry.get_smoke_config("whisper-tiny")
    cfg = registry.get_smoke_config("whisper-tiny")
    jcache, _ = jT.init_cache(jcfg, jT.ModelRuntime(max_seq=MAX_SEQ), B,
                              enc_len=FRAMES)
    cache = T.init_cache(cfg, T.ModelRuntime(max_seq=MAX_SEQ), B,
                         enc_len=FRAMES, device="cpu")
    jleaves = bridge.tree_leaves(jax.tree.map(np.asarray, jcache))
    leaves = bridge.tree_leaves(cache)
    assert [p for p, _ in jleaves] == [p for p, _ in leaves]
    assert "group0/p0/cross/kpos" in dict(leaves)
    for (path, ja), (_, t) in zip(jleaves, leaves):
        assert str(t.dtype) == f"torch.{ja.dtype.name}", path
        np.testing.assert_array_equal(bridge.to_numpy(t),
                                      bridge.to_numpy(ja), err_msg=path)


def test_serving_encoder_skips_recomputation(monkeypatch):
    """Without autograd (serving) the encoder's "full"-mode layers run
    straight, even with ``rt.remat``: a checkpoint there would only add
    its set-up; with autograd (training) they are recomputed."""
    cfg = registry.get_smoke_config("whisper-tiny")
    rt = T.ModelRuntime(max_seq=MAX_SEQ, remat=True)
    params = T.init_params(cfg, rt, torch.Generator().manual_seed(0),
                           device="cpu")
    frames = torch.from_numpy(_frontend(cfg)["enc_frames"])
    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        want = T.encode(params, cfg, rt, frames)
    assert calls == []
    got = T.encode(params, cfg, rt, frames)
    assert len(calls) == cfg.n_enc_layers
    assert torch.equal(got.detach(), want)


def _check_prefill_decode(arch, dtype, frontend, monkeypatch, s=S,
                          steps=STEPS):
    """Prefill then ``steps`` decode steps: logits and every cache leaf
    (the cross caches' ``kpos`` exactly) against JAX's."""
    (jcfg, jrt, jparams), (cfg, rt, host) = _models(arch, dtype)
    params = bridge.params_from_host(host, "cpu")
    if dtype == "float32" and cfg.enc_dec:
        _same_encoder(monkeypatch, jparams, jcfg, jrt,
                      frontend["enc_frames"])
    atol, rtol = TOLS[dtype]
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, s + steps)).astype(np.int32)
    jlog, jcache = jT.prefill(jparams, jcfg, jrt, jnp.asarray(tokens[:, :s]),
                              **{k: jnp.asarray(v)
                                 for k, v in frontend.items()})
    with torch.no_grad():
        log, cache = T.prefill(params, cfg, rt,
                               torch.from_numpy(tokens[:, :s]),
                               **{k: torch.from_numpy(v)
                                  for k, v in frontend.items()})
    np.testing.assert_allclose(log.numpy(), _np(jlog), atol=atol, rtol=rtol)
    paths = _leaves_close(jcache, cache, atol, rtol)
    start = s + (cfg.prefix_len if "prefix_embeds" in frontend else 0)
    for step in range(steps):
        pos = start + step
        jlog, jcache = jT.decode_step(jparams, jcfg, jrt, jcache,
                                      jnp.asarray(tokens[:, s + step]),
                                      jnp.int32(pos))
        with torch.no_grad():
            log, cache = T.decode_step(params, cfg, rt, cache,
                                       torch.from_numpy(tokens[:, s + step]),
                                       pos)
        np.testing.assert_allclose(log.numpy(), _np(jlog), atol=atol,
                                   rtol=rtol, err_msg=f"decode step {step}")
    _leaves_close(jcache, cache, atol, rtol)
    return cfg, paths, cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_prefill_decode_matches_jax(dtype, monkeypatch):
    cfg = registry.get_smoke_config("whisper-tiny")
    cfg, paths, cache = _check_prefill_decode(
        "whisper-tiny", dtype, _frontend(cfg), monkeypatch)
    assert "group0/p0/cross/k" in paths and "group0/p0/self/k" in paths
    # the cross cache: the frames at positions 0..F-1, padded with -1 to
    # max_seq, in every layer of the stack
    kpos = cache["group0"]["p0"]["cross"]["kpos"]
    assert kpos.shape == (cfg.n_layers, B, MAX_SEQ)
    want = torch.cat([torch.arange(FRAMES, dtype=torch.int32),
                      torch.full((MAX_SEQ - FRAMES,), -1, dtype=torch.int32)])
    assert torch.equal(kpos, want.expand_as(kpos))


def test_whisper_decode_past_max_seq_matches_jax(monkeypatch):
    """Decoding past ``max_seq`` (positions 26..35 against 32): the self
    ring wraps and the learned position is the last one, as JAX's
    ``dynamic_slice`` clamps its start; float32, JAX's encoder output."""
    cfg = registry.get_smoke_config("whisper-tiny")
    _check_prefill_decode("whisper-tiny", "float32", _frontend(cfg),
                          monkeypatch, s=26, steps=10)


def test_whisper_frames_past_the_encoder_ring_match_jax(monkeypatch):
    """40 encoded frames against a decoder runtime of ``max_seq`` 32: the
    cross cache keeps the last 32 frames, rolled into the ring layout
    (slot = frame % 32), as JAX's does. (A whole model cannot encode more
    frames than its own ``max_seq``, the length of its ``pos_embed``;
    both decoders get the encoder output of a 40-long model.)"""
    cfg = registry.get_smoke_config("whisper-tiny")
    (jcfg, jrt, jparams), (cfg, rt, host) = _models("whisper-tiny",
                                                    "float32")
    frames = _frontend(cfg, frames=40)["enc_frames"]
    jrt40 = jT.ModelRuntime(tp=1, attn_impl="interpret", max_seq=40,
                            remat=False)
    jp40, _ = jT.init_params(jax.random.PRNGKey(0), jcfg, jrt40)
    _same_encoder(monkeypatch, jp40, jcfg, jrt40, frames)
    params = bridge.params_from_host(host, "cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                             (B, 8)).astype(np.int32)
    jlog, jcache = jT.prefill(jparams, jcfg, jrt, jnp.asarray(toks),
                              enc_frames=jnp.asarray(frames))
    with torch.no_grad():
        log, cache = T.prefill(params, cfg, rt, torch.from_numpy(toks),
                               enc_frames=torch.from_numpy(frames))
    np.testing.assert_allclose(log.numpy(), _np(jlog), atol=2e-5, rtol=2e-5)
    _leaves_close(jcache, cache, 2e-5, 2e-5)
    kpos = cache["group0"]["p0"]["cross"]["kpos"][0, 0]
    assert sorted(kpos.tolist()) == list(range(40 - MAX_SEQ, 40))


def test_cross_decode_sees_frames_up_to_its_position(monkeypatch):
    """JAX's decode cross-attention keeps ``kpos <= pos``: decode position
    p reads encoder frames 0..p only. Changing the cross cache past p
    leaves the step's logits as they were; changing frame p moves them."""
    cfg = registry.get_smoke_config("whisper-tiny")
    (_, _, _), (cfg, rt, host) = _models("whisper-tiny", "float32")
    params = bridge.params_from_host(host, "cpu")
    frames = torch.from_numpy(_frontend(cfg)["enc_frames"])
    s = 5
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, s + 1)).astype(np.int32))

    def step_logits(edit):
        with torch.no_grad():
            _, cache = T.prefill(params, cfg, rt, toks[:, :s],
                                 enc_frames=frames)
            cross = cache["group0"]["p0"]["cross"]
            edit(cross)
            log, _ = T.decode_step(params, cfg, rt, cache, toks[:, s], s)
        return log

    base = step_logits(lambda c: None)

    def scramble(lo, hi):
        def edit(c):
            for n in ("k", "v"):
                c[n][:, :, lo:hi] = torch.randn_like(c[n][:, :, lo:hi]) * 5
        return edit

    assert torch.equal(step_logits(scramble(s + 1, FRAMES)), base)
    assert not torch.allclose(step_logits(scramble(s, s + 1)), base)


# ---------------------------------------------------------------------------
# internvl2's prefix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_internvl2_prefix_prefill_decode_matches_jax(dtype, monkeypatch):
    """With ``prefix_embeds``: the prefix's positions come first, the
    cache holds S + prefix_len entries, decode goes on from there."""
    cfg = registry.get_smoke_config("internvl2-26b")
    cfg, paths, cache = _check_prefill_decode(
        "internvl2-26b", dtype, _frontend(cfg), monkeypatch)
    kpos = cache["group0"]["p0"]["self"]["kpos"][0, 0]
    assert int(kpos.max()) == S + cfg.prefix_len + STEPS - 1


# ---------------------------------------------------------------------------
# the engine: tokens, spill and resume across packages, TieredIO, sessions
# ---------------------------------------------------------------------------

def _engines(arch, dtype, tmp_path, monkeypatch, frontend, max_seq=40):
    (jcfg, jrt, jparams), (cfg, rt, host) = _models(
        arch, dtype, attn=("naive", "pallas"), max_seq=max_seq)
    if dtype == "float32" and cfg.enc_dec:
        _same_encoder(monkeypatch, jparams, jcfg, jrt,
                      frontend["enc_frames"])
    jeng = JEngine(jcfg, jrt, jparams, store=JStore(JPool(tmp_path)))
    eng = ServeEngine(cfg, rt, host, store=PMemObjectStore(PMemPool(
        tmp_path)), device="cpu")
    return jeng, eng


@pytest.mark.parametrize("arch,prefix", [("whisper-tiny", False),
                                         ("internvl2-26b", True),
                                         ("internvl2-26b", False)])
def test_engine_tokens_match_jax(arch, prefix, tmp_path, monkeypatch):
    """float32 decoders: the greedy tokens equal JAX's engine's, and the
    cursor starts at S + prefix_len whether or not a prefix came."""
    cfg = registry.get_smoke_config(arch)
    frontend = _frontend(cfg, prefix=prefix)
    jeng, eng = _engines(arch, "float32", tmp_path, monkeypatch, frontend)
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jfirst = jeng.prefill(prompts, **{k: jnp.asarray(v)
                                      for k, v in frontend.items()})
    first = eng.prefill(prompts, **frontend)
    np.testing.assert_array_equal(first, jfirst)
    np.testing.assert_array_equal(eng.decode(first, 4),
                                  jeng.decode(jfirst, 4))
    assert eng.pos == jeng.pos == S + cfg.prefix_len + 4


def _bits(tree):
    return {p: bridge.to_numpy(a) for p, a in bridge.tree_leaves(tree)}


def _next_logits(eng, jeng, tok):
    with torch.no_grad():
        log, _ = T.decode_step(eng.params, eng.cfg, eng.rt, eng.cache,
                               torch.from_numpy(tok), eng.pos)
    jlog, _ = jT.decode_step(jeng.params, jeng.cfg, jeng.rt, jeng.cache,
                             jnp.asarray(tok), jnp.int32(jeng.pos))
    return log.numpy(), _np(jlog)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_whisper_spill_resumes_across_packages(writer, tmp_path,
                                               monkeypatch):
    """bf16: whisper's session (self and cross caches, the cursor)
    spilled by one package resumes in the other bit for bit, with the
    same leaf table, and the next step's logits agree."""
    cfg = registry.get_smoke_config("whisper-tiny")
    frontend = _frontend(cfg)
    jeng, eng = _engines("whisper-tiny", "bfloat16", tmp_path, monkeypatch,
                         frontend)
    prompts = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    src, dst = (jeng, eng) if writer == "jax" else (eng, jeng)
    kw = {k: jnp.asarray(v) for k, v in frontend.items()} \
        if writer == "jax" else frontend
    out = src.decode(src.prefill(prompts, **kw), 2)
    before = _bits(src.export_state())
    src.spill("w")
    dst.resume("w")
    after = _bits(dst.export_state())
    assert sorted(after) == sorted(before)
    assert any("/cross/" in p for p in before)
    for path in before:
        np.testing.assert_array_equal(after[path], before[path], path)
    src.resume("w")
    assert eng.pos == jeng.pos == S + 2
    jstore = JStore(JPool(tmp_path))
    dst.spill("again")
    assert jstore.manifest("serve/w")["leaves"] == \
        jstore.manifest("serve/again")["leaves"]
    dst.resume("again")
    log, jlog = _next_logits(eng, jeng, out[:, -1])
    np.testing.assert_allclose(log, jlog, atol=TOLS["bfloat16"][0], rtol=0)


def test_whisper_session_through_tiered_io_and_the_manager(tmp_path):
    """whisper's state through the port's TieredIO (a nonblocking spill,
    its replica's ack, cold eviction, prefetch, a DRAM-hit resume,
    ``peek_session`` of a cross page) and through the SessionManager (a
    suspend, the home node killed, a second engine resumes off the
    replica, ``peek`` of the cross keys): the tokens equal an
    uninterrupted engine's, the state bit for bit."""
    (_, _, _), (cfg, rt, host) = _models("whisper-tiny", "bfloat16",
                                         max_seq=40)
    frontend = _frontend(cfg)
    prompts = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    ref = ServeEngine(cfg, rt, host, device="cpu")
    out = ref.decode(ref.prefill(prompts, **frontend), 2)
    state = ref.export_state()
    want = ref.decode(out[:, -1], 3)
    cross = bridge.to_numpy(state["cache"]["group0"]["p0"]["cross"]["k"])
    c = SimCluster(tmp_path / "tiered", n_nodes=2, device="cpu")
    try:
        eng = ServeEngine(cfg, rt, host, store=c.stores["node0"],
                          tiered=c.tiered, device="cpu")
        eng.install_state(state)
        eng.spill("s", wait=False).result(timeout=60)
        assert c.tiered.quiesce() == []
        assert c.tiered.dlm_acks.targets("dlm/serve/s") == ["node1"]
        assert eng.evict_cold_sessions() == 1
        assert eng.prefetch_sessions(["s"]).result(timeout=60)["loads"] == 1
        page = eng.peek_session("s", "cache/group0/p0/cross/k")
        np.testing.assert_array_equal(bridge.to_numpy(page), cross)
        eng.resume("s")
        np.testing.assert_array_equal(eng.decode(out[:, -1], 3), want)
    finally:
        c.shutdown()
    c = SimCluster(tmp_path / "fleet", n_nodes=3, device="cpu")
    try:
        a = ServeEngine(cfg, rt, host, label="a", device="cpu")
        a.install_state(state)
        c.sessions.start("u", a)
        rec = c.sessions.suspend("u")
        c.tiered.quiesce()
        c.kill_node(rec["home"])
        np.testing.assert_array_equal(
            bridge.to_numpy(c.sessions.peek("u", "cache/group0/p0/cross/k")),
            cross)
        b = ServeEngine(cfg, rt, host, label="b", device="cpu")
        c.sessions.resume("u", b)
        got, want_bits = _bits(b.export_state()), _bits(state)
        assert sorted(got) == sorted(want_bits)
        for path in want_bits:
            np.testing.assert_array_equal(got[path], want_bits[path], path)
        np.testing.assert_array_equal(b.decode(out[:, -1], 3), want)
    finally:
        c.shutdown()


# ---------------------------------------------------------------------------
# the serve CLI and the training loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_cli_serves_on_cpu(arch, tmp_path, capsys, monkeypatch):
    """``python -m repro_torch.launch.serve --device cpu --arch ...``:
    whisper gets ``prompt_len`` encoder frames, internvl2 no prefix (as
    JAX's CLI); the plain versions, no kernel launch; without ``--device
    cpu`` and without a card it raises."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve
    before = fa_ops.launches
    serve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                "--prompt-len", "19", "--gen", "3", "--root",
                str(tmp_path)])
    out = capsys.readouterr().out
    assert "spill/resume ok" in out
    assert f"arch={registry.get_smoke_config(arch).name} " in out
    assert fa_ops.launches == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", arch])


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_training_loss_with_frontends_matches_jax(arch, monkeypatch):
    """The loss of one batch from the pipeline (tokens after the prefix,
    ``prefix_embeds``, ``enc_frames``) through the port's
    ``make_loss_fn`` against JAX's, float32 blockwise attention (whisper:
    both given JAX's encoder output, see the module docstring); and the
    batches of both pipelines are equal."""
    seq = 32
    (jcfg, jrt, jparams), (cfg, rt, host) = _models(
        arch, "float32", attn=("blockwise", "blockwise"), max_seq=seq)
    shard = pipeline.synthetic_shard(0, 8, seq, cfg.vocab_size)
    shape = ShapeConfig("loss", seq, B, "train")
    batch = pipeline.make_batch(shard, cfg, shape,
                                np.random.default_rng(1))
    jbatch = jpipeline.make_batch(shard, jcfg, shape,
                                  np.random.default_rng(1))
    assert sorted(batch) == sorted(jbatch)
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k], k)
    assert ("prefix_embeds" in batch) == bool(cfg.prefix_len)
    assert ("enc_frames" in batch) == cfg.enc_dec
    if cfg.enc_dec:
        _same_encoder(monkeypatch, jparams, jcfg, jrt, batch["enc_frames"])
    jloss, jm = jts.make_loss_fn(jcfg, jrt, lambda x, kind: x, 16)(
        jparams, {k: jnp.asarray(v) for k, v in jbatch.items()})
    with torch.no_grad():
        loss, m = ts.make_loss_fn(cfg, rt, 16)(
            bridge.params_from_host(host, "cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert m["ntok"].item() == float(jm["ntok"])
