"""Port parity: the training path against the JAX package on the CPU.

Blockwise and local attention (forward and gradients), the chunked
cross-entropy, one train step of gemma2's smoke config (loss, gradient
norm, new parameters, moments and step), microbatch accumulation, the
bf16 step, the training loop against JAX's loop, and the CLI. Inputs come
from numpy with a seed; parameters are JAX-initialised and carried across
by ``repro_torch.bridge``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core.cluster import SimCluster as JSimCluster
from repro.data.pipeline import StagedDataset as JStagedDataset
from repro.models import attention as jattn
from repro.models import transformer as jT
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import bridge
from repro_torch.configs import ShapeConfig, registry
from repro_torch.core.cluster import SimCluster
from repro_torch.data.pipeline import StagedDataset
from repro_torch.launch import train as train_cli
from repro_torch.models import attention
from repro_torch.models import transformer as T
from repro_torch.train import loop
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

jax.config.update("jax_platform_name", "cpu")

ARCH = "gemma2-9b"
B, S = 4, 32
# float32 attention: both sides sum the same products in another order
# (XLA's einsum against torch's), measured ~1e-7 on outputs of unit scale
ATTN_TOL = 2e-6
# gradients through an online softmax: the same, over more terms
ATTN_GRAD_TOL = 1e-5


def _jp(a):
    return jnp.asarray(a)


def _np(x):
    return np.asarray(x, np.float32)


def _qkv(b, s, h, kh, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, n, d)).astype(np.float32)
            for n in (h, kh, kh)]


def _attn_grads(fn_j, fn_t, q, k, v, w):
    """Forward outputs and d(sum(out * w))/d(q, k, v) of both packages."""
    jout, jvjp = jax.vjp(lambda a, b_, c: fn_j(a, b_, c), _jp(q), _jp(k),
                         _jp(v))
    jg = jvjp(_jp(w))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fn_t(tq, tk, tv)
    tg = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(w))
    return (jout, jg), (out, tg)


@pytest.mark.parametrize("causal,cap,q_offset", [(True, 50.0, 0),
                                                 (True, 0.0, 0),
                                                 (False, 30.0, 0),
                                                 (True, 0.0, 16)])
def test_blockwise_attention_matches_jax(causal, cap, q_offset):
    """Forward and gradients, float32, several blocks each way (bq=bk=16
    over S=64 and Sk=64+q_offset)."""
    q, _, _ = _qkv(2, 64, 4, 2, 16, seed=1)
    _, k, v = _qkv(2, 64 + q_offset, 4, 2, 16, seed=2)
    w = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=causal, cap=cap, q_offset=q_offset, bq=16, bk=16)
    (jout, jg), (out, tg) = _attn_grads(
        lambda a, b_, c: jattn.blockwise_attention(a, b_, c, **kw),
        lambda a, b_, c: attention.blockwise_attention(a, b_, c, **kw),
        q, k, v, w)
    np.testing.assert_allclose(out.detach().numpy(), _np(jout),
                               atol=ATTN_TOL, rtol=ATTN_TOL)
    for a, b_ in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), _np(b_), atol=ATTN_GRAD_TOL,
                                   rtol=ATTN_GRAD_TOL)


@pytest.mark.parametrize("window,cap", [(16, 50.0), (40, 0.0), (200, 30.0)])
def test_local_attention_matches_jax(window, cap):
    """Sliding-window attention, forward and gradients, float32: windows
    inside one block, across blocks, and longer than the sequence."""
    q, k, v = _qkv(2, 64, 4, 1, 16, seed=4)
    w = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)
    kw = dict(window=window, cap=cap, bq=16)
    (jout, jg), (out, tg) = _attn_grads(
        lambda a, b_, c: jattn.local_attention(a, b_, c, **kw),
        lambda a, b_, c: attention.local_attention(a, b_, c, **kw),
        q, k, v, w)
    np.testing.assert_allclose(out.detach().numpy(), _np(jout),
                               atol=ATTN_TOL, rtol=ATTN_TOL)
    for a, b_ in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), _np(b_), atol=ATTN_GRAD_TOL,
                                   rtol=ATTN_GRAD_TOL)


@pytest.mark.parametrize("window", [0, 24])
def test_attend_blockwise_dispatch_matches_jax(window):
    """``attend(impl="blockwise")`` takes the same route as JAX's (local
    for a causal window, blockwise otherwise) at the default blocks."""
    q, k, v = _qkv(1, 40, 4, 2, 8, seed=6)
    want = jattn.attend(_jp(q), _jp(k), _jp(v), causal=True, window=window,
                        cap=50.0, impl="blockwise")
    got = attention.attend(*map(torch.from_numpy, (q, k, v)), causal=True,
                           window=window, cap=50.0, impl="blockwise")
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATTN_TOL,
                               rtol=ATTN_TOL)


@pytest.mark.parametrize("chunk", [16, 12, 64])
def test_chunked_ce_loss_matches_jax(chunk):
    """Sum of NLL and of the mask, chunk by chunk (12 halves to 6 to
    divide S=48), the padded vocabulary columns masked; float32."""
    cfg = registry.get_smoke_config(ARCH)
    jcfg = jregistry.get_smoke_config(ARCH)
    rng = np.random.default_rng(7)
    vp = cfg.padded_vocab + 8  # columns past the vocabulary are masked
    h = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    w = (rng.standard_normal((cfg.d_model, vp)) * 0.3).astype(np.float32)
    lbl = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    msk = (rng.random((2, 48)) > 0.2).astype(np.float32)
    jn, jm = jts.chunked_ce_loss(_jp(h), _jp(w), _jp(lbl), _jp(msk), jcfg,
                                 lambda x, kind: x, chunk)
    n, m = ts.chunked_ce_loss(*map(torch.from_numpy, (h, w, lbl, msk)), cfg,
                              chunk)
    assert m.item() == float(jm)
    np.testing.assert_allclose(n.item(), float(jn), rtol=1e-6)


@pytest.fixture(scope="module")
def jax_init():
    """JAX's smoke-config parameters, initialised once for the module
    (JAX's init takes seconds on the CPU)."""
    jcfg = jregistry.get_smoke_config(ARCH)
    return jT.init_params(jax.random.PRNGKey(0), jcfg,
                          jT.ModelRuntime(tp=1, max_seq=S))[0]


def _models(jax_init, dtype=jnp.float32, attn="blockwise"):
    jcfg = jregistry.get_smoke_config(ARCH)
    cfg = registry.get_smoke_config(ARCH)
    jrt = jT.ModelRuntime(tp=1, attn_impl=attn, max_seq=S)
    rt = T.ModelRuntime(tp=1, attn_impl=attn, max_seq=S)
    jparams = jax.tree.map(lambda a: a.astype(dtype), jax_init)
    params = bridge.params_from_host(jax.tree.map(np.asarray, jparams),
                                     "cpu")
    return jcfg, jrt, jparams, cfg, rt, params


def _batch(seed=8, b=B, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (b, s + 1)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[:, -1] = 0.0
    return {"tokens": toks[:, :s], "labels": toks[:, 1:], "loss_mask": mask}


def _steps(jcfg, jrt, jparams, cfg, rt, params, batch, n=1, micro=1):
    adam_j = jopt.AdamWConfig(lr=1e-3, warmup=10)
    adam = opt.AdamWConfig(lr=1e-3, warmup=10)
    jstep = jax.jit(jts.make_train_step(jcfg, jrt, lambda x, kind: x,
                                        adam_j, microbatches=micro,
                                        ce_chunk=16))
    step = ts.make_train_step(cfg, rt, adam, microbatches=micro, ce_chunk=16)
    jst, st = jopt.init_opt_state(jparams, adam_j), \
        opt.init_opt_state(params, adam)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(n):
        jparams, jst, jm = jstep(jparams, jst, jb)
        params, st, m = step(params, st, batch)
    return (jparams, jst, jm), (params, st, m)


def _leaves(jtree):
    """A JAX tree's ``[(path, numpy leaf)]``."""
    return bridge.tree_leaves(jax.tree.map(np.asarray, jtree))


def test_train_step_matches_jax_float32(jax_init):
    """Two steps in float32. Gradients agree to ~1e-6 of their largest
    (summation order); AdamW's first steps are sign-like (m / sqrt(v) =
    g / |g|), so a gradient near 0 may flip its element's update: held to
    atol 1e-5 (1% of one lr step) and rtol 1e-5. Moments rtol 1e-4 with
    atol 1e-4 of the leaf's largest; b1 ** step in float32 on both
    sides."""
    jcfg, jrt, jparams, cfg, rt, params = _models(jax_init)
    (jp, jst, jm), (p, st, m) = _steps(jcfg, jrt, jparams, cfg, rt, params,
                                       _batch(), n=2)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(),
                               float(jm["grad_norm"]), rtol=1e-5)
    assert m["step"].item() == float(jm["step"]) == 2.0
    assert m["aux"].item() == float(jm["aux"]) == 0.0
    assert st["step"].dtype == torch.int32 and st["step"].item() == 2
    jl, tl = _leaves(jp), bridge.tree_leaves(p)
    assert [a for a, _ in jl] == [a for a, _ in tl]
    for (path, a), (_, t) in zip(jl, tl):
        assert t.dtype == torch.float32, path
        np.testing.assert_allclose(t.numpy(), a, atol=1e-5, rtol=1e-5,
                                   err_msg=path)
    for (path, a), (_, t) in zip(_leaves(jst["moments"]),
                                 bridge.tree_leaves(st["moments"])):
        scale = np.abs(a).max() + 1e-30
        np.testing.assert_allclose(t.numpy(), a, atol=1e-4 * scale,
                                   rtol=1e-4, err_msg=path)


def test_microbatches_equal_full_batch(jax_init):
    """Two microbatches (float32 accumulation, averaged) give the full
    batch's step: the loss of each half normalises by the half's own
    mask count, which is the same here, so only summation order
    differs. Also against JAX's microbatched step."""
    jcfg, jrt, jparams, cfg, rt, params = _models(jax_init)
    batch = _batch(seed=9)
    (jp2, _, jm2), (p2, _, m2) = _steps(jcfg, jrt, jparams, cfg, rt, params,
                                        batch, micro=2)
    _, (p1, _, m1) = _steps(jcfg, jrt, jparams, cfg, rt, params, batch)
    np.testing.assert_allclose(m2["loss"].item(), m1["loss"].item(),
                               rtol=1e-5)
    np.testing.assert_allclose(m2["loss"].item(), float(jm2["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m2["grad_norm"].item(),
                               m1["grad_norm"].item(), rtol=1e-5)
    for (path, a), (_, b_) in zip(bridge.tree_leaves(p2),
                                  bridge.tree_leaves(p1)):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=path)
    for (path, a), (_, t) in zip(_leaves(jp2), bridge.tree_leaves(p2)):
        np.testing.assert_allclose(t.numpy(), a, atol=1e-5, rtol=1e-5,
                                   err_msg=path)


def test_train_step_bf16_matches_jax(jax_init):
    """bf16 parameters (float32 moments): XLA and torch round bf16
    intermediates at other places, so the loss agrees to 1e-2 relative
    and each new parameter to two bf16 ulps of its leaf's largest value
    plus one lr step (the sign-like first update)."""
    jcfg, jrt, jparams, cfg, rt, params = _models(jax_init, jnp.bfloat16)
    (jp, _, jm), (p, _, m) = _steps(jcfg, jrt, jparams, cfg, rt, params,
                                    _batch(seed=10))
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=1e-2)
    np.testing.assert_allclose(m["grad_norm"].item(),
                               float(jm["grad_norm"]), rtol=5e-2)
    for (path, a), (_, t) in zip(_leaves(jp), bridge.tree_leaves(p)):
        assert t.dtype == torch.bfloat16, path
        want = np.asarray(a, np.float32)
        scale = np.abs(want).max()
        np.testing.assert_allclose(t.float().numpy(), want,
                                   atol=2 * 2 ** -8 * scale + 1e-3,
                                   err_msg=path)


def test_training_rejects_kernels_without_backward():
    cfg = registry.get_smoke_config(ARCH)
    with pytest.raises(NotImplementedError, match="backward"):
        ts.make_train_step(cfg, T.ModelRuntime(attn_impl="pallas"),
                           opt.AdamWConfig())
    # the int8 moments are ported (tests/test_torch_optimizer_int8.py)
    st = opt.init_opt_state({"w": torch.zeros(2)},
                            opt.AdamWConfig(moments_dtype="int8"))
    assert sorted(st["moments"]["w"]["m"]) == ["q", "scale"]
    assert sorted(st["moments"]["w"]["v"]) == ["lo", "q", "rng"]


def test_remat_gives_the_same_gradients(jax_init):
    """Recomputing each layer in the backward pass changes no number."""
    _, _, _, cfg, rt, params = _models(jax_init)
    batch = {k: torch.from_numpy(v) for k, v in _batch(seed=11).items()}
    grads = []
    for remat in (True, False):
        fn = ts._grad_fn(ts.make_loss_fn(
            cfg, T.ModelRuntime(attn_impl="blockwise", remat=remat,
                                max_seq=S), 16))
        grads.append(fn(params, batch)[0])
    for (path, a), (_, b_) in zip(bridge.tree_leaves(grads[0]),
                                  bridge.tree_leaves(grads[1])):
        assert torch.equal(a, b_), path


def test_loop_matches_jax_loop(jax_init, tmp_path):
    """The port's loop on a 4-node port cluster (6 steps, a full save at
    step 2 and deltas at 4 and 6) against JAX's loop on a JAX cluster,
    from the same parameters and data seed: the same batches (the
    pipelines are copies), losses within 1e-4 relative (float32, two
    frameworks' summation orders compounding over six steps)."""
    jcfg, jrt, jparams, cfg, rt, params = _models(jax_init)
    shape = ShapeConfig("t", S, B, "train")
    jshape = JShapeConfig("t", S, B, "train")
    adam_j = jopt.AdamWConfig(lr=1e-3, warmup=10)
    adam = opt.AdamWConfig(lr=1e-3, warmup=10)
    lc = loop.LoopConfig(steps=6, ckpt_every=2, delta_ckpt=True)
    jlc = jloop.LoopConfig(steps=6, ckpt_every=2, delta_ckpt=True)

    jc = JSimCluster(tmp_path / "jax", n_nodes=4, delta=True)
    try:
        jdata = JStagedDataset(jc, jcfg, jshape, n_shards=4,
                               seqs_per_shard=16)
        jstate = jloop.run(
            jax.jit(jts.make_train_step(jcfg, jrt, lambda x, kind: x,
                                        adam_j, ce_chunk=16)),
            jparams, jopt.init_opt_state(jparams, adam_j), jdata.batches(6),
            jc, jlc)
    finally:
        jc.shutdown()
    c = SimCluster(tmp_path / "port", n_nodes=4, delta=True, device="cpu")
    try:
        data = StagedDataset(c, cfg, shape, n_shards=4, seqs_per_shard=16)
        state = loop.run(ts.make_train_step(cfg, rt, adam, ce_chunk=16),
                         params, opt.init_opt_state(params, adam),
                         data.batches(6), c, lc)
        assert c.checkpointer.available_steps() == [2, 4, 6]
        man = c.checkpointer._meta_get_json("ckpt/manifest_step6.json")
        assert man["delta_base"] == 2
    finally:
        c.shutdown()
    assert state.step == jstate.step == 6
    np.testing.assert_allclose(state.losses, jstate.losses, rtol=1e-4)
    assert len(state.ckpt_seconds) == 3
    # both clusters replicate every save to its ring buddy
    assert state.final_ckpt_durability == \
        jstate.final_ckpt_durability == "REPLICATED"


def test_pipeline_batches_match_jax():
    """The same seed gives the same synthetic shards and batches."""
    from repro.data.pipeline import make_batch as j_make_batch
    from repro.data.pipeline import synthetic_shard as j_shard
    from repro_torch.data.pipeline import make_batch, synthetic_shard
    cfg = registry.get_smoke_config(ARCH)
    jcfg = jregistry.get_smoke_config(ARCH)
    shard, jshard = synthetic_shard(3, 16, S, 512), j_shard(3, 16, S, 512)
    np.testing.assert_array_equal(shard["tokens"], jshard["tokens"])
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(3):
        b = make_batch(shard, cfg, ShapeConfig("t", S, B, "train"), rng)
        jb = j_make_batch(jshard, jcfg, JShapeConfig("t", S, B, "train"),
                          jrng)
        assert sorted(b) == sorted(jb)
        for k in b:
            np.testing.assert_array_equal(b[k], jb[k], err_msg=k)


def test_loop_refuses_unported_options(tmp_path):
    """``fault_at``, ``drain_every`` and the repair daemon are ported
    (tests/test_torch_recovery.py): the loop takes them, and a fault
    before the first checkpoint fails as JAX's does, with nothing to
    restore."""
    c = SimCluster(tmp_path / "c", n_nodes=2, device="cpu")
    try:
        for lc, fault in ((loop.LoopConfig(), 3),
                          (loop.LoopConfig(drain_every=1,
                                           repair_daemon=True), None)):
            state = loop.run(None, {}, {}, iter(()), c, lc, fault_at=fault)
            assert state.step == 0 and state.recovered_at == []
    finally:
        c.shutdown()
    with pytest.raises(IOError, match="no recoverable checkpoint"):
        train_cli.main(["--device", "cpu", "--smoke", "--steps", "3",
                        "--fault-at", "3", "--root", str(tmp_path / "cli")])


def test_cli_trains_on_cpu_with_delta_checkpoints(tmp_path, capsys):
    """The CLI at JAX's defaults (20 steps, seq 64, batch 8, a checkpoint
    every 5 steps) on the CPU: the loss goes down."""
    state = train_cli.main(["--device", "cpu", "--smoke", "--delta-ckpt",
                            "--root", str(tmp_path)])
    assert state.step == 20 and len(state.ckpt_seconds) == 4
    assert state.losses[-1] < state.losses[0]
    assert "arch=gemma2-smoke steps=20" in capsys.readouterr().out
