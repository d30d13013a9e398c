"""Port parity: repro_torch.serve.engine against repro.serve.engine.

Both engines run the same smoke model from the JAX package's parameters.
A session spilled by one package resumes in the other: the object store
format is shared, leaf for leaf and byte for byte.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core.object_store import PMemObjectStore as JStore
from repro.core.pmem import PMemPool as JPool
from repro.models import transformer as jT
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.core.object_store import PMemObjectStore
from repro_torch.core.pmem import PMemPool
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine

jax.config.update("jax_platform_name", "cpu")

B, PROMPT, GEN, MAX_SEQ = 2, 24, 4, 40
# one decode step's logits from the same bf16 state: the packages round
# bf16 intermediates at different places (see test_torch_models.py, whose
# recurrentgemma limit is wider for its gelu gate)
TOL_BF16 = 0.08
BF16_TOL = {"recurrentgemma-9b": 0.16}
ARCHS = ["gemma2-9b", "qwen2-72b", "recurrentgemma-9b", "mamba2-1.3b",
         "grok-1-314b", "arctic-480b"]


def _pair(arch, dtype, tmp_path):
    jcfg = jregistry.get_smoke_config(arch)
    cfg = registry.get_smoke_config(arch)
    jrt = jT.ModelRuntime(tp=1, attn_impl="naive", max_seq=MAX_SEQ,
                          remat=False)
    rt = T.ModelRuntime(tp=1, attn_impl="pallas", max_seq=MAX_SEQ)
    jparams, _ = jT.init_params(jax.random.PRNGKey(0), jcfg, jrt)
    if dtype == jnp.float32:  # else bf16, and the f32 decay leaves stay
        jparams = jax.tree.map(lambda a: a.astype(dtype), jparams)
    jeng = JEngine(jcfg, jrt, jparams, store=JStore(JPool(tmp_path)))
    eng = ServeEngine(cfg, rt, jax.tree.map(np.asarray, jparams),
                      store=PMemObjectStore(PMemPool(tmp_path)),
                      device="cpu")
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    return jeng, eng, prompts


def _bits(tree):
    return {p: bridge.to_numpy(a) for p, a in bridge.tree_leaves(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax(arch, tmp_path):
    """float32 parameters: greedy tokens are a discrete function of
    logits that agree to ~1e-6, so they must be identical."""
    jeng, eng, prompts = _pair(arch, jnp.float32, tmp_path)
    jfirst = jeng.prefill(prompts)
    first = eng.prefill(prompts)
    np.testing.assert_array_equal(first, jfirst)
    np.testing.assert_array_equal(eng.decode(first, GEN),
                                  jeng.decode(jfirst, GEN))
    assert eng.pos == jeng.pos == PROMPT + GEN


def _next_logits(eng, jeng, tok):
    with torch.no_grad():
        log, _ = T.decode_step(eng.params, eng.cfg, eng.rt, eng.cache,
                               torch.from_numpy(tok), eng.pos)
    jlog, _ = jT.decode_step(jeng.params, jeng.cfg, jeng.rt, jeng.cache,
                             jnp.asarray(tok), jnp.int32(jeng.pos))
    return log.numpy(), np.asarray(jlog, np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_spill_resumes_in_port(arch, tmp_path):
    jeng, eng, prompts = _pair(arch, jnp.bfloat16, tmp_path)
    out = jeng.decode(jeng.prefill(prompts), 2)
    jeng.spill("s")
    stored = _bits(JStore(JPool(tmp_path)).get("serve/s"))
    eng.resume("s")
    resumed = _bits(eng.export_state())
    assert sorted(resumed) == sorted(stored)
    for path in stored:
        np.testing.assert_array_equal(resumed[path], stored[path], path)
    assert eng.pos == jeng.pos == PROMPT + 2
    jeng.resume("s")
    log, jlog = _next_logits(eng, jeng, out[:, -1])
    np.testing.assert_allclose(log, jlog, atol=BF16_TOL.get(arch, TOL_BF16),
                               rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_spill_resumes_in_jax(arch, tmp_path):
    jeng, eng, prompts = _pair(arch, jnp.bfloat16, tmp_path)
    out = eng.decode(eng.prefill(prompts), 2)
    before = _bits(eng.export_state())
    eng.spill("p")
    assert eng.cache is None
    jeng.resume("p")
    after = _bits(jax.tree.map(np.asarray, jeng.export_state()))
    assert sorted(after) == sorted(before)
    for path in before:
        np.testing.assert_array_equal(after[path], before[path], path)
    # the port wrote the JAX format: re-spilled by JAX, every leaf keeps
    # its shape, dtype tag, offset, size and CRC
    jeng.spill("j")
    jstore = JStore(JPool(tmp_path))
    mine, theirs = jstore.manifest("serve/p"), jstore.manifest("serve/j")
    assert mine["leaves"] == theirs["leaves"]
    assert mine["nbytes"] == theirs["nbytes"]
    jeng.resume("j")
    eng.resume("p")
    log, jlog = _next_logits(eng, jeng, out[:, -1])
    np.testing.assert_allclose(log, jlog, atol=BF16_TOL.get(arch, TOL_BF16),
                               rtol=0)


def test_spill_resume_is_exact_and_peekable(tmp_path):
    _, eng, prompts = _pair("gemma2-9b", jnp.bfloat16, tmp_path)
    out = eng.decode(eng.prefill(prompts), 2)
    copy = eng.export_state()
    direct = eng.decode(out[:, -1], 4)
    eng.install_state(copy)
    eng.spill("x")
    assert int(eng.peek_session("x", "pos")) == PROMPT + 2
    page = eng.peek_session("x", "cache/group0/p0/self/k")
    assert torch.equal(page, copy["cache"]["group0"]["p0"]["self"]["k"])
    eng.resume("x")
    np.testing.assert_array_equal(eng.decode(out[:, -1], 4), direct)


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.get_smoke_config("gemma2-9b")
    rt = T.ModelRuntime(max_seq=MAX_SEQ)
    params = T.init_params(cfg, rt, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, rt, params)
    eng = ServeEngine(cfg, rt, params, device="cpu")
    with pytest.raises(RuntimeError, match="pmem"):
        eng.spill("nowhere")


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-1.3b"])
def test_recurrent_state_spills_exactly_and_peeks(arch, tmp_path):
    """The session state of the recurrent mixers: float32 ``h`` and
    bfloat16 ``conv`` leaves go to the store under their own dtype tags
    and come back bit for bit; a single ``h`` page is readable alone;
    decoding after the resume gives the same tokens."""
    _, eng, prompts = _pair(arch, jnp.bfloat16, tmp_path)
    out = eng.decode(eng.prefill(prompts), 2)
    copy = eng.export_state()
    direct = eng.decode(out[:, -1], 4)
    eng.install_state(copy)
    eng.spill("r")
    leaves = JStore(JPool(tmp_path)).manifest("serve/r")["leaves"]
    tags = {path.split("/")[-1]: ent["dtype"]
            for path, ent in leaves.items()}
    assert tags["h"] == "float32" and tags["conv"] == "bfloat16"
    page = bridge.to_numpy(eng.peek_session("r", "cache/group0/p0/self/h"))
    assert page.dtype == np.float32
    np.testing.assert_array_equal(
        page, bridge.to_numpy(copy["cache"]["group0"]["p0"]["self"]["h"]))
    eng.resume("r")
    np.testing.assert_array_equal(eng.decode(out[:, -1], 4), direct)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-1.3b"])
def test_cli_serves_recurrent_archs_on_cpu(arch, tmp_path, capsys,
                                           monkeypatch):
    """``python -m repro_torch.launch.serve --device cpu --arch ...``:
    the plain versions, no kernel launch; without ``--device cpu`` and
    without a card it raises."""
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import serve
    before = (rg_ops.launches, ssd_ops.launches)
    serve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                "--prompt-len", "19", "--gen", "3", "--root",
                str(tmp_path)])
    assert "spill/resume ok" in capsys.readouterr().out
    assert (rg_ops.launches, ssd_ops.launches) == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", arch])


@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
def test_cli_serves_moe_archs_on_cpu(arch, tmp_path, capsys, monkeypatch):
    """``--arch grok-1-314b|arctic-480b --device cpu``: the sorted MoE
    route through the plain grouped matmul, no kernel launch."""
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.launch import serve
    before = gmm_ops.launches
    serve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                "--prompt-len", "19", "--gen", "3", "--root",
                str(tmp_path)])
    assert "spill/resume ok" in capsys.readouterr().out
    assert gmm_ops.launches == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", arch])
