"""Port bridge: JAX parameter trees cross into torch and back bit-exactly."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import transformer as jT
from repro_torch import bridge
from repro_torch.configs import registry

ARCHS = ["gemma2-9b", "qwen2-72b", "recurrentgemma-9b", "mamba2-1.3b",
         "grok-1-314b", "arctic-480b", "deepseek-coder-33b",
         "starcoder2-15b", "internvl2-26b", "whisper-tiny"]
# the recurrences' decay parameters, float32 in both packages
F32_LEAVES = ("lam", "a_log", "dt_bias")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_round_trips_bit_exactly(arch):
    cfg = jregistry.get_smoke_config(arch)
    rt = jT.ModelRuntime(tp=1, attn_impl="naive", max_seq=32, remat=False)
    params, _ = jT.init_params(jax.random.PRNGKey(0), cfg, rt)
    host = jax.tree.map(np.asarray, params)
    tparams = bridge.params_from_host(host, "cpu")
    back = bridge.params_to_host(tparams)
    leaves = bridge.tree_leaves(host)
    assert [p for p, _ in leaves] == [p for p, _ in bridge.tree_leaves(back)]
    assert len(leaves) > 10
    for (path, a), (_, b) in zip(leaves, bridge.tree_leaves(back)):
        assert a.shape == b.shape, path
        if a.dtype.name == "bfloat16":
            assert b.dtype == np.uint16, path
            np.testing.assert_array_equal(b, a.view(np.uint16), path)
        else:
            assert b.dtype == a.dtype, path
            np.testing.assert_array_equal(b, a, path)
    for path, t in bridge.tree_leaves(tparams):
        want = torch.float32 if path.split("/")[-1] in F32_LEAVES \
            else torch.bfloat16
        assert t.dtype == want, path


def test_bf16_values_survive_the_bit_path():
    """The uint16 route keeps values, not just bytes (jnp.bfloat16 and
    torch.bfloat16 are the same format)."""
    import jax.numpy as jnp
    x = np.array([0.0, -1.5, 3.140625, 1e-30, 65504.0, -np.inf],
                 np.float32)
    jb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    t = bridge.to_torch(jb)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), jb.astype(np.float32))
    np.testing.assert_array_equal(
        bridge.to_numpy(torch.from_numpy(x).to(torch.bfloat16)),
        jb.view(np.uint16))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_configs_are_copies(arch, getter):
    mine = getattr(registry, getter)(arch)
    ref = getattr(jregistry, getter)(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()
