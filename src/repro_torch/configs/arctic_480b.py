"""arctic-480b — dense-MoE hybrid, 128 experts top-2 + dense residual.

[hf:Snowflake/snowflake-arctic-base; hf] 35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000, MoE 128e top-2 with a parallel dense residual MLP
(Snowflake's dense-MoE hybrid).
"""
from repro_torch.configs.base import (ATTN_GLOBAL, MLP_MOE, LayerSpec,
                                      ModelConfig, MoEConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab_size=32_000,
        pattern=(LayerSpec(mixer=ATTN_GLOBAL, mlp=MLP_MOE,
                           dense_residual=True),),
        moe=MoEConfig(n_experts=128, top_k=2, capacity_factor=1.25),
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="arctic-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=512,
        pattern=(LayerSpec(mixer=ATTN_GLOBAL, mlp=MLP_MOE,
                           dense_residual=True),),
        moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.5),
    )
