"""recurrentgemma-9b — Griffin-style hybrid: RG-LRU + local attention, 1:2.

[arXiv:2402.19427; unverified] 38L d_model=4096 16H (GQA kv=1, i.e. MQA)
d_ff=12288 vocab=256000, pattern (rec, rec, local-attn), window 2048.
"""
from repro_torch.configs.base import (ATTN_LOCAL, MLP_GEGLU, RGLRU,
                                      LayerSpec, ModelConfig, RGLRUConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256_000,
        pattern=(
            LayerSpec(mixer=RGLRU, mlp=MLP_GEGLU),
            LayerSpec(mixer=RGLRU, mlp=MLP_GEGLU),
            LayerSpec(mixer=ATTN_LOCAL, mlp=MLP_GEGLU),
        ),
        window=2048,
        rglru=RGLRUConfig(width=4096, conv_width=4),
        subquadratic=True,
        tie_embeddings=True,  # deviation: implemented untied (see DESIGN.md)
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke",
        family="hybrid",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        pattern=(
            LayerSpec(mixer=RGLRU, mlp=MLP_GEGLU),
            LayerSpec(mixer=RGLRU, mlp=MLP_GEGLU),
            LayerSpec(mixer=ATTN_LOCAL, mlp=MLP_GEGLU),
        ),
        window=16,
        rglru=RGLRUConfig(width=64, conv_width=4, block_width=8),
        subquadratic=True,
    )
