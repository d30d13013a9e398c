"""mamba2-1.3b — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060; unverified] 48L d_model=2048, d_ff=0 (mixer-only blocks),
vocab=50280, ssm_state=128, expand 2 -> d_inner=4096, head_dim 64 -> 64 heads.
"""
from repro_torch.configs.base import (MLP_NONE, SSD, LayerSpec,
                                      ModelConfig, SSMConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=1,        # unused by SSD blocks (heads live in SSMConfig)
        n_kv_heads=1,
        d_ff=0,
        vocab_size=50_280,
        pattern=(LayerSpec(mixer=SSD, mlp=MLP_NONE),),
        ssm=SSMConfig(d_state=128, head_dim=64, n_groups=1, conv_width=4,
                      chunk_size=256, expand=2),
        subquadratic=True,
        tie_embeddings=True,  # deviation: implemented untied (see DESIGN.md)
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab_size=512,
        pattern=(LayerSpec(mixer=SSD, mlp=MLP_NONE),),
        ssm=SSMConfig(d_state=16, head_dim=8, n_groups=1, conv_width=4,
                      chunk_size=16, expand=2),
        subquadratic=True,
    )
