"""starcoder2-15b — dense GQA, RoPE, LayerNorm + biases. [arXiv:2402.19173; hf]

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152, gelu MLP.
"""
from repro_torch.configs.base import (ATTN_GLOBAL, MLP_GELU, LayerSpec,
                                      ModelConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b",
        family="dense",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=4,
        head_dim=128,
        d_ff=24576,
        vocab_size=49_152,
        pattern=(LayerSpec(mixer=ATTN_GLOBAL, mlp=MLP_GELU),),
        norm="layernorm",
        linear_bias=True,
        rope_theta=100_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        pattern=(LayerSpec(mixer=ATTN_GLOBAL, mlp=MLP_GELU),),
        norm="layernorm",
        linear_bias=True,
        rope_theta=100_000.0,
    )
