"""qwen2-72b — dense GQA with QKV bias. [arXiv:2407.10671; hf]

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064, SwiGLU,
RoPE theta 1e6.
"""
from repro_torch.configs.base import (ATTN_GLOBAL, MLP_SWIGLU, LayerSpec,
                                      ModelConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152_064,
        pattern=(LayerSpec(mixer=ATTN_GLOBAL, mlp=MLP_SWIGLU),),
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        pattern=(LayerSpec(mixer=ATTN_GLOBAL, mlp=MLP_SWIGLU),),
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )
