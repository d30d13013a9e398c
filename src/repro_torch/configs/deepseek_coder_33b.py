"""deepseek-coder-33b — llama-arch dense GQA. [arXiv:2401.14196; hf]

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256, SwiGLU.
Note: 56 heads is not divisible by a TP degree of 16; JAX's sharding plan
zero-pads Q heads to 64 (``ModelConfig.padded_heads``). The port serves
it on one card (tp=1), unpadded.
"""
from repro_torch.configs.base import (ATTN_GLOBAL, MLP_SWIGLU, LayerSpec,
                                      ModelConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b",
        family="dense",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=19200,
        vocab_size=32_256,
        pattern=(LayerSpec(mixer=ATTN_GLOBAL, mlp=MLP_SWIGLU),),
        rope_theta=100_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=6,  # deliberately not a power of two (exercises head padding)
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        pattern=(LayerSpec(mixer=ATTN_GLOBAL, mlp=MLP_SWIGLU),),
        rope_theta=100_000.0,
    )
