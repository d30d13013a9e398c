"""internvl2-26b — VLM: InternViT frontend (stub) + InternLM2-20B backbone.

[arXiv:2404.16821; hf] 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553. The vision frontend is a stub, as in the JAX package: the
caller passes precomputed patch embeddings (``prefix_embeds``,
[B, prefix_len=256, d_model]), prepended to the token stream.
"""
from repro_torch.configs.base import (ATTN_GLOBAL, MLP_SWIGLU, LayerSpec,
                                      ModelConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b",
        family="vlm",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92_553,
        pattern=(LayerSpec(mixer=ATTN_GLOBAL, mlp=MLP_SWIGLU),),
        prefix_len=256,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        pattern=(LayerSpec(mixer=ATTN_GLOBAL, mlp=MLP_SWIGLU),),
        prefix_len=8,
        rope_theta=1_000_000.0,
    )
