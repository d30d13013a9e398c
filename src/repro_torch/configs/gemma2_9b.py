"""gemma2-9b — dense, local+global alternating attention, logit softcaps.

[arXiv:2408.00118; hf] 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000, head_dim=256, window 4096, attn softcap 50, final softcap 30,
sandwich (pre+post) RMSNorms, GeGLU.
"""
from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, MLP_GEGLU,
                                      LayerSpec, ModelConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256_000,
        pattern=(
            LayerSpec(mixer=ATTN_LOCAL, mlp=MLP_GEGLU),
            LayerSpec(mixer=ATTN_GLOBAL, mlp=MLP_GEGLU),
        ),
        window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        post_norms=True,
        tie_embeddings=True,  # deviation: implemented untied (see DESIGN.md)
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        pattern=(
            LayerSpec(mixer=ATTN_LOCAL, mlp=MLP_GEGLU),
            LayerSpec(mixer=ATTN_GLOBAL, mlp=MLP_GEGLU),
        ),
        window=16,
        attn_softcap=50.0,
        final_softcap=30.0,
        post_norms=True,
    )
