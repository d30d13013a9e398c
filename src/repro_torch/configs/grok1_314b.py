"""grok-1-314b — MoE, 8 experts top-2. [hf:xai-org/grok-1; unverified]

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, attention +
router/output logit softcaps (tanh 30). The port serves it on one card
(every expert resident, through the gmm kernel) or on a mesh through the
expert-parallel routes of ``distributed/moe_parallel.py``, and trains it
on a mesh with the reference's plan: FSDP of the parameters, ZeRO-2
gradient blocks, int8 moments.
"""
from repro_torch.configs.base import (ATTN_GLOBAL, MLP_MOE, LayerSpec,
                                      ModelConfig, MoEConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=32768,
        vocab_size=131_072,
        pattern=(LayerSpec(mixer=ATTN_GLOBAL, mlp=MLP_MOE),),
        moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25,
                      router_softcap=30.0),
        attn_softcap=30.0,
        final_softcap=30.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="grok1-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        pattern=(LayerSpec(mixer=ATTN_GLOBAL, mlp=MLP_MOE),),
        moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=1.5,
                      router_softcap=30.0),
        attn_softcap=30.0,
        final_softcap=30.0,
    )
