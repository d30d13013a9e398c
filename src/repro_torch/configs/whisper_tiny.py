"""whisper-tiny — encoder-decoder with conv audio frontend (stub).

[arXiv:2212.04356; unverified] 4L (enc) + 4L (dec) d_model=384 6H (kv=6)
d_ff=1536 vocab=51865. The conv frontend is a stub, as in the JAX
package: the caller passes precomputed frame embeddings (``enc_frames``,
[B, frames, d_model]) to the encoder.
"""
from repro_torch.configs.base import (ATTN_GLOBAL, MLP_GELU, LayerSpec,
                                      ModelConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="audio",
        n_layers=4,
        n_enc_layers=4,
        enc_dec=True,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab_size=51_865,
        pattern=(LayerSpec(mixer=ATTN_GLOBAL, mlp=MLP_GELU),),
        norm="layernorm",
        linear_bias=True,
        rope_theta=0.0,  # learned positional embeddings instead of RoPE
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="audio",
        n_layers=2,
        n_enc_layers=2,
        enc_dec=True,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        pattern=(LayerSpec(mixer=ATTN_GLOBAL, mlp=MLP_GELU),),
        norm="layernorm",
        linear_bias=True,
        rope_theta=0.0,
    )
