"""Architecture registry: --arch <id> resolution, the JAX registry's ten
architectures (dense and GQA attention with RMSNorm or LayerNorm and
biases, the RG-LRU and SSD recurrent ones, the two MoE ones, the
InternVL prefix model and the Whisper encoder-decoder).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

# arch id -> module name
_ARCH_MODULES = {
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-tiny": "whisper_tiny",
    "gemma2-9b": "gemma2_9b",
    "qwen2-72b": "qwen2_72b",
    "starcoder2-15b": "starcoder2_15b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "grok-1-314b": "grok1_314b",
    "arctic-480b": "arctic_480b",
    "mamba2-1.3b": "mamba2_1p3b",
    "internvl2-26b": "internvl2_26b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def _mod(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(arch).smoke_config()
