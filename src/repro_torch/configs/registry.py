"""Architecture registry: --arch <id> resolution for the ported archs.

The JAX registry knows ten architectures. The port serves those it has
modules for: the dense attention ones, the RG-LRU and SSD recurrent ones
and the two MoE ones; the rest (whisper, internvl and the other dense
and hybrid archs) raise until their modules are ported (ROADMAP Queue A:
other mixers and archs).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

# arch id -> module name
_ARCH_MODULES = {
    "recurrentgemma-9b": "recurrentgemma_9b",
    "gemma2-9b": "gemma2_9b",
    "qwen2-72b": "qwen2_72b",
    "mamba2-1.3b": "mamba2_1p3b",
    "grok-1-314b": "grok1_314b",
    "arctic-480b": "arctic_480b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def _mod(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(
            f"arch {arch!r} is not ported yet (ROADMAP Queue A: other "
            f"mixers and archs); ported: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(arch).smoke_config()
