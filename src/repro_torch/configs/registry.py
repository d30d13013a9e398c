"""Architecture registry: --arch <id> resolution, the JAX registry's ten
architectures (dense and GQA attention with RMSNorm or LayerNorm and
biases, the RG-LRU and SSD recurrent ones, the two MoE ones, the
InternVL prefix model and the Whisper encoder-decoder), and the 40-cell
(arch x shape) matrix of the dry run.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Iterator, Optional

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

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


@dataclass(frozen=True)
class Cell:
    arch: str
    shape: ShapeConfig
    skip: Optional[str] = None  # reason, if this cell is skipped by design

    @property
    def name(self) -> str:
        return f"{self.arch}:{self.shape.name}"


def cell_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """The skips the reference's matrix makes: a 500k context on an arch
    of pure full attention."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("full-attention arch: 500k context requires sub-quadratic "
                "attention (assignment: skip for pure full-attention archs)")
    return None


def cells(arch: Optional[str] = None,
          shape: Optional[str] = None) -> Iterator[Cell]:
    """All (arch x shape) cells, skip-annotated. 10 archs x 4 shapes = 40."""
    archs = [arch] if arch else list(ARCH_IDS)
    shapes = [SHAPES[shape]] if shape else list(SHAPES.values())
    for a in archs:
        cfg = get_config(a)
        for s in shapes:
            yield Cell(a, s, cell_skip_reason(cfg, s))
