"""Shape-only input stand-ins for every (arch x shape) cell.

PyTorch counterpart of ``repro/launch/specs.py``: ``meta`` tensors in
place of JAX's ``ShapeDtypeStruct``s, with the same shapes and dtypes,
allocating nothing. Modality frontends are stubs as in the reference:
``enc_frames`` / ``prefix_embeds`` are precomputed embeddings.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import DECODE, ModelConfig, ShapeConfig
from repro_torch.models import transformer as tfm


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig
                      ) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    text = s - cfg.prefix_len
    batch = {
        "tokens": _meta((b, text), torch.int32),
        "labels": _meta((b, s), torch.int32),
        "loss_mask": _meta((b, s), torch.float32),
    }
    if cfg.enc_dec:
        batch["enc_frames"] = _meta((b, s, cfg.d_model), torch.bfloat16)
    if cfg.prefix_len:
        batch["prefix_embeds"] = _meta((b, cfg.prefix_len, cfg.d_model),
                                       torch.bfloat16)
    return batch


def abstract_cache(cfg: ModelConfig, rt: tfm.ModelRuntime, batch: int,
                   enc_len: int = 0):
    """(meta cache tree, logical-axes specs) without allocation."""
    return (tfm.init_cache(cfg, rt, batch, enc_len, device="meta"),
            tfm.cache_specs(cfg, rt, batch, enc_len))


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig,
                       rt: tfm.ModelRuntime):
    b = shape.global_batch
    enc_len = shape.seq_len if cfg.enc_dec else 0
    cache, cache_specs = abstract_cache(cfg, rt, b, enc_len)
    return {
        "tokens": _meta((b,), torch.int32),
        "pos": _meta((), torch.int32),
        "cache": cache,
    }, cache_specs


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                rt: tfm.ModelRuntime) -> Tuple[Dict[str, Any], Any]:
    """Returns (specs dict, cache logical specs or None)."""
    if shape.kind == DECODE:
        return decode_input_specs(cfg, shape, rt)
    return train_batch_specs(cfg, shape), None
