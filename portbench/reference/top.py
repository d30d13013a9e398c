"""``top``: the model's ends. The embedding ``in_embed`` (rows of the
padded vocabulary), the final RMSNorm and the untied head ``h @
out_embed`` with the final softcap.

Work: the head's 2 D V operations at the last position of a prompt (the
program computes no other) and at every row of a decode step, which
reads the head, the final norm and the embedding's rows of the batch.
"""
from __future__ import annotations

from typing import Dict

import torch

from portbench.reference.lm import mat, rms_norm, softcap
from portbench.weights import Leaf, padded_vocab

ROLE = "top"


def leaves(cfg: dict):
    d, vp = cfg["d_model"], padded_vocab(cfg)
    return [Leaf("in_embed", (vp, d), init="normal", std=1.0),
            Leaf("out_embed", (d, vp), std=d ** -0.5),
            Leaf("final_norm/w", (d,), init="norm")]


def embed(params: Dict, cfg: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["in_embed"][tokens].float()


def final(params: Dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, params["final_norm"]["w"])


def logits(params: Dict, cfg: dict, hidden: torch.Tensor,
           quant) -> torch.Tensor:
    return softcap(hidden @ mat(params["out_embed"], 1, quant),
                   cfg.get("final_softcap", 0.0))


def _head_flops(cfg: dict) -> float:
    return 2.0 * cfg["d_model"] * padded_vocab(cfg)


def prefill_flops(cfg: dict, batch: int, s: int) -> float:
    return batch * _head_flops(cfg)


def decode_flops(cfg: dict, batch: int, pos: int) -> float:
    return batch * _head_flops(cfg)


def decode_bytes(cfg: dict, batch: int, pos: int) -> float:
    d, vp = cfg["d_model"], padded_vocab(cfg)
    return (batch * d + d * vp + d) * 2       # bfloat16
