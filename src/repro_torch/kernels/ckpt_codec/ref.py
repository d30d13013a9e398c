"""Plain PyTorch version of the delta-int8 checkpoint codec.

It computes what ``repro/kernels/ckpt_codec/ref.py`` (the numpy oracle
that the JAX package's live checkpoint path runs) computes, bit for bit,
per tile of ``TILE`` elements:

    d = float32(new) - float32(base)
    scale = max(max|d| / 127, 1e-12)            (float32)
    q = int8(clip(round_half_even(d / scale), -127, 127))
    decode: cast(float32(base) + float32(q) * scale)

Every step is one float32 operation, rounded once, in numpy's order (no
fused multiply-add in eager PyTorch); ``torch.round`` rounds half to even
as ``np.round`` does; the cast to bfloat16 rounds to nearest even and the
cast to int32 truncates toward zero, as numpy's ``astype`` does. The
divisor 127 is a tensor, not a Python number: on a CUDA tensor PyTorch
divides by a host scalar as a multiplication by its reciprocal, which
rounds some scales one ulp away from numpy's quotient.
"""
from __future__ import annotations

import torch

TILE = 1024


def encode_ref(new: torch.Tensor, base: torch.Tensor):
    """new, base [n, TILE] (any real dtype) -> (q int8 [n, TILE], scale
    float32 [n, 1])."""
    d = new.float() - base.float()
    absmax = d.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax / absmax.new_full((), 127.0), 1e-12)
    q = torch.clamp(torch.round(d / scale), -127, 127).to(torch.int8)
    return q, scale


def decode_ref(q: torch.Tensor, scale: torch.Tensor, base: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """q int8 [n, TILE], scale float32 [n, 1], base [n, TILE] -> [n, TILE]
    in ``dtype``."""
    d = q.float() * scale
    return (base.float() + d).to(dtype)
