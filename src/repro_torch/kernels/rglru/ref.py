"""Plain PyTorch oracle for the RG-LRU scan kernel (sequential recurrence).

Line for line with ``repro/kernels/rglru/ref.py``: a Python loop over
time where JAX scans.
"""
from __future__ import annotations

import torch


def rglru_ref(log_a: torch.Tensor, gated: torch.Tensor) -> torch.Tensor:
    """Sequential h_t = a_t h_{t-1} + sqrt(1-a_t^2) gated_t.

    log_a, gated: [B, S, W] f32 -> h [B, S, W] f32.
    """
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(-torch.expm1(2.0 * log_a), 1e-12)) * gated
    h = torch.zeros_like(a[:, 0])
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out
