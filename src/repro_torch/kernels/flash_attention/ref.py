"""Plain PyTorch oracle for the flash attention kernel (naive full softmax).

``attention_ref`` is line for line with
``repro/kernels/flash_attention/ref.py``; ``row_error`` and
``BF16_ROW_TOL`` are how the kernel is held against it.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0e38

# Limit of ``row_error`` for a bfloat16 kernel against this oracle. Both
# round the output to bf16 once, and two roundings of nearby values differ
# by at most one ulp, <= 2**-7 of the row's largest value; the kernel also
# rounds p to bf16 before p.v (<= 2**-8 relative per weight, and the
# errors of the weights average out). Two ulps at the row's largest value
# bound both.
BF16_ROW_TOL = 2.0 ** -6


def row_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over rows (every index but the last) of
    max |got - want| / max |want|: the error against the size of each
    output row, so rows of small values are held as tightly as large."""
    diff = (got.float() - want.float()).abs().amax(-1)
    size = want.float().abs().amax(-1).clamp_min(
        torch.finfo(torch.float32).tiny)
    return (diff / size).max().item()


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: int = 0,
                  cap: float = 0.0) -> torch.Tensor:
    """q: [B,H,Sq,D]; k,v: [B,Kh,Sk,D]. Returns [B,H,Sq,D] (q.dtype)."""
    b, h, sq, d = q.shape
    kh = k.shape[1]
    group = h // kh
    kk = torch.repeat_interleave(k, group, dim=1)
    vv = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * (d ** -0.5)
    if cap > 0:
        s = cap * torch.tanh(s / cap)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = torch.ones((sq, k.shape[2]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv.float()).to(q.dtype)
