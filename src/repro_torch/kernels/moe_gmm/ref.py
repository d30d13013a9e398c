"""Plain PyTorch version of the grouped expert matmul (``gmm``).

It computes what ``repro/kernels/moe_gmm/ref.py::gmm_ref`` computes,
without its ``w[block_expert]`` gather, which at grok-1's shapes would
build a [~102, 6144, 32768] weight stack (about 41 GB): each run of blocks
that share an expert is one float32 ``torch.matmul`` against that expert's
[D, F] weights, rounded once to x's dtype. A block whose id is negative
(the port's layout marks trailing empty blocks -1) gives zeros.
"""
from __future__ import annotations

import torch


def gmm_ref(x_sorted: torch.Tensor, w: torch.Tensor,
            block_expert: torch.Tensor, bt: int) -> torch.Tensor:
    """x_sorted [T, D] (T a multiple of bt); w [E, D, F]; block_expert
    [T // bt] int -> [T, F] in x's dtype."""
    t = x_sorted.shape[0]
    out = torch.zeros((t, w.shape[-1]), dtype=x_sorted.dtype,
                      device=x_sorted.device)
    ids = block_expert.tolist()
    i = 0
    while i < len(ids):
        j = i
        while j < len(ids) and ids[j] == ids[i]:
            j += 1
        if ids[i] >= 0:
            rows = slice(i * bt, j * bt)
            out[rows] = (x_sorted[rows].float() @ w[ids[i]].float()) \
                .to(x_sorted.dtype)
        i = j
    return out
