"""Plain PyTorch oracle for the SSD kernel: sequential state-space recurrence.

h_t = exp(dt_t a_h) h_{t-1} + dt_t B_t (x_t)^T ;  y_t = C_t^T h_t

Line for line with ``repro/kernels/ssd/ref.py``: a Python loop over time
where JAX scans, in the kernel layout ``[B,H,S,P]``.
"""
from __future__ import annotations

import torch


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor):
    """x [B,H,S,P]; dt [B,H,S]; a [H]; b,c [B,G,S,N].

    Returns (y [B,H,S,P] f32, final state [B,H,N,P] f32).
    """
    B, H, S, P = x.shape
    G, N = b.shape[1], b.shape[3]
    rep = H // G
    bh = torch.repeat_interleave(b, rep, dim=1).float()  # [B,H,S,N]
    ch = torch.repeat_interleave(c, rep, dim=1).float()
    xf, dtf, af = x.float(), dt.float(), a.float()
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    ys = torch.empty((B, H, S, P), dtype=torch.float32, device=x.device)
    for t in range(S):
        dtt = dtf[:, :, t]                                   # [B,H]
        decay = torch.exp(dtt * af)
        xdt = xf[:, :, t] * dtt[..., None]                  # [B,H,P]
        upd = bh[:, :, t, :, None] * xdt[:, :, None, :]      # [B,H,N,P]
        h = h * decay[..., None, None] + upd
        ys[:, :, t] = torch.einsum("bhnp,bhn->bhp", h, ch[:, :, t])
    return ys, h
