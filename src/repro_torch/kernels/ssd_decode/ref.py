"""Plain PyTorch version of the SSD decode step: one token's state update
and read-out.

h_new = exp(dt a) h + (x dt) B^T ;  y = h_new C + x d_skip

Line for line with JAX's ``repro/models/ssm.py:ssd_decode_step``, in the
model layout, with its roundings. ``models/ssm.py`` decodes through it
with the ``interpret`` and ``jnp`` impls, and the kernel's wrapper
(``ops.py``) on a CPU tensor.
"""
from __future__ import annotations

from typing import Tuple

import torch


def ssd_decode_step(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    d_skip: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD update. h [B,H,P,N]; x [B,H,P]; dt [B,H];
    b,c [B,G,N]. Returns (y [B,H,P], h_new)."""
    G = b.shape[-2]
    rep = h.shape[1] // G
    bh = torch.repeat_interleave(b, rep, dim=-2)  # [B,H,N]
    ch = torch.repeat_interleave(c, rep, dim=-2)
    decay = torch.exp(dt * a)  # [B,H]
    xdt = x * dt[..., None].to(x.dtype)
    upd = xdt[..., :, None] * bh.to(x.dtype)[..., None, :]  # [B,H,P,N]
    h_new = h * decay[..., None, None].to(h.dtype) + upd.to(h.dtype)
    y = torch.einsum("bhpn,bhn->bhp", h_new.to(x.dtype), ch.to(x.dtype))
    y = y + x * d_skip[:, None].to(x.dtype)
    return y, h_new
