"""``ssd``: a Mamba-2 block (state-space duality).

RMSNorm, in-projections z, x, B|C, dt; ``dt = softplus(x wdt +
dt_bias)``, ``A = -exp(a_log)``; the causal depthwise conv over (x, B, C)
then SiLU; the SSD recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t
B_t^T``, ``y_t = C_t h_t + D x_t``; the gate ``y * silu(z)``, RMSNorm
over the inner width, the out-projection, the residual. The reference
scans chunk by chunk. It holds for decode the float32 state ``h`` and
the conv window of the last K - 1 inputs.

Work: 2 operations a weight of the projections, the conv's 2 C K and
the recurrence's 4 P N a token and head (``work/ssd.py``). A decode step
reads and writes each row's float32 state and bfloat16 conv window once,
beside the layer's weights.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.kinds import leaf_bytes
from portbench.reference.lm import mat, rms_norm
from portbench.weights import Leaf

ROLE = "mixer"
SSD_CHUNK = 256        # the scan's chunk


def dims(cfg: dict) -> Tuple[int, int, int, int, int, int]:
    """(d_inner, heads, head_dim, groups, d_state, conv channels)."""
    s = cfg["ssm"]
    d_inner = s["expand"] * cfg["d_model"]
    heads = d_inner // s["head_dim"]
    return (d_inner, heads, s["head_dim"], s["n_groups"], s["d_state"],
            d_inner + 2 * s["n_groups"] * s["d_state"])


def _init_a(t: torch.Tensor) -> None:
    """``a_log`` from uniform draws: A in [1, 16]."""
    t.mul_(15.0).add_(1.0).log_()


def _init_dt(t: torch.Tensor) -> None:
    """``dt_bias`` from uniform draws: softplus^-1 of dt, log-uniform in
    [1e-3, 1e-1]."""
    dt = torch.exp(t * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    t.copy_(dt + torch.log(-torch.expm1(-dt)))


def leaves(cfg: dict):
    d = cfg["d_model"]
    di, h, p, g, n, _ = dims(cfg)
    cw = cfg["ssm"]["conv_width"]
    f32 = torch.float32
    return [Leaf("norm1/w", (d,), init="norm"),
            Leaf("mixer/wz", (d, h, p), std=d ** -0.5),
            Leaf("mixer/wx", (d, h, p), std=d ** -0.5),
            Leaf("mixer/wbc", (d, 2 * g * n), std=d ** -0.5),
            Leaf("mixer/wdt", (d, h), std=d ** -0.5),
            Leaf("mixer/conv_x", (di, cw), std=cw ** -0.5),
            Leaf("mixer/conv_bc", (2 * g * n, cw), std=cw ** -0.5),
            Leaf("mixer/a_log", (h,), f32, _init_a),
            Leaf("mixer/d_skip", (h,), init="norm"),
            Leaf("mixer/dt_bias", (h,), f32, _init_dt),
            Leaf("mixer/norm_w", (h, p), init="norm"),
            Leaf("mixer/w_out", (h, p, d), std=di ** -0.5)]


def scan(x, dt, a, b, c, chunk: int = SSD_CHUNK,
             h0: Optional[torch.Tensor] = None):
    """The chunked SSD scan in float32. x [R,S,H,P]; dt [R,S,H]; a [H];
    b, c [R,S,G,N]. Returns (y [R,S,H,P], final state [R,H,P,N])."""
    r, s0, h, p = x.shape
    g, n = b.shape[-2:]
    pad = (-s0) % chunk
    if pad:  # dt = 0 rows: decay 1 and no contribution
        x, b, c = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, b, c))
        dt = F.pad(dt, (0, 0, 0, pad))
    s = s0 + pad
    nc = s // chunk
    hg = torch.arange(h, device=x.device) // (h // g)
    xdt = (x * dt[..., None]).view(r, nc, chunk, h, p)
    cs = torch.cumsum((dt * a).view(r, nc, chunk, h), dim=2)
    bh = b.view(r, nc, chunk, g, n)[:, :, :, hg]
    ch = c.view(r, nc, chunk, g, n)[:, :, :, hg]
    seg = cs.permute(0, 1, 3, 2)                     # [R,nc,H,Q]
    tri = torch.ones(chunk, chunk, dtype=torch.bool,
                     device=x.device).tril()
    lmat = torch.exp((seg[..., :, None] - seg[..., None, :])
                     .masked_fill(~tri, float("-inf")))
    cb = torch.einsum("rcihn,rcjhn->rchij", ch, bh)
    y = torch.einsum("rchij,rcjhp->rcihp", cb * lmat, xdt)
    del lmat, cb
    decay_end = torch.exp(cs[:, :, -1:, :] - cs)
    states = torch.einsum("rcjhn,rcjhp->rchpn", bh * decay_end[..., None],
                          xdt)
    chunk_decay = torch.exp(cs[:, :, -1, :])
    carry = torch.zeros(r, h, p, n, device=x.device) if h0 is None \
        else h0.float()
    prev = []
    for ci in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, ci, :, None, None] + states[:, ci]
    y = y + torch.einsum("rcihn,rchpn->rcihp", ch * torch.exp(cs)[..., None],
                         torch.stack(prev, 1))
    return y.reshape(r, s, h, p)[:, :s0], carry



def forward(lp: Dict, xin: torch.Tensor, cfg: dict, quant
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict]:
    r, s, d = xin.shape
    sc = cfg["ssm"]
    di = sc["expand"] * d
    p_, n_, g = sc["head_dim"], sc["d_state"], sc["n_groups"]
    h = di // p_
    kw = sc["conv_width"]
    m = lp["mixer"]
    nrm = rms_norm(xin, lp["norm1"]["w"])
    z = nrm @ mat(m["wz"], 1, quant)
    conv_in = torch.cat([nrm @ mat(m["wx"], 1, quant),
                         nrm @ mat(m["wbc"], 1, quant)], dim=-1)
    dt = F.softplus(nrm @ mat(m["wdt"], 1, quant) + m["dt_bias"].float())
    del nrm
    a = -torch.exp(m["a_log"].float())
    conv_w = torch.cat([mat(m["conv_x"], 1, quant),
                        mat(m["conv_bc"], 1, quant)], dim=0)   # [C, K]
    xp = F.pad(conv_in, (0, 0, kw - 1, 0))
    conv_state = xp[:, -(kw - 1):]
    conv = sum(xp[:, i:i + s] * conv_w[:, i] for i in range(kw))
    conv = F.silu(conv)
    x = conv[..., :di].reshape(r, s, h, p_)
    b = conv[..., di:di + g * n_].reshape(r, s, g, n_)
    c = conv[..., di + g * n_:].reshape(r, s, g, n_)
    del conv, conv_in, xp
    y, state = scan(x, dt, a, b, c)
    y = y + x * m["d_skip"].float()[:, None]
    y = y.reshape(r, s, di) * F.silu(z)
    y = rms_norm(y, m["norm_w"].reshape(-1))
    out = y @ mat(m["w_out"], 2, quant)
    return xin + out, {"self/h": state, "self/conv": conv_state}, {}


def _token_flops(cfg: dict) -> float:
    d = cfg["d_model"]
    di, hs, p, g, n, c = dims(cfg)
    return 2.0 * d * (2 * di + 2 * g * n + hs) + 2.0 * di * d + \
        2.0 * c * cfg["ssm"]["conv_width"] + 4.0 * hs * p * n


def prefill_flops(cfg: dict, batch: int, s: int) -> float:
    return batch * s * _token_flops(cfg)


def decode_flops(cfg: dict, batch: int, pos: int) -> float:
    return batch * _token_flops(cfg)


def decode_bytes(cfg: dict, batch: int, pos: int) -> float:
    di, hs, p, g, n, c = dims(cfg)
    state = batch * (4 * hs * p * n + 2 * (cfg["ssm"]["conv_width"] - 1) * c)
    return leaf_bytes(leaves(cfg)) + 2 * state
