"""Mamba2 SSD (state-space duality) blocks.

PyTorch counterpart of ``repro/models/ssm.py``:

Block: in_proj -> (z, x, B, C, dt); causal conv over (x,B,C); SSD scan;
gated RMSNorm; out_proj. ``ssd_chunked`` is the chunked algorithm from
arXiv:2405.21060 (intra-chunk quadratic term + inter-chunk state
recurrence), as JAX writes it.

Shapes: x [B,S,H,P], dt [B,S,H], A [H] (negative), B/C [B,S,G,N] (G groups
broadcast over heads).

``impl`` of the prefill scan: ``pallas`` the Hopper kernel
(``kernels/ssd``; its plain version on a CPU tensor), ``interpret`` the
kernel's plain version on any device, ``jnp`` ``ssd_chunked``.

JAX's einsums with ``preferred_element_type=jnp.float32`` sum products of
bf16 operands in float32 without rounding the result; torch has no such
flag, so those products are taken over float32 casts of the operands
(exact: a bf16 product fits in float32). The other einsums round their
result to the operands' dtype, as JAX's do.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamBuilder, conv1d_channels, rms_norm

Params = Dict[str, torch.Tensor]


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    sc = cfg.ssm
    d_inner = sc.expand * cfg.d_model
    n_heads = d_inner // sc.head_dim
    return d_inner, n_heads, sc.head_dim, sc.n_groups, sc.d_state


def init_ssd(pb: ParamBuilder, cfg: ModelConfig) -> None:
    d = cfg.d_model
    d_inner, h, p_, g, n = ssm_dims(cfg)
    cw = cfg.ssm.conv_width
    pb.param("wz", (d, h, p_), init="fan_in")
    pb.param("wx", (d, h, p_), init="fan_in")
    pb.param("wbc", (d, 2 * g * n), init="fan_in")
    pb.param("wdt", (d, h), init="fan_in")
    pb.param("conv_x", (d_inner, cw), init="fan_in")
    pb.param("conv_bc", (2 * g * n, cw), init="fan_in")
    pb.param("a_log", (h,), init="ssm_a")
    pb.param("d_skip", (h,), init="ones")
    pb.param("dt_bias", (h,), init="ssm_dt")
    pb.param("norm_w", (h, p_), init="ones")
    pb.param("w_out", (h, p_, d), init="fan_in")


def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """log_a [..., Q] -> L [..., Q, Q] with L[i,j] = sum_{k=j+1..i} log_a_k
    for i>=j, else -inf."""
    q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # [., i, j] = cs_i - cs_j
    idx = torch.arange(q, device=log_a.device)
    mask = idx[:, None] >= idx[None, :]
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x [B,S,H,P]; dt [B,S,H] (f32, post-softplus); a [H] (negative, f32);
    b,c [B,S,G,N]; h0 optional initial state [B,H,P,N].
    Returns (y [B,S,H,P], final_state [B,H,P,N]).
    """
    B_, S, H, P = x.shape
    G, N = b.shape[-2], b.shape[-1]
    q = min(chunk, S)
    s_orig = S
    if S % q:  # pad tail: dt=0 rows are exact no-ops (decay 1, contribution 0)
        pad = q - S % q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
        S = S + pad
    nc = S // q
    rep = H // G
    dtype = x.dtype

    da = dt * a  # [B,S,H] negative decay logs
    xdt = x * dt[..., None].to(dtype)

    xc = xdt.reshape(B_, nc, q, H, P)
    dac = da.reshape(B_, nc, q, H)
    bh = torch.repeat_interleave(b.reshape(B_, nc, q, G, N), rep, dim=-2)
    ch = torch.repeat_interleave(c.reshape(B_, nc, q, G, N), rep, dim=-2)

    # --- intra-chunk (quadratic within chunk) ---
    L = torch.exp(_segsum(dac.permute(0, 1, 3, 2)))  # [B,nc,H,q,q]
    scores = torch.einsum("bciht,bcjht->bchij", ch.float(), bh.float())
    y_intra = torch.einsum("bchij,bcjhp->bcihp", (scores * L).to(dtype), xc)

    # --- chunk summaries: state contribution of each chunk ---
    cs = torch.cumsum(dac, dim=2)  # [B,nc,q,H]
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)  # [B,nc,q,H]
    states = torch.einsum("bcqht,bcqhp->bchpt",
                          (bh * decay_to_end[..., None]).to(dtype), xc)

    # --- inter-chunk recurrence ---
    chunk_decay = torch.exp(dac.sum(dim=2))  # [B,nc,H]
    carry = torch.zeros((B_, H, P, N), dtype=torch.float32,
                        device=x.device) if h0 is None else h0.float()
    prev = []
    for ci in range(nc):  # emit the state *before* each chunk
        prev.append(carry)
        carry = carry * chunk_decay[:, ci, :, None, None] + \
            states[:, ci].float()
    prev_states = torch.stack(prev, dim=1)  # [B,nc,H,P,N]

    # --- inter-chunk output: y_i += C_i . (decay_in * prev_state) ---
    decay_in = torch.exp(cs)  # [B,nc,q,H]
    y_inter = torch.einsum("bcqht,bchpt->bcqhp",
                           (ch * decay_in[..., None]).to(dtype),
                           prev_states.to(dtype))
    y = (y_intra + y_inter).reshape(B_, S, H, P)[:, :s_orig]
    return y, carry


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


def apply_ssd(p: Params, xin: torch.Tensor, cfg: ModelConfig,
              state: Optional[Params] = None, impl: str = "pallas",
              return_state: bool = False
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """xin [B,S,D]. state (decode): {'h': [B,H,P,N], 'conv': [B,K-1,Cc]}."""
    d_inner, H, P, G, N = ssm_dims(cfg)
    B_, S, D = xin.shape
    cw = cfg.ssm.conv_width
    z = (xin @ p["wz"].reshape(D, H * P)).reshape(B_, S, H, P)
    x = xin @ p["wx"].reshape(D, d_inner)
    bcb = xin @ p["wbc"]
    dt_raw = (xin @ p["wdt"]).float()
    dt = F.softplus(dt_raw + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())

    conv_in = torch.cat([x, bcb], dim=-1)  # [B,S,Cc]
    conv_w = torch.cat([p["conv_x"], p["conv_bc"]], dim=0)
    carry = None if state is None else state["conv"]
    new_conv = None
    if state is not None or return_state:
        prev = carry if carry is not None else \
            conv_in.new_zeros((B_, cw - 1, conv_in.shape[-1]))
        new_conv = torch.cat([prev.to(conv_in.dtype), conv_in],
                             dim=1)[:, -(cw - 1):]
    conv_out = F.silu(conv1d_channels(conv_in, conv_w, carry))
    x = conv_out[..., :d_inner].reshape(B_, S, H, P)
    b = conv_out[..., d_inner:d_inner + G * N].reshape(B_, S, G, N)
    c = conv_out[..., d_inner + G * N:].reshape(B_, S, G, N)

    if state is None:
        from repro_torch.kernels.ssd import ops as ssd_ops
        if impl == "pallas":
            y, h_fin = ssd_ops.ssd(x, dt, a, b, c, chunk=cfg.ssm.chunk_size)
        elif impl == "interpret":
            y, h_fin = ssd_ops.reference(x, dt, a, b, c)
        elif impl == "jnp":
            y, h_fin = ssd_chunked(x, dt, a, b, c, cfg.ssm.chunk_size)
        else:
            raise ValueError(f"ssd_impl {impl!r}: use 'pallas', "
                             f"'interpret' or 'jnp'")
        y = y + x * p["d_skip"].to(x.dtype)[:, None]
        new_state = {"h": h_fin, "conv": new_conv} if return_state else None
    else:
        y1, h_new = ssd_decode_step(state["h"], x[:, 0], dt[:, 0], a,
                                    b[:, 0], c[:, 0], p["d_skip"])
        y = y1[:, None]
        new_state = {"h": h_new, "conv": new_conv}

    y = y * F.silu(z.float()).to(y.dtype)
    y = rms_norm(y.reshape(B_, -1, H * P),
                 p["norm_w"].reshape(-1)).reshape(y.shape)
    out = y.reshape(B_, -1, H * P) @ p["w_out"].reshape(H * P, D)
    return out, new_state


def init_ssd_state(cfg: ModelConfig, batch: int, device) -> Params:
    d_inner, H, P, G, N = ssm_dims(cfg)
    cc = d_inner + 2 * G * N
    return {"h": torch.zeros((batch, H, P, N), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm.conv_width - 1, cc),
                                dtype=torch.bfloat16, device=device)}
