"""RG-LRU recurrent block (RecurrentGemma / Griffin).

PyTorch counterpart of ``repro/models/rglru.py``:

Block: x -> { gate branch: gelu(W_gate x) ;
              rec branch:  conv1d_4(W_in x) -> RG-LRU }
       out = W_out (rglru_out * gate)

RG-LRU (per channel): r_t = sigmoid(BD_a(x_t)); i_t = sigmoid(BD_x(x_t))
  log a_t = -c * softplus(Lambda) * r_t           (c = 8)
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t)
Gate projections BD_* are block-diagonal with n_heads blocks.

``impl`` of the prefill scan: ``pallas`` the Hopper kernel
(``kernels/rglru``; its plain version on a CPU tensor), ``interpret`` the
kernel's plain version on any device, ``jnp`` ``rglru_scan`` below, a
doubling scan on tensors where JAX runs ``associative_scan``. The names
are the JAX package's, so one ``ModelRuntime`` reads the same in both.

Under the dense layout a process holds its block of the channels
(``rglru``) and of the gate blocks (``rglru_heads``): the gates, the
conv, ``lam`` and the scan run on its channels, its state is its
channels, and ``w_out``'s row block's product is summed over ``model``
(``reduce``), as GSPMD partitions JAX's layer.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamBuilder, conv1d_channels

Params = Dict[str, torch.Tensor]
C_RGLRU = 8.0


def init_rglru(pb: ParamBuilder, cfg: ModelConfig) -> None:
    d = cfg.d_model
    w = cfg.rglru.width or d
    nb = cfg.n_heads
    bs = w // nb
    pb.param("w_in", (d, w), (None, "rglru"), init="fan_in")
    pb.param("w_gate", (d, w), (None, "rglru"), init="fan_in")
    pb.param("conv_w", (w, cfg.rglru.conv_width), ("rglru", None),
             init="fan_in")
    pb.param("conv_b", (w,), ("rglru",), init="zeros")
    pb.param("bd_a", (nb, bs, bs), ("rglru_heads", None, None), init="fan_in")
    pb.param("bd_a_bias", (nb, bs), ("rglru_heads", None), init="zeros")
    pb.param("bd_x", (nb, bs, bs), ("rglru_heads", None, None), init="fan_in")
    pb.param("bd_x_bias", (nb, bs), ("rglru_heads", None), init="zeros")
    pb.param("lam", (w,), ("rglru",), init="lru_lambda")
    pb.param("w_out", (w, d), ("rglru", None), init="fan_in")


def _gates(p: Params, xr: torch.Tensor,
           nb: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-diagonal gate projections. xr: [..., W] -> (log_a, i) in f32."""
    shp = xr.shape
    xb = xr.reshape(shp[:-1] + (nb, shp[-1] // nb))
    r = torch.einsum("...hb,hbc->...hc", xb, p["bd_a"]) + p["bd_a_bias"]
    i = torch.einsum("...hb,hbc->...hc", xb, p["bd_x"]) + p["bd_x_bias"]
    r = torch.sigmoid(r.float()).reshape(shp)
    i = torch.sigmoid(i.float()).reshape(shp)
    log_a = -C_RGLRU * F.softplus(p["lam"].float()) * r
    return log_a, i


def _coeffs(log_a: torch.Tensor,
            gated: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(-torch.expm1(2.0 * log_a), 1e-12)) * gated
    return a, b


def rglru_scan(log_a: torch.Tensor, gated: torch.Tensor) -> torch.Tensor:
    """Linear recurrence h_t = a_t h_{t-1} + b_t by a doubling scan over
    time: after the round of shift k, (a_t, b_t) compose the last 2k
    steps ending at t.

    log_a, gated: [B, S, W] (f32). Returns h: [B, S, W].
    """
    av, bv = _coeffs(log_a, gated)
    s = av.shape[1]
    shift = 1
    while shift < s:
        bv = torch.cat([bv[:, :shift], bv[:, shift:] +
                        av[:, shift:] * bv[:, :-shift]], dim=1)
        av = torch.cat([av[:, :shift], av[:, shift:] * av[:, :-shift]],
                       dim=1)
        shift *= 2
    return bv


def apply_rglru(p: Params, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Params] = None, impl: str = "pallas",
                return_state: bool = False,
                reduce: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: [B,S,D]. state (decode): {'h': [B,W], 'conv': [B,K-1,W]}, W the
    channels ``p`` holds (all of them, or with ``reduce``, the sum over
    ``model``, this process's block).

    Returns (y [B,S,D], new_state or None).
    """
    nb = p["bd_a"].shape[0]  # the gate blocks this process holds
    k = cfg.rglru.conv_width
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    xr = x @ p["w_in"]
    conv_carry = None if state is None else state["conv"]
    new_conv = None
    if state is not None or return_state:
        prev = conv_carry if conv_carry is not None else \
            xr.new_zeros(xr.shape[:1] + (k - 1, xr.shape[-1]))
        new_conv = torch.cat([prev.to(xr.dtype), xr], dim=1)[:, -(k - 1):]
    xr = conv1d_channels(xr, p["conv_w"], conv_carry) + p["conv_b"]
    log_a, i = _gates(p, xr, nb)
    gated = i * xr.float()

    if state is None:  # prefill over the full sequence
        from repro_torch.kernels.rglru import ops as rg_ops
        if impl == "pallas":
            h = rg_ops.rglru(log_a, gated, block=cfg.rglru.block_width)
        elif impl == "interpret":
            h = rg_ops.reference(log_a, gated)
        elif impl == "jnp":
            h = rglru_scan(log_a, gated)
        else:
            raise ValueError(f"rglru_impl {impl!r}: use 'pallas', "
                             f"'interpret' or 'jnp'")
        new_state = {"h": h[:, -1], "conv": new_conv} if return_state \
            else None
        y = h.to(x.dtype)
    else:  # single-step decode: S == 1
        a, b = _coeffs(log_a[:, 0], gated[:, 0])
        h1 = a * state["h"] + b
        new_state = {"h": h1, "conv": new_conv}
        y = h1[:, None].to(x.dtype)
    y = (y * gate.to(y.dtype)) @ p["w_out"]
    if reduce is not None:
        y = reduce(y)
    return y, new_state


def init_rglru_state(cfg: ModelConfig, batch: int, device) -> Params:
    w = cfg.rglru.width or cfg.d_model
    k = cfg.rglru.conv_width
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, k - 1, w), dtype=torch.bfloat16,
                                device=device)}
