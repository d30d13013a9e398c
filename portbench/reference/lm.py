"""The plain float32 model: its ends (``top.py``) and each layer, every
part by its kind (``portbench/reference/<kind>.py``, found by name
through ``portbench/kinds.py``), and the helpers the kinds share.

It reads the configuration's numbers (``configs/<config>.json``) and the
parameter tree by name (``weights.layout``), and imports nothing of the
program. Every product runs in float32 with TF32 off (the caller's
``no_tf32``); RoPE's angles are taken in float64. Each kind computes in
blocks that fit beside the served weights.

``quant``, when given, is applied to every projection matrix ``[in,
out]`` before it is used (the control of ``check.py``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from portbench import kinds

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

EPS = 1e-6


def mat(w: torch.Tensor, n_in: int, quant: Quant) -> torch.Tensor:
    """``w`` as a float32 matrix [prod(in dims), prod(out dims)]."""
    m = w.float().reshape(math.prod(w.shape[:n_in]), -1)
    return quant(m) if quant is not None else m


def rms_norm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * \
        w.float()


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap > 0 else x


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [R, S, H, D] at positions 0..S-1, half-split."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float64,
                                   device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] \
        * freq
    sin = torch.sin(ang).float()[None, :, None, :]
    cos = torch.cos(ang).float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer(tree: Dict, r: int) -> Dict:
    return {k: _layer(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


def forward(params: Dict, cfg: dict, tokens: torch.Tensor,
            quant: Quant = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict]:
    """tokens [R, S] -> (final normed hidden [R, S, D] float32, the
    session state ``{"group0/p{i}/self/<leaf>": [reps, R, ...]}``, the
    least of each number the layers report, such as
    ``min_expert_rows``)."""
    top = kinds.top(cfg)
    x = top.embed(params, cfg, tokens)
    state: Dict[str, list] = {}
    least: Dict[str, float] = {}
    for rep in range(kinds.repeats(cfg)):
        for i, mixer, mlp in kinds.layers(cfg):
            lp = _layer(params["group0"][f"p{i}"], rep)
            for k in (mixer, mlp):
                x, st, stats = k.forward(lp, x, cfg, quant)
                for name, t in st.items():
                    state.setdefault(f"group0/p{i}/{name}", []).append(t)
                for name, v in stats.items():
                    least[name] = min(least.get(name, v), v)
    hidden = top.final(params, cfg, x)
    return hidden, {k: torch.stack(v) for k, v in state.items()}, least


def logits(params: Dict, cfg: dict, hidden: torch.Tensor,
           quant: Quant = None) -> torch.Tensor:
    """hidden [..., D] float32 -> logits [..., padded vocab] float32."""
    return kinds.top(cfg).logits(params, cfg, hidden, quant)
