"""``attn_global``: causal GQA self-attention over every position.

RMSNorm, q/k/v projections, half-split RoPE, causal attention in which
query head h reads kv head h // (H / Kh), with the logit softcap
``cap * tanh(s / cap)``, the output projection, the residual. The
reference takes a block of queries at a time. It holds K and V for
decode in a ring of ``max_seq`` slots, with each slot's position
(``kpos``, -1 where none was written).

Work: 2 operations a weight of q, k, v and o a token; 4 Dh a visible
(query, key) pair and query head (``work/flash.py``). A decode step at
``pos`` held positions reads the K and V of ``pos + 1`` positions
(bfloat16) beside the layer's weights.
"""
from __future__ import annotations

from typing import Dict

import torch

from portbench.kinds import leaf_bytes
from portbench.reference.lm import mat, rms_norm, rope, softcap
from portbench.weights import Leaf
from portbench.work import flash

ROLE = "mixer"
Q_BLOCK = 512          # queries a block
CACHE_ITEMSIZE = 2     # the ring's K and V are bfloat16


def _dims(cfg):
    return cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], \
        cfg["head_dim"]


def leaves(cfg: dict):
    d, h, kh, dh = _dims(cfg)
    return [Leaf("norm1/w", (d,), init="norm"),
            Leaf("mixer/wq", (d, h, dh), std=d ** -0.5),
            Leaf("mixer/wk", (d, kh, dh), std=d ** -0.5),
            Leaf("mixer/wv", (d, kh, dh), std=d ** -0.5),
            Leaf("mixer/wo", (h, dh, d), std=(h * dh) ** -0.5)]


def forward(lp: Dict, x: torch.Tensor, cfg: dict, quant):
    r, s, d = x.shape
    _, h, kh, dh = _dims(cfg)
    n = rms_norm(x, lp["norm1"]["w"])
    m = lp["mixer"]
    q = rope((n @ mat(m["wq"], 1, quant)).view(r, s, h, dh),
             cfg["rope_theta"])
    k = rope((n @ mat(m["wk"], 1, quant)).view(r, s, kh, dh),
             cfg["rope_theta"])
    v = (n @ mat(m["wv"], 1, quant)).view(r, s, kh, dh)
    del n
    kk = k.repeat_interleave(h // kh, dim=2)
    vv = v.repeat_interleave(h // kh, dim=2)
    o = torch.empty_like(q)
    cap = cfg.get("attn_softcap", 0.0)
    for q0 in range(0, s, Q_BLOCK):
        q1 = min(s, q0 + Q_BLOCK)
        sc = torch.einsum("rqhd,rshd->rhqs", q[:, q0:q1], kk[:, :q1]) \
            * dh ** -0.5
        sc = softcap(sc, cap)
        qpos = torch.arange(q0, q1, device=x.device)[:, None]
        kpos = torch.arange(q1, device=x.device)[None, :]
        sc = sc.masked_fill(kpos > qpos, float("-inf"))
        o[:, q0:q1] = torch.einsum("rhqs,rshd->rqhd",
                                   torch.softmax(sc, -1), vv[:, :q1])
        del sc
    del kk, vv, q
    y = o.reshape(r, s, h * dh) @ mat(m["wo"], 2, quant)
    return x + y, {"self/k": k, "self/v": v}, {}


def held(name: str, prog: torch.Tensor, ref: torch.Tensor, length: int):
    """K and V: the ring's written slots, one vector a position."""
    if length > prog.shape[2]:
        raise ValueError(f"{length} positions overrun the "
                         f"{prog.shape[2]}-slot ring")
    return prog[:, :, :length].flatten(3), ref.flatten(3)


def exact(leaves: Dict[str, torch.Tensor], length: int) -> Dict[str, int]:
    """``kpos_mismatch``: ring slots whose recorded position is not the
    position written there."""
    bad = 0
    for name, t in leaves.items():
        if name.endswith("/kpos"):
            want = torch.full(t.shape[-1:], -1, dtype=t.dtype,
                              device=t.device)
            want[:length] = torch.arange(length, dtype=t.dtype,
                                         device=t.device)
            bad += int((t != want).sum())
    return {"kpos_mismatch": bad}


def _proj_flops(cfg: dict) -> float:
    d, h, kh, dh = _dims(cfg)
    return 2.0 * d * (2 * h + 2 * kh) * dh


def prefill_flops(cfg: dict, batch: int, s: int) -> float:
    _, h, _, dh = _dims(cfg)
    return batch * s * _proj_flops(cfg) + flash.flops(batch, s, h, dh)


def decode_flops(cfg: dict, batch: int, pos: int) -> float:
    _, h, _, dh = _dims(cfg)
    return batch * (_proj_flops(cfg) + 4.0 * dh * h * (pos + 1))


def decode_bytes(cfg: dict, batch: int, pos: int) -> float:
    _, _, kh, dh = _dims(cfg)
    return leaf_bytes(leaves(cfg)) + \
        batch * 2 * kh * dh * (pos + 1) * CACHE_ITEMSIZE
