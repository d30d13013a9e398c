"""``moe``: a mixture of SwiGLU experts.

RMSNorm, router logits with their softcap, softmax, the ``top_k``
largest (ties to the lower index), gates renormalised over them, each
chosen expert's ``(silu(x wg) * (x wi)) wo`` weighted by its gate, the
residual. The reference takes one expert at a time and reports the
fewest rows any expert got (``min_expert_rows``).

Work: the router's 2 D E and ``top_k`` experts' 3 x 2 D F operations a
token. A decode step of ``batch`` rows reads the router and the weights
of min(E, batch x top_k) experts: every expert that can hold a row, as
random routing of that many rows reaches them.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench.kinds import leaf_bytes
from portbench.reference.lm import mat, rms_norm, softcap
from portbench.weights import Leaf

ROLE = "mlp"


def leaves(cfg: dict):
    d, e, f = cfg["d_model"], cfg["moe"]["n_experts"], cfg["d_ff"]
    return [Leaf("norm2/w", (d,), init="norm"),
            Leaf("mlp/router", (d, e), std=d ** -0.5),
            Leaf("mlp/wi", (1, e, d, f), std=d ** -0.5),
            Leaf("mlp/wg", (1, e, d, f), std=d ** -0.5),
            Leaf("mlp/wo", (1, e, f, d), std=f ** -0.5)]


def forward(lp: Dict, x: torch.Tensor, cfg: dict, quant):
    moe = cfg["moe"]
    e, k = moe["n_experts"], moe["top_k"]
    r, s, d = x.shape
    n = rms_norm(x, lp["norm2"]["w"]).reshape(r * s, d)
    m = lp["mlp"]
    logits = softcap(n @ mat(m["router"], 1, quant),
                     moe.get("router_softcap", 0.0))
    probs = torch.softmax(logits, -1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :k], ids[:, :k]
    gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(n)
    fewest = None
    for ex in range(e):
        tok, slot = torch.nonzero(ids == ex, as_tuple=True)
        fewest = tok.numel() if fewest is None else min(fewest, tok.numel())
        if tok.numel() == 0:
            continue
        xe = n[tok]
        hi = xe @ mat(m["wi"][0, ex], 1, quant)
        hg = F.silu(xe @ mat(m["wg"][0, ex], 1, quant))
        ye = (hg * hi) @ mat(m["wo"][0, ex], 1, quant)
        del hi, hg
        out.index_add_(0, tok, ye * gates[tok, slot][:, None])
    return x + out.view(r, s, d), {}, {"min_expert_rows": fewest}


def _token_flops(cfg: dict) -> float:
    d, e, k = cfg["d_model"], cfg["moe"]["n_experts"], cfg["moe"]["top_k"]
    return 2.0 * d * e + k * 3 * 2.0 * d * cfg["d_ff"]


def prefill_flops(cfg: dict, batch: int, s: int) -> float:
    return batch * s * _token_flops(cfg)


def decode_flops(cfg: dict, batch: int, pos: int) -> float:
    return batch * _token_flops(cfg)


def decode_bytes(cfg: dict, batch: int, pos: int) -> float:
    e = cfg["moe"]["n_experts"]
    used = min(e, batch * cfg["moe"]["top_k"])
    ls = leaves(cfg)
    experts = leaf_bytes(ls[2:])
    return leaf_bytes(ls[:2]) + experts * used / e
