"""Mixture-of-experts FFN: router and expert dispatch.

PyTorch counterpart of ``repro/models/moe.py`` on one device (tp=1). The
parameter tree is JAX's: ``router`` [D, E] and expert weights ``wi``,
``wg`` [slots=1, E, D, F] and ``wo`` [1, E, F, D] (stacked
``[reps, 1, E, ...]`` in a layer group). Two routes share the router:

* ``apply_moe`` (``moe_impl`` "pallas" or "interpret"): each token is
  flattened ``top_k`` times, routed through ``moe_ffn_sorted`` (the grouped
  matmul kernel, or its plain version), and the ``top_k`` outputs are
  combined with the gates as gshard rounds them: gates cast to y's dtype,
  the products summed in float32, rounded once;
* ``apply_moe_gshard`` (``moe_impl`` "gshard"): the dense oracle, every
  expert for every token, weighted by the combine weights. It loops over
  experts, so no [E, D, F] stack is copied or gathered.

Top-k ties: the router logits are rounded to bf16 before the float32
softmax, so equal probabilities happen among 8 or 128 experts.
``jax.lax.top_k`` keeps the lower index first; ``torch.topk`` promises no
order, so ``router_probs`` takes the first k of a stable descending sort.
Both return the Switch-style load-balance loss beside the output, as
JAX's ``apply_moe_gshard`` does; the transformer sums it over the layers
as the training loss's ``aux``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.models.layers import ParamBuilder, softcap

Params = Dict[str, Any]

MOE_IMPLS = ("pallas", "interpret", "gshard")


class MoELayout(NamedTuple):
    """JAX's fields; on one device slots = inner = 1."""
    slots: int       # total virtual slots (= tp)
    inner: int       # FFN shards per expert group
    e_loc: int       # experts per slot group
    f_loc: int       # FFN hidden per slot


def make_moe_layout(cfg: ModelConfig, tp: int = 1) -> MoELayout:
    """The single-device layout: one slot holding every expert."""
    if tp != 1:
        raise NotImplementedError(
            f"MoE with tp={tp}: expert sharding is not ported (ROADMAP "
            f"Queue A: distributed)")
    return MoELayout(1, 1, cfg.moe.n_experts, cfg.expert_d_ff)


def init_moe(pb: ParamBuilder, cfg: ModelConfig, layout: MoELayout) -> None:
    d = cfg.d_model
    sl, el, fl = layout.slots, layout.e_loc, layout.f_loc
    pb.param("router", (d, cfg.moe.n_experts), init="fan_in")
    # fan_in over shape[0], the slot axis, as JAX's ParamBuilder takes it
    pb.param("wi", (sl, el, d, fl), init="fan_in")
    pb.param("wg", (sl, el, d, fl), init="fan_in")
    pb.param("wo", (sl, el, fl, d), init="fan_in")


def router_probs(p: Params, x: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [..., D] -> (top-k gate weights [..., k] float32, expert ids
    [..., k] int64, full probs [..., E] float32)."""
    logits = (x @ p["router"]).float()
    logits = softcap(logits, cfg.moe.router_softcap)
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    gates, ids = gates[..., :k], ids[..., :k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, ids, probs


def logical_expert_weights(p: Params, cfg: ModelConfig):
    """Device-major [1, E, D, F] -> logical [E, D, F] views (tp=1)."""
    ws = tuple(p[k] for k in ("wi", "wg", "wo"))
    if any(w.dim() != 4 or w.shape[0] != 1 for w in ws):
        raise NotImplementedError(
            f"expert weights {[tuple(w.shape) for w in ws]}: only the "
            f"single-slot layout [1, E, ...] is ported (ROADMAP Queue A: "
            f"distributed)")
    return tuple(w[0] for w in ws)


def _combine_weights(gates: torch.Tensor, ids: torch.Tensor,
                     n_experts: int) -> torch.Tensor:
    """[..., E] float32: each token's gate on its top-k experts, else 0."""
    comb = torch.zeros(ids.shape[:-1] + (n_experts,), dtype=torch.float32,
                       device=gates.device)
    return comb.scatter_add_(-1, ids, gates.float())


def load_balance_loss(probs: torch.Tensor, ids: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary load-balancing loss (float32 scalar)."""
    me = probs.reshape(-1, n_experts).mean(0)
    assign = F.one_hot(ids.reshape(-1), n_experts).float().mean(0) * \
        ids.shape[-1]
    return n_experts * torch.sum(me * assign)


def apply_moe_gshard(p: Params, x: torch.Tensor, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense all-experts oracle, x [B,S,D] -> ([B,S,D], aux), JAX's rounding: h,
    g and y of each expert in x's dtype, silu in x's dtype, then the
    experts' outputs weighted by the combine weights (cast to y's dtype)
    and summed in float32, rounded once."""
    wi, wg, wo = logical_expert_weights(p, cfg)
    gates, ids, probs = router_probs(p, x, cfg)
    comb = _combine_weights(gates, ids, cfg.moe.n_experts).to(x.dtype)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(cfg.moe.n_experts):
        h = x @ wi[e]
        h = F.silu(x @ wg[e]) * h
        acc += (h @ wo[e]).float() * comb[..., e:e + 1].float()
    return acc.to(x.dtype), load_balance_loss(probs, ids, cfg.moe.n_experts)


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig,
              impl: str = "pallas") -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,D] -> ([B,S,D], aux). impl: pallas (sorted route through the
    grouped matmul kernel), interpret (the same route through its plain
    version) or gshard (the dense oracle)."""
    if impl not in MOE_IMPLS:
        raise ValueError(f"moe_impl {impl!r} not in {MOE_IMPLS}")
    if impl == "gshard":
        return apply_moe_gshard(p, x, cfg)
    wi, wg, wo = logical_expert_weights(p, cfg)
    gates, ids, probs = router_probs(p, x, cfg)
    k = cfg.moe.top_k
    d = x.shape[-1]
    flat = x.reshape(-1, d)
    t = flat.shape[0]
    # token i's j-th choice is row i * k + j
    xk = flat[:, None].expand(t, k, d).reshape(t * k, d)
    y = gmm_ops.moe_ffn_sorted(xk, ids.reshape(t * k), wi, wg, wo,
                               n_experts=cfg.moe.n_experts,
                               interpret=(impl == "interpret"))
    g = gates.reshape(t, k, 1).to(y.dtype).float()
    out = (y.reshape(t, k, d).float() * g).sum(1)
    return out.to(x.dtype).reshape(x.shape), \
        load_balance_loss(probs, ids, cfg.moe.n_experts)
