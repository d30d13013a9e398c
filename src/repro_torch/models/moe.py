"""Mixture-of-experts FFN: router and expert dispatch.

PyTorch counterpart of ``repro/models/moe.py``. The parameter tree is
JAX's: ``router`` [D, E] and expert weights stored device-major, ``wi``,
``wg`` [slots, E_loc, D, F_loc] and ``wo`` [slots, E_loc, F_loc, D]
(stacked ``[reps, ...]`` in a layer group) where ``slots`` is the tp
degree: slot ``s`` owns expert group ``s // inner`` and FFN shard
``s % inner``, ``inner = max(1, tp // n_experts)``; with tp 1 this is
``[1, E, D, F]``, the logical layout. 2D expert parallelism (training,
``dp > 1``) stores ``[tp, dp, E_loc, D, F_loc]``. The expert-parallel
routes over a mesh live in ``distributed/moe_parallel.py`` (the
transformer's ``moe_fn`` hook); on one device two routes share the
router:

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
from repro_torch.obs import spans

Params = Dict[str, Any]

MOE_IMPLS = ("pallas", "interpret", "gshard")


class MoELayout(NamedTuple):
    slots: int       # total virtual slots (= tp, or tp*dp for 2D)
    inner: int       # FFN shards per expert group
    e_loc: int       # experts per slot group
    f_loc: int       # FFN hidden per slot
    dp: int = 1      # data-axis slot factor (2D expert parallelism)

    @property
    def groups(self) -> int:
        return self.slots // self.inner


def make_moe_layout(cfg: ModelConfig, tp: int = 1, dp: int = 1) -> MoELayout:
    e = cfg.moe.n_experts
    f = cfg.expert_d_ff
    slots = tp * dp
    inner = max(1, slots // e)
    groups = slots // inner
    assert slots % inner == 0 and e % groups == 0, (e, tp, dp)
    assert f % inner == 0, (f, inner)
    if dp > 1:  # inner ring must stay within one model row (ppermute axis)
        assert inner <= dp and dp % inner == 0, (inner, dp)
    return MoELayout(slots, inner, e // groups, f // inner, dp)


def can_use_2d(cfg: ModelConfig, tp: int, dp: int,
               last_axis: int = 0) -> bool:
    if cfg.moe is None or dp <= 1:
        return False
    e = cfg.moe.n_experts
    f = cfg.expert_d_ff
    slots = tp * dp
    inner = max(1, slots // e)
    groups = slots // inner
    last = last_axis or dp
    return (slots % inner == 0 and e % groups == 0 and f % inner == 0
            and inner <= last and last % inner == 0 and dp % inner == 0)


def init_moe(pb: ParamBuilder, cfg: ModelConfig, layout: MoELayout) -> None:
    d = cfg.d_model
    sl, el, fl = layout.slots, layout.e_loc, layout.f_loc
    pb.param("router", (d, cfg.moe.n_experts), (None, None), init="fan_in")
    # fan_in over shape[0], the slot axis, as JAX's ParamBuilder takes it
    if layout.dp > 1:
        # 2D expert parallelism (training): slots span model x data, the
        # weights fully resident, tokens travel (two-hop all_to_all)
        tp = sl // layout.dp
        axes = ("expert_slots", "expert_slots_dp", None, None, None)
        pb.param("wi", (tp, layout.dp, el, d, fl), axes, init="fan_in")
        pb.param("wg", (tp, layout.dp, el, d, fl), axes, init="fan_in")
        pb.param("wo", (tp, layout.dp, el, fl, d), axes, init="fan_in")
        return
    # "expert_f" is unsharded by default (no LOGICAL_RULES entry)
    pb.param("wi", (sl, el, d, fl), ("expert_slots", None, None, "expert_f"),
             init="fan_in")
    pb.param("wg", (sl, el, d, fl), ("expert_slots", None, None, "expert_f"),
             init="fan_in")
    pb.param("wo", (sl, el, fl, d), ("expert_slots", None, "expert_f", None),
             init="fan_in")


def router_probs(p: Params, x: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [..., D] -> (top-k gate weights [..., k] float32, expert ids
    [..., k] int64, full probs [..., E] float32)."""
    with spans.span(spans.MOE_ROUTE):
        logits = (x @ p["router"]).float()
        logits = softcap(logits, cfg.moe.router_softcap)
        probs = torch.softmax(logits, dim=-1)
        gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
        k = cfg.moe.top_k
        gates, ids = gates[..., :k], ids[..., :k]
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
        return gates, ids, probs


def to_logical(w: torch.Tensor, cfg: ModelConfig, layout: MoELayout,
               last_is_d: bool) -> torch.Tensor:
    """One device-major stack ``[..., slots, el, D, fl]`` (``wo``: ``[...,
    slots, el, fl, D]``) -> logical ``[..., E, D, F]`` (``[..., E, F,
    D]``); leading dims (a layer stack's ``reps``) are kept. A view when
    each group has one FFN shard (``inner`` 1)."""
    g, r, el, fl = layout.groups, layout.inner, layout.e_loc, layout.f_loc
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.expert_d_ff
    lead = tuple(w.shape[:-4])
    if last_is_d:  # [g, r, el, fl, d] -> [g, el, r, fl, d]
        w = w.reshape(lead + (g, r, el, fl, d)).transpose(-4, -3)
        return w.reshape(lead + (e, f, d))
    w = w.reshape(lead + (g, r, el, d, fl)).permute(
        *range(len(lead)), *(len(lead) + i for i in (0, 2, 3, 1, 4)))
    return w.reshape(lead + (e, d, f))


def from_logical(w: torch.Tensor, cfg: ModelConfig, layout: MoELayout,
                 last_is_d: bool) -> torch.Tensor:
    """The inverse of ``to_logical``: ``[..., E, D, F]`` -> ``[...,
    slots, el, D, fl]`` (the 4-D layout; a 2D one reshapes its slots
    into ``(tp, dp)``)."""
    g, r, el, fl = layout.groups, layout.inner, layout.e_loc, layout.f_loc
    d = cfg.d_model
    lead = tuple(w.shape[:-3])
    n = len(lead)
    if last_is_d:  # [g, el, r, fl, d] -> [g, r, el, fl, d]
        w = w.reshape(lead + (g, el, r, fl, d)).transpose(-4, -3)
        return w.reshape(lead + (layout.slots, el, fl, d))
    w = w.reshape(lead + (g, el, d, r, fl)).permute(
        *range(n), *(n + i for i in (0, 3, 1, 2, 4)))
    return w.reshape(lead + (layout.slots, el, d, fl))


def logical_expert_weights(p: Params, cfg: ModelConfig):
    """Device-major [slots, E_loc, D, F_loc] (or the 2D layout [tp, dp,
    E_loc, D, F_loc]) -> logical [E, D, F] views (copies when a group's
    FFN is split over slots)."""
    ws = [p[k] for k in ("wi", "wg", "wo")]
    if ws[0].dim() == 5:  # 2D layout: flatten (tp, dp) -> slots
        ws = [w.reshape((w.shape[0] * w.shape[1],) + tuple(w.shape[2:]))
              for w in ws]
    layout = make_moe_layout(cfg, ws[0].shape[0])
    return (to_logical(ws[0], cfg, layout, False),
            to_logical(ws[1], cfg, layout, False),
            to_logical(ws[2], cfg, layout, True))


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
    # token i's j-th choice is row i * k + j (moe.sort: with the sort
    # inside moe_ffn_sorted)
    with spans.span(spans.MOE_SORT):
        xk = flat[:, None].expand(t, k, d).reshape(t * k, d)
    y = gmm_ops.moe_ffn_sorted(xk, ids.reshape(t * k), wi, wg, wo,
                               n_experts=cfg.moe.n_experts,
                               interpret=(impl == "interpret"))
    with spans.span(spans.MOE_UNSORT):  # with the unsort before it
        g = gates.reshape(t, k, 1).to(y.dtype).float()
        out = (y.reshape(t, k, d).float() * g).sum(1)
        out = out.to(x.dtype).reshape(x.shape)
    return out, load_balance_loss(probs, ids, cfg.moe.n_experts)
