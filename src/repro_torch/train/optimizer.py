"""AdamW with float32 moments, functional as JAX's.

PyTorch counterpart of ``repro/train/optimizer.py`` on one device:
``AdamWConfig``, ``lr_at`` (linear warmup), ``init_opt_state``,
``global_norm`` and ``apply_updates``, which returns new parameter and
moment tensors and leaves its inputs as they are (a background
checkpoint may still be reading them). Every step of the update is the
reference's float32 operation in its order; ``b1 ** step`` is taken in
float32, as JAX takes it. The update runs leaf by leaf, a large leaf in
slabs of rows, so its float32 temporaries stay a few GB at gemma2-9b's
vocabulary. ZeRO sharding belongs to the distributed slice; the int8
blockwise moments (``optimizer.py:56-93``) are not ported (ROADMAP Queue
A item 4).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.bridge import tree_from_leaves, tree_leaves, tree_map

Params = Dict[str, Any]

#: elements of a leaf updated at once (a slab of whole rows)
_SLAB = 1 << 27


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moments_dtype: str = "float32"   # float32 (int8: not ported)
    warmup: int = 100


def _check(cfg: AdamWConfig) -> None:
    if cfg.moments_dtype != "float32":
        raise NotImplementedError(
            f"moments_dtype {cfg.moments_dtype!r}: the int8 blockwise "
            f"moments are not ported (ROADMAP Queue A item 4)")


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp_max(step.float() / max(cfg.warmup, 1), 1.0)
    return cfg.lr * warm


def init_opt_state(params: Params, cfg: AdamWConfig) -> Params:
    _check(cfg)
    moments = tree_map(lambda p: {"m": torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device),
                                  "v": torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device)},
                       params)
    dev = tree_leaves(params)[0][1].device
    return {"moments": moments,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.float())) for _, x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _update_slab(p, g, m0, v0, scale, lr, b1c, b2c, cfg: AdamWConfig):
    """One slab of a leaf: (new p, new m, new v), JAX's float32 ops in
    JAX's order, with the temporaries released as soon as they are
    used."""
    g = g.float() * scale
    m = torch.mul(m0, cfg.b1)
    m.add_(torch.mul(g, 1 - cfg.b1))
    v = torch.mul(v0, cfg.b2)
    g.square_()
    v.add_(g.mul_(1 - cfg.b2))
    del g
    den = torch.div(v, b2c)
    den.sqrt_()
    den.add_(cfg.eps)
    upd = torch.div(m, b1c)
    upd.div_(den)
    del den
    pf = p.float()
    upd.add_(torch.mul(pf, cfg.weight_decay))
    upd.mul_(lr)
    return torch.sub(pf, upd).to(p.dtype), m, v


def apply_updates(params: Params, grads: Params, state: Params,
                  cfg: AdamWConfig) -> Tuple[Params, Params, torch.Tensor]:
    """Returns (new_params, new_state, grad_norm)."""
    _check(cfg)
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12),
                            1.0) if cfg.clip_norm > 0 else 1.0
    lr = lr_at(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def one(p, g, mo):
        if p.dim() == 0 or p.numel() <= _SLAB:
            newp, m, v = _update_slab(p, g, mo["m"], mo["v"], scale, lr,
                                      b1c, b2c, cfg)
            return newp, {"m": m, "v": v}
        newp = torch.empty_like(p)
        m, v = torch.empty_like(mo["m"]), torch.empty_like(mo["v"])
        rows = max(1, _SLAB // (p.numel() // p.shape[0]))
        for r in range(0, p.shape[0], rows):
            sl = slice(r, r + rows)
            newp[sl], m[sl], v[sl] = _update_slab(
                p[sl], g[sl], mo["m"][sl], mo["v"][sl], scale, lr, b1c, b2c,
                cfg)
        return newp, {"m": m, "v": v}

    flat_g = dict(tree_leaves(grads))
    out = {path: one(p, flat_g[path], _get(state["moments"], path))
           for path, p in tree_leaves(params)}
    new_params = tree_from_leaves({p: o[0] for p, o in out.items()})
    new_moments = tree_from_leaves({p: o[1] for p, o in out.items()})
    return new_params, {"moments": new_moments, "step": step}, gnorm


def _get(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree
