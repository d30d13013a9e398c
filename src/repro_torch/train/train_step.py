"""Train step: chunked cross-entropy, microbatch accumulation, remat,
AdamW.

PyTorch counterpart of ``repro/train/train_step.py`` on one device. The
cross-entropy never materialises [B, S, V] logits: the sequence is cut
into chunks of ``ce_chunk`` positions (halved until it divides S), each
chunk's logits are computed, softcapped in float32, masked to -1e30 on
the padded vocabulary columns and reduced to a log-sum-exp, under
``torch.utils.checkpoint`` as JAX's chunk body is under
``jax.checkpoint``, so the backward pass recomputes one chunk's logits at
a time. Gradients come from autograd through the plain PyTorch routes
(``transformer.check_trainable``); with ``microbatches`` > 1 they are
accumulated in float32 and averaged, as JAX's scan does.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.bridge import tree_from_leaves, tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import softcap
from repro_torch.train import optimizer as opt

Params = Dict[str, Any]

AUX_WEIGHT = 0.01  # MoE load-balance loss weight


def _ce_chunk(h, out_embed, lbl, msk, vocab_valid, cap: float):
    logits = h @ out_embed
    logits = softcap(logits.float(), cap)
    logits = torch.where(vocab_valid, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    lbl_logit = torch.gather(logits, -1, lbl[..., None].long())[..., 0]
    nll = (lse - lbl_logit) * msk
    return nll.sum(), msk.sum()


def chunked_ce_loss(hidden: torch.Tensor, out_embed: torch.Tensor,
                    labels: torch.Tensor, mask: torch.Tensor,
                    cfg: ModelConfig, chunk: int = 512
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden [B,S,D]; labels/mask [B,S]. Returns (sum_nll, sum_mask),
    float32 scalars summed chunk by chunk in sequence order."""
    s = hidden.shape[1]
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    vocab_valid = torch.arange(out_embed.shape[-1],
                               device=hidden.device) < cfg.vocab_size
    nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    msk_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(s // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        nll, msk = torch.utils.checkpoint.checkpoint(
            _ce_chunk, hidden[:, sl], out_embed, labels[:, sl],
            mask[:, sl], vocab_valid, cfg.final_softcap, use_reentrant=False)
        nll_sum = nll_sum + nll
        msk_sum = msk_sum + msk
    return nll_sum, msk_sum


def make_loss_fn(cfg: ModelConfig, rt: tfm.ModelRuntime,
                 ce_chunk: int = 512) -> Callable:
    def loss_fn(params: Params, batch: Dict[str, torch.Tensor]):
        hidden, _, aux = tfm.forward(params, cfg, rt, batch["tokens"])
        nll_sum, msk_sum = chunked_ce_loss(
            hidden, params["out_embed"], batch["labels"], batch["loss_mask"],
            cfg, ce_chunk)
        loss = nll_sum / torch.clamp_min(msk_sum, 1.0) + AUX_WEIGHT * aux
        return loss, {"nll": nll_sum, "ntok": msk_sum, "aux": aux}

    return loss_fn


def _grad_fn(loss_fn: Callable):
    """(params, batch) -> (grads in the params' dtypes, metrics)."""
    def grad_fn(params: Params, batch):
        leaves = tree_leaves(params)
        live = {path: t.detach().requires_grad_() for path, t in leaves}
        loss, metrics = loss_fn(tree_from_leaves(live), batch)
        grads = torch.autograd.grad(loss, list(live.values()),
                                    allow_unused=True)
        out = {path: torch.zeros_like(t) if g is None else g
               for (path, t), g in zip(live.items(), grads)}
        return tree_from_leaves(out), {k: v.detach()
                                       for k, v in metrics.items()}
    return grad_fn


def make_train_step(cfg: ModelConfig, rt: tfm.ModelRuntime,
                    adamw: opt.AdamWConfig, microbatches: int = 1,
                    ce_chunk: int = 512, accum_dtype=torch.float32):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). batch: numpy arrays or tensors, dims [global_batch, ...],
    moved to the parameters' device."""
    tfm.check_trainable(cfg, rt)
    grad_fn = _grad_fn(make_loss_fn(cfg, rt, ce_chunk))

    def train_step(params: Params, opt_state: Params, batch):
        dev = tree_leaves(params)[0][1].device
        batch = {k: torch.as_tensor(np.asarray(v) if not
                                    isinstance(v, torch.Tensor) else v,
                                    device=dev)
                 for k, v in batch.items()}
        if microbatches == 1:
            grads, metrics = grad_fn(params, batch)
        else:
            n = next(iter(batch.values())).shape[0] // microbatches
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                                   device=p.device), params)
            metrics = {k: torch.zeros((), dtype=torch.float32, device=dev)
                       for k in ("nll", "ntok", "aux")}
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                g, m = grad_fn(params, mb)
                grads = _tree_zip(lambda a, b_: a + b_.to(accum_dtype),
                                  grads, g)
                metrics = {k: metrics[k] + m[k] for k in metrics}
                del g
            grads = tree_map(lambda g: g / microbatches, grads)

        new_params, new_state, gnorm = opt.apply_updates(
            params, grads, opt_state, adamw)
        loss = metrics["nll"] / torch.clamp_min(metrics["ntok"], 1.0)
        out_metrics = {"loss": loss, "grad_norm": gnorm,
                       "aux": metrics["aux"],
                       "step": new_state["step"].float()}
        return new_params, new_state, out_metrics

    return train_step


def _tree_zip(fn: Callable, a, b):
    if isinstance(a, dict):
        return {k: _tree_zip(fn, a[k], b[k]) for k in a}
    return fn(a, b)
