"""Train step: chunked cross-entropy, microbatch accumulation, remat,
AdamW.

PyTorch counterpart of ``repro/train/train_step.py``. The
cross-entropy never materialises [B, S, V] logits: the sequence is cut
into chunks of ``ce_chunk`` positions (halved until it divides S), each
chunk's logits are computed, softcapped in float32, masked to -1e30 on
the padded vocabulary columns and reduced to a log-sum-exp, under
``torch.utils.checkpoint`` as JAX's chunk body is under
``jax.checkpoint``, so the backward pass recomputes one chunk's logits at
a time. Gradients come from autograd through the plain PyTorch routes
(``transformer.check_trainable``); with ``microbatches`` > 1 they are
accumulated in ``accum_dtype`` and averaged, as JAX's scan does (a
DTensor parameter's gradient on its block).

On a mesh (``rt.layout``) each process is handed the whole batch and
runs its rows of it (of each microbatch: microbatch i is the global rows
JAX's reshape gives it, so the loss of each is JAX's) on its blocks of
the parameters, in one ``Layout.run``: the cross-entropy reduces its
log-sum-exp over the vocabulary blocks (a ``pmax``, then a ``psum``; the
label's logit from the block that holds it) and the loss is the masked
mean over the global batch (the sums ``psum``-ed over the batch axes).
Autograd through the collectives and the shard_map's boundary reduces
each gradient over the batch axes (``distributed/compat.py``), so every
gradient is JAX's global one on this process's block. ``zero1_plan``
lays the AdamW moments out as JAX's ``opt_state_specs`` under
``tree_shardings(..., zero1=True)`` (``train/optimizer.py``).

``grad_shardings`` (JAX's argument; ``zero2_shardings`` gives the
port's) is ZeRO-2: each gradient reaches the optimizer, and the
microbatch accumulator holds it, as this process's block under
``tree_shardings(..., zero1=True)``: a parameter the layout's FSDP cut
already cuts so gets its block from the gather's backward, any other one
from a reduce-scatter at the boundary (``compat.GradBlock``) where the
psum would make it whole. The accumulator is kept in ``accum_dtype``
(JAX's dry run: bf16 above 4e11 parameters).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.bridge import tree_from_leaves, tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.compat import (GradBlock, P, bind_mesh,
                                            from_local, like_sharded,
                                            local_block, local_of, pmax,
                                            psum)
from repro_torch.distributed.mesh import batch_axes
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import softcap
from repro_torch.train import optimizer as opt

Params = Dict[str, Any]

AUX_WEIGHT = 0.01  # MoE load-balance loss weight


def _ce_chunk(h, out_embed, lbl, msk, vocab_valid, cap: float, v0: int,
              sharded: bool):
    """One chunk's (sum nll, sum mask). ``sharded``: ``out_embed`` holds
    the vocabulary columns from ``v0``, and the log-sum-exp and the
    label's logit are reduced over ``model``."""
    logits = h @ out_embed
    logits = softcap(logits.float(), cap)
    logits = torch.where(vocab_valid, logits, -1e30)
    if not sharded:
        lse = torch.logsumexp(logits, dim=-1)
        lbl_logit = torch.gather(logits, -1, lbl[..., None].long())[..., 0]
    else:
        n = logits.shape[-1]
        m = pmax(logits.detach().amax(dim=-1), "model")
        lse = m + torch.log(psum(torch.exp(logits - m[..., None]).sum(-1),
                                 "model"))
        local = lbl.long() - v0
        mine = (local >= 0) & (local < n)
        pick = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])
        lbl_logit = psum(torch.where(mine, pick[..., 0], 0.0), "model")
    nll = (lse - lbl_logit) * msk
    return nll.sum(), msk.sum()


def chunked_ce_loss(hidden: torch.Tensor, out_embed: torch.Tensor,
                    labels: torch.Tensor, mask: torch.Tensor,
                    cfg: ModelConfig, chunk: int = 512, layout=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden [B,S,D]; labels/mask [B,S]. Returns (sum_nll, sum_mask),
    float32 scalars summed chunk by chunk in sequence order. With
    ``layout`` (inside its ``run``) ``out_embed`` is this process's
    vocabulary block when the layout cuts ``vocab``."""
    s = hidden.shape[1]
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    n = out_embed.shape[-1]
    sharded = layout is not None and layout.cuts("vocab", cfg.padded_vocab)
    v0 = layout.model_index() * n if sharded else 0
    vocab_valid = torch.arange(v0, v0 + n,
                               device=hidden.device) < cfg.vocab_size
    nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    msk_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(s // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        nll, msk = torch.utils.checkpoint.checkpoint(
            bind_mesh(_ce_chunk), hidden[:, sl], out_embed, labels[:, sl],
            mask[:, sl], vocab_valid, cfg.final_softcap, v0, sharded,
            use_reentrant=False)
        nll_sum = nll_sum + nll
        msk_sum = msk_sum + msk
    return nll_sum, msk_sum


def make_loss_fn(cfg: ModelConfig, rt: tfm.ModelRuntime,
                 ce_chunk: int = 512) -> Callable:
    lay = rt.layout

    def body(params: Params, batch: Dict[str, torch.Tensor]):
        params = tfm.gather_top(params, cfg, rt)
        hidden, _, aux = tfm.forward(
            params, cfg, rt, batch["tokens"],
            prefix_embeds=batch.get("prefix_embeds"),
            enc_frames=batch.get("enc_frames"))
        nll_sum, msk_sum = chunked_ce_loss(
            hidden, params["out_embed"], batch["labels"], batch["loss_mask"],
            cfg, ce_chunk, layout=lay)
        if lay is not None:  # the global batch's sums
            baxes = batch_axes(lay.mesh)
            nll_sum, msk_sum = psum(nll_sum, baxes), psum(msk_sum, baxes)
        loss = nll_sum / torch.clamp_min(msk_sum, 1.0) + AUX_WEIGHT * aux
        return loss, {"nll": nll_sum, "ntok": msk_sum, "aux": aux}

    if lay is None:
        return body

    def loss_fn(params: Params, batch: Dict[str, torch.Tensor]):
        b = batch["tokens"].shape[0]
        rows = lay.row_entry(b)
        bspecs = {k: P(rows, *([None] * (v.dim() - 1)))
                  for k, v in batch.items()}
        return lay.run(body, (params, batch),
                       (lay.specs(params, tfm.param_specs(cfg, rt)), bspecs),
                       (P(), dict.fromkeys(("nll", "ntok", "aux"), P())))

    return loss_fn


def zero1_plan(cfg: ModelConfig, rt: tfm.ModelRuntime,
               adamw: opt.AdamWConfig, grad_shardings=None
               ) -> Optional[opt.Zero1]:
    """The AdamW moments' layout on ``rt.layout``'s mesh (None without
    one): each leaf's moments laid out as JAX's ``opt_state_specs`` under
    ``tree_shardings(..., zero1=True)``, so they are also cut over the
    batch axes (ZeRO-1); int8 codes and their scales are cut on the same
    dim, never inside a quantisation block. The gradients arrive laid out
    as ``grad_shardings`` (ZeRO-2), or as the parameters."""
    lay = rt.layout
    if lay is None:
        return None
    from repro_torch.distributed import sharding as shd
    shapes, specs = tfm.abstract_params(cfg, rt)
    ostate = opt.init_opt_state(shapes, adamw)
    ospecs = opt.opt_state_specs(specs, adamw)
    moment = shd.layout_shardings(ostate["moments"], ospecs["moments"],
                                  lay.mesh, lay.overrides, zero1=True)
    if adamw.moments_dtype == "int8":
        moment = opt.int8_zero1(moment)
    param = dict(tree_leaves(lay.specs(shapes, specs)))
    grad = param if grad_shardings is None else \
        dict(tree_leaves(shd._spec_tree(grad_shardings)))
    return opt.Zero1(lay.mesh, param,
                     {path: ns.spec for path, ns in tree_leaves(moment)},
                     {path: tuple(t.shape) for path, t in tree_leaves(shapes)},
                     grad)


def zero2_shardings(cfg: ModelConfig, rt: tfm.ModelRuntime):
    """The port's ``grad_shardings`` (ZeRO-2): JAX's ``tree_shardings(
    params, specs, mesh, zero1=True)`` under ``rt.layout`` (its overrides,
    the recurrent mixers' widths whole)."""
    from repro_torch.distributed import sharding as shd
    lay = rt.layout
    shapes, specs = tfm.abstract_params(cfg, rt)
    return shd.layout_shardings(shapes, specs, lay.mesh, lay.overrides,
                                zero1=True)


def _grad_fn(loss_fn: Callable, zero: Optional[opt.Zero1] = None):
    """(params, batch) -> (grads in the params' dtypes, metrics). With
    ``zero`` each gradient is its block under ``zero.grad``: a parameter
    laid out otherwise enters the loss as a ``GradBlock``."""
    def leaf(path, t):
        t = t.detach()
        cut = None if zero is None else zero.grad_cut(path, t.dim())
        if cut is None:
            return t.requires_grad_(), t
        d, axes = cut
        blk = local_block(local_of(t), opt.cut_spec(d, axes), zero.mesh)
        blk = from_local(blk, zero.grad[path], zero.mesh).requires_grad_()
        return blk, GradBlock(t, blk)

    def grad_fn(params: Params, batch):
        both = {path: leaf(path, t) for path, t in tree_leaves(params)}
        live = {path: b[0] for path, b in both.items()}
        loss, metrics = loss_fn(tree_from_leaves(
            {path: b[1] for path, b in both.items()}), batch)
        grads = torch.autograd.grad(loss, list(live.values()),
                                    allow_unused=True)
        out = {path: torch.zeros_like(t) if g is None else g
               for (path, t), g in zip(live.items(), grads)}
        return tree_from_leaves(out), {k: v.detach()
                                       for k, v in metrics.items()}
    return grad_fn


def make_train_step(cfg: ModelConfig, rt: tfm.ModelRuntime,
                    adamw: opt.AdamWConfig, microbatches: int = 1,
                    ce_chunk: int = 512, grad_shardings=None,
                    accum_dtype=torch.float32):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). batch: numpy arrays or tensors, dims [global_batch, ...],
    moved to the parameters' device. On a mesh the optimizer state is
    ``init_opt_state(params, adamw, zero=zero1_plan(cfg, rt, adamw))``.
    ``grad_shardings``: each gradient, and the accumulator, as its block
    of these NamedShardings (ZeRO-2; ``zero2_shardings``)."""
    tfm.check_trainable(cfg, rt)
    zero = zero1_plan(cfg, rt, adamw, grad_shardings)
    grad_fn = _grad_fn(make_loss_fn(cfg, rt, ce_chunk), zero)

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
            grads = None
            metrics = {k: torch.zeros((), dtype=torch.float32, device=dev)
                       for k in ("nll", "ntok", "aux")}
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                g, m = grad_fn(params, mb)
                if grads is None:  # blocks laid out as the gradients
                    grads = tree_map(lambda b_: like_sharded(torch.zeros(
                        local_of(b_).shape, dtype=accum_dtype,
                        device=b_.device), b_), g)
                grads = _tree_zip(lambda a, b_: like_sharded(
                    local_of(a) + local_of(b_).to(accum_dtype), a), grads, g)
                metrics = {k: metrics[k] + m[k] for k in metrics}
                del g
            grads = tree_map(lambda g: like_sharded(
                local_of(g) / microbatches, g), grads)

        new_params, new_state, gnorm = opt.apply_updates(
            params, grads, opt_state, adamw, zero=zero)
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
