"""Block-pattern transformer LM: one implementation, ten architectures.

PyTorch counterpart of ``repro/models/transformer.py``: layers of global
or sliding-window attention, RG-LRU recurrent blocks or Mamba2 SSD
blocks, with gelu/swiglu/geglu MLPs or none, RMSNorm or LayerNorm, with
or without biases (gemma2, qwen2, deepseek-coder, starcoder2,
recurrentgemma, mamba2), MoE FFNs with or without a parallel dense
SwiGLU residual (grok-1, arctic), a prefix of precomputed embeddings
before the tokens (internvl2) and an encoder-decoder with learned
positions and cross-attention over the encoded frames (whisper). The
parameter and cache trees keep the JAX layout: layers stacked by period
position (``group{g}/p{i}``) with a leading ``reps`` axis, layer
``rep * len(period) + i``; a whisper decoder layer adds ``norm_cross``
and ``cross``, its cache ``cross/{k,v,kpos}``, and the encoder is the
``encoder`` subtree (its own ``pos_embed``, ``final_norm`` and
``group0``). Where JAX scans over the stack, the port runs a Python loop
over layers on views of it.

The decode cache is updated in place (JAX returns a new cache): a decode
step writes one slot of each attention layer's ring, and copies each
recurrent layer's new ``h`` and ``conv`` over the old ones, in the stacked
cache. ``forward`` in ``full`` mode is the training forward: it builds
no caches, returns the MoE load-balance loss as ``aux`` (0 for a model
without MoE layers), and with ``rt.remat`` wraps each layer body in
``torch.utils.checkpoint`` (non-reentrant), as JAX wraps it in
``jax.checkpoint``. The backward pass runs through autograd over the
plain PyTorch routes: the kernels have no backward (``check_trainable``).

Distribution is injected through ``ModelRuntime``, as in JAX: the tp
degree (head and expert-slot layouts), the ``constrain`` hook at JAX's
three sites, the shard_map routes of ``distributed/`` for decode
attention (``decode_attn_fn``: flash-decoding over a sequence-sharded
ring) and the MoE FFN (``moe_fn``: expert parallelism), and the dense
layout (``layout``), which ``distributed/sharding.Plan.runtime``
chooses. With a layout, ``prefill``, ``decode_step`` and the training
loss run their body once a process on its blocks (``Layout.run``): each
process runs its rows of the batch; the attention layers their block of
q heads (with the kv heads those read: ``attention.kv_for_heads``), the
MLPs their column and row blocks, the embedding and the head their
vocabulary block, each row-parallel product summed over ``model`` before
its bias. With the layout's ``fsdp`` the parameters are also cut over
the batch axes: a layer's leaves are gathered inside its body (under
remat the backward gathers them again instead of keeping whole weights;
``Layout.layer``), the embeddings, the final norms and the learned
positions at the top of the entry point's body (``gather_top``), and
each gradient comes back as this process's reduce-scattered block.
``param_specs`` and ``cache_specs`` give JAX's logical-axis trees
without drawing a number.

Behaviours of the reference that the port copies: decode cross-attention
masks the encoder frames by the decoder position (``kpos <= pos``, so
decode position p sees frames 0..p while prefill sees all of them); the
cross cache is padded to ``rt.max_seq`` (or rolled into a ring past it);
``decode_step`` past ``rt.max_seq`` adds the last learned position, as
``dynamic_slice`` clamps its start.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, MLP_GEGLU,
                                      MLP_GELU, MLP_MOE, MLP_NONE,
                                      MLP_SWIGLU, RGLRU, SSD, LayerSpec,
                                      ModelConfig)
from repro_torch.distributed.compat import (AS_IS, P, all_gather, bind_mesh,
                                            is_sharded_tensor, local_of)
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import HeadLayout, make_head_layout
from repro_torch.models.layers import (ParamBuilder, Shape, apply_mlp,
                                       apply_norm,
                                       embed_tokens, index_tree,
                                       init_embeddings, init_mlp, init_norm,
                                       rope, softcap)

Params = Dict[str, Any]

_MIXERS = (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, SSD)
_MLPS = (MLP_GELU, MLP_SWIGLU, MLP_GEGLU, MLP_MOE, MLP_NONE)


@dataclasses.dataclass(frozen=True)
class ModelRuntime:
    """Execution environment, kept out of ModelConfig as in JAX."""
    tp: int = 1
    attn_impl: str = "pallas"             # pallas | interpret | naive
    rglru_impl: str = "pallas"            # pallas | interpret | jnp
    ssd_impl: str = "pallas"              # pallas | interpret | jnp
    moe_impl: str = "pallas"              # pallas | interpret | gshard
    moe_fn: Optional[Callable] = None     # shard_map EP: (p, x, cfg)->(y,aux)
    decode_attn_fn: Optional[Callable] = None
    constrain: Callable = lambda x, kind: x
    remat: bool = True                    # recompute layer bodies
    remat_policy: str = "full"            # full | dots (save matmul outputs)
    max_seq: int = 4096                   # sizes the global-layer caches
    moe_dp: int = 1                       # 2D expert-parallel slot factor
    layout: Optional[Any] = None          # sharding.Layout: blocks and rows

    def head_layout(self, cfg: ModelConfig) -> HeadLayout:
        return make_head_layout(cfg.n_heads, cfg.n_kv_heads, self.tp)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a layer the port has no module for (none of the JAX
    registry's archs has one)."""
    for period, _ in cfg.groups:
        for spec in period:
            if spec.mixer not in _MIXERS or spec.mlp not in _MLPS:
                raise NotImplementedError(
                    f"{cfg.name}: layer {spec} is not ported (ROADMAP "
                    f"Queue A: other mixers and archs)")


def check_trainable(cfg: ModelConfig, rt: ModelRuntime) -> None:
    """Raise when a layer would run a kernel on the card in training: the
    kernels have no backward, so autograd would see their outputs as
    constants. The plain routes (attention ``blockwise``/``naive``/
    ``interpret``, the ``jnp`` scans, MoE ``interpret``/``gshard``) are
    differentiable, and so is a ``moe_fn`` hook on any mesh (plain
    PyTorch and the collectives, which carry JAX's transposes;
    ``moe_impl`` is then unused)."""
    kinds = {spec.mixer for period, _ in cfg.groups for spec in period} | \
        {spec.mlp for period, _ in cfg.groups for spec in period}
    used = {"attn_impl": rt.attn_impl
            if kinds & {ATTN_GLOBAL, ATTN_LOCAL} else None,
            "rglru_impl": rt.rglru_impl if RGLRU in kinds else None,
            "ssd_impl": rt.ssd_impl if SSD in kinds else None,
            "moe_impl": rt.moe_impl
            if MLP_MOE in kinds and rt.moe_fn is None else None}
    bad = {k: v for k, v in used.items() if v == "pallas"}
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {bad} would run a kernel without a backward in "
            f"training; train through the plain routes (the JAX package "
            f"trains through blockwise attention and the jnp scans)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_layer(pb: ParamBuilder, cfg: ModelConfig, spec: LayerSpec,
                rt: ModelRuntime, cross: bool = False) -> None:
    gemma = cfg.norm == "rmsnorm" and cfg.post_norms
    init_norm(pb, "norm1", cfg.d_model, cfg.norm, gemma)
    if spec.mixer == RGLRU:
        rglru_mod.init_rglru(pb.child("mixer"), cfg)
    elif spec.mixer == SSD:
        ssm_mod.init_ssd(pb.child("mixer"), cfg)
    else:
        attn_mod.init_attention(pb.child("mixer"), cfg.d_model,
                                rt.head_layout(cfg), cfg.resolved_head_dim,
                                qkv_bias=cfg.qkv_bias,
                                linear_bias=cfg.linear_bias)
    if cfg.post_norms:
        init_norm(pb, "post_norm1", cfg.d_model, cfg.norm, gemma)
    if cross:  # a decoder layer's cross-attention (no qkv_bias, as JAX)
        init_norm(pb, "norm_cross", cfg.d_model, cfg.norm, gemma)
        attn_mod.init_attention(pb.child("cross"), cfg.d_model,
                                rt.head_layout(cfg), cfg.resolved_head_dim,
                                linear_bias=cfg.linear_bias)
    if spec.mlp == MLP_NONE:
        return
    init_norm(pb, "norm2", cfg.d_model, cfg.norm, gemma)
    if spec.mlp == MLP_MOE:
        moe_mod.init_moe(pb.child("mlp"), cfg,
                         moe_mod.make_moe_layout(cfg, rt.tp, rt.moe_dp))
    else:
        init_mlp(pb.child("mlp"), cfg.d_model, cfg.d_ff, spec.mlp,
                 cfg.linear_bias)
    if spec.dense_residual:
        init_mlp(pb.child("dense_mlp"), cfg.d_model, cfg.d_ff, "swiglu",
                 cfg.linear_bias)
    if cfg.post_norms:
        init_norm(pb, "post_norm2", cfg.d_model, cfg.norm, gemma)


def _device(device) -> torch.device:
    """``resolve_device``, plus ``meta`` for the shape-only trees."""
    if torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def _build_params(pb: ParamBuilder, cfg: ModelConfig,
                  rt: ModelRuntime) -> None:
    init_embeddings(pb, cfg.padded_vocab, cfg.d_model)
    gemma = cfg.norm == "rmsnorm" and cfg.post_norms
    init_norm(pb, "final_norm", cfg.d_model, cfg.norm, gemma)
    if cfg.rope_theta <= 0:  # learned positions (whisper)
        pb.param("pos_embed", (rt.max_seq, cfg.d_model), (None, None),
                 init="normal", scale=0.02)

    def add_stack(parent: ParamBuilder, name: str, groups,
                  cross: bool) -> None:
        for gi, (period, reps) in enumerate(groups):
            grp = parent.child(f"{name}{gi}")
            for i, spec in enumerate(period):
                grp.stacked(f"p{i}", reps,
                            lambda sub, spec=spec: _init_layer(
                                sub, cfg, spec, rt, cross=cross))

    add_stack(pb, "group", cfg.groups, cross=cfg.enc_dec)
    if cfg.enc_dec:
        enc = pb.child("encoder")
        if cfg.rope_theta <= 0:
            enc.param("pos_embed", (rt.max_seq, cfg.d_model), (None, None),
                      init="normal", scale=0.02)
        init_norm(enc, "final_norm", cfg.d_model, cfg.norm, gemma)
        add_stack(enc, "group", _encoder_groups(cfg), cross=False)


def init_params(cfg: ModelConfig, rt: ModelRuntime,
                generator: torch.Generator, device="cuda",
                keep: Optional[Callable] = None) -> Params:
    """Random parameters on ``device`` from ``generator`` (which must
    live on that device): the JAX tree's names, shapes, dtypes and init
    scales, other random numbers. ``keep(w, spec)`` keeps a part of each
    leaf as it is drawn (``sharding.Layout.block``: this process's
    block, without the whole tree ever held)."""
    check_supported(cfg)
    pb = ParamBuilder(generator, resolve_device(device),
                      dtype=torch.bfloat16, keep=keep)
    _build_params(pb, cfg, rt)
    return pb.params


def abstract_params(cfg: ModelConfig, rt: ModelRuntime
                    ) -> Tuple[Params, Params]:
    """(params on the ``meta`` device: shapes and dtypes, no numbers;
    their logical-axis specs), as JAX's ``abstract_params``."""
    check_supported(cfg)
    pb = ParamBuilder(None, "meta", dtype=torch.bfloat16)
    _build_params(pb, cfg, rt)
    return pb.params, pb.specs


def param_specs(cfg: ModelConfig, rt: ModelRuntime) -> Params:
    """JAX's ``init_params(...)[1]``: each leaf's logical axes (built on
    ``Shape``s: no tensor is made, not even on ``meta``)."""
    return _shape_tree(cfg, rt)[1]


def _shape_tree(cfg: ModelConfig, rt: ModelRuntime) -> Tuple[Params, Params]:
    """(a tree of ``Shape``s, its logical-axis specs)."""
    check_supported(cfg)
    pb = ParamBuilder(None, None, dtype=torch.bfloat16)
    _build_params(pb, cfg, rt)
    return pb.params, pb.specs


def fsdp_cuts(cfg: ModelConfig, rt: ModelRuntime) -> Dict[str, Any]:
    """``{path: (dim, batch axes)}`` of the parameters ``rt.layout``'s FSDP
    cut narrows (empty without one)."""
    if rt.layout is None or not rt.layout.fsdp:
        return {}
    return rt.layout.fsdp_cuts(*_shape_tree(cfg, rt))


def _under(cuts: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """The cuts of the leaves under ``prefix``, by their path below it."""
    return {k[len(prefix):]: v for k, v in cuts.items()
            if k.startswith(prefix)}


def gather_top(params: Params, cfg: ModelConfig, rt: ModelRuntime
               ) -> Params:
    """Inside the layout's ``run``: ``params`` with every FSDP-cut leaf
    outside the layer stacks (the embeddings, the final norms, the
    learned positions) gathered whole over the batch axes; the stacks
    are gathered a layer at a time (``_run_groups``)."""
    cuts = fsdp_cuts(cfg, rt)
    if not cuts:
        return params

    def walk(tree, pre):
        out = {}
        for k, v in tree.items():
            path = f"{pre}{k}"
            if isinstance(v, dict):
                stack = k.startswith("group") and pre in ("", "encoder/")
                out[k] = v if stack else walk(v, path + "/")
            else:
                out[k] = rt.layout.gather(v, cuts.get(path))
        return out
    return walk(params, "")


def _encoder_groups(cfg: ModelConfig):
    """The encoder's one group: ``n_enc_layers`` non-causal global
    attention layers with the decoder's MLP."""
    return (((LayerSpec(mixer=ATTN_GLOBAL, mlp=cfg.pattern[0].mlp),),
             cfg.n_enc_layers),)


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _cache_len(cfg: ModelConfig, rt: ModelRuntime, spec: LayerSpec) -> int:
    return min(cfg.window, rt.max_seq) if spec.mixer == ATTN_LOCAL \
        else rt.max_seq


def _apply_attn_full(lp: Params, x: torch.Tensor, spec: LayerSpec,
                     cfg: ModelConfig, rt: ModelRuntime,
                     positions: torch.Tensor, causal: bool,
                     kv_x: Optional[torch.Tensor] = None,
                     collect_cache: bool = False):
    """Self-attention over ``x``, or cross-attention of ``x`` over
    ``kv_x`` (the encoder's output, at positions ``arange(Sk)``)."""
    layout = rt.head_layout(cfg)
    q, k, v = attn_mod.qkv_project(lp, x, kv_x)
    kv_pos = positions if kv_x is None else \
        torch.arange(kv_x.shape[1], device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, kv_pos, cfg.rope_theta)
    window = cfg.window if spec.mixer == ATTN_LOCAL else 0
    mask, reduce = layout.head_mask(x.device), None
    ka, va = k, v
    if _heads_cut(rt, layout):  # this process's block of q heads
        h0 = rt.layout.model_index() * q.shape[2]
        ka, va = attn_mod.kv_for_heads(k, v, layout, h0, q.shape[2])
        mask, reduce = mask[h0:h0 + q.shape[2]], rt.layout.tp_sum
    o = attn_mod.attend(q, ka, va, causal=causal, window=window,
                        cap=cfg.attn_softcap, impl=rt.attn_impl)
    del ka, va
    y = attn_mod.out_project(lp, o, mask, reduce)
    cache = None
    if collect_cache:
        s_cache = _cache_len(cfg, rt, spec)
        s = k.shape[1]
        kpos = kv_pos.to(torch.int32).expand(k.shape[0], s)
        if s < s_cache:  # pad to cache size
            pad = s_cache - s
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
            kpos = torch.nn.functional.pad(kpos, (0, pad), value=-1)
        elif s > s_cache:  # keep last window (ring layout: slot = pos % Sc)
            k, v, kpos = (t[:, -s_cache:] for t in (k, v, kpos))
            # entry j holds pos (s - s_cache + j); slot for pos p is p % Sc,
            # so new[i] = old[(i - s % Sc) % Sc]  ==  roll by +(s % Sc).
            roll = s % s_cache
            k = torch.roll(k, roll, dims=1)
            v = torch.roll(v, roll, dims=1)
            kpos = torch.roll(kpos, roll, dims=1)
        cache = {n: _ring_block(t, rt) for n, t in
                 (("k", k), ("v", v), ("kpos", kpos))}
    return y, cache


def _ring_block(t: torch.Tensor, rt: ModelRuntime) -> torch.Tensor:
    """This process's block of a cache ring ``[B, Sc, ...]`` over
    ``model`` (``kv_seq``; whole when ``model`` does not divide Sc), an
    owned copy so that the whole ring is freed."""
    lay = rt.layout
    if lay is None or lay.tp == 1 or t.shape[1] % lay.tp:
        return t
    n = t.shape[1] // lay.tp
    return t.narrow(1, lay.model_index() * n, n).clone()


def _heads_cut(rt: ModelRuntime, layout: HeadLayout) -> bool:
    """Whether this process holds a block of the q heads (the layout cuts
    ``heads``)."""
    return rt.layout is not None and rt.layout.cuts("heads", layout.q_heads)


def _decode_attn(rt: ModelRuntime, cache: Params, k_new, v_new, q, pos,
                 *, window: int, cap: float, cut: bool):
    """Decode attention through the plan's hook (``decode_attn_fn``, which
    takes this process's q heads inside the layout), or on one device
    (``_jnp_decode_attn``): inside the layout, on every q head gathered
    over ``model``, of which this process keeps its own."""
    fn = rt.decode_attn_fn
    if fn is not None:
        return fn(cache["k"], cache["v"], cache["kpos"], k_new, v_new, q,
                  pos, window=window, cap=cap)
    if any(is_sharded_tensor(t) and any(pl.is_shard(1) for pl in
                                        t.placements)
           for t in (cache["k"], cache["v"])):
        raise ValueError("a cache ring cut over model needs the plan's "
                         "decode attention (decode_attn_fn)")
    kc, vc, kp = (local_of(cache[n]) for n in ("k", "v", "kpos"))
    lay, n = rt.layout, q.shape[1]
    if not cut:
        o, _ = _jnp_decode_attn(kc, vc, kp, k_new, v_new, q, pos,
                                window=window, cap=cap)
        return o, cache
    q_all = all_gather(q, "model", axis=1, tiled=True)
    o, _ = _jnp_decode_attn(kc, vc, kp, k_new, v_new, q_all, pos,
                            window=window, cap=cap)
    return o.narrow(1, lay.model_index() * n, n), cache


def _jnp_decode_attn(k_cache, v_cache, kpos, k_new, v_new, q, pos: int, *,
                     window: int, cap: float):
    """Single-device decode attention with an in-place ring-buffer write
    of slot ``pos % Sc`` (none for cross-attention, ``k_new`` None, which
    reads the encoder's keys at ``kpos <= pos``, as JAX's
    ``decode_attend`` does). Returns (o [B,H,Dh], the written cache)."""
    if k_new is not None:
        slot = pos % k_cache.shape[1]
        k_cache[:, slot] = k_new
        v_cache[:, slot] = v_new
        kpos[:, slot] = pos
    o = attn_mod.decode_attend(q, k_cache, v_cache, kpos, pos,
                               window=window, cap=cap)
    return o, {"k": k_cache, "v": v_cache, "kpos": kpos}


def _apply_attn_decode(lp: Params, x: torch.Tensor, spec: LayerSpec,
                       cfg: ModelConfig, rt: ModelRuntime, cache: Params,
                       pos: int, cross: bool = False):
    """Decode attention of this layer's cache view through
    ``_decode_attn`` (the cache is written in place)."""
    layout = rt.head_layout(cfg)
    x0 = x[:, 0]
    q = attn_mod._proj(x0, lp["wq"])
    if "bq" in lp:
        q = q + lp["bq"]
    positions = torch.tensor([pos], device=x.device)  # [S=1]
    q = rope(q[:, None], positions, cfg.rope_theta)[:, 0]
    k_new = v_new = None
    if not cross:
        k_new = attn_mod._proj(x0, lp["wk"])
        v_new = attn_mod._proj(x0, lp["wv"])
        if "bk" in lp:
            k_new, v_new = k_new + lp["bk"], v_new + lp["bv"]
        k_new = rope(k_new[:, None], positions, cfg.rope_theta)[:, 0]
    window = cfg.window if spec.mixer == ATTN_LOCAL else 0
    o, _ = _decode_attn(rt, cache, k_new, v_new, q, pos, window=window,
                        cap=cfg.attn_softcap, cut=_heads_cut(rt, layout))
    mask, reduce = layout.head_mask(x.device), None
    if _heads_cut(rt, layout):  # this process's block of q heads
        h0 = rt.layout.model_index() * q.shape[1]
        mask, reduce = mask[h0:h0 + q.shape[1]], rt.layout.tp_sum
    return attn_mod.out_project(lp, o[:, None], mask, reduce)


def apply_layer(lp: Params, x: torch.Tensor, spec: LayerSpec,
                cfg: ModelConfig, rt: ModelRuntime, *, mode: str,
                positions=None, cache=None, enc_out=None,
                pos: Optional[int] = None, causal: bool = True):
    """mode: full | prefill | decode. Returns (x, cache_out, aux): the
    layer's new cache in prefill (``self``, and ``cross`` for a whisper
    decoder layer), None otherwise (decode updates ``cache`` in place);
    aux is the MoE load-balance loss (float32, 0 without a MoE FFN)."""
    gemma = cfg.norm == "rmsnorm" and cfg.post_norms
    cache_out = None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(lp["norm1"], x, cfg.norm, gemma)
    if spec.mixer in (RGLRU, SSD):
        apply_fn, impl = (rglru_mod.apply_rglru, rt.rglru_impl) \
            if spec.mixer == RGLRU else (ssm_mod.apply_ssd, rt.ssd_impl)
        st = None
        if mode == "decode":  # this process's rows of the states
            st = {n: local_of(t) for n, t in cache["self"].items()}
        y, st2 = apply_fn(lp["mixer"], h, cfg, state=st, impl=impl,
                          return_state=(mode == "prefill"))
        if mode == "decode":  # the stacked cache's view, in place
            for n, t in st2.items():
                st[n].copy_(t)
        elif mode == "prefill":
            cache_out = {"self": st2}
    elif mode == "decode":
        y = _apply_attn_decode(lp["mixer"], h, spec, cfg, rt, cache["self"],
                               pos)
    else:
        y, c = _apply_attn_full(lp["mixer"], h, spec, cfg, rt, positions,
                                causal, collect_cache=(mode == "prefill"))
        if mode == "prefill":
            cache_out = {"self": c}
    if cfg.post_norms:
        y = apply_norm(lp["post_norm1"], y, cfg.norm, gemma)
    x = x + y
    x = rt.constrain(x, "resid")
    if "cross" in lp:  # whisper decoder cross-attention
        h = apply_norm(lp["norm_cross"], x, cfg.norm, gemma)
        if mode == "decode":
            y = _apply_attn_decode(lp["cross"], h, spec, cfg, rt,
                                   cache["cross"], pos, cross=True)
        else:
            y, c = _apply_attn_full(lp["cross"], h, spec, cfg, rt,
                                    positions, causal=False, kv_x=enc_out,
                                    collect_cache=(mode == "prefill"))
            if mode == "prefill":
                cache_out["cross"] = c
        x = x + y
    if spec.mlp == MLP_NONE:
        return x, cache_out, aux
    h = apply_norm(lp["norm2"], x, cfg.norm, gemma)
    if spec.mlp == MLP_MOE:
        if rt.moe_fn is not None:
            y, aux = rt.moe_fn(lp["mlp"], h, cfg)
        else:
            y, aux = moe_mod.apply_moe(lp["mlp"], h, cfg, impl=rt.moe_impl)
    else:
        y = apply_mlp(lp["mlp"], h, spec.mlp, _mlp_reduce(cfg, rt))
    if spec.dense_residual:
        y = y + apply_mlp(lp["dense_mlp"], h, "swiglu", _mlp_reduce(cfg, rt))
    if cfg.post_norms:
        y = apply_norm(lp["post_norm2"], y, cfg.norm, gemma)
    return rt.constrain(x + y, "resid"), cache_out, aux


def _mlp_reduce(cfg: ModelConfig, rt: ModelRuntime):
    """The sum over ``model`` when the layout cuts the MLPs' hidden dim
    (the layer then holds its column and row blocks)."""
    if rt.layout is None or not rt.layout.cuts("mlp", cfg.d_ff):
        return None
    return rt.layout.tp_sum


def _save_dots():
    """``torch.utils.checkpoint``'s selective recomputation as JAX's
    ``dots_with_no_batch_dims_saveable``: the outputs of products with no
    batch dimension (``mm``, ``addmm``) are saved, every other op (the
    attention scores' ``bmm`` among them) is recomputed."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    saved = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else \
            CheckpointPolicy.PREFER_RECOMPUTE
    return create_selective_checkpoint_contexts(policy)


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def _run_groups(params: Params, cfg: ModelConfig, rt: ModelRuntime,
                x: torch.Tensor, *, mode: str, positions=None, cache=None,
                enc_out=None, pos: Optional[int] = None, groups=None,
                causal: bool = True, prefix: str = ""):
    """Loop over each (period, repeats) group (``cfg.groups``, or the
    encoder's ``groups``, whose parameters sit under ``prefix``). Returns
    (x, caches, aux).

    In prefill each layer's cache is written into a stacked buffer
    ``[reps, ...]`` allocated at the group's first repeat, so the stack is
    built without holding every layer's cache twice. In ``full`` mode with
    ``rt.remat`` each layer body is recomputed in the backward pass
    (``rt.remat_policy="dots"``: all but its saved matmul outputs). Under
    FSDP a layer's leaves are gathered inside its body."""
    caches_out = {}
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    groups = cfg.groups if groups is None else groups
    cuts = fsdp_cuts(cfg, rt)
    # no recomputation without autograd (whisper's encoder runs in "full"
    # mode when serving): the first checkpoint call of a process costs
    # seconds of set-up (7.9 s of a whisper-tiny prefill on the H100)
    remat = rt.remat and mode == "full" and torch.is_grad_enabled()
    for gi, (period, reps) in enumerate(groups):
        gp = params[f"group{gi}"]
        gcache = cache[f"group{gi}"] if cache is not None else None
        stacked: Dict[str, Any] = {}
        for r in range(reps):
            for i, spec in enumerate(period):
                lcuts = _under(cuts, f"{prefix}group{gi}/p{i}/")
                # under FSDP the body takes the stacks and gathers layer r
                lp = (gp[f"p{i}"], lcuts, r) if lcuts else \
                    index_tree(gp[f"p{i}"], r)
                c_i = index_tree(gcache[f"p{i}"], r) \
                    if gcache is not None else None
                if remat:
                    kw = {"context_fn": _save_dots} \
                        if rt.remat_policy == "dots" else {}
                    x, a = torch.utils.checkpoint.checkpoint(
                        bind_mesh(_layer_body), lp, x, spec, cfg, rt,
                        positions, enc_out, causal, use_reentrant=False,
                        **kw)
                    c_out = None
                else:
                    if lcuts:
                        lp = _layer_params(rt, *lp)
                    x, c_out, a = apply_layer(lp, x, spec, cfg, rt,
                                              mode=mode, positions=positions,
                                              cache=c_i, enc_out=enc_out,
                                              pos=pos, causal=causal)
                total_aux = total_aux + a
                if c_out is None:
                    continue
                if r == 0:
                    stacked[f"p{i}"] = {
                        kind: {n: t.new_empty((reps,) + tuple(t.shape))
                               for n, t in sub.items()}
                        for kind, sub in c_out.items()}
                for kind, sub in c_out.items():
                    for n, t in sub.items():
                        stacked[f"p{i}"][kind][n][r].copy_(t)
        if stacked:
            caches_out[f"group{gi}"] = stacked
    return x, (caches_out or None), total_aux


def _layer_params(rt: ModelRuntime, stack: Params, cuts: Dict[str, Any],
                  r: int) -> Params:
    """Layer ``r`` of a period position's stacks, each FSDP-cut leaf
    gathered whole (``Layout.layer``)."""
    def walk(tree, pre):
        return {k: walk(v, f"{pre}{k}/") if isinstance(v, dict) else
                rt.layout.layer(v, cuts.get(f"{pre}{k}"), r)
                for k, v in tree.items()}
    return walk(stack, "")


def _layer_body(lp, x: torch.Tensor, spec: LayerSpec,
                cfg: ModelConfig, rt: ModelRuntime, positions: torch.Tensor,
                enc_out: Optional[torch.Tensor], causal: bool):
    """One layer of the training forward: (x, aux). ``lp`` is the layer's
    parameters, or under FSDP (its stacks, their cuts, the layer's
    index), gathered here, so the backward gathers them again."""
    if isinstance(lp, tuple):
        lp = _layer_params(rt, *lp)
    x, _, aux = apply_layer(lp, x, spec, cfg, rt, mode="full",
                            positions=positions, enc_out=enc_out,
                            causal=causal)
    return x, aux


def encode(params: Params, cfg: ModelConfig, rt: ModelRuntime,
           frames: torch.Tensor) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings [B,S,D]: bf16 frames
    (as JAX casts them), plus the encoder's learned positions, through
    ``n_enc_layers`` non-causal layers and the encoder's final norm."""
    enc = params["encoder"]
    x = frames.to(torch.bfloat16)
    s = x.shape[1]
    if "pos_embed" in enc:
        x = x + enc["pos_embed"][:s][None].to(x.dtype)
    positions = torch.arange(s, device=x.device)
    x, _, _ = _run_groups(enc, cfg, rt, x, mode="full", positions=positions,
                          groups=_encoder_groups(cfg), causal=False,
                          prefix="encoder/")
    gemma = cfg.norm == "rmsnorm" and cfg.post_norms
    return apply_norm(enc["final_norm"], x, cfg.norm, gemma)


def forward(params: Params, cfg: ModelConfig, rt: ModelRuntime,
            tokens: torch.Tensor, *, prefix_embeds=None, enc_frames=None,
            mode: str = "full"):
    """Returns (hidden [B,S,D], caches|None, aux); S counts the prefix
    (``prefix_embeds`` [B,P,D], prepended to the token embeddings).
    ``enc_frames`` [B,F,D] feeds an encoder-decoder's encoder. Logits
    via lm_head()."""
    check_supported(cfg)
    x = _embed(params, cfg, rt, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    s = x.shape[1]
    if "pos_embed" in params:
        x = x + params["pos_embed"][:s][None].to(x.dtype)
    x = rt.constrain(x, "resid")
    positions = torch.arange(s, device=x.device)
    enc_out = None
    if cfg.enc_dec:
        if enc_frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                             f"enc_frames")
        enc_out = encode(params, cfg, rt, enc_frames)
    x, caches, aux = _run_groups(params, cfg, rt, x, mode=mode,
                                 positions=positions, enc_out=enc_out)
    gemma = cfg.norm == "rmsnorm" and cfg.post_norms
    x = apply_norm(params["final_norm"], x, cfg.norm, gemma)
    return x, caches, aux


def _embed(params: Params, cfg: ModelConfig, rt: ModelRuntime,
           tokens: torch.Tensor) -> torch.Tensor:
    cut = rt.layout is not None and \
        rt.layout.cuts("vocab", cfg.padded_vocab)
    return embed_tokens(params, tokens, rt.layout if cut else None)


def lm_head(params: Params, cfg: ModelConfig,
            hidden: torch.Tensor) -> torch.Tensor:
    """bf16 matmul, then float32, then the final softcap. Inside the
    layout ``out_embed`` is this process's vocabulary block, and so are
    the logits' columns (padded columns unmasked, as JAX's)."""
    logits = hidden @ params["out_embed"]
    return softcap(logits.float(), cfg.final_softcap)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, rt: ModelRuntime, batch: int,
               enc_len: int = 0, device="cuda",
               dtype=torch.bfloat16) -> Params:
    """Empty decode caches for all layers, in the JAX tree layout:
    ``group{g}/p{i}/self/{k,v,kpos}`` with k/v ``[reps,B,Sc,Kh,Dh]`` and
    kpos ``[reps,B,Sc]`` (-1 = empty) for attention; ``self/{h,conv}``
    with float32 ``h`` and bfloat16 ``conv`` for RG-LRU and SSD; an
    encoder-decoder's ``cross/{k,v,kpos}`` over ``enc_len`` frames (kpos
    0, as JAX's). On ``device="meta"``: shapes and dtypes only; with
    ``device=None`` each leaf is a ``Shape`` (no tensor at all)."""
    check_supported(cfg)
    dev = None if device is None else _device(device)

    def make(shape, dt, fill):
        if dev is None:
            return Shape(tuple(shape), dt)
        return torch.full(shape, fill, dtype=dt, device=dev)

    layout = rt.head_layout(cfg)
    dh = cfg.resolved_head_dim
    cache = {}
    for gi, (period, reps) in enumerate(cfg.groups):
        g = {}
        for i, spec in enumerate(period):
            if spec.mixer in (RGLRU, SSD):
                init = rglru_mod.init_rglru_state if spec.mixer == RGLRU \
                    else ssm_mod.init_ssd_state
                g[f"p{i}"] = {"self": {
                    n: make((reps,) + tuple(t.shape), t.dtype, 0)
                    for n, t in init(cfg, batch, "meta").items()}}
                continue
            sc = _cache_len(cfg, rt, spec)
            g[f"p{i}"] = {"self": {
                "k": make((reps, batch, sc, layout.kv_heads, dh), dtype, 0),
                "v": make((reps, batch, sc, layout.kv_heads, dh), dtype, 0),
                "kpos": make((reps, batch, sc), torch.int32, -1)}}
        if cfg.enc_dec:
            for i in range(len(period)):
                g[f"p{i}"]["cross"] = {
                    "k": make((reps, batch, enc_len, layout.kv_heads, dh),
                              dtype, 0),
                    "v": make((reps, batch, enc_len, layout.kv_heads, dh),
                              dtype, 0),
                    "kpos": make((reps, batch, enc_len), torch.int32, 0)}
        cache[f"group{gi}"] = g
    return cache


def cache_specs(cfg: ModelConfig, rt: ModelRuntime, batch: int,
                enc_len: int = 0) -> Params:
    """JAX's ``init_cache(...)[1]``: the logical axes of each leaf of
    ``init_cache``'s tree (``None`` on the stacked ``reps`` dim)."""
    del rt, batch, enc_len  # the axes do not depend on the sizes
    attn = {"k": (None, "kv_batch", "kv_seq", None, None),
            "v": (None, "kv_batch", "kv_seq", None, None),
            "kpos": (None, "kv_batch", "kv_seq")}
    state = {RGLRU: {"h": (None, "kv_batch", "rglru"),
                     "conv": (None, "kv_batch", None, "rglru")},
             SSD: {"h": (None, "kv_batch", "ssm_heads", None, None),
                   "conv": (None, "kv_batch", None, None)}}
    specs = {}
    for gi, (period, _) in enumerate(cfg.groups):
        g = {}
        for i, spec in enumerate(period):
            g[f"p{i}"] = {"self": dict(state.get(spec.mixer, attn))}
            if cfg.enc_dec:
                g[f"p{i}"]["cross"] = dict(attn)
        specs[f"group{gi}"] = g
    return specs


def _logits_spec(lay, cfg: ModelConfig, rows) -> P:
    """The logits' ``P``: rows, and the vocabulary over ``model`` where
    the layout cuts it."""
    return P(rows, "model" if lay.cuts("vocab", cfg.padded_vocab) else None)


def decode_step(params: Params, cfg: ModelConfig, rt: ModelRuntime,
                cache: Params, tokens: torch.Tensor, pos: int):
    """One token: tokens [B] int, pos the token's absolute position.
    Returns (logits [B, V] float32, cache), the cache updated in place.

    With ``rt.layout`` each process runs its rows of ``tokens`` (whole,
    the same on every process) on its blocks of the parameters and of
    the cache (a whole cache is cut first, as views); the logits come
    back as a DTensor over its rows and vocabulary block, the cache as
    its blocks."""
    pos = int(pos)
    if rt.layout is None:
        return _decode_step(params, cfg, rt, cache, tokens, pos)
    lay = rt.layout
    b = tokens.shape[0]
    rows = lay.row_entry(b)
    cache = lay.shard(cache, cache_specs(cfg, rt, b), fsdp=False)
    pspecs = lay.specs(params, param_specs(cfg, rt))
    return lay.run(
        lambda p, c, t: _decode_step(gather_top(p, cfg, rt), cfg, rt, c, t,
                                     pos),
        (params, cache, tokens), (pspecs, AS_IS, P(rows)),
        (_logits_spec(lay, cfg, rows), AS_IS))


def _decode_step(params: Params, cfg: ModelConfig, rt: ModelRuntime,
                 cache: Params, tokens: torch.Tensor, pos: int):
    x = _embed(params, cfg, rt, tokens)[:, None]  # [B,1,D]
    if "pos_embed" in params:  # JAX's dynamic_slice clamps the start
        pe = params["pos_embed"]
        x = x + pe[min(pos, pe.shape[0] - 1)][None, None].to(x.dtype)
    x, _, _ = _run_groups(params, cfg, rt, x, mode="decode", cache=cache,
                          pos=pos)
    gemma = cfg.norm == "rmsnorm" and cfg.post_norms
    x = apply_norm(params["final_norm"], x, cfg.norm, gemma)
    return lm_head(params, cfg, x[:, 0]), cache


def prefill(params: Params, cfg: ModelConfig, rt: ModelRuntime,
            tokens: torch.Tensor, *, prefix_embeds=None,
            enc_frames=None) -> Tuple[torch.Tensor, Params]:
    """Run the prompt, return (last-token logits, decode caches).

    With ``rt.layout`` each process runs its rows of the batch (whole,
    the same on every process) on its blocks of the parameters; the
    logits come back as a DTensor over its rows and vocabulary block,
    each cache leaf as its block (rows, and the ring over ``model``)."""
    if rt.layout is None:
        return _prefill(params, cfg, rt, tokens, prefix_embeds, enc_frames)
    lay = rt.layout
    b = tokens.shape[0]
    rows = lay.row_entry(b)
    enc = rt.max_seq if cfg.enc_dec else 0  # the cross ring's length
    cspecs = lay.specs(init_cache(cfg, rt, b, enc, device=None),
                       cache_specs(cfg, rt, b, enc), fsdp=False)
    pspecs = lay.specs(params, param_specs(cfg, rt))
    return lay.run(
        lambda p, t, pe, ef: _prefill(gather_top(p, cfg, rt), cfg, rt, t,
                                      pe, ef),
        (params, tokens, prefix_embeds, enc_frames),
        (pspecs, P(rows, None), P(rows, None, None), P(rows, None, None)),
        (_logits_spec(lay, cfg, rows), cspecs))


def _prefill(params: Params, cfg: ModelConfig, rt: ModelRuntime,
             tokens: torch.Tensor, prefix_embeds, enc_frames):
    hidden, caches, _ = forward(params, cfg, rt, tokens,
                                prefix_embeds=prefix_embeds,
                                enc_frames=enc_frames, mode="prefill")
    return lm_head(params, cfg, hidden[:, -1]), caches
