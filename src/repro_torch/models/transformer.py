"""Block-pattern transformer LM: attention, RG-LRU and SSD mixers.

PyTorch counterpart of ``repro/models/transformer.py`` for models whose
layers are global or sliding-window attention, RG-LRU recurrent blocks
or Mamba2 SSD blocks, with gelu/swiglu/geglu MLPs or none (gemma2, qwen2,
recurrentgemma, mamba2), and MoE FFNs with or without a parallel dense
SwiGLU residual (grok-1, arctic). The parameter and cache trees keep the JAX
layout: layers stacked by period position (``group{g}/p{i}``) with a
leading ``reps`` axis, layer ``rep * len(period) + i``. Where JAX scans
over the stack, the port runs a Python loop over layers on views of it.

The decode cache is updated in place (JAX returns a new cache): a decode
step writes one slot of each attention layer's ring, and copies each
recurrent layer's new ``h`` and ``conv`` over the old ones, in the stacked
cache. ``forward`` in ``full`` mode is the training forward: it builds
no caches, returns the MoE load-balance loss as ``aux`` (0 for a model
without MoE layers), and with ``rt.remat`` wraps each layer body in
``torch.utils.checkpoint`` (non-reentrant), as JAX wraps it in
``jax.checkpoint``. The backward pass runs through autograd over the
plain PyTorch routes: the kernels have no backward (``check_trainable``).
Encoder-decoder and prefix models and the sharding hooks are not ported
yet (ROADMAP Queue A).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, MLP_GEGLU,
                                      MLP_GELU, MLP_MOE, MLP_NONE,
                                      MLP_SWIGLU, RGLRU, SSD, LayerSpec,
                                      ModelConfig)
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import HeadLayout, make_head_layout
from repro_torch.models.layers import (ParamBuilder, apply_mlp, apply_norm,
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
    remat: bool = True                    # recompute layer bodies (full)
    max_seq: int = 4096                   # sizes the global-layer caches

    def head_layout(self, cfg: ModelConfig) -> HeadLayout:
        return make_head_layout(cfg.n_heads, cfg.n_kv_heads, self.tp)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port has no module for yet."""
    if cfg.enc_dec or cfg.prefix_len or cfg.rope_theta <= 0:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder, prefix and learned-position "
            f"models are not ported (ROADMAP Queue A: other mixers and "
            f"archs)")
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
    differentiable."""
    kinds = {spec.mixer for period, _ in cfg.groups for spec in period} | \
        {spec.mlp for period, _ in cfg.groups for spec in period}
    used = {"attn_impl": rt.attn_impl
            if kinds & {ATTN_GLOBAL, ATTN_LOCAL} else None,
            "rglru_impl": rt.rglru_impl if RGLRU in kinds else None,
            "ssd_impl": rt.ssd_impl if SSD in kinds else None,
            "moe_impl": rt.moe_impl if MLP_MOE in kinds else None}
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
                rt: ModelRuntime) -> None:
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
    if spec.mlp == MLP_NONE:
        return
    init_norm(pb, "norm2", cfg.d_model, cfg.norm, gemma)
    if spec.mlp == MLP_MOE:
        moe_mod.init_moe(pb.child("mlp"), cfg,
                         moe_mod.make_moe_layout(cfg, rt.tp))
    else:
        init_mlp(pb.child("mlp"), cfg.d_model, cfg.d_ff, spec.mlp,
                 cfg.linear_bias)
    if spec.dense_residual:
        init_mlp(pb.child("dense_mlp"), cfg.d_model, cfg.d_ff, "swiglu",
                 cfg.linear_bias)
    if cfg.post_norms:
        init_norm(pb, "post_norm2", cfg.d_model, cfg.norm, gemma)


def init_params(cfg: ModelConfig, rt: ModelRuntime,
                generator: torch.Generator, device="cuda") -> Params:
    """Random parameters on ``device`` from ``generator`` (which must
    live on that device): the JAX tree's names, shapes, dtypes and init
    scales, other random numbers."""
    check_supported(cfg)
    dev = resolve_device(device)
    pb = ParamBuilder(generator, dev, dtype=torch.bfloat16)
    init_embeddings(pb, cfg.padded_vocab, cfg.d_model)
    gemma = cfg.norm == "rmsnorm" and cfg.post_norms
    init_norm(pb, "final_norm", cfg.d_model, cfg.norm, gemma)
    for gi, (period, reps) in enumerate(cfg.groups):
        grp = pb.child(f"group{gi}")
        for i, spec in enumerate(period):
            grp.stacked(f"p{i}", reps,
                        lambda sub, spec=spec: _init_layer(sub, cfg, spec,
                                                           rt))
    return pb.params


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _cache_len(cfg: ModelConfig, rt: ModelRuntime, spec: LayerSpec) -> int:
    return min(cfg.window, rt.max_seq) if spec.mixer == ATTN_LOCAL \
        else rt.max_seq


def _apply_attn_full(lp: Params, x: torch.Tensor, spec: LayerSpec,
                     cfg: ModelConfig, rt: ModelRuntime,
                     positions: torch.Tensor, causal: bool,
                     collect_cache: bool = False):
    layout = rt.head_layout(cfg)
    q, k, v = attn_mod.qkv_project(lp, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    window = cfg.window if spec.mixer == ATTN_LOCAL else 0
    o = attn_mod.attend(q, k, v, causal=causal, window=window,
                        cap=cfg.attn_softcap, impl=rt.attn_impl)
    y = attn_mod.out_project(lp, o, layout.head_mask(x.device))
    cache = None
    if collect_cache:
        s_cache = _cache_len(cfg, rt, spec)
        s = k.shape[1]
        kpos = positions.to(torch.int32).expand(k.shape[0], s)
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
        cache = {"k": k, "v": v, "kpos": kpos}
    return y, cache


def _apply_attn_decode(lp: Params, x: torch.Tensor, spec: LayerSpec,
                       cfg: ModelConfig, rt: ModelRuntime, cache: Params,
                       pos: int):
    """Single-device decode attention with an in-place ring-buffer write:
    slot ``pos % Sc`` of this layer's cache view."""
    layout = rt.head_layout(cfg)
    x0 = x[:, 0]
    q = attn_mod._proj(x0, lp["wq"])
    k_new = attn_mod._proj(x0, lp["wk"])
    v_new = attn_mod._proj(x0, lp["wv"])
    if "bq" in lp:
        q = q + lp["bq"]
        k_new, v_new = k_new + lp["bk"], v_new + lp["bv"]
    positions = torch.tensor([pos], device=x.device)  # [S=1]
    q = rope(q[:, None], positions, cfg.rope_theta)[:, 0]
    k_new = rope(k_new[:, None], positions, cfg.rope_theta)[:, 0]
    k_cache, v_cache, kpos = cache["k"], cache["v"], cache["kpos"]
    slot = pos % k_cache.shape[1]
    k_cache[:, slot] = k_new
    v_cache[:, slot] = v_new
    kpos[:, slot] = pos
    window = cfg.window if spec.mixer == ATTN_LOCAL else 0
    o = attn_mod.decode_attend(q, k_cache, v_cache, kpos, pos,
                               window=window, cap=cfg.attn_softcap)
    return attn_mod.out_project(lp, o[:, None], layout.head_mask(x.device))


def apply_layer(lp: Params, x: torch.Tensor, spec: LayerSpec,
                cfg: ModelConfig, rt: ModelRuntime, *, mode: str,
                positions=None, cache=None, pos: Optional[int] = None,
                causal: bool = True):
    """mode: full | prefill | decode. Returns (x, cache_out, aux): the
    layer's new cache in prefill, None otherwise (decode updates
    ``cache`` in place); aux is the MoE load-balance loss (float32, 0
    without a MoE FFN)."""
    gemma = cfg.norm == "rmsnorm" and cfg.post_norms
    cache_out = None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(lp["norm1"], x, cfg.norm, gemma)
    if spec.mixer in (RGLRU, SSD):
        apply_fn, impl = (rglru_mod.apply_rglru, rt.rglru_impl) \
            if spec.mixer == RGLRU else (ssm_mod.apply_ssd, rt.ssd_impl)
        st = cache["self"] if mode == "decode" else None
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
    if spec.mlp == MLP_NONE:
        return x, cache_out, aux
    h = apply_norm(lp["norm2"], x, cfg.norm, gemma)
    if spec.mlp == MLP_MOE:
        y, aux = moe_mod.apply_moe(lp["mlp"], h, cfg, impl=rt.moe_impl)
    else:
        y = apply_mlp(lp["mlp"], h, spec.mlp)
    if spec.dense_residual:
        y = y + apply_mlp(lp["dense_mlp"], h, "swiglu")
    if cfg.post_norms:
        y = apply_norm(lp["post_norm2"], y, cfg.norm, gemma)
    return x + y, cache_out, aux


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def _run_groups(params: Params, cfg: ModelConfig, rt: ModelRuntime,
                x: torch.Tensor, *, mode: str, positions=None, cache=None,
                pos: Optional[int] = None):
    """Loop over each (period, repeats) group. Returns (x, caches, aux).

    In prefill each layer's cache is written into a stacked buffer
    ``[reps, ...]`` allocated at the group's first repeat, so the stack is
    built without holding every layer's cache twice. In ``full`` mode with
    ``rt.remat`` each layer body is recomputed in the backward pass."""
    caches_out = {}
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for gi, (period, reps) in enumerate(cfg.groups):
        gp = params[f"group{gi}"]
        gcache = cache[f"group{gi}"] if cache is not None else None
        stacked: Dict[str, Any] = {}
        for r in range(reps):
            for i, spec in enumerate(period):
                lp = index_tree(gp[f"p{i}"], r)
                c_i = index_tree(gcache[f"p{i}"], r) \
                    if gcache is not None else None
                if rt.remat and mode == "full":
                    x, a = torch.utils.checkpoint.checkpoint(
                        _layer_body, lp, x, spec, cfg, rt, positions,
                        use_reentrant=False)
                    c_out = None
                else:
                    x, c_out, a = apply_layer(lp, x, spec, cfg, rt,
                                              mode=mode, positions=positions,
                                              cache=c_i, pos=pos)
                total_aux = total_aux + a
                if c_out is None:
                    continue
                if r == 0:
                    stacked[f"p{i}"] = {"self": {
                        n: t.new_empty((reps,) + tuple(t.shape))
                        for n, t in c_out["self"].items()}}
                for n, t in c_out["self"].items():
                    stacked[f"p{i}"]["self"][n][r].copy_(t)
        if stacked:
            caches_out[f"group{gi}"] = stacked
    return x, (caches_out or None), total_aux


def _layer_body(lp: Params, x: torch.Tensor, spec: LayerSpec,
                cfg: ModelConfig, rt: ModelRuntime, positions: torch.Tensor):
    """One layer of the training forward: (x, aux)."""
    x, _, aux = apply_layer(lp, x, spec, cfg, rt, mode="full",
                            positions=positions)
    return x, aux


def forward(params: Params, cfg: ModelConfig, rt: ModelRuntime,
            tokens: torch.Tensor, *, mode: str = "full"):
    """Returns (hidden [B,S,D], caches|None, aux). Logits via
    lm_head()."""
    check_supported(cfg)
    x = embed_tokens(params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    x, caches, aux = _run_groups(params, cfg, rt, x, mode=mode,
                                 positions=positions)
    gemma = cfg.norm == "rmsnorm" and cfg.post_norms
    x = apply_norm(params["final_norm"], x, cfg.norm, gemma)
    return x, caches, aux


def lm_head(params: Params, cfg: ModelConfig,
            hidden: torch.Tensor) -> torch.Tensor:
    """bf16 matmul, then float32, then the final softcap."""
    logits = hidden @ params["out_embed"]
    return softcap(logits.float(), cfg.final_softcap)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, rt: ModelRuntime, batch: int,
               device="cuda", dtype=torch.bfloat16) -> Params:
    """Empty decode caches for all layers, in the JAX tree layout:
    ``group{g}/p{i}/self/{k,v,kpos}`` with k/v ``[reps,B,Sc,Kh,Dh]`` and
    kpos ``[reps,B,Sc]`` (-1 = empty) for attention; ``self/{h,conv}``
    with float32 ``h`` and bfloat16 ``conv`` for RG-LRU and SSD."""
    check_supported(cfg)
    dev = resolve_device(device)
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
                    n: t.expand((reps,) + tuple(t.shape)).clone()
                    for n, t in init(cfg, batch, dev).items()}}
                continue
            sc = _cache_len(cfg, rt, spec)
            g[f"p{i}"] = {"self": {
                "k": torch.zeros((reps, batch, sc, layout.kv_heads, dh),
                                 dtype=dtype, device=dev),
                "v": torch.zeros((reps, batch, sc, layout.kv_heads, dh),
                                 dtype=dtype, device=dev),
                "kpos": torch.full((reps, batch, sc), -1, dtype=torch.int32,
                                   device=dev)}}
        cache[f"group{gi}"] = g
    return cache


def decode_step(params: Params, cfg: ModelConfig, rt: ModelRuntime,
                cache: Params, tokens: torch.Tensor, pos: int):
    """One token: tokens [B] int, pos the token's absolute position.
    Returns (logits [B, V] float32, cache), the cache updated in place."""
    x = embed_tokens(params, tokens)[:, None]  # [B,1,D]
    x, _, _ = _run_groups(params, cfg, rt, x, mode="decode", cache=cache,
                          pos=int(pos))
    gemma = cfg.norm == "rmsnorm" and cfg.post_norms
    x = apply_norm(params["final_norm"], x, cfg.norm, gemma)
    return lm_head(params, cfg, x[:, 0]), cache


def prefill(params: Params, cfg: ModelConfig, rt: ModelRuntime,
            tokens: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """Run the prompt, return (last-token logits, decode caches)."""
    hidden, caches, _ = forward(params, cfg, rt, tokens, mode="prefill")
    return lm_head(params, cfg, hidden[:, -1]), caches
