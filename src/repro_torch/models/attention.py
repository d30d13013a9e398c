"""Attention: GQA/MQA, causal / sliding-window, logit softcap.

PyTorch counterpart of ``repro/models/attention.py``. Q heads are stored
flat as ``H = kv_heads * group`` (group-major: q head ``h`` reads kv head
``h // group``); a ``head_mask`` zeroes the outputs of heads padded for
tensor parallelism, so padding never changes the math.

Implementations of ``attend``:
  naive      - full score matrix (oracle / tiny shapes)
  pallas     - the Hopper flash attention kernel (``kernels/flash_attention``;
               its plain version on a CPU tensor). The name is the JAX
               package's, so one ``ModelRuntime`` reads the same in both.
  interpret  - the kernel's plain version (``ops.reference``: float32
               scores and softmax) on any device, as JAX's ``interpret``
               runs the kernel's semantics without the TPU
  blockwise  - flash-structured attention in plain PyTorch: an online
               softmax over 512-key blocks for each 512-row query block;
               sliding-window layers take ``local_attention`` (each query
               block against the window + block keys before it). This is
               what the JAX package trains through, so it is the training
               path here too: it is differentiable, the kernel is not.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.layers import ParamBuilder

Params = Dict[str, torch.Tensor]

NEG_INF = -2.0e38


class HeadLayout(NamedTuple):
    kv_heads: int        # physical (possibly padded for MHA) KV heads
    group: int           # physical Q heads per KV head (possibly padded)
    real_kv: int
    real_group: int

    @property
    def q_heads(self) -> int:
        return self.kv_heads * self.group

    def head_mask(self, device=None) -> torch.Tensor:
        h = torch.arange(self.q_heads, device=device)
        return ((h % self.group < self.real_group) &
                (h // self.group < self.real_kv)).to(torch.bfloat16)


def make_head_layout(n_heads: int, n_kv_heads: int, tp: int) -> HeadLayout:
    """Pad Q heads (inside groups / kv for MHA) so q_heads % tp == 0."""
    if n_heads == n_kv_heads:  # MHA: pad kv heads alongside
        kh = n_heads if n_heads % tp == 0 else \
            (n_heads + tp - 1) // tp * tp
        return HeadLayout(kh, 1, n_heads, 1)
    g = n_heads // n_kv_heads
    g_pad = g
    while (n_kv_heads * g_pad) % tp:
        g_pad += 1
    return HeadLayout(n_kv_heads, g_pad, n_kv_heads, g)


def repeat_kv(k: torch.Tensor, group: int) -> torch.Tensor:
    """[..., Kh, Dh] -> [..., Kh*group, Dh]."""
    if group == 1:
        return k
    return torch.repeat_interleave(k, group, dim=-2)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_attention(pb: ParamBuilder, d: int, layout: HeadLayout, dh: int,
                   *, qkv_bias: bool = False, linear_bias: bool = False):
    h, kh = layout.q_heads, layout.kv_heads
    pb.param("wq", (d, h, dh), init="fan_in")
    pb.param("wk", (d, kh, dh), init="fan_in")
    pb.param("wv", (d, kh, dh), init="fan_in")
    pb.param("wo", (h, dh, d), init="fan_in")
    if qkv_bias or linear_bias:
        pb.param("bq", (h, dh), init="zeros")
        pb.param("bk", (kh, dh), init="zeros")
        pb.param("bv", (kh, dh), init="zeros")
    if linear_bias:
        pb.param("bo", (d,), init="zeros")


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("...d,dhk->...hk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def qkv_project(p: Params, x: torch.Tensor,
                kv_x: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B,S,D] -> q [B,S,H,Dh], k/v [B,Skv,Kh,Dh]."""
    src = x if kv_x is None else kv_x
    q = _proj(x, p["wq"])
    k = _proj(src, p["wk"])
    v = _proj(src, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def out_project(p: Params, o: torch.Tensor,
                head_mask: torch.Tensor) -> torch.Tensor:
    """o: [B,S,H,Dh] -> [B,S,D]; padded heads masked to keep math exact."""
    o = o * head_mask[:, None].to(o.dtype)
    h, k, d = p["wo"].shape
    y = o.flatten(-2) @ p["wo"].reshape(h * k, d)
    if "bo" in p:
        y = y + p["bo"]
    return y


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------

def naive_attention(q, k, v, *, causal: bool, window: int = 0,
                    cap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """Oracle. q [B,Sq,H,Dh]; k,v [B,Sk,Kh,Dh] -> [B,Sq,H,Dh]."""
    g = q.shape[2] // k.shape[2]
    kk, vv = repeat_kv(k, g), repeat_kv(v, g)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bshd->bhqs", q, kk).float() * scale
    if cap > 0:
        s = cap * torch.tanh(s / cap)
    qpos = torch.arange(q.shape[1], device=q.device) + q_offset
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", p.to(vv.dtype), vv)


def _online_block(carry, k_blk, v_blk, q_blk, mask, scale, cap):
    """One online-softmax step. carry = (o, m, l). q_blk [B,bq,H,D];
    k_blk/v_blk [B,bk,H,D] (already repeated)."""
    o, m, l = carry
    s = torch.einsum("bqhd,bshd->bhqs", q_blk, k_blk).float()
    s = s * scale
    if cap > 0:
        s = cap * torch.tanh(s / cap)
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    m_safe = torch.clamp_min(m_new, -1e30)
    p = torch.exp(s - m_safe[..., None])
    alpha = torch.exp(torch.clamp_min(m, -1e30) - m_safe)
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhqs,bshd->bhqd", p.to(v_blk.dtype), v_blk)
    o_new = o * alpha[..., None].to(o.dtype) + pv.to(o.dtype)
    return o_new, m_new, l_new


def blockwise_attention(q, k, v, *, causal: bool, cap: float = 0.0,
                        q_offset: int = 0, bq: int = 512,
                        bk: int = 512) -> torch.Tensor:
    """Flash-structured attention (loops over Q and KV blocks), as JAX's
    ``blockwise_attention``. q [B,Sq,H,D]; k,v [B,Sk,Kh,D]."""
    b, sq, h, dh = q.shape
    sk, kh = k.shape[1], k.shape[2]
    kk, vv = repeat_kv(k, h // kh), repeat_kv(v, h // kh)
    bq, bk = min(bq, sq), min(bk, sk)
    if sq % bq or sk % bk:
        raise ValueError(f"Sq={sq}, Sk={sk} must be multiples of the "
                         f"blocks {bq}, {bk}")
    scale = dh ** -0.5
    blocks = []
    for qi in range(sq // bq):
        q_blk = q[:, qi * bq:(qi + 1) * bq]
        qpos = qi * bq + torch.arange(bq, device=q.device) + q_offset
        carry = (torch.zeros((b, h, bq, dh), dtype=torch.float32,
                             device=q.device),
                 torch.full((b, h, bq), NEG_INF, dtype=torch.float32,
                            device=q.device),
                 torch.zeros((b, h, bq), dtype=torch.float32,
                             device=q.device))
        for ki in range(sk // bk):
            kpos = ki * bk + torch.arange(bk, device=q.device)
            mask = torch.ones((bq, bk), dtype=torch.bool, device=q.device)
            if causal:
                mask = mask & (qpos[:, None] >= kpos[None, :])
            sl = slice(ki * bk, (ki + 1) * bk)
            carry = _online_block(carry, kk[:, sl], vv[:, sl], q_blk, mask,
                                  scale, cap)
        o, _, l = carry
        o = o / torch.clamp_min(l, 1e-30)[..., None]
        blocks.append(o.transpose(1, 2))  # [B,bq,H,Dh]
    return torch.cat(blocks, dim=1).to(q.dtype)


def local_attention(q, k, v, *, window: int, cap: float = 0.0,
                    bq: int = 512) -> torch.Tensor:
    """Sliding-window causal self-attention, as JAX's ``local_attention``:
    each query block attends to the ``window + bq`` keys ending at its
    last row (a static span), so the cost is O(S * window)."""
    b, sq, h, dh = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if sq != sk:
        raise ValueError("local attention is self-attention")
    kk, vv = repeat_kv(k, h // kh), repeat_kv(v, h // kh)
    bq = min(bq, sq)
    if sq % bq:
        raise ValueError(f"S={sq} must be a multiple of the block {bq}")
    span = min(window + bq, sk)
    scale = dh ** -0.5
    blocks = []
    for qi in range(sq // bq):
        qs = qi * bq
        start = min(max(qs + bq - span, 0), sk - span)
        k_sl, v_sl = kk[:, start:start + span], vv[:, start:start + span]
        qpos = qs + torch.arange(bq, device=q.device)
        kpos = start + torch.arange(span, device=q.device)
        mask = (qpos[:, None] >= kpos[None, :]) & \
            (kpos[None, :] > qpos[:, None] - window)
        s = torch.einsum("bqhd,bshd->bhqs", q[:, qs:qs + bq], k_sl).float()
        s = s * scale
        if cap > 0:
            s = cap * torch.tanh(s / cap)
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        blocks.append(torch.einsum("bhqs,bshd->bqhd", p.to(v_sl.dtype),
                                   v_sl))
    return torch.cat(blocks, dim=1).to(q.dtype)


def attend(q, k, v, *, causal: bool, window: int = 0, cap: float = 0.0,
           impl: str = "pallas", q_offset: int = 0) -> torch.Tensor:
    """Dispatch over implementations, in the JAX package's order. q
    [B,S,H,D]; k,v [B,Sk,Kh,D].

    The kernel branch is tested before the short-prompt fallback, as in
    the JAX package, so with ``impl="pallas"`` every prompt runs it."""
    if impl in ("pallas", "interpret"):
        if q_offset:
            raise ValueError("the flash attention kernel takes q_offset=0")
        from repro_torch.kernels.flash_attention import ops as fa_ops
        fn = fa_ops.flash_attention if impl == "pallas" else \
            fa_ops.reference
        return fn(q, k, v, causal=causal, window=window, cap=cap)
    if impl == "naive" or q.shape[1] < 8:
        return naive_attention(q, k, v, causal=causal, window=window, cap=cap,
                               q_offset=q_offset)
    if impl != "blockwise":
        raise ValueError(f"attn_impl {impl!r} not in naive, blockwise, "
                         f"pallas, interpret")
    if window > 0 and q_offset == 0 and causal:
        return local_attention(q, k, v, window=window, cap=cap)
    return blockwise_attention(q, k, v, causal=causal, cap=cap,
                               q_offset=q_offset)


# ---------------------------------------------------------------------------
# Decode (single new token against a cache), plain PyTorch as in the JAX
# package, whose decode attention reaches no kernel.
# ---------------------------------------------------------------------------

def decode_attend(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, k_pos: torch.Tensor, pos: int, *,
                  window: int = 0, cap: float = 0.0) -> torch.Tensor:
    """q [B,H,Dh]; caches [B,Sc,Kh,Dh]; k_pos [B,Sc] absolute positions
    (-1 = empty). Returns [B,H,Dh]."""
    g = q.shape[1] // k_cache.shape[2]
    kk, vv = repeat_kv(k_cache, g), repeat_kv(v_cache, g)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhd,bshd->bhs", q, kk).float() * scale
    if cap > 0:
        s = cap * torch.tanh(s / cap)
    valid = (k_pos >= 0) & (k_pos <= pos)
    if window > 0:
        valid &= k_pos > pos - window
    s = s.masked_fill(~valid[:, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p.to(vv.dtype), vv)
