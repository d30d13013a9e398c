"""Flash-decoding: sequence-sharded KV-cache attention for a decode step.

PyTorch counterpart of ``repro/distributed/decode_attn.py``. The KV cache
is sharded [batch -> data axes, seq -> model] and stays so between
steps (a DTensor of each process's ``[B/dp, Sc/tp, Kh, Dh]`` block); the
new token's query (tiny) is replicated across the model axis. Every model
shard computes partial attention (m, l, o) over its KV slice for *all* Q
heads, the partials are combined with one pmax and two psums over
``model`` (O(B·H·Dh) bytes, not O(cache)), and the new token's K/V is
written, in place, only by the shard that owns its global ring slot.

The hook runs inside the model's layout (``sharding.Layout.run``; on a
mesh of one device also outside it). It receives this process's rows
and its block of q heads, and the cache DTensors as they are: it gathers the q heads over ``model`` (the reference's
``in_specs`` take every head), attends over its cache block, and keeps
the output of its own heads, as GSPMD reshards around the reference's
shard_map.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.compat import (all_gather, axis_index,
                                            axis_size, is_sharded_tensor,
                                            local_of, on_blocks, pmax, psum)
from repro_torch.models.attention import NEG_INF, repeat_kv


def _partial_attend(q, kc, vc, kp, pos: int, window: int, cap: float):
    """Local partial attention. q [B,H,D]; kc/vc [B,Sloc,Kh,D]; kp [B,Sloc].
    Returns (o [B,H,D] f32, m [B,H], l [B,H])."""
    g = q.shape[1] // kc.shape[2]
    kk, vv = repeat_kv(kc, g), repeat_kv(vc, g)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhd,bshd->bhs", q, kk).float() * scale
    if cap > 0:
        s = cap * torch.tanh(s / cap)
    valid = (kp >= 0) & (kp <= pos)
    if window > 0:
        valid &= kp > pos - window
    s = torch.where(valid[:, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - torch.clamp_min(m, -1e30)[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhs,bshd->bhd", p, vv.float())
    return o, m, l


def make_flash_decode(mesh):
    """Build the decode-attention fn with ``_jnp_decode_attn``'s
    signature: (k_cache, v_cache, kpos, k_new, v_new, q, pos, *, window,
    cap) -> (o [B_loc,H/tp,D], {'k','v','kpos'}), run inside the layout
    on this process's rows and q heads; the cache DTensors are written in
    place and come back as they are."""
    has_model = "model" in mesh.axis_names and mesh.shape["model"] > 1

    def flash_decode(k_cache, v_cache, kpos, k_new, v_new, q, pos: int, *,
                     window: int, cap: float):
        seq_ok = has_model and is_sharded_tensor(k_cache) and \
            any(pl.is_shard(1) for pl in k_cache.placements)
        write = k_new is not None
        n = q.shape[1]
        q_all = all_gather(q, "model", axis=1, tiled=True) if has_model \
            else q
        new = (k_new, v_new) if write else ()
        o = _inner(local_of(k_cache), local_of(v_cache), local_of(kpos),
                   q_all, pos, *new, seq_ok=seq_ok, write=write,
                   window=window, cap=cap)
        if has_model:
            o = o.narrow(1, axis_index("model") * n, n)
        return o, {"k": k_cache, "v": v_cache, "kpos": kpos}

    return on_blocks(flash_decode, mesh)


def _inner(kc, vc, kp, q_, pos_, *new, seq_ok: bool, write: bool,
           window: int, cap: float):
    """One process's flash-decoding step on its blocks: the owner of the
    new token's ring slot writes it, then partial attention over the
    block, combined over ``model`` when the ring is cut over it."""
    sc_loc = kc.shape[1]
    if seq_ok:
        midx = axis_index("model")
        nshard = axis_size("model")
    else:
        midx, nshard = 0, 1
    if write:
        kn, vn = new
        slot = pos_ % (sc_loc * nshard)   # global ring slot
        local = slot % sc_loc
        if slot // sc_loc == midx:  # the slot's owner writes it
            kc[:, local] = kn.to(kc.dtype)
            vc[:, local] = vn.to(vc.dtype)
            kp[:, local] = pos_
    o, m, l = _partial_attend(q_, kc, vc, kp, pos_, window, cap)
    if seq_ok:
        m_g = pmax(m, "model")
        corr = torch.exp(torch.clamp_min(m, -1e30) -
                         torch.clamp_min(m_g, -1e30))
        l_g = psum(l * corr, "model")
        o_g = psum(o * corr[..., None], "model")
    else:
        l_g, o_g = l, o
    out = o_g / torch.clamp_min(l_g, 1e-30)[..., None]
    return out.to(q_.dtype)
