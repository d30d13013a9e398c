"""Flash-decoding: sequence-sharded KV-cache attention for a decode step.

PyTorch counterpart of ``repro/distributed/decode_attn.py``. The KV cache
is sharded [batch -> data axes, seq -> model] and stays so between
steps (a DTensor of each process's ``[B/dp, Sc/tp, Kh, Dh]`` block); the
new token's query (tiny) is replicated across the model axis. Every model
shard computes partial attention (m, l, o) over its KV slice for *all* Q
heads, the partials are combined with one pmax and two psums over
``model`` (O(B·H·Dh) bytes, not O(cache)), and the new token's K/V is
written, in place, only by the shard that owns its global ring slot.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.compat import (P, axis_index, axis_size, pmax,
                                            psum, shard_map, to_replicated)
from repro_torch.distributed.mesh import batch_axes
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
    cap) -> (o [B,H,D], {'k','v','kpos'}). The cache leaves are written
    in place and come back in their layout; ``o`` comes back whole on
    every process (the residual stream is replicated)."""
    batch = batch_axes(mesh) or None
    has_model = "model" in mesh.axis_names and mesh.shape["model"] > 1

    dp = 1
    if batch:
        for a in (batch if isinstance(batch, tuple) else (batch,)):
            dp *= mesh.shape[a]

    def flash_decode(k_cache, v_cache, kpos, k_new, v_new, q, pos: int, *,
                     window: int, cap: float):
        write = k_new is not None
        b = k_cache.shape[0]
        bspec = batch if (batch and b % dp == 0) else None
        seq_ok = has_model and k_cache.shape[1] % mesh.shape["model"] == 0
        sspec = "model" if seq_ok else None

        def inner(kc, vc, kp, q_, pos_, *new):
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
            return out.to(q_.dtype), kc, vc, kp

        kv_spec = P(bspec, sspec, None, None)
        kp_spec = P(bspec, sspec)
        new_specs = (P(bspec, None, None),) * 2 if write else ()
        fn = shard_map(
            inner, mesh=mesh,
            in_specs=(kv_spec, kv_spec, kp_spec, P(bspec, None, None), P())
            + new_specs,
            out_specs=(P(bspec, None, None), kv_spec, kv_spec, kp_spec),
            check_vma=False)
        args = (k_cache, v_cache, kpos, q, pos) + \
            ((k_new, v_new) if write else ())
        o, kc, vc, kp = fn(*args)
        return to_replicated(o, mesh), {"k": kc, "v": vc, "kpos": kp}

    return flash_decode
