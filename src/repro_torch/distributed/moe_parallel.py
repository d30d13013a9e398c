"""MoE expert-(tensor-)parallelism over the 'model' mesh axis.

PyTorch counterpart of ``repro/distributed/moe_parallel.py``. Virtual-slot
scheme: slots = tp; slot ``s`` owns expert group ``s // inner`` and
FFN-hidden shard ``s % inner`` with ``inner = max(1, tp // n_experts)``.
Only full-axis collectives are needed: one all_to_all dispatches tokens,
and the inner-TP partial down-projections are summed with an
(inner-1)-step ppermute ring.

Three routes share router/dispatch semantics with ``models/moe.py``:

  make_moe_etp        - training/prefill: tokens are sequence-sharded over
                        'model'; dispatch is gather/scatter-based; tiled
                        all_to_all to the expert owners and back.
  make_moe_etp2d      - 2D expert parallelism (training): slots span
                        model x data, a two-hop all_to_all.
  make_moe_replicated - decode: tokens stay replicated over 'model'; every
                        shard computes its expert group's contribution
                        and one psum combines groups and inner F-shards.

Capacity is computed per shard from its own token count, ranks within an
expert and dropped (token, choice) pairs follow the reference exactly;
``route_stats`` counts the pairs each process routed and dropped. A
route runs inside the model's layout (``sharding.Layout.run``, the
reference's shard_map): it receives this process's rows and its blocks
of the expert stacks, and hands back its rows. The prefill and training
routes cut the rows' sequence over ``model`` and gather it back; the
decode route runs on the ``expert_f`` blocks the layout cuts over the
batch axes (the 2-D route, which gathers the rows outer axis major where
the reference's come out data-major) or on the whole expert FFNs. On a
mesh of one device a route may be called outside a shard_map (the blocks
are the whole tensors); on a larger one that is refused.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.compat import (all_gather, all_to_all,
                                            axis_index, axis_size, on_blocks,
                                            pmean, ppermute, psum)
from repro_torch.distributed.mesh import batch_axes, model_axis_size
from repro_torch.models.moe import (load_balance_loss, make_moe_layout,
                                    router_probs)

#: (token, choice) pairs this process routed ("pairs") and dropped over
#: capacity ("dropped"), as device tensors; reset with ``reset_route_stats``
route_stats: Dict[str, torch.Tensor] = {}


def reset_route_stats() -> None:
    route_stats.clear()


def _count(keep: torch.Tensor) -> None:
    for k, v in (("pairs", keep.numel()), ("dropped", (~keep).sum())):
        route_stats[k] = route_stats.get(k, 0) + v


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _route_and_slot(p, x_flat, cfg: ModelConfig, cap: int):
    """Shared routing: returns (slot [T*k], keep [T*k], gates_flat [T*k],
    aux). slot = expert_id * cap + rank-within-expert."""
    gates, ids, probs = router_probs(p, x_flat, cfg)
    e = cfg.moe.n_experts
    t, k = ids.shape
    ids_flat = ids.reshape(-1)
    gates_flat = gates.reshape(-1).float()
    order = torch.argsort(ids_flat, stable=True)
    sorted_ids = ids_flat[order]
    ranks_sorted = torch.arange(t * k, device=ids.device) - \
        torch.searchsorted(sorted_ids, sorted_ids, right=False)
    ranks = torch.zeros((t * k,), dtype=torch.int64, device=ids.device)
    ranks[order] = ranks_sorted
    keep = ranks < cap
    slot = ids_flat * cap + torch.clamp_max(ranks, cap - 1)
    aux = load_balance_loss(probs, ids, e)
    _count(keep)
    return slot, keep, gates_flat, aux


def _dispatch(x_flat, slot, keep, e: int, cap: int):
    """Scatter tokens into [E, cap, D] capacity buffer (dropped -> zero)."""
    d = x_flat.shape[-1]
    src = torch.where(keep, slot, e * cap)  # dropped rows -> overflow slot
    buf = x_flat.new_zeros((e * cap + 1, d))
    k = slot.shape[0] // x_flat.shape[0]
    xk = torch.repeat_interleave(x_flat, k, dim=0)  # choice j of token t
    buf = buf.index_copy(0, src, xk)  # at row t*k+j; kept slots unique
    return buf[:-1].reshape(e, cap, d)


def _combine(y_buf, slot, keep, gates_flat, t: int):
    """Gather expert outputs back to tokens with gate weighting."""
    d = y_buf.shape[-1]
    flat = y_buf.reshape(-1, d)
    y = flat[slot] * (gates_flat * keep)[:, None].to(flat.dtype)
    return y.reshape(t, -1, d).sum(dim=1)


def _expert_ffn(recv, wi, wg, wo):
    """recv [..., el, cap, D] batched over leading dims; w* [el, D, Fl]
    (wo [el, Fl, D]). The reference's einsums, one expert at a time, so
    the [..., cap, Fl] intermediates of one expert only are live."""
    out = []
    for j in range(wi.shape[0]):
        x = recv[..., j, :, :]
        h = x @ wi[j]
        g = x @ wg[j]
        h = F.silu(g.float()).to(h.dtype) * h
        out.append(h @ wo[j])
    return torch.stack(out, dim=-3)


def _on_rows(inner_fn, x, p, tp: int):
    """A sequence-sharded route inside the layout: this process's block
    of its rows' sequence over ``model``, the route, and the sequence
    gathered back (``x`` [B_loc, S, D])."""
    if tp > 1:
        n = x.shape[1] // tp
        x = x.narrow(1, axis_index("model") * n, n)
    y, aux = inner_fn(x, p["router"], p["wi"], p["wg"], p["wo"])
    if tp > 1:
        y = all_gather(y, "model", axis=1, tiled=True)
    return y, aux


def make_moe_etp(mesh):
    """Sequence-sharded ETP path. Signature: (params, x [B_loc,S,D], cfg)
    -> (y [B_loc,S,D], aux), on this process's rows and expert blocks."""
    tp = model_axis_size(mesh)
    all_axes = tuple(mesh.axis_names)

    def moe_fn(p, x, cfg: ModelConfig):
        layout = make_moe_layout(cfg, tp)
        e = cfg.moe.n_experts
        groups, inner, el = layout.groups, layout.inner, layout.e_loc

        def inner_fn(xl, router, wi, wg, wo):
            b_loc, s_loc, d = xl.shape
            t = b_loc * s_loc
            x_flat = xl.reshape(t, d)
            cap = _round_up(max(1, int(t * cfg.moe.top_k *
                                       cfg.moe.capacity_factor / e)), 8)
            slot, keep, gates_flat, aux = _route_and_slot(
                {"router": router}, x_flat, cfg, cap)
            x_disp = _dispatch(x_flat, slot, keep, e, cap)  # [E, cap, D]
            xg = x_disp.reshape(groups, el, cap, d)
            if inner > 1:  # replicate each group's tokens to its F-shards
                xg = xg[:, None].expand(groups, inner, el, cap, d)
            x_send = xg.reshape(tp, el, cap, d)
            recv = all_to_all(x_send, "model", 0, 0, tiled=True)
            # recv [tp(src), el, cap, D]; FFN with my F-shard
            y_part = _expert_ffn(recv, wi[0], wg[0], wo[0])
            if inner > 1:  # ring-sum partial down-projections within group
                acc = y_part
                for sigma in range(1, inner):
                    perm = [(s, (s // inner) * inner + (s % inner + sigma)
                             % inner) for s in range(tp)]
                    acc = acc + ppermute(y_part, "model", perm)
                y_part = acc
            back = all_to_all(y_part, "model", 0, 0, tiled=True)
            # back [tp(slot), el, cap, D]; group g data identical across its
            # inner slots -> read the r==0 copy.
            y_buf = back.reshape(groups, inner, el, cap, d)[:, 0] \
                .reshape(e, cap, d)
            y = _combine(y_buf, slot, keep, gates_flat, t)
            aux = pmean(aux, all_axes)
            return y.reshape(b_loc, s_loc, d), aux

        return _on_rows(inner_fn, x, p, tp)

    return on_blocks(moe_fn, mesh)


def make_moe_etp2d(mesh):
    """2D expert-parallel training path: expert slots span model x data
    (slots = tp*dp), so the weights are fully resident; tokens travel
    instead, a two-hop all_to_all (over 'model', then over each batch
    axis) to the owning slot, and the partial down-projections of inner
    F-shards ring-sum with a ppermute over the innermost batch axis."""
    baxes = batch_axes(mesh)
    tp = model_axis_size(mesh)
    all_axes = tuple(mesh.axis_names)
    dp = 1
    for a in baxes:
        dp *= mesh.shape[a]

    def moe_fn(p, x, cfg: ModelConfig):
        layout = make_moe_layout(cfg, tp, dp)
        e = cfg.moe.n_experts
        slots, inner, el = layout.slots, layout.inner, layout.e_loc
        groups = layout.groups
        last_ax = baxes[-1]
        last_n = mesh.shape[last_ax]
        assert last_n % inner == 0, (last_n, inner)

        def inner_fn(xl, router, wi, wg, wo):
            b_loc, s_loc, d = xl.shape
            t = b_loc * s_loc
            x_flat = xl.reshape(t, d)
            cap = _round_up(max(1, int(t * cfg.moe.top_k *
                                       cfg.moe.capacity_factor / e)), 4)
            slot, keep, gates_flat, aux = _route_and_slot(
                {"router": router}, x_flat, cfg, cap)
            x_disp = _dispatch(x_flat, slot, keep, e, cap)  # [E, cap, D]
            xg = x_disp.reshape(groups, el, cap, d)
            if inner > 1:
                xg = xg[:, None].expand(groups, inner, el, cap, d)
            x_send = xg.reshape(slots, el, cap, d)

            def hops(z, reverse=False):
                # dims: [tp, *batch_axis_sizes, el, cap, d]
                z = z.reshape((tp,) + tuple(mesh.shape[a] for a in baxes)
                              + (el, cap, d))
                seq = [("model", 0)] + [(a, 1 + i)
                                        for i, a in enumerate(baxes)]
                for ax, dim in (reversed(seq) if reverse else seq):
                    z = all_to_all(z, ax, dim, dim, tiled=True)
                return z.reshape(slots, el, cap, d)

            recv = hops(x_send)
            y_part = _expert_ffn(recv, wi[0, 0], wg[0, 0], wo[0, 0])
            if inner > 1:  # ring-sum F-shard partials (same-group slots
                # are consecutive in the innermost batch axis)
                acc = y_part
                for sigma in range(1, inner):
                    perm = [(i, (i // inner) * inner +
                             (i % inner + sigma) % inner)
                            for i in range(last_n)]
                    acc = acc + ppermute(y_part, last_ax, perm)
                y_part = acc
            back = hops(y_part, reverse=True)
            y_buf = back.reshape(groups, inner, el, cap, d)[:, 0] \
                .reshape(e, cap, d)
            y = _combine(y_buf, slot, keep, gates_flat, t)
            aux = pmean(aux, all_axes)
            return y.reshape(b_loc, s_loc, d), aux

        return _on_rows(inner_fn, x, p, tp)

    return on_blocks(moe_fn, mesh)


def make_moe_replicated(mesh, expert_2d: bool = False):
    """Decode path: tokens replicated over 'model'; one psum combines expert
    groups and inner F-shards.

    expert_2d: additionally shard the experts' FFN hidden dim over the
    *data* axes so giant MoEs stay fully resident; tokens (tiny at decode)
    are all-gathered over the data axes instead, and the final psum runs
    over every mesh axis at once, folding expert-group, inner-TP and
    data-F partial sums together. The layout must cut ``expert_f`` over
    the batch axes for it (``sharding.Plan.overrides``).
    """
    baxes = batch_axes(mesh)
    tp = model_axis_size(mesh)
    all_axes = tuple(mesh.axis_names)
    dp = 1
    for a in baxes:
        dp *= mesh.shape[a]

    def moe_fn(p, x, cfg: ModelConfig):
        layout = make_moe_layout(cfg, tp)
        e = cfg.moe.n_experts
        groups, inner, el = layout.groups, layout.inner, layout.e_loc
        # the 2-D route where the layout cuts expert_f over the batch axes
        # (``Plan.overrides``; the cut is dropped where dp does not divide)
        use_2d = expert_2d and dp > 1 and layout.f_loc % dp == 0

        def inner_fn(xl, router, wi, wg, wo):
            b_loc, s, d = xl.shape
            xg = xl
            if use_2d:  # gather the (tiny) token batch across data axes,
                # outer axis major: the rows sliced back out below are then
                # this process's own (the reference gathers one axis at a
                # time, pod first, so with two batch axes of size > 1 its
                # rows come out data-major and another process's are
                # sliced out: ROADMAP, behaviour not copied)
                xg = all_gather(xg, baxes, axis=0, tiled=True)
            b_tot = xg.shape[0]
            t = b_tot * s
            x_flat = xg.reshape(t, d)
            cap = _round_up(max(1, int(t * cfg.moe.top_k *
                                       cfg.moe.capacity_factor / e)), 4)
            slot, keep, gates_flat, aux = _route_and_slot(
                {"router": router}, x_flat, cfg, cap)
            x_disp = _dispatch(x_flat, slot, keep, e, cap)  # [E, cap, D]
            g_idx = axis_index("model") // inner if tp > 1 else 0
            x_mine = x_disp.reshape(groups, el, cap, d)[g_idx]
            y_part = _expert_ffn(x_mine[None], wi[0], wg[0], wo[0])[0]
            # place my experts' outputs into the full [E, cap, D] frame
            y_all = y_part.new_zeros((groups, el, cap, d))
            y_all[g_idx] = y_part
            y_tok = _combine(y_all.reshape(e, cap, d), slot, keep,
                             gates_flat, t)
            if use_2d:
                y_tok = psum(y_tok, all_axes)
                # slice my batch rows back out
                idx = 0
                stride = b_tot
                for ax in baxes:
                    stride = stride // axis_size(ax)
                    idx = idx + axis_index(ax) * stride
                y_tok = y_tok.reshape(b_tot, s, d)[idx:idx + b_loc]
                aux = pmean(aux, all_axes)
                return y_tok, aux
            if tp > 1:
                y_tok = psum(y_tok, "model")
            aux = pmean(aux, all_axes)
            return y_tok.reshape(b_loc, s, d), aux

        return inner_fn(x, p["router"], p["wi"], p["wg"], p["wo"])

    return on_blocks(moe_fn, mesh)
