"""AdamW with float32 or int8 blockwise moments, functional as JAX's.

PyTorch counterpart of ``repro/train/optimizer.py``:
``AdamWConfig``, ``lr_at`` (linear warmup), ``init_opt_state``,
``global_norm`` and ``apply_updates``, which returns new parameter and
moment tensors and leaves its inputs as they are (a background
checkpoint may still be reading them). Every step of the update is the
reference's float32 operation in its order; ``b1 ** step`` is taken in
float32, as JAX takes it. The update runs leaf by leaf, a large leaf in
slabs, so its float32 temporaries stay a few GB at gemma2-9b's
vocabulary. A DTensor leaf (a block of a leaf the mesh cuts) is
updated on its block, its moments are blocks of the same shape, and its
part of the global norm is summed over the mesh dims that cut it, so the
norm is that of the whole gradient on every process, as JAX's.

ZeRO-1 (``zero``, a ``Zero1`` from ``train_step.zero1_plan``): the
moments are laid out as JAX's ``opt_state_specs`` under
``tree_shardings(..., zero1=True)``, the parameter's layout plus a cut
over the batch axes. Each process updates its moments' block on the
matching slice of its parameter and gradient blocks, then gathers the
new parameter over the batch axes, as GSPMD partitions JAX's update. A
gradient that arrives already cut as its moments (ZeRO-2,
``Zero1.grad``) is not cut again; a parameter the layout's FSDP cut
already cuts as its moments is updated on its block and keeps it (no
gather).

``moments_dtype="int8"`` keeps JAX's blockwise moment codec and state
tree, ``{"m": {"q", "scale"}, "v": {"q", "lo", "rng"}}``: the trailing
dims of a leaf (all but ``max(ndim - 2, 0)`` leading ones) are flattened
into blocks of ``QBLOCK`` elements, zero-padded; ``m`` is signed absmax
int8 a block, ``v`` int8 codes of ``log2(v)`` between the block's
``lo`` and ``lo + rng``. These are plain tensor operations: JAX computes
them outside any TPU kernel. A slab of an int8 leaf is a run of whole
blocks, so the codes equal those of the whole leaf. On a mesh the blocks
are those of the whole leaf (a leaf whose trailing dims the layout cuts
over ``model`` is gathered for its update), and ZeRO-1 cuts the codes
and their scales on the same dim, never inside a block.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.bridge import tree_from_leaves, tree_leaves, tree_map
from repro_torch.distributed.compat import (P, all_gather, is_sharded_tensor,
                                            like_sharded, local_block,
                                            local_of, on_mesh, psum_shards,
                                            spec_axes)
from repro_torch.distributed.sharding import added_cut

Params = Dict[str, Any]

#: elements of a leaf updated at once (a slab of whole rows, or of whole
#: quantization blocks)
_SLAB = 1 << 27

QBLOCK = 256  # small block so padded tails stay cheap


# ---------------------------------------------------------------------------
# int8 blockwise moment codec
# ---------------------------------------------------------------------------

def _kept_dims(shape) -> int:
    """Leading dims kept out of the blocks (layer stacks, expert slots):
    quantization never crosses them."""
    return max(len(shape) - 2, 0)


def _to_blocks(x: torch.Tensor) -> torch.Tensor:
    k = _kept_dims(x.shape)
    lead = tuple(x.shape[:k])
    flat = x.reshape(lead + (-1,))
    pad = (-flat.shape[-1]) % QBLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(lead + (-1, QBLOCK))


def _from_blocks(xb: torch.Tensor, shape) -> torch.Tensor:
    k = _kept_dims(shape)
    lead = tuple(shape[:k])
    n = 1
    for s in shape[k:]:
        n *= s
    return xb.reshape(lead + (-1,))[..., :n].reshape(tuple(shape))


def _q8_encode(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Signed blockwise absmax int8 (first moment)."""
    return _q8_encode_blocks(_to_blocks(x))


def _q8_encode_blocks(xb: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``_q8_encode`` of ``[..., blocks, QBLOCK]``. The divisor is a
    tensor: on the card a division by a host scalar is a multiplication
    by its reciprocal, which rounds some scales away from JAX's."""
    absmax = xb.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax / absmax.new_full((), 127.0), 1e-20)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale[..., 0]}


def _q8_decode(st: Dict[str, torch.Tensor], shape) -> torch.Tensor:
    return _from_blocks(_q8_decode_blocks(st), shape)


def _q8_decode_blocks(st: Dict[str, torch.Tensor]) -> torch.Tensor:
    return st["q"].float() * st["scale"][..., None]


def _q8v_encode(v: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Log-space asymmetric int8 for the second moment (v spans orders of
    magnitude): codes of log2(v) between the block's min and max."""
    return _q8v_encode_blocks(_to_blocks(v))


def _q8v_encode_blocks(xb: torch.Tensor) -> Dict[str, torch.Tensor]:
    lv = torch.log2(torch.clamp_min(xb, 1e-30))
    lo = lv.amin(dim=-1, keepdim=True)
    rng = torch.clamp_min(lv.amax(dim=-1, keepdim=True) - lo, 1e-6)
    q = torch.clamp(torch.round((lv - lo) / rng * 255.0) - 128, -128,
                    127).to(torch.int8)
    return {"q": q, "lo": lo[..., 0], "rng": rng[..., 0]}


def _q8v_decode(st: Dict[str, torch.Tensor], shape) -> torch.Tensor:
    return _from_blocks(_q8v_decode_blocks(st), shape)


def _q8v_decode_blocks(st: Dict[str, torch.Tensor]) -> torch.Tensor:
    t = (st["q"].float() + 128.0) / 255.0
    lv = st["lo"][..., None] + t * st["rng"][..., None]
    v = torch.exp2(lv)
    return torch.where(v <= 2e-30, torch.zeros_like(v), v)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moments_dtype: str = "float32"   # float32 | int8
    warmup: int = 100


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp_max(step.float() / max(cfg.warmup, 1), 1.0)
    return cfg.lr * warm


@dataclasses.dataclass(frozen=True)
class Zero1:
    """The moments' layout on a mesh (``train_step.zero1_plan``): by
    parameter path, the parameter's ``P`` under the model's layout and
    its whole shape; by moment path (``{path}/m``, ``{path}/m/q``, ...)
    the moment's ``P``."""
    mesh: object
    param: Dict[str, P]
    moment: Dict[str, P]
    shape: Dict[str, Tuple[int, ...]]
    #: by parameter path, the ``P`` its gradient arrives in (ZeRO-2's
    #: ``grad_shardings``; None: the parameter's)
    grad: Optional[Dict[str, P]] = None

    def grad_cut(self, path: str, ndim: int):
        """(dim, batch axes) the gradient's layout adds to the
        parameter's, or None."""
        if self.grad is None:
            return None
        return added_cut(self.param[path], self.grad[path], ndim, self.mesh)

    def cut(self, base: P, path: str, ndim: int):
        """(dim, batch axes) the moment ``path`` adds to ``base`` (the
        parameter's layout on its dims), or None."""
        return added_cut(base, self.moment[path], ndim, self.mesh)


def int8_zero1(moment):
    """The int8 moments' shardings with the codes ``q`` cut as their
    ``scale`` (``tree_shardings``' ZeRO-1 choice over the blocks' dims),
    so that no quantisation block crosses a process."""
    if "m" in moment and isinstance(moment["m"], dict) and \
            "q" in moment["m"]:
        s = moment["m"]["scale"]
        q = type(s)(s.mesh, P(*(tuple(s.spec) + (None,))))
        return {"m": {"q": q, "scale": s},
                "v": {"q": q, "lo": s, "rng": s}}
    return {k: int8_zero1(v) for k, v in moment.items()}


def _zero_moments(shape, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The int8 codes of zero moments of a leaf of ``shape``, expanded
    (no storage). Every block of a zero leaf (its padding included)
    encodes alike, so one block is encoded and its codes filled in,
    without a float32 leaf of zeros."""
    k = _kept_dims(shape)
    lead = tuple(shape[:k])
    n = 1
    for d in shape[k:]:
        n *= d
    nblk = -(-n // QBLOCK)
    one = torch.zeros(QBLOCK, dtype=torch.float32, device=device)

    def fill(codes):
        return {key: (t.expand(lead + (nblk, QBLOCK)) if key == "q"
                      else t.expand(lead + (nblk,)))
                for key, t in codes.items()}
    return {"m": fill(_q8_encode(one)), "v": fill(_q8v_encode(one))}


def init_opt_state(params: Params, cfg: AdamWConfig,
                   zero: Optional[Zero1] = None) -> Params:
    """Zero moments: each parameter's block (its local tensor), or with
    ``zero`` this process's block of each moment under the ZeRO-1
    layout."""
    def one(path, p):
        shape = zero.shape[path] if zero is not None else \
            tuple(local_of(p).shape)
        if cfg.moments_dtype == "int8":
            codes = _zero_moments(shape, p.device)
        else:
            z = torch.zeros((), dtype=torch.float32, device=p.device)
            codes = {"m": z.expand(shape), "v": z.expand(shape)}
        if zero is not None:
            codes = tree_from_leaves({
                k: local_block(t, zero.moment[f"{path}/{k}"], zero.mesh)
                for k, t in tree_leaves(codes)})
        return tree_map(lambda t: t.contiguous(), codes)

    moments = tree_from_leaves({path: one(path, p)
                                for path, p in tree_leaves(params)})
    dev = tree_leaves(params)[0][1].device
    return {"moments": moments,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_state_specs(param_specs, cfg: AdamWConfig):
    """Logical-axes tree for the optimizer state, as JAX's (ZeRO handled
    at the mesh-mapping layer via the 'zero' pseudo-axis on the q/scale
    blocks)."""
    def one(spec):
        if isinstance(spec, dict):
            return {k: one(v) for k, v in spec.items()}
        if cfg.moments_dtype == "int8":
            # blocks keep the param's (sharded) leading dims
            lead = tuple(spec[:max(len(spec) - 2, 0)])
            return {"m": {"q": lead + (None, None),
                          "scale": lead + (None,)},
                    "v": {"q": lead + (None, None), "lo": lead + (None,),
                          "rng": lead + (None,)}}
        return {"m": tuple(spec), "v": tuple(spec)}
    return {"moments": one(param_specs), "step": ()}


def global_norm(tree, like=None) -> torch.Tensor:
    """The norm of the whole tree; a DTensor leaf, or a leaf whose
    counterpart in ``like`` (the parameters) is a DTensor, holds that
    DTensor's block, and its sum of squares is summed over the mesh dims
    that cut it."""
    refs = dict(tree_leaves(like)) if like is not None else {}
    sums = []
    for path, x in tree_leaves(tree):
        sq = torch.sum(torch.square(local_of(x).float()))
        ref = x if is_sharded_tensor(x) else refs.get(path)
        sums.append(psum_shards(sq, ref) if is_sharded_tensor(ref) else sq)
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
                  cfg: AdamWConfig, zero: Optional[Zero1] = None
                  ) -> Tuple[Params, Params, torch.Tensor]:
    """Returns (new_params, new_state, grad_norm). With ``zero`` the
    moments are this process's ZeRO-1 blocks (``init_opt_state``)."""
    step = state["step"] + 1
    gnorm = global_norm(grads, like=params)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12),
                            1.0) if cfg.clip_norm > 0 else 1.0
    lr = lr_at(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def laid_out(path, p, g, mo):
        gcut = zero.grad_cut(path, p.dim())
        if cfg.moments_dtype == "int8":
            if gcut is not None:  # back to the parameter's layout
                with on_mesh(zero.mesh):
                    g = all_gather(g, gcut[1], axis=gcut[0], tiled=True)
            return _update_int8_laid_out(path, p, g, mo, scale, lr, b1c,
                                         b2c, cfg, zero)
        cut = zero.cut(zero.param[path], f"{path}/m", p.dim())
        if cut is None:
            return one(p, g, mo)
        d, axes = cut
        if gcut is not None and gcut != (d, tuple(axes)):
            raise ValueError(f"{path}: gradient cut {gcut}, moments {cut}")
        with on_mesh(zero.mesh):
            newp, mo = one(local_block(p, cut_spec(d, axes), zero.mesh),
                           g if gcut is not None else
                           local_block(g, cut_spec(d, axes), zero.mesh), mo)
            return all_gather(newp, axes, axis=d, tiled=True), mo

    def one(p, g, mo):
        if cfg.moments_dtype == "int8":
            return _update_int8(p, g, mo, scale, lr, b1c, b2c, cfg)
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
    out = {}
    for path, p in tree_leaves(params):
        args = (local_of(p), local_of(flat_g[path]),
                _get(state["moments"], path))
        out[path] = one(*args) if zero is None else laid_out(path, *args)
    flat_p = dict(tree_leaves(params))
    new_params = tree_from_leaves({p: like_sharded(o[0], flat_p[p])
                                   for p, o in out.items()})
    new_moments = tree_from_leaves({p: o[1] for p, o in out.items()})
    return new_params, {"moments": new_moments, "step": step}, gnorm


def _update_int8(p, g, mo, scale, lr, b1c, b2c, cfg: AdamWConfig):
    """One leaf with int8 moments: decode, update and encode again, a
    slab of whole blocks at a time (``_update_blocks``; blocks are
    independent, so the codes are those of the whole leaf, zero padding
    of the last block included)."""
    n = p[(0,) * _kept_dims(p.shape)].numel()
    newb, moments = _update_blocks(_to_blocks(p), _to_blocks(g), mo,
                                   _padding_mask(n, p.device), scale, lr,
                                   b1c, b2c, cfg)
    return _from_blocks(newb, tuple(p.shape)), moments


def _padding_mask(n: int, device=None):
    """``[blocks, QBLOCK]`` True on the first ``n`` elements of a leaf's
    blocks, or None when ``n`` fills them (no padding)."""
    if n % QBLOCK == 0:
        return None
    nb = -(-n // QBLOCK)
    return (torch.arange(nb * QBLOCK, device=device) < n).reshape(nb, QBLOCK)


def cut_spec(d: int, axes) -> P:
    """A ``P`` that cuts dim ``d`` over ``axes`` and nothing else."""
    return P(*([None] * d), tuple(axes))



def _update_int8_laid_out(path, p, g, mo, scale, lr, b1c, b2c,
                          cfg: AdamWConfig, zero: Zero1):
    """One int8 leaf on a mesh: the parameter and gradient blocks
    gathered whole over their trailing (blocked) dims, cut into the
    whole leaf's quantisation blocks, narrowed to this process's ZeRO-1
    slice of them; the slice updated and encoded, the new parameter
    gathered back over the batch axes and cut to its block again. A
    block cut on its first blocked dim into whole quantisation blocks,
    as its moments are (an FSDP-cut embedding), is its moments' slice of
    the blocks as it is: it is updated without a gather."""
    mesh = zero.mesh
    shape = zero.shape[path]
    k = _kept_dims(shape)
    pax = spec_axes(zero.param[path], len(shape), mesh)
    n = 1
    for s in shape[k:]:
        n *= s
    base = P(*(tuple(zero.param[path])[:k] + (None,) * 2))
    cut = zero.cut(base, f"{path}/m/q", k + 2)
    row = n // shape[k] if len(shape) > k else n
    if cut is not None and cut == (k, tuple(pax[k])) and \
            not any(pax[k + 1:]) and row % QBLOCK == 0:
        newb, moments = _update_blocks(_to_blocks(p), _to_blocks(g), mo,
                                       None, scale, lr, b1c, b2c, cfg)
        return newb.reshape(p.shape), moments
    with on_mesh(mesh):
        pw, gw = p, g
        for d in range(k, len(shape)):
            if pax[d]:
                pw = all_gather(pw, pax[d], axis=d, tiled=True)
                gw = all_gather(gw, pax[d], axis=d, tiled=True)
        pb, gb = _to_blocks(pw), _to_blocks(gw)
        valid = _padding_mask(n, pb.device)
        if cut is not None:
            d, axes = cut
            pb = local_block(pb, cut_spec(d, axes), mesh)
            gb = local_block(gb, cut_spec(d, axes), mesh)
            if d == k and valid is not None:
                valid = local_block(valid, P(tuple(axes)), mesh)
        newb, moments = _update_blocks(pb, gb, mo, valid, scale, lr, b1c,
                                       b2c, cfg)
        if cut is not None:
            newb = all_gather(newb, axes, axis=d, tiled=True)
        neww = _from_blocks(newb, tuple(pw.shape))
        for d in range(k, len(shape)):
            if pax[d]:
                neww = local_block(neww, cut_spec(d, pax[d]), mesh)
    return neww.contiguous(), moments


def _update_blocks(pb, gb, mo, valid, scale, lr, b1c, b2c,
                   cfg: AdamWConfig):
    """``_update_slab`` on parameter and gradient blocks ``[..., nb,
    QBLOCK]`` with their int8 moments, a slab of whole blocks at a time
    (``_SLAB`` elements: its float32 temporaries stay a few GB); the
    padding ``valid`` (None: none) masks out of the moments. Returns (new
    blocks, new moments): blocks are independent, so the codes are those
    of one pass."""
    nb = pb.shape[-2]
    step = max(1, _SLAB // max(pb[..., 0, :].numel(), 1))
    newb = torch.empty_like(pb)
    out = {"m": {k: torch.empty_like(t) for k, t in mo["m"].items()},
           "v": {k: torch.empty_like(t) for k, t in mo["v"].items()}}

    def blk(st, sl):
        return {k: t[..., sl, :] if k == "q" else t[..., sl]
                for k, t in st.items()}

    for b0 in range(0, nb, step):
        sl = slice(b0, b0 + step)
        newb[..., sl, :], m1, v1 = _update_slab(
            pb[..., sl, :], gb[..., sl, :], _q8_decode_blocks(blk(mo["m"],
                                                                  sl)),
            _q8v_decode_blocks(blk(mo["v"], sl)), scale, lr, b1c, b2c, cfg)
        if valid is not None:
            m1, v1 = m1 * valid[sl], v1 * valid[sl]
        for key, codes in (("m", _q8_encode_blocks(m1)),
                           ("v", _q8v_encode_blocks(v1))):
            for k, t in codes.items():
                blk(out[key], sl)[k].copy_(t)
        del m1, v1
    return newb, out


def _get(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree
