"""AdamW with float32 or int8 blockwise moments, functional as JAX's.

PyTorch counterpart of ``repro/train/optimizer.py`` on one device:
``AdamWConfig``, ``lr_at`` (linear warmup), ``init_opt_state``,
``global_norm`` and ``apply_updates``, which returns new parameter and
moment tensors and leaves its inputs as they are (a background
checkpoint may still be reading them). Every step of the update is the
reference's float32 operation in its order; ``b1 ** step`` is taken in
float32, as JAX takes it. The update runs leaf by leaf, a large leaf in
slabs, so its float32 temporaries stay a few GB at gemma2-9b's
vocabulary. ZeRO sharding belongs to the distributed slice.

``moments_dtype="int8"`` keeps JAX's blockwise moment codec and state
tree, ``{"m": {"q", "scale"}, "v": {"q", "lo", "rng"}}``: the trailing
dims of a leaf (all but ``max(ndim - 2, 0)`` leading ones) are flattened
into blocks of ``QBLOCK`` elements, zero-padded; ``m`` is signed absmax
int8 a block, ``v`` int8 codes of ``log2(v)`` between the block's
``lo`` and ``lo + rng``. These are plain tensor operations: JAX computes
them outside any TPU kernel. A slab of an int8 leaf is a run of whole
blocks, so the codes equal those of the whole leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.bridge import tree_from_leaves, tree_leaves, tree_map

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


def _zero_moments(p: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
    """The int8 codes of zero moments of ``p``'s shape. Every block of a
    zero leaf (its padding included) encodes alike, so one block is
    encoded and its codes filled in, without a float32 leaf of zeros."""
    k = _kept_dims(p.shape)
    lead = tuple(p.shape[:k])
    nblk = -(-p[(0,) * k].numel() // QBLOCK)
    one = torch.zeros(QBLOCK, dtype=torch.float32, device=p.device)

    def fill(codes):
        return {key: (t.expand(lead + (nblk, QBLOCK)) if key == "q"
                      else t.expand(lead + (nblk,))).contiguous()
                for key, t in codes.items()}
    return {"m": fill(_q8_encode(one)), "v": fill(_q8v_encode(one))}


def init_opt_state(params: Params, cfg: AdamWConfig) -> Params:
    if cfg.moments_dtype == "int8":
        moments = tree_map(_zero_moments, params)
    else:
        moments = tree_map(
            lambda p: {"m": torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device),
                       "v": torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)}, params)
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
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12),
                            1.0) if cfg.clip_norm > 0 else 1.0
    lr = lr_at(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

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
    out = {path: one(p, flat_g[path], _get(state["moments"], path))
           for path, p in tree_leaves(params)}
    new_params = tree_from_leaves({p: o[0] for p, o in out.items()})
    new_moments = tree_from_leaves({p: o[1] for p, o in out.items()})
    return new_params, {"moments": new_moments, "step": step}, gnorm


def _update_int8(p, g, mo, scale, lr, b1c, b2c, cfg: AdamWConfig):
    """One leaf with int8 moments: decode, update and encode again, a
    slab of whole blocks at a time (blocks are independent, so the codes
    are those of the whole leaf, zero padding of the last block
    included)."""
    k = _kept_dims(p.shape)
    lead = tuple(p.shape[:k])
    n = p[(0,) * k].numel()
    nblk = -(-n // QBLOCK)
    pf, gf = p.reshape(lead + (n,)), g.reshape(lead + (n,))
    newp = torch.empty_like(pf)
    m = {"q": torch.empty_like(mo["m"]["q"]),
         "scale": torch.empty_like(mo["m"]["scale"])}
    v = {key: torch.empty_like(t) for key, t in mo["v"].items()}
    width = 1
    for d in lead:
        width *= d
    step = max(1, _SLAB // (QBLOCK * width))
    for b0 in range(0, nblk, step):
        b1 = min(b0 + step, nblk)
        e0, e1 = b0 * QBLOCK, min(b1 * QBLOCK, n)

        def blk(st):
            return {key: t[..., b0:b1, :] if key == "q" else t[..., b0:b1]
                    for key, t in st.items()}

        def flat(xb):
            return xb.reshape(lead + (-1,))[..., :e1 - e0]

        def blocks(x):  # zero-padded to whole blocks, as _to_blocks
            x = torch.nn.functional.pad(x, (0, (b1 - b0) * QBLOCK -
                                            (e1 - e0)))
            return x.reshape(lead + (b1 - b0, QBLOCK))
        m0 = flat(_q8_decode_blocks(blk(mo["m"])))
        v0 = flat(_q8v_decode_blocks(blk(mo["v"])))
        np_, m1, v1 = _update_slab(pf[..., e0:e1], gf[..., e0:e1], m0, v0,
                                   scale, lr, b1c, b2c, cfg)
        del m0, v0
        newp[..., e0:e1] = np_
        for dst, src in ((m, _q8_encode_blocks(blocks(m1))),
                         (v, _q8v_encode_blocks(blocks(v1)))):
            for key, t in src.items():
                if key == "q":
                    dst[key][..., b0:b1, :] = t
                else:
                    dst[key][..., b0:b1] = t
        del np_, m1, v1
    return newp.reshape(p.shape), {"m": m, "v": v}


def _get(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree
