"""Tensor boundary between host trees (numpy) and the port's tensors.

The JAX package hands parameters and session state around as nested dicts
of numpy arrays (``jax.tree.map(np.asarray, tree)``). Its bfloat16 leaves
are ``ml_dtypes.bfloat16`` arrays, which the port cannot import (that
package ships with JAX and is absent where the port runs). A bfloat16 leaf
is therefore recognised by ``arr.dtype.name == "bfloat16"`` and moved
through its 16-bit pattern, so every conversion here is bit-exact.

Stacked layer leaves keep the JAX layout: a leading ``reps`` axis, layer
``rep * len(period) + p`` at index ``rep`` of ``group{g}/p{p}``.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.kernels import watchdog

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
}


def is_bf16_array(a) -> bool:
    return isinstance(a, np.ndarray) and a.dtype.name == "bfloat16"


def bf16_from_bits(bits: np.ndarray) -> torch.Tensor:
    """uint16 bit patterns -> a CPU ``torch.bfloat16`` tensor (no copy of
    the values' meaning, only of their bytes)."""
    bits = np.array(bits, dtype=np.uint16, order="C").view(np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the CPU (itself if it is there already). A card tensor
    first waits for the card's queued work with the watchdog's deadline
    (``kernels/watchdog.py``), so a hung kernel raises ``KernelTimeout``
    instead of hanging the read."""
    if t.is_cuda:
        with torch.cuda.device(t.device):
            watchdog.synchronize(what="a read back to the host")
    return t.detach().cpu()


def bf16_bits(t: torch.Tensor) -> np.ndarray:
    """A bfloat16 tensor's values as a uint16 numpy array of bit
    patterns (the on-disk and cross-package form)."""
    return to_host(t).contiguous().view(torch.int16).numpy() \
        .view(np.uint16)


def to_torch(a, device=None) -> torch.Tensor:
    """A host leaf (numpy array or scalar, ml_dtypes bfloat16 included,
    or a tensor) -> tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device) if device is not None else a
    a = np.asarray(a)
    if is_bf16_array(a):
        t = bf16_from_bits(a.view(np.uint16))
    else:
        if a.dtype not in _NP_TO_TORCH:
            raise TypeError(f"no torch dtype for numpy {a.dtype}")
        t = torch.from_numpy(np.array(a, order="C"))  # 0-d stays 0-d
    return t.to(device) if device is not None else t


def to_numpy(t) -> np.ndarray:
    """Tensor -> numpy for comparison and storage: bfloat16 becomes its
    uint16 bit pattern (see ``bf16_bits``)."""
    if not isinstance(t, torch.Tensor):
        t = np.asarray(t)
        return t.view(np.uint16) if is_bf16_array(t) else t
    if t.dtype == torch.bfloat16:
        return bf16_bits(t)
    return to_host(t).numpy()


def tree_map(fn: Callable, tree) -> Any:
    """Map over the leaves of a nested dict (the only container the
    parameter and cache trees use)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree, prefix: str = ""):
    """``[(path, leaf), ...]`` in sorted path order, paths joined by
    ``/`` as the object store names them."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def tree_from_leaves(leaves: dict) -> dict:
    """``{path: leaf}`` (paths joined by ``/``) -> the nested dict tree;
    the inverse of ``tree_leaves``."""
    tree: dict = {}
    for path, v in leaves.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def params_from_host(tree, device) -> dict:
    """The JAX package's parameter tree (numpy leaves, as
    ``jax.tree.map(np.asarray, params)`` gives them) -> the port's tree
    of tensors on ``device``, same names, shapes and dtypes."""
    return tree_map(lambda a: to_torch(a, device), tree)


def params_to_host(tree) -> dict:
    """The port's parameter tree -> numpy (bfloat16 as uint16 bits)."""
    return tree_map(to_numpy, tree)


def state_to_host(cache) -> dict:
    """The engine's cache tree -> owned CPU tensors in the JAX layout
    (``group{g}/p{i}/self/{k,v,kpos}`` or ``.../self/{h,conv}``, leading
    ``reps`` axis), dtypes kept (float32 recurrent ``h``, bfloat16 KV and
    conv windows): bfloat16 stays a tensor, which numpy cannot hold
    without ml_dtypes."""
    return tree_map(lambda t: to_host(t) if t.is_cuda
                    else t.detach().clone(), cache)


def state_from_host(tree, device) -> dict:
    """A host cache tree from either package -> tensors on ``device``,
    always fresh copies: decode updates the cache in place, and must not
    write through into the caller's host copy."""
    return tree_map(lambda a: to_torch(a).to(device, copy=True), tree)


def relayout_experts(params, cfg, tp: int = 1, dp: int = 1) -> dict:
    """The parameter tree with every MoE layer's expert stacks moved from
    the slot layout they were built in (any tp, or the 2D ``[tp, dp,
    ...]`` one) to the layout of ``(tp, dp)``: the same logical [E, D, F]
    weights (``models.moe.logical_expert_weights``), not redrawn (the
    fan-in scale divides by the slot count they were drawn at). Other
    leaves are kept; a stack is a view where a reshape allows it (one FFN
    shard a group on both sides), else a copy."""
    from repro_torch.models import moe as moe_mod
    want = moe_mod.make_moe_layout(cfg, tp, dp)

    def one(w: torch.Tensor, src, last_is_d: bool) -> torch.Tensor:
        lg = moe_mod.to_logical(w, cfg, src, last_is_d)
        out = moe_mod.from_logical(lg, cfg, want, last_is_d)
        if dp > 1:  # [..., slots, ...] -> [..., tp, dp, ...]
            lead = tuple(out.shape[:-4])
            out = out.reshape(lead + (tp, dp) + tuple(out.shape[-3:]))
        return out

    def walk(tree):
        if not isinstance(tree, dict):
            return tree
        if {"router", "wi", "wg", "wo"} <= set(tree):
            # a layer stack: [reps, slots, el, ...] or [reps, tp, dp, el, ...]
            ws = {k: tree[k] for k in ("wi", "wg", "wo")}
            if ws["wi"].dim() == 6:
                ws = {k: w.reshape((w.shape[0], w.shape[1] * w.shape[2]) +
                                   tuple(w.shape[3:])) for k, w in ws.items()}
            src = moe_mod.make_moe_layout(cfg, ws["wi"].shape[1])
            out = dict(tree)
            out.update({k: one(w, src, k == "wo") for k, w in ws.items()})
            return out
        return {k: walk(v) for k, v in tree.items()}

    return walk(params)
