"""Common layers: RMSNorm, RoPE, softcap, MLPs, embeddings, the causal
channel conv, ParamBuilder.

PyTorch counterpart of ``repro/models/layers.py``. Parameters are plain
nested dicts of tensors with the JAX package's names, shapes and dtypes,
so a tree crosses between the packages leaf for leaf (``bridge.py``).
Points that must match the reference exactly:

* the gemma RMSNorm scales by ``1 + w`` and its ``w`` starts at zero;
* RoPE is half-split, ``freq = theta ** (-arange(half) / half)`` in
  float32;
* ``jax.nn.gelu`` is the tanh approximation;
* embeddings are not scaled by sqrt(d) and are untied;
* ``softcap`` computes in float32.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, object]

# normal leaves are drawn in float32 slabs of this many elements (4.3 GB),
# which bounds the float32 copy a leaf's draw holds on the device
_SLAB = 2 ** 30


class ParamBuilder:
    """Collects parameters drawn from one ``torch.Generator``.

    Shapes, scales and dtypes follow the JAX ParamBuilder; the random
    numbers do not (the two generators cannot agree), which is why the
    tests carry the JAX package's parameters over instead. A normal leaf
    is drawn in float32 slabs of ``_SLAB`` elements, so building a MoE
    layer's expert stack (grok-1's 4-layer ``wi`` is 6.4 G elements) never
    holds a float32 copy of the whole. ``lead`` is a
    leading stack shape (the ``reps`` axis of a stacked layer group): it
    is prepended to every parameter and ignored by the fan-in.
    """

    def __init__(self, generator: torch.Generator, device,
                 dtype=torch.bfloat16, lead: Tuple[int, ...] = ()):
        self.generator = generator
        self.device = torch.device(device)
        self.dtype = dtype
        self.lead = tuple(lead)
        self.params: Params = {}

    def param(self, name: str, shape: Tuple[int, ...], init: str = "normal",
              scale: float = 0.02) -> torch.Tensor:
        full = self.lead + tuple(shape)
        if init in ("normal", "fan_in"):
            div = math.sqrt(max(shape[0] if len(shape) else 1, 1))
            w = torch.empty(full, dtype=self.dtype, device=self.device)
            flat = w.view(-1)
            for lo in range(0, flat.numel(), _SLAB):
                z = torch.randn(min(_SLAB, flat.numel() - lo),
                                generator=self.generator, device=self.device,
                                dtype=torch.float32)
                flat[lo:lo + z.numel()].copy_(
                    z.mul_(scale) if init == "normal" else z.div_(div))
            self.params[name] = w
            return w
        if init == "zeros":
            w = torch.zeros(full, device=self.device, dtype=torch.float32)
        elif init == "ones":
            w = torch.ones(full, device=self.device, dtype=torch.float32)
        elif init == "lru_lambda":  # RG-LRU lambda: a in [0.9, 0.999]
            u = self._uniform(full, 0.9 ** 2, 0.999 ** 2)
            # a = exp(-c*softplus(lam)): softplus(lam) = -log(a)/c, u = a^2
            sp = -torch.log(u) / (2.0 * 8.0)
            w = torch.log(torch.expm1(sp.clamp_min(1e-8)))
        elif init == "ssm_a":  # mamba2 A_log: A in [1, 16]
            w = torch.log(self._uniform(full, 1.0, 16.0))
        elif init == "ssm_dt":  # dt bias: softplus^-1 of dt in [1e-3, 1e-1]
            dt = torch.exp(self._uniform(full, math.log(1e-3),
                                         math.log(1e-1)))
            w = dt + torch.log(-torch.expm1(-dt))
        else:
            raise NotImplementedError(
                f"init {init!r} belongs to a mixer that is not ported "
                f"(ROADMAP Queue A: other mixers and archs)")
        # the recurrences' decay parameters stay float32, as in JAX
        keep_f32 = init in ("lru_lambda", "ssm_a", "ssm_dt")
        w = w.to(torch.float32 if keep_f32 else self.dtype)
        self.params[name] = w
        return w

    def _uniform(self, shape: Tuple[int, ...], lo: float,
                 hi: float) -> torch.Tensor:
        u = torch.rand(shape, generator=self.generator, device=self.device,
                       dtype=torch.float32)
        return u * (hi - lo) + lo

    def child(self, name: str) -> "ParamBuilder":
        sub = ParamBuilder(self.generator, self.device, self.dtype,
                           self.lead)
        self.params[name] = sub.params
        return sub

    def stacked(self, name: str, n: int,
                init_fn: Callable[["ParamBuilder"], None]) -> None:
        """Leaves with a leading layer dim ``n`` (JAX: vmap over keys)."""
        sub = ParamBuilder(self.generator, self.device, self.dtype,
                           self.lead + (n,))
        init_fn(sub)
        self.params[name] = sub.params


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
             gemma_scale: bool = False) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if gemma_scale else w.float()
    return (y * scale).to(dt)


def init_norm(pb: ParamBuilder, name: str, d: int, kind: str,
              gemma_scale: bool) -> None:
    if kind != "rmsnorm":
        raise NotImplementedError(
            f"{kind} belongs to an arch that is not ported (ROADMAP "
            f"Queue A: other mixers and archs)")
    pb.child(name).param("w", (d,), init="zeros" if gemma_scale else "ones")


def apply_norm(p: Params, x: torch.Tensor, kind: str,
               gemma_scale: bool) -> torch.Tensor:
    if kind != "rmsnorm":
        raise NotImplementedError(
            f"{kind} belongs to an arch that is not ported (ROADMAP "
            f"Queue A: other mixers and archs)")
    return rms_norm(x, p["w"], gemma_scale=gemma_scale)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    if theta <= 0:
        return x
    d = x.shape[-1]
    half = d // 2
    # theta ** (-i/half) in float32, as jnp computes it
    expo = -torch.arange(0, half, dtype=torch.float32,
                         device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), expo)
    ang = positions[..., None].to(device=x.device,
                                  dtype=torch.float32) * freq
    sin = torch.sin(ang)[..., None, :]  # broadcast over heads
    cos = torch.cos(ang)[..., None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(pb: ParamBuilder, d: int, f: int, kind: str, bias: bool) -> None:
    gated = kind in ("swiglu", "geglu")
    pb.param("w1", (d, f), init="fan_in")
    if gated:
        pb.param("w3", (d, f), init="fan_in")
    pb.param("w2", (f, d), init="fan_in")
    if bias:
        pb.param("b1", (f,), init="zeros")
        pb.param("b2", (d,), init="zeros")


def apply_mlp(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    h = x @ p["w1"]
    if "b1" in p:
        h = h + p["b1"]
    if kind == "swiglu":
        h = F.silu(h) * (x @ p["w3"])
    elif kind == "geglu":
        h = F.gelu(h, approximate="tanh") * (x @ p["w3"])
    elif kind == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise NotImplementedError(
            f"mlp {kind!r} is not ported (ROADMAP Queue A: other mixers "
            f"and archs)")
    y = h @ p["w2"]
    if "b2" in p:
        y = y + p["b2"]
    return y


# ---------------------------------------------------------------------------
# Embeddings (vocab padded to a TP-friendly multiple; untied in/out)
# ---------------------------------------------------------------------------

def init_embeddings(pb: ParamBuilder, vocab_padded: int, d: int) -> None:
    pb.param("in_embed", (vocab_padded, d), init="normal", scale=0.02)
    pb.param("out_embed", (d, vocab_padded), init="fan_in")


def embed_tokens(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["in_embed"][tokens]


def conv1d_channels(x: torch.Tensor, w: torch.Tensor,
                    carry: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal depthwise temporal conv. x: [B, S, C]; w: [C, K].

    With ``carry`` [B, K-1, C] (previous tokens) prepended; else zero-pad.
    The same K-tap loop as JAX, accumulating in x's dtype: ``F.conv1d``
    would sum in another order (and through cuDNN, in TF32 by default).
    """
    k = w.shape[-1]
    if carry is None:
        pad = x.new_zeros(x.shape[:-2] + (k - 1, x.shape[-1]))
    else:
        pad = carry.to(x.dtype)
    xp = torch.cat([pad, x], dim=-2)  # [B, S+K-1, C]
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[..., i:i + x.shape[-2], :] * w[:, i]
    return out


def index_tree(tree, i: int):
    """Slice index ``i`` off the leading (``reps``) axis of every leaf:
    views, no copies, so in-place cache writes land in the stack."""
    if isinstance(tree, dict):
        return {k: index_tree(v, i) for k, v in tree.items()}
    return tree[i]

