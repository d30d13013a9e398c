"""Common layers: RMSNorm, LayerNorm, RoPE, softcap, MLPs, embeddings,
the causal channel conv, ParamBuilder.

PyTorch counterpart of ``repro/models/layers.py``. Parameters are plain
nested dicts of tensors with the JAX package's names, shapes and dtypes,
so a tree crosses between the packages leaf for leaf (``bridge.py``).
Points that must match the reference exactly:

* the gemma RMSNorm scales by ``1 + w`` and its ``w`` starts at zero;
* LayerNorm takes float32 statistics with eps 1e-5 (RMSNorm: 1e-6);
* RoPE is half-split, ``freq = theta ** (-arange(half) / half)`` in
  float32;
* ``jax.nn.gelu`` is the tanh approximation;
* embeddings are not scaled by sqrt(d) and are untied;
* ``softcap`` computes in float32.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, object]


class Shape(NamedTuple):
    """A leaf's shape and dtype, with no tensor behind it (the layout's
    specs are computed from these without allocating, even on meta)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

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
    ``specs`` records each parameter's logical axes (JAX's ``axes``
    argument, None on each lead dim). On the ``meta`` device nothing is
    drawn: the tree holds shapes and dtypes only (``abstract_params``);
    with no device, its leaves are ``Shape``s (``param_specs``).
    ``keep(w, spec)``, when given, is what the tree keeps of each leaf as
    soon as it is drawn (a process's block of it: the whole leaf is then
    freed before the next is drawn).
    """

    def __init__(self, generator: torch.Generator, device,
                 dtype=torch.bfloat16, lead: Tuple[int, ...] = (),
                 keep: Optional[Callable] = None):
        self.generator = generator
        self.device = None if device is None else torch.device(device)
        self.dtype = dtype
        self.lead = tuple(lead)
        self.keep = keep
        self.params: Params = {}
        self.specs: Dict[str, object] = {}

    def param(self, name: str, shape: Tuple[int, ...],
              axes: Optional[Tuple] = None, init: str = "normal",
              scale: float = 0.02) -> torch.Tensor:
        axes = (None,) * len(shape) if axes is None else tuple(axes)
        assert len(axes) == len(shape), (name, shape, axes)
        full = self.lead + tuple(shape)
        self.specs[name] = (None,) * len(self.lead) + axes
        w = self._draw(shape, full, init, scale)
        if self.keep is not None:
            w = self.keep(w, self.specs[name])
        self.params[name] = w
        return w

    def _draw(self, shape, full, init: str, scale: float) -> torch.Tensor:
        keep_f32 = init in ("lru_lambda", "ssm_a", "ssm_dt")
        if self.device is None:
            return Shape(full, torch.float32 if keep_f32 else self.dtype)
        if self.device.type == "meta":
            return torch.empty(full, device="meta", dtype=torch.float32
                               if keep_f32 else self.dtype)
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
        return w.to(torch.float32 if keep_f32 else self.dtype)

    def _uniform(self, shape: Tuple[int, ...], lo: float,
                 hi: float) -> torch.Tensor:
        u = torch.rand(shape, generator=self.generator, device=self.device,
                       dtype=torch.float32)
        return u * (hi - lo) + lo

    def child(self, name: str) -> "ParamBuilder":
        sub = ParamBuilder(self.generator, self.device, self.dtype,
                           self.lead, self.keep)
        self.params[name] = sub.params
        self.specs[name] = sub.specs
        return sub

    def stacked(self, name: str, n: int,
                init_fn: Callable[["ParamBuilder"], None]) -> None:
        """Leaves with a leading layer dim ``n`` (JAX: vmap over keys)."""
        sub = ParamBuilder(self.generator, self.device, self.dtype,
                           self.lead + (n,), self.keep)
        init_fn(sub)
        self.params[name] = sub.params
        self.specs[name] = sub.specs


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


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """float32 mean and (biased) variance, then w and b, cast back."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def init_norm(pb: ParamBuilder, name: str, d: int, kind: str,
              gemma_scale: bool) -> None:
    c = pb.child(name)
    c.param("w", (d,), (None,), init="zeros" if gemma_scale else "ones")
    if kind == "layernorm":
        c.param("b", (d,), (None,), init="zeros")


def apply_norm(p: Params, x: torch.Tensor, kind: str,
               gemma_scale: bool) -> torch.Tensor:
    if kind == "layernorm":
        return layer_norm(x, p["w"], p["b"])
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
    pb.param("w1", (d, f), (None, "mlp"), init="fan_in")
    if gated:
        pb.param("w3", (d, f), (None, "mlp"), init="fan_in")
    pb.param("w2", (f, d), ("mlp", None), init="fan_in")
    if bias:
        pb.param("b1", (f,), ("mlp",), init="zeros")
        pb.param("b2", (d,), (None,), init="zeros")


def apply_mlp(p: Params, x: torch.Tensor, kind: str,
              reduce: Optional[Callable] = None) -> torch.Tensor:
    """``w1``/``w3`` column blocks and a ``w2`` row block when ``reduce``
    (the sum over ``model``) is given: the partial products are summed
    before ``b2`` is added, once."""
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
    if reduce is not None:
        y = reduce(y)
    if "b2" in p:
        y = y + p["b2"]
    return y


# ---------------------------------------------------------------------------
# Embeddings (vocab padded to a TP-friendly multiple; untied in/out)
# ---------------------------------------------------------------------------

def init_embeddings(pb: ParamBuilder, vocab_padded: int, d: int) -> None:
    pb.param("in_embed", (vocab_padded, d), ("vocab", None), init="normal",
             scale=0.02)
    pb.param("out_embed", (d, vocab_padded), (None, "vocab"), init="fan_in")


def embed_tokens(p: Params, tokens: torch.Tensor, layout=None
                 ) -> torch.Tensor:
    """The rows of ``in_embed``. With ``layout`` the table is this
    process's vocabulary block: a masked local gather, then a sum over
    ``model`` (one block holds each token's row, so the sum is exact), as
    GSPMD lowers JAX's gather of a vocabulary-sharded table."""
    table = p["in_embed"]
    if layout is None:
        return table[tokens]
    n = table.shape[0]
    local = tokens.long() - layout.model_index() * n
    mine = (local >= 0) & (local < n)
    x = table[local.clamp(0, n - 1)] * mine[..., None].to(table.dtype)
    return layout.tp_sum(x)


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

