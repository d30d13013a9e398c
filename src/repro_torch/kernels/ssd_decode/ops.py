"""Wrapper of the Hopper SSD decode-step kernel, in the model layout.

``ssd_decode_step(h, x, dt, a, b, c, d_skip)`` takes the arguments of the
plain version (``ref.ssd_decode_step``, which ``models/ssm.py`` decodes
through with its other impls): the state h [B,H,P,N] float32, x [B,H,P],
dt [B,H] and a [H] float32, b, c [B,G,N] in x's dtype and d_skip [H]; it
returns (y [B,H,P] in x's dtype, h). On every device it writes the new
state into ``h`` in place and returns ``h`` itself (the caller's cache
view: no new state, no copy back). Head ``i`` reads group ``i // (H / G)``
with the call's own H and G, so a process's block of the heads under the
dense layout decodes as the whole model does.

A CUDA tensor launches the kernel of ``csrc/ssd_decode.cu`` or raises. The
kernel reads x, b and c through their strides (slices of one conv
output), and h through its batch and head strides (its rows of N
contiguous). A CPU tensor runs the plain version and copies its new state
into ``h``. ``launches`` counts kernel launches.

The checks of what the kernel takes, and the launch's constants, are made
once per layout (the seven arguments' shapes, strides, dtypes and
device): a decode step calls the wrapper once a layer on views of one
stacked cache, all of one layout. h's alignment is checked every call.

A ``meta`` call (the dry run's trace) checks the inputs as a CUDA call does
and returns an empty ``meta`` y and ``h``: no launch, and ``launches`` does
not move. While an ``op_analysis`` is active, a CUDA or ``meta`` call
reports itself to it (``record_kernel``) with ``work``'s FLOPs and bytes.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels.ssd.ops import HEAD_DIMS, STATE_DIMS
from repro_torch.kernels.ssd_decode.ref import ssd_decode_step as reference
from repro_torch.launch import op_analysis

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_decode.cu"
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

#: kernel launches in this process
launches = 0

# each layout's checked launch constants, by (dtype, device, shape,
# strides) of the seven arguments; cleared when it holds _MAX_PLANS
_PLANS: dict = {}
_MAX_PLANS = 256


class _Plan(NamedTuple):
    codes: tuple                 # x's dtype code, d_skip's
    strides: ctypes.Array        # the kernel's 9 element strides
    sizes: tuple                 # B, H, G, P, N
    work: tuple                  # FLOPs, bytes (``work``)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once per
    process."""
    from repro_torch.kernels import build
    lib = build.load("ssd_decode", SOURCE)
    fn = lib.repro_ssd_decode
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 +
                   [ctypes.POINTER(ctypes.c_longlong)] +
                   [ctypes.c_int] * 5 + [ctypes.c_void_p])
    return lib


def _check(h, x, dt, a, b, c, d_skip) -> None:
    """What the kernel takes."""
    if h.dim() != 4 or x.dim() != 3 or dt.dim() != 2 or a.dim() != 1 or \
            b.dim() != 3 or c.shape != b.shape or d_skip.dim() != 1:
        raise ValueError("h [B,H,P,N], x [B,H,P], dt [B,H], a [H], "
                         "b, c [B,G,N], d_skip [H]")
    bs, nh, p, n = h.shape
    g = b.shape[1]
    if x.shape != (bs, nh, p) or dt.shape != (bs, nh) or \
            a.shape != (nh,) or d_skip.shape != (nh,) or \
            b.shape != (bs, g, n):
        raise ValueError(f"shape mismatch: h {tuple(h.shape)}, x "
                         f"{tuple(x.shape)}, dt {tuple(dt.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, d_skip "
                         f"{tuple(d_skip.shape)}")
    if nh % g:
        raise ValueError(f"{nh} heads do not group over {g} groups")
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"head_dim {p} not in {HEAD_DIMS} or d_state {n} "
                         f"not in {STATE_DIMS}")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype \
            or d_skip.dtype not in _DTYPES:
        raise TypeError(f"dtypes {x.dtype}, {b.dtype}, {c.dtype}, "
                        f"{d_skip.dtype}: the kernel takes x, b, c in "
                        f"bfloat16 or float32, all alike, and d_skip in "
                        f"either")
    if any(t.dtype != torch.float32 for t in (h, dt, a)):
        raise TypeError(f"dtypes {h.dtype}, {dt.dtype}, {a.dtype}: the "
                        f"kernel takes h, dt and a in float32")
    if len({t.device for t in (h, x, dt, a, b, c, d_skip)}) != 1:
        raise ValueError("h, x, dt, a, b, c, d_skip lie on different "
                         "devices")
    if any(t.stride(-1) != 1 for t in (h, x, dt, a, b, c, d_skip)):
        raise ValueError("the last dim must have stride 1")
    if h.stride(2) != n or h.stride(0) % 4 or h.stride(1) % 4:
        raise ValueError(f"h's rows must be contiguous and 16-byte aligned "
                         f"(strides {h.stride()})")


def work(b: int, h: int, p: int, g: int, n: int, itemsize: int):
    """(FLOPs, bytes) of one step: 5 P N float32 operations per row and
    head (the update's product, the decay's product and the add, the
    read-out's multiply-add counted as 2), against the float32 state read
    and written once, x and y, B and C (``itemsize``) and dt, a and d_skip
    (float32) read or written once."""
    flops = 5.0 * b * h * p * n
    nbytes = 8 * b * h * p * n + (2 * b * h * p + 2 * b * g * n) * \
        itemsize + 4 * (b * h + 2 * h)
    return flops, float(nbytes)


def _plan(tensors) -> _Plan:
    """The checked launch constants of ``tensors``' layout: ``_check``
    runs at a layout's first call only."""
    key = tuple((t.dtype, t.device, t.shape, t.stride()) for t in tensors)
    plan = _PLANS.get(key)
    if plan is None:
        _check(*tensors)
        h, x, dt, _, b, c, d_skip = tensors
        bs, nh, p, n = h.shape
        g = b.shape[1]
        plan = _Plan(
            (_DTYPES[x.dtype], _DTYPES[d_skip.dtype]),
            (ctypes.c_longlong * 9)(*h.stride()[:2], *x.stride()[:2],
                                    dt.stride(0), *b.stride()[:2],
                                    *c.stride()[:2]),
            (bs, nh, g, p, n), work(bs, nh, p, g, n, x.element_size()))
        if len(_PLANS) >= _MAX_PLANS:
            _PLANS.clear()
        _PLANS[key] = plan
    return plan


def ssd_decode_step(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    d_skip: torch.Tensor):
    """h [B,H,P,N] float32; x [B,H,P]; dt [B,H]; a [H]; b,c [B,G,N];
    d_skip [H].

    Returns (y [B,H,P] in x's dtype, ``h``), the new state written into
    ``h`` in place."""
    tensors = (h, x, dt, a, b, c, d_skip)
    if all(t.device.type == "cpu" for t in tensors):
        y, h_new = reference(*tensors)
        h.copy_(h_new)
        return y, h
    if h.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_decode_step runs on cuda or cpu (or meta, "
                         f"launching nothing), not {h.device}")
    plan = _plan(tensors)
    if h.device.type == "cuda" and \
            h.device.index != torch.cuda.current_device():
        with torch.cuda.device(h.device):
            return ssd_decode_step(*tensors)
    bs, nh, g, p, n = plan.sizes
    y = torch.empty((bs, nh, p), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y, h
    op_analysis.record_kernel("ssd_decode", *plan.work)
    if h.device.type == "meta":
        return y, h
    hp = h.data_ptr()
    if hp % 16:
        raise ValueError("h must be 16-byte aligned")
    err = _library().repro_ssd_decode(
        *plan.codes, hp, x.data_ptr(), dt.data_ptr(), a.data_ptr(),
        b.data_ptr(), c.data_ptr(), d_skip.data_ptr(), y.data_ptr(),
        plan.strides, bs, nh, g, p, n,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_decode kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return y, h
