"""Wrapper of the Hopper SSD scan kernel, in the model layout.

``ssd(x, dt, a, b, c, *, chunk)`` takes x [B,S,H,P], dt [B,S,H], a [H] and
b, c [B,S,G,N] and returns (y [B,S,H,P] in x's dtype, final state
[B,H,P,N] float32), the contract of ``repro/kernels/ssd/ops.py`` and of
``models.ssm.ssd_chunked``. ``chunk`` is the JAX kernel's chunk, kept for
the same signature: the Hopper kernel runs the recurrence over time
(``csrc/ssd.cu``: a ring of asynchronous tile copies, the state rescaled
within runs of 16 steps), and no result depends on the chunk beyond
rounding.

A CUDA tensor launches the kernel of ``csrc/ssd.cu`` or raises; a CPU
tensor runs the plain version (``reference``, over ``ref.ssd_ref``), and
only because it lies on the CPU. The kernel reads the model layout through
strides (x, B and C may be slices of one conv output). ``launches``
counts kernel launches.

A ``meta`` call (the dry run's trace) checks the inputs as a CUDA call
does and returns empty ``meta`` outputs (y in x's dtype, the float32 end
state): no launch, and ``launches`` does not move. While an
``op_analysis`` is active, a CUDA or ``meta`` call reports itself to it
(``record_kernel``) with ``work``'s FLOPs and bytes, the numbers
``chip_smoke.py``'s bound is computed from.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.ssd.ref import ssd_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
HEAD_DIMS = (8, 16, 64)       # P
STATE_DIMS = (16, 32, 128)    # N
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

#: kernel launches in this process; ``chip_smoke.py`` resets and reads it
launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once per
    process."""
    from repro_torch.kernels import build
    lib = build.load("ssd", SOURCE)
    fn = lib.repro_ssd_scan
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 +
                   [ctypes.POINTER(ctypes.c_longlong)] +
                   [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return lib


def _check(x, dt, a, b, c) -> None:
    """What the kernel takes; dt and a come in as float32 (``ssd``
    casts them, as the JAX wrapper does)."""
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b.dim() != 4 or \
            c.shape != b.shape:
        raise ValueError("x [B,S,H,P], dt [B,S,H], a [H], b, c [B,S,G,N]")
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if dt.shape != (bs, s, h) or a.shape != (h,) or b.shape[:2] != (bs, s):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    if h % g:
        raise ValueError(f"{h} heads do not group over {g} groups")
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"head_dim {p} not in {HEAD_DIMS} or d_state {n} "
                         f"not in {STATE_DIMS}")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"dtypes {x.dtype}, {b.dtype}, {c.dtype}: the "
                        f"kernel takes x, b, c in bfloat16 or float32, "
                        f"all alike")
    if len({t.device for t in (x, dt, a, b, c)}) != 1:
        raise ValueError("x, dt, a, b, c lie on different devices")
    if any(t.stride(-1) != 1 for t in (x, dt, a, b, c)):
        raise ValueError("the last dim must have stride 1")
    if bs > 65535:
        raise ValueError("at most 65535 batch rows")


def work(b: int, s: int, h: int, p: int, g: int, n: int, itemsize: int):
    """(FLOPs, bytes) of one scan: 4 P N float32 operations per token and
    head (the rescaled form's update and read-out, fused multiply-adds
    counted as 2: the fewest of the kernel's two forms), against x, y, B
    and C (``itemsize``), dt and a (float32) read or written once and the
    float32 end state written once."""
    flops = 4.0 * b * s * h * p * n
    nbytes = (2 * b * s * h * p + 2 * b * s * g * n) * itemsize + \
        4 * (b * s * h + h + b * h * p * n)
    return flops, float(nbytes)


def _record(x: torch.Tensor, b: torch.Tensor) -> None:
    from repro_torch.launch import op_analysis
    op_analysis.record_kernel("ssd", *work(*x.shape, *b.shape[2:],
                                           x.element_size()))


def reference(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor):
    """The plain version in the model layout, on any device: the
    sequential float32 scan of ``ref.ssd_ref``, y rounded once to x's
    dtype."""
    y, st = ssd_ref(x.transpose(1, 2), dt.transpose(1, 2), a,
                    b.transpose(1, 2), c.transpose(1, 2))
    return y.transpose(1, 2).to(x.dtype), st.transpose(2, 3)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, *, chunk: int = 256):
    """x [B,S,H,P]; dt [B,S,H]; a [H]; b,c [B,S,G,N].

    Returns (y [B,S,H,P] in x's dtype, final_state [B,H,P,N] float32)."""
    del chunk  # the JAX kernel's chunk; see the module doc
    dt, a = dt.float(), a.float()
    tensors = (x, dt, a, b, c)
    if all(t.device.type == "cpu" for t in tensors):
        return reference(x, dt, a, b, c)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd runs on cuda or cpu (or meta, launching "
                         f"nothing), not {x.device}")
    _check(*tensors)
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    y = torch.empty((bs, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((bs, h, p, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, state.zero_()
    _record(x, b)
    if x.device.type == "meta":
        return y, state
    strides = (ctypes.c_longlong * 14)(
        *x.stride()[:3], *dt.stride()[:2], *b.stride()[:3],
        *c.stride()[:3], *y.stride()[:3])
    with torch.cuda.device(x.device):
        lib = _library()
        err = lib.repro_ssd_scan(
            _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
            b.data_ptr(), c.data_ptr(), y.data_ptr(), state.data_ptr(),
            strides, bs, s, h, g, p, n,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return y, state
