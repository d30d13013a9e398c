"""Wrapper of the Hopper RG-LRU scan kernel.

``rglru(log_a, gated, *, block)`` takes log_a, gated [B,S,W] and returns
h [B,S,W] in float32, as ``repro/kernels/rglru/ops.py`` does. ``block`` is
the JAX kernel's sequence block, kept for the same signature; the Hopper
kernel cuts the sequence its own way (``csrc/rglru.cu``: a single-pass
chained scan over tiles of 64 steps), and no result depends on either
beyond rounding.

A CUDA tensor launches the kernel of ``csrc/rglru.cu`` or raises; a CPU
tensor runs the plain version (``reference``, ``ref.rglru_ref``), and only
because it lies on the CPU. Each launch gets its scratch from the
wrapper: one zeroed int64 buffer holding the tile ticket and the tiles'
flagged carries, sized by the C side (``repro_rglru_scratch``).
``launches`` counts kernel launches.

A ``meta`` call (the dry run's trace) checks the inputs as a CUDA call
does and returns an empty ``meta`` h: no launch, and ``launches`` does
not move. While an ``op_analysis`` is active, a CUDA or ``meta`` call
reports itself to it (``record_kernel``) with ``work``'s FLOPs and bytes,
the numbers ``chip_smoke.py``'s bound is computed from.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.rglru.ref import rglru_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru.cu"

#: kernel launches in this process; ``chip_smoke.py`` resets and reads it
launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once per
    process."""
    from repro_torch.kernels import build
    lib = build.load("rglru", SOURCE)
    fn = lib.repro_rglru_scan
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 +
                   [ctypes.POINTER(ctypes.c_longlong)] +
                   [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    size = lib.repro_rglru_scratch
    size.restype = ctypes.c_int
    size.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
    return lib


def _scratch(lib: ctypes.CDLL, b: int, s: int, w: int,
             device) -> torch.Tensor:
    """The launch's scratch, zeroed: the tile ticket and, for each tile,
    its end state with a ready flag beside each channel's value."""
    words = ctypes.c_longlong()
    if lib.repro_rglru_scratch(b, s, w, ctypes.byref(words)) < 0:
        raise ValueError(f"rglru: no tiling for B={b} S={s} W={w}")
    return torch.zeros(words.value, dtype=torch.int64, device=device)


def _check(log_a: torch.Tensor, gated: torch.Tensor) -> None:
    if log_a.dim() != 3 or log_a.shape != gated.shape:
        raise ValueError(f"log_a {tuple(log_a.shape)} and gated "
                         f"{tuple(gated.shape)} must both be [B,S,W]")
    if log_a.dtype != torch.float32 or gated.dtype != torch.float32:
        raise TypeError(f"dtypes {log_a.dtype}, {gated.dtype}: the kernel "
                        f"takes float32")
    if log_a.device != gated.device:
        raise ValueError(f"devices differ: {log_a.device}, {gated.device}")
    if log_a.stride(2) != 1 or gated.stride(2) != 1:
        raise ValueError("the channel dim must have stride 1")
    if log_a.shape[0] > 65535:
        raise ValueError("at most 65535 batch rows")


#: float32 operations per element: exp, expm1, sqrt and two multiply-adds
#: (each counted as one)
OPS_PER_ELEMENT = 5


def work(b: int, s: int, w: int):
    """(FLOPs, bytes) of one scan over [B, S, W]: ``OPS_PER_ELEMENT`` per
    element, and its three float32 arrays (log_a and gated read, h
    written) each moved once."""
    n = b * s * w
    return float(OPS_PER_ELEMENT * n), float(3 * 4 * n)


def _record(log_a: torch.Tensor) -> None:
    from repro_torch.launch import op_analysis
    op_analysis.record_kernel("rglru", *work(*log_a.shape))


def reference(log_a: torch.Tensor, gated: torch.Tensor) -> torch.Tensor:
    """The plain version on any device: the sequential float32 scan."""
    return rglru_ref(log_a.float(), gated.float())


def rglru(log_a: torch.Tensor, gated: torch.Tensor, *,
          block: int = 256) -> torch.Tensor:
    """log_a, gated [B,S,W] float32 -> h [B,S,W] float32."""
    del block  # the JAX kernel's sequence block; see the module doc
    if log_a.device.type == "cpu" and gated.device.type == "cpu":
        return reference(log_a, gated)
    if log_a.device.type not in ("cuda", "meta"):
        raise ValueError(f"rglru runs on cuda or cpu (or meta, launching "
                         f"nothing), not {log_a.device}")
    _check(log_a, gated)
    b, s, w = log_a.shape
    out = torch.empty((b, s, w), dtype=torch.float32, device=log_a.device)
    if out.numel() == 0:
        return out
    _record(log_a)
    if log_a.device.type == "meta":
        return out
    strides = (ctypes.c_longlong * 6)(
        *log_a.stride()[:2], *gated.stride()[:2], *out.stride()[:2])
    with torch.cuda.device(log_a.device):
        lib = _library()
        scratch = _scratch(lib, b, s, w, log_a.device)
        err = lib.repro_rglru_scan(
            log_a.data_ptr(), gated.data_ptr(), out.data_ptr(), strides, b,
            s, w, scratch.data_ptr(),
            torch.cuda.current_stream(log_a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out
