"""Wrapper of the Hopper flash attention kernel, in the model layout.

``flash_attention(q, k, v, *, causal, window, cap)`` takes q [B,S,H,Dh]
(flat group-major heads) and k, v [B,Sk,Kh,Dh], as
``repro/kernels/flash_attention/ops.py`` does, and returns [B,S,H,Dh].

A CUDA tensor launches a kernel of ``csrc/flash_attention.cu`` or
raises; a CPU tensor runs the plain version (``reference``, over
``ref.attention_ref``), and only because it lies on the CPU. Which kernel
(the route) follows from dtype and head dim alone (``route``): bf16 at
D in {64, 128, 256} takes the wgmma/TMA kernel, bf16 at D in {16, 32} the
mma.sync one, float32 the CUDA-core one; nothing else is taken, and no
route gives way to another. The kernels read the model layout through
strides, so no transpose is copied; rows must start on 16-byte
boundaries, as the model's projections leave them. ``launches`` counts
kernel launches, ``launches_by_route`` the same launches by route.

A ``meta`` call (the dry run's trace) checks the inputs and the route as
a CUDA call does and returns an empty ``meta`` output: no launch, and
``launches`` does not move. While an ``op_analysis`` is active, a CUDA
or ``meta`` call reports itself to it (``record_kernel``): 4 * Dh FLOPs
for each visible (q, k) pair and head (``visible_pairs``), and the bytes
of q, k, v and the output, which a dispatch mode cannot see of a launch
through ctypes. The plain version's ops on the CPU are seen directly.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.flash_attention.ref import attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 256)
#: the head dims of the bf16 wgmma kernel; the others take mma.sync
WGMMA_HEAD_DIMS = (64, 128, 256)
ROUTES = ("wgmma", "mma_sync", "f32")
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

#: kernel launches in this process; ``chip_smoke.py`` resets and reads it
launches = 0
#: the same launches by route (``route``)
launches_by_route = dict.fromkeys(ROUTES, 0)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once per
    process: the source is hashed and the library loaded only here."""
    from repro_torch.kernels import build
    lib = build.load("flash_attention", SOURCE)
    fn = lib.repro_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 +
        [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 7 +
        [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B,S,H,Dh] / [B,Sk,Kh,Dh]")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} q heads do not group over {k.shape[2]} "
                         f"kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the "
                        f"kernel takes bfloat16 or float32, all alike")
    if not (q.device == k.device == v.device):
        raise ValueError(f"devices differ: {q.device}, {k.device}, "
                         f"{v.device}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the last dim must have stride 1")
    for x in (q, k, v):  # tiles are loaded 16 bytes at a time
        if x.data_ptr() % 16 or any(
                s * x.element_size() % 16 for s in x.stride()[:3]):
            raise ValueError("q, k and v rows must start on 16-byte "
                             "boundaries")
    if h > 65535 or b > 65535:
        raise ValueError("at most 65535 heads and 65535 batch rows")


def route(q: torch.Tensor, k: torch.Tensor) -> str:
    """The kernel a CUDA call with these inputs takes, from dtype and head
    dim alone, as the C dispatch chooses it: "wgmma" (bf16, D in
    WGMMA_HEAD_DIMS), "mma_sync" (bf16, D 16 or 32) or "f32". Raises for
    inputs no kernel takes."""
    d = q.shape[-1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}, {k.dtype}: the kernel takes "
                        f"bfloat16 or float32, all alike")
    if d not in HEAD_DIMS or k.shape[-1] != d:
        raise ValueError(f"head_dim {d} (k: {k.shape[-1]}) not in "
                         f"{HEAD_DIMS}")
    if q.dtype == torch.float32:
        return "f32"
    return "wgmma" if d in WGMMA_HEAD_DIMS else "mma_sync"


def reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, window: int = 0,
              cap: float = 0.0) -> torch.Tensor:
    """The plain version in the model layout, on any device: float32
    scores and softmax, one rounding at the end (``ref.attention_ref``)."""
    o = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=causal, window=window,
                      cap=cap)
    return o.transpose(1, 2)


def visible_pairs(sq: int, sk: int, causal: bool, window: int = 0) -> int:
    """The (q, k) pairs a head's masks leave: a causal row q sees keys
    0..q, a window the last ``window`` of them (non-causal: every key,
    at most ``window``)."""
    if not causal:
        return sq * (min(sk, window) if window else sk)
    c = min(sk, window) if window else sk
    if sq <= c:
        return sq * (sq + 1) // 2
    return c * (c + 1) // 2 + (sq - c) * c


def _record(q, k, causal: bool, window: int) -> None:
    from repro_torch.launch import op_analysis
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    op_analysis.record_kernel(
        "flash_attention",
        4.0 * b * h * d * visible_pairs(sq, sk, causal, window),
        float((2 * b * sq * h * d + 2 * b * sk * kh * d) *
              q.element_size()))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0,
                    cap: float = 0.0) -> torch.Tensor:
    """q [B,S,H,Dh] (flat group-major heads); k,v [B,Sk,Kh,Dh]
    -> [B,S,H,Dh] in q's dtype."""
    if q.device.type == "cpu" and k.device.type == "cpu" and \
            v.device.type == "cpu":
        return reference(q, k, v, causal=causal, window=window, cap=cap)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda or cpu (or meta, "
                         f"launching nothing), not {q.device}")
    _check(q, k, v)
    kernel = route(q, k)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    _record(q, k, causal, window)
    if q.device.type == "meta":
        return out
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3])
    with torch.cuda.device(q.device):
        lib = _library()
        err = lib.repro_flash_attention_fwd(
            _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), strides, b, h, kh, sq, sk, int(bool(causal)),
            int(window), float(d ** -0.5), float(cap),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    launches_by_route[kernel] += 1
    return out
