"""Wrapper of the Hopper grouped expert matmul, and the sorted-token MoE
expert FFN built on it.

PyTorch counterpart of ``repro/kernels/moe_gmm/ops.py`` and ``kernel.py``,
with their names and arguments: ``gmm``, ``sort_tokens_by_expert``,
``unsort`` and ``moe_ffn_sorted``. ``gmm``'s ``bf`` is the TPU kernel's
column block, kept for the same signature: the Hopper kernel tiles F its
own way and masks a ragged tail (``csrc/gmm.cu``).

A CUDA tensor launches a kernel of ``csrc/gmm.cu`` or raises; a CPU
tensor runs the plain version (``reference``, ``ref.gmm_ref``), and only
because it lies on the CPU. Which kernel (the route) follows from dtype and
row block alone (``gmm_route``): bf16 with bt a multiple of 64 (every
prefill) takes the persistent wgmma/TMA kernel, other bf16 row blocks
(decode steps, small groups) the mma.sync one, float32 the CUDA-core one;
no route gives way to another. ``launches`` counts kernel launches,
``launches_by_route`` the same launches by route.

The layout differs from JAX's on purpose. JAX gives every expert a
capacity of ``ceil(T / bt) * bt`` rows (``ops.py:39-48``), so its buffer
has E·T rows and ``gmm`` multiplies E times the real rows. Here each
expert's group is padded only to a multiple of ``bt``, in a buffer of
``round_up(T + E (bt - 1), bt)`` rows (its size known without looking at
the routing); the slots and ``block_expert`` are computed on the device
(counts, cumulative sums, ``searchsorted``), blocks past the last group
are marked -1, and nothing synchronises with the host. The function is
the same: pad rows are zero and ``unsort`` drops them.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gmm.ref import gmm_ref
from repro_torch.obs import spans

SOURCE = Path(__file__).resolve().parent / "csrc" / "gmm.cu"
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
#: the row blocks ``choose_bt`` picks from; the kernel takes any multiple
#: of 16
BLOCK_ROWS = (128, 64, 32, 16)

ROUTES = ("wgmma", "mma_sync", "f32")

#: kernel launches in this process; ``chip_smoke.py`` resets and reads it
launches = 0
#: the same launches by route (``gmm_route``)
launches_by_route = dict.fromkeys(ROUTES, 0)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once per
    process."""
    from repro_torch.kernels import build
    lib = build.load("gmm", SOURCE)
    fn = lib.repro_gmm
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 +
                   [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 5 +
                   [ctypes.c_void_p])
    return lib


def choose_bt(rows: int, n_experts: int) -> int:
    """The row block for ``rows`` routed rows over ``n_experts``: the
    smallest of ``BLOCK_ROWS`` that holds the mean group (rows per expert
    that can hold one), at most 128. A decode step (a row or two an
    expert) gets 16, the smallest mma tile; arctic's prefill (about 94
    rows an expert at 12,000 rows over 128) and grok-1's (1,500) get 128.
    A short group padded to a whole tile costs operations, but each row
    tile re-reads its expert's weights, and with small groups the weights
    are the bytes that bound the kernel. ``chip_smoke.py`` times the
    other row blocks beside this pick at grok-1's and arctic's prefill
    and a decode step (PERF.md)."""
    mean = rows / max(1, min(n_experts, rows))
    for bt in sorted(BLOCK_ROWS):
        if bt >= mean:
            return bt
    return max(BLOCK_ROWS)


def _check(x: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor,
           bt: int) -> None:
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} must be [T,D] and w "
                         f"{tuple(w.shape)} [E,D,F]")
    t, d = x.shape
    f = w.shape[2]
    if bt <= 0 or bt % 16 or t % bt:
        raise ValueError(f"bt {bt} must be a multiple of 16 dividing "
                         f"T={t}")
    if block_expert.shape != (t // bt,) or block_expert.dtype != torch.int32:
        raise ValueError(f"block_expert {tuple(block_expert.shape)} "
                         f"{block_expert.dtype} must be [T // bt] int32")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"dtypes {x.dtype}, {w.dtype}: the kernel takes "
                        f"bfloat16 or float32, both the same")
    if not (x.device == w.device == block_expert.device):
        raise ValueError(f"devices differ: {x.device}, {w.device}, "
                         f"{block_expert.device}")
    if x.stride(1) != 1 or w.stride(2) != 1 or \
            not block_expert.is_contiguous():
        raise ValueError("the last dim of x and w must have stride 1")
    if x.dtype == torch.bfloat16 and (
            d % 8 or f % 8 or x.data_ptr() % 16 or w.data_ptr() % 16 or
            x.stride(0) % 8 or w.stride(0) % 8 or w.stride(1) % 8):
        raise ValueError("bfloat16: D and F multiples of 8 and rows of x "
                         "and w on 16-byte boundaries (the kernel loads "
                         "16 bytes at a time)")
    if max(t, d, f, w.shape[0]) >= 2 ** 31:
        raise ValueError("dims must fit in int32")


def gmm_route(x: torch.Tensor, w: torch.Tensor, bt: int) -> str:
    """The kernel a CUDA call with these inputs takes, from dtype and row
    block alone, as the C dispatch chooses it: "wgmma" (bf16, bt a
    multiple of 64), "mma_sync" (bf16, any other multiple of 16) or
    "f32". Raises for inputs no kernel takes."""
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"dtypes {x.dtype}, {w.dtype}: the kernel takes "
                        f"bfloat16 or float32, both the same")
    if bt <= 0 or bt % 16:
        raise ValueError(f"bt {bt} must be a multiple of 16")
    if x.dtype == torch.float32:
        return "f32"
    return "wgmma" if bt % 64 == 0 else "mma_sync"


def work(rows: int, d: int, f: int, experts: int, itemsize: int):
    """(FLOPs, bytes) of one gmm over ``rows`` routed rows: 2 D F
    operations a row, against the rows of x read and of the output
    written once, and every expert's weights read once. The weights are
    an upper bound: an expert no row is routed to is not read (the bound
    ``chip_smoke.py`` prints counts only the experts that hold a row,
    which the routing decides)."""
    return 2.0 * rows * d * f, \
        float((rows * d + rows * f + experts * d * f) * itemsize)


def _record(x: torch.Tensor, w: torch.Tensor, rows: int) -> None:
    from repro_torch.launch import op_analysis
    e, d, f = w.shape
    op_analysis.record_kernel("gmm", *work(rows, d, f, e, x.element_size()))


def reference(x_sorted: torch.Tensor, w: torch.Tensor,
              block_expert: torch.Tensor, bt: int) -> torch.Tensor:
    """The plain version on any device (it reads block_expert on the
    host)."""
    return gmm_ref(x_sorted, w, block_expert, bt)


def gmm(x_sorted: torch.Tensor, w: torch.Tensor, block_expert: torch.Tensor,
        *, bt: int = 128, bf: int = 512, interpret: bool = False,
        rows: Optional[int] = None) -> torch.Tensor:
    """x_sorted [T, D] (expert-sorted, block-aligned groups); w [E, D, F];
    block_expert [T // bt] int32. Returns [T, F] in x's dtype.
    ``interpret`` runs the plain version on any device. ``rows`` is the
    routed rows the buffer holds, for the analysis (``work``; default T,
    pad rows included)."""
    del bf  # the TPU kernel's column block; see the module doc
    if interpret or (x_sorted.device.type == "cpu" and
                     w.device.type == "cpu"):
        return reference(x_sorted, w, block_expert, bt)
    if x_sorted.device.type not in ("cuda", "meta"):
        raise ValueError(f"gmm runs on cuda or cpu (or meta, launching "
                         f"nothing), not {x_sorted.device}")
    _check(x_sorted, w, block_expert, bt)
    kernel = gmm_route(x_sorted, w, bt)
    t, d = x_sorted.shape
    e, _, f = w.shape
    out = torch.empty((t, f), dtype=x_sorted.dtype, device=x_sorted.device)
    if out.numel() == 0 or d == 0:
        return out.zero_()
    _record(x_sorted, w, t if rows is None else rows)
    if x_sorted.device.type == "meta":
        return out
    strides = (ctypes.c_longlong * 4)(x_sorted.stride(0), w.stride(0),
                                      w.stride(1), out.stride(0))
    with torch.cuda.device(x_sorted.device):
        lib = _library()
        err = lib.repro_gmm(
            _DTYPES[x_sorted.dtype], x_sorted.data_ptr(), w.data_ptr(),
            block_expert.data_ptr(), out.data_ptr(), strides, t, d, f, e, bt,
            torch.cuda.current_stream(x_sorted.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gmm kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    launches_by_route[kernel] += 1
    return out


def padded_rows(t: int, n_experts: int, bt: int) -> int:
    """Rows of the sorted buffer: every group padded to a multiple of bt
    needs at most ``T + E (bt - 1)`` rows, rounded up to a block."""
    return -(-(t + n_experts * (bt - 1)) // bt) * bt


def sort_tokens_by_expert(x: torch.Tensor, expert_ids: torch.Tensor,
                          n_experts: int, bt: int = 128
                          ) -> Tuple[torch.Tensor, torch.Tensor, Tuple]:
    """x [T, D]; expert_ids [T] -> (x_sorted [Ts, D], block_expert
    [Ts // bt] int32, (order, slots)), Ts = ``padded_rows(T, E, bt)``.

    Tokens are sorted by expert (stably); expert e's group starts at a
    multiple of bt and holds its tokens, then zero rows up to the next
    multiple. ``slots[i]`` is the buffer row of sorted token ``i``,
    ``order`` the sort permutation (JAX's ``meta``). Blocks past the last
    group are -1. Everything runs on x's device, without a host sync."""
    t, d = x.shape
    dev = x.device
    ids = expert_ids.reshape(-1).long()
    counts = torch.zeros(n_experts, dtype=torch.long, device=dev) \
        .scatter_add_(0, ids, torch.ones_like(ids))
    padded = (counts + bt - 1) // bt * bt
    ends = torch.cumsum(padded, 0)
    starts = ends - padded
    order = torch.argsort(ids, stable=True)
    ids_sorted = ids[order]
    first = torch.cumsum(counts, 0) - counts  # first sorted index per expert
    ranks = torch.arange(t, device=dev) - first[ids_sorted]
    slots = starts[ids_sorted] + ranks
    rows = padded_rows(t, n_experts, bt)
    buf = x.new_zeros((rows, d)).index_copy_(0, slots, x[order])
    block_starts = torch.arange(0, rows, bt, device=dev)
    block_expert = torch.searchsorted(ends, block_starts, right=True)
    block_expert = torch.where(block_expert < n_experts, block_expert, -1)
    return buf, block_expert.to(torch.int32), (order, slots)


def unsort(y_buf: torch.Tensor, meta, t: int) -> torch.Tensor:
    order, slots = meta
    return y_buf.new_empty((t, y_buf.shape[-1])).index_copy_(
        0, order, y_buf.index_select(0, slots))


def moe_ffn_sorted(x: torch.Tensor, expert_ids: torch.Tensor,
                   wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor, *,
                   n_experts: int, bt: Optional[int] = None, bf: int = 512,
                   interpret: bool = False) -> torch.Tensor:
    """Full expert FFN over sorted tokens, JAX's arithmetic: x [T,D];
    wi, wg [E,D,F]; wo [E,F,D]; h = gmm(wi), g = gmm(wg), silu in float32
    rounded to h's dtype, times h, then gmm(wo), unsorted. ``bt`` None
    picks it with ``choose_bt``."""
    t = x.shape[0]
    if bt is None:
        bt = choose_bt(t, n_experts)
    with spans.span(spans.MOE_SORT):
        buf, block_expert, meta = sort_tokens_by_expert(x, expert_ids,
                                                        n_experts, bt)
    kw = dict(bt=bt, bf=bf, interpret=interpret, rows=t)
    h = gmm(buf, wi, block_expert, **kw)
    g = gmm(buf, wg, block_expert, **kw)
    del buf
    h = F.silu(g.float()).to(h.dtype) * h
    del g
    y = gmm(h, wo, block_expert, **kw)
    with spans.span(spans.MOE_UNSORT):
        return unsort(y, meta, t)
