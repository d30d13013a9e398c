"""Wrappers of the Hopper delta-int8 checkpoint codec kernels.

PyTorch counterpart of ``repro/kernels/ckpt_codec/kernel.py`` and
``ops.py``, with their names and arguments: ``encode_tiles`` and
``decode_tiles`` on ``[n_tiles, TILE]`` arrays, ``delta_encode`` and
``delta_decode`` on arrays of any shape, which JAX flattens and pads with
zeros to a whole number of tiles. Here the kernels read a ragged last tile
as zeros and write nothing past the array's end, so no padded copy is
made; the codes and scales are those of the padded arrays.

A CUDA tensor launches a kernel of ``csrc/ckpt_codec.cu`` or raises; a CPU
tensor, or ``interpret=True`` (JAX's name), runs the plain version
(``ref.encode_ref``/``decode_ref``) on the padded tiles.
``encode_launches`` and ``decode_launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ckpt_codec.ref import TILE, decode_ref, encode_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ckpt_codec.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

#: kernel launches in this process; ``chip_smoke.py`` resets and reads them
encode_launches = 0
decode_launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, once per
    process."""
    from repro_torch.kernels import build
    lib = build.load("ckpt_codec", SOURCE)
    enc = lib.repro_ckpt_encode
    enc.restype = ctypes.c_int
    enc.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p]
    dec = lib.repro_ckpt_decode
    dec.restype = ctypes.c_int
    dec.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p]
    return lib


def n_tiles(n: int) -> int:
    return -(-n // TILE)


def _tiles(flat: torch.Tensor) -> torch.Tensor:
    """Flat -> [n_tiles, TILE], zero-padded (the plain version's input)."""
    return F.pad(flat, (0, (-flat.numel()) % TILE)).reshape(-1, TILE)


def _flat(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} dtype {x.dtype}: the codec takes "
                        f"{sorted(map(str, _DTYPES))}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return x.reshape(-1)


def _vec(x: torch.Tensor) -> int:
    """1 when 4 consecutive elements can move as one aligned vector."""
    return int(x.data_ptr() % (4 * x.element_size()) == 0)


def _on_card(*ts: torch.Tensor, interpret: bool) -> bool:
    if interpret or all(t.device.type == "cpu" for t in ts):
        return False
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"the codec runs on one cuda device or on the "
                         f"cpu, not {[str(t.device) for t in ts]}")
    return True


def _encode_flat(new: torch.Tensor, base: torch.Tensor, *,
                 interpret: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat new, base of n elements -> (q int8 [n_tiles, TILE], scale
    float32 [n_tiles, 1])."""
    new, base = _flat(new, "new"), _flat(base, "base")
    if new.numel() != base.numel():
        raise ValueError(f"new has {new.numel()} elements, base "
                         f"{base.numel()}")
    if not _on_card(new, base, interpret=interpret):
        return encode_ref(_tiles(new), _tiles(base))
    n = new.numel()
    q = torch.empty((n_tiles(n), TILE), dtype=torch.int8, device=new.device)
    scale = torch.empty((n_tiles(n), 1), dtype=torch.float32,
                        device=new.device)
    if n == 0:
        return q, scale
    with torch.cuda.device(new.device):
        err = _library().repro_ckpt_encode(
            new.data_ptr(), _DTYPES[new.dtype], _vec(new), base.data_ptr(),
            _DTYPES[base.dtype], _vec(base), n, q.data_ptr(),
            scale.data_ptr(),
            torch.cuda.current_stream(new.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ckpt_codec encode launch failed: CUDA error "
                           f"{err}")
    global encode_launches
    encode_launches += 1
    return q, scale


def _decode_flat(q: torch.Tensor, scale: torch.Tensor, base: torch.Tensor,
                 dtype: torch.dtype, *, interpret: bool = False
                 ) -> torch.Tensor:
    """Codes and scales of a flat array of n = base.numel() elements ->
    the decoded flat array in ``dtype``."""
    base = _flat(base, "base")
    n = base.numel()
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"q {q.dtype}, scale {scale.dtype}: want int8 and "
                        f"float32")
    if q.shape != (n_tiles(n), TILE) or scale.numel() != n_tiles(n):
        raise ValueError(f"q {tuple(q.shape)} / scale {tuple(scale.shape)} "
                         f"do not cover {n} elements in tiles of {TILE}")
    if dtype not in _DTYPES:
        raise TypeError(f"output dtype {dtype} not in {sorted(map(str, _DTYPES))}")
    if not _on_card(q, scale, base, interpret=interpret):
        out = decode_ref(q, scale.reshape(-1, 1), _tiles(base), dtype)
        return out.reshape(-1)[:n]
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("q and scale must be contiguous")
    out = torch.empty(n, dtype=dtype, device=base.device)
    if n == 0:
        return out
    with torch.cuda.device(base.device):
        err = _library().repro_ckpt_decode(
            q.data_ptr(), scale.data_ptr(), base.data_ptr(),
            _DTYPES[base.dtype], _vec(base), n, out.data_ptr(),
            _DTYPES[dtype], _vec(out),
            torch.cuda.current_stream(base.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ckpt_codec decode launch failed: CUDA error "
                           f"{err}")
    global decode_launches
    decode_launches += 1
    return out


def _check_tiles(x: torch.Tensor, name: str) -> None:
    if x.dim() != 2 or x.shape[1] != TILE:
        raise ValueError(f"{name} {tuple(x.shape)} is not [n_tiles, {TILE}]")


def encode_tiles(new: torch.Tensor, base: torch.Tensor, *,
                 interpret: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """new, base [n, TILE] -> (q int8 [n, TILE], scales float32 [n, 1])."""
    _check_tiles(new, "new")
    _check_tiles(base, "base")
    return _encode_flat(new, base, interpret=interpret)


def decode_tiles(q: torch.Tensor, scales: torch.Tensor, base: torch.Tensor,
                 *, dtype=torch.bfloat16,
                 interpret: bool = False) -> torch.Tensor:
    """q [n, TILE], scales [n, 1], base [n, TILE] -> [n, TILE] in
    ``dtype``."""
    _check_tiles(base, "base")
    return _decode_flat(q, scales, base, dtype,
                        interpret=interpret).reshape(-1, TILE)


def delta_encode(new: torch.Tensor, base: torch.Tensor, *,
                 interpret: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Any-shape arrays -> (q int8 [n_tiles, TILE], scales [n_tiles, 1])."""
    return _encode_flat(new, base, interpret=interpret)


def delta_decode(q: torch.Tensor, scales: torch.Tensor, base: torch.Tensor,
                 *, shape: Tuple[int, ...], dtype=torch.bfloat16,
                 interpret: bool = False) -> torch.Tensor:
    """Codes and scales of an array of ``base``'s size -> that array in
    ``shape`` and ``dtype``."""
    return _decode_flat(q, scales, base, dtype,
                        interpret=interpret).reshape(shape)
