"""PyTorch/CUDA port of the JAX package ``repro`` for one NVIDIA H100.

It mirrors the JAX package's module names so that one can be read against
the other, imports ``torch`` and ``numpy`` only, and runs on the card
unless the caller asks for the CPU. The kernels the JAX package wrote in
Pallas for the TPU are written by hand for Hopper here (``kernels/``); each
keeps a plain PyTorch version beside it, which is what a CPU tensor runs.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``cuda`` without a card raises:
    the port never carries on silently on the CPU; pass ``device="cpu"``
    to ask for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
