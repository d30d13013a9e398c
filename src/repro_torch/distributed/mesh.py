"""Mesh axis conventions.

PyTorch counterpart of ``repro/distributed/mesh.py``. Production meshes
(``launch/mesh.py``): single-pod (16,16)=("data","model"), multi-pod
(2,16,16)=("pod","data","model"). "pod" defaults to an extra
data-parallel axis; ``distributed/pipeline.py`` can repurpose it as a
pipeline axis. Everything here reads only ``axis_names`` and ``shape``,
so it takes any mesh shape (the tests use tiny meshes and stand-ins).
"""
from __future__ import annotations

from typing import Tuple


def batch_axes(mesh) -> Tuple[str, ...]:
    """Axes that shard the batch dimension (every non-'model' axis)."""
    return tuple(a for a in mesh.axis_names if a != "model")


def model_axis_size(mesh) -> int:
    return mesh.shape.get("model", 1)


def dp_size(mesh) -> int:
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.shape[a]
    return n
