"""Production mesh builders over ``torch.distributed``.

PyTorch counterpart of ``repro/launch/mesh.py``. A ``Mesh`` names its
axes and their sizes as JAX's does (``axis_names``, and ``shape``: a
mapping of axis name to size); every process of the world is one device
of the mesh, and its coordinate along each axis comes from the
``DeviceMesh`` that backs the mesh. A mesh whose every axis has size 1
needs no process group: it has no ``DeviceMesh``, its coordinate is 0 on
every axis, and every collective over it is the identity, so the CLIs
and single-process tests never initialise ``torch.distributed``.

``init_world`` starts one process of a world on one host (a
``FileStore`` rendezvous) and picks the backend by one rule: NCCL when
every rank has a card of its own, else gloo (NCCL refuses two ranks on
one device).
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device


class Mesh:
    """Named axes over the world's processes (device-major, last axis
    fastest, as ``jax.make_mesh`` lays its devices out)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device="cuda", device_mesh=None):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} vs axes "
                             f"{tuple(axes)}")
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.devices_shape: Tuple[int, ...] = tuple(int(n) for n in shape)
        self.device_type = torch.device(device).type
        self.device_mesh = device_mesh

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices_shape))

    @property
    def size(self) -> int:
        return math.prod(self.devices_shape)

    def coordinate(self) -> Dict[str, int]:
        """This process's index along each axis."""
        if self.device_mesh is None:
            return dict.fromkeys(self.axis_names, 0)
        return dict(zip(self.axis_names, self.device_mesh.get_coordinate()))

    def group(self, axis: str):
        """The process group of this process's row along ``axis``."""
        if self.device_mesh is None:
            raise RuntimeError(f"mesh {self.shape} has no process group")
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_type})"


def make_mesh(shape, axes, device="cuda") -> Mesh:
    """Arbitrary (test-scale) mesh with the production axis conventions.
    A mesh of more than one device needs ``torch.distributed``
    initialised with exactly that many processes (``device`` is then
    the one its processes run on; a 1-device mesh touches no device)."""
    mesh = Mesh(shape, axes, device)
    if mesh.size == 1:
        return mesh
    dev = resolve_device(device)
    if not dist.is_initialized() or dist.get_world_size() != mesh.size:
        raise RuntimeError(
            f"mesh {mesh.shape} needs a world of {mesh.size} processes "
            f"(init_world), have "
            f"{dist.get_world_size() if dist.is_initialized() else 0}")
    from torch.distributed.device_mesh import init_device_mesh
    mesh.device_mesh = init_device_mesh(dev.type, mesh.devices_shape,
                                        mesh_dim_names=mesh.axis_names)
    return mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def backend_for(world: int, device) -> str:
    """NCCL when every rank of the world has a card of its own, else
    gloo (NCCL refuses two ranks on one device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def init_world(rank: int, world: int, init_file, device="cuda",
               backend: Optional[str] = None) -> str:
    """Join a world of ``world`` processes on this host through a
    ``FileStore`` at ``init_file`` (a path no earlier world used); on a
    card, rank r uses device ``r % device_count``. Returns the
    backend."""
    dev = resolve_device(device)
    backend = backend or backend_for(world, dev)
    if backend == "gloo":  # the ranks share this host: its loopback
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(str(init_file), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    return backend
