"""Mesh construction (twin of ``repro.launch.mesh``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the world's ranks.
Functions, not module constants: importing this module starts no process
group.  The caller starts one for a world of more than one rank (``torchrun``
sets the environment ``init_process_group`` reads; tests spawn gloo ranks);
where none exists and the world is 1, :func:`make_host_mesh` starts one
itself from an in-memory ``HashStore``, with no socket.

:class:`AbstractMesh` is a mesh with axis names, sizes and one rank's
coordinate, and no process group and no devices: the dry-run's stand-in
(``make_production_mesh(device="meta")``).  The collectives of
:mod:`repro_torch.models.sharding` take it with ``meta`` tensors only and
build their results' shapes without ``torch.distributed``.
"""
from __future__ import annotations

import math
import os

import torch

from repro_torch import resolve_device

__all__ = ["AbstractMesh", "make_production_mesh", "make_host_mesh",
           "ensure_process_group"]


class AbstractMesh:
    """Axis names and sizes, and the coordinate of the one rank whose work is
    counted (all zeros unless ``coord`` says otherwise), with the
    ``DeviceMesh`` methods the port reads: ``mesh_dim_names``, ``shape``,
    ``size(i)``, ``get_local_rank(axis)`` and ``device_type`` (``"meta"``).
    ``target`` is the device type the counted rank stands for, ``"cuda"``
    (the card) or ``"cpu"``: the post-gather kernels are selected as they
    are on it."""

    abstract = True
    device_type = "meta"

    def __init__(self, shape, names, coord=None, target: str = "cuda"):
        self.mesh_dim_names = tuple(names)
        self.shape = tuple(int(n) for n in shape)
        coord = tuple(coord) if coord is not None else (0,) * len(self.shape)
        if not len(self.shape) == len(self.mesh_dim_names) == len(coord) or \
                any(not 0 <= c < n for c, n in zip(coord, self.shape)):
            raise ValueError(f"mesh {dict(zip(self.mesh_dim_names, self.shape))}: "
                             f"coordinate {coord} is not one of its ranks")
        if target not in ("cuda", "cpu"):
            raise ValueError(f"target={target!r}; want 'cuda' or 'cpu'")
        self.coord = dict(zip(self.mesh_dim_names, coord))
        self.target = target

    def _dim(self, mesh_dim) -> int:
        return mesh_dim if isinstance(mesh_dim, int) else \
            self.mesh_dim_names.index(mesh_dim)

    def size(self, mesh_dim=None) -> int:
        return math.prod(self.shape) if mesh_dim is None else self.shape[self._dim(mesh_dim)]

    def get_local_rank(self, mesh_dim=None) -> int:
        return self.coord[self.mesh_dim_names[self._dim(mesh_dim or 0)]]

    def __repr__(self) -> str:
        axes = ", ".join(f"{n}={s}" for n, s in zip(self.mesh_dim_names, self.shape))
        return f"AbstractMesh({axes}; rank at {self.coord}, target {self.target})"


def ensure_process_group(device="cuda") -> None:
    """Start the default process group if none exists: from the environment
    (``torchrun``: ``WORLD_SIZE`` > 1) or, for a world of 1, from a
    ``HashStore``.  NCCL on the card, gloo on the CPU.  On the card each rank
    takes device ``LOCAL_RANK`` modulo the cards present."""
    import torch.distributed as dist
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    if dist.is_initialized():
        return
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if int(os.environ.get("WORLD_SIZE", 1)) > 1:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def _mesh(device, shape: tuple, names: tuple):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    ensure_process_group(dev)
    n = dist.get_world_size()
    if torch.Size(shape).numel() != n:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs "
                         f"{torch.Size(shape).numel()} ranks; the world has {n}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's production shapes: 16x16 ("data", "model"), or
    2x16x16 ("pod", "data", "model"); built only on a world of that size,
    except with ``device="meta"``, which gives the :class:`AbstractMesh` of
    that shape (rank 0's coordinate, standing for the card)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    if torch.device(device).type == "meta":
        return AbstractMesh(shape, names)
    return _mesh(device, shape, names)


def make_host_mesh(data: int = 1, model: int = 1, pp: int = 0, device="cuda"):
    """A ("data", "model") mesh, or ("pp", "data", "model") with ``pp``,
    over the world's ranks (its size must be the product).  ``device``
    defaults to ``"cuda"`` (NCCL, or whatever group the caller started);
    ``device="cpu"`` gives gloo."""
    if pp:
        return _mesh(device, (pp, data, model), ("pp", "data", "model"))
    return _mesh(device, (data, model), ("data", "model"))
