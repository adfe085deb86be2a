"""Mesh construction (twin of ``repro.launch.mesh``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the world's ranks.
Functions, not module constants: importing this module starts no process
group.  The caller starts one for a world of more than one rank (``torchrun``
sets the environment ``init_process_group`` reads; tests spawn gloo ranks);
where none exists and the world is 1, :func:`make_host_mesh` starts one
itself from an in-memory ``HashStore``, with no socket.
"""
from __future__ import annotations

import os

import torch

from repro_torch import resolve_device

__all__ = ["make_production_mesh", "make_host_mesh", "ensure_process_group"]


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
    2x16x16 ("pod", "data", "model"); built only on a world of that size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, names)


def make_host_mesh(data: int = 1, model: int = 1, pp: int = 0, device="cuda"):
    """A ("data", "model") mesh, or ("pp", "data", "model") with ``pp``,
    over the world's ranks (its size must be the product).  ``device``
    defaults to ``"cuda"`` (NCCL, or whatever group the caller started);
    ``device="cpu"`` gives gloo."""
    if pp:
        return _mesh(device, (pp, data, model), ("pp", "data", "model"))
    return _mesh(device, (data, model), ("data", "model"))
