"""Specs-first parameters (twin of ``repro.models.params``): modules declare
``ParamDef(shape, axes, dtype, init, scale)`` trees, and ``init_params``
materializes them on a device from a seed.

``abstract_params`` is the dry-run's stand-in tree: ``meta`` tensors of the
same shapes and dtypes, which allocate nothing and draw nothing.

``params_from_numpy`` carries a reference parameter tree across: the same
nested dict (the same ``/``-joined paths, the same ``(groups, K, N)``
stacking) of numpy arrays becomes the port's tree on a device, so both
sides compute on identical weights.

On a mesh, ``param_pspecs`` gives each leaf's ``PartitionSpec`` under the
sharding rules, ``shard_params`` cuts a global tree (tensors, or numpy: the
weight carry-over; or a served tree, whose packed leaves it keeps as they
are) into this rank's shards, each placed
(``sharding.Placement``), and ``gather_params`` puts the shards back
together (ZeRO-3 storage and the sharded serving layout; checkpoints hold
the global arrays).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["ParamDef", "init_params", "abstract_params", "params_from_numpy",
           "torch_dtype", "param_pspecs", "param_shardings", "shard_params",
           "gather_params", "tree_bytes"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple                  # logical axis names, len == len(shape)
    dtype: str = "float32"
    init: str = "normal"         # normal | zeros | ones
    scale: float = 1.0           # stddev multiplier for normal inits

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def torch_dtype(name) -> torch.dtype:
    """'float32' / 'bfloat16' / ... -> torch dtype (dtypes pass through)."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _fan_in(shape) -> int:
    return int(np.prod(shape[:-1])) if len(shape) > 1 else max(shape[0], 1)


def _resolve_dtype(d: ParamDef, override) -> torch.dtype:
    """Overrides apply to floating leaves only (packed uint8 / int8 payloads
    and integer counters keep their declared dtype)."""
    dt = torch_dtype(d.dtype)
    if override is not None and dt.is_floating_point:
        return torch_dtype(override)
    return dt


def _map_defs(fn, defs):
    """``fn(path, def)`` over a ``ParamDef`` tree, the tree's shape kept."""
    def walk(tree, prefix):
        if isinstance(tree, ParamDef):
            return fn(prefix, tree)
        return {k: walk(v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return walk(defs, "")


def init_params(defs, seed: int = 0, device="cuda",
                dtype_override: Optional[str] = None):
    """Materialize a ParamDef tree on ``device`` (default ``"cuda"``; raises
    without a card unless ``device="cpu"``).  Each leaf draws from its own
    ``torch.Generator`` on that device, seeded from ``seed`` and a CRC of its
    path name, so a leaf's values do not depend on the others."""
    dev = resolve_device(device)

    def make(name, d: ParamDef):
        dt = _resolve_dtype(d, dtype_override)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed((seed << 32) ^ zlib.crc32(name.encode()))
        std = d.scale / np.sqrt(_fan_in(d.shape)) if d.init == "normal" else d.scale
        arr = torch.randn(d.shape, generator=gen, dtype=torch.float32, device=dev)
        return (arr * std).to(dt)
    return _map_defs(make, defs)


def abstract_params(defs, dtype_override: Optional[str] = None):
    """``meta`` tensor tree of a ``ParamDef`` tree: the twin of the
    reference's ``ShapeDtypeStruct`` stand-ins (no allocation, no draw)."""
    return _map_defs(lambda _, d: torch.empty(
        d.shape, dtype=_resolve_dtype(d, dtype_override), device="meta"), defs)


def tree_bytes(defs) -> int:
    """Bytes of a ``ParamDef`` tree at its declared dtypes."""
    sizes = []
    _map_defs(lambda _, d: sizes.append(
        int(np.prod(d.shape)) * torch_dtype(d.dtype).itemsize), defs)
    return sum(sizes)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Reference params as a nested dict of numpy arrays -> the port's tree
    of tensors on ``device``, with the same keys and shapes."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(dev)


def _with_defs(fn, tree, defs):
    """``fn(leaf, def)`` over a parameter tree and its ``ParamDef`` tree."""
    if isinstance(defs, ParamDef):
        return fn(tree, defs)
    return {k: _with_defs(fn, tree[k], d) for k, d in defs.items()}


def param_pspecs(defs, rules):
    """``ParamDef`` tree -> ``PartitionSpec`` tree under ``rules``."""
    from repro_torch.models.sharding import spec_for_axes
    return _with_defs(lambda _, d: spec_for_axes(d.axes, rules.table), defs, defs)


def param_shardings(defs, mesh, rules):
    """``ParamDef`` tree -> ``(mesh, PartitionSpec)`` pairs, the twin of the
    reference's ``NamedSharding`` tree."""
    return _with_defs(lambda spec, _: (mesh, spec), param_pspecs(defs, rules),
                      defs)


def shard_params(tree, defs, mesh, rules, device=None):
    """A global tree (tensors or numpy arrays, e.g. the reference's
    ``init_params``; or a served tree) -> this rank's shards under
    ``rules``, on ``device`` (default: the mesh's device type).  Every dense
    leaf is cut by its ``ParamDef``'s logical axes (the reference's
    ``param_shardings``) and says what it holds: its
    :class:`~repro_torch.models.sharding.Placement` (global shape, spec,
    logical axes).  A packed leaf of a served tree is kept as it is: the
    block of a plan built on this mesh (``build_plan(mesh=)``; its
    ``ExecSpec.shard`` says so), or a mesh-less plan's whole leaf, which the
    ``sharded:*`` variants cut to this rank's block per use
    (``engine.sharded.local_payload``); the block of a plan built on
    another mesh raises.  A leaf placed already is kept (the call is
    idempotent).  Cutting a ZeRO-3 tree is the same call on a training
    tree."""
    from repro_torch.models.sharding import (axis_sizes, place, placement,
                                             shard_slice, spec_for_axes)
    dev = resolve_device(device or mesh.device_type)
    here = tuple(axis_sizes(mesh).items())

    def cut(x, d):
        if isinstance(x, dict):
            shard = getattr(x.get("spec"), "shard", None)
            if shard is not None and shard.mesh_shape != here:
                raise ValueError(
                    "shard_params: a packed leaf cut for the mesh "
                    f"{dict(shard.mesh_shape)}, not this mesh {dict(here)}; "
                    "build the plan with build_plan(..., mesh=) on this mesh")
            return x
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
        spec = spec_for_axes(d.axes, rules.table)
        pl = placement(x)
        if pl is not None:          # placed already: this rank's block
            if pl.spec != spec or pl.mesh_shape != here:
                raise ValueError(f"shard_params: a leaf placed at {pl.spec} on "
                                 f"{dict(pl.mesh_shape)}; want {spec} on {dict(here)}")
            return x
        return place(shard_slice(x, spec, mesh).to(dev), mesh, spec,
                     tuple(x.shape), d.axes)
    return _with_defs(cut, tree, defs)


def gather_params(tree, defs, mesh, rules):
    """This rank's shards -> the global tree (every rank gets all of it)."""
    from repro_torch.models.sharding import all_gather, spec_for_axes

    def whole(x, d):
        for dim, entry in enumerate(spec_for_axes(d.axes, rules.table)):
            x = all_gather(x, mesh, entry, dim)
        return x
    return _with_defs(whole, tree, defs)
