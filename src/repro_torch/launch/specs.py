"""Dry-run input specs (twin of ``repro.launch.specs``): ``meta`` stand-ins
and ``PartitionSpec`` trees for every (arch x shape) cell, allocating
nothing.

:func:`input_specs` returns the inputs of the cell's step as ``meta``
tensors (the reference's ``ShapeDtypeStruct`` trees), in the reference's
order; tokens and labels are int64, the port's token dtype, where the
reference's are int32, and a decode cell's ``cache_len`` is the Python int
``shape.seq_len`` (the port's decode reads it on the host, so a ``meta``
scalar could not run).  :func:`input_shardings` gives the same trees'
``PartitionSpec`` leaves under the sharding rules (the reference's
``NamedSharding`` trees without the mesh): it reads only a mesh's axis names
and sizes, so a stand-in object with ``axis_names`` and a ``shape`` dict
serves, as ``models.sharding`` allows wherever no collective runs.

They are the placement the serving steps take on a mesh
(:func:`place_inputs`; the sharded serving layout of
``models.sharding``), for every family's prefill and decode cells:
``serve --mesh`` and the mesh dry-run apply them.  Packed 2-D weights are
the blocks a mesh-aware plan cuts (``build_plan(mesh=)``), which are these
specs' blocks; a packed expert stack's block axis, which the plan also
splits over the data axes, is held whole, as these specs hold it
(``engine.sharded.stack_at_rest``).  A train cell's parameters and AdamW
moments are this rank's shards under the same rules, its batch global (the
train layout's step takes its rows itself).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.data.pipeline import DataConfig, batch_specs
from repro_torch.models import cache_defs, model_defs
from repro_torch.models.params import abstract_params, param_pspecs
from repro_torch.models.sharding import (P, Rules, axis_sizes, fsdp_axes,
                                         rules_for_mesh)
from repro_torch.optim.adamw import OptState, abstract_opt_state

__all__ = ["input_specs", "input_shardings", "batch_axes", "padded_cache_len",
           "place_inputs"]


def padded_cache_len(seq_len: int) -> int:
    """Cache length (seq + 1 headroom slot) rounded to 512 so the
    model-sharded cache_seq dim divides any mesh axis."""
    return -(-(seq_len + 1) // 512) * 512


def batch_axes(mesh, global_batch: Optional[int] = None) -> tuple:
    """The mesh axes the batch splits over; ``()`` (replicated) for a batch
    they do not divide, e.g. long_500k's B = 1."""
    axes = fsdp_axes(mesh)
    if global_batch is not None:
        sizes = axis_sizes(mesh)
        if global_batch % math.prod(sizes[a] for a in axes):
            return ()
    return axes


def _batch_specs(cfg: ModelConfig, seq: int, batch: int) -> dict:
    return batch_specs(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch),
                       d_model=cfg.d_model, modality=cfg.modality)


def _defs_for(cfg: ModelConfig, kind: str) -> dict:
    """Dense defs for training; StruM-packed defs for inference when
    ``cfg.strum`` is set (packed serving)."""
    if cfg.strum is not None and kind in ("prefill", "decode"):
        from repro_torch.models.quantize import packed_model_defs
        return packed_model_defs(cfg)
    return model_defs(cfg)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, param_dtype: str = "bfloat16"):
    """``meta`` stand-ins for the step inputs of this cell:

    train   -> (params, opt_state, batch)
    prefill -> (params, batch)               (no labels)
    decode  -> (params, token, caches, cache_len)
    """
    defs = _defs_for(cfg, shape.kind)
    params = abstract_params(defs, dtype_override=param_dtype)
    if shape.kind == "train":
        return (params, abstract_opt_state(params),
                _batch_specs(cfg, shape.seq_len, shape.global_batch))
    if shape.kind == "prefill":
        b = _batch_specs(cfg, shape.seq_len, shape.global_batch)
        b.pop("labels")
        return params, b
    # decode: one new token against a cache of length seq_len (padded with
    # headroom so the model-sharded seq dim divides the mesh)
    caches = abstract_params(cache_defs(cfg, shape.global_batch,
                                        padded_cache_len(shape.seq_len)))
    if cfg.modality == "text":
        token = torch.empty((shape.global_batch, 1), dtype=torch.long, device="meta")
    else:
        token = torch.empty((shape.global_batch, 1, cfg.d_model),
                            dtype=torch.bfloat16, device="meta")
    return params, token, caches, shape.seq_len


def input_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh,
                    rules: Optional[Rules] = None):
    """``PartitionSpec`` trees matching :func:`input_specs` leaf for leaf
    (``cache_len`` and the optimizer step replicated: ``P()``)."""
    rules = rules or rules_for_mesh(mesh)
    pspecs = param_pspecs(_defs_for(cfg, shape.kind), rules)
    baxes = batch_axes(mesh, shape.global_batch)

    def batch_spec(t: torch.Tensor):
        return P(baxes, None, None) if t.dim() == 3 else P(baxes, None)

    if shape.kind == "train":
        bspecs = _batch_specs(cfg, shape.seq_len, shape.global_batch)
        return (pspecs, OptState(P(), pspecs, pspecs),
                {k: batch_spec(v) for k, v in bspecs.items()})
    if shape.kind == "prefill":
        bspecs = _batch_specs(cfg, shape.seq_len, shape.global_batch)
        bspecs.pop("labels")
        return pspecs, {k: batch_spec(v) for k, v in bspecs.items()}
    table = dict(rules.table)
    if not baxes:
        table["batch"] = None   # B=1 long-context: cache batch replicated
    cspecs = param_pspecs(cache_defs(cfg, shape.global_batch,
                                     padded_cache_len(shape.seq_len)), Rules(table))
    token = P(baxes, None, None) if cfg.modality != "text" else P(baxes, None)
    return pspecs, token, cspecs, P()


def place_inputs(cfg: ModelConfig, shape: ShapeSpec, inputs, mesh,
                 rules: Optional[Rules] = None):
    """This rank's blocks of a cell's whole ``inputs`` (in
    :func:`input_specs`' order) under :func:`input_shardings`, each placed
    (``models.sharding.Placement``): what the sharded serving layout's
    prefill and decode steps take.  Dense weights are cut by
    ``models.params.shard_params``; packed weights must be a mesh-aware
    plan's blocks already, and its expert stacks' block axes are gathered
    whole (the module docstring).  A train cell's parameters and AdamW
    moments are cut to this rank's shards, its batch left global (the train
    layout's step takes its rows)."""
    from repro_torch.core.apply import map_named
    from repro_torch.engine.sharded import stack_at_rest
    from repro_torch.models.params import shard_params
    from repro_torch.models.sharding import place_tree
    rules = rules or rules_for_mesh(mesh, shape.global_batch)
    defs = model_defs(cfg)
    dev = _device_of(inputs[0])
    if shape.kind == "train":
        params, opt, batch = inputs
        cut = lambda t: shard_params(t, defs, mesh, rules, device=dev)  # noqa: E731
        return cut(params), OptState(opt.step, cut(opt.m), cut(opt.v)), batch
    specs = input_shardings(cfg, shape, mesh, rules)
    params = map_named(lambda _, w: stack_at_rest(w, mesh) if isinstance(w, dict) else w,
                       shard_params(inputs[0], defs, mesh, rules, device=dev),
                       is_leaf=lambda x: isinstance(x, dict) and "mask" in x)
    rest = tuple(place_tree(t, s, mesh) if isinstance(t, (dict, torch.Tensor)) else t
                 for t, s in zip(inputs[1:], specs[1:]))
    return (params,) + rest


def _device_of(tree) -> torch.device:
    """The device of the first tensor of a parameter tree."""
    if isinstance(tree, dict):
        for v in tree.values():
            dev = _device_of(v)
            if dev is not None:
                return dev
        return None
    return tree.device if isinstance(tree, torch.Tensor) else None
