"""AdamW with global-norm clipping and a warmup-cosine schedule (twin of
``repro.optim.adamw``).

Functional, as the reference is: :func:`adamw_update` returns new tensors
and never writes into the parameters, gradients or state it was given, so
a failed step can be re-run from its inputs (``runtime.fault_tolerance.retry``)
and a checkpoint snapshot of a state stays valid while training goes on.
The moments are f32 trees shaped like the parameters; bias correction runs
in f32; decay is decoupled and applies to ``ndim >= 2`` leaves only; each
update is cast back to its parameter's dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.apply import map_named, tree_leaves, tree_like

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "abstract_opt_state",
           "adamw_update", "warmup_cosine", "global_norm"]

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor   # () int32
    m: Any               # f32 tree like params
    v: Any


def init_opt_state(params) -> OptState:
    """Zero moments (f32) beside each parameter, step 0 on their device."""
    zeros = map_named(lambda _, p: torch.zeros(p.shape, dtype=_F32, device=p.device),
                      params)
    dev = tree_leaves(params)[0].device
    return OptState(torch.zeros((), dtype=torch.int32, device=dev), zeros,
                    map_named(lambda _, z: z.clone(), zeros))


def abstract_opt_state(params_abs) -> OptState:
    """The dry-run's stand-in state: ``meta`` tensors, an int32 step and f32
    moments shaped like ``params_abs`` (no allocation)."""
    def moments():
        return map_named(lambda _, p: torch.empty(p.shape, dtype=_F32, device="meta"),
                         params_abs)
    return OptState(torch.empty((), dtype=torch.int32, device="meta"), moments(),
                    moments())


def warmup_cosine(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step``: linear warmup, then cosine to
    ``min_lr_ratio · lr`` at ``total_steps`` (f32)."""
    s = step.to(_F32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree, mesh=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32.  With ``mesh`` a
    leaf may be this rank's block of a placed tensor
    (``models.sharding.Placement``): its sum of squares is all-reduced over
    the mesh axes that split it, one all-reduce for all the leaves split
    over the same axes, so each element counts once."""
    if mesh is None:
        sq = sum(torch.sum(torch.square(x.to(_F32))) for x in tree_leaves(tree))
        return torch.sqrt(sq)
    from repro_torch.models import sharding as shd
    names = shd.axis_names(mesh)
    by_axes: dict = {}
    for x in tree_leaves(tree):
        pl = shd.placement(x)
        axes = () if pl is None else tuple(
            a for e in pl.spec for a in shd._as_axes(e) if shd.axis_size(mesh, a) > 1)
        axes = tuple(sorted(set(axes), key=names.index))
        by_axes[axes] = by_axes.get(axes, 0) + torch.sum(torch.square(x.to(_F32)))
    sq = sum(shd.all_reduce(v, mesh, axes) if axes else v for axes, v in by_axes.items())
    return torch.sqrt(sq)


def adamw_update(cfg: AdamWConfig, params, grads, state: OptState,
                 gnorm: Optional[torch.Tensor] = None):
    """Returns (new_params, new_state, stats) with stats ``grad_norm`` and
    ``lr`` (tensors); nothing it was given is modified.  ``gnorm`` is the
    clip's global norm where ``grads`` are shards of the gradient (the ZeRO-3
    step); by default the norm of ``grads``."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = warmup_cosine(cfg, step)
    bc1 = 1 - cfg.b1 ** step.to(_F32)
    bc2 = 1 - cfg.b2 ** step.to(_F32)

    def upd(p, g, m, v):
        g = g.to(_F32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.dim() >= 2:   # decoupled weight decay on matrices only
            u = u + cfg.weight_decay * p.to(_F32)
        return (p.to(_F32) - lr * u).to(p.dtype), m, v

    new = [upd(*leaves) for leaves in zip(*map(tree_leaves, (
        params, grads, state.m, state.v)))]
    new_p, new_m, new_v = ([x[i] for x in new] for i in range(3))
    return (tree_like(params, new_p),
            OptState(step, tree_like(params, new_m), tree_like(params, new_v)),
            {"grad_norm": gnorm, "lr": lr})
