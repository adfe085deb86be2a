"""Pipeline parallelism (GPipe fill-drain) over a ``pp`` mesh axis (twin of
``repro.runtime.pipeline``).

Parameters arrive stacked ``(n_stages, ...)``; activations are a
``(n_micro, B_micro, ...)`` queue.  Each tick every stage runs its resident
microbatch and the result hops one stage down the ring; after ``n_micro +
n_stages - 1`` ticks every microbatch has crossed every stage.  Bubble
fraction = (S-1)/(M+S-1) (:func:`bubble_fraction`).

Global in, global out, as the reference's ``shard_map``: every rank takes
the whole stacked parameters and the whole batch, runs the stage of its
``pp`` coordinate, and returns the whole result.  The ring hop is an
``all_gather`` over ``pp`` from which each stage takes its predecessor's
output (a collective both gloo and NCCL implement); the last stage's
outputs reach every rank through one ``all_reduce``.
"""
from __future__ import annotations

import torch

from repro_torch.models import sharding as shd

__all__ = ["pipelined_apply", "bubble_fraction"]


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _stage(tree, i: int):
    """Stage ``i`` of a stacked parameter tree (a tensor or a dict)."""
    if isinstance(tree, dict):
        return {k: _stage(v, i) for k, v in tree.items()}
    return tree[i]


def pipelined_apply(stage_fn, stage_params, x: torch.Tensor, *, mesh, n_micro: int,
                    axis: str = "pp") -> torch.Tensor:
    """``y = stage_{S-1}(...stage_0(x))`` pipelined over ``axis``.

    ``stage_fn(params_i, x_micro) -> y_micro`` of the same shape (uniform
    stages); ``stage_params`` a tensor or dict tree with leading dim
    ``n_stages``; ``x`` ``(n_micro * B_micro, ...)``, the global batch."""
    n_stages = shd.axis_size(mesh, axis)
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} is not divisible by n_micro={n_micro}")
    xm = x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
    sid = shd.axis_index(mesh, axis)
    last = n_stages - 1
    params_me = _stage(stage_params, sid)
    carry = torch.zeros_like(xm[0])             # activation resident here
    outq = torch.zeros_like(xm)
    for t in range(n_micro + n_stages - 1):
        x_in = xm[t] if sid == 0 and t < n_micro else carry
        y = stage_fn(params_me, x_in)
        if sid == last and t >= last:           # the last stage emits
            outq[t - last] = y
        # ring hop: every stage's output to the next stage
        carry = shd.all_gather(y[None], mesh, axis, 0)[(sid - 1) % n_stages]
    outq = shd.all_reduce(outq if sid == last else torch.zeros_like(outq), mesh, axis)
    return outq.reshape((b,) + tuple(outq.shape[2:]))
