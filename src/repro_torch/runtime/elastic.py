"""Elastic rescaling: resume a run on a different device count (twin of
``repro.runtime.elastic``).

Invariants that make this safe, as in the reference:
  * parameter and optimizer checkpoints hold the *logical* (global) arrays
    (:func:`global_state` before ``checkpoint.save``), so resharding is
    cutting them anew on restore (:func:`local_state` on the new mesh);
  * the data pipeline is stateless-indexed (step -> batch), so changing the
    number of data shards only changes which rank computes which rows;
  * mesh construction is a pure function of (n_devices, model_parallelism),
    so any fleet size with n % model == 0 resumes cleanly.

``plan_remesh`` validates a proposed new fleet and returns the new mesh
shape.  Global batch stays FIXED across rescales (per-device batch
changes), so optimization dynamics are unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["RemeshPlan", "plan_remesh", "global_state", "local_state"]


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    old_shape: tuple
    new_shape: tuple
    axis_names: tuple
    relower: bool = True            # always true: device count changed
    notes: str = ""


def plan_remesh(n_devices: int, model_parallel: int, global_batch: int,
                old_shape: Optional[tuple] = None,
                pods: int = 1) -> RemeshPlan:
    if n_devices % (model_parallel * pods):
        raise ValueError(
            f"{n_devices} devices not divisible by model={model_parallel} x pods={pods}")
    data = n_devices // (model_parallel * pods)
    if global_batch % (data * pods):
        raise ValueError(
            f"global_batch={global_batch} not divisible by data shards {data * pods}")
    if pods > 1:
        new = (pods, data, model_parallel)
        names = ("pod", "data", "model")
    else:
        new = (data, model_parallel)
        names = ("data", "model")
    return RemeshPlan(old_shape or new, new, names,
                      notes=f"per-data-shard batch {global_batch // (data * pods)}")


def _per_tree(fn, state: dict) -> dict:
    """``fn`` over each parameter-shaped tree of a train state ``{"params",
    "opt"[, "ef"]}``: ``params`` itself and every dict field of a NamedTuple
    (the AdamW moments, the error-feedback residual); the step passes."""
    def one(v):
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return type(v)(*(fn(f) if isinstance(f, dict) else f for f in v))
        return fn(v)
    return {k: one(v) for k, v in state.items()}


def global_state(state: dict, defs, mesh, rules) -> dict:
    """A ZeRO-3 train state (this rank's shards) -> the logical arrays, the
    form a checkpoint holds; every rank gets all of it."""
    from repro_torch.models.params import gather_params
    return _per_tree(lambda t: gather_params(t, defs, mesh, rules), state)


def local_state(state: dict, defs, mesh, rules) -> dict:
    """Logical arrays (e.g. a restored checkpoint) -> this rank's shards on
    ``mesh``, which may differ from the mesh that saved them."""
    from repro_torch.models.params import shard_params
    return _per_tree(lambda t: shard_params(t, defs, mesh, rules), state)
