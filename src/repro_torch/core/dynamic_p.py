"""Dynamic per-layer precision ratio — compatibility wrapper (twin of
``repro.core.dynamic_p``).

    "At present, p ... remains constant.  In future work, we aim to explore
    methods for dynamically adjusting p on a per-layer basis." (§VIII)

The original implementation (a fixed-grid p sweep with an SQNR floor) has
been subsumed by :mod:`repro_torch.autotune`, which searches the full
method × w × p × q/L space against a joint accuracy-proxy + hardware cost
model and emits serializable :class:`~repro_torch.autotune.schedule.StruMSchedule`
artifacts.  This module keeps the historical entry points as thin shims over
the new search — same signatures, same selection semantics (largest p whose
SQNR clears the floor; tensors that miss at every p stay plain INT8), now
via ``search_schedule(..., Budget(min_sqnr_db=floor))``.

New code should use :mod:`repro_torch.autotune` directly.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.autotune.schedule import StruMSchedule
from repro_torch.autotune.search import Budget, search_schedule
from repro_torch.core.apply import _named_leaves
from repro_torch.core.policy import DEFAULT_EXCLUDE, LayerPolicy, StruMConfig

__all__ = ["choose_layer_p", "dynamic_policy", "achieved_ratio", "CANDIDATE_P"]

CANDIDATE_P = (0.75, 0.5, 0.25)


def choose_layer_p(params, *, method: str = "mip2q", sqnr_floor_db: float = 28.0,
                   w: int = 16, q: int = 4, L: int = 7,
                   base_policy: Optional[LayerPolicy] = None) -> dict:
    """{tensor name: StruMConfig | None} — largest p clearing the SQNR floor.

    Tensors where even p=0.25 misses the floor stay at plain INT8 (None) —
    the per-layer fallback the configurable PE exists for.
    """
    base_policy = base_policy or LayerPolicy(default=StruMConfig(
        method=method, w=w, q=q, L=L))
    grid = [StruMConfig(method=method, w=w, p=p, q=q, L=L)
            for p in CANDIDATE_P]
    sched = search_schedule(params, Budget(min_sqnr_db=sqnr_floor_db),
                            grid=grid, base_policy=base_policy)
    return dict(sched.assignments)


def dynamic_policy(chosen: dict, *, method: str = "mip2q", q: int = 4,
                   L: int = 7) -> LayerPolicy:
    """LayerPolicy whose overrides pin each tensor to its chosen config."""
    return StruMSchedule(assignments=dict(chosen),
                         exclude=DEFAULT_EXCLUDE).to_policy()


def achieved_ratio(chosen: dict, params) -> float:
    """Bytes-weighted average compression vs INT8 across chosen configs."""
    sizes = {name: int(leaf.numel()) for name, leaf in _named_leaves(params)
             if isinstance(leaf, torch.Tensor)}
    return StruMSchedule(assignments=dict(chosen)).achieved_ratio(sizes)
