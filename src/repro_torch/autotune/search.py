"""Hardware-cost-aware per-layer schedule search (twin of
``repro.autotune.search``; the allocator is the same Python, so a profile
gives the reference's schedule exactly).

The post-training mixed-precision-assignment move (FxP-QNet, RMSMP)
specialized to StruM's structured blocks: given a weight tree, a candidate
grid, and a *budget*, pick each tensor's :class:`StruMConfig` so the model
meets the budget with the least quality loss.  Three budget axes:

  target_ratio — total packed bytes / total int8 bytes ≤ target (Eq. 1/2);
  max_energy   — total normalized deployment energy (costmodel: MAC mix +
                 HBM stream) ≤ budget;
  min_sqnr_db  — per-tensor floor: every chosen config must clear it
                 (tensors that can't stay plain INT8).  This axis subsumes
                 the old ``core.dynamic_p`` heuristic.

Allocator: per tensor, prune the candidate list to its Pareto frontier
(cost strictly up ⇒ noise strictly down); start every tensor at its
lowest-noise point (plain INT8 is always a candidate), then walk down the
frontiers greedily, always taking the step that adds the least *relative
noise power* (size · 10^(−SQNR/10), the linear-domain form of the paper's
L2 objective) per unit of cost saved — the discrete Lagrangian
water-filling that is optimal for convex per-tensor frontiers and a tight
heuristic otherwise.  Noise power, not dB, is the objective on purpose:
dB deltas are near-flat in depth, so a dB-greedy allocator concentrates
all compression on one tensor and destroys it; the linear objective
spreads compression where the weight distributions tolerate it.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional, Sequence

from repro_torch.autotune import costmodel
from repro_torch.autotune.schedule import StruMSchedule, config_key
from repro_torch.autotune.sensitivity import (DEFAULT_GRID,
                                              output_error_profile, profile_tree)
from repro_torch.core.policy import LayerPolicy, StruMConfig, default_policy

__all__ = ["Budget", "Candidate", "pareto_frontier", "search_schedule"]


@dataclasses.dataclass(frozen=True)
class Budget:
    """Global constraint the allocator must satisfy (set at least one).

    ``error_budget`` is not an allocation axis: it declares the maximum
    statically derived end-to-end output error the schedule accepts, is
    recorded in the schedule meta, and is enforced after the fact by the
    numerics pass (``analysis.numerics.check_error_budget`` in
    ``analysis.suite.verify_numerics``; ``build_plan(..., validate=True)``
    checks each packed entry's unit-input bound against it).
    """

    target_ratio: Optional[float] = None   # packed/int8 bytes, e.g. 0.875
    max_energy: Optional[float] = None     # normalized (costmodel units)
    min_sqnr_db: Optional[float] = None    # per-tensor quality floor
    error_budget: Optional[float] = None   # declared max static output error

    def __post_init__(self):
        if (self.target_ratio is None and self.max_energy is None
                and self.min_sqnr_db is None):
            raise ValueError("Budget needs at least one constraint axis "
                             "(error_budget is declarative, not one)")
        if self.target_ratio is not None and self.max_energy is not None:
            raise ValueError(
                "target_ratio and max_energy are alternative cost axes — "
                "set one (min_sqnr_db composes with either)")

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One (config, quality, cost) point on a tensor's trade-off curve.

    ``loss`` is the allocator's objective: size × relative quantization
    noise power (= size · 10^(−SQNR/10)) — the linear-domain form of the
    paper's ‖x − x_q‖₂ objective.  Minimizing summed loss spreads
    compression where the distributions tolerate it; minimizing *dB* loss
    would not (dB deltas are near-flat in depth, so a dB-greedy allocator
    happily crushes one tensor to garbage — the classic failure mode).
    """

    cfg: Optional[StruMConfig]   # None = plain INT8
    sqnr_db: float
    loss: float                  # size-weighted relative noise power
    cost: float                  # the budgeted axis (bytes or energy)
    bytes: int
    energy: float


def _candidates(row: dict, grid: Sequence[StruMConfig], budget: Budget,
                axis: str, proxy: str = "sqnr") -> list:
    """Build the candidate list for one profiled tensor (incl. INT8)."""
    size = row["size"]
    cands = []
    for cfg in (None,) + tuple(grid):
        s = row["int8_sqnr_db"] if cfg is None else row["sqnr_db"][config_key(cfg)]
        if (cfg is not None and budget.min_sqnr_db is not None
                and s < budget.min_sqnr_db):
            continue  # below the floor: never eligible (INT8 always is)
        est = costmodel.config_cost(cfg, size)
        cost = est.bytes if axis == "bytes" else est.energy
        if proxy == "output_error":
            loss = (row["int8_output_err2"] if cfg is None
                    else row["output_err2"][config_key(cfg)])
        else:
            loss = size * 10.0 ** (-float(s) / 10.0)
        cands.append(Candidate(cfg=cfg, sqnr_db=float(s),
                               loss=float(loss),
                               cost=float(cost),
                               bytes=est.bytes, energy=est.energy))
    return cands


def pareto_frontier(cands: Sequence[Candidate]) -> list:
    """Non-dominated subset, sorted by cost ascending, loss descending.

    A candidate survives iff no other has ≤ cost and ≤ loss (with at least
    one strict).  On the result, walking left saves cost and adds noise
    monotonically — the structure the greedy allocator walks.
    """
    best: dict = {}
    for c in cands:  # dedup at equal cost: keep the lowest loss
        if c.cost not in best or c.loss < best[c.cost].loss:
            best[c.cost] = c
    frontier: list = []
    for c in sorted(best.values(), key=lambda c: c.cost):
        if not frontier or c.loss < frontier[-1].loss:
            frontier.append(c)
    return frontier


def search_schedule(params, budget: Budget,
                    grid: Sequence[StruMConfig] = DEFAULT_GRID,
                    base_policy: Optional[LayerPolicy] = None,
                    profile: Optional[dict] = None,
                    proxy: str = "sqnr",
                    fn=None, fn_args: tuple = ()) -> StruMSchedule:
    """Search the per-layer config space against ``budget``.

    ``base_policy`` is the eligibility test (which tensors participate at
    all — defaults to the repo-wide exclusions); ``profile`` lets callers
    reuse a :func:`~repro_torch.autotune.sensitivity.profile_tree` result
    across budget sweeps.

    ``proxy`` picks the allocator's quality objective: ``"sqnr"`` is the
    data-free size-weighted noise power; ``"output_error"`` is the
    activation-aware statically derived *output* error power (weight noise
    rescaled by each leaf's noise gain — the quantity the numerics pass
    bounds).  The output-error proxy needs either a profile from
    ``output_error_profile`` or ``fn``/``fn_args`` (a forward, e.g.
    ``lambda p, t: forward_train(p, {"tokens": t}, cfg)[0]``) to derive one
    here.

    Returns a :class:`StruMSchedule` whose meta records the budget, the
    proxy, the per-tensor decision table, and the achieved totals.
    """
    if proxy not in ("sqnr", "output_error"):
        raise ValueError(f"proxy={proxy!r}: pick 'sqnr' or 'output_error'")
    base_policy = base_policy or default_policy()
    grid = tuple(grid)
    if proxy == "output_error":
        have_gains = profile is not None and all(
            "output_err2" in row for row in profile.values())
        if not have_gains:
            if fn is None:
                raise ValueError(
                    "proxy='output_error' needs an output_error_profile() "
                    "result or fn/fn_args to trace one")
            profile = output_error_profile(
                params, fn, *fn_args, grid=grid, base_policy=base_policy,
                profile=profile)
    elif profile is None:
        profile = profile_tree(params, grid, base_policy=base_policy)

    # cost axis: bytes when a byte budget is set; otherwise energy — which
    # also prices the MAC mix, so a config that compresses nothing (e.g.
    # mip2q p=0.25, Eq.-1 ratio 1.0) still ranks cheaper than plain INT8,
    # exactly the preference the paper's shifter-PE exists for.
    axis = "bytes" if budget.target_ratio is not None else "energy"
    limit = budget.max_energy if axis == "energy" else None

    names = sorted(profile)
    frontiers = {n: pareto_frontier(
        _candidates(profile[n], grid, budget, axis, proxy=proxy))
                 for n in names}

    if budget.target_ratio is not None:
        limit = budget.target_ratio * sum(profile[n]["size"] for n in names)

    # start: every tensor at its best-quality point (frontier right end)
    state = {n: len(frontiers[n]) - 1 for n in names}

    if limit is None:
        # pure min_sqnr_db floor: most-compressed point clearing the floor
        # (the floor already pruned candidates below it)
        state = {n: 0 for n in names}
    else:
        total = sum(frontiers[n][state[n]].cost for n in names)

        def slope(f, i):
            # added noise power per unit of cost saved by stepping i+1 -> i
            return (f[i].loss - f[i + 1].loss) / max(f[i + 1].cost - f[i].cost,
                                                     1e-9)

        # greedy Lagrangian descent: least noise added per unit cost first
        heap = []
        for n in names:
            if state[n] > 0:
                heapq.heappush(heap, (slope(frontiers[n], state[n] - 1),
                                      n, state[n] - 1))
        while total > limit and heap:
            _, n, i = heapq.heappop(heap)
            if state[n] != i + 1:
                continue  # stale entry
            f = frontiers[n]
            total -= f[state[n]].cost - f[i].cost
            state[n] = i
            if i > 0:
                heapq.heappush(heap, (slope(f, i - 1), n, i - 1))

    assignments = {n: frontiers[n][state[n]].cfg for n in names}

    tot_size = sum(profile[n]["size"] for n in names)
    tot_bytes = sum(frontiers[n][state[n]].bytes for n in names)
    tot_energy = sum(frontiers[n][state[n]].energy for n in names)
    tot_loss = sum(frontiers[n][state[n]].loss for n in names)
    wsqnr = sum(frontiers[n][state[n]].sqnr_db * profile[n]["size"]
                for n in names) / max(tot_size, 1)
    meta = {
        "budget": budget.to_dict(),
        "proxy": proxy,
        "grid": [config_key(c) for c in grid],
        "achieved_ratio": tot_bytes / max(tot_size, 1),
        "total_bytes": tot_bytes,
        "total_energy": tot_energy,
        "total_noise": tot_loss,
        "weighted_sqnr_db": wsqnr,
        "tensors": [{
            "name": n, "size": profile[n]["size"],
            "config": config_key(assignments[n]),
            "sqnr_db": frontiers[n][state[n]].sqnr_db,
            "bytes": frontiers[n][state[n]].bytes,
        } for n in names],
    }
    meta["feasible"] = (limit is None
                        or sum(frontiers[n][state[n]].cost for n in names)
                        <= limit * (1 + 1e-9))
    return StruMSchedule(assignments=assignments,
                         exclude=base_policy.exclude, meta=meta)
