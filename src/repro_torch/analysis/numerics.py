"""Quantization-error numerics of a plan's leaves (the leaf-statistics half
of ``repro.analysis.numerics``).

Walks the port's :class:`~repro_torch.engine.plan.ExecutionPlan` entries
against their float leaves: per-leaf statistics (:class:`LeafStats`), the
unit-input output-error bound of one entry (:func:`per_tensor_bound`,
which ``plan_check``'s ``numerics/budget-exceeded`` reads), the measured
teacher-forced error of a function (:func:`measured_error`) and the budget
check of a :class:`NumericsResult` (:func:`check_error_budget`).  All of it
is plain array math in float64.

The reference's abstract interpreter over jaxprs (``analyze``,
``output_gains``) has no twin here yet; its port walks the ATen graphs that
:func:`repro_torch.analysis.dataflow.trace_dataflow` records.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.analysis.report import Report

__all__ = ["LeafStats", "NumericsResult", "leaf_stats_from_plan",
           "measured_error", "check_error_budget", "per_tensor_bound",
           "PAYLOAD_KEYS", "SCALE_KEY"]

PAYLOAD_KEYS = ("mask", "hi", "lo")
SCALE_KEY = "scale"


def _f64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float64).numpy()
    return np.asarray(t, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class LeafStats:
    """Precomputed numerics of one quantized leaf: joint hull of ``W`` and
    ``W_hat``, max-abs / mean-square quantization error, signal power."""

    lo: float
    hi: float
    err: float
    err2: float
    ms: float


def leaf_stats_from_plan(plan, ref_params) -> dict:
    """Per-entry :class:`LeafStats` for an ``ExecutionPlan``, against the
    original float leaves in ``ref_params``.  The hull includes 0 so a
    padded-K decode (zero-filled tail) stays inside it."""
    from repro_torch.core.apply import _named_leaves
    named = dict(_named_leaves(ref_params))
    out = {}
    for name, entry in plan.entries.items():
        w = _f64(named[name])
        wq = _f64(entry.dequantized())
        d = wq - w
        out[name] = LeafStats(
            lo=float(min(w.min(), wq.min(), 0.0)),
            hi=float(max(w.max(), wq.max(), 0.0)),
            err=float(np.max(np.abs(d))),
            err2=float(np.mean(d * d)),
            ms=float(np.mean(w * w)))
    return out


def per_tensor_bound(entry, ref_leaf) -> float:
    """Unit-input local output-error bound for one plan entry:
    ``max_n sum_k |W_hat - W|[k, n]`` — the worst-case error of
    ``x @ W_hat`` vs ``x @ W`` over ``|x|_inf <= 1``."""
    d = np.abs(_f64(entry.dequantized()) - _f64(ref_leaf))
    k_axis = max(0, d.ndim - 2)      # leaf layout is (..., K, N)
    return float(d.sum(axis=k_axis).max())


@dataclasses.dataclass
class NumericsResult:
    """Output-error bounds of one program (the interpreter that derives
    them statically is the reference's; ``check_error_budget`` reads them)."""

    per_tag: dict        # payload leaf -> sound output-error bound
    total: float         # sound end-to-end bound (all leaves quantized)
    per_tag_err2: dict   # payload leaf -> estimated output-error power
    total_err2: float
    interval: tuple      # joint output interval (lo, hi)
    unsupported: tuple   # primitives the interpreter gave up on

    def to_json(self) -> dict:
        return {"per_tag": {t: float(v) for t, v in self.per_tag.items()},
                "total": float(self.total),
                "per_tag_err2": {t: float(v)
                                 for t, v in self.per_tag_err2.items()},
                "total_err2": float(self.total_err2),
                "interval": [float(self.interval[0]),
                             float(self.interval[1])],
                "unsupported": list(self.unsupported)}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def measured_error(fn, args_a, args_b) -> float:
    """Teacher-forced measured output error: ``max |fn(*args_a) -
    fn(*args_b)|`` over all output tensors."""
    worst = 0.0
    for a, b in zip(_tensors(fn(*args_a)), _tensors(fn(*args_b))):
        d = _f64(a) - _f64(b)
        if d.size:
            worst = max(worst, float(np.max(np.abs(d))))
    return worst


def check_error_budget(result: NumericsResult, budget: dict,
                       location: str = "<schedule>") -> Report:
    """Compare a :class:`NumericsResult` against a declared error budget
    (``{"total": x, "per_layer": y-or-{name: y}}``); every violation is a
    ``numerics/budget-exceeded`` error finding."""
    report = Report()
    total_cap = budget.get("total")
    if total_cap is not None and result.total > float(total_cap):
        report.add("error", "numerics/budget-exceeded", location,
                   f"static end-to-end output-error bound {result.total:.6g}"
                   f" exceeds the declared total budget {total_cap:.6g}")
    per = budget.get("per_layer")
    if per is not None:
        caps = per if isinstance(per, dict) else {
            t: float(per) for t in result.per_tag}
        for t, cap in sorted(caps.items()):
            bound = result.per_tag.get(t)
            if bound is not None and bound > float(cap):
                report.add("error", "numerics/budget-exceeded",
                           f"{location}: {t}",
                           f"static per-layer bound {bound:.6g} exceeds "
                           f"the declared per-layer budget {float(cap):.6g}")
    return report
