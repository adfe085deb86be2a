"""Plan validation: walks a freshly built port
:class:`~repro_torch.engine.plan.ExecutionPlan`, entry by entry — the
``build_plan(..., validate=True)`` hook (twin of
``repro.analysis.plan_check``).

``plan/selection-drift``  re-running selection under the entry's recorded
                          backend picks a different variant;
``plan/payload-shape``    packed field geometry or dtypes disagree with
                          ``packing.field_dims`` for the entry's config;
``plan/k-dim``            the recorded reduction dim does not fit the
                          payload's block count;
``numerics/budget-exceeded``  (with ``params``) a packed entry's
                          unit-input output-error bound exceeds the
                          schedule's declared ``error_budget``.

A mesh-aware plan's leaves hold one rank's block of the payload
(``ExecSpec.shard``, a ``ShardSpec``): the checks read each field's global
shape, its block's times the mesh axes that cut each dim.  Findings come
out as the reference's on the same plan, dtypes named as numpy names them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.analysis.report import Report
from repro_torch.core import packing
from repro_torch.engine.registry import LeafInfo, select_variant

__all__ = ["validate_plan"]

_FIELD_DTYPES = {"mask": torch.uint8, "hi": torch.int8, "lo": torch.uint8}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _global_shapes(leaf: dict, shard, exec_lead: bool) -> dict:
    """Each field's global shape: the block's, times the mesh axes that cut
    each dim (``engine.sharded.payload_specs``, as ``build_plan`` cut it)."""
    shapes = {k: tuple(leaf[k].shape) for k in ("mask", "hi", "lo", "scale")}
    if shard is None or not shard.mesh_shape:
        return shapes
    from repro_torch.engine.sharded import payload_specs
    from repro_torch.models.sharding import _as_axes
    sizes = dict(shard.mesh_shape)
    tp = None if exec_lead else ("model" if "model" in sizes else None)
    scan = len(shapes["mask"]) - 3 - int(exec_lead)
    specs = payload_specs(shard.tp_pattern, shard.fsdp_axes, tp, shard.lead_axis, scan)
    return {k: tuple(d * math.prod(sizes.get(a, 1) for a in _as_axes(e))
                     for d, e in zip(shape, tuple(specs[k]) + (None,) * len(shape)))
            for k, shape in shapes.items()}


def _device(plan, device):
    if device is not None:
        return device
    for e in plan.entries.values():
        if e.leaf is not None:
            return e.leaf["mask"].device
    return "cpu"


def validate_plan(plan, params=None, device=None) -> Report:
    """Check every entry of ``plan``; ``params`` (the float tree the plan
    was built from) arms the error-budget check, ``device`` the ``auto``
    backend's selection (default: the payload's device)."""
    from repro_torch.engine.plan import _is_expert_stack

    report = Report()
    report.extend(_check_error_budget(plan, params))
    dev = _device(plan, device)
    for name, e in plan.entries.items():
        # exec-lead convention from build_plan: scan-group lead dims are
        # sliced away before dispatch; only MoE expert stacks keep theirs
        lead = (tuple(e.shape[:-2])
                if e.layout == "serve" and _is_expert_stack(name) else ())
        shard = e.shard
        info = LeafInfo(
            k_dim=e.shape[-2], n_out=e.shape[-1], lead=lead, name=name,
            fsdp=tuple(shard.fsdp_axes) if shard is not None else (),
            tp_pattern=shard.tp_pattern if shard is not None else None)
        try:
            reselected = select_variant(e.cfg, info, backend=e.backend,
                                        device=dev).name
        except LookupError:
            reselected = None
        if reselected != e.variant:
            report.add("error", "plan/selection-drift", name,
                       f"plan recorded {e.variant!r}, selection now yields "
                       f"{reselected!r} under backend={e.backend!r}")

        if e.leaf is None:
            continue
        cfg = e.cfg
        k_dim = e.shape[-2]
        shapes = _global_shapes(e.leaf, shard, bool(lead))
        nb = shapes["mask"][-3]
        if not (nb * cfg.w >= k_dim > (nb - 1) * cfg.w):
            report.add("error", "plan/k-dim", name,
                       f"recorded K={k_dim} does not fit {nb} blocks of "
                       f"w={cfg.w}")
        mb, nh, lb = packing.field_dims(cfg.w, cfg.n_low, cfg.q, cfg.method)
        rows = {"mask": mb, "hi": nh, "lo": lb}
        n_out = shapes["scale"][-1]
        for field, want_rows in rows.items():
            shape, dtype = shapes[field], e.leaf[field].dtype
            if shape[-3] != nb or shape[-2] != want_rows or shape[-1] != n_out:
                report.add(
                    "error", "plan/payload-shape", f"{name}/{field}",
                    f"shape {shape}; field_dims want "
                    f"(..., {nb}, {want_rows}, {n_out})")
            if dtype != _FIELD_DTYPES[field]:
                report.add(
                    "error", "plan/payload-shape", f"{name}/{field}",
                    f"dtype {_dtype_name(dtype)}; packed payload fields must "
                    f"be {_dtype_name(_FIELD_DTYPES[field])}")
        if not e.leaf["scale"].dtype.is_floating_point:
            report.add("error", "plan/payload-shape", f"{name}/scale",
                       f"dtype {_dtype_name(e.leaf['scale'].dtype)}; scales "
                       f"are float")
    return report


def _check_error_budget(plan, params) -> Report:
    """Fidelity check for plans whose schedule declares ``error_budget``
    (``autotune.Budget(error_budget=...)``): every packed entry's
    unit-input output-error bound (``numerics.per_tensor_bound``, the
    worst-case error of ``x @ W_hat`` vs ``x @ W`` over ``|x|_inf <= 1``)
    must clear the budget.  Needs the original float ``params``; without
    them (or without a declared budget) this is a no-op."""
    report = Report()
    if params is None:
        return report
    meta = getattr(plan.schedule, "meta", None) or {}
    budget = (meta.get("budget") or {}).get("error_budget")
    if budget is None:
        return report
    from repro_torch.analysis.numerics import per_tensor_bound
    from repro_torch.core.apply import _named_leaves

    named = dict(_named_leaves(params))
    for name, e in plan.entries.items():
        if e.leaf is None or name not in named or (
                e.shard is not None and e.shard.parts > 1):
            continue      # a block of a mesh-aware plan: its global leaf is not here
        bound = per_tensor_bound(e, named[name])
        if bound > float(budget):
            report.add("error", "numerics/budget-exceeded", name,
                       f"unit-input output-error bound {bound:.6g} exceeds "
                       f"the schedule's declared error budget "
                       f"{float(budget):.6g}")
    return report
