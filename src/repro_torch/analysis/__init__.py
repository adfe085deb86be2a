"""repro_torch.analysis — static analysis of the port's registry, kernel
launchers, plans and serving lanes (twin of ``repro.analysis``).

Six passes, the reference's rule ids on their findings:

* **packed dataflow** (:func:`verify`, :func:`trace_dataflow`) — one
  recorded run of a function: every ATen op, every kernel call and every
  collective, with payload taints spread by tensor storage; proves
  collectives move packed bytes (the Eq.-1 ratio), payloads decode once,
  and sealed pools leave HBM as mask + hi + lo bytes only;
* **registry audit** (:func:`audit_registry`) — sweeps the capability grid
  through the real ``select_variant`` and flags unreachable, shadowed or
  overlapping variants;
* **launch-contract lint** (:func:`lint_pallas`) — every ``cuda:*`` /
  ``cache:*`` / ``draft:*`` predicate against its launcher's
  ``launch_contract``, and on the card every accepted point launched and
  held to its kernel's plain version;
* **recompile lint** (:func:`lint_scheduler_recompiles`) — every call of a
  serving lane has one shape signature;
* **numerics** (:func:`analyze`, :func:`output_gains`) — an abstract
  interpreter over one eager run: a static per-leaf and end-to-end bound
  on the output error a plan's quantization causes, and the noise gains
  the ``output_error`` autotune proxy reads;
* **plan validation** (:func:`validate_plan`, ``build_plan(validate=True)``).

``python -m repro_torch.analysis`` runs them over the model zoo.  Importing
the package loads only the findings and rules; the passes load lazily.
"""
from repro_torch.analysis.report import RULES, SEVERITIES, Finding, Report

__all__ = [
    "Finding", "Report", "RULES", "SEVERITIES",
    "verify", "trace_dataflow", "collective_stats",
    "audit_registry", "render_coverage",
    "lint_pallas", "lint_scheduler_recompiles",
    "validate_plan", "analyze", "output_gains", "run_all",
]

_LAZY = {
    "verify": "repro_torch.analysis.dataflow",
    "trace_dataflow": "repro_torch.analysis.dataflow",
    "collective_stats": "repro_torch.analysis.dataflow",
    "audit_registry": "repro_torch.analysis.registry_audit",
    "render_coverage": "repro_torch.analysis.registry_audit",
    "lint_pallas": "repro_torch.analysis.pallas_lint",
    "lint_scheduler_recompiles": "repro_torch.analysis.recompile",
    "validate_plan": "repro_torch.analysis.plan_check",
    "analyze": "repro_torch.analysis.numerics",
    "output_gains": "repro_torch.analysis.numerics",
    "run_all": "repro_torch.analysis.suite",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.analysis' has no attribute "
                             f"{name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
