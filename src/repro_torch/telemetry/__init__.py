"""``repro_torch.telemetry``: the port's measurement layer (a copy of the
jax-free part of ``repro.telemetry``: same counter names, same Chrome-trace
format, same ``python -m repro_torch.telemetry.check`` CLI).

* **counters / gauges / histograms**, recorded by the dispatch funnel
  (``dispatch/variant/*``, ``dispatch/packed_bytes``,
  ``spec/draft_packed_bytes``), the cache and attention partials
  (``cache/*``, ``attn/*``), the page allocator (``pages/*``) and the
  scheduler (``sched/*``, ``spec/*``);
* **spans** (``sched:*``, ``spec:*``, ``attn:*``), exported as Chrome Trace
  Event Format complete events;
* **request lifecycle log**: submitted -> admitted -> prefill ->
  first_token -> decode -> retired per request, reduced to TTFT, per-token
  p50/p99 and goodput by :mod:`repro_torch.telemetry.requests`;
* **collective byte accounting** — :func:`all_gather_stats`
  (:mod:`repro_torch.telemetry.jaxpr_stats`), read off one recorded call
  by ``analysis.dataflow`` (imported lazily, so the trace checker runs
  without the engine).

One difference from the reference: the reference's dispatch counters fire
at ``jax.jit`` trace time (once per leaf per compiled step, the layer scan
traced once), while the port runs eagerly and counts once per call, so a
run's counters grow with its steps.  One dispatch per plan entry counts the
plan's ``variant_distribution``; one eager forward counts it once per layer
group.

Nothing is recorded until a recorder is active: ``STRUM_TRACE=<path>``
(read at import) or ``--trace`` on the serve entry point installs a
process-wide recorder flushed at exit, and ``recording()`` scopes one to a
``with`` block.  With none active every hook is an early return and
``span()`` returns a shared null object.
"""
from repro_torch.telemetry.recorder import (MAX_EVENTS, Recorder, configure,
                                            current, enabled, event, gauge, inc,
                                            observe, recording, request_event,
                                            shutdown, span)
from repro_torch.telemetry.requests import (LIFECYCLE_STAGES,
                                            check_well_ordered,
                                            latency_summary, percentile,
                                            request_metrics)
from repro_torch.telemetry.trace import (chrome_trace, require_spans,
                                         validate_chrome_trace)

from repro_torch.telemetry.recorder import _init_from_env

__all__ = [
    "Recorder", "configure", "current", "enabled", "recording", "shutdown",
    "inc", "gauge", "observe", "event", "request_event", "span",
    "MAX_EVENTS",
    "LIFECYCLE_STAGES", "check_well_ordered", "latency_summary",
    "percentile", "request_metrics",
    "chrome_trace", "validate_chrome_trace", "require_spans",
    "all_gather_stats",
]


def __getattr__(name: str):
    # lazy: all_gather_stats pulls in the engine, which the trace checker
    # CLI must not need
    if name == "all_gather_stats":
        from repro_torch.telemetry.jaxpr_stats import all_gather_stats
        return all_gather_stats
    raise AttributeError(f"module 'repro_torch.telemetry' has no attribute {name!r}")

_init_from_env()
