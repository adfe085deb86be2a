"""Chrome Trace Event Format export + validation.

The emitted file is the *object* flavor of the format —
``{"traceEvents": [...], ...}`` — which both ``chrome://tracing`` and
Perfetto's legacy-JSON importer accept, and which tolerates extra
top-level keys.  We use that tolerance to carry the non-timeline payload
(final counter values, latest gauges, the per-request latency summary and
raw lifecycle log) under ``"strumTelemetry"``, so one trace file is the
single artifact the acceptance criteria read everything from.

Event mapping:

* spans        -> ``"ph": "X"`` complete events (``ts``/``dur`` in µs)
* gauges       -> ``"ph": "C"`` counter events (rendered as a track whose
                  height follows the value — page-pool occupancy over time)
* instants     -> ``"ph": "i"`` instant events (alloc/free/defrag,
                  request lifecycle marks)
* counters     -> one final ``"ph": "C"`` sample each at the end of the
                  trace (cumulative totals; the authoritative values live
                  in ``strumTelemetry.counters``)
"""
from __future__ import annotations

import json
from typing import Sequence, Union

__all__ = ["chrome_trace", "validate_chrome_trace", "require_spans"]

PID = 0  # single-process runtime; one Chrome "process" track


def chrome_trace(rec) -> dict:
    """Render a :class:`repro_torch.telemetry.recorder.Recorder` to a
    Chrome-trace JSON object (pure data; callers dump it)."""
    from repro_torch.telemetry.requests import latency_summary, request_metrics
    with rec._lock:
        spans = list(rec._spans)
        instants = list(rec._instants)
        gauge_track = list(rec._gauge_track)
        counters = dict(rec._counters)
        gauges = dict(rec._gauges)
        hists = {k: list(v) for k, v in rec._hists.items()}
        requests = {u: list(ev) for u, ev in rec._requests.items()}
        dropped = rec._dropped
    events: list[dict] = [
        {"ph": "M", "pid": PID, "name": "process_name",
         "args": {"name": "repro_torch.telemetry"}},
    ]
    end_ts = 0.0
    for s in spans:
        events.append({"ph": "X", "pid": PID, "tid": s["tid"],
                       "name": s["name"], "cat": s["cat"],
                       "ts": s["ts"], "dur": s["dur"], "args": s["args"]})
        end_ts = max(end_ts, s["ts"] + s["dur"])
    for e in instants:
        events.append({"ph": "i", "s": "t", "pid": PID, "tid": e["tid"],
                       "name": e["name"], "cat": e["cat"],
                       "ts": e["ts"], "args": e["args"]})
        end_ts = max(end_ts, e["ts"])
    for name, ts, value in gauge_track:
        events.append({"ph": "C", "pid": PID, "tid": 0, "name": name,
                       "cat": "gauge", "ts": ts,
                       "args": {"value": value}})
        end_ts = max(end_ts, ts)
    for uid, evs in requests.items():
        for stage, ts, attrs in evs:
            events.append({"ph": "i", "s": "t", "pid": PID, "tid": 0,
                           "name": f"req:{stage}", "cat": "request",
                           "ts": ts, "args": dict(attrs, uid=uid)})
            end_ts = max(end_ts, ts)
    for name, value in sorted(counters.items()):
        events.append({"ph": "C", "pid": PID, "tid": 0, "name": name,
                       "cat": "counter", "ts": end_ts,
                       "args": {"value": value}})
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "strumTelemetry": {
            "created_unix": rec.created_unix,
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
            "latency_summary": latency_summary(requests),
            "request_metrics": request_metrics(requests),
            "request_log": {str(u): [[st, ts, at] for st, ts, at in ev]
                            for u, ev in requests.items()},
            "dropped_events": dropped,
        },
    }


def validate_chrome_trace(source: Union[str, dict]) -> dict:
    """Parse + structurally validate a Chrome-trace JSON file (or an
    already-parsed object).  Raises ``ValueError`` with a specific message
    on the first violation; returns the parsed object on success."""
    if isinstance(source, dict):
        data = source
    else:
        with open(source) as f:
            data = json.load(f)
    if not isinstance(data, dict) or "traceEvents" not in data:
        raise ValueError("not a Chrome-trace object: missing 'traceEvents'")
    events = data["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        ph = ev.get("ph")
        if not isinstance(ph, str) or not ph:
            raise ValueError(f"traceEvents[{i}] missing phase 'ph'")
        if "name" not in ev:
            raise ValueError(f"traceEvents[{i}] (ph={ph!r}) missing 'name'")
        if ph in ("X", "i", "C", "B", "E") and not isinstance(
                ev.get("ts"), (int, float)):
            raise ValueError(f"traceEvents[{i}] (ph={ph!r}) missing "
                             f"numeric 'ts'")
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            raise ValueError(f"traceEvents[{i}] complete event missing "
                             f"numeric 'dur'")
    return data


def require_spans(trace: dict, prefixes: Sequence[str],
                  min_count: int = 1) -> dict:
    """Assert the trace contains >= ``min_count`` ``"X"`` spans per name
    prefix.  Returns {prefix: count}; raises ``ValueError`` listing every
    unmet prefix (the CI obs-smoke contract)."""
    counts = {p: 0 for p in prefixes}
    for ev in trace.get("traceEvents", ()):
        if ev.get("ph") != "X":
            continue
        for p in prefixes:
            if str(ev.get("name", "")).startswith(p):
                counts[p] += 1
    missing = [p for p, c in counts.items() if c < min_count]
    if missing:
        raise ValueError(
            f"trace is missing required spans: "
            + ", ".join(f"{p!r} ({counts[p]}/{min_count})" for p in missing))
    return counts
