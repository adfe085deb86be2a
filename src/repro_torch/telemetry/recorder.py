"""Core recorder: counters, gauges, histograms, spans, request events (a
copy of ``repro.telemetry.recorder``, which imports no JAX either).

One :class:`Recorder` instance is one measurement scope.  Recorders stack:
``recording()`` pushes a fresh recorder for the duration of a ``with``
block, ``configure()`` installs a long-lived one (the ``STRUM_TRACE=``
path), and every instrumentation call **broadcasts to every recorder on
the stack** — a benchmark can open a per-run scope without stealing events
from the process-wide trace file.

The zero-overhead contract: with an empty stack, every module-level hook
(:func:`inc`, :func:`gauge`, :func:`span`, ...) is a dict-free early
return, and :func:`span` hands back a shared no-op singleton — no
allocation, no clock read, no lock.  Instrumented code therefore never
needs its own ``if telemetry.enabled()`` guard (though hot paths that
*compute* arguments may still want one).

Thread safety: each recorder serializes its mutations behind one lock.
Timestamps are ``time.perf_counter()`` microseconds relative to the
recorder's creation — the native unit of the Chrome Trace Event Format
(:mod:`repro_torch.telemetry.trace` renders the export).
"""
from __future__ import annotations

import atexit
import contextlib
import os
import threading
import time
from typing import Optional

__all__ = ["Recorder", "enabled", "current", "configure", "shutdown",
           "recording", "inc", "gauge", "observe", "event", "request_event",
           "span", "MAX_EVENTS"]

# Backstop against unbounded growth in long-lived recorders (a serve loop
# left tracing overnight): past this many stored events per category, new
# ones are dropped and counted under ``telemetry/dropped``.
MAX_EVENTS = 500_000

_STACK: list["Recorder"] = []
_STACK_LOCK = threading.Lock()


class Recorder:
    """One measurement scope: counters + gauges + histograms + spans +
    per-request lifecycle log, with an optional Chrome-trace export path."""

    def __init__(self, trace_path: Optional[str] = None):
        self.trace_path = trace_path
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.created_unix = time.time()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}          # latest value
        self._gauge_track: list[tuple] = []          # (name, ts_us, value)
        self._hists: dict[str, list] = {}
        self._spans: list[dict] = []                 # Chrome "X" events
        self._instants: list[dict] = []              # Chrome "i" events
        self._requests: dict = {}                    # uid -> [(stage, ts, attrs)]
        self._dropped = 0

    # ------------------------------------------------------------- clock --
    def now_us(self) -> float:
        """Microseconds since this recorder was created."""
        return (time.perf_counter() - self._t0) * 1e6

    def _abs_us(self, t: float) -> float:
        """perf_counter() seconds -> this recorder's trace microseconds."""
        return (t - self._t0) * 1e6

    # ---------------------------------------------------------- mutators --
    def inc(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def gauge(self, name: str, value: float) -> None:
        ts = self.now_us()
        with self._lock:
            self._gauges[name] = value
            if len(self._gauge_track) < MAX_EVENTS:
                self._gauge_track.append((name, ts, value))
            else:
                self._dropped += 1

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._hists.setdefault(name, [])
            if len(h) < MAX_EVENTS:
                h.append(value)
            else:
                self._dropped += 1

    def event(self, name: str, cat: str = "event", **args) -> None:
        ts = self.now_us()
        with self._lock:
            if len(self._instants) < MAX_EVENTS:
                self._instants.append({"name": name, "cat": cat, "ts": ts,
                                       "tid": threading.get_ident(),
                                       "args": args})
            else:
                self._dropped += 1

    def request_event(self, uid, stage: str, **attrs) -> None:
        ts = self.now_us()
        with self._lock:
            if len(self._requests.get(uid, ())) < MAX_EVENTS:
                self._requests.setdefault(uid, []).append((stage, ts, attrs))
            else:
                self._dropped += 1

    def add_span(self, name: str, t_start: float, t_end: float,
                 cat: str = "span", tid: Optional[int] = None,
                 args: Optional[dict] = None) -> None:
        """Record a completed span from absolute ``perf_counter()`` times."""
        with self._lock:
            if len(self._spans) < MAX_EVENTS:
                self._spans.append({
                    "name": name, "cat": cat,
                    "ts": self._abs_us(t_start),
                    "dur": max(0.0, (t_end - t_start) * 1e6),
                    "tid": tid if tid is not None else threading.get_ident(),
                    "args": args or {}})
            else:
                self._dropped += 1

    def span(self, name: str, cat: str = "span", **args):
        return _Span((self,), name, cat, args)

    # ----------------------------------------------------------- readers --
    def counters(self, prefix: Optional[str] = None) -> dict:
        with self._lock:
            if prefix is None:
                return dict(self._counters)
            return {k[len(prefix):]: v for k, v in self._counters.items()
                    if k.startswith(prefix)}

    def counter(self, name: str, default: float = 0) -> float:
        with self._lock:
            return self._counters.get(name, default)

    def gauges(self) -> dict:
        with self._lock:
            return dict(self._gauges)

    def gauge_series(self, name: str) -> list:
        """[(ts_us, value), ...] for one gauge — occupancy over time."""
        with self._lock:
            return [(ts, v) for n, ts, v in self._gauge_track if n == name]

    def histogram(self, name: str) -> list:
        with self._lock:
            return list(self._hists.get(name, ()))

    def spans(self, prefix: Optional[str] = None) -> list:
        with self._lock:
            sp = list(self._spans)
        if prefix is not None:
            sp = [s for s in sp if s["name"].startswith(prefix)]
        return sp

    def request_log(self, uid=None):
        with self._lock:
            if uid is not None:
                return list(self._requests.get(uid, ()))
            return {u: list(ev) for u, ev in self._requests.items()}

    def latency_summary(self) -> dict:
        from repro_torch.telemetry.requests import latency_summary
        return latency_summary(self.request_log())

    def request_metrics(self) -> dict:
        from repro_torch.telemetry.requests import request_metrics
        return request_metrics(self.request_log())

    @property
    def empty(self) -> bool:
        with self._lock:
            return not (self._counters or self._gauges or self._gauge_track
                        or self._hists or self._spans or self._instants
                        or self._requests)

    # ------------------------------------------------------------ export --
    def chrome_trace(self) -> dict:
        from repro_torch.telemetry.trace import chrome_trace
        return chrome_trace(self)

    def flush(self, path: Optional[str] = None) -> Optional[str]:
        """Write the Chrome-trace JSON to ``path`` (default: the recorder's
        ``trace_path``).  Returns the written path, or None if there is
        nowhere to write."""
        import json
        path = path or self.trace_path
        if not path:
            return None
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


class _Span:
    """Context manager timing one wall-clock span into >=1 recorders."""

    __slots__ = ("_recs", "_name", "_cat", "_args", "_t0")

    def __init__(self, recs, name, cat, args):
        self._recs, self._name, self._cat, self._args = recs, name, cat, args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        tid = threading.get_ident()
        for r in self._recs:
            r.add_span(self._name, self._t0, t1, cat=self._cat, tid=tid,
                       args=self._args)
        return False


class _NullSpan:
    """The disabled-path span: a shared, stateless no-op singleton."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


# ------------------------------------------------------- module-level API --

def enabled() -> bool:
    """Is any recorder active?  (The cheap guard for hot paths that would
    otherwise *compute* values just to discard them.)"""
    return bool(_STACK)


def current() -> Optional[Recorder]:
    """The innermost active recorder, or None."""
    return _STACK[-1] if _STACK else None


def inc(name: str, value: float = 1) -> None:
    if not _STACK:
        return
    for r in tuple(_STACK):
        r.inc(name, value)


def gauge(name: str, value: float) -> None:
    if not _STACK:
        return
    for r in tuple(_STACK):
        r.gauge(name, value)


def observe(name: str, value: float) -> None:
    if not _STACK:
        return
    for r in tuple(_STACK):
        r.observe(name, value)


def event(name: str, cat: str = "event", **args) -> None:
    if not _STACK:
        return
    for r in tuple(_STACK):
        r.event(name, cat=cat, **args)


def request_event(uid, stage: str, **attrs) -> None:
    if not _STACK:
        return
    for r in tuple(_STACK):
        r.request_event(uid, stage, **attrs)


def span(name: str, cat: str = "span", **args):
    if not _STACK:
        return NULL_SPAN
    return _Span(tuple(_STACK), name, cat, args)


def configure(trace_path: Optional[str] = None) -> Recorder:
    """Install a long-lived recorder (bottom of the stack).

    With ``trace_path``, the trace is flushed there at interpreter exit
    (and on :func:`shutdown`).  This is what ``STRUM_TRACE=<path>`` and the
    ``--trace`` CLI flags call.
    """
    rec = Recorder(trace_path=trace_path)
    with _STACK_LOCK:
        _STACK.insert(0, rec)
    if trace_path:
        atexit.register(_atexit_flush, rec)
    return rec


def _atexit_flush(rec: Recorder) -> None:
    if rec in _STACK:
        rec.flush()


def shutdown(rec: Optional[Recorder] = None) -> Optional[str]:
    """Remove ``rec`` (default: the most recent recorder) from the stack,
    flushing it if it has a trace path.  Returns the flushed path."""
    with _STACK_LOCK:
        if rec is None:
            if not _STACK:
                return None
            rec = _STACK[-1]
        if rec in _STACK:
            _STACK.remove(rec)
    return rec.flush()


@contextlib.contextmanager
def recording(trace_path: Optional[str] = None):
    """Scoped recorder: ``with telemetry.recording() as rec: ...``.

    Pushes a fresh :class:`Recorder` for the block (stacking on top of any
    ``configure()``-installed one — both receive the block's events) and
    pops it on exit, flushing if ``trace_path`` was given.
    """
    rec = Recorder(trace_path=trace_path)
    with _STACK_LOCK:
        _STACK.append(rec)
    try:
        yield rec
    finally:
        with _STACK_LOCK:
            if rec in _STACK:
                _STACK.remove(rec)
        rec.flush()


def _init_from_env() -> Optional[Recorder]:
    """``STRUM_TRACE=<path>`` installs a process-wide recorder at import."""
    path = os.environ.get("STRUM_TRACE")
    if path:
        return configure(trace_path=path)
    return None
