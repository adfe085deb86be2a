"""Per-request lifecycle accounting: TTFT, per-token latency, goodput.

The scheduler emits one event stream per request uid —

    submitted -> admitted -> prefill -> first_token [-> decode] -> retired

(``decode`` is skipped when the prefill-produced first token already
exhausts the budget or hits EOS; ``token`` events mark each subsequent
decoded token).  This module turns those streams into the serving metrics
the ROADMAP asks for: time-to-first-token, per-token decode latency, and
goodput — output tokens of *retired* requests per second of wall time, the
number that penalizes work spent on requests that never finish.

Everything here is stdlib math on the raw log, so the same functions serve
the live :class:`~repro_torch.telemetry.recorder.Recorder`, the exported trace
file, and the tests' synthetic streams.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

__all__ = ["LIFECYCLE_STAGES", "check_well_ordered", "request_metrics",
           "latency_summary", "percentile"]

#: one lifecycle event: (stage, timestamp_us, attributes)
Event = Tuple[str, float, dict]

# Canonical stage order; a request's events must be a subsequence of this
# (with "token" events interleaved after first_token).
LIFECYCLE_STAGES = ("submitted", "admitted", "prefill", "first_token",
                    "decode", "retired")
_STAGE_RANK = {s: i for i, s in enumerate(LIFECYCLE_STAGES)}


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """Linear-interpolated percentile (numpy's default), stdlib-only.
    ``q`` in [0, 100].  None on empty input."""
    vals = sorted(values)
    if not vals:
        return None
    if len(vals) == 1:
        return float(vals[0])
    pos = (q / 100.0) * (len(vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return float(vals[lo] * (1 - frac) + vals[hi] * frac)


def check_well_ordered(events: Iterable[Event]) -> None:
    """Validate one request's event stream: timestamps non-decreasing and
    lifecycle stages in canonical order (stages may be skipped, never
    repeated or reordered; ``token`` events only after ``first_token``).
    Raises ``ValueError`` on the first violation."""
    last_ts = float("-inf")
    last_rank = -1
    seen_first = False
    for stage, ts, _attrs in events:
        if ts < last_ts:
            raise ValueError(f"timestamp regressed at {stage!r}: "
                             f"{ts} < {last_ts}")
        last_ts = ts
        if stage == "token":
            if not seen_first:
                raise ValueError("'token' event before 'first_token'")
            continue
        rank = _STAGE_RANK.get(stage)
        if rank is None:
            raise ValueError(f"unknown lifecycle stage {stage!r}")
        if rank <= last_rank:
            raise ValueError(
                f"stage {stage!r} out of order (after "
                f"{LIFECYCLE_STAGES[last_rank]!r})")
        last_rank = rank
        if stage == "first_token":
            seen_first = True


def request_metrics(log: dict) -> dict:
    """{uid: per-request metrics} from a {uid: [(stage, ts_us, attrs)]} log.

    Per request: ``ttft_us`` (submitted -> first_token), ``queue_us``
    (submitted -> admitted), token timestamps, per-token decode intervals,
    ``n_tokens``, ``e2e_us`` (submitted -> retired), ``retired`` flag.
    """
    out: dict = {}
    for uid, events in log.items():
        stamps: dict = {}
        token_ts: list = []
        for stage, ts, _attrs in events:
            if stage == "token":
                token_ts.append(ts)
            elif stage not in stamps:        # first occurrence wins
                stamps[stage] = ts
        if "first_token" in stamps:
            token_ts = [stamps["first_token"]] + token_ts
        sub = stamps.get("submitted")
        m = {
            "ttft_us": (stamps["first_token"] - sub
                        if sub is not None and "first_token" in stamps
                        else None),
            "queue_us": (stamps["admitted"] - sub
                         if sub is not None and "admitted" in stamps
                         else None),
            "e2e_us": (stamps["retired"] - sub
                       if sub is not None and "retired" in stamps
                       else None),
            "n_tokens": len(token_ts),
            "token_intervals_us": [b - a for a, b in zip(token_ts,
                                                         token_ts[1:])],
            "retired": "retired" in stamps,
            "retired_ts": stamps.get("retired"),
            "submitted_ts": sub,
        }
        out[uid] = m
    return out


def latency_summary(log: dict) -> dict:
    """Fleet-level summary of a lifecycle log: TTFT / per-token p50 & p99
    (µs) and goodput (retired tokens per second).

    Goodput's wall window spans first submission to last retirement —
    the full time the system was responsible for the work, so requests
    that were admitted but never retired dilute it.
    """
    metrics = request_metrics(log)
    ttfts = [m["ttft_us"] for m in metrics.values()
             if m["ttft_us"] is not None]
    intervals = [iv for m in metrics.values()
                 for iv in m["token_intervals_us"]]
    retired = [m for m in metrics.values() if m["retired"]]
    good_tokens = sum(m["n_tokens"] for m in retired)
    submits = [m["submitted_ts"] for m in metrics.values()
               if m["submitted_ts"] is not None]
    ends = [m["retired_ts"] for m in retired]
    wall_us = (max(ends) - min(submits)) if (submits and ends) else 0.0
    return {
        "n_requests": len(metrics),
        "n_retired": len(retired),
        "ttft_p50_us": percentile(ttfts, 50),
        "ttft_p99_us": percentile(ttfts, 99),
        "tok_p50_us": percentile(intervals, 50),
        "tok_p99_us": percentile(intervals, 99),
        "goodput_tok_s": (good_tokens / (wall_us / 1e6)
                          if wall_us > 0 else None),
        "good_tokens": good_tokens,
        "wall_us": wall_us,
    }
