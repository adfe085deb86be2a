"""Trace-file validator CLI (the CI ``obs-smoke`` gate).

    python -m repro_torch.telemetry.check trace.json \
        --require sched: --require cache:

Validates the file against the Chrome Trace Event Format (object flavor)
and asserts at least one complete-event span exists per ``--require`` name
prefix.  Exit 0 on success with a one-line summary; exit 1 with the first
violation otherwise.  Imports only the standard library.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from repro_torch.telemetry.trace import require_spans, validate_chrome_trace


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.check",
        description="validate a repro_torch.telemetry Chrome-trace JSON file")
    ap.add_argument("trace", help="path to the trace JSON")
    ap.add_argument("--require", action="append", default=[],
                    metavar="PREFIX",
                    help="require >= --min-count spans whose name starts "
                         "with PREFIX (repeatable)")
    ap.add_argument("--min-count", type=int, default=1)
    args = ap.parse_args(argv)
    try:
        data = validate_chrome_trace(args.trace)
        counts = require_spans(data, args.require, min_count=args.min_count)
    except (ValueError, OSError) as e:
        print(f"FAIL {args.trace}: {e}", file=sys.stderr)
        return 1
    n_ev = len(data["traceEvents"])
    summary = data.get("strumTelemetry", {})
    n_counters = len(summary.get("counters", {}))
    n_req = summary.get("latency_summary", {}).get("n_requests", 0)
    req = " ".join(f"{p}={c}" for p, c in counts.items())
    print(f"OK {args.trace}: {n_ev} events, {n_counters} counters, "
          f"{n_req} requests" + (f" [{req}]" if req else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
