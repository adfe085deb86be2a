"""Recompile lint: drives a port ``BatchScheduler`` over a mixed-length
workload and counts each serving lane's shape signatures (twin of
``repro.analysis.recompile``).

The reference proves every lane is ONE compiled executable across prompt
lengths.  The port compiles nothing; its form of that invariant is that
every call of a lane has **one shape signature**: the ordered ops, kernel
calls and collectives :func:`~repro_torch.analysis.dataflow.trace_dataflow`
records for the call, each with its input shapes and dtypes.  CUDA-graph
capture of a lane (one graph replayed every tick) needs exactly this.

Lanes: ``decode``, ``chunk_prefill``, ``serial_prefill``, ``seal``, and
under ``speculative=`` ``draft_decode``, ``verify`` and ``commit``.  A lane
with more than one signature is ``recompile/lane-retrace``; the finding
names the first event where two of its signatures part.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.dataflow import _record
from repro_torch.analysis.report import Report

__all__ = ["lint_scheduler_recompiles", "lane_trace_counts", "instrument",
           "DEFAULT_PROMPT_LENS", "LANES"]

#: prompt lengths chosen to straddle page and chunk boundaries
DEFAULT_PROMPT_LENS = (3, 7, 16, 21, 33)
#: lane name -> the scheduler attribute that runs it
LANES = {"decode": "_decode", "chunk_prefill": "_chunk_prefill",
         "serial_prefill": "_prefill", "seal": "_seal",
         "draft_decode": "_draft_decode", "verify": "_verify", "commit": "_commit"}


def instrument(sched) -> dict:
    """Record every lane call of ``sched`` from now on: each lane attribute
    is wrapped so its calls run under the dataflow recorders.  Returns
    ``{lane: [signature per call]}``, which the calls fill."""
    seen = getattr(sched, "_lane_signatures", None)
    if seen is not None:
        return seen
    seen = {}
    for lane, attr in LANES.items():
        fn = getattr(sched, attr, None)
        if fn is None or (lane in ("draft_decode", "verify", "commit")
                          and not getattr(sched, "speculative", 0)):
            continue
        calls = seen.setdefault(lane, [])

        def run(*args, _fn=fn, _calls=calls, **kwargs):
            trace, out = _record(_fn, *args, **kwargs)
            _calls.append(trace.signature())
            return out
        setattr(sched, attr, run)
    sched._lane_signatures = seen
    return seen


def lane_trace_counts(sched) -> dict:
    """Distinct shape signatures per lane that ran, of an instrumented
    scheduler (:func:`instrument`)."""
    seen = getattr(sched, "_lane_signatures", {})
    return {lane: len(set(sigs)) for lane, sigs in seen.items() if sigs}


def _first_split(sigs: list) -> str:
    """Where the first two distinct signatures of a lane part."""
    a, b = list(dict.fromkeys(sigs))[:2]
    for i, (ea, eb) in enumerate(zip(a, b)):
        if ea != eb:
            return f"event {i}: {ea[0]} {list(ea[1])} vs {eb[0]} {list(eb[1])}"
    return f"event {min(len(a), len(b))}: one signature has {abs(len(a) - len(b))} " \
           f"more events"


def lint_scheduler_recompiles(sched=None, *, cfg=None, params=None,
                              prompt_lens=DEFAULT_PROMPT_LENS,
                              max_new_tokens: int = 4,
                              location: str = "scheduler", device="cpu",
                              **sched_kwargs) -> Report:
    """Drive a mixed-length workload and flag any lane whose calls show
    more than one shape signature.

    Pass a prebuilt ``sched`` (it will be *run*), or ``cfg``/``params`` to
    build a small one (2 slots, chunked prefill) on ``device`` here.
    """
    from repro_torch.serving import BatchScheduler, Request

    if sched is None:
        if cfg is None or params is None:
            raise ValueError("need sched= or cfg=/params=")
        sched = BatchScheduler(cfg, params, n_slots=2,
                               max_len=max(prompt_lens) + max_new_tokens + 8,
                               device=device, **sched_kwargs)
    seen = instrument(sched)
    rng = np.random.default_rng(0)
    vocab = int(sched.cfg.vocab_size)
    for i, plen in enumerate(prompt_lens):
        prompt = torch.as_tensor(rng.integers(0, vocab, size=(plen,)),
                                 dtype=torch.long)
        sched.submit(Request(uid=i, prompt=prompt,
                             max_new_tokens=max_new_tokens))
    sched.run_to_completion(max_steps=64 * len(prompt_lens))

    report = Report()
    for lane, count in lane_trace_counts(sched).items():
        if count > 1:
            report.add(
                "error", "recompile/lane-retrace", f"{location}/{lane}",
                f"{len(seen[lane])} calls show {count} shape signatures across "
                f"prompt lengths {tuple(prompt_lens)}; a captured lane needs "
                f"exactly one (first split at {_first_split(seen[lane])})")
    return report
