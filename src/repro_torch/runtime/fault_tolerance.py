"""Fault tolerance: checkpoint/restart, heartbeats and bounded retries
(twin of ``repro.runtime.fault_tolerance``, the single-host skeleton).

* A crashed job restarts and calls :func:`resume_or_init`, which restores
  the newest committed checkpoint (``checkpoint.py`` commits last, so a torn
  write is invisible).  The data pipeline is indexed by step, so step N's
  batch is replayed exactly.
* :class:`Heartbeat` writes a beat file per process; a watchdog declares a
  process dead when its beat is older than a timeout.
* :func:`retry` re-runs a flaky step a bounded number of times and then
  re-raises.  It never changes the device or the path a step runs on: a
  CUDA error is a ``RuntimeError`` and comes back up after its retries.
  Re-running is sound because the train step is functional (it returns new
  state and never writes into the state it was given).
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

from repro_torch.checkpoint import checkpoint as ckpt

__all__ = ["Heartbeat", "retry", "resume_or_init", "TrainLoopRunner"]


class Heartbeat:
    """File-based liveness beacon (a portable stand-in for a KV store)."""

    def __init__(self, path: str, process_id: int = 0):
        self.path = os.path.join(path, f"heartbeat_{process_id}.json")
        os.makedirs(path, exist_ok=True)
        self.process_id = process_id

    def beat(self, step: int) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": time.time(),
                       "process": self.process_id}, f)
        os.replace(tmp, self.path)

    def last(self) -> Optional[dict]:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def is_alive(self, timeout: float) -> bool:
        rec = self.last()
        return rec is not None and (time.time() - rec["time"]) < timeout


def retry(fn: Callable, max_tries: int = 3, backoff: float = 0.5,
          retriable=(RuntimeError,)):
    """Run ``fn()`` with at most ``max_tries`` attempts on ``retriable``
    errors, sleeping ``backoff · 2**attempt`` between them; re-raises the
    last error."""
    last_exc = None
    for attempt in range(max_tries):
        try:
            return fn()
        except retriable as e:  # noqa: PERF203
            last_exc = e
            time.sleep(backoff * (2 ** attempt))
    raise last_exc


def resume_or_init(directory: str, template, init_fn: Callable):
    """Restore the newest committed checkpoint into ``template``'s structure,
    devices and dtypes, or cold-start with ``init_fn()``.  Returns
    ``(state, start_step)``."""
    try:
        tree, step, _ = ckpt.restore(directory, template)
        return tree, step
    except FileNotFoundError:
        return init_fn(), 0


class TrainLoopRunner:
    """Crash-safe train loop: heartbeat, periodic async checkpoints, GC.

    ``step_fn(state, batch) -> (state, metrics)`` must be functional, so a
    retried step and a restart replay identically from their state.
    ``ckpt_every=0`` writes no checkpoint.
    """

    def __init__(self, workdir: str, ckpt_every: int = 50, keep: int = 3,
                 process_id: int = 0):
        self.workdir = workdir
        self.ckpt_dir = os.path.join(workdir, "ckpt")
        self.ckpt_every = ckpt_every
        self.keep = keep
        self.hb = Heartbeat(os.path.join(workdir, "hb"), process_id)
        self._pending = None

    def run(self, state, start_step: int, n_steps: int, step_fn, batch_fn,
            log_every: int = 10, log_fn=print):
        for step in range(start_step, n_steps):
            batch = batch_fn(step)
            state, metrics = retry(lambda: step_fn(state, batch))
            self.hb.beat(step)
            if log_every and step % log_every == 0:
                log_fn(f"step {step}: " + " ".join(
                    f"{k}={float(v):.4f}" for k, v in metrics.items()))
            if self.ckpt_every and (step + 1) % self.ckpt_every == 0:
                self._finish_write()
                self._pending = ckpt.save_async(self.ckpt_dir, step + 1, state)
        self._finish_write()
        return state

    def _finish_write(self) -> None:
        """Wait for the checkpoint in flight (re-raising its error), then
        GC.  GC runs only while nothing is being written: it deletes
        ``.tmp`` directories, and the write in flight is one."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
            ckpt.gc_keep(self.ckpt_dir, self.keep)
