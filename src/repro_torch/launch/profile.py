"""Where the serve driver's time goes on the card: ``torch.profiler`` over
one prefill and a few decode steps of the port's main path, or over a few
decode-only ticks of the paged runtime.

    PYTHONPATH=src python -m repro_torch.launch.profile --arch olmo_1b --steps 4
    PYTHONPATH=src python -m repro_torch.launch.profile --arch olmo_1b \
        --paged --kv-cache mip2q --prompt-len 128 --gen 32 --steps 4
    PYTHONPATH=src python -m repro_torch.launch.profile \
        --arch moonshot_v1_16b_a3b --layers 4 --paged --kv-cache mip2q \
        --prompt-len 128 --gen 32 --steps 4

Serves once through :func:`repro_torch.launch.serve.run` (build, pack,
warm-up), then profiles a prefill and ``--steps`` decode steps fed the
tokens that run produced.  With ``--paged`` it instead fills a fresh
scheduler of the same configuration with the same requests, steps it until
every prompt is prefilled, and profiles ``--steps`` decode-only ticks.  For
each it prints the host time, the summed device time of the kernels, the
device busy share (kernel time over host wall time) and the top ops by
device time and by host time (``key_averages``).  Needs a card; other flags
pass to ``repro_torch.launch.serve`` (``--mesh 1x1`` profiles the mesh
path: the ``sharded:*`` dispatch around the same kernels).
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.launch import serve as S
from repro_torch.models.sharding import place_tree, placement

__all__ = ["main"]


def _profiled(fn):
    """(profile, host seconds, result) of one synchronized call of ``fn``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall, out


def _report(name: str, prof, wall: float, n: int, rows: int) -> None:
    kernel_s = sum(e.device_time_total for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    print(f"== {name}: host {wall / n * 1e3:.3f} ms, device kernels "
          f"{kernel_s / n * 1e3:.3f} ms, busy share {kernel_s / wall:.3f} "
          f"(per {'step' if n > 1 else 'call'}, {n} timed)")
    avg = prof.key_averages()
    print(avg.table(sort_by="self_device_time_total", row_limit=rows))
    print(avg.table(sort_by="self_cpu_time_total", row_limit=rows))


def _rules(res: dict):
    from repro_torch.models.sharding import rules_for_mesh
    return None if res["mesh"] is None else rules_for_mesh(res["mesh"],
                                                           res["prompt"].shape[0])


def _profile_paged(res: dict, args) -> int:
    """Decode-only ticks of a scheduler like the one ``res`` drained."""
    from repro_torch.serving import BatchScheduler, Request
    done = res["sched"]
    b, n = res["prompt"].shape
    sched = BatchScheduler(res["cfg"], res["params"], n_slots=b, max_len=done.max_len,
                           mesh=res["mesh"], rules=_rules(res),
                           plan=res["plan"], kv_cache=done.spec.cfg,
                           page_size=done.page_size, prefill=done.prefill_mode,
                           device=res["device"])
    for i in range(b):
        sched.submit(Request(uid=i, prompt=res["prompt"][i].cpu(),
                             max_new_tokens=res["gen"] + 1))
    while sched.queue or sched._prefill_slots():
        sched.step()
    left = min(min(s.req.max_new_tokens - len(s.req.output), sched.max_len - 2 - s.len)
               for s in sched.slots if s is not None)
    steps = max(1, min(args.steps, left - 1))
    with torch.inference_mode():
        prof, wall, _ = _profiled(lambda: [sched.step() for _ in range(steps)])
    _report(f"paged decode tick ({b} slots, attention {sched.spec.attn_variant})",
            prof, wall, steps, args.rows)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.profile")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--rows", type=int, default=15)
    args, rest = ap.parse_known_args(argv)
    res = S.run(rest)
    if res["paged"]:
        return _profile_paged(res, args)
    cfg, prompt, toks = res["cfg"], res["prompt"], res["tokens"]
    steps, n = min(args.steps, res["gen"]), prompt.shape[1]
    params, rows, prefill, step = S.serving_setup(cfg, res["params"], prompt, steps,
                                                  mesh=res["mesh"], rules=_rules(res))
    pl = placement(rows)
    if pl is not None:      # the sharded serving layout: this rank's rows
        toks = place_tree(toks, pl.spec, res["mesh"])
    with torch.inference_mode():
        prof, wall, (_, caches) = _profiled(lambda: prefill(params, {"tokens": rows}))
        _report("prefill", prof, wall, 1, args.rows)

        def decode():
            for i in range(steps):
                step(params, toks[:, i:i + 1], caches, n + i)
        prof, wall, _ = _profiled(decode)
        _report("decode", prof, wall, steps, args.rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
