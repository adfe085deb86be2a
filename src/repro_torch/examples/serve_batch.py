"""Continuous-batching serving demo (twin of ``examples/serve_batch.py``): a
request queue drained through the paged scheduler with StruM-compressed
weights and StruM-packed KV pages.

    PYTHONPATH=src python -m repro_torch.examples.serve_batch --arch olmo_1b \
        --requests 6 [--kv-cache mip2q] [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_batch --trace trace.json

Departures from the reference script: prompts come from
``np.random.default_rng(seed)`` (the reference draws them with
``jax.random``, which the port cannot reproduce), and weights from the
port's seeded init; ``run`` takes both, so the reference's draws can be
served here too.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device, telemetry
from repro_torch.core.policy import StruMConfig

__all__ = ["prompts_for", "run", "main"]


def prompts_for(n: int, vocab: int, seed: int = 0) -> list:
    """``n`` prompts of 6-10 tokens (the reference's lengths, ``6 + i % 5``)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, 6 + i % 5).astype(np.int64) for i in range(n)]


def run(cfg, params, prompts, *, slots: int = 3, gen: int = 8, strum: str = "mip2q",
        schedule=None, kv_cache: str = "none", page_size: int = 16,
        prefill: str = "chunked", device="cuda") -> dict:
    """Serve ``prompts`` (int arrays) as requests ``uid = i`` (priority
    ``i % 2``) through a :class:`repro_torch.serving.BatchScheduler` with
    ``slots`` slots: weights packed under ``strum`` (``"none"``: dense), or
    by the scheduler from ``schedule`` (a ``StruMSchedule`` JSON path), KV
    pages sealed under ``kv_cache`` (q = 4, L = 7)."""
    from repro_torch import engine
    from repro_torch.models.quantize import serve_tree_bytes
    from repro_torch.serving import BatchScheduler, Request
    dev = resolve_device(device)
    out = {"dense_bytes": serve_tree_bytes(params), "schedule": schedule}
    if schedule is None and strum != "none":
        scfg = StruMConfig(method=strum, p=0.5, L=5)
        cfg = dataclasses.replace(cfg, strum=scfg)
        plan = engine.build_plan(params, cfg=scfg, device=dev)
        params = plan.params
        out["variants"] = plan.summary()["variant_distribution"]
    kv = None if kv_cache == "none" else StruMConfig(method=kv_cache, p=0.5, q=4, L=7)
    sched = BatchScheduler(cfg, params, n_slots=slots, max_len=64,
                           schedule=schedule, kv_cache=kv, page_size=page_size,
                           prefill=prefill, device=dev)
    out["served_bytes"] = serve_tree_bytes(sched.params)
    for i, p in enumerate(prompts):
        sched.submit(Request(uid=i, prompt=torch.as_tensor(p), max_new_tokens=gen,
                             priority=i % 2))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    done = sched.run_to_completion(max_steps=500)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["seconds"] = time.perf_counter() - t0
    out["outputs"] = {r.uid: list(r.output) for r in sorted(done, key=lambda r: r.uid)}
    out["tokens"] = sum(len(r.output) for r in done)
    st = sched.cache_stats()
    out["ticks"] = st["steps"]
    out["cache"] = {k: st[k] for k in ("codec", "resident_page_bytes", "ratio_vs_int8",
                                       "dense_cache_bytes", "attn_variant")}
    rec = telemetry.current()
    if rec is not None:
        out["latency"] = rec.latency_summary()
    return out


def report(res: dict, slots: int, prefill: str, strum: str) -> list:
    """The reference script's lines for ``run``'s result."""
    lines = []
    if res["schedule"] is not None:
        lines.append(f"serving per-layer schedule {res['schedule']} (dense "
                     f"{res['dense_bytes'] / 1e6:.2f} MB)")
        lines.append(f"  scheduler compressed to {res['served_bytes'] / 1e6:.2f} MB")
    elif strum != "none":
        lines.append(f"serving StruM-{strum} weights: {res['dense_bytes'] / 1e6:.2f} -> "
                     f"{res['served_bytes'] / 1e6:.2f} MB (variants {res['variants']})")
    lines += [f"req {uid}: {out}" for uid, out in res["outputs"].items()]
    lines.append(f"{len(res['outputs'])} requests, {res['tokens']} tokens in "
                 f"{res['seconds']:.1f}s ({res['ticks']} scheduler ticks on {slots} "
                 f"slots, {prefill} prefill)")
    c = res["cache"]
    lines.append(f"cache: {c['codec']} pages, resident {c['resident_page_bytes'] / 1e3:.1f} "
                 f"kB (x{c['ratio_vs_int8']:.3f} vs int8 pages; dense monolithic cache "
                 f"would be {c['dense_cache_bytes'] / 1e3:.1f} kB)")
    lat = res.get("latency")
    if lat is not None:
        lines.append(f"latency: ttft p50 {lat['ttft_p50_us'] / 1e3:.1f} ms / p99 "
                     f"{lat['ttft_p99_us'] / 1e3:.1f} ms; tok p50 "
                     f"{lat['tok_p50_us'] / 1e3:.1f} ms; goodput "
                     f"{lat['goodput_tok_s']:.1f} tok/s ({lat['n_retired']}/"
                     f"{lat['n_requests']} retired)")
    return lines


def main(argv=None) -> int:
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--strum", default="mip2q",
                    choices=["none", "sparsity", "dliq", "mip2q"])
    ap.add_argument("--schedule", default=None,
                    help="autotuned StruMSchedule JSON (overrides --strum; the "
                         "scheduler compresses the weights from it)")
    ap.add_argument("--kv-cache", default="none",
                    choices=["none", "sparsity", "dliq", "mip2q"],
                    help="pack sealed KV pages with this codec (q=4 / L=7)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill", default="chunked", choices=["chunked", "serial"])
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write a Chrome-trace JSON of the run (same as "
                         "STRUM_TRACE=PATH); open in Perfetto")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.trace:
        telemetry.configure(trace_path=args.trace)
    cfg = get_smoke_config(args.arch)
    params = init_params(model_defs(cfg), seed=0, device=dev, dtype_override="float32")
    res = run(cfg, params, prompts_for(args.requests, cfg.vocab_size), slots=args.slots,
              gen=args.gen, strum=args.strum, schedule=args.schedule,
              kv_cache=args.kv_cache, page_size=args.page_size, prefill=args.prefill,
              device=dev)
    print("\n".join(report(res, args.slots, args.prefill, args.strum)))
    if args.trace:
        print(f"trace -> {args.trace} (Perfetto / chrome://tracing)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
