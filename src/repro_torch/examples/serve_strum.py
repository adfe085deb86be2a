"""Serve a model with StruM-compressed weights (twin of
``examples/serve_strum.py``; the paper's deployment scenario: a vendor
receives a trained model, quantizes it post-training and serves it).

1. Fixed-config comparison (the paper's statically configured PE): dense
   vs sparsity / DLIQ / MIP2Q serving -- weight bytes, the projected H100
   decode time of the weight stream, agreement of generated tokens.
2. Autotuned schedule (the dynamically configurable PE + ``autotune``):
   search a per-layer schedule under a byte budget, write it to JSON, load
   it back, build an ``ExecutionPlan`` from it and serve the plan --
   profile -> search -> schedule -> plan -> serve.

    PYTHONPATH=src python -m repro_torch.examples.serve_strum --arch olmo_1b \
        [--device cpu]

Departures from the reference script: the prompt comes from
``np.random.default_rng(1)`` (the reference draws it with
``jax.random.PRNGKey(1)``) and the weights from the port's seeded init;
``run`` takes both.  The weight-stream projection divides the served bytes
by the H100's HBM rate (``repro_torch.hardware``), where the reference
divides by a TPU's.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile

import numpy as np
import torch

from repro_torch import hardware, resolve_device
from repro_torch.core.policy import StruMConfig

__all__ = ["FIXED", "run", "main"]

#: part 1's configs, each at p = 0.5
FIXED = [("sparsity", {}), ("dliq", dict(q=4)), ("mip2q", dict(L=5))]


def _agreement(toks: torch.Tensor, ref: torch.Tensor) -> float:
    return float((toks == ref).to(torch.float32).mean())


def _weight_record(plan, nbytes: int, dense: int) -> dict:
    """Served bytes, the packed payload beside the int8 bytes of the entries
    it packs (their true K x N, and K padded to whole blocks), and the H100
    weight-stream time."""
    entries = plan.entries.values()
    return {"bytes": nbytes, "ratio_vs_dense": nbytes / dense,
            "payload_bytes": plan.summary().get("packed_payload_bytes", 0),
            "int8_bytes": sum(math.prod(e.shape) for e in entries),
            "padded_int8_bytes": sum(math.prod(e.leaf["mask"].shape[:-2]) * e.cfg.w
                                     * e.shape[-1] for e in entries),
            "proj_us_per_token": nbytes / hardware.HBM_BYTES_PER_S * 1e6,
            "variants": plan.summary()["variant_distribution"]}


def autotuned_flow(cfg, params, prompt, gen: int, toks_ref, dense: int,
                   target_ratio: float, schedule_path: str, device) -> dict:
    """profile -> search -> save / load JSON -> build_plan -> serve."""
    from repro_torch import engine
    from repro_torch.autotune import Budget, StruMSchedule, search_schedule
    from repro_torch.core.apply import _named_leaves, tree_compression_report
    from repro_torch.core.metrics import sqnr_db
    from repro_torch.launch.serve import serve
    sched = search_schedule(params, Budget(target_ratio=target_ratio))
    sched.save(schedule_path)
    loaded = StruMSchedule.load(schedule_path)
    if loaded.assignments != sched.assignments:
        raise RuntimeError(f"{schedule_path} does not load back to the schedule saved")
    # the schedule drives plan construction end to end: packed payloads and
    # a registry-selected kernel variant per tensor
    offline = engine.build_plan(params, schedule=loaded, scope="tree", device=device)
    report = tree_compression_report(params, schedule=loaded)
    leaves = dict(_named_leaves(params))
    worst = min((float(sqnr_db(leaves[name], e.dequantized()))
                 for name, e in offline.entries.items()), default=None)
    # and the serving loader consumes the same schedule as a model plan
    plan = engine.build_plan(params, schedule=loaded, device=device)
    toks, _, _ = serve(cfg, plan.params, prompt, gen, device=device)
    return dict(_weight_record(plan, plan.serve_bytes(), dense),
                path=schedule_path, n_tensors=len(loaded.assignments),
                achieved_ratio=loaded.meta["achieved_ratio"],
                weighted_sqnr_db=loaded.meta["weighted_sqnr_db"],
                config_distribution=loaded.summary()["config_distribution"],
                n_packed=len(offline.entries), worst_sqnr_db=worst,
                packed_bytes=report["total_packed_bytes"],
                packed_ratio=report["total_packed_ratio"],
                theoretical_ratio=report["total_ratio"],
                agreement=_agreement(toks, toks_ref), tokens=toks.cpu())


def run(cfg, params, prompt, *, gen: int = 12, target_ratio: float = 0.875,
        schedule_path=None, device="cuda") -> dict:
    """Both parts on ``params`` (dense, f32) and ``prompt`` ((B, S) ints)."""
    from repro_torch import engine
    from repro_torch.launch.serve import serve
    from repro_torch.models.quantize import serve_tree_bytes
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt).to(dev)
    dense_cfg = dataclasses.replace(cfg, strum=None)
    toks_ref, _, _ = serve(dense_cfg, params, prompt, gen, device=dev)
    dense = serve_tree_bytes(params)
    out = {"dense_bytes": dense, "tokens": toks_ref.cpu(), "fixed": {}}
    for method, kw in FIXED:
        scfg = StruMConfig(method=method, p=0.5, **kw)
        plan = engine.build_plan(params, cfg=scfg, device=dev)
        toks, _, _ = serve(dataclasses.replace(cfg, strum=scfg), plan.params, prompt,
                           gen, device=dev)
        out["fixed"][method] = dict(_weight_record(plan, serve_tree_bytes(plan.params),
                                                   dense),
                                    p=scfg.p, q=scfg.q, n_low=scfg.n_low, w=scfg.w,
                                    agreement=_agreement(toks, toks_ref),
                                    tokens=toks.cpu())
    path = schedule_path or os.path.join(tempfile.gettempdir(),
                                         f"strum_schedule_{cfg.name}.json")
    out["autotune"] = autotuned_flow(dense_cfg, params, prompt, gen, toks_ref, dense,
                                     target_ratio, path, dev)
    out["target_ratio"] = target_ratio
    return out


def report(res: dict) -> list:
    """The reference script's lines for ``run``'s result."""
    dense = res["dense_bytes"]
    lines = [f"dense fp32: {dense / 1e6:8.2f} MB   tokens[0]="
             f"{res['tokens'][0, :8].tolist()}"]
    for method, r in res["fixed"].items():
        lines.append(f"{method:9s} p=0.5: {r['bytes'] / 1e6:8.2f} MB (x"
                     f"{r['ratio_vs_dense']:.3f}; proj H100 weight-stream "
                     f"{r['proj_us_per_token']:6.1f} us/tok) token agreement "
                     f"{r['agreement']:.2%}")
    a = res["autotune"]
    lines.append(f"autotune  r<={res['target_ratio']}: schedule {a['path']} "
                 f"({a['n_tensors']} tensors, achieved r={a['achieved_ratio']:.3f}, "
                 f"weighted SQNR {a['weighted_sqnr_db']:.1f} dB)")
    worst = (f", worst tensor SQNR {a['worst_sqnr_db']:.1f} dB" if a["n_packed"]
             else " (budget met with every tensor at plain INT8)")
    lines.append(f"          plan: {a['n_packed']} packed leaves, realized "
                 f"{a['packed_bytes'] / 1e6:.2f} MB (x{a['packed_ratio']:.3f} of int8; "
                 f"theoretical x{a['theoretical_ratio']:.3f}){worst}")
    lines.append(f"          serve: {a['bytes'] / 1e6:8.2f} MB (x{a['ratio_vs_dense']:.3f}; "
                 f"proj H100 weight-stream {a['proj_us_per_token']:6.1f} us/tok) "
                 f"variants {a['variants']} token agreement {a['agreement']:.2%}")
    return lines


def main(argv=None) -> int:
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--target-ratio", type=float, default=0.875,
                    help="autotune byte budget (packed/int8)")
    ap.add_argument("--schedule-out", default=None,
                    help="where to WRITE the searched schedule JSON (to serve an "
                         "existing schedule, pass it to "
                         "repro_torch.examples.serve_batch --schedule)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = init_params(model_defs(cfg), seed=0, device=dev, dtype_override="float32")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (args.batch, args.prompt_len))
    path = args.schedule_out or os.path.join(tempfile.gettempdir(),
                                             f"strum_schedule_{args.arch}.json")
    res = run(cfg, params, prompt, gen=args.gen, target_ratio=args.target_ratio,
              schedule_path=path, device=dev)
    print("\n".join(report(res)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
