"""End to end (twin of ``examples/train_e2e.py``): train a ~100M
parameter model with the full stack -- deterministic data pipeline, AdamW,
the fault-tolerant loop with async checkpoints, optional MIP2Q gradient
compression -- then quantize the result post-training with StruM and
compare eval quality (the paper's no-retraining deployment flow).

    PYTHONPATH=src python -m repro_torch.examples.train_e2e --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_e2e --steps 30 --small \
        --device cpu

Departures from the reference script: the step is the port's eager
``launch.steps.make_train_step`` (the reference jits it), the weights come
from the port's seeded init, and ``--workdir`` defaults to
``repro_torch_e2e`` under the system's temporary directory.  ``M100`` and
``SMALL`` are the reference's configs.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import StruMConfig

__all__ = ["M100", "SMALL", "PTQ", "run", "main"]

M100 = ModelConfig(  # ~103M params
    name="repro_100m", n_layers=8, d_model=768, n_heads=12, n_kv_heads=4,
    head_dim=64, d_ff=2048, vocab_size=32768, remat=False, attn_chunk=128)

SMALL = ModelConfig(
    name="repro_8m", n_layers=4, d_model=192, n_heads=6, n_kv_heads=2,
    head_dim=32, d_ff=512, vocab_size=2048, remat=False, attn_chunk=64)

#: the post-training quantizations compared, each at p = 0.5
PTQ = [("sparsity", {}), ("dliq", dict(q=4)), ("mip2q", dict(L=5))]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cfg, *, steps: int = 200, batch: int = 8, seq: int = 256,
        grad_compression: bool = False, workdir=None, device="cuda",
        log_fn=print) -> dict:
    """Train ``cfg`` for ``steps`` steps from its f32 init (seed 0),
    checkpointing every ``max(steps // 4, 10)`` steps under ``workdir``,
    then the eval CE of the trained weights, dense and under each ``PTQ``
    method."""
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.engine import fake_quantize
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import loss_fn
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.runtime import compression as gcomp
    from repro_torch.runtime.fault_tolerance import TrainLoopRunner, resume_or_init
    dev = resolve_device(device)
    workdir = workdir or os.path.join(tempfile.gettempdir(), "repro_torch_e2e")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                      seed=11)
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=max(steps // 10, 5), total_steps=steps)
    params = init_params(model_defs(cfg), seed=0, device=dev, dtype_override="float32")
    init = {"params": params, "opt": init_opt_state(params)}
    if grad_compression:
        init["ef"] = gcomp.init_ef_state(params)
    shutil.rmtree(workdir, ignore_errors=True)
    state, start = resume_or_init(os.path.join(workdir, "ckpt"), init, lambda: init)
    raw = make_train_step(cfg, opt_cfg, grad_compression=grad_compression)
    losses, ms = [], []

    def step_fn(st, b):
        _sync(dev)
        t0 = time.perf_counter()
        if grad_compression:
            p, o, ef, m = raw(st["params"], st["opt"], st["ef"], b)
            new = {"params": p, "opt": o, "ef": ef}
        else:
            p, o, m = raw(st["params"], st["opt"], b)
            new = {"params": p, "opt": o}
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        return new, m

    runner = TrainLoopRunner(workdir, ckpt_every=max(steps // 4, 10))
    state = runner.run(state, start, steps, step_fn,
                       lambda s: global_batch(dcfg, s, device=dev), log_every=10,
                       log_fn=log_fn)

    # deployment: PTQ with StruM, no fine-tuning (the paper's Table I flow)
    params = state["params"]
    eval_batch = global_batch(dcfg, 10_000, device=dev)
    dense_cfg = dataclasses.replace(cfg, strum=None)

    def ce(p) -> float:
        with torch.no_grad():
            return float(loss_fn(p, eval_batch, dense_cfg)[1]["ce"])
    evals, ratios = {"fp32": ce(params)}, {}
    for method, kw in PTQ:
        scfg = StruMConfig(method=method, p=0.5, **kw)
        evals[method] = ce(fake_quantize(params, cfg=scfg, device=dev))
        ratios[method] = scfg.compression_ratio
    return {"params": params, "losses": losses, "ms_per_step": ms, "eval": evals,
            "ratios": ratios, "param_count": cfg.param_count()}


def report(res: dict) -> list:
    """The reference script's eval lines for ``run``'s result."""
    lines = [f"\neval CE: fp32 baseline {res['eval']['fp32']:.4f}"]
    lines += [f"eval CE: {m:9s} p=0.5 -> {res['eval'][m]:.4f} "
              f"(r={res['ratios'][m]:.4f} x int8)" for m, _ in PTQ]
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = SMALL if args.small else M100
    if args.small:
        args.seq = min(args.seq, 128)
    print(f"model {cfg.name}: {cfg.param_count() / 1e6:.1f}M params")
    res = run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
              grad_compression=args.grad_compression, workdir=args.workdir, device=dev)
    print("\n".join(report(res)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
