"""End-to-end trainer (twin of ``repro.launch.train``): data pipeline ->
autograd train step (AdamW, optional MIP2Q gradient compression) ->
fault-tolerant loop with async checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b --smoke \\
        --steps 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b \\
        --steps 5 --batch 4 --seq 2048 --ckpt-every 0

runs on the card unless ``--device cpu`` is given (and raises without a
card).  ``--smoke`` takes the reduced same-family config with remat off,
as the reference does; the full configs keep their ``remat``.  A run
resumes from the newest committed checkpoint under ``--workdir/ckpt``
(by default ``$TMPDIR/repro_torch_train/<arch>[_smoke]``, one directory
for each config); ``--ckpt-every 0`` writes none.  The checkpoints use the reference's
layout and leaf names, so either package resumes the other's.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

from repro_torch import resolve_device
from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, global_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model_defs
from repro_torch.models.params import init_params
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.runtime import compression as gcomp
from repro_torch.runtime.fault_tolerance import TrainLoopRunner, resume_or_init

__all__ = ["build", "main", "workdir"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--workdir", default=None,
                    help="checkpoints and heartbeats; a run resumes from its "
                         "checkpoints (default: $TMPDIR/repro_torch_train/"
                         "<arch>[_smoke])")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", action="store_true",
                    help="StruM-MIP2Q gradient compression with error feedback")
    ap.add_argument("--param-dtype", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """The trainer's parts from its flags: ``(cfg, opt_cfg, data_cfg,
    cold_start, step_fn)``.  ``cold_start()`` makes the initial state
    ``{"params", "opt"[, "ef"]}`` on the device; ``step_fn(state, batch)``
    returns ``(state, metrics)``."""
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(cfg, remat=False)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 10 + 1),
                          total_steps=args.steps)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)
    defs = model_defs(cfg)

    def cold_start():
        params = init_params(defs, seed=args.seed, device=dev,
                             dtype_override=args.param_dtype)
        state = {"params": params, "opt": init_opt_state(params)}
        if args.grad_compression:
            state["ef"] = gcomp.init_ef_state(params)
        return state

    raw = make_train_step(cfg, opt_cfg, grad_compression=args.grad_compression)
    if args.grad_compression:
        def step_fn(state, batch):
            p, o, ef, metrics = raw(state["params"], state["opt"], state["ef"], batch)
            return {"params": p, "opt": o, "ef": ef}, metrics
    else:
        def step_fn(state, batch):
            p, o, metrics = raw(state["params"], state["opt"], batch)
            return {"params": p, "opt": o}, metrics
    return cfg, opt_cfg, dcfg, cold_start, step_fn


def workdir(args: argparse.Namespace) -> str:
    """``--workdir``, or a directory of this config under the system's
    temporary directory (which follows ``TMPDIR``)."""
    if args.workdir is not None:
        return args.workdir
    return os.path.join(tempfile.gettempdir(), "repro_torch_train",
                        args.arch + ("_smoke" if args.smoke else ""))


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg, _, dcfg, cold_start, step_fn = build(args)
    dev = resolve_device(args.device)
    work = workdir(args)
    init_state = cold_start()
    state, start = resume_or_init(os.path.join(work, "ckpt"),
                                  template=init_state, init_fn=lambda: init_state)
    if start:
        print(f"resumed from step {start} in {work}")
    runner = TrainLoopRunner(work, ckpt_every=args.ckpt_every)
    runner.run(state, start, args.steps, step_fn,
               lambda s: global_batch(dcfg, s, device=dev))
    print(f"done: {cfg.name}, {args.steps} steps on {dev}; checkpoints in "
          f"{runner.ckpt_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
