"""Quickstart: StruM in a minute (twin of ``examples/quickstart.py``).

1. quantize a weight matrix with structured sparsity / DLIQ / MIP2Q,
2. inspect error and compression (paper Eq. 1/2),
3. run the packed-weight matmul against its oracle,
4. compress a whole model's params with an ``ExecutionPlan`` and run a
   forward pass.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Departures from the reference script: step 3's ``ops.strum_matmul`` is K1
on the card (the reference's is interpret-mode Pallas), held against the
plain ``ref.strum_matmul_ref``; on the CPU both are plain PyTorch.  Step 4's
weights come from the port's seeded init, not ``jax.random``, so its
numbers are the reference's only on the reference's weights (``run``'s
``params=``).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.apply import fake_quantize_array, pack_array
from repro_torch.core.metrics import rel_l2_error, sqnr_db
from repro_torch.core.policy import StruMConfig

__all__ = ["METHODS", "run", "main"]

#: the three set-quantization strategies of step 1, each at p = .25 / .5 / .75
METHODS = [("sparsity", {}), ("dliq", dict(q=4)), ("mip2q", dict(L=5))]


@torch.inference_mode()
def run(model_cfg=None, params=None, seed: int = 0, device="cuda") -> dict:
    """Steps 1-4 on the reference's draws from ``np.random.default_rng(seed)``
    (``w`` (512, 256), then ``x`` (4, 512)); ``model_cfg`` defaults to the
    ``qwen2_7b`` smoke config and ``params`` to its f32 init from ``seed``."""
    from repro_torch import engine
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import forward_train, model_defs
    from repro_torch.models.params import init_params
    from repro_torch.models.quantize import serve_tree_bytes
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(size=(512, 256)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.normal(size=(4, 512)).astype(np.float32)).to(dev)

    table = []
    for method, kw in METHODS:
        for p in (0.25, 0.5, 0.75):
            cfg = StruMConfig(method=method, p=p, **kw)
            wq = fake_quantize_array(w, cfg)
            table.append({"method": method, "p": p,
                          "rel_l2": float(rel_l2_error(w, wq)),
                          "sqnr_db": float(sqnr_db(w, wq)),
                          "ratio": cfg.compression_ratio})

    cfg = StruMConfig(method="mip2q", p=0.5, L=5)
    packed = pack_array(w, cfg)
    y = ops.strum_matmul(x, packed)
    y_ref = ref.strum_matmul_ref(x, packed)

    mcfg = dataclasses.replace(model_cfg or get_smoke_config("qwen2_7b"), strum=cfg)
    if params is None:
        params = init_params(model_defs(mcfg), seed=seed, device=dev,
                             dtype_override="float32")
    plan = engine.build_plan(params, cfg=cfg, device=dev)
    summary = plan.summary()
    batch = {"tokens": torch.ones((1, 16), dtype=torch.long, device=dev)}
    lg_dense, _ = forward_train(params, batch, dataclasses.replace(mcfg, strum=None))
    lg_strum, _ = forward_train(plan.params, batch, mcfg)
    tv = 0.5 * float(torch.sum(torch.abs(torch.softmax(lg_dense[0, -1], -1)
                                         - torch.softmax(lg_strum[0, -1], -1))))
    return {"methods": table, "kernel_max_err": float((y - y_ref).abs().max()),
            "kernel_max_ref": float(y_ref.abs().max()),
            "weight_bytes": packed.payload_bytes(),
            "achieved_ratio": packed.achieved_ratio(), "eq_ratio": cfg.compression_ratio,
            "n_entries": summary["n_entries"],
            "variant_distribution": summary["variant_distribution"],
            "dense_bytes": serve_tree_bytes(params),
            "served_bytes": serve_tree_bytes(plan.params), "tv": tv,
            "device": str(dev)}


def report(res: dict) -> list:
    """The reference script's lines for ``run``'s result."""
    lines = [f"{'method':10s}{'p':>6s}{'rel_l2':>10s}{'sqnr_db':>9s}{'r (Eq.1/2)':>12s}"]
    lines += [f"{r['method']:10s}{r['p']:6.2f}{r['rel_l2']:10.4f}{r['sqnr_db']:9.2f}"
              f"{r['ratio']:12.4f}" for r in res["methods"]]
    lines.append(f"\nkernel max err vs oracle: {res['kernel_max_err']:.2e}; weight bytes "
                 f"{res['weight_bytes']} (= {res['achieved_ratio']:.4f} x int8, Eq.1 "
                 f"r={res['eq_ratio']})")
    lines.append(f"\nplan: {res['n_entries']} packed leaves, variants "
                 f"{res['variant_distribution']}")
    lines.append(f"\nmodel: {res['dense_bytes'] / 1e6:.2f} MB dense -> "
                 f"{res['served_bytes'] / 1e6:.2f} MB StruM; next-token TV distance "
                 f"{res['tv']:.4f} (no retraining)")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    print("\n".join(report(run(device=args.device))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
