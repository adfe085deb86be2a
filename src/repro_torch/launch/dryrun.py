"""Dry-run of every (arch x shape) cell on one H100 (twin of
``repro.launch.dryrun``).

The reference lowers and compiles each cell's jitted step on 512 forced
host devices and reads XLA's ``cost_analysis`` / ``memory_analysis``.  The
port has no compiler to ask, so it *runs* the cell's step once on the
``meta`` tensors of :func:`repro_torch.launch.specs.input_specs`: shapes and
dtypes flow through every ATen op, nothing is allocated or computed, and a
:class:`Counter` (a ``TorchDispatchMode`` and the ``kernels.hooks`` slot)
counts what the step does:

* FLOPs of each ATen op by ``torch.utils.flop_counter``'s formulas, split by
  the operands' dtype (bf16 at the tensor cores' peak, anything else at the
  f32 peak: the port's dense products are f32 matmuls);
* bytes: every input and output of each ATen op that is not a view, once
  per op.  Nothing is fused, so this is an upper bound on HBM traffic, as
  the reference's CPU cost model is (``benchmarks/roofline.py``);
* kernel calls: each wrapper call (K1-K11) counts once, under the name of
  the kernel the card's plan selects for its leaf (packed leaves carry the
  ``cuda`` family's selection), with 2·M·K·N FLOPs per group (grouped
  stacks at capacity) and every tensor argument and output once, the bound
  ``chip_smoke.py`` uses.  On ``meta`` the kernel's plain version runs in
  its place, uncounted (``hooks.paused``): it is the only route there is.
  On any other device the wrapper itself runs, uncounted, as the dataflow
  tracer runs it (the kernel on the card, its plain version on the CPU);
  a call that mixes ``meta`` with other tensors is refused;
* memory: ``argument_bytes`` (the input trees), ``output_bytes`` (the
  step's outputs) and ``temp_bytes``, the peak of live bytes above the
  arguments, tracked per storage with ``weakref.finalize``.

Costs are counted at depth ``period(cfg)``, twice that (and, for a train
step, three times) and extrapolated to the config's depth
(:func:`extrapolated_costs`), exactly; the roofline uses the H100's published peaks
(:mod:`repro_torch.hardware`).  One H100 moves no collective bytes, so the
``collectives`` record is empty and ``collective_s`` is 0.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]

needs no card.  The reference's ``--multi-pod`` / ``--both-meshes`` are left
out: the port's collectives run real process groups and its dense compute is
replicated on every rank (``models/sharding.py``), so a 16x16 or 2x16x16
dry-run needs a collective stand-in the port does not have.  So are
``--accum-dtype`` and ``--attn-constraint``: the port reads no
``cfg.accum_dtype``, and ``cfg.attn_heads_constraint`` acts only under a
mesh's rules, which the 1x1 dry-run has none of; either flag would record a
variant whose counts are the baseline's.
"""
from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import math
import os
import sys
import time
import traceback
import weakref
from collections import Counter as _Tally
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import hardware
from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config
from repro_torch.core.apply import map_named
from repro_torch.kernels import hooks
from repro_torch.launch.specs import input_specs
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.transformer import period
from repro_torch.optim.adamw import AdamWConfig

__all__ = ["Counter", "count_step", "extrapolated_costs", "compute_s",
           "roofline_terms", "model_flops", "lower_cell", "main"]

#: kernels whose work is a product of x (M, K) with a packed (K, N) weight
MATMULS = ("cuda:onehot", "cuda:maskfree", "cuda:dense", "cuda:grouped",
           "cuda:grouped_maskfree", "cuda:grouped_dense", "draft:histream",
           "draft:maskfree_p")
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _plain(fn):
    """A kernel wrapper's plain PyTorch version (``<name>_plain`` beside it)."""
    return getattr(sys.modules[fn.__module__], fn.__name__ + "_plain")


class Counter(TorchDispatchMode):
    """Counts one step's ATen ops, kernel calls and live bytes.  Enter it
    with ``with counter:``; it installs itself in ``kernels.hooks.active``
    for the block, and :meth:`hold` marks the argument tensors first."""

    def __init__(self):
        super().__init__()
        self.flops = _Tally()          # str(dtype) -> FLOPs of ATen ops
        self.bytes = 0                 # ATen ops' inputs + outputs
        self.kernels = _Tally()        # kernel name -> calls
        self.kernel_flops = _Tally()   # str(x dtype) -> FLOPs of kernel calls
        self.kernel_bytes = 0
        self.live = self.peak = 0      # bytes of tensors made during the run
        self._seen: set = set()
        self._muted = 0

    def hold(self, tree) -> int:
        """Mark ``tree``'s storages as arguments (never counted as
        temporaries); returns their bytes."""
        for t in _tensors(tree):
            self._seen.add(t.untyped_storage()._cdata)
        return sum(_nbytes(t) for t in _tensors(tree))

    def _track(self, tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            self._seen.add(key)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self._seen.discard(key)
        self.live -= n

    def __enter__(self):
        self._saved, hooks.active = hooks.active, self
        return super().__enter__()

    def __exit__(self, *exc):
        hooks.active = self._saved
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._muted:
            return out
        outs = _tensors(out)
        self._track(outs)
        packet = func._overloadpacket
        if packet in flop_registry:
            ins = [t for t in _tensors((args, kwargs)) if t.is_floating_point()]
            dt = str(ins[0].dtype) if ins else "torch.float32"
            self.flops[dt] += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes += sum(map(_nbytes, _tensors((args, kwargs)))) + \
                sum(map(_nbytes, outs))
        return out

    # -- the kernels.hooks slot ------------------------------------------
    def kernel(self, name: str, fn, *args, **kwargs):
        """One kernel call: count it, then run it unseen: its plain version
        on ``meta`` tensors, else the wrapper itself."""
        devices = {t.device.type for t in _tensors((args, kwargs))}
        if "meta" in devices and len(devices) > 1:
            raise ValueError(f"{name}: meta tensors mixed with tensors on "
                             f"{sorted(devices - {'meta'})}")
        run = _plain(fn) if devices == {"meta"} else fn
        self._muted += 1
        try:
            with hooks.paused():
                out = run(*args, **kwargs)
        finally:
            self._muted -= 1
        outs = _tensors(out)
        self._track(outs)
        self.kernels[name] += 1
        self.kernel_bytes += sum(map(_nbytes, _tensors((args, kwargs)))) + \
            sum(map(_nbytes, outs))
        if name in MATMULS:    # x (M, K) or (G, M, K), scale (..., 1, N)
            bound = inspect.signature(fn).bind(*args, **kwargs).arguments
            x = next(iter(bound.values()))
            self.kernel_flops[str(x.dtype)] += 2 * x.numel() * bound["scale"].shape[-1]
        return out


def compute_s(flops_by_dtype: dict) -> float:
    """FLOPs over the H100's peak for their dtype (bf16 at the tensor cores'
    rate, everything else at the f32 rate)."""
    return sum(f / hardware.PEAK_FLOPS.get(dt, hardware.F32_FLOPS)
               for dt, f in flops_by_dtype.items())


def _step_for(cfg, kind: str):
    if kind == "train":
        return make_train_step(cfg, AdamWConfig())
    if kind == "prefill":
        return make_prefill_step(cfg)
    return make_decode_step(cfg)


def _card_plan(params, cfg):
    """Give every packed leaf of a ``packed_model_defs`` stand-in tree the
    ``cfg`` and ``spec`` that ``engine.build_plan`` records on the card, so
    each linear dispatches to the ``cuda`` kernel the card would run."""
    from repro_torch.engine import build_plan
    from repro_torch.models import model_defs
    from repro_torch.models.params import abstract_params
    plan = build_plan(abstract_params(model_defs(cfg)), cfg=cfg.strum, backend="cuda",
                      pack=False, device="meta")

    def attach(name, leaf):
        e = plan.entries.get(name)
        if e is not None:
            leaf = dict(leaf, cfg=e.cfg, spec=e.spec)
        return leaf
    return map_named(attach, params, is_leaf=lambda x: isinstance(x, dict) and "mask" in x)


def count_step(cfg, shape, inputs=None) -> dict:
    """Run ``shape``'s step of ``cfg`` once on ``inputs`` (by default the
    ``meta`` trees of ``input_specs(cfg, shape)``) under a
    :class:`Counter`; returns the counts and the memory record."""
    if inputs is None:
        inputs = input_specs(cfg, shape)
    if cfg.strum is not None and shape.kind != "train":
        inputs = (_card_plan(inputs[0], cfg),) + tuple(inputs[1:])
    step = _step_for(cfg, shape.kind)
    counter = Counter()
    args_bytes = counter.hold(inputs)
    held = {t.untyped_storage()._cdata for t in _tensors(inputs)}
    t0 = time.perf_counter()
    with counter:
        outs = _tensors(step(*inputs))
    out_bytes = sum(map(_nbytes, outs))
    alias_bytes = sum(_nbytes(t) for t in outs if t.untyped_storage()._cdata in held)
    del outs
    return {"flops": sum((counter.flops + counter.kernel_flops).values()),
            "flops_by_dtype": dict(counter.flops + counter.kernel_flops),
            "kernel_flops": sum(counter.kernel_flops.values()),
            "aten_bytes": counter.bytes, "kernel_bytes": counter.kernel_bytes,
            "bytes": counter.bytes + counter.kernel_bytes,
            "kernels": dict(counter.kernels),
            "memory": {"argument_bytes": args_bytes, "output_bytes": out_bytes,
                       "temp_bytes": counter.peak, "alias_bytes": alias_bytes},
            "seconds": time.perf_counter() - t0}


def _extrapolate(counts: list, groups: int) -> dict:
    """Newton's forward differences of records counted at 1, 2, ... groups,
    evaluated at ``groups``: sum_j C(groups - 1, j) * delta^j (exact for
    counts polynomial in the depth of degree below ``len(counts)``)."""
    out = {}
    for k in dict.fromkeys(key for c in counts for key in c):
        vals = [c.get(k, 0) for c in counts]
        if any(isinstance(v, dict) for v in vals):
            out[k] = _extrapolate([v or {} for v in vals], groups)
            continue
        total, diffs = 0, vals
        for j in range(len(vals)):
            total += math.comb(groups - 1, j) * diffs[0]
            diffs = [b - a for a, b in zip(diffs, diffs[1:])]
        out[k] = total
    return out


def extrapolated_costs(cfg, shape) -> dict:
    """Counts of the full-depth step from runs at depths P = ``period(cfg)``,
    2P and, for a train step, 3P, extrapolated to ``cfg.n_layers`` (the
    reference does this because ``cost_analysis`` counts a ``scan`` body
    once).  Layer groups are identical, so the forward's counts are linear
    in the depth; a train step's are quadratic, because the gradient of each
    group's slice of a stacked weight is a zero-filled tensor of the whole
    stack (``select_backward``) added into its gradient.  Both are counted
    exactly; ``temp_bytes``, a peak, is extrapolated the same way and is not
    exact."""
    p = period(cfg)
    runs = [count_step(dataclasses.replace(cfg, n_layers=k * p), shape)
            for k in range(1, 4 if shape.kind == "train" else 3)]
    for r in runs:
        r.pop("seconds")
    return _extrapolate(runs, cfg.n_layers // p)


def roofline_terms(t_c: float, bytes_per_dev: float,
                   link_bytes_per_dev: float) -> dict:
    """The three least times (compute ``t_c``, HBM bytes, NVLink bytes) and
    the largest one's name."""
    t_m = bytes_per_dev / hardware.HBM_BYTES_PER_S
    t_x = link_bytes_per_dev / hardware.NVLINK_BYTES_PER_S
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
              key=lambda kv: kv[1])[0]
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
            "bottleneck": dom}


def model_flops(cfg, shape) -> float:
    """The useful FLOPs of the cell: 6·N·D for a train step, 2·N·D for one
    forward over its tokens (N active parameters, D tokens)."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    return (6.0 if shape.kind == "train" else 2.0) * cfg.active_param_count() * tokens


def lower_cell(arch: str, shape_name: str, overrides: Optional[dict] = None,
               variant: str = "baseline") -> dict:
    """The record of one cell on one H100 (mesh ``1x1``); the reference's
    keys wherever the quantity is the same (``trace_s`` in place of
    ``lower_s`` / ``compile_s``: the two ``meta`` runs' host seconds)."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": "1x1", "variant": variant}
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return dict(rec, status="SKIP(full-attn)",
                    note="quadratic attention at 512k context")
    t0 = time.perf_counter()
    costs = extrapolated_costs(cfg, shape)
    args = sum(_nbytes(t) for t in _tensors(input_specs(cfg, shape)))
    flops, nbytes = costs["flops"], costs["bytes"]
    rec.update(status="OK", kind=shape.kind, n_devices=1,
               trace_s=round(time.perf_counter() - t0, 2),
               flops_per_dev=flops, bytes_per_dev=nbytes,
               aten_bytes_per_dev=costs["aten_bytes"],
               kernel_bytes_per_dev=costs["kernel_bytes"],
               flops_by_dtype=costs["flops_by_dtype"], link_bytes_per_dev=0,
               kernels=costs["kernels"],
               collectives={"per_kind_bytes": dict.fromkeys(COLLECTIVE_KINDS, 0),
                            "per_kind_count": dict.fromkeys(COLLECTIVE_KINDS, 0),
                            "link_bytes": 0},
               memory=dict(costs["memory"], argument_bytes=args),
               roofline=roofline_terms(compute_s(costs["flops_by_dtype"]), nbytes, 0))
    rec["model_flops_total"] = rec["model_flops_per_dev"] = model_flops(cfg, shape)
    if flops > 0:
        rec["useful_flops_ratio"] = rec["model_flops_total"] / flops
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="one arch id, or omit for all")
    ap.add_argument("--shape", default=None, help="one shape name, or omit for all")
    ap.add_argument("--out", default="build/dryrun.json")
    ap.add_argument("--variant", default="baseline",
                    help="label recorded with each cell (perf iterations)")
    ap.add_argument("--remat-policy", default=None,
                    help="override cfg.remat_policy (full|dots)")
    ap.add_argument("--serve-packed", default=None,
                    help="StruM method for packed serving (mip2q|dliq|sparsity)")
    ap.add_argument("--strum-p", type=float, default=0.5)
    ap.add_argument("--strum-L", type=int, default=5)
    ap.add_argument("--ssm-split", action="store_true")
    args = ap.parse_args(argv)

    overrides = {}
    if args.ssm_split:
        overrides["ssm_split_proj"] = True
    if args.remat_policy:
        overrides["remat_policy"] = args.remat_policy
    if args.serve_packed:
        from repro_torch.core.policy import StruMConfig
        overrides["strum"] = StruMConfig(method=args.serve_packed, p=args.strum_p,
                                         L=args.strum_L)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"], r.get("variant", "baseline"))
            for r in results}
    for arch in archs:
        for shape in shapes:
            key = (arch, shape, "1x1", args.variant)
            if key in done:
                print(f"cached {key}", flush=True)
                continue
            print(f"counting {key} ...", flush=True)
            try:
                rec = lower_cell(arch, shape, overrides, args.variant)
            except Exception as e:  # noqa: BLE001 — record and continue
                rec = {"arch": arch, "shape": shape, "mesh": "1x1",
                       "variant": args.variant,
                       "status": f"FAIL: {type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
            results.append(rec)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
            extra = ""
            if rec["status"] == "OK":
                r = rec["roofline"]
                extra = (f" bottleneck={r['bottleneck']} tc={r['compute_s']:.3f}s "
                         f"tm={r['memory_s']:.3f}s trace={rec['trace_s']:.1f}s")
            print(f"  -> {rec['status']}{extra}", flush=True)
    n_ok = sum(r["status"] == "OK" for r in results)
    n_skip = sum(r["status"].startswith("SKIP") for r in results)
    print(f"TOTAL {len(results)} cells: {n_ok} OK, {n_skip} SKIP, "
          f"{len(results) - n_ok - n_skip} FAIL")
    return 0 if len(results) == n_ok + n_skip else 1


if __name__ == "__main__":
    sys.exit(main())
