"""Dry-run of every (arch x shape) cell on one H100, or on one rank of a
16x16 or 2x16x16 mesh of them (twin of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's jitted step on 512 forced
host devices and reads XLA's ``cost_analysis`` / ``memory_analysis`` and
the collectives of the partitioned HLO.  The port has no compiler to ask,
so it *runs* the cell's step once on the ``meta`` tensors of
:func:`repro_torch.launch.specs.input_specs`: shapes and dtypes flow
through every ATen op, nothing is allocated or computed, and a
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
* collectives (:meth:`Counter.collective`, the slot every collective of
  ``models.sharding`` reports to): kind, count and the result's bytes per
  device, in the reference's accounting (:func:`collective_bytes`);
* memory: ``argument_bytes`` (the input trees), ``output_bytes`` (the
  step's outputs) and ``temp_bytes``, the peak of live bytes above the
  arguments, tracked per storage with ``weakref.finalize``.

On a mesh (``lower_cell(..., mesh="16x16" | "2x16x16")``) the step is the
port's mesh step (``mesh=`` / ``rules=``) on the :class:`AbstractMesh` of
``launch.mesh.make_production_mesh(device="meta")``: no process group,
rank 0's coordinate, the card's kernel choices.  Its collectives build
their results' shapes alone, and each input is the block rank 0 holds
(``launch.specs.place_inputs``), under the layout the record names
(``layout``, :data:`LAYOUT_NOTES`):

* ``input_shardings``: every family's prefill and decode cells run the
  sharded serving layout (``models.sharding``), the reference's
  ``input_shardings``: rank 0 holds its shards of the dense and packed
  weights (a packed expert stack with its block axis whole, as the
  reference's specs hold it), its rows of the batch and its blocks of the
  decode caches (attention caches by sequence, the SSM ``conv`` cache by
  channel and ``state`` by head), so its argument bytes are the sum of the
  reference's shard sizes (tokens int64 where the reference's are int32,
  ``cache_len`` a Python int), and the count holds the FSDP gathers, the
  row-parallel all-reduces, the vocab-parallel embedding, the flash-decode
  merge, the expert-parallel all-reduce and the SSM mixer's gathers;
* ``tp_train``: every family's train cells run the train layout of
  ``models.transformer`` (the reference's train ``input_shardings``): rank
  0 holds its shards of the parameters and AdamW moments and computes its
  rows of the batch (the step takes them itself from the global batch)
  and its blocks of the heads, the MLP, the experts, the SSM heads and
  conv channels and the vocabulary; the count holds the FSDP gathers per
  use, the row-parallel all-reduces, the gathers of q / k / v and of the
  SSM projections and conv output, the expert-parallel combine, the
  vocab-parallel embedding and cross-entropy, and the backward's
  transposes of them all.

Costs are counted at depth ``period(cfg)``, twice that (and, for a train
step, three times) and extrapolated to the config's depth
(:func:`extrapolated_costs`), exactly, collectives included; the roofline
uses the H100's published peaks (:mod:`repro_torch.hardware`).  One H100
moves no collective bytes, so its ``collectives`` record is empty and its
``collective_s`` is 0.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--multi-pod | --both-meshes] [--accum-dtype bfloat16]
        [--attn-constraint]

needs no card.  With neither ``--multi-pod`` nor ``--both-meshes`` a cell
is counted on one H100 (mesh ``1x1``), where the reference's default is
16x16; ``--multi-pod`` gives 2x16x16 and ``--both-meshes`` both production
meshes.  ``--accum-dtype`` sets ``cfg.accum_dtype``: the dense products and
the plain routes round their f32 products to it; the CUDA kernels ignore
it, as the reference's Pallas variants do, and the card's post-gather
partial sums stay f32 (as the reference's ``gather_pallas`` sums), so its
collectives and kernel calls are the baseline's and only the dense
products' rounding adds ATen work.  ``--attn-constraint``
sets ``cfg.attn_heads_constraint``, which ``models.attention`` checks with
``sharding.check_axes`` and which moves nothing (the sharded serving
layout places the heads by its own schedule): its counts equal the
baseline's, where the reference's GSPMD reshards the heads.
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
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import input_specs, place_inputs
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.sharding import rules_for_mesh
from repro_torch.models.transformer import period
from repro_torch.optim.adamw import AdamWConfig, OptState

__all__ = ["Counter", "count_step", "extrapolated_costs", "compute_s",
           "collective_bytes", "roofline_terms", "model_flops",
           "lower_cell", "layout_of", "LAYOUT_NOTES", "MESHES", "main"]

#: kernels whose work is a product of x (M, K) with a packed (K, N) weight
MATMULS = ("cuda:onehot", "cuda:maskfree", "cuda:dense", "cuda:grouped",
           "cuda:grouped_maskfree", "cuda:grouped_dense", "draft:histream",
           "draft:maskfree_p")
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")
#: ``models.sharding``'s collectives as the reference's HLO names them
KIND_OF = {"all_gather": "all-gather", "psum": "all-reduce",
           "out_gather": "all-gather"}
#: the mesh names of a record -> ``make_production_mesh``'s ``multi_pod``
MESHES = {"16x16": False, "2x16x16": True}


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
        self.collectives: list = []    # one dict per collective call
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

    def collective(self, primitive: str, x: torch.Tensor, width: int,
                   out: torch.Tensor) -> None:
        """One collective of ``models.sharding`` over ``width`` ranks: its
        kind (:data:`KIND_OF`) and its result's bytes on this device, as
        the reference's ``collective_bytes`` reads the partitioned HLO.  A
        group of one rank moves nothing and is not recorded."""
        if width <= 1:
            return
        self.collectives.append({"primitive": primitive, "kind": KIND_OF[primitive],
                                 "shape": tuple(out.shape), "dtype": str(out.dtype),
                                 "width": width, "bytes": _nbytes(out)})


def collective_bytes(records) -> dict:
    """Twin of the reference's ``collective_bytes`` over :class:`Counter`
    records (``kind``, ``bytes``): the result bytes and the count per kind,
    and the ring model's ``link_bytes`` (an all-reduce is a reduce-scatter
    and an all-gather, so twice its bytes; every other kind once)."""
    sums = dict.fromkeys(COLLECTIVE_KINDS, 0)
    counts = dict.fromkeys(COLLECTIVE_KINDS, 0)
    for r in records:
        sums[r["kind"]] += r["bytes"]
        counts[r["kind"]] += 1
    link = 2 * sums["all-reduce"] + sum(v for k, v in sums.items() if k != "all-reduce")
    return {"per_kind_bytes": sums, "per_kind_count": counts, "link_bytes": link}


def compute_s(flops_by_dtype: dict) -> float:
    """FLOPs over the H100's peak for their dtype (bf16 at the tensor cores'
    rate, everything else at the f32 rate)."""
    return sum(f / hardware.PEAK_FLOPS.get(dt, hardware.F32_FLOPS)
               for dt, f in flops_by_dtype.items())


def _step_for(cfg, kind: str, mesh=None, rules=None):
    if kind == "train":
        return make_train_step(cfg, AdamWConfig(), mesh=mesh, rules=rules)
    if kind == "prefill":
        return make_prefill_step(cfg, mesh=mesh, rules=rules)
    return make_decode_step(cfg, mesh=mesh, rules=rules)


def _card_plan(params, cfg, mesh=None, rules=None):
    """Give every packed leaf of a ``packed_model_defs`` stand-in tree the
    ``cfg`` and ``spec`` that ``engine.build_plan`` records on the card, so
    each linear dispatches to the ``cuda`` kernel the card would run; with
    ``mesh`` the plan is mesh-aware and each leaf is cut, as ``build_plan``
    cuts it, to the block this rank holds."""
    from repro_torch.engine import build_plan
    from repro_torch.engine.sharded import cut_payload
    from repro_torch.models import model_defs
    from repro_torch.models.params import abstract_params
    plan = build_plan(abstract_params(model_defs(cfg)), cfg=cfg.strum, backend="cuda",
                      pack=False, mesh=mesh, rules=rules, device="meta")

    def attach(name, leaf):
        e = plan.entries.get(name)
        if e is None:
            return leaf
        leaf = dict(leaf, cfg=e.cfg, spec=e.spec)
        if e.shard is not None:
            leaf.update(cut_payload(leaf, e.shard, mesh))
        return leaf
    return map_named(attach, params, is_leaf=lambda x: isinstance(x, dict) and "mask" in x)


def _rank_inputs(cfg, shape, inputs, mesh, rules):
    """The inputs rank 0 of ``mesh`` holds (the module docstring): packed
    serving leaves as the card's (mesh-aware) plan cuts them, then every
    input placed by ``launch.specs.place_inputs``."""
    if cfg.strum is not None and shape.kind != "train":
        inputs = (_card_plan(inputs[0], cfg, mesh, rules),) + tuple(inputs[1:])
    if mesh is None:
        return inputs
    return place_inputs(cfg, shape, inputs, mesh, rules)


def layout_of(cfg, kind: str, mesh) -> str:
    """The layout a cell's step runs on ``mesh``: ``"1x1"`` without one, else
    a key of :data:`LAYOUT_NOTES`."""
    if mesh is None:
        return "1x1"
    return "tp_train" if kind == "train" else "input_shardings"


def count_step(cfg, shape, inputs=None, mesh=None, rules=None) -> dict:
    """Run ``shape``'s step of ``cfg`` once on ``inputs`` (by default the
    ``meta`` trees of ``input_specs(cfg, shape)``) under a
    :class:`Counter`; returns the counts, the collectives in the order
    they ran (``collective_records``) and the memory record.  With
    ``mesh`` (a ``DeviceMesh``, or an ``AbstractMesh`` for ``meta``
    inputs) the step is the port's mesh step under ``rules`` (default
    ``rules_for_mesh(mesh, shape.global_batch)``), each input cut to the
    block this rank holds (the module docstring), and the collectives are
    counted."""
    if inputs is None:
        inputs = input_specs(cfg, shape)
    if mesh is not None:
        rules = rules or rules_for_mesh(mesh, shape.global_batch)
        if getattr(mesh, "abstract", False):
            off = {t.device.type for t in _tensors(inputs)} - {"meta"}
            if off:
                raise ValueError(f"count_step: {mesh!r} takes meta inputs only; "
                                 f"got tensors on {sorted(off)}")
    inputs = _rank_inputs(cfg, shape, inputs, mesh, rules)
    step = _step_for(cfg, shape.kind, mesh, rules)
    counter = Counter()
    args_bytes = counter.hold(inputs)
    held = {t.untyped_storage()._cdata for t in _tensors(inputs)}
    t0 = time.perf_counter()
    with counter:
        outs = _tensors(step(*inputs))
    out_bytes = sum(map(_nbytes, outs))
    alias_bytes = sum(_nbytes(t) for t in outs if t.untyped_storage()._cdata in held)
    del outs
    coll = collective_bytes(counter.collectives)
    return {"flops": sum((counter.flops + counter.kernel_flops).values()),
            "flops_by_dtype": dict(counter.flops + counter.kernel_flops),
            "kernel_flops": sum(counter.kernel_flops.values()),
            "aten_bytes": counter.bytes, "kernel_bytes": counter.kernel_bytes,
            "bytes": counter.bytes + counter.kernel_bytes,
            "kernels": dict(counter.kernels), "collectives": coll,
            "collective_records": counter.collectives,
            "memory": {"argument_bytes": args_bytes, "output_bytes": out_bytes,
                       "temp_bytes": counter.peak, "alias_bytes": alias_bytes},
            "seconds": time.perf_counter() - t0}


def _extrapolate(counts: list, groups: int, first: int = 1) -> dict:
    """Newton's forward differences of records counted at ``first``,
    ``first + 1``, ... groups, evaluated at ``groups``: sum_j C(groups -
    first, j) * delta^j (exact for counts polynomial in the depth, from
    ``first`` groups on, of degree below ``len(counts)``)."""
    out = {}
    for k in dict.fromkeys(key for c in counts for key in c):
        vals = [c.get(k, 0) for c in counts]
        if any(isinstance(v, dict) for v in vals):
            out[k] = _extrapolate([v or {} for v in vals], groups, first)
            continue
        total, diffs = 0, vals
        for j in range(len(vals)):
            total += math.comb(groups - first, j) * diffs[0]
            diffs = [b - a for a, b in zip(diffs, diffs[1:])]
        out[k] = total
    return out


def extrapolated_costs(cfg, shape, mesh=None, rules=None) -> dict:
    """Counts of the full-depth step from runs at depths P = ``period(cfg)``,
    2P and, for a train step, 3P, extrapolated to ``cfg.n_layers`` (the
    reference does this because ``cost_analysis`` counts a ``scan`` body
    once).  Layer groups are identical, so the forward's counts are linear
    in the depth; a train step's are quadratic, because the gradient of each
    group's slice of a stacked weight is a zero-filled tensor of the whole
    stack (``select_backward``) added into its gradient.  Both are counted
    exactly; ``temp_bytes``, a peak, is extrapolated the same way and is not
    exact.  On a mesh the collectives of a layer group are the same in
    every group, so they are extrapolated with the rest; a train step's
    autograd on a mesh can clone more bytes at one group than the quadratic
    through two, three and four gives (the ZeRO-3 step did on an MoE
    config), so on a mesh a train step of two groups or more is counted at
    2P, 3P and 4P."""
    p = period(cfg)
    groups = cfg.n_layers // p
    first = 2 if mesh is not None and shape.kind == "train" and groups >= 2 else 1
    runs = [count_step(dataclasses.replace(cfg, n_layers=k * p), shape, mesh=mesh,
                       rules=rules)
            for k in range(first, first + (3 if shape.kind == "train" else 2))]
    for r in runs:
        r.pop("seconds")
        r.pop("collective_records")
    return _extrapolate(runs, groups, first)


def roofline_terms(t_c: float, bytes_per_dev: float, link_bytes_per_dev: float,
                   n_devices: int = 1) -> dict:
    """The three least times (compute ``t_c``, HBM bytes, link bytes) and
    the largest one's name.  Link bytes cross NVLink within one node of 8
    H100s; on a larger mesh (16x16, 2x16x16) every axis of 16 spans nodes,
    so its groups run at the inter-node rate, one 400 Gb/s port per card
    (``hardware``)."""
    t_m = bytes_per_dev / hardware.HBM_BYTES_PER_S
    link = hardware.NVLINK_BYTES_PER_S if n_devices <= hardware.CARDS_PER_NODE \
        else hardware.INTERNODE_BYTES_PER_S
    t_x = link_bytes_per_dev / link
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
              key=lambda kv: kv[1])[0]
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
            "bottleneck": dom}


def model_flops(cfg, shape) -> float:
    """The useful FLOPs of the cell: 6·N·D for a train step, 2·N·D for one
    forward over its tokens (N active parameters, D tokens)."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    return (6.0 if shape.kind == "train" else 2.0) * cfg.active_param_count() * tokens


#: the record's ``note`` on a mesh, by its ``layout``: what rank 0 holds
LAYOUT_NOTES = {
    "input_shardings": (
        "rank 0 of the port's sharded serving layout, the reference's "
        "input_shardings: dense and packed weights, the batch and the decode "
        "caches are rank 0's shards (weights FSDP over data, qkv/mlp/vocab over "
        "model; batch over data; cache sequence over model); tokens int64 and "
        "cache_len a Python int where the reference's are int32"),
    "tp_train": (
        "rank 0 of the port's train step, the reference's train input_shardings: "
        "parameters and moments rank 0's shards (FSDP over data; qkv/mlp/vocab, "
        "experts, SSM inner dims and heads over model), its rows of the batch "
        "over data, its blocks of the heads, the MLP, the experts, the SSM heads "
        "and channels and the vocabulary over model; each weight gathered over "
        "data per use, never whole"),
}


def lower_cell(arch: str, shape_name: str, overrides: Optional[dict] = None,
               variant: str = "baseline", *, mesh: str = "1x1") -> dict:
    """The record of one cell on one H100 (``mesh="1x1"``) or on rank 0 of
    a ``"16x16"`` / ``"2x16x16"`` mesh of them; the reference's keys
    wherever the quantity is the same (``trace_s`` in place of ``lower_s``
    / ``compile_s``: the ``meta`` runs' host seconds)."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh, "variant": variant}
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return dict(rec, status="SKIP(full-attn)",
                    note="quadratic attention at 512k context")
    mesh_obj = None if mesh == "1x1" else make_production_mesh(multi_pod=MESHES[mesh],
                                                               device="meta")
    rec["layout"] = layout_of(cfg, shape.kind, mesh_obj)
    n_dev = 1 if mesh_obj is None else mesh_obj.size()
    t0 = time.perf_counter()
    costs = extrapolated_costs(cfg, shape, mesh_obj)
    flops, nbytes = costs["flops"], costs["bytes"]
    coll = costs["collectives"]
    if mesh_obj is None:
        args = sum(_nbytes(t) for t in _tensors(input_specs(cfg, shape)))
        memory = dict(costs["memory"], argument_bytes=args)
        coll = {k: coll[k] for k in ("per_kind_bytes", "per_kind_count", "link_bytes")}
    else:
        memory = costs["memory"]
        rec["note"] = LAYOUT_NOTES[rec["layout"]]
    link = coll["link_bytes"]
    rec.update(status="OK", kind=shape.kind, n_devices=n_dev,
               trace_s=round(time.perf_counter() - t0, 2),
               flops_per_dev=flops, bytes_per_dev=nbytes,
               aten_bytes_per_dev=costs["aten_bytes"],
               kernel_bytes_per_dev=costs["kernel_bytes"],
               flops_by_dtype=costs["flops_by_dtype"], link_bytes_per_dev=link,
               kernels=costs["kernels"], collectives=coll, memory=memory,
               roofline=roofline_terms(compute_s(costs["flops_by_dtype"]), nbytes,
                                       link, n_dev))
    rec["model_flops_total"] = model_flops(cfg, shape)
    rec["model_flops_per_dev"] = rec["model_flops_total"] / n_dev
    if flops > 0:
        rec["useful_flops_ratio"] = rec["model_flops_per_dev"] / flops
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="one arch id, or omit for all")
    ap.add_argument("--shape", default=None, help="one shape name, or omit for all")
    ap.add_argument("--multi-pod", action="store_true",
                    help="rank 0 of a 2x16x16 mesh (default: one H100, 1x1)")
    ap.add_argument("--both-meshes", action="store_true",
                    help="16x16 and 2x16x16")
    ap.add_argument("--out", default="build/dryrun.json")
    ap.add_argument("--variant", default="baseline",
                    help="label recorded with each cell (perf iterations)")
    ap.add_argument("--accum-dtype", default=None,
                    help="override cfg.accum_dtype (e.g. bfloat16)")
    ap.add_argument("--remat-policy", default=None,
                    help="override cfg.remat_policy (full|dots)")
    ap.add_argument("--serve-packed", default=None,
                    help="StruM method for packed serving (mip2q|dliq|sparsity)")
    ap.add_argument("--strum-p", type=float, default=0.5)
    ap.add_argument("--strum-L", type=int, default=5)
    ap.add_argument("--attn-constraint", action="store_true")
    ap.add_argument("--ssm-split", action="store_true")
    args = ap.parse_args(argv)

    overrides = {}
    if args.attn_constraint:
        overrides["attn_heads_constraint"] = True
    if args.ssm_split:
        overrides["ssm_split_proj"] = True
    if args.accum_dtype:
        overrides["accum_dtype"] = args.accum_dtype
    if args.remat_policy:
        overrides["remat_policy"] = args.remat_policy
    if args.serve_packed:
        from repro_torch.core.policy import StruMConfig
        overrides["strum"] = StruMConfig(method=args.serve_packed, p=args.strum_p,
                                         L=args.strum_L)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = list(MESHES) if args.both_meshes else \
        ["2x16x16"] if args.multi_pod else ["1x1"]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"], r.get("variant", "baseline"))
            for r in results}
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                key = (arch, shape, mesh, args.variant)
                if key in done:
                    print(f"cached {key}", flush=True)
                    continue
                print(f"counting {key} ...", flush=True)
                try:
                    rec = lower_cell(arch, shape, overrides, args.variant, mesh=mesh)
                except Exception as e:  # noqa: BLE001 — record and continue
                    rec = {"arch": arch, "shape": shape, "mesh": mesh,
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
                             f"tm={r['memory_s']:.3f}s tx={r['collective_s']:.3f}s "
                             f"trace={rec['trace_s']:.1f}s")
                print(f"  -> {rec['status']}{extra}", flush=True)
    n_ok = sum(r["status"] == "OK" for r in results)
    n_skip = sum(r["status"].startswith("SKIP") for r in results)
    print(f"TOTAL {len(results)} cells: {n_ok} OK, {n_skip} SKIP, "
          f"{len(results) - n_ok - n_skip} FAIL")
    return 0 if len(results) == n_ok + n_skip else 1


if __name__ == "__main__":
    sys.exit(main())
