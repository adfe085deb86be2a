"""Execution plans: build once from ``(params, StruMSchedule)``, serve many
(twin of ``repro.engine.plan``).

For every quantized leaf the plan records the packed representation *and*
the kernel variant selected from the registry, so serving never re-derives
per-leaf configs.  Two scopes, as in the reference:

``scope="model"``  model param trees: each eligible ``.../w`` weight and
                   each MoE expert stack (``.../moe/wi|wg|wo``) becomes
                   ``{"mask", "hi", "lo", "scale", "cfg", "spec"}`` with its
                   lead dims kept on every payload field ("serve" layout).
                   Scan-group lead dims are sliced away before dispatch, so
                   2-D weights select a 2-D variant; expert stacks keep
                   their expert dim and select from the grouped family
                   (``cuda:grouped*``, K6-K8).
``scope="tree"``   any tree: every eligible leaf packs column-folded
                   ("folded" layout); ``plan.params`` is the flat manifest
                   ``{name: (PackedStruM, shape) | leaf}`` that
                   ``core.apply.pack_tree`` returns.

A ``schedule`` (a :class:`repro_torch.autotune.StruMSchedule`, e.g. loaded
from the reference's JSON) gives each tensor its own config, so one plan
may run K1, K2, K3 and dense products side by side.  ``pack=False`` builds
a selection-only plan (configs and variants, no payload), which
:func:`fake_quantize` uses.

``mesh=`` (+ ``rules=``) makes the plan mesh-aware, as in the reference:
every entry records its distributed layout (:class:`ShardSpec`: FSDP gather
axes from the rules' ``embed`` mapping, col / row TP pattern, expert lead
axis) and selects from the ``sharded:*`` family.  Unlike the reference,
whose arrays are global and placed by GSPMD, each rank packs the global
weight and keeps only its block of the payload (ZeRO-3 storage);
``payload_bytes`` and ``summary`` still count the whole payload.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import packing
from repro_torch.core.apply import _named_leaves, map_named
from repro_torch.core.policy import LayerPolicy, StruMConfig, default_policy
from repro_torch.engine import sharded as _sharded  # registers sharded:*; layouts
from repro_torch.engine import variants as _variants  # noqa: F401  (registration)
from repro_torch.engine.registry import ExecSpec, LeafInfo, ShardSpec, select_variant
from repro_torch.models.sharding import (axis_names, axis_sizes, fsdp_axes,
                                         rules_for_mesh)

__all__ = ["PlanEntry", "ExecutionPlan", "build_plan", "fake_quantize"]

_FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def _is_expert_stack(name: str) -> bool:
    return "/moe/" in name and name.rsplit("/", 1)[-1] in ("wi", "wg", "wo")


def _resolve_policy(schedule, policy: Optional[LayerPolicy],
                    cfg: Optional[StruMConfig]) -> LayerPolicy:
    """Schedule wins, then explicit policy, then a uniform-cfg default."""
    if schedule is not None:
        return schedule.to_policy()
    if policy is not None:
        return policy
    return default_policy(cfg)


@dataclasses.dataclass
class PlanEntry:
    """One quantized leaf: config + selected variant + packed payload."""

    name: str
    cfg: StruMConfig
    variant: str
    shape: tuple                      # original dense shape
    leaf: Optional[dict] = None       # packed tensors + cfg + spec; None if
                                      # the plan was built with pack=False
    backend: Optional[str] = None
    layout: str = "serve"             # "serve" (lead dims kept) | "folded"
    shard: Optional[ShardSpec] = None  # distributed layout (mesh-aware plans);
                                       # ``leaf`` is then this rank's block

    @property
    def spec(self) -> ExecSpec:
        # K is shape[-2] in both layouts: folding moves lead dims into
        # columns, never into the reduction axis
        return ExecSpec(cfg=self.cfg, variant=self.variant,
                        backend=self.backend, k_dim=self.shape[-2],
                        shard=self.shard)

    def _payload(self) -> dict:
        if self.leaf is None:
            raise ValueError(f"plan entry {self.name!r} was built with "
                             f"pack=False (selection-only)")
        return self.leaf

    def as_packed(self) -> packing.PackedStruM:
        """The 2-D :class:`PackedStruM` view (folded, or lead-free serve)."""
        leaf = self._payload()
        if self.layout == "serve" and len(self.shape) > 2:
            raise ValueError(f"{self.name!r} is a stacked leaf (lead dims "
                             f"{self.shape[:-2]}); slice a group first")
        cfg = self.cfg
        return packing.PackedStruM(
            method=cfg.method, w=cfg.w, n_low=cfg.n_low, q=cfg.q, L=cfg.L,
            k_dim=self.shape[-2], scale=leaf["scale"], mask=leaf["mask"],
            hi=leaf["hi"], lo=leaf["lo"])

    def dequantized(self, dtype=torch.float32) -> torch.Tensor:
        """Decompress back to the original dense shape."""
        leaf = self._payload()
        if self.layout == "folded":
            from repro_torch.core.apply import unpack_array
            return unpack_array(self.as_packed(), self.shape, dtype)
        from repro_torch.engine.dispatch import dequant_leaf
        return dequant_leaf(leaf, dtype, cfg=self.cfg, k_dim=self.shape[-2])

    def payload_bytes(self) -> Optional[int]:
        """mask + hi + lo bytes of the whole payload (all ranks' blocks)."""
        if self.leaf is None:
            return None
        local = sum(self.leaf[k].numel() for k in ("mask", "hi", "lo"))
        return int(local * (self.shard.parts if self.shard is not None else 1))


@dataclasses.dataclass
class ExecutionPlan:
    """Per-leaf packed payloads + selected kernel variants, built once.

    ``entries`` is keyed by parameter path name; ``params`` is either the
    model-shaped served tree (scope="model") or the flat pack manifest
    (scope="tree").
    """

    entries: dict
    params: Any
    backend: Optional[str] = None
    scope: str = "model"
    schedule: Any = None
    meta: dict = dataclasses.field(default_factory=dict)   # e.g. a draft
                                                           # plan's mode map

    def __getitem__(self, name: str) -> PlanEntry:
        return self.entries[name]

    def variants(self) -> dict:
        return {name: e.variant for name, e in self.entries.items()}

    def serve_bytes(self) -> int:
        from repro_torch.models.quantize import serve_tree_bytes
        return serve_tree_bytes(self.params)

    def summary(self) -> dict:
        dist: dict = {}
        for e in self.entries.values():
            dist[e.variant] = dist.get(e.variant, 0) + 1
        out = {"n_entries": len(self.entries), "backend": self.backend or "auto",
               "scope": self.scope, "variant_distribution": dist}
        if self.meta.get("fsdp_axes"):
            out["fsdp_axes"] = tuple(self.meta["fsdp_axes"])
        payload = [e.payload_bytes() for e in self.entries.values()]
        if payload and None not in payload:
            out["packed_payload_bytes"] = int(sum(payload))
        return out

    def fake_quantize(self, params: Any, baseline_int8: bool = True) -> Any:
        """Shape-preserving fake-quant of ``params`` per this plan's configs,
        on each leaf's device.

        Leaves with a plan entry get the StruM round-trip; other float
        matrices get the plain INT8 round-trip when ``baseline_int8`` (so
        comparisons isolate StruM's delta on top of the INT8 baseline) or
        pass through untouched.
        """
        from repro_torch.core.apply import fake_quantize_array, int8_baseline_array

        def visit(name, leaf):
            if not isinstance(leaf, torch.Tensor) or leaf.dtype not in _FLOATS:
                return leaf
            entry = self.entries.get(name)
            if entry is None:
                return int8_baseline_array(leaf) if (
                    baseline_int8 and leaf.dim() >= 2
                    and min(leaf.shape[-2:]) >= 2
                    and "embed" not in name.lower()
                ) else leaf
            return fake_quantize_array(leaf, entry.cfg)

        return map_named(visit, params)


def _mesh_layout(mesh, rules):
    """(FSDP axes, TP axis, ``((axis, size), ...)``) of a mesh-aware plan;
    ``((), None, ())`` without a mesh.  The FSDP axes are the rules'
    ``embed`` mapping, as in the reference, kept to the mesh's axes."""
    if mesh is None:
        return (), None, ()
    rules = rules or rules_for_mesh(mesh)
    names = axis_names(mesh)
    emb = rules.table.get("embed")
    fsdp = (tuple(emb) if isinstance(emb, tuple) else (emb,)) if emb \
        else fsdp_axes(mesh)
    return (tuple(a for a in fsdp if a in names),
            "model" if "model" in names else None,
            tuple(axis_sizes(mesh).items()))


def _maybe_validate(plan: ExecutionPlan, validate: bool, params: Any,
                    device) -> ExecutionPlan:
    if not validate:
        return plan
    from repro_torch.analysis import validate_plan
    report = validate_plan(plan, params=params, device=device)
    if report.errors():
        raise ValueError("build_plan(validate=True) failed:\n"
                         + report.render(min_severity="warning"))
    return plan


def build_plan(params: Any, *, schedule: Any = None,
               policy: Optional[LayerPolicy] = None,
               cfg: Optional[StruMConfig] = None,
               backend: Optional[str] = None, scope: str = "model",
               float_only: bool = False, pack: bool = True,
               mesh=None, rules=None,
               validate: bool = False, device="cuda") -> ExecutionPlan:
    """Build an :class:`ExecutionPlan` from ``(params, schedule)``.

    Precedence: ``schedule`` (per-tensor table) > ``policy`` > uniform
    ``cfg`` > repo default.  Expert stacks pack with ``cfg`` whenever it is
    given and no schedule is (the reference's legacy rule); with a
    schedule they follow the schedule.

    Tensors move to ``device`` (default ``"cuda"``; raises without a card
    unless ``device="cpu"``), packing runs there, and ``backend=None`` /
    ``"auto"`` selects by that device: ``cuda:*`` on the card, ``torch:*``
    on the CPU.  ``validate=True`` runs the static plan checks
    (``analysis.validate_plan``, with ``params`` for a schedule's error
    budget) and raises ``ValueError`` on any error finding.

    ``mesh`` (a ``DeviceMesh``, + optional sharding ``rules``) makes the
    plan mesh-aware (the module docstring): each packed leaf becomes this
    rank's block, and ``ExecSpec.shard`` records the layout and the mesh's
    shape.  Folded (``scope="tree"``) leaves have no TP layout: refused.
    """
    if scope not in ("model", "tree"):
        raise ValueError(f"scope={scope!r}")
    if mesh is not None and scope != "model":
        raise ValueError("mesh-aware plans need scope='model': folded "
                         "(scope='tree') leaves have no TP layout")
    dev = resolve_device(device)
    pol = _resolve_policy(schedule, policy, cfg)
    entries: dict[str, PlanEntry] = {}
    fsdp, tp, mesh_shape = _mesh_layout(mesh, rules)

    def _entry(name, leaf, leaf_cfg, layout, packed_leaf, exec_lead=()):
        # exec_lead: lead dims as the kernel sees them (scan groups are
        # sliced away before dispatch; expert stacks keep theirs and select
        # from the grouped family)
        shape = tuple(leaf.shape)
        shard = None
        if fsdp:
            shard = ShardSpec(fsdp_axes=fsdp, lead_axis=tp, mesh_shape=mesh_shape) \
                if exec_lead else ShardSpec(fsdp_axes=fsdp, mesh_shape=mesh_shape,
                                            tp_pattern=_sharded.tp_pattern_for(name))
        info = LeafInfo(k_dim=shape[-2], n_out=shape[-1], lead=exec_lead,
                        name=name, fsdp=fsdp,
                        tp_pattern=shard.tp_pattern if shard else None)
        variant = select_variant(leaf_cfg, info, backend=backend, device=dev)
        e = PlanEntry(name=name, cfg=leaf_cfg, variant=variant.name,
                      shape=shape, leaf=packed_leaf, backend=backend,
                      layout=layout, shard=shard)
        if packed_leaf is not None:
            if shard is not None:     # keep this rank's block of the payload
                packed_leaf.update(_sharded.cut_payload(packed_leaf, shard, mesh))
            packed_leaf["cfg"] = leaf_cfg
            packed_leaf["spec"] = e.spec
        entries[name] = e

    def _float_ok(leaf) -> bool:
        return not float_only or leaf.dtype in _FLOATS

    if scope == "model":
        from repro_torch.models.quantize import _pack_leaf

        def visit(name, leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            leaf = leaf.to(dev)
            is_expert = _is_expert_stack(name)
            if (not name.endswith("/w") and not is_expert) or leaf.dim() < 2 \
                    or not _float_ok(leaf):
                return leaf
            leaf_cfg = pol.resolve(name, tuple(leaf.shape))
            if is_expert and schedule is None and cfg is not None:
                leaf_cfg = cfg      # legacy: experts pack with the uniform cfg
            if leaf_cfg is None:
                return leaf
            packed = _pack_leaf(leaf, leaf_cfg) if pack else None
            _entry(name, leaf, leaf_cfg, "serve", packed,
                   tuple(leaf.shape[:-2]) if is_expert else ())
            return packed if pack else leaf

        out = map_named(visit, params)
        return _maybe_validate(
            ExecutionPlan(entries=entries, params=out, backend=backend,
                          scope="model", schedule=schedule,
                          meta={"fsdp_axes": fsdp} if fsdp else {}),
            validate, params, dev)

    # scope == "tree": flat manifest, column-folded packing
    from repro_torch.core.apply import pack_array

    out = {}
    for name, leaf in _named_leaves(params):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.to(dev)
        leaf_cfg = pol.resolve(name, tuple(getattr(leaf, "shape", ())))
        if leaf_cfg is None or not isinstance(leaf, torch.Tensor) \
                or not _float_ok(leaf):
            out[name] = leaf
            continue
        if pack:
            p = pack_array(leaf, leaf_cfg)
            _entry(name, leaf, leaf_cfg, "folded",
                   {"mask": p.mask, "hi": p.hi, "lo": p.lo, "scale": p.scale})
            out[name] = (p, tuple(leaf.shape))
        else:
            _entry(name, leaf, leaf_cfg, "folded", None)
            out[name] = leaf
    return _maybe_validate(
        ExecutionPlan(entries=entries, params=out, backend=backend, scope="tree",
                      schedule=schedule),
        validate, params, dev)


def fake_quantize(params: Any, *, schedule: Any = None,
                  policy: Optional[LayerPolicy] = None,
                  cfg: Optional[StruMConfig] = None,
                  baseline_int8: bool = True, device="cuda") -> Any:
    """One-shot fake-quant through a selection-only plan (no bit-packing),
    on ``device``: the engine-native replacement for
    ``core.apply.fake_quantize_tree``, with the same eligibility and INT8
    baseline, driven by the same schedule / policy resolution as
    :func:`build_plan`."""
    dev = resolve_device(device)
    params = map_named(lambda _, x: x.to(dev) if isinstance(x, torch.Tensor)
                       else x, params)
    plan = build_plan(params, schedule=schedule, policy=policy, cfg=cfg,
                      scope="tree", float_only=True, pack=False, device=dev)
    return plan.fake_quantize(params, baseline_int8=baseline_int8)
