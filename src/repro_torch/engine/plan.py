"""Execution plans: build once from ``(params, cfg | policy)``, serve many
(twin of ``repro.engine.plan`` for ``scope="model"``).

For every packed linear the plan records the payload *and* the kernel
variant selected from the registry.  ``plan.params`` is the model-shaped
tree the forward consumes: each eligible ``.../w`` weight and each MoE
expert stack (``.../moe/wi|wg|wo``) becomes ``{"mask", "hi", "lo",
"scale", "cfg", "spec"}`` with its lead dims kept on every payload field.
Scan-group lead dims are sliced away before dispatch, so 2-D weights
select a 2-D variant; expert stacks keep their expert dim and select from
the grouped family (``cuda:grouped*``, K6-K8).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import packing
from repro_torch.core.policy import LayerPolicy, StruMConfig, default_policy
from repro_torch.engine import variants as _variants  # noqa: F401  (registration)
from repro_torch.engine.registry import ExecSpec, LeafInfo, select_variant

__all__ = ["PlanEntry", "ExecutionPlan", "build_plan"]


def _is_expert_stack(name: str) -> bool:
    return "/moe/" in name and name.rsplit("/", 1)[-1] in ("wi", "wg", "wo")


@dataclasses.dataclass
class PlanEntry:
    """One quantized leaf: config + selected variant + packed payload."""

    name: str
    cfg: StruMConfig
    variant: str
    shape: tuple                      # original dense shape
    leaf: dict                        # packed tensors + cfg + spec
    backend: Optional[str] = None

    @property
    def spec(self) -> ExecSpec:
        return ExecSpec(cfg=self.cfg, variant=self.variant,
                        backend=self.backend, k_dim=self.shape[-2])

    def as_packed(self) -> packing.PackedStruM:
        """The 2-D :class:`PackedStruM` view of a lead-free entry."""
        if len(self.shape) > 2:
            raise ValueError(f"{self.name!r} is a stacked leaf (lead dims "
                             f"{self.shape[:-2]}); slice a group first")
        cfg = self.cfg
        return packing.PackedStruM(
            method=cfg.method, w=cfg.w, n_low=cfg.n_low, q=cfg.q, L=cfg.L,
            k_dim=self.shape[-2], scale=self.leaf["scale"],
            mask=self.leaf["mask"], hi=self.leaf["hi"], lo=self.leaf["lo"])

    def payload_bytes(self) -> int:
        return int(sum(self.leaf[k].numel() for k in ("mask", "hi", "lo")))


@dataclasses.dataclass
class ExecutionPlan:
    """Per-leaf packed payloads + selected kernel variants, built once."""

    entries: dict
    params: Any
    backend: Optional[str] = None
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
        return {"n_entries": len(self.entries), "backend": self.backend or "auto",
                "scope": "model", "variant_distribution": dist,
                "packed_payload_bytes": sum(e.payload_bytes()
                                            for e in self.entries.values())}


def _map_named(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """Map ``fn(name, leaf)`` over a nested dict; names are ``/``-joined keys,
    as the reference's path names are."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def build_plan(params: Any, *, policy: Optional[LayerPolicy] = None,
               cfg: Optional[StruMConfig] = None, backend: Optional[str] = None,
               device="cuda") -> ExecutionPlan:
    """Pack every eligible ``.../w`` linear and MoE expert stack of a model
    tree and select its variant.  Precedence: ``policy`` > uniform ``cfg``
    > repo default, except that expert stacks pack with ``cfg`` whenever it
    is given (the reference's legacy rule).

    Tensors move to ``device`` (default ``"cuda"``; raises without a card
    unless ``device="cpu"``), packing runs there, and ``backend=None`` /
    ``"auto"`` selects by that device: ``cuda:*`` on the card, ``torch:*``
    on the CPU.
    """
    dev = resolve_device(device)
    pol = policy if policy is not None else default_policy(cfg)
    entries: dict[str, PlanEntry] = {}

    def visit(name, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        leaf = leaf.to(dev)
        is_expert = _is_expert_stack(name)
        if (not name.endswith("/w") and not is_expert) or leaf.dim() < 2:
            return leaf
        leaf_cfg = pol.resolve(name, tuple(leaf.shape))
        if is_expert and cfg is not None:
            leaf_cfg = cfg      # legacy: experts pack with the uniform cfg
        if leaf_cfg is None:
            return leaf
        from repro_torch.models.quantize import _pack_leaf
        shape = tuple(leaf.shape)
        # lead dims as the kernel sees them: scan groups are sliced away
        # before dispatch (2-D), expert stacks keep theirs (grouped family)
        info = LeafInfo(k_dim=shape[-2], n_out=shape[-1],
                        lead=shape[:-2] if is_expert else (), name=name)
        variant = select_variant(leaf_cfg, info, backend=backend, device=dev)
        packed = _pack_leaf(leaf, leaf_cfg)
        e = PlanEntry(name=name, cfg=leaf_cfg, variant=variant.name,
                      shape=shape, backend=backend, leaf=packed)
        entries[name] = e
        packed["cfg"] = leaf_cfg
        packed["spec"] = e.spec
        return packed

    out = _map_named(visit, params)
    return ExecutionPlan(entries=entries, params=out, backend=backend)
