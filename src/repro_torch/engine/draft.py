"""Draft plans: reduced-fidelity views of a full-fidelity ExecutionPlan (twin
of ``repro.engine.draft``).

StruM's packed payload encodes a family of fidelity levels: the mask, hi
and lo streams can be read selectively, so a self-speculative draft model
costs no second checkpoint and no extra device memory.  A
:class:`DraftPolicy` names, per leaf, which reduced decode runs:

``histream``    skip the lo stream: hi values land at their masked
                positions, low positions decode to zero (K9).
``maskfree_p``  skip mask and lo: hi values fill the leading block
                positions (K10).  Cheapest and lossiest.
``full``        per-leaf escape hatch: keep the target spec.

:func:`build_draft_plan` derives a new :class:`ExecutionPlan` whose param
tree shares every payload tensor with the target plan (shallow-copied leaf
dicts, only ``spec`` differs), so the draft's tensors have the target's
``untyped_storage().data_ptr()``.  Leaves no draft variant expresses
(stacked expert payloads, ``w % 8 != 0`` under ``histream``, configs with
no high values) keep full fidelity: the draft is exact there.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import packing
from repro_torch.core.apply import map_named
from repro_torch.core.packing import _scatter_expand, _unpack_bits_axis1
from repro_torch.engine.dispatch import _as_packed, dequant_leaf
from repro_torch.engine.registry import ExecSpec, LeafInfo, select_variant
from repro_torch.kernels.ops import DRAFT_MODES, draft_field_set

__all__ = ["DraftPolicy", "build_draft_plan", "draft_dequant_packed",
           "draft_dequant_leaf", "draft_leaf_bytes", "draft_plan_bytes",
           "DRAFT_MODES"]


@dataclasses.dataclass(frozen=True)
class DraftPolicy:
    """Which reduced-fidelity decode each leaf runs in the draft lane.

    ``mode`` is the default for every eligible leaf; ``overrides`` is a
    tuple of ``(substring, mode)`` pairs matched against the leaf's path
    name, first hit wins; ``"full"`` (or ``""``) pins a leaf to the target
    spec.
    """

    mode: str = "histream"
    overrides: tuple = ()

    def __post_init__(self):
        for m in (self.mode,) + tuple(m for _, m in self.overrides):
            if m not in DRAFT_MODES + ("full", ""):
                raise ValueError(f"unknown draft mode {m!r}; want one of "
                                 f"{DRAFT_MODES + ('full',)}")

    def resolve(self, name: str) -> str:
        """The draft mode for ``name`` ('' = keep full fidelity)."""
        for pat, m in self.overrides:
            if pat in name:
                return "" if m in ("", "full") else m
        return "" if self.mode in ("", "full") else self.mode


def draft_dequant_packed(packed: packing.PackedStruM, mode: str,
                         dtype=torch.float32) -> torch.Tensor:
    """Plain draft decode of a 2-D packed leaf, ``(K, N)`` in ``dtype``:
    reads only the fields ``draft_field_set(mode)`` names (plus scale)."""
    w, n = packed.w, packed.n_out
    nb = packed.hi.shape[0]
    if packed.n_low >= w:
        raise ValueError(f"draft modes need high values to stream "
                         f"(n_low={packed.n_low} w={w})")
    hv = packed.hi.to(torch.float32)
    if mode == "histream":
        vals = _scatter_expand(hv, _unpack_bits_axis1(packed.mask, w))
    elif mode == "maskfree_p":
        vals = torch.cat([hv, hv.new_zeros((nb, w - hv.shape[1], n))], dim=1)
    else:
        raise ValueError(f"unknown draft mode {mode!r}; "
                         f"want one of {DRAFT_MODES}")
    wd = vals.reshape(nb * w, n) * packed.scale
    return wd[:packed.k_dim].to(dtype)


def _leaf_packed(leaf: dict, cfg=None, k_dim: Optional[int] = None
                 ) -> packing.PackedStruM:
    spec = leaf.get("spec")
    cfg = cfg or (spec.cfg if spec is not None else leaf.get("cfg"))
    if k_dim is None:
        k_dim = spec.k_dim if spec is not None and spec.k_dim else \
            leaf["mask"].shape[-3] * cfg.w
    return _as_packed(leaf, cfg, k_dim)


def draft_dequant_leaf(leaf: dict, mode: str, dtype=torch.float32, cfg=None,
                       k_dim: Optional[int] = None) -> torch.Tensor:
    """Draft decode of a packed leaf dict (mode '' = the full decode).
    Stacked payloads (lead dims) decode group by group."""
    if not mode:
        return dequant_leaf(leaf, dtype, cfg=cfg, k_dim=k_dim)
    lead_dims = leaf["mask"].dim() - 3
    if lead_dims == 0:
        return draft_dequant_packed(_leaf_packed(leaf, cfg, k_dim), mode, dtype)
    lead = tuple(leaf["mask"].shape[:lead_dims])
    g = 1
    for d in lead:
        g *= d
    fields = {k: leaf[k].reshape((g,) + tuple(leaf[k].shape[lead_dims:]))
              for k in ("mask", "hi", "lo", "scale")}
    dq = torch.stack([draft_dequant_packed(
        _leaf_packed({**leaf, **{k: f[i] for k, f in fields.items()}}, cfg, k_dim),
        mode, dtype) for i in range(g)])
    return dq.reshape(lead + tuple(dq.shape[1:]))


def draft_leaf_bytes(leaf: dict, mode: str) -> int:
    """Payload bytes a draft-mode read of this leaf streams (mode '' = the
    full mask + hi + lo payload).  uint8/int8 fields: elements are bytes."""
    fields = draft_field_set(mode) if mode else ("mask", "hi", "lo")
    return int(sum(leaf[k].numel() for k in fields))


def _is_packed_leaf(node) -> bool:
    return isinstance(node, dict) and "mask" in node and "hi" in node


def _map_packed(fn, tree):
    """Map ``fn(name, leaf)`` over the packed leaves of a tree, named and
    visited as plan entries are; everything else passes through."""
    return map_named(lambda name, node: fn(name, node)
                     if _is_packed_leaf(node) else node,
                     tree, is_leaf=_is_packed_leaf)


def build_draft_plan(plan, policy: Optional[DraftPolicy] = None):
    """Derive the draft-fidelity twin of a full-fidelity plan.

    Returns a new :class:`~repro_torch.engine.plan.ExecutionPlan` whose
    ``params`` tree is the target's with every drafted leaf shallow-copied:
    the payload tensors (mask/hi/lo/scale) are the same objects as the
    target's, only ``spec`` swaps to a ``draft:*`` variant.
    ``meta["draft"]`` records the per-leaf mode map ('' = full fidelity).
    """
    from repro_torch.engine.plan import ExecutionPlan, _is_expert_stack

    policy = policy or DraftPolicy()
    modes: dict = {}
    new_entries = dict(plan.entries)

    def visit(name, leaf):
        entry = plan.entries.get(name)
        mode = policy.resolve(name) if entry is not None else ""
        if entry is not None:
            modes[name] = mode
        if not mode:
            return leaf
        # layer-group stacks are sliced to 2-D before dispatch; only expert
        # stacks dispatch with a live lead dim
        lead = tuple(entry.shape[:-2]) if _is_expert_stack(name) else ()
        info = LeafInfo(k_dim=entry.shape[-2], n_out=entry.shape[-1],
                        lead=lead, name=name, draft=mode)
        try:
            variant = select_variant(entry.cfg, info, backend=plan.backend,
                                     device=leaf["mask"].device)
        except LookupError:
            modes[name] = ""              # no draft lowering: stay exact
            return leaf
        spec = ExecSpec(cfg=entry.cfg, variant=variant.name,
                        backend=plan.backend, k_dim=entry.shape[-2])
        new = {**leaf, "spec": spec}      # payload tensors shared
        new_entries[name] = dataclasses.replace(entry, variant=variant.name,
                                                leaf=new)
        return new

    params = _map_packed(visit, plan.params)
    meta = dict(plan.meta, draft=modes,
                draft_policy={"mode": policy.mode,
                              "overrides": [list(o) for o in policy.overrides]})
    return ExecutionPlan(entries=new_entries, params=params,
                         backend=plan.backend, scope=plan.scope,
                         schedule=plan.schedule, meta=meta)


def draft_plan_bytes(plan) -> dict:
    """{'draft_bytes', 'full_bytes', 'ratio'} of a draft plan's weight reads
    per full read: the cost ratio of a draft step bound by bytes."""
    modes = plan.meta.get("draft", {})
    totals = {"draft": 0, "full": 0}

    def visit(name, leaf):
        totals["full"] += draft_leaf_bytes(leaf, "")
        totals["draft"] += draft_leaf_bytes(leaf, modes.get(name, ""))
        return leaf

    _map_packed(visit, plan.params)
    draft_b, full_b = totals["draft"], totals["full"]
    return {"draft_bytes": int(draft_b), "full_bytes": int(full_b),
            "ratio": draft_b / full_b if full_b else 1.0}
