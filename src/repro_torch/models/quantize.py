"""Model-level StruM packing in the serving layout (twin of ``_pack_leaf``,
``strum_serve_params`` and ``serve_tree_bytes`` of
``repro.models.quantize``).  ``packed_model_defs`` (dry-run ParamDefs with
sharding axes) waits for the launch dry-run tools."""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from repro_torch.core import blocking, packing
from repro_torch.core.policy import LayerPolicy, StruMConfig
from repro_torch.core.quantizers import int8_symmetric, quantize_blocks

__all__ = ["strum_serve_params", "serve_tree_bytes"]


def _pack_leaf(wt: torch.Tensor, scfg: StruMConfig) -> dict:
    """(..., K, N) kernel -> packed fields with lead dims preserved, so the
    forward slices scan groups out of every field as it slices dense ones."""
    lead = tuple(wt.shape[:-2])
    k, n = wt.shape[-2:]
    packed = []
    for w in wt.reshape((-1, k, n)):
        codes, scale = int8_symmetric(w, axis=0)
        qb = quantize_blocks(blocking.to_blocks(codes, scfg.w), scfg.method,
                             scfg.n_low, q=scfg.q, L=scfg.L)
        p = packing.pack(qb, method=scfg.method, scale=scale, k_dim=k,
                         n_low=scfg.n_low, q=scfg.q, L=scfg.L)
        packed.append({"mask": p.mask, "hi": p.hi, "lo": p.lo, "scale": p.scale})
    return {key: torch.stack([p[key] for p in packed]).reshape(
        lead + tuple(packed[0][key].shape)) for key in packed[0]}


def strum_serve_params(params, cfg, policy: Optional[LayerPolicy] = None,
                       schedule=None, device="cuda"):
    """Deprecated shim over :func:`repro_torch.engine.build_plan`: returns
    ``build_plan(...).params``, the model-shaped served tree on ``device``.

    Without a ``schedule`` every eligible kernel gets the uniform
    ``cfg.strum``; with one (a :class:`repro_torch.autotune.StruMSchedule`,
    e.g. loaded from disk) each tensor gets its own config, embedded with
    its selected variant in the packed leaf.
    """
    warnings.warn(
        "strum_serve_params is deprecated; use repro_torch.engine.build_plan "
        "(the ExecutionPlan also records per-leaf kernel variants)",
        DeprecationWarning, stacklevel=2)
    scfg = cfg.strum
    if scfg is None and schedule is None:
        raise ValueError("set cfg.strum or pass a schedule")
    from repro_torch.engine import build_plan
    return build_plan(params, schedule=schedule,
                      policy=policy if schedule is None else None,
                      cfg=scfg, device=device).params


def serve_tree_bytes(params) -> int:
    """Bytes of every tensor in a (possibly packed) parameter tree; a packed
    leaf of a mesh-aware plan (this rank's block) counts as its whole."""
    if isinstance(params, dict):
        shard = getattr(params.get("spec"), "shard", None)
        if shard is not None and shard.mesh_shape:
            from repro_torch.engine.sharded import field_parts
            parts = field_parts(shard)
            return sum(serve_tree_bytes(v) * parts.get(k, 1) for k, v in params.items())
        return sum(serve_tree_bytes(v) for v in params.values())
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return 0
