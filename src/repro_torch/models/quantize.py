"""Model-level StruM packing in the serving layout (twin of
``repro.models.quantize``): ``_pack_leaf``, ``strum_serve_params``,
``serve_tree_bytes`` and ``packed_model_defs``, the packed model's
``ParamDef`` tree that the dry-run (``launch.specs``) builds its stand-ins
and partition specs from."""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from repro_torch.core import blocking, packing
from repro_torch.core.policy import LayerPolicy, StruMConfig, default_policy
from repro_torch.core.quantizers import int8_symmetric, quantize_blocks

__all__ = ["strum_serve_params", "serve_tree_bytes", "packed_model_defs"]


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


def packed_model_defs(cfg, policy: Optional[LayerPolicy] = None) -> dict:
    """``ParamDef`` tree of the model packed under ``cfg.strum``: exact
    payload shapes, dtypes and logical axes, nothing allocated.

    Every eligible linear ``{"w": ParamDef(..., (..., in_ax, out_ax))}``
    becomes ``{"w": {"mask", "hi", "lo", "scale"}}`` with the in-axis moved
    to the block dim (nb = ceil(K / w)) and the out-axis kept; MoE expert
    stacks pack the same way with their lead dims, whatever the policy says
    of them (``engine.build_plan``'s rule for a uniform config).  The
    shapes are ``build_plan``'s, except that an empty field (sparsity's lo,
    hi at p = 1) keeps the reference's one-row floor: the row the kernels
    are handed (``kernels.ops._min1``), where the plan stores 0 rows."""
    from repro_torch.core.apply import map_named
    from repro_torch.models import model_defs
    from repro_torch.models.params import ParamDef
    scfg = cfg.strum
    if scfg is None:
        raise ValueError("packed_model_defs needs cfg.strum")
    policy = policy or default_policy(scfg)

    def visit(name, leaf):
        is_expert = "/moe/" in name and name.rsplit("/", 1)[-1] in ("wi", "wg", "wo")
        if (not name.endswith("/w") and not is_expert) or len(leaf.shape) < 2:
            return leaf
        if not is_expert and policy.resolve(name, leaf.shape) is None:
            return leaf
        lead, (k_dim, n) = leaf.shape[:-2], leaf.shape[-2:]
        la, (in_ax, out_ax) = leaf.axes[:-2], leaf.axes[-2:]
        nb = blocking.num_blocks(k_dim, scfg.w)
        mb, nh, lb = packing.field_dims(scfg.w, scfg.n_low, scfg.q, scfg.method)

        def field(rows, dtype):
            return ParamDef(lead + (nb, max(rows, 1), n), la + (in_ax, None, out_ax),
                            dtype=dtype, init="zeros")
        return {"mask": field(mb, "uint8"), "hi": field(nh, "int8"),
                "lo": field(lb, "uint8"),
                "scale": ParamDef(lead + (1, n), la + (None, out_ax),
                                  dtype="float32", init="zeros")}
    return map_named(visit, model_defs(cfg))


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
