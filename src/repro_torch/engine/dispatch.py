"""Runtime dispatch: packed leaf (+ recorded variant) -> kernel call (twin
of ``repro.engine.dispatch``).

The one funnel every quantized linear of ``models/`` goes through.  A leaf
built by :func:`repro_torch.engine.build_plan` carries an :class:`ExecSpec`
naming its selected variant; a hand-built leaf (``{"mask", "hi", "lo",
"scale"}`` plus an explicit ``strum`` config) gets one selected on the fly
from the same registry.

With a telemetry recorder active, every call counts
``dispatch/variant/<name>`` and the packed bytes it streams
(``dispatch/packed_bytes``; a ``draft:*`` call counts only its mode's
fields, mirrored under ``spec/draft_packed_bytes``; a ``sharded:*`` call
the payload it gathers, mirrored under
``dispatch/sharded/gathered_packed_bytes``).  The reference counts these
once per leaf per ``jax.jit`` trace; the eager port counts once per call.

With ``mesh=`` a 2-D leaf runs through the registry's ``sharded:*`` family
(:mod:`repro_torch.engine.sharded`): the FSDP all-gather moves the *packed*
payload, and a per-call ``backend=`` still reaches the post-gather kernel.

``accum_dtype`` (default f32) is the reference's ``preferred_element_type``:
the plain routes (``KernelVariant.accum``) round their f32 product to it
before ``out_dtype``; the CUDA kernels ignore it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import telemetry
from repro_torch.core import packing
from repro_torch.core.policy import StruMConfig
from repro_torch.engine.registry import (ExecSpec, LeafInfo, get_variant,
                                         select_variant)

__all__ = ["dispatch", "dispatch_grouped", "apply", "dequant_leaf", "leaf_spec"]


def _draft_mode_of(variant_name: str) -> str:
    """'draft:histream' / 'draft:torch_histream' -> 'histream'."""
    tail = variant_name.split(":", 1)[-1]
    return tail[len("torch_"):] if tail.startswith("torch_") else tail


def _note_dispatch(variant, wleaf: dict, *, sharded: bool = False) -> None:
    """Count one call through ``variant`` into the active recorders: the
    variant, and the packed bytes it streams (mask + hi + lo, or a draft
    mode's subset, also under ``spec/draft_packed_bytes``).  A ``sharded:*``
    call counts the payload as the reference's trace sees it (a 2-D leaf
    whole, a stack as this rank's block), also under
    ``dispatch/sharded/gathered_packed_bytes``."""
    if not telemetry.enabled():
        return
    telemetry.inc(f"dispatch/variant/{variant.name}")
    if sharded:
        payload = sum(wleaf[k].numel() for k in ("mask", "hi", "lo"))
        shard = getattr(wleaf.get("spec"), "shard", None)
        if shard is not None and wleaf["mask"].dim() == 3:    # a 2-D block
            payload *= shard.parts
        telemetry.inc("dispatch/sharded/gathered_packed_bytes", payload)
    elif variant.draft:
        from repro_torch.kernels.ops import draft_field_set
        fields = draft_field_set(_draft_mode_of(variant.name))
        payload = sum(wleaf[k].numel() for k in fields if k in wleaf)
        telemetry.inc("spec/draft_packed_bytes", payload)
    else:
        payload = sum(wleaf[k].numel() for k in ("mask", "hi", "lo") if k in wleaf)
    telemetry.inc("dispatch/packed_bytes", payload)


def leaf_spec(wleaf: dict, strum: Optional[StruMConfig] = None
              ) -> tuple[StruMConfig, Optional[ExecSpec]]:
    """Resolve the (config, spec) of a packed leaf: plan-built leaves carry
    ``spec``, others ``cfg`` or the caller's uniform ``strum`` config."""
    spec = wleaf.get("spec")
    if spec is not None:
        return spec.cfg, spec
    cfg = wleaf.get("cfg", strum)
    if cfg is None:
        raise ValueError("compressed leaf needs an embedded spec/cfg or an "
                         "explicit strum config")
    return cfg, None


def _as_packed(wleaf: dict, cfg: StruMConfig, k_dim: int) -> packing.PackedStruM:
    return packing.PackedStruM(
        method=cfg.method, w=cfg.w, n_low=cfg.n_low, q=cfg.q, L=cfg.L,
        k_dim=k_dim, scale=wleaf["scale"], mask=wleaf["mask"], hi=wleaf["hi"],
        lo=wleaf["lo"])


def _check_k(spec: Optional[ExecSpec], k_dim: int) -> None:
    """A plan-built leaf records its true reduction dim: a mismatched x
    would otherwise contract against a truncated or padded weight."""
    if spec is not None and spec.k_dim is not None and spec.k_dim != k_dim:
        raise ValueError(f"x K={k_dim} does not match the leaf's recorded "
                         f"reduction dim K={spec.k_dim}")


def _pick(cfg: StruMConfig, info: LeafInfo, spec: Optional[ExecSpec],
          backend: Optional[str], device):
    """A per-call ``backend`` overrides the plan's recorded selection;
    without one, the spec's variant is authoritative -- unless its
    sharded-ness disagrees with the call's mesh context (``info.fsdp``):
    then it is re-selected under the plan's backend, so a mesh-aware plan
    serves without a mesh (a 1x1 one) and a mesh-less plan serves on a
    mesh.  The override stays inside a draft leaf's partition: it never
    promotes a draft leaf to full fidelity."""
    if spec is None:
        return select_variant(cfg, info, backend=backend, device=device)
    recorded = get_variant(spec.variant)
    if backend is None:
        if recorded.sharded == bool(info.fsdp):
            return recorded
        backend = spec.backend
    if recorded.draft and not info.draft:
        info = info._replace(draft=_draft_mode_of(spec.variant))
    return select_variant(cfg, info, backend=backend, device=device)


def _sharded_call(wleaf: dict, x: torch.Tensor, cfg: StruMConfig,
                  spec: Optional[ExecSpec], info: LeafInfo, *, mesh,
                  pattern: Optional[str], backend: Optional[str], out_dtype,
                  accum_dtype=torch.float32, rows=None, k_dim=None,
                  spmd: bool = False, local_rows: bool = False) -> torch.Tensor:
    """Select and invoke a ``sharded:*`` variant: the one implementation
    behind the 2-D mesh branch of :func:`dispatch` and the ``fsdp_axes``
    branch of :func:`dispatch_grouped`."""
    variant = _pick(cfg, info, spec, backend, x.device)
    _note_dispatch(variant, wleaf, sharded=True)
    eff_backend = backend if backend is not None else (
        spec.backend if spec is not None else None)
    kw = {"rows": rows} if variant.grouped else {"spmd": spmd, "local_rows": local_rows}
    return variant.fn(wleaf, x, cfg=cfg, mesh=mesh, fsdp=tuple(info.fsdp),
                      pattern=pattern, k_dim=k_dim or x.shape[-1],
                      backend=eff_backend, out_dtype=out_dtype,
                      accum_dtype=accum_dtype, **kw)


def _check_whole(spec: Optional[ExecSpec]) -> None:
    """A leaf cut into blocks by a mesh-aware plan serves only on its mesh."""
    shard = getattr(spec, "shard", None)
    if shard is not None and shard.parts > 1:
        raise ValueError(
            f"the leaf holds one of {shard.parts} blocks of a mesh-aware plan "
            f"(mesh {dict(shard.mesh_shape)}); pass mesh=")


def dispatch(wleaf: dict, x: torch.Tensor, *,
             strum: Optional[StruMConfig] = None,
             backend: Optional[str] = None, out_dtype=None,
             accum_dtype=torch.float32, mesh=None, tp_mesh=None,
             tp_pattern: Optional[str] = None, spmd: bool = False,
             local_rows: bool = False) -> torch.Tensor:
    """y = x @ dequant(leaf) through the leaf's selected kernel variant.

    ``x``: (..., K); returns (..., N) in ``out_dtype`` (default x.dtype).
    Stacked leaves (lead dims: MoE expert stacks) go to
    :func:`dispatch_grouped`; ``x`` then carries the matching lead dims.

    With ``mesh`` (``tp_mesh`` is the alias the model forwards thread) a
    2-D leaf runs through the ``sharded:*`` family: ``x`` and the result are
    global, the leaf this rank's block (mesh-aware plans) or global.  The TP
    layout comes from ``tp_pattern`` or the leaf's ``spec.shard``.  As in
    the reference: a stacked leaf with a mesh raises (its collectives run
    inside the MoE body), a mesh without a TP layout raises, and a mesh with
    no FSDP axis serves the local path.  With ``spmd`` (the sharded serving
    layout) ``x`` and the result are this rank's blocks instead, as the
    reference's ``shard_map`` in and out specs hold them: the rows this
    rank holds, a row leaf's ``x`` its block of K over ``model``, a col
    leaf's result its block of N.  With ``local_rows`` (the paged layout)
    ``x`` and the result are this rank's rows with every feature.
    """
    cfg, spec = leaf_spec(wleaf, strum)
    out_dtype = out_dtype or x.dtype
    mesh = mesh if mesh is not None else tp_mesh
    shard = getattr(spec, "shard", None)
    pattern = tp_pattern or (shard.tp_pattern if shard is not None else None)
    spmd = spmd and mesh is not None
    k_dim = x.shape[-1]
    if spmd and pattern == "row":
        from repro_torch.models.sharding import axis_names, axis_size
        if "model" in axis_names(mesh):
            k_dim *= axis_size(mesh, "model")
    _check_k(spec, k_dim)
    if wleaf["mask"].dim() > 3:
        if mesh is not None:
            # going local would gather the DEQUANTIZED stack, the regression
            # the sharded:* family exists to prevent
            raise ValueError(
                "stacked (expert) leaves take the distributed path inside the "
                "MoE shard_map body: use models.moe.moe_apply(..., mesh=...) or "
                "dispatch_grouped(..., fsdp_axes=..., mesh=...) from within the "
                "body, not dispatch(mesh=...)")
        return dispatch_grouped(wleaf, x, strum=strum, backend=backend,
                                out_dtype=out_dtype, accum_dtype=accum_dtype)
    if mesh is not None:
        if pattern is None:
            raise ValueError(
                "dispatch(mesh=...) on a 2-D leaf needs a TP layout: pass "
                "tp_pattern='col'|'row', or build the plan mesh-aware "
                "(build_plan(..., mesh=...)) so the leaf's spec records it")
        from repro_torch.models.sharding import axis_names, fsdp_axes
        fsdp = tuple(a for a in (shard.fsdp_axes if shard is not None and
                                 shard.fsdp_axes else fsdp_axes(mesh))
                     if a in axis_names(mesh))
        if fsdp:      # a mesh with no FSDP axis (TP-only) serves the local path
            info = LeafInfo(k_dim=k_dim, n_out=wleaf["scale"].shape[-1],
                            fsdp=fsdp, tp_pattern=pattern)
            return _sharded_call(wleaf, x, cfg, spec, info, mesh=mesh,
                                 pattern=pattern, backend=backend,
                                 out_dtype=out_dtype, accum_dtype=accum_dtype,
                                 k_dim=k_dim, spmd=spmd, local_rows=local_rows)
        if spmd:
            raise ValueError("the sharded serving layout needs an FSDP axis on "
                             "the mesh")
    _check_whole(spec)
    info = LeafInfo(k_dim=k_dim, n_out=wleaf["scale"].shape[-1])
    variant = _pick(cfg, info, spec, backend, x.device)
    _note_dispatch(variant, wleaf)
    packed = _as_packed(wleaf, cfg, k_dim)
    lead = tuple(x.shape[:-1])
    y = variant.fn(x.reshape(-1, k_dim), packed, out_dtype=out_dtype,
                   **({"accum_dtype": accum_dtype} if variant.accum else {}))
    return y.reshape(lead + (y.shape[-1],))


def dispatch_grouped(wleaf: dict, x: torch.Tensor, *,
                     strum: Optional[StruMConfig] = None,
                     backend: Optional[str] = None, out_dtype=None,
                     accum_dtype=torch.float32, fsdp_axes=None, mesh=None,
                     rows=None, device=None) -> torch.Tensor:
    """Batched y[..., c, n] = x[..., c, :] @ dequant(leaf[...]) for stacks.

    ``x``: (lead..., C, K), ``lead`` the leaf's stack dims -- e.g. MoE expert
    buffers (E, C, D) against a packed (E, D, F) stack.  A ``grouped``
    selection (``cuda:grouped*``, K6-K8) streams the packed stack; any other
    (the ``torch:dequant`` fallback) dequantizes the stack at its *true* K
    to x's dtype and runs a batched matmul accumulated in f32.

    ``rows`` (lead...) int on x's device, optional: the live rows of each
    stack (x is zero past them).  ``cuda:grouped`` (K6),
    ``cuda:grouped_maskfree`` (K7) and ``cuda:grouped_dense`` (K8) skip the
    work past them; the other variants ignore it, with the same result.

    ``fsdp_axes`` marks a call from inside the MoE body whose stack is this
    rank's block, its packed block axis still FSDP-sharded over those axes
    of ``mesh``: selection then goes to the ``sharded:*`` family, and
    ``sharded:grouped_gather`` all-gathers the *packed* stack and
    re-dispatches here on the gathered form with the same backend.
    ``device`` is the device ``backend=None`` selects for (default x's:
    the dry-run's ``meta`` tensors pass the device they stand for).
    """
    cfg, spec = leaf_spec(wleaf, strum)
    lead_dims = wleaf["mask"].dim() - 3
    if lead_dims == 0:
        return dispatch(wleaf, x, strum=strum, backend=backend, out_dtype=out_dtype,
                        accum_dtype=accum_dtype)
    lead = tuple(wleaf["mask"].shape[:lead_dims])
    if x.dim() != lead_dims + 2 or tuple(x.shape[:lead_dims]) != lead:
        raise ValueError(
            f"stacked leaf with lead dims {lead} needs x of shape "
            f"(*lead, C, K); got {tuple(x.shape)}")
    k_dim = x.shape[-1]
    out_dtype = out_dtype or x.dtype
    if fsdp_axes:
        if mesh is None:
            raise ValueError("dispatch_grouped(fsdp_axes=...) gathers over a "
                             "mesh's groups: pass mesh=")
        # the leaf is a block (its nb still FSDP-split): the recorded k_dim
        # applies after the gather
        info = LeafInfo(k_dim=k_dim, n_out=wleaf["scale"].shape[-1], lead=lead,
                        fsdp=tuple(fsdp_axes))
        return _sharded_call(wleaf, x, cfg, spec, info, mesh=mesh, pattern=None,
                             backend=backend, out_dtype=out_dtype,
                             accum_dtype=accum_dtype, rows=rows)
    _check_k(spec, k_dim)
    _check_whole(spec)
    info = LeafInfo(k_dim=k_dim, n_out=wleaf["scale"].shape[-1], lead=lead)
    variant = _pick(cfg, info, spec, backend, x.device if device is None else device)
    _note_dispatch(variant, wleaf)
    if variant.grouped:
        return variant.fn(x, _as_packed(wleaf, cfg, k_dim), out_dtype=out_dtype,
                          rows=rows)
    wd = dequant_leaf(wleaf, x.dtype, cfg=cfg, k_dim=k_dim)
    return torch.matmul(x.to(torch.float32), wd.to(torch.float32)).to(
        accum_dtype).to(out_dtype)


def apply(plan, name: str, x: torch.Tensor, *, backend: Optional[str] = None,
          **kw) -> torch.Tensor:
    """Name-keyed plan execution: y = x @ dequant(plan[name]); stacked
    entries (MoE expert stacks) take x with the matching lead dims."""
    return dispatch(plan.entries[name].leaf, x, backend=backend, **kw)


def dequant_leaf(wleaf, dtype=torch.bfloat16, cfg: Optional[StruMConfig] = None,
                 k_dim: Optional[int] = None) -> torch.Tensor:
    """Decompress a (possibly stacked) packed leaf to dense weights; a dense
    leaf passes through.

    The true K comes from ``k_dim``, else the leaf's spec (plan-built leaves
    record it), else -- hand-built leaves only -- the padded payload
    (``nb * w``), which is right only when ``K % w == 0``: padding rows
    decode to junk (MIP2Q code 0 is +-1), so plan-built stacks always carry
    the exact K.  A stack ``(lead..., nb, rows, N)`` decodes in one call
    with its groups folded into the column axis (every column decodes on
    its own), then unfolds to ``(lead..., K, N)``.
    """
    if not isinstance(wleaf, dict):
        return wleaf
    cfg, spec = leaf_spec(wleaf, cfg)
    if k_dim is None:
        k_dim = getattr(spec, "k_dim", None)
    if k_dim is None:
        k_dim = wleaf["mask"].shape[-3] * cfg.w
    lead_dims = wleaf["mask"].dim() - 3
    lead = tuple(wleaf["mask"].shape[:lead_dims])
    g = math.prod(lead)

    n = wleaf["scale"].shape[-1]

    def fold(a):   # (lead..., r, c, N) -> (r, c, g * N); no -1: 0-row fields
        a = a.reshape((g,) + tuple(a.shape[lead_dims:]))
        return a.permute(1, 2, 0, 3).reshape(a.shape[1], a.shape[2], g * n)

    folded = packing.PackedStruM(
        method=cfg.method, w=cfg.w, n_low=cfg.n_low, q=cfg.q, L=cfg.L,
        k_dim=k_dim, scale=wleaf["scale"].reshape(1, g * n),
        mask=fold(wleaf["mask"]), hi=fold(wleaf["hi"]), lo=fold(wleaf["lo"]))
    wd = packing.dequantize(folded, dtype)                   # (K, g * N)
    return wd.reshape(k_dim, g, n).permute(1, 0, 2).reshape(lead + (k_dim, n))
