"""The ``sharded:*`` kernel-variant family (twin of ``repro.engine.sharded``):
distributed execution as registry entries, gathering *packed* payloads.

StruM's economics (paper Eq. 1/2) come from moving compressed weight bytes;
on a mesh the bytes that matter are the FSDP all-gather.  Every variant here
gathers the packed payloads -- mask / hi / lo at ~r x int8 -- and only then
does the math:

``sharded:gather_dequant``  gather packed, dequantize this rank's block, a
                            plain f32 matmul (the portable path, ``torch``
                            family).
``sharded:gather_pallas``   gather packed and run the registry-selected 2-D
                            kernel on the gathered payload: K1-K3 on the
                            card, the ``torch`` family on the CPU; decode
                            happens after the gather, so wire and memory
                            traffic stay at the Eq.-1/2 ratio (``cuda``
                            family; the reference's name is kept).
``sharded:grouped_gather``  the same for expert stacks, from inside the MoE
                            body: all-gather the packed stack along the FSDP
                            axes, then re-dispatch to the grouped family
                            (K6-K8 on the card).

Three contracts, one per layout (:mod:`repro_torch.models.sharding`).  In
the replicated layout activations ``x`` arrive global (replicated on every
rank) and the result leaves global (``gather_out``).  In the paged layout
(``local_rows=True``) ``x`` is this rank's rows, which differ between data
ranks, and the result is the same rows with every feature: the token rows
are not split again over the FSDP axes.  In the sharded
serving layout (``spmd=True``) ``x`` arrives at the reference's ``x_spec``
and ``y`` leaves at its ``y_spec``, as its ``shard_map`` holds them: the
rows this rank holds (the batch over the data axes; they are the token
rows' FSDP split), a row leaf's ``x`` also its block of K over ``model``;
a col result keeps its block of N over ``model`` (``P(m_ax, tp)``), a row
result is whole after the all-reduce.  Nothing is then sliced or
gathered back.  A leaf
from a mesh-aware plan already holds this rank's block of the payload
(``ExecSpec.shard``); any other leaf is global and is cut to the block
first, as ``shard_map``'s ``in_specs`` would.  TP layouts as in the
reference:

'col' (wq/wk/wv, mlp wi/wg, ssm in_proj): K FSDP-sharded (payload axis 0),
    N over ``model``; the token rows M split over the FSDP axes (padded by
    :func:`_pick_m_pad`), the output's N gathers over ``model``.
'row' (attn wo, mlp wo, ssm out_proj): K over ``model``, N FSDP-sharded
    (payload axis 2, and the per-N scales); the K-partials all-reduce over
    ``model`` (Megatron row-parallel).

On a CPU tensor the post-gather selection resolves the ``cuda`` family to
the ``torch`` family, the CPU's plain path; on the card it keeps the
caller's backend, so a per-call ``backend=`` reaches the post-gather kernel.
The dry-run's ``meta`` tensors on an abstract mesh select as on the device
the mesh stands for (``AbstractMesh.target``).  ``accum_dtype`` reaches the
plain routes (``gather_dequant``'s product, which its collectives then
carry, and a plain post-gather variant), as in the reference; the kernels
ignore it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import packing
from repro_torch.core.policy import StruMConfig
from repro_torch.engine.registry import (LeafInfo, list_variants, register_kernel,
                                         resolve_backend, select_variant)
from repro_torch.models import sharding as shd

__all__ = ["gather_dequant_leaf", "tp_pattern_for", "dense_gather_bytes",
           "payload_specs", "cut_payload", "local_payload", "stack_at_rest"]

FIELDS = ("mask", "hi", "lo")
_ROW_NAMES = ("wo", "out_proj")


def tp_pattern_for(name: str) -> str:
    """TP layout of a 2-D linear from its parameter path name: ``wo`` /
    ``out_proj`` contract a model-sharded K ('row'), everything else
    produces a model-sharded N ('col')."""
    parts = name.split("/")
    owner = parts[-2] if len(parts) >= 2 and parts[-1] == "w" else parts[-1]
    return "row" if owner in _ROW_NAMES else "col"


def _tp_axis(mesh) -> Optional[str]:
    """The TP mesh axis, or None on an FSDP-only mesh (weights replicated on
    their non-gathered dim; the row pattern then needs no all-reduce)."""
    return "model" if "model" in shd.axis_names(mesh) else None


def _pick_m_pad(m: int, n_fsdp: int) -> int:
    """Rows to append so the token dim divides the FSDP width (zero rows,
    zero outputs, sliced off after the gather)."""
    if n_fsdp <= 1:
        return 0
    return (-m) % n_fsdp


def payload_specs(pattern: Optional[str], fsdp: tuple, tp: Optional[str],
                  lead_axis: Optional[str] = None, scan: int = 0) -> dict:
    """Per-field ``PartitionSpec`` of a payload: a 2-D leaf under
    ``pattern``, or (``pattern=None``) an expert stack ``(E, nb, rows, N)``
    with its experts over ``lead_axis`` and its block axis over ``fsdp``;
    ``scan`` stacked-layer dims lead, whole."""
    fs = tuple(fsdp) or None
    if pattern is None:
        spec, scale = (lead_axis, fs, None, None), (lead_axis, None, None)
    elif pattern == "col":
        spec, scale = (fs, None, tp), (None, tp)
    else:
        spec, scale = (tp, None, fs), (None, fs)
    lead = (None,) * scan
    return {"mask": shd.P(*lead, *spec), "hi": shd.P(*lead, *spec),
            "lo": shd.P(*lead, *spec), "scale": shd.P(*lead, *scale)}


def cut_payload(fields: dict, shard, mesh) -> dict:
    """This rank's block of a whole packed leaf's fields under a mesh-aware
    plan's ``ShardSpec`` (an expert stack has no TP pattern; leading
    stacked-layer dims stay whole): what ``build_plan(mesh=)`` keeps."""
    stack = shard.tp_pattern is None
    tp = None if stack or "model" not in shd.axis_names(mesh) else "model"
    specs = payload_specs(shard.tp_pattern, shard.fsdp_axes, tp, shard.lead_axis,
                          fields["mask"].dim() - 3 - stack)
    return {k: shd.shard_slice(fields[k], sp, mesh) for k, sp in specs.items()}


def local_payload(wleaf: dict, specs: dict, mesh) -> dict:
    """This rank's block of the payload fields: a leaf from a mesh-aware
    plan holds it already (its ``ShardSpec`` names the mesh shape it was cut
    for, which must be this mesh's); any other leaf is global and is cut."""
    spec = wleaf.get("spec")
    shard = getattr(spec, "shard", None)
    fields = {k: wleaf[k] for k in FIELDS + ("scale",)}
    if shard is not None and shard.mesh_shape:
        here = tuple(shd.axis_sizes(mesh).items())
        if shard.mesh_shape != here:
            raise ValueError(f"leaf holds a shard cut for mesh {dict(shard.mesh_shape)}; "
                             f"called on mesh {dict(here)}")
        return fields
    return {k: shd.shard_slice(v, specs[k], mesh) for k, v in fields.items()}


def stack_at_rest(wleaf: dict, mesh) -> dict:
    """An expert stack of a mesh-aware plan as the reference's
    ``input_shardings`` hold it: its experts over ``model`` and its packed
    block axis whole (the rules map a stack's ``expert_fsdp`` axis to no
    mesh axis), where the plan's block also splits the block axis over the
    FSDP axes.  That axis is all-gathered once and the leaf's ``ShardSpec``
    then names no FSDP axis; any other leaf is returned as it is.  The MoE
    body cuts the data block again on entry (``models.moe``), as the
    reference's ``in_specs`` reshard it."""
    import dataclasses
    spec = wleaf.get("spec")
    shard = getattr(spec, "shard", None)
    if shard is None or shard.tp_pattern is not None or not shard.fsdp_axes:
        return wleaf
    out = dict(wleaf, **{k: shd.all_gather(wleaf[k], mesh, shard.fsdp_axes,
                                           wleaf[k].dim() - 3) for k in FIELDS})
    out["spec"] = dataclasses.replace(spec, shard=dataclasses.replace(shard,
                                                                      fsdp_axes=()))
    return out


def _packed(cfg: StruMConfig, k_dim: int, f: dict) -> packing.PackedStruM:
    return packing.PackedStruM(
        method=cfg.method, w=cfg.w, n_low=cfg.n_low, q=cfg.q, L=cfg.L,
        k_dim=k_dim, scale=f["scale"], mask=f["mask"], hi=f["hi"], lo=f["lo"])


def _gather_fields(f: dict, pattern: str, fsdp: tuple, mesh) -> dict:
    """All-gather the packed fields of a 2-D block over the FSDP axes (col:
    payload axis 0; row: axis 2 and the per-N scales)."""
    col = pattern == "col"
    out = {k: shd.all_gather(f[k], mesh, fsdp, 0 if col else 2) for k in FIELDS}
    out["scale"] = f["scale"] if col else shd.all_gather(f["scale"], mesh, fsdp, 1)
    return out


def _target(x: torch.Tensor, mesh) -> torch.device:
    """The device the post-gather kernel is selected for: ``x``'s, or the
    one an abstract mesh's ``meta`` tensors stand for."""
    if x.device.type == "meta" and getattr(mesh, "abstract", False):
        return torch.device(mesh.target)
    return x.device


def _post_gather_backend(backend: Optional[str], device) -> Optional[str]:
    """The caller's backend, except that the ``cuda`` family on a CPU tensor
    becomes the ``torch`` family (the CPU's plain path)."""
    if torch.device(device).type != "cuda" and backend not in (None, "auto") \
            and resolve_backend(backend) == "cuda":
        return "torch"
    return backend


def _local_dense(wleaf: dict, cfg: StruMConfig, mesh, pattern: str, fsdp: tuple,
                 dtype) -> torch.Tensor:
    """This rank's dense block after the packed FSDP gather: col (K, N/tp),
    row (K/tp, N)."""
    tp = _tp_axis(mesh)
    f = _gather_fields(local_payload(wleaf, payload_specs(pattern, fsdp, tp), mesh),
                       pattern, fsdp, mesh)
    return packing.dequantize(_packed(cfg, f["mask"].shape[0] * cfg.w, f), dtype)


def gather_dequant_leaf(wleaf: dict, scfg: StruMConfig, mesh, pattern: str,
                        k_dim: int, dtype=torch.bfloat16,
                        fsdp: Optional[tuple] = None) -> torch.Tensor:
    """FSDP-gather the *compressed* payloads, dequantize this rank's block
    locally, and return the global dense ``(K, N)`` weight (its TP blocks
    gathered dense: a test and tool helper; ``sharded:gather_dequant``
    contracts the local block and gathers activations instead)."""
    fsdp = tuple(fsdp) if fsdp else shd.fsdp_axes(mesh)
    tp = _tp_axis(mesh)
    wd = _local_dense(wleaf, scfg, mesh, pattern, fsdp, dtype)
    wd = shd.gather_out(wd, mesh, tp, 1 if pattern == "col" else 0)
    return wd[:k_dim]


@register_kernel(
    "sharded:gather_dequant", family="torch", priority=0, sharded=True,
    supports=lambda cfg, info: not info.lead,
    description="all-gather packed payloads along the FSDP axes, dequantize "
                "this rank's block, f32 matmul (portable distributed path)")
def _gather_dequant(wleaf, x, *, cfg, mesh, fsdp, pattern, k_dim, backend=None,
                    out_dtype=None, accum_dtype=torch.float32, spmd=False,
                    local_rows=False):
    # the global contract computes every row it is given: local_rows alike
    out_dtype = out_dtype or x.dtype
    tp = _tp_axis(mesh)
    wd = _local_dense(wleaf, cfg, mesh, pattern, fsdp, x.dtype).to(torch.float32)
    xf = x.to(torch.float32)
    if spmd:            # x at x_spec, y at y_spec: this rank's rows and blocks
        y = xf @ wd[:xf.shape[-1]]
        if pattern != "col":
            y = shd.all_reduce(y, mesh, tp)
        return y.to(accum_dtype).to(out_dtype)
    if pattern == "col":
        y = shd.gather_out((xf @ wd[:k_dim]).to(accum_dtype), mesh, tp, -1)
    else:
        xk = xf.chunk(shd.axis_size(mesh, tp), dim=-1)[shd.axis_index(mesh, tp)] \
            if tp else xf
        y = shd.all_reduce((xk @ wd[:xk.shape[-1]]).to(accum_dtype), mesh, tp)
    return y.to(out_dtype)


def _post_gather_expressible(cfg: StruMConfig, info: LeafInfo) -> bool:
    """Does some 2-D ``cuda`` variant decode this config after the gather?"""
    inner = LeafInfo(k_dim=info.k_dim, n_out=info.n_out, name=info.name)
    return any(v.family == "cuda" and not v.grouped and not v.sharded
               and not v.cache and not v.draft and v.supports(cfg, inner)
               for v in list_variants().values())


@register_kernel(
    "sharded:gather_pallas", family="cuda", priority=10, sharded=True,
    redispatch=True,
    supports=lambda cfg, info: (not info.lead
                                and _post_gather_expressible(cfg, info)),
    description="all-gather the packed payloads along the FSDP axes, then run "
                "the registry-selected 2-D kernel on the gathered payload")
def _gather_pallas(wleaf, x, *, cfg, mesh, fsdp, pattern, k_dim, backend=None,
                   out_dtype=None, accum_dtype=torch.float32, spmd=False,
                   local_rows=False):
    tp = _tp_axis(mesh)
    col = pattern == "col"
    out_dtype = out_dtype or x.dtype
    lead = tuple(x.shape[:-1])
    f = _gather_fields(local_payload(wleaf, payload_specs(pattern, fsdp, tp), mesh),
                       pattern, fsdp, mesh)
    dev = _target(x, mesh)
    if spmd:            # x at x_spec, y at y_spec: this rank's rows and blocks
        x_l = x.reshape(-1, x.shape[-1])
        n_global = f["scale"].shape[-1] * (shd.axis_size(mesh, tp) if col else 1)
        inner = select_variant(cfg, LeafInfo(k_dim=k_dim, n_out=n_global),
                               backend=_post_gather_backend(backend, dev), device=dev)
        y = inner.fn(x_l, _packed(cfg, x_l.shape[-1], f), out_dtype=torch.float32,
                     **({"accum_dtype": accum_dtype} if inner.accum else {}))
        if not col:
            y = shd.all_reduce(y, mesh, tp)          # row-parallel K-partials
        return y.to(out_dtype).reshape(lead + (y.shape[-1],))
    x2 = x.reshape(-1, k_dim)
    m = x2.shape[0]
    rows_fsdp = () if local_rows else fsdp     # local rows are split already
    m_pad = _pick_m_pad(m, shd.axis_size(mesh, rows_fsdp))
    if m_pad:
        x2 = torch.cat([x2, x2.new_zeros((m_pad, k_dim))])
    # this rank's token rows (and, for row, its model-shard of K)
    x_l = shd.shard_slice(x2, shd.P(rows_fsdp or None, None if col else tp), mesh)
    k_local = x_l.shape[-1]
    n_global = f["scale"].shape[-1] * (shd.axis_size(mesh, tp) if col else 1)
    # the post-gather kernel: the same registry, the caller's backend
    inner = select_variant(cfg, LeafInfo(k_dim=k_dim, n_out=n_global),
                           backend=_post_gather_backend(backend, dev), device=dev)
    y = inner.fn(x_l, _packed(cfg, k_local, f), out_dtype=torch.float32,
                 **({"accum_dtype": accum_dtype} if inner.accum else {}))
    if not col:
        y = shd.all_reduce(y, mesh, tp)              # row-parallel K-partials
    y = shd.gather_out(y, mesh, tp, 1) if col else y
    if rows_fsdp:
        y = shd.gather_out(y, mesh, rows_fsdp, 0)[:m]
    return y.to(out_dtype).reshape(lead + (n_global,))


@register_kernel(
    "sharded:grouped_gather", family="torch", priority=0, sharded=True,
    grouped=True, redispatch=True,
    supports=lambda cfg, info: bool(info.lead),
    description="inside the MoE body: all-gather the packed expert stack "
                "along the FSDP axes, then re-dispatch to the grouped family")
def _grouped_gather(wleaf, x, *, cfg, mesh, fsdp, pattern=None, k_dim=None,
                    backend=None, out_dtype=None, accum_dtype=torch.float32,
                    rows=None):
    # the FSDP shard dim is the packed block axis nb, ndim-3 of every field
    # (lead..., nb, rows, N); scales are per output channel and stay local
    gathered = {k: shd.all_gather(wleaf[k], mesh, fsdp, wleaf[k].dim() - 3)
                for k in FIELDS}
    gathered["scale"] = wleaf["scale"]
    from repro_torch.engine.dispatch import dispatch_grouped
    dev = _target(x, mesh)
    return dispatch_grouped(gathered, x, strum=cfg,
                            backend=_post_gather_backend(backend, dev),
                            out_dtype=out_dtype, accum_dtype=accum_dtype,
                            rows=rows, device=dev)


# --------------------------------------------------- collective accounting --

def dense_gather_bytes(k_dim: int, n_out: int, dtype=torch.bfloat16) -> int:
    """Bytes the naive path would move: all-gather the *dequantized* weight."""
    return int(k_dim) * int(n_out) * torch.empty((), dtype=dtype).element_size()


def field_parts(shard) -> dict:
    """How many blocks each payload field of a mesh-aware plan's leaf was
    cut into (the scale follows the N or expert axis only)."""
    sizes = dict(shard.mesh_shape)
    tp = "model" if "model" in sizes else None
    specs = payload_specs(shard.tp_pattern, shard.fsdp_axes,
                          None if shard.lead_axis else tp, shard.lead_axis)
    return {k: math.prod(sizes.get(a, 1) for e in sp for a in shd._as_axes(e))
            for k, sp in specs.items()}


