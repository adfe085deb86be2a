"""Shared model layers (twin of ``repro.models.layers``): norms, rotary,
StruM-aware linears, the SwiGLU MLP, embeddings and the tied LM head.

Functional like the reference: ``apply(params_subtree, x, ...)``.  A
linear's ``w`` may be a packed leaf (``{"mask", "hi", "lo", "scale", ...}``
from :func:`repro_torch.engine.build_plan`); it then runs through
:func:`repro_torch.engine.dispatch`.  Products the reference leaves to XLA
(dense linears, the logits) are ``torch.matmul`` in f32, after rounding the
weight to the activation dtype as the reference's ``w.astype(x.dtype)``
does.

In the sharded serving layout (``spmd=True`` with a ``tp_mesh``; see
:mod:`repro_torch.models.sharding`) a dense leaf is this rank's shard: its
``embed`` dim is gathered over the data axes per use (FSDP), a ``col``
linear keeps its output features local, a ``row`` linear contracts this
rank's block of K and all-reduces over ``model``; the embedding table is
vocab-parallel and the LM head's logits are this rank's vocab block.  The
train step (every family on a mesh) runs the same products under
autograd: the collectives carry their transposes, and the input of the
column-parallel products (the MLP's, attention's q / k / v, the SSM
mixer's projections, the MoE body's, the LM head) passes
``sharding.grad_all_reduce``, whose backward sums the parts of its
gradient the ``model`` ranks hold.  Anywhere else a sharded dense leaf
raises.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.policy import StruMConfig
from repro_torch.models import sharding as shd
from repro_torch.models.params import ParamDef, torch_dtype

__all__ = ["rms_norm", "nonparam_ln", "norm_def", "apply_norm", "linear_def",
           "linear", "mlp_def", "mlp", "rope_freqs", "apply_rope", "embed_def",
           "embed_lookup", "logits", "check_whole", "tp_input"]


def _f32_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w.astype(x.dtype) with f32 accumulation (preferred_element_type)."""
    return x.to(torch.float32) @ w.to(x.dtype).to(torch.float32)


# ----------------------------------------------------------------- norms --

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def nonparam_ln(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm: no scale, no bias."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def norm_def(cfg, lead=()):
    if cfg.norm == "nonparam":
        return {}
    return {"scale": ParamDef(lead + (cfg.d_model,),
                              ("layers",) * len(lead) + ("embed_no_fsdp",),
                              init="ones")}


def apply_norm(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.norm == "nonparam" or "scale" not in p:
        return nonparam_ln(x)
    return rms_norm(x, p["scale"])


# --------------------------------------------------------------- linears --

def linear_def(d_in: int, d_out: int, in_axis: str, out_axis: str,
               bias: bool = False, lead=(), scale: float = 1.0) -> dict:
    lead_axes = ("layers",) * len(lead)
    d = {"w": ParamDef(lead + (d_in, d_out), lead_axes + (in_axis, out_axis),
                       scale=scale)}
    if bias:
        d["b"] = ParamDef(lead + (d_out,), lead_axes + (out_axis,), init="zeros")
    return d


def linear(p: dict, x: torch.Tensor, *, strum: Optional[StruMConfig] = None,
           backend: Optional[str] = None, accum_dtype=torch.float32, tp_mesh=None,
           tp_pattern: Optional[str] = None, spmd: bool = False,
           local_rows: bool = False) -> torch.Tensor:
    """y = x @ W (+ b), dense or StruM-compressed; ``backend`` overrides the
    plan's variant per call (``"torch"``, ``"cuda"``, ...).  ``accum_dtype``
    (a dtype or its name) is the reference's ``preferred_element_type``:
    the f32 product is rounded to it before x's dtype (the CUDA kernels
    ignore it).  With ``tp_mesh`` a packed leaf runs through the
    ``sharded:*`` family in the ``tp_pattern`` layout ('col' | 'row').  A
    dense leaf computes replicated, unless ``spmd`` (the sharded serving
    layout): then it must be a placed shard (``params.shard_params``) and
    runs as the module docstring says; ``x`` and the result hold this
    rank's rows (a row linear's ``x`` its block of K, a col linear's result
    its block of N).  ``local_rows`` (the paged layout): ``x`` is this
    rank's rows, the weight whole or a plan's packed block."""
    acc = torch_dtype(accum_dtype)
    wleaf = p["w"]
    if isinstance(wleaf, dict):
        from repro_torch.engine.dispatch import dispatch
        y = dispatch(wleaf, x, strum=strum, backend=backend, accum_dtype=acc,
                     mesh=tp_mesh, tp_pattern=tp_pattern, spmd=spmd,
                     local_rows=local_rows)
    elif spmd and tp_mesh is not None:
        y = _spmd_product(x, wleaf, tp_mesh).to(acc).to(x.dtype)
    else:
        check_whole(wleaf, "a dense linear")
        y = _f32_matmul(x, wleaf).to(acc).to(x.dtype)
    if "b" in p:
        b = p["b"]
        if not (spmd and tp_mesh is not None):
            check_whole(b, "a linear's bias")
        y = y + b.to(y.dtype)
    return y


def check_whole(t: torch.Tensor, what: str) -> None:
    """Refuse a sharded dense leaf outside the sharded serving layout: it
    would compute on its block as if it were the whole tensor."""
    if shd.is_sharded(t):
        pl = shd.placement(t)
        raise ValueError(
            f"{what}: a sharded dense leaf (global shape {pl.shape}, spec "
            f"{pl.spec}) reached a lane that holds whole dense weights; the "
            f"sharded serving layout covers prefill and decode_step on a mesh, "
            f"and the train step on a mesh")


def _spmd_product(x: torch.Tensor, w: torch.Tensor, mesh) -> torch.Tensor:
    """f32 ``x @ w`` of a placed dense shard: each ``embed`` dim gathered
    over its axes (FSDP), a K split over ``model`` contracted locally and
    all-reduced over it."""
    pl = shd.placement(w)
    if pl is None or pl.axes is None:
        raise ValueError("sharded serving layout: a dense weight that is not a "
                         "placed shard; place the served tree with "
                         "models.params.shard_params")
    for dim, (ax, entry) in enumerate(zip(pl.axes, pl.spec)):
        if ax == "embed" and shd.axis_size(mesh, entry) > 1:
            w = shd.all_gather(w, mesh, entry, dim)
    y = _f32_matmul(x, w)
    k_entry = pl.spec[0]
    if pl.axes[0] != "embed" and shd.axis_size(mesh, k_entry) > 1:
        y = shd.all_reduce(y, mesh, k_entry)      # row-parallel K-partials
    return y


# ------------------------------------------------------------------ MLPs --

def mlp_def(cfg, lead=()) -> dict:
    """SwiGLU (gated) or plain-GELU MLP."""
    d, f = cfg.d_model, cfg.d_ff
    out = {"wi": linear_def(d, f, "embed", "mlp", lead=lead)}
    if cfg.gated_mlp:
        out["wg"] = linear_def(d, f, "embed", "mlp", lead=lead)
    out["wo"] = linear_def(f, d, "mlp", "embed", lead=lead)
    return out


def tp_input(x: torch.Tensor, kw: dict) -> torch.Tensor:
    """The input of column-parallel products in the sharded layout (its
    gradient summed over ``model`` in the backward); ``x`` elsewhere."""
    mesh = kw.get("tp_mesh") if kw.get("spmd") else None
    tp = shd.tp_axis(mesh) if mesh is not None else None
    return shd.grad_all_reduce(x, mesh, tp) if tp is not None else x


def mlp(p: dict, x: torch.Tensor, cfg, **kw) -> torch.Tensor:
    x = tp_input(x, kw)
    kw_c = dict(kw, tp_pattern="col")
    h = linear(p["wi"], x, **kw_c)
    if cfg.gated_mlp:
        h = F.silu(linear(p["wg"], x, **kw_c)) * h
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return linear(p["wo"], h, **dict(kw, tp_pattern="row"))


# ------------------------------------------------------------------ RoPE --

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs         # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ------------------------------------------------------------ embeddings --

def embed_def(cfg) -> dict:
    return {"table": ParamDef((cfg.padded_vocab, cfg.d_model),
                              ("vocab", "embed_no_fsdp"), scale=1.0)}


def embed_lookup(p: dict, ids: torch.Tensor, dtype, mesh=None) -> torch.Tensor:
    """Rows of the table for ``ids``.  A table sharded over the vocab
    (the sharded serving layout; ``mesh`` given) is vocab-parallel: each
    rank looks up the ids its block holds, zeroes the others and the rows
    are all-reduced over the vocab's axes (one rank adds a row, the others
    zeros, so the sum is exact)."""
    table = p["table"]
    if mesh is not None and shd.placement(table) is None:
        raise ValueError("sharded serving layout: the embedding table is not "
                         "placed; place the served tree with "
                         "models.params.shard_params")
    if mesh is None or not shd.is_sharded(table):
        check_whole(table, "the embedding")
        return table[ids].to(dtype)
    entry = shd.placement(table).spec[0]
    n = table.shape[0]
    local = ids - shd.axis_index(mesh, entry) * n
    hit = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)].to(dtype)
    rows = torch.where(hit[..., None], rows, torch.zeros_like(rows))
    return shd.all_reduce(rows, mesh, entry)


def logits(head_p: Optional[dict], embed_p: dict, x: torch.Tensor,
           mesh=None) -> torch.Tensor:
    """LM head, f32 out: tied (embed^T) or untied.  On a vocab-sharded head
    (the sharded serving layout) the result is this rank's vocab block;
    ``mesh`` (the train step) makes ``x`` the column-parallel input."""
    if mesh is not None:
        x = tp_input(x, {"tp_mesh": mesh, "spmd": True})
    if head_p is not None:
        return _f32_matmul(x, head_p["w"])
    return _f32_matmul(x, embed_p["table"].T)
