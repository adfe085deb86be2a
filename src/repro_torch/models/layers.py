"""Shared model layers (twin of ``repro.models.layers``): norms, rotary,
StruM-aware linears, the SwiGLU MLP, embeddings and the tied LM head.

Functional like the reference: ``apply(params_subtree, x, ...)``.  A
linear's ``w`` may be a packed leaf (``{"mask", "hi", "lo", "scale", ...}``
from :func:`repro_torch.engine.build_plan`); it then runs through
:func:`repro_torch.engine.dispatch`.  Products the reference leaves to XLA
(dense linears, the logits) are ``torch.matmul`` in f32, after rounding the
weight to the activation dtype as the reference's ``w.astype(x.dtype)``
does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.policy import StruMConfig
from repro_torch.models.params import ParamDef, torch_dtype

__all__ = ["rms_norm", "nonparam_ln", "norm_def", "apply_norm", "linear_def",
           "linear", "mlp_def", "mlp", "rope_freqs", "apply_rope", "embed_def",
           "embed_lookup", "logits"]


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
           tp_pattern: Optional[str] = None) -> torch.Tensor:
    """y = x @ W (+ b), dense or StruM-compressed; ``backend`` overrides the
    plan's variant per call (``"torch"``, ``"cuda"``, ...).  ``accum_dtype``
    (a dtype or its name) is the reference's ``preferred_element_type``:
    the f32 product is rounded to it before x's dtype (the CUDA kernels
    ignore it).  With ``tp_mesh`` a packed leaf runs through the
    ``sharded:*`` family in the ``tp_pattern`` layout ('col' | 'row'); a
    dense leaf ignores both (dense compute is replicated)."""
    acc = torch_dtype(accum_dtype)
    wleaf = p["w"]
    if isinstance(wleaf, dict):
        from repro_torch.engine.dispatch import dispatch
        y = dispatch(wleaf, x, strum=strum, backend=backend, accum_dtype=acc,
                     mesh=tp_mesh, tp_pattern=tp_pattern)
    else:
        y = _f32_matmul(x, wleaf).to(acc).to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
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


def mlp(p: dict, x: torch.Tensor, cfg, **kw) -> torch.Tensor:
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


def embed_lookup(p: dict, ids: torch.Tensor, dtype) -> torch.Tensor:
    return p["table"][ids].to(dtype)


def logits(head_p: Optional[dict], embed_p: dict, x: torch.Tensor) -> torch.Tensor:
    """LM head, f32 out: tied (embed^T) or untied."""
    if head_p is not None:
        return _f32_matmul(x, head_p["w"])
    return _f32_matmul(x, embed_p["table"].T)
