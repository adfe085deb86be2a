"""Top-k MoE FFN, single device (twin of the local path of
``repro.models.moe``).

Dispatch is GShard-style fixed capacity: per expert ``C = max(ceil(T·k / E
· capacity_factor), top_k)`` slots, filled in token-major order of the
flattened ``(T·k)`` assignments; an assignment past its expert's capacity
drops (its weight is zeroed and its row parked in a trash slot ``C`` that is
cut off).  The router runs in f32; ties in the top-k go to the lower expert
index, as ``jax.lax.top_k`` orders them.  The three expert contractions go
through :func:`_expert_contract`: a StruM-packed stack runs through the
engine's grouped dispatch (``cuda:grouped*``, kernels K6-K8, on the card)
with each expert's filled-slot count (``rows``, so K6, K7 and K8 skip empty
experts and empty row tiles), a dense one through a batched matmul.

Like the reference, ``moe_apply`` ignores a per-call ``backend=``: packed
stacks always run the variant their plan recorded.  The expert-parallel
mesh path (``mesh=``) is not ported yet (ROADMAP queue 1 item 13).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef

__all__ = ["moe_def", "moe_apply"]


def moe_def(cfg, lead=()) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    la = ("layers",) * len(lead)
    out = {
        # the router stays dense (DEFAULT_EXCLUDE): tiny and accuracy-critical
        "router": {"w": ParamDef(lead + (d, e), la + ("embed_no_fsdp", None))},
        "wi": ParamDef(lead + (e, d, f), la + ("experts", "expert_fsdp", "expert_mlp")),
        "wo": ParamDef(lead + (e, f, d), la + ("experts", "expert_fsdp", "embed_no_fsdp")),
    }
    if cfg.gated_mlp:
        out["wg"] = ParamDef(lead + (e, d, f), la + ("experts", "expert_fsdp", "expert_mlp"))
    return out


def _expert_contract(wstack, xbuf: torch.Tensor, scfg, rows=None) -> torch.Tensor:
    """(E, C, K) x (E, K, N) -> (E, C, N) in xbuf's dtype, packed stacks kept
    packed (grouped dispatch of their recorded variant, with ``rows``, the
    filled slots of each expert), dense ones a batched f32-accumulated
    matmul."""
    if isinstance(wstack, dict):
        from repro_torch.engine.dispatch import dispatch_grouped
        return dispatch_grouped(wstack, xbuf, strum=scfg, out_dtype=xbuf.dtype,
                                rows=rows)
    return torch.matmul(xbuf.to(torch.float32),
                        wstack.to(xbuf.dtype).to(torch.float32)).to(xbuf.dtype)


def _stack_len(wstack) -> int:
    """Leading (expert) dim of a dense or packed stack."""
    return (wstack["mask"] if isinstance(wstack, dict) else wstack).shape[0]


def _capacity(tokens: int, cfg) -> int:
    per_expert = tokens * cfg.top_k / max(cfg.n_experts, 1)
    return max(int(math.ceil(per_expert * cfg.capacity_factor)), cfg.top_k)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort; ``torch.topk`` makes no promise
    about ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x2: torch.Tensor, router_w: torch.Tensor, cfg, e_offset: int,
           e_local: int, capacity: int) -> dict:
    """Router, top-k and capacity positions of the flattened ``(T·k)``
    assignments (token-major).  Returns the assignments' token ``tok``,
    local expert ``exp``, slot ``pos`` (``capacity`` for a drop), ``keep``
    and f32 combine weight ``w`` (0 for a drop), and the load-balance
    fractions ``dispatch_frac`` / ``prob_frac`` over all experts."""
    t = x2.shape[0]
    k = cfg.top_k
    logits = x2.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                        # (T, E)
    top_w, top_i = _top_k(probs, k)
    top_w = top_w / torch.clamp(top_w.sum(dim=-1, keepdim=True), min=1e-9)
    dispatch_frac = F.one_hot(top_i[:, 0], cfg.n_experts).to(torch.float32).mean(0)
    prob_frac = probs.mean(0)

    tok = torch.arange(t, device=x2.device).repeat_interleave(k)
    exp = top_i.reshape(-1) - e_offset
    w = top_w.reshape(-1).to(torch.float32)
    is_local = (exp >= 0) & (exp < e_local)
    exp = torch.where(is_local, exp, 0)
    w = torch.where(is_local, w, 0.0)
    # GShard capacity positions: running count per expert, in assignment order
    onehot = F.one_hot(exp, e_local) * is_local[:, None]
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1)
    keep = is_local & (pos < capacity)
    return {"tok": tok, "exp": exp, "pos": torch.where(keep, pos, capacity),
            "keep": keep, "w": torch.where(keep, w, 0.0),
            "dispatch_frac": dispatch_frac, "prob_frac": prob_frac}


def _moe_local(x2, router_w, wi, wg, wo, cfg, e_offset: int, capacity: int,
               scfgs=(None, None, None)):
    """Token-local, expert-local MoE.  x2: (T, D); wi/wg (E, D, F), wo (E,
    F, D), dense or packed, for the experts from ``e_offset`` on.  Returns
    (y (T, D) in x2's dtype, (dispatch_frac, prob_frac))."""
    t, d = x2.shape
    r = _route(x2, router_w, cfg, e_offset, _stack_len(wi), capacity)
    # dispatch: (E, C + 1, D) in x's dtype; slot C is the trash bin
    buf = x2.new_zeros((_stack_len(wi), capacity + 1, d))
    buf.index_put_((r["exp"], r["pos"]),
                   torch.where(r["keep"][:, None], x2[r["tok"]], 0), accumulate=True)
    buf = buf[:, :capacity]
    # filled slots per expert: a bincount of the kept assignments on the
    # device (no host sync); slots fill from 0 in order, so every row past
    # the count is zero in buf, and in h (silu(0)·0 = gelu(0) = 0)
    e_local = buf.shape[0]
    rows = torch.zeros(e_local, dtype=torch.int32, device=x2.device).index_add_(
        0, r["exp"], r["keep"].to(torch.int32))

    h = _expert_contract(wi, buf, scfgs[0], rows)
    if wg is not None:
        h = F.silu(_expert_contract(wg, buf, scfgs[1], rows)) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    out_buf = _expert_contract(wo, h, scfgs[2], rows)

    # combine: f32 weights (0 for drops), scatter-added per token in f32
    gathered = out_buf[r["exp"], torch.clamp(r["pos"], max=capacity - 1)]
    contrib = gathered.to(torch.float32) * r["w"][:, None]
    y = torch.zeros((t, d), dtype=torch.float32, device=x2.device)
    y.index_add_(0, r["tok"], contrib)
    return y.to(x2.dtype), (r["dispatch_frac"], r["prob_frac"])


def moe_apply(p: dict, x: torch.Tensor, cfg, mesh=None, **_kw):
    """x: (B, S, D) -> (y, aux).  ``aux = E · Σ(dispatch_frac · prob_frac)``,
    the switch-style load-balance loss.  Per-call kwargs (``backend=``,
    ``strum=``) are ignored, as the reference ignores them: packed stacks
    run their recorded variant, with ``cfg.strum`` for stacks without one."""
    if mesh is not None:
        raise NotImplementedError("moe_apply(mesh=...) is the expert-parallel "
                                  "path, not ported yet (ROADMAP queue 1 item 13)")
    b, s, d = x.shape
    scfg = cfg.strum
    y, (df, pf) = _moe_local(x.reshape(-1, d), p["router"]["w"], p["wi"],
                             p.get("wg"), p["wo"], cfg, 0, _capacity(b * s, cfg),
                             scfgs=(scfg, scfg, scfg))
    return y.reshape(b, s, d), cfg.n_experts * torch.sum(df * pf)
