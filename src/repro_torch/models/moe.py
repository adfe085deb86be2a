"""Top-k MoE FFN with expert parallelism (twin of ``repro.models.moe``).

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
stacks always run the variant their plan recorded.

With a mesh that has a ``model`` axis, ``moe_apply`` runs the reference's
expert-parallel body on every rank: tokens split over the data axes (where
the batch divides), experts over ``model`` (EP == TP axis), each rank runs
its token rows against its experts, and one all-reduce over ``model``
combines them; the load-balance fractions are averaged over all ranks
before their product (aux from the data-mean fractions).  A packed stack
enters the body as this rank's block, its experts over ``model`` and its
packed block axis over the data axes (the reference's ``in_specs``):
``dispatch_grouped(fsdp_axes=..., mesh=...)`` selects
``sharded:grouped_gather``, which all-gathers the packed block axis before
the grouped kernel (K6-K8 on the card).  Two contracts, one per layout
(:mod:`repro_torch.models.sharding`):

* the replicated layout (``spmd=False``): ``x`` and the result are global,
  as every activation of that layout is; the body cuts its token rows and
  gathers the result back.  A dense stack is global and gives this rank its
  experts; a packed one is a mesh-aware plan's block or is cut from a
  global one;
* the sharded serving layout (``spmd=True``): ``x`` is this rank's rows
  (the batch over the data axes, or whole and replicated where they do not
  divide it, as the reference's ``shard_tokens``) and so is the result:
  nothing is cut or gathered back, and the capacity is the reference's
  ``t_local``, the rows this rank holds.  A dense stack arrives placed by
  ``params.shard_params`` at ``P('model', None, None)`` (``expert_fsdp``
  maps to no axis): this rank's experts, K whole, used as they are.  A
  packed stack arrives as ``launch.specs.place_inputs`` holds it, its
  block axis whole as the reference stores it, and is cut to this rank's
  data block on entry, as the reference's ``in_specs`` reshard it.  The
  train layout (``launch.steps.make_train_step`` on a mesh) runs this
  contract under autograd: the body's input and the router pass
  ``sharding.grad_all_reduce`` (each ``model`` rank holds its experts'
  part of their gradients), and the load-balance fractions carry the
  gradient :func:`_rank_fractions` derives.

A mesh without a ``model`` axis runs the local path, as in the reference (a
mesh-aware plan's stacks are then gathered packed over the FSDP axes before
each contraction); dense stacks under ``spmd`` (rows held per rank, as the
train layout holds them on an FSDP-only mesh) run the body with one
``model`` rank, so the load-balance fractions are the data ranks' mean.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import sharding as shd
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


def _expert_contract(wstack, xbuf: torch.Tensor, scfg, rows=None, fsdp=(),
                     mesh=None) -> torch.Tensor:
    """(E, C, K) x (E, K, N) -> (E, C, N) in xbuf's dtype, packed stacks kept
    packed (grouped dispatch of their recorded variant, with ``rows``, the
    filled slots of each expert), dense ones a batched f32-accumulated
    matmul.  Inside the EP body ``fsdp`` names the axes of ``mesh`` a packed
    stack's block axis is still split over (gathered packed by dispatch)."""
    if isinstance(wstack, dict):
        from repro_torch.engine.dispatch import dispatch_grouped
        return dispatch_grouped(wstack, xbuf, strum=scfg, out_dtype=xbuf.dtype,
                                rows=rows, fsdp_axes=tuple(fsdp) or None,
                                mesh=mesh)
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
           e_local: int, capacity: int, split=None) -> dict:
    """Router, top-k and capacity positions of the flattened ``(T·k)``
    assignments (token-major).  Returns the assignments' token ``tok``,
    local expert ``exp``, slot ``pos`` (``capacity`` for a drop), ``keep``
    and f32 combine weight ``w`` (0 for a drop), and the load-balance
    fractions ``dispatch_frac`` / ``prob_frac`` over all experts.  With
    ``split = (mesh, axes)`` the rows are this rank's consecutive part of a
    token order split over ``axes``: an assignment keeps its slot when its
    position among all ranks' assignments (the earlier ranks' counts, one
    all-gather, plus its own) is under ``capacity``."""
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
    slot = pos
    if split is not None:
        mesh, axes = split
        counts = shd.all_gather(onehot.sum(0)[None], mesh, axes, 0)   # (ranks, E)
        slot = pos + counts[:shd.axis_index(mesh, axes)].sum(0)[exp]
    keep = is_local & (slot < capacity)
    return {"tok": tok, "exp": exp, "pos": torch.where(keep, pos, capacity),
            "keep": keep, "w": torch.where(keep, w, 0.0),
            "dispatch_frac": dispatch_frac, "prob_frac": prob_frac}


def _moe_local(x2, router_w, wi, wg, wo, cfg, e_offset: int, capacity: int,
               scfgs=(None, None, None), fsdp=(), mesh=None, split=None):
    """Token-local, expert-local MoE.  x2: (T, D); wi/wg (E, D, F), wo (E,
    F, D), dense or packed, for the experts from ``e_offset`` on (packed
    stacks still split over ``fsdp`` inside the EP body; ``split`` as in
    :func:`_route`).  Returns (y (T, D) in x2's dtype, (dispatch_frac,
    prob_frac))."""
    t, d = x2.shape
    r = _route(x2, router_w, cfg, e_offset, _stack_len(wi), capacity, split)
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

    h = _expert_contract(wi, buf, scfgs[0], rows, fsdp, mesh)
    if wg is not None:
        h = F.silu(_expert_contract(wg, buf, scfgs[1], rows, fsdp, mesh)) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    out_buf = _expert_contract(wo, h, scfgs[2], rows, fsdp, mesh)

    # combine: f32 weights (0 for drops), scatter-added per token in f32
    gathered = out_buf[r["exp"], torch.clamp(r["pos"], max=capacity - 1)]
    contrib = gathered.to(torch.float32) * r["w"][:, None]
    y = torch.zeros((t, d), dtype=torch.float32, device=x2.device)
    y.index_add_(0, r["tok"], contrib)
    return y.to(x2.dtype), (r["dispatch_frac"], r["prob_frac"])


def moe_apply(p: dict, x: torch.Tensor, cfg, mesh=None, batch_split=None,
              spmd: bool = False, **_kw):
    """x: (B, S, D) -> (y, aux).  ``aux = E · Σ(dispatch_frac · prob_frac)``,
    the switch-style load-balance loss.  Per-call kwargs (``backend=``,
    ``strum=``) are ignored, as the reference ignores them: packed stacks
    run their recorded variant, with ``cfg.strum`` for stacks without one.
    A mesh with a ``model`` axis runs the expert-parallel body (the module
    docstring), with ``spmd`` in the sharded serving layout's contract; a
    mesh the experts or the stacks' FSDP dim do not divide raises before
    any collective, with the shapes in the message.

    ``batch_split = (mesh, axes)`` (the ZeRO-3 step, ``launch.steps.
    _zero3_step``, a yardstick the train step no longer selects; with no
    ``mesh``): ``x`` is this rank's equal share of a batch split over
    ``axes``, and the layer routes as one device does on the whole batch:
    capacity over all tokens, slots in the global token order, and aux from
    the all-rank mean fractions; its gradient carries this rank's share of
    ``prob_frac``, so the step's gradient mean is the whole batch's.  The
    train layout instead routes each data rank's rows with its own
    capacity, as the reference's expert-parallel body does."""
    b, s, d = x.shape
    scfg = cfg.strum
    if batch_split is not None and mesh is None:
        smesh, axes = batch_split
        n = shd.axis_size(smesh, axes)
        y, (df, pf) = _moe_local(x.reshape(-1, d), p["router"]["w"], p["wi"],
                                 p.get("wg"), p["wo"], cfg, 0,
                                 _capacity(n * b * s, cfg), scfgs=(scfg, scfg, scfg),
                                 split=batch_split)
        df = shd.all_reduce(df, smesh, axes, "mean")
        pf = pf + (shd.all_reduce(pf.detach(), smesh, axes, "mean") - pf).detach()
        return y.reshape(b, s, d), cfg.n_experts * torch.sum(df * pf)
    has_model = "model" in shd.axis_names(mesh)
    dense = not any(isinstance(p.get(nm), dict) for nm in ("wi", "wg", "wo"))
    if mesh is None or not (has_model or (spmd and dense)):
        # the reference's local path; a mesh-aware plan's stacks on an
        # FSDP-only mesh are blocks of their block axis, gathered packed
        blocks = any(_nb_split(p.get(nm)) for nm in ("wi", "wg", "wo"))
        y, (df, pf) = _moe_local(x.reshape(-1, d), p["router"]["w"], p["wi"],
                                 p.get("wg"), p["wo"], cfg, 0,
                                 _capacity(b * s, cfg), scfgs=(scfg, scfg, scfg),
                                 fsdp=shd.fsdp_axes(mesh) if blocks else (),
                                 mesh=mesh)
        return y.reshape(b, s, d), cfg.n_experts * torch.sum(df * pf)

    data_axes = shd.fsdp_axes(mesh)
    sizes = shd.axis_sizes(mesh)
    n_data = shd.axis_size(mesh, data_axes)
    n_model = sizes.get("model", 1)
    if cfg.n_experts % n_model:
        raise ValueError(
            f"moe_apply: n_experts={cfg.n_experts} is not divisible by the "
            f"'model' mesh axis (size {n_model}, mesh shape {sizes}); experts "
            f"shard evenly over 'model'")
    stacks = {nm: p[nm] for nm in ("wi", "wg", "wo") if p.get(nm) is not None}
    for nm, w in stacks.items():
        # axis 1 is the FSDP shard dim: K for dense stacks, the packed block
        # axis nb = ceil(K/w) for compressed ones (a block's: times n_data)
        arr = w["mask"] if isinstance(w, dict) else w
        n1 = arr.shape[1] * (n_data if _nb_split(w) else 1)
        kind = "packed block axis nb" if isinstance(w, dict) else "K axis"
        if n1 % n_data:
            raise ValueError(
                f"moe_apply: expert stack {nm!r} {kind} of size {n1} (array "
                f"shape {tuple(arr.shape)}) is not divisible by the FSDP data "
                f"axes {data_axes} (size {n_data}); the all-gather would "
                f"mis-shard")
    e_local = cfg.n_experts // n_model
    shard_tokens = b % n_data == 0 and not spmd
    cap = _capacity((b // n_data) * s if shard_tokens else b * s, cfg)
    midx = shd.axis_index(mesh, "model") if has_model else 0
    x_l = shd.shard_slice(x, shd.P(data_axes), mesh) if shard_tokens else x
    router_w = p["router"]["w"]
    if spmd:    # the train layout: each model rank holds its experts' part
        x_l = shd.grad_all_reduce(x_l, mesh, "model")       # of these gradients
        router_w = shd.grad_all_reduce(router_w, mesh, "model")
    local = {nm: _expert_block(w, mesh, data_axes, midx, e_local)
             for nm, w in stacks.items()}
    y, (df, pf) = _moe_local(x_l.reshape(-1, d), router_w, local["wi"],
                             local.get("wg"), local["wo"], cfg, midx * e_local, cap,
                             scfgs=(scfg, scfg, scfg), fsdp=data_axes, mesh=mesh)
    y = shd.all_reduce(y, mesh, "model")                # combine expert shards
    # global fractions BEFORE the product (aux is nonlinear in them)
    ranks = data_axes + (("model",) if has_model else ())
    df = shd.all_reduce(df, mesh, ranks, "mean")
    if spmd:
        pf = _rank_fractions(pf, mesh, ranks, n_model)
    else:
        pf = shd.all_reduce(pf, mesh, ranks, "mean")
    y = y.reshape(x_l.shape)
    if shard_tokens:
        y = shd.gather_out(y, mesh, data_axes, 0)
    return y, cfg.n_experts * torch.sum(df * pf)


def _rank_fractions(pf: torch.Tensor, mesh, ranks: tuple,
                    n_model: int) -> torch.Tensor:
    """The mean of every rank's ``prob_frac`` over ``ranks`` (the
    forward), carrying
    ``1 / n_model`` of aux's gradient to this rank's own (the backward).

    In the train layout each rank's objective is ``1 / n_data`` of the
    whole batch's (``launch.steps``), the data ranks' gradients are summed,
    and so are the ``model`` ranks' parts of the router's and the input's
    gradients (:func:`moe_apply`).  A data rank's fractions are the same on
    its ``n_model`` ranks and weigh ``1 / n_data`` in the mean, so the
    whole batch's aux gradient reaches them as ``1 / n_data`` of aux's,
    which is what each rank's ``1 / n_data`` objective gives once the
    ``model`` sum has added its ranks' ``1 / n_model`` shares.  The
    all-reduce's own backward (``1 / (n_data · n_model)``) would leave it
    ``n_data`` times too small."""
    whole = shd.all_reduce(pf.detach(), mesh, ranks, "mean")
    return whole + (pf - pf.detach()) / n_model


def _nb_split(w) -> bool:
    """Is ``w`` a packed stack whose block axis is already this rank's FSDP
    block (a mesh-aware plan's)?  Not a stack held with its block axis
    whole (``launch.specs.place_inputs``)."""
    shard = getattr(w.get("spec"), "shard", None) if isinstance(w, dict) else None
    return shard is not None and bool(shard.mesh_shape) and bool(shard.fsdp_axes)


def _expert_block(w, mesh, data_axes: tuple, midx: int, e_local: int):
    """This rank's experts of a stack as the body takes them: a dense
    stack's slice (whole K; a placed stack is this rank's already), a
    packed stack's block (experts over ``model``, block axis over the data
    axes: a mesh-aware plan's leaf already is one, a stack held with its
    block axis whole is cut to it, a global one is cut)."""
    if not isinstance(w, dict):
        if shd.placement(w) is not None:
            return w
        return w[midx * e_local:(midx + 1) * e_local]
    from repro_torch.engine.sharded import FIELDS, local_payload, payload_specs
    shard = getattr(w.get("spec"), "shard", None)
    if shard is not None and shard.mesh_shape and not shard.fsdp_axes:
        return dict(w, **{k: shd.shard_slice(w[k], shd.P(None, data_axes), mesh)
                          for k in FIELDS})
    return dict(w, **local_payload(w, payload_specs(None, data_axes, None, "model"),
                                   mesh))
