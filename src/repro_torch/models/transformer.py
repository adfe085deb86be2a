"""Decoder stack (twin of ``repro.models.transformer``) for every family
of the reference, dense, MoE, ``ssm`` (Mamba-2) and ``hybrid`` (Jamba):
``model_defs``, ``cache_defs``, ``forward_train`` (with the ``remat``
policy), ``loss_fn``, ``prefill`` and ``decode_step``, and the serving
runtime's paged lanes ``decode_step_paged``, ``prefill_chunk_step`` and
``verify_chunk_step``.

Parameters keep the reference layout: per period position ``pos{i}``,
every leaf stacked with a leading ``n_groups`` dim.  The period is the lcm
of the hybrid's attention period (``attn_every``) and the MoE period
(``moe_every``); a position holds ``attn`` or ``ssm`` (its mixer, by
``cfg.layer_kind``) and ``moe`` or ``mlp`` (its FFN, by
``cfg.layer_is_moe``).  The reference's ``lax.scan`` over groups is a
Python loop here that slices group ``g`` out of every tensor (packed
payload fields included).  Inputs are token ids, or with ``batch["embeds"]``
(the audio and VLM configs' stub frontend) embeddings ``(B, S, D)``; the
decode lanes take ``(B, 1, D)`` embeddings in place of ``(B, 1)`` ids.

Every forward and lane takes ``mesh=`` / ``rules=`` as the reference's do,
and hands ``cfg.accum_dtype`` to every linear as its ``accum_dtype``;
the mesh rides to every linear as ``tp_mesh`` and to the MoE FFN (the
expert-parallel body).  The layouts (:mod:`repro_torch.models.sharding`):

* ``prefill`` and ``decode_step`` of every family on a mesh, given placed
  params, run the sharded serving layout, the reference's
  ``input_shardings``: params placed by ``params.shard_params`` (packed
  expert stacks as ``launch.specs.place_inputs`` holds them), the batch
  (tokens, embeddings, caches) split over the rules' ``batch`` axes
  (replicated where they do not divide it, ``rules_for_mesh(mesh,
  global_batch)``), the attention caches' sequence over ``model``, the SSM
  ``conv`` cache's channels and ``state``'s heads over ``model``; the MoE
  FFN takes this rank's rows (``moe.moe_apply(spmd=True)``), the Mamba-2
  mixer its blocks (:mod:`repro_torch.models.mamba2`); the logits are this
  rank's rows and vocab block, placed.  ``prefill(..., max_len=)`` returns
  attention caches already padded to the decode loop's length
  (``launch.specs.padded_cache_len``) and cut to this rank's slice;
* the paged runtime's lanes (``decode_step_paged``, ``prefill_chunk_step``,
  ``verify_chunk_step``) and ``prefill`` given whole dense params (the
  paged runtime's serial prefill) run the paged layout, as the reference's
  scheduler runs them: dense params whole (a sharded one raises), packed
  leaves through the ``sharded:*`` family, the lane's batch cut to this
  rank's rows by ``constrain`` after the embedding and held there after
  every block (``sharding.lane_rules``: whole on every rank where the data
  axes do not divide it), the per-slot inputs cut to the same rows, the MoE
  FFN on those rows (``spmd=True``), pools and tails whole.  What the
  decode lane writes for its rows (each slot's new tail row, the SSM
  ``conv`` and ``state`` rows) is all-gathered over the data axes after
  it, so the tails stay equal on every rank (:data:`lane_gather_bytes`
  counts the bytes);
* ``forward_train`` on a mesh: the train layout of every family, given
  placed params: the batch over the data axes, each weight gathered over
  its ``embed`` axes per use, each rank computing its block of the heads,
  the MLP and the vocabulary, its experts (``moe.moe_apply(spmd=True)``
  on its rows, with the reference's ``t_local`` capacity) and its SSM
  heads and conv channels (the Mamba-2 mixer on its blocks),
  differentiable through the collectives (``loss_fn`` takes the
  vocab-parallel cross-entropy); the aux loss sums over the MoE layers.
  A ``model`` axis that does not divide the experts, the SSM heads or
  the conv channels raises before any collective.
"""
from __future__ import annotations

import collections
import math
from typing import Any

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2, moe
from repro_torch.models import sharding as shd
from repro_torch.models.layers import (apply_norm, check_whole, embed_def,
                                       embed_lookup, linear_def, logits, mlp,
                                       mlp_def, norm_def)
from repro_torch.models.params import ParamDef
from repro_torch.models.sharding import check_axes, constrain

__all__ = ["period", "n_groups", "model_defs", "cache_defs", "forward_train",
           "loss_fn", "prefill", "decode_step", "decode_step_paged",
           "prefill_chunk_step", "verify_chunk_step", "sharded_serving",
           "lane_gather_bytes"]

#: bytes the paged lanes all-gathered to keep the tails equal on every
#: rank (the gathered results' bytes on this rank), by lane
lane_gather_bytes: collections.Counter = collections.Counter()


def period(cfg) -> int:
    """Layers per scan group: the lcm of the hybrid's attention period and
    the MoE period (8 for Jamba's 1:7 with MoE every 2; 1 for uniform
    stacks)."""
    p = 1
    if cfg.family == "hybrid" and cfg.attn_every:
        p = math.lcm(p, cfg.attn_every)
    if cfg.n_experts and cfg.moe_every > 1:
        p = math.lcm(p, cfg.moe_every)
    if cfg.n_layers % p:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is not a "
                         f"multiple of the period {p}")
    return p


def n_groups(cfg) -> int:
    return cfg.n_layers // period(cfg)


def _block_def(cfg, pos: int, lead) -> dict:
    d = {"norm1": norm_def(cfg, lead)}
    if cfg.layer_kind(pos) == "attn":
        d["attn"] = attn_mod.attn_def(cfg, lead)
    else:
        d["ssm"] = mamba2.ssm_def(cfg, lead)
    if cfg.d_ff > 0:
        d["norm2"] = norm_def(cfg, lead)
        if cfg.layer_is_moe(pos):
            d["moe"] = moe.moe_def(cfg, lead)
        else:
            d["mlp"] = mlp_def(cfg, lead)
    return d


def model_defs(cfg) -> dict:
    defs: dict = {"embed": embed_def(cfg)}
    defs["blocks"] = {f"pos{i}": _block_def(cfg, i, (n_groups(cfg),))
                      for i in range(period(cfg))}
    defs["final_norm"] = norm_def(cfg)
    if not cfg.tie_embeddings:
        defs["lm_head"] = linear_def(cfg.d_model, cfg.padded_vocab,
                                     "embed_no_fsdp", "vocab")
    return defs


def cache_defs(cfg, batch: int, max_len: int) -> dict:
    """ParamDef tree of the dense-cache loop's per-layer caches, stacked by
    group: ``k`` / ``v`` (activation dtype) per attention position, ``conv``
    (activation dtype) and ``state`` (f32) per SSM position."""
    g = n_groups(cfg)
    out = {}
    for i in range(period(cfg)):
        if cfg.layer_kind(i) == "attn":
            shape, axes = attn_mod.init_cache_spec(cfg, batch, max_len)
            out[f"pos{i}"] = {n: ParamDef((g,) + shape, ("layers",) + axes,
                                          dtype=cfg.dtype, init="zeros")
                              for n in ("k", "v")}
        else:
            (cs, ca), (ss, sa) = mamba2.ssm_cache_spec(cfg, batch)
            out[f"pos{i}"] = {
                "conv": ParamDef((g,) + cs, ("layers",) + ca, dtype=cfg.dtype,
                                 init="zeros"),
                "state": ParamDef((g,) + ss, ("layers",) + sa, dtype="float32",
                                  init="zeros")}
    return out


def _group(tree: Any, g: int) -> Any:
    """Group ``g`` of a stacked tree: every tensor indexed at ``[g]`` (a
    placed one keeps its placement, less the stacked dim); static leaf
    metadata (cfg, spec) passes through."""
    if isinstance(tree, dict):
        return {k: _group(v, g) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    pl = shd.placement(tree)
    out = tree[g]
    if pl is not None:
        out._placement = pl.drop_lead()
    return out


def sharded_serving(cfg, mesh) -> bool:
    """Do ``prefill`` / ``decode_step`` of ``cfg`` on ``mesh`` run the
    sharded serving layout?  On any mesh, for every family (dense, MoE,
    Mamba-2 and the hybrid)."""
    return mesh is not None


def _whole_dense(params, lane: str) -> None:
    """A lane of the replicated layout refuses a sharded dense leaf
    anywhere in ``params`` (it never computes on a block as if whole and
    never gathers it back quietly)."""
    if isinstance(params, dict):
        for v in params.values():
            _whole_dense(v, lane)
    elif isinstance(params, torch.Tensor):
        check_whole(params, lane)


def _blocks(params, cfg, *trees):
    """Every layer in order: ``(pos, block params, *the same group and
    position of each of trees)``."""
    for g in range(n_groups(cfg)):
        groups = [_group(params["blocks"], g)] + [_group(t, g) for t in trees]
        for i in range(period(cfg)):
            yield (f"pos{i}",) + tuple(t[f"pos{i}"] for t in groups)


def _ffn_residual(bp, x, cfg, kw, batch_split=None):
    """x + the block's MLP or MoE FFN; returns (x, MoE aux loss or 0)."""
    if cfg.d_ff <= 0:
        return x, 0.0
    h = apply_norm(bp["norm2"], x, cfg)
    if "moe" in bp:
        h, aux = moe.moe_apply(bp["moe"], h, cfg, mesh=kw.get("tp_mesh"),
                               batch_split=batch_split,
                               spmd=kw.get("spmd", False) or kw.get("local_rows", False))
        return x + h, aux
    return x + mlp(bp["mlp"], h, cfg, **kw), 0.0


def _linear_kw(kw: dict, cfg, mesh) -> dict:
    """The linears' keywords: ``strum`` and ``accum_dtype`` default to the
    config's, and a mesh rides along as ``tp_mesh`` whatever ``cfg.strum``
    is (a schedule-built plan packs leaves with ``cfg.strum`` None)."""
    kw.setdefault("strum", cfg.strum)
    kw.setdefault("accum_dtype", cfg.accum_dtype)
    if mesh is not None:
        kw.setdefault("tp_mesh", mesh)
    return kw


def _embed_in(params, inputs, cfg, mesh=None):
    """Token ids ``(B, S)`` through the embedding table (vocab-parallel on
    ``mesh``), or embeddings ``(B, S, D)`` (the stub frontends) cast to the
    activation dtype."""
    if inputs.dim() == 3:
        return inputs.to(cfg.activation_dtype)
    return embed_lookup(params["embed"], inputs, cfg.activation_dtype, mesh)


def _batch_in(params, batch, cfg, mesh=None):
    return _embed_in(params, batch["embeds"] if "embeds" in batch
                     else batch["tokens"], cfg, mesh)


def _placed(params) -> bool:
    """Are ``params`` placed shards (``params.shard_params``)?  The
    embedding table says: it is dense in every served tree."""
    return shd.placement(params["embed"]["table"]) is not None


def _serving_layout(params, cfg, mesh, rules, kw: dict):
    """Set up a serving step on the sharded serving layout: ``(rules,
    mesh)``, ``kw`` gaining ``spmd``; ``(rules, None)`` without a mesh."""
    if not sharded_serving(cfg, mesh):
        _whole_dense(params, "a serving step without a mesh")
        return rules, None
    kw["spmd"] = True
    return rules or shd.rules_for_mesh(mesh), mesh


def _lane_layout(params, cfg, mesh, rules, kw: dict, lane: str, batch: int):
    """Set up a lane of the paged layout for a batch of ``batch`` rows:
    ``(rules, rows)``, ``rows`` this rank's slice of the batch (None
    without a mesh); dense params must be whole, and ``kw`` gains
    ``local_rows``."""
    _whole_dense(params, lane)
    if mesh is None:
        return rules, None
    rules = shd.lane_rules(mesh, rules, batch)
    kw["local_rows"] = True
    entry = rules.table["batch"]
    n = shd.axis_size(mesh, entry)
    i = shd.axis_index(mesh, entry) if n > 1 else 0
    return rules, slice(i * batch // n, (i + 1) * batch // n)


def _hold_rows(x, rules, shape):
    """The reference's constraint of the activations after a block: ``x``
    holds this rank's rows of a ``shape`` batch, which it keeps."""
    if rules is None or rules.mesh is None:
        return x
    held = shd.place(x, rules.mesh, rules(("batch", None, None)), shape)
    return constrain(held, ("batch", None, None), rules)


def _slot_rows(tree, rows):
    """Every per-slot tensor of a hot tree ``(groups, n_slots, ...)`` cut
    to the slots ``rows`` (views: writes reach the whole tensor)."""
    return {pos: {n: t[:, rows] for n, t in hp.items()} for pos, hp in tree.items()}


def _share_rows(hot, rows, tail_pos, mesh, entry) -> int:
    """All-gather over ``entry`` what the decode lane wrote for this rank's
    ``rows``, into every rank's whole tails: each slot's tail row at
    ``tail_pos`` (an inactive slot's is its unchanged one), and the SSM
    ``conv`` / ``state`` rows.  Returns the gathered bytes."""
    moved = 0
    dev = tail_pos.device
    every_row = torch.arange(tail_pos.shape[0], device=dev)
    mine = every_row[rows]
    for hp in hot.values():
        for name, t in hp.items():
            if name.endswith("_tail"):
                new = shd.all_gather(t[:, mine, tail_pos[rows]], mesh, entry, 1)
                t[:, every_row, tail_pos] = new
            else:
                new = shd.all_gather(t[:, rows], mesh, entry, 1)
                t.copy_(new)
            moved += new.numel() * new.element_size()
    return moved


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device, dtype=torch.int32)[None].expand(b, s)


def _stack(per_pos: dict) -> dict:
    """``{pos: {name: [per-group tensors]}}`` -> group-stacked tensors."""
    return {pos: {n: torch.stack(ts) for n, ts in c.items()}
            for pos, c in per_pos.items()}


def _per_pos(cfg, attn_names, ssm_names=()) -> dict:
    return {f"pos{i}": {n: [] for n in (attn_names if cfg.layer_kind(i) == "attn"
                                        else ssm_names)}
            for i in range(period(cfg))}


#: ops whose outputs ``remat_policy="dots"`` keeps for the backward (the
#: reference's ``dots_saveable``: every matmul and einsum contraction)
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default]


def _remat(body, cfg):
    """The configured activation-checkpoint policy around a group body
    (twin of the reference's ``_remat``): ``remat_policy="full"`` recomputes
    the whole group in the backward, ``"dots"`` keeps the matmul outputs
    and recomputes the rest.  Forward values are unchanged; without
    gradients the body runs as is."""
    if not cfg.remat:
        return body
    ckpt_kw = {}
    if cfg.remat_policy == "dots":
        ckpt_kw["context_fn"] = lambda: _ckpt.create_selective_checkpoint_contexts(_DOTS)

    def run(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        return _ckpt.checkpoint(body, *args, use_reentrant=False, **ckpt_kw)
    return run


def _check_train_mesh(cfg, mesh) -> None:
    """Refuse, before any collective, a mesh whose ``model`` axis does not
    divide the experts, the SSM heads or the conv channels, naming the
    shapes (the reference's ``moe_apply`` check and the SSM mixer's)."""
    sizes = shd.axis_sizes(mesh)
    n = sizes.get("model", 1)
    if cfg.n_experts % n:
        raise ValueError(
            f"{cfg.name}: n_experts={cfg.n_experts} is not divisible by the 'model' "
            f"mesh axis (size {n}, mesh shape {sizes}); experts shard evenly over "
            f"'model'")
    if any(cfg.layer_kind(i) != "attn" for i in range(period(cfg))):
        nh, conv_dim = cfg.ssm_heads, cfg.d_inner + 2 * cfg.ssm_state
        if nh % n or conv_dim % n:
            raise ValueError(
                f"{cfg.name}: {nh} SSM heads and {conv_dim} conv channels do not "
                f"both divide over the 'model' mesh axis (size {n}, mesh shape "
                f"{sizes})")


def forward_train(params: dict, batch: dict, cfg, mesh=None, rules=None,
                  batch_split=None, **kw):
    """Full forward; returns (logits f32, aux): aux is the MoE load-balance
    loss summed over layers (0 without MoE layers).  With ``cfg.remat``
    each layer group is checkpointed (:func:`_remat`).  ``batch_split =
    (mesh, axes)`` says ``batch`` is this rank's share of a batch split over
    ``axes`` (the ZeRO-3 step): MoE layers then route over the whole batch
    (``moe.moe_apply``).  With a ``mesh`` (the train layout) ``params`` are
    placed shards, ``batch`` this rank's rows, and the logits this rank's
    rows and vocab block, placed."""
    _linear_kw(kw, cfg, mesh)
    spmd = None
    if mesh is not None:
        _check_train_mesh(cfg, mesh)
        kw["spmd"] = True
        rules, spmd = rules or shd.rules_for_mesh(mesh), mesh
    else:
        _whole_dense(params, "forward_train")
    x = check_axes(_batch_in(params, batch, cfg, spmd), ("batch", None, None), rules)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)

    def group(x, gp):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(period(cfg)):
            bp = gp[f"pos{i}"]
            h = apply_norm(bp["norm1"], x, cfg)
            if "attn" in bp:
                h = attn_mod.attention(bp["attn"], h, cfg, positions, rules=rules,
                                       **kw)
            else:
                h = mamba2.ssm_apply(bp["ssm"], h, cfg, **kw)
            x, a = _ffn_residual(bp, x + h, cfg, kw, batch_split)
            aux = aux + a
        return x, aux

    body = _remat(group, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(n_groups(cfg)):
        x, a = body(x, _group(params["blocks"], g))
        aux = aux + a
    x = apply_norm(params["final_norm"], x, cfg)
    lg = logits(params.get("lm_head"), params["embed"], x, spmd)
    if spmd is not None:
        return shd.place(lg, mesh, rules(("batch", None, "vocab"))), aux
    return check_axes(lg, ("batch", None, "vocab"), rules), aux


def loss_fn(params: dict, batch: dict, cfg, mesh=None, rules=None, **kw):
    """Next-token cross-entropy over ``labels >= 0`` plus
    ``router_aux_weight · aux``; returns ``(loss, {"ce", "aux"})``.  With a
    ``mesh`` (the train layout) ``batch`` is this rank's rows and the loss
    their mean, from the vocab-parallel logits (:func:`_vocab_parallel_ce`)."""
    lg, aux = forward_train(params, batch, cfg, mesh, rules, **kw)
    labels = batch["labels"]
    if mesh is not None:
        tok = _vocab_parallel_ce(lg, labels, mesh, shd.placement(lg).spec[-1])
    else:
        lse = torch.logsumexp(lg, dim=-1)
        # a masked label (< 0) reads column 0; its term is multiplied by 0
        gold = torch.gather(lg, -1, labels.clamp(min=0).to(torch.long)[..., None])[..., 0]
        tok = lse - gold
    mask = (labels >= 0).to(torch.float32)
    ce = torch.sum(tok * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return ce + cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}


def _vocab_parallel_ce(lg, labels, mesh, entry) -> torch.Tensor:
    """Per token ``logsumexp - gold logit`` of logits whose vocabulary is
    split over ``entry`` (``lg`` this rank's block): the max of every
    rank's maxima (gathered, no gradient), the sum of exponentials
    all-reduced, and the gold logit from the rank whose block holds the
    label, all-reduced (the others add 0).  A masked label (< 0) reads
    column 0."""
    n = lg.shape[-1]
    m = shd.all_gather(lg.detach().amax(dim=-1, keepdim=True), mesh, entry, -1)
    m = m.amax(dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(shd.all_reduce(torch.exp(lg - m).sum(dim=-1), mesh, entry))
    v0 = shd.axis_index(mesh, entry) * n if shd.axis_size(mesh, entry) > 1 else 0
    local = labels.clamp(min=0).to(torch.long) - v0
    hit = (local >= 0) & (local < n)
    gold = torch.gather(lg, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = shd.all_reduce(torch.where(hit, gold, torch.zeros_like(gold)), mesh, entry)
    return lse - gold


def prefill(params: dict, batch: dict, cfg, mesh=None, rules=None,
            max_len=None, **kw):
    """Forward over a prompt; returns (last-token logits (B, 1, V) f32,
    caches): per attention position ``{"k", "v"}`` stacked as (groups, B,
    L, KV, hd), per SSM position ``{"conv", "state"}`` as (groups, B, W-1,
    conv_dim) and (groups, B, nh, hp, ns) f32.  ``L`` is ``max_len`` (the
    prompt's positions, then zeros: the decode loop's cache), by default
    the prompt's length.  On a mesh, placed params run the sharded serving
    layout (the module docstring): everything is this rank's block, placed,
    logits at ``(batch, None, vocab)``, each cache at its ``cache_defs``
    axes.  Whole dense params run the paged layout (the paged runtime's
    serial prefill): logits and caches are this rank's rows of the batch,
    placed, every feature whole."""
    _linear_kw(kw, cfg, mesh)
    inputs = batch["embeds"] if "embeds" in batch else batch["tokens"]
    rows = spmd = None
    if mesh is not None and not _placed(params):
        rules, rows = _lane_layout(params, cfg, mesh, rules, kw, "prefill",
                                   inputs.shape[0])
    else:
        rules, spmd = _serving_layout(params, cfg, mesh, rules, kw)
    x = _batch_in(params, batch, cfg, spmd)
    shape = tuple(x.shape)
    x = (constrain if rows is not None else check_axes)(x, ("batch", None, None), rules)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    caches = _per_pos(cfg, ("k", "v"), ("conv", "state"))
    for pos, bp in _blocks(params, cfg):
        h = apply_norm(bp["norm1"], x, cfg)
        c = caches[pos]
        if "attn" in bp:
            h, (k, v) = attn_mod.attention(bp["attn"], h, cfg, positions,
                                           return_kv=True, rules=rules, **kw)
            for name, t in (("k", k), ("v", v)):
                t = _pad_seq(t.to(cfg.activation_dtype), max_len)
                if spmd is not None:    # this rank's slice of the sequence
                    t_rows = shd.place(t, spmd, rules(("batch", None, None, None)))
                    t = constrain(t_rows, ("batch", "cache_seq", None, None), rules)
                c[name].append(t)
        else:
            h, (conv, state) = mamba2.ssm_apply(bp["ssm"], h, cfg,
                                                return_state=True, **kw)
            c["conv"].append(conv.to(cfg.activation_dtype))
            c["state"].append(state)
        x, _ = _ffn_residual(bp, x + h, cfg, kw)
        if rows is not None:
            x = _hold_rows(x, rules, shape)
    x = apply_norm(params["final_norm"], x, cfg)
    lg = logits(params.get("lm_head"), params["embed"], x[:, -1:, :])
    caches = _stack(caches)
    if rows is not None:        # this rank's rows, every feature whole
        entry = rules.table["batch"]
        return (shd.place(lg, mesh, shd.P(entry), (shape[0],) + tuple(lg.shape[1:])),
                {pos: {n: shd.place(t, mesh, shd.P(None, entry)) for n, t in c.items()}
                 for pos, c in caches.items()})
    if spmd is None:
        return lg, caches
    axes = {pos: {n: d.axes for n, d in c.items()}
            for pos, c in cache_defs(cfg, 1, 1).items()}
    caches = {pos: {n: shd.place(t, spmd, rules(axes[pos][n]), axes=axes[pos][n])
                    for n, t in c.items()}
              for pos, c in caches.items()}
    return shd.place(lg, spmd, rules(("batch", None, "vocab"))), caches


def _pad_seq(t: torch.Tensor, max_len) -> torch.Tensor:
    """(B, S, ...) -> (B, max_len, ...), zeros after the S positions."""
    if max_len is None or max_len == t.shape[1]:
        return t
    if max_len < t.shape[1]:
        raise ValueError(f"max_len={max_len} is shorter than the prompt "
                         f"({t.shape[1]} positions)")
    shape = list(t.shape)
    shape[1] = max_len - t.shape[1]
    return torch.cat([t, t.new_zeros(shape)], dim=1)


def decode_step(params: dict, token: torch.Tensor, caches: dict, cache_len,
                cfg, mesh=None, rules=None, **kw):
    """One decode step.  token: (B, 1) int, or embeddings (B, 1, D).
    Returns (logits (B, 1, V) f32, caches); the caches are updated in place
    (attention at ``cache_len``, SSM conv and state whole).  In the sharded
    serving layout ``token``, ``caches`` and the logits are this rank's
    blocks (the module docstring), and each SSM cache is this rank's block
    of it, updated whole."""
    _linear_kw(kw, cfg, mesh)
    rules, spmd = _serving_layout(params, cfg, mesh, rules, kw)
    x = check_axes(_embed_in(params, token, cfg, spmd), ("batch", None, None), rules)
    for _, bp, c in _blocks(params, cfg, caches):
        h = apply_norm(bp["norm1"], x, cfg)
        if "attn" in bp:
            h, _ = attn_mod.decode_attention(bp["attn"], h, cfg, (c["k"], c["v"]),
                                             cache_len, **kw)
        else:
            h, (conv, state) = mamba2.ssm_decode(bp["ssm"], h, cfg,
                                                 (c["conv"], c["state"]), **kw)
            c["conv"].copy_(conv)
            c["state"].copy_(state)
        x, _ = _ffn_residual(bp, x + h, cfg, kw)
    x = apply_norm(params["final_norm"], x, cfg)
    lg = logits(params.get("lm_head"), params["embed"], x)
    if spmd is not None:
        lg = shd.place(lg, spmd, rules(("batch", None, "vocab")))
    return lg, caches


# -------------------------------------------------------- paged serving --
#
# The serving runtime's lanes (repro_torch.serving.scheduler): a decode
# step over every slot, a chunked-prefill step over one slot and the
# speculative verify step over one slot, all reading KV through the page
# table.  ``pools`` holds the sealed pages per attention position (an SSM
# position's pool is empty), ``hot`` the per-slot tail pages and SSM
# (conv, state).  Shapes are fixed per lane -- (n_slots, 1), (1, chunk) and
# (1, k + 1) -- and ``slot`` / ``start`` / ``valid_len`` / ``cache_len`` are
# device tensors, so no shape depends on a prompt's length and no step reads
# a value back to the host.  ``hot`` is updated in place (the reference
# returns a new one); sealing full pages into the pools happens between
# steps, on the host.

def decode_step_paged(params: dict, token: torch.Tensor, pools: dict,
                      hot: dict, cache_len: torch.Tensor,
                      page_table: torch.Tensor, active: torch.Tensor,
                      spec, cfg, mesh=None, rules=None, cache_backend=None, **kw):
    """One decode step over paged caches.  token: (B, 1) int, or (B, 1, D)
    embeddings.

    ``active`` (B,) bool masks the hot-state writes: parked slots and slots
    mid-prefill ride the fixed-shape batch but keep their tails and their
    SSM conv and state.  Returns (logits (B, 1, V) f32, hot), ``hot``
    updated in place.
    """
    _linear_kw(kw, cfg, mesh)
    b = token.shape[0]
    rules, rows = _lane_layout(params, cfg, mesh, rules, kw, "decode_step_paged", b)
    x = constrain(_embed_in(params, token, cfg), ("batch", None, None), rules)
    shape = (b,) + tuple(x.shape[1:])
    tail_pos = cache_len.to(torch.long) % spec.page_size
    hot_l = hot
    if rows is not None:        # the per-slot inputs on x's rows
        cache_len, page_table, active = cache_len[rows], page_table[rows], active[rows]
        hot_l = _slot_rows(hot, rows)
    for _, bp, pool, hp in _blocks(params, cfg, pools, hot_l):
        h = apply_norm(bp["norm1"], x, cfg)
        if "attn" in bp:
            h, _ = attn_mod.decode_attention_paged(
                bp["attn"], h, cfg, pool, (hp["k_tail"], hp["v_tail"]), spec,
                page_table, cache_len, active=active, cache_backend=cache_backend,
                **kw)
        else:
            h, (conv, state) = mamba2.ssm_decode(bp["ssm"], h, cfg,
                                                 (hp["conv"], hp["state"]), **kw)
            hp["conv"].copy_(torch.where(active[:, None, None], conv, hp["conv"]))
            hp["state"].copy_(torch.where(active[:, None, None, None], state,
                                          hp["state"]))
        x, _ = _ffn_residual(bp, x + h, cfg, kw)
        x = _hold_rows(x, rules, shape)
    x = apply_norm(params["final_norm"], x, cfg)
    lg = logits(params.get("lm_head"), params["embed"], x)
    if rows is None:
        return lg, hot
    entry = rules.table["batch"]
    if shd.axis_size(mesh, entry) > 1:
        lane_gather_bytes["decode"] += _share_rows(hot, rows, tail_pos, mesh, entry)
    return shd.place(lg, mesh, shd.P(entry), (b,) + tuple(lg.shape[1:])), hot


def prefill_chunk_step(params: dict, tokens: torch.Tensor, pools: dict,
                       hot: dict, page_table: torch.Tensor, slot: torch.Tensor,
                       start: torch.Tensor, valid_len: torch.Tensor,
                       spec, cfg, mesh=None, rules=None, cache_backend=None,
                       **kw):
    """One fixed-shape prefill chunk for ONE slot.  tokens: (1, C) int, or
    (1, C, D) embeddings.

    ``slot`` / ``start`` / ``valid_len`` are device scalars.  Returns
    ``(logits (1, C, V), hot, chunk_kv)``: the first generated token is
    ``argmax(logits[0, valid_len - 1])`` on the last chunk, and ``chunk_kv``
    (per attention position the chunk's group-stacked (k, v); empty per SSM
    position) is what the host seals into full pages.  In place, the slot's
    tail page gets the ragged remainder ``[floor(valid_len / ps) * ps,
    valid_len)`` of the chunk, and its SSM conv and state the chunk's
    continuation (``ssm_prefill_chunk``).
    """
    _linear_kw(kw, cfg, mesh)
    ps = spec.page_size
    rules, _ = _lane_layout(params, cfg, mesh, rules, kw, "prefill_chunk_step",
                            tokens.shape[0])
    x = constrain(_embed_in(params, tokens, cfg), ("batch", None, None), rules)
    shape = tuple(x.shape)
    c = x.shape[1]
    slot1 = slot.to(torch.long).reshape(1)
    row = page_table.index_select(0, slot1)[0]
    # chunk starts are page-aligned, so the tail starts at a page boundary
    # of the chunk; the clamp keeps a full chunk's slice in bounds (its tail
    # is then empty and masked by length)
    tail_rel = torch.clamp((valid_len.to(torch.long) // ps) * ps, 0, c - ps)
    tail_idx = tail_rel + torch.arange(ps, device=x.device)
    chunk_kv = _per_pos(cfg, ("k", "v"))
    for pos, bp, pool, hp in _blocks(params, cfg, pools, hot):
        h = apply_norm(bp["norm1"], x, cfg)
        if "attn" in bp:
            h, (ck, cv) = attn_mod.prefill_attention_paged(
                bp["attn"], h, cfg, pool, spec, row, start,
                cache_backend=cache_backend, **kw)
            for name, kv in (("k", ck), ("v", cv)):
                kv = kv.to(hp[f"{name}_tail"].dtype)
                chunk_kv[pos][name].append(kv)
                hp[f"{name}_tail"].index_copy_(0, slot1, kv[:, tail_idx])
        else:
            cache = (hp["conv"].index_select(0, slot1),
                     hp["state"].index_select(0, slot1))
            h, (conv, state) = mamba2.ssm_prefill_chunk(bp["ssm"], h, cfg, cache,
                                                        valid_len, **kw)
            hp["conv"].index_copy_(0, slot1, conv.to(hp["conv"].dtype))
            hp["state"].index_copy_(0, slot1, state)
        x, _ = _ffn_residual(bp, x + h, cfg, kw)
        x = _hold_rows(x, rules, shape)
    x = apply_norm(params["final_norm"], x, cfg)
    lg = logits(params.get("lm_head"), params["embed"], x)
    return lg, hot, _stack(chunk_kv)


def verify_chunk_step(params: dict, tokens: torch.Tensor, pools: dict,
                      hot: dict, page_table: torch.Tensor, slot: torch.Tensor,
                      start: torch.Tensor, spec, cfg, mesh=None, rules=None,
                      cache_backend=None, **kw):
    """Score a speculative token window for ONE slot.  tokens: (1, C) int, or
    (1, C, D) embeddings.

    The verify lane of self-speculative decoding: ``tokens[0]`` is the
    slot's next input token and ``tokens[1:]`` the draft continuation, at
    positions ``start + [0, C)`` where ``start`` (a device scalar) is the
    slot's committed length.  Full-fidelity weights, so ``argmax(logits[0,
    j])`` is what plain decode would emit after the same prefix.  Nothing
    is written: the scheduler commits the accepted rows of ``chunk_kv``
    into the tails itself (its rollback).  Attention-only stacks: SSM state
    cannot roll back a rejected window.  Returns ``(logits (1, C, V),
    chunk_kv)``, ``chunk_kv`` per layer position the window's group-stacked
    (k, v) in the tails' dtype.
    """
    _linear_kw(kw, cfg, mesh)
    rules, _ = _lane_layout(params, cfg, mesh, rules, kw, "verify_chunk_step",
                            tokens.shape[0])
    x = constrain(_embed_in(params, tokens, cfg), ("batch", None, None), rules)
    shape = tuple(x.shape)
    slot1 = slot.to(torch.long).reshape(1)
    row = page_table.index_select(0, slot1)[0]
    chunk_kv = _per_pos(cfg, ("k", "v"))
    for pos, bp, pool, hp in _blocks(params, cfg, pools, hot):
        if "attn" not in bp:
            raise NotImplementedError(
                "speculative verify needs an attention-only stack: SSM "
                "recurrent state cannot roll back a rejected window")
        tails = (hp["k_tail"].index_select(0, slot1),
                 hp["v_tail"].index_select(0, slot1))
        h, (ck, cv) = attn_mod.verify_attention_paged(
            bp["attn"], apply_norm(bp["norm1"], x, cfg), cfg, pool, tails, spec,
            row, start, cache_backend=cache_backend, **kw)
        chunk_kv[pos]["k"].append(ck.to(hp["k_tail"].dtype))
        chunk_kv[pos]["v"].append(cv.to(hp["v_tail"].dtype))
        x, _ = _ffn_residual(bp, x + h, cfg, kw)
        x = _hold_rows(x, rules, shape)
    x = apply_norm(params["final_norm"], x, cfg)
    lg = logits(params.get("lm_head"), params["embed"], x)
    return lg, _stack(chunk_kv)
