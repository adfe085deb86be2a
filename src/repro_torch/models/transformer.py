"""Decoder stack, the dense and MoE families of
``repro.models.transformer``: ``model_defs``, ``forward_train`` (forward
only), ``prefill`` and ``decode_step``, and the serving runtime's paged
lanes ``decode_step_paged``, ``prefill_chunk_step`` and
``verify_chunk_step``.

Parameters keep the reference layout: per period position ``pos{i}``,
every leaf stacked with a leading ``n_groups`` dim.  The period is the lcm
of the MoE period (``moe_every``) and 1; a position whose layer is MoE
holds ``moe`` (router + expert stacks) in place of ``mlp``.  The
reference's ``lax.scan`` over groups is a Python loop here that slices
group ``g`` out of every tensor (packed payload fields included).  SSM and
hybrid stacks are not ported yet (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import moe
from repro_torch.models.layers import (apply_norm, embed_def, embed_lookup,
                                       linear_def, logits, mlp, mlp_def,
                                       norm_def)

__all__ = ["period", "n_groups", "model_defs", "forward_train", "prefill",
           "decode_step", "decode_step_paged", "prefill_chunk_step",
           "verify_chunk_step"]


def _check_family(cfg) -> None:
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is not "
                                  f"ported yet (Mamba-2)")


def period(cfg) -> int:
    """Layers per scan group: the lcm of the MoE period and 1 (the
    reference's lcm with the attention period matters only for hybrids)."""
    _check_family(cfg)
    p = 1
    if cfg.n_experts and cfg.moe_every > 1:
        p = math.lcm(p, cfg.moe_every)
    if cfg.n_layers % p:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is not a "
                         f"multiple of the period {p}")
    return p


def n_groups(cfg) -> int:
    return cfg.n_layers // period(cfg)


def _block_def(cfg, pos: int, lead) -> dict:
    d = {"norm1": norm_def(cfg, lead), "attn": attn_mod.attn_def(cfg, lead)}
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


def _group(tree: Any, g: int) -> Any:
    """Group ``g`` of a stacked tree: every tensor indexed at ``[g]``;
    static leaf metadata (cfg, spec) passes through."""
    if isinstance(tree, dict):
        return {k: _group(v, g) for k, v in tree.items()}
    return tree[g] if isinstance(tree, torch.Tensor) else tree


def _ffn_residual(bp, x, cfg, kw):
    """x + the block's MLP or MoE FFN; returns (x, MoE aux loss or 0)."""
    if cfg.d_ff <= 0:
        return x, 0.0
    h = apply_norm(bp["norm2"], x, cfg)
    if "moe" in bp:
        h, aux = moe.moe_apply(bp["moe"], h, cfg, **kw)
        return x + h, aux
    return x + mlp(bp["mlp"], h, cfg, **kw), 0.0


def _embed_in(params, tokens, cfg):
    return embed_lookup(params["embed"], tokens, cfg.activation_dtype)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device, dtype=torch.int32)[None].expand(b, s)


def forward_train(params: dict, batch: dict, cfg, **kw):
    """Full forward; returns (logits f32, aux): aux is the MoE load-balance
    loss summed over layers (0 for the dense family)."""
    kw.setdefault("strum", cfg.strum)
    x = _embed_in(params, batch["tokens"], cfg)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(n_groups(cfg)):
        gp = _group(params["blocks"], g)
        for i in range(period(cfg)):
            bp = gp[f"pos{i}"]
            x = x + attn_mod.attention(bp["attn"], apply_norm(bp["norm1"], x, cfg),
                                       cfg, positions, **kw)
            x, a = _ffn_residual(bp, x, cfg, kw)
            aux = aux + a
    x = apply_norm(params["final_norm"], x, cfg)
    return logits(params.get("lm_head"), params["embed"], x), aux


def prefill(params: dict, batch: dict, cfg, **kw):
    """Forward over a prompt; returns (last-token logits (B, 1, V) f32,
    caches ``{"pos{i}": {"k", "v"}}`` stacked as (groups, B, S, KV, hd))."""
    kw.setdefault("strum", cfg.strum)
    x = _embed_in(params, batch["tokens"], cfg)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    kv: dict = {f"pos{i}": {"k": [], "v": []} for i in range(period(cfg))}
    for g in range(n_groups(cfg)):
        gp = _group(params["blocks"], g)
        for i in range(period(cfg)):
            bp = gp[f"pos{i}"]
            h, (k, v) = attn_mod.attention(bp["attn"],
                                           apply_norm(bp["norm1"], x, cfg), cfg,
                                           positions, return_kv=True, **kw)
            kv[f"pos{i}"]["k"].append(k.to(cfg.activation_dtype))
            kv[f"pos{i}"]["v"].append(v.to(cfg.activation_dtype))
            x, _ = _ffn_residual(bp, x + h, cfg, kw)
    x = apply_norm(params["final_norm"], x, cfg)
    lg = logits(params.get("lm_head"), params["embed"], x[:, -1:, :])
    caches = {pos: {n: torch.stack(ts) for n, ts in c.items()}
              for pos, c in kv.items()}
    return lg, caches


def decode_step(params: dict, token: torch.Tensor, caches: dict, cache_len,
                cfg, **kw):
    """One decode step.  token: (B, 1) int.  Returns (logits (B, 1, V) f32,
    caches); the caches are updated in place at ``cache_len``."""
    kw.setdefault("strum", cfg.strum)
    x = _embed_in(params, token, cfg)
    for g in range(n_groups(cfg)):
        gp = _group(params["blocks"], g)
        for i in range(period(cfg)):
            bp, c = gp[f"pos{i}"], caches[f"pos{i}"]
            h, _ = attn_mod.decode_attention(
                bp["attn"], apply_norm(bp["norm1"], x, cfg), cfg,
                (c["k"][g], c["v"][g]), cache_len, **kw)
            x, _ = _ffn_residual(bp, x + h, cfg, kw)
    x = apply_norm(params["final_norm"], x, cfg)
    return logits(params.get("lm_head"), params["embed"], x), caches


# -------------------------------------------------------- paged serving --
#
# The serving runtime's lanes (repro_torch.serving.scheduler): a decode
# step over every slot, a chunked-prefill step over one slot and the
# speculative verify step over one slot, all reading KV through the page
# table.  ``pools`` holds the sealed pages per
# layer position, ``hot`` the per-slot tail pages.  Shapes are fixed per
# lane -- (n_slots, 1), (1, chunk) and (1, k + 1) -- and ``slot`` / ``start`` /
# ``valid_len`` / ``cache_len`` are device tensors, so no shape depends on
# a prompt's length and no step reads a value back to the host.  The tails
# are updated in place (the reference returns new ones); sealing full pages
# into the pools happens between steps, on the host.

def decode_step_paged(params: dict, token: torch.Tensor, pools: dict,
                      hot: dict, cache_len: torch.Tensor,
                      page_table: torch.Tensor, active: torch.Tensor,
                      spec, cfg, cache_backend=None, **kw):
    """One decode step over paged caches.  token: (B, 1) int.

    ``active`` (B,) bool masks the tail writes: parked slots and slots mid-
    prefill ride the fixed-shape batch but keep their tails.  Returns
    (logits (B, 1, V) f32, hot), ``hot`` updated in place.
    """
    kw.setdefault("strum", cfg.strum)
    x = _embed_in(params, token, cfg)
    for g in range(n_groups(cfg)):
        gp, pool_g, hot_g = (_group(params["blocks"], g), _group(pools, g),
                             _group(hot, g))
        for i in range(period(cfg)):
            bp, hp = gp[f"pos{i}"], hot_g[f"pos{i}"]
            h, _ = attn_mod.decode_attention_paged(
                bp["attn"], apply_norm(bp["norm1"], x, cfg), cfg, pool_g[f"pos{i}"],
                (hp["k_tail"], hp["v_tail"]), spec, page_table, cache_len,
                active=active, cache_backend=cache_backend, **kw)
            x, _ = _ffn_residual(bp, x + h, cfg, kw)
    x = apply_norm(params["final_norm"], x, cfg)
    return logits(params.get("lm_head"), params["embed"], x), hot


def prefill_chunk_step(params: dict, tokens: torch.Tensor, pools: dict,
                       hot: dict, page_table: torch.Tensor, slot: torch.Tensor,
                       start: torch.Tensor, valid_len: torch.Tensor,
                       spec, cfg, cache_backend=None, **kw):
    """One fixed-shape prefill chunk for ONE slot.  tokens: (1, C) int.

    ``slot`` / ``start`` / ``valid_len`` are device scalars.  Returns
    ``(logits (1, C, V), hot, chunk_kv)``: the first generated token is
    ``argmax(logits[0, valid_len - 1])`` on the last chunk, and ``chunk_kv``
    (per layer position, the chunk's group-stacked (k, v)) is what the host
    seals into full pages.  The slot's tail page gets the ragged remainder
    ``[floor(valid_len / ps) * ps, valid_len)`` of the chunk, written in
    place.
    """
    kw.setdefault("strum", cfg.strum)
    ps = spec.page_size
    x = _embed_in(params, tokens, cfg)
    c = x.shape[1]
    slot1 = slot.to(torch.long).reshape(1)
    row = page_table.index_select(0, slot1)[0]
    # chunk starts are page-aligned, so the tail starts at a page boundary
    # of the chunk; the clamp keeps a full chunk's slice in bounds (its tail
    # is then empty and masked by length)
    tail_rel = torch.clamp((valid_len.to(torch.long) // ps) * ps, 0, c - ps)
    tail_idx = tail_rel + torch.arange(ps, device=x.device)
    chunk_kv: dict = {f"pos{i}": {"k": [], "v": []} for i in range(period(cfg))}
    for g in range(n_groups(cfg)):
        gp, pool_g, hot_g = (_group(params["blocks"], g), _group(pools, g),
                             _group(hot, g))
        for i in range(period(cfg)):
            bp, hp = gp[f"pos{i}"], hot_g[f"pos{i}"]
            h, (ck, cv) = attn_mod.prefill_attention_paged(
                bp["attn"], apply_norm(bp["norm1"], x, cfg), cfg, pool_g[f"pos{i}"],
                spec, row, start, cache_backend=cache_backend, **kw)
            for name, kv in (("k", ck), ("v", cv)):
                kv = kv.to(hp[f"{name}_tail"].dtype)
                chunk_kv[f"pos{i}"][name].append(kv)
                hp[f"{name}_tail"].index_copy_(0, slot1, kv[:, tail_idx])
            x, _ = _ffn_residual(bp, x + h, cfg, kw)
    x = apply_norm(params["final_norm"], x, cfg)
    lg = logits(params.get("lm_head"), params["embed"], x)
    return lg, hot, {pos: {n: torch.stack(ts) for n, ts in c_.items()}
                     for pos, c_ in chunk_kv.items()}


def verify_chunk_step(params: dict, tokens: torch.Tensor, pools: dict,
                      hot: dict, page_table: torch.Tensor, slot: torch.Tensor,
                      start: torch.Tensor, spec, cfg, cache_backend=None, **kw):
    """Score a speculative token window for ONE slot.  tokens: (1, C) int.

    The verify lane of self-speculative decoding: ``tokens[0]`` is the
    slot's next input token and ``tokens[1:]`` the draft continuation, at
    positions ``start + [0, C)`` where ``start`` (a device scalar) is the
    slot's committed length.  Full-fidelity weights, so ``argmax(logits[0,
    j])`` is what plain decode would emit after the same prefix.  Nothing
    is written: the scheduler commits the accepted rows of ``chunk_kv``
    into the tails itself (its rollback).  Returns ``(logits (1, C, V),
    chunk_kv)``, ``chunk_kv`` per layer position the window's
    group-stacked (k, v) in the tails' dtype.
    """
    kw.setdefault("strum", cfg.strum)
    x = _embed_in(params, tokens, cfg)
    slot1 = slot.to(torch.long).reshape(1)
    row = page_table.index_select(0, slot1)[0]
    chunk_kv: dict = {f"pos{i}": {"k": [], "v": []} for i in range(period(cfg))}
    for g in range(n_groups(cfg)):
        gp, pool_g, hot_g = (_group(params["blocks"], g), _group(pools, g),
                             _group(hot, g))
        for i in range(period(cfg)):
            bp, hp = gp[f"pos{i}"], hot_g[f"pos{i}"]
            if "attn" not in bp:
                raise NotImplementedError(
                    "speculative verify needs an attention-only stack: SSM "
                    "recurrent state cannot roll back a rejected window")
            tails = (hp["k_tail"].index_select(0, slot1),
                     hp["v_tail"].index_select(0, slot1))
            h, (ck, cv) = attn_mod.verify_attention_paged(
                bp["attn"], apply_norm(bp["norm1"], x, cfg), cfg, pool_g[f"pos{i}"],
                tails, spec, row, start, cache_backend=cache_backend, **kw)
            chunk_kv[f"pos{i}"]["k"].append(ck.to(hp["k_tail"].dtype))
            chunk_kv[f"pos{i}"]["v"].append(cv.to(hp["v_tail"].dtype))
            x, _ = _ffn_residual(bp, x + h, cfg, kw)
    x = apply_norm(params["final_norm"], x, cfg)
    lg = logits(params.get("lm_head"), params["embed"], x)
    return lg, {pos: {n: torch.stack(ts) for n, ts in c_.items()}
                for pos, c_ in chunk_kv.items()}
