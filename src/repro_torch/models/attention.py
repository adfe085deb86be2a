"""GQA attention (twin of ``repro.models.attention``): chunked causal
online-softmax attention for train/prefill, cache-based decode, and the
paged decode, chunked-prefill and speculative-verify attention of the
serving runtime, as plain
torch ops that mirror the reference's arithmetic around the kernels.

Head order is kv-major, as in the reference: query head ``h`` belongs to kv
group ``h // rep`` (``q.reshape(b, nkv, rep, hd)``).

In the sharded serving layout (``spmd=True`` with a ``tp_mesh`` among the
linears' keywords; :mod:`repro_torch.models.sharding`) each rank holds its
rows of the batch and its block of the q / k / v columns over ``model``,
which need not align with heads (Qwen2-7B's 3584 q columns over 16 ranks
are 1.75 heads each): q, k and v are gathered over ``model``.  Prefill
and the train step then compute the heads that overlap
this rank's block of the columns and keep that block, which is the K block
of ``wo``'s row-parallel product.  In the backward each gather sums its
gradient over ``model`` before it takes this rank's block: a rank's heads
use part of the gathered k and v (and a head split between two ranks all
of its q), so each rank holds a part of their gradient.
Decode reads a cache whose sequence is split over ``model``: the new
token is written on the rank that holds position ``cache_len``, each rank
takes the online-softmax partial of every head over its slice of the
sequence, the partials are merged across ``model`` by
:func:`_merge_partials`'s rule, and ``wo`` runs on this rank's block.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import sharding as shd
from repro_torch.models.layers import apply_rope, linear, linear_def, tp_input

__all__ = ["attn_def", "attention", "decode_attention", "init_cache_spec",
           "decode_attention_paged", "prefill_attention_paged",
           "verify_attention_paged"]

NEG_INF = -1e30


def attn_def(cfg, lead=()) -> dict:
    d, hd = cfg.d_model, cfg.hd
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": linear_def(d, nh * hd, "embed", "qkv", bias=cfg.qkv_bias, lead=lead),
        "wk": linear_def(d, nkv * hd, "embed", "qkv", bias=cfg.qkv_bias, lead=lead),
        "wv": linear_def(d, nkv * hd, "embed", "qkv", bias=cfg.qkv_bias, lead=lead),
        "wo": linear_def(nh * hd, d, "qkv", "embed", lead=lead),
    }


def _spmd_mesh(kw: dict):
    """The mesh of the sharded serving layout, or None (any other lane)."""
    return kw.get("tp_mesh") if kw.get("spmd") else None


def _tp_block(mesh, width: int) -> tuple:
    """This rank's columns ``[c0, c1)`` of a ``width``-wide dim split over
    ``model``."""
    n = shd.axis_size(mesh, shd.tp_axis(mesh))
    c0 = shd.axis_index(mesh, shd.tp_axis(mesh)) * (width // n) if n > 1 else 0
    return c0, c0 + width // n


def _qkv(p, x, cfg, positions, **kw):
    b, s, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    x = tp_input(x, kw)
    kw_c = dict(kw, tp_pattern="col")
    q, k, v = (linear(p[n], x, **kw_c) for n in ("wq", "wk", "wv"))
    mesh = _spmd_mesh(kw)
    tp = shd.tp_axis(mesh) if mesh is not None else None
    if shd.axis_size(mesh, tp) > 1:   # each rank holds its block of the columns
        q, k, v = (shd.all_gather(t, mesh, tp, t.dim() - 1) for t in (q, k, v))
    q, k, v = q.reshape(b, s, nh, hd), k.reshape(b, s, nkv, hd), v.reshape(b, s, nkv, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _chunked_causal(q, k, v, chunk: int) -> torch.Tensor:
    """Online-softmax blocked causal attention.

    q: (B, S, H, D), k/v: (B, S, KV, D).  Returns (B, S, H, D) f32.  A
    ragged tail is zero-padded: padded keys sit at future positions (masked
    by causality for every real query) and padded query rows are sliced.
    Key chunks after the query chunk are skipped, as the reference's
    ``lax.cond`` skips them.
    """
    b, s, h, d = q.shape
    kv = k.shape[2]
    rep = h // kv
    qc = min(chunk, s)
    pad = (-s) % qc
    s_real = s
    if pad:
        q, k, v = (torch.cat([t, t.new_zeros((b, pad) + tuple(t.shape[2:]))], dim=1)
                   for t in (q, k, v))
        s += pad
    n_chunks = s // qc
    scale = 1.0 / math.sqrt(d)
    qf = (q.to(torch.float32) * scale).reshape(b, n_chunks, qc, kv, rep, d)
    kf = k.to(torch.float32).reshape(b, n_chunks, qc, kv, d)
    vf = v.to(torch.float32).reshape(b, n_chunks, qc, kv, d)
    pos = torch.arange(s, device=q.device).reshape(n_chunks, qc)

    outs = []
    for qi in range(n_chunks):
        q_i = qf[:, qi]                                       # (B, qc, KV, rep, D)
        m = q.new_full((b, kv, rep, qc), NEG_INF, dtype=torch.float32)
        l = q.new_zeros((b, kv, rep, qc), dtype=torch.float32)
        acc = q.new_zeros((b, kv, rep, qc, d), dtype=torch.float32)
        for kj in range(qi + 1):
            sc = torch.einsum("bqgrd,bkgd->bgrqk", q_i, kf[:, kj])
            mask = pos[qi][:, None] >= pos[kj][None, :]
            sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bgrqk,bkgd->bgrqd", p, vf[:, kj])
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, qc, h, d))
    return torch.cat(outs, dim=1)[:, :s_real]


def attention(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
              return_kv: bool = False, rules=None, **kw):
    """Training / prefill attention.  x: (B, S, D).  ``rules`` checks the
    heads' logical axes, as the reference pins them
    (``sharding.check_axes``); the replicated layout keeps the heads whole
    and the sharded serving layout places them by its own schedule (the
    module docstring), so the constraint moves nothing."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions, **kw)
    if cfg.attn_heads_constraint and rules is not None:
        shd.check_axes(q, ("batch", None, "heads", None), rules)
        shd.check_axes(k, ("batch", None, "kv_heads", None), rules)
        shd.check_axes(v, ("batch", None, "kv_heads", None), rules)
    mesh = _spmd_mesh(kw)
    if mesh is None:
        o = _chunked_causal(q, k, v, cfg.attn_chunk).reshape(b, s, -1)
    else:
        o = _heads_of_block(q, k, v, cfg, mesh)
    y = linear(p["wo"], o.to(x.dtype), **dict(kw, tp_pattern="row"))
    return (y, (k, v)) if return_kv else y


def _heads_of_block(q, k, v, cfg, mesh) -> torch.Tensor:
    """Causal attention of the heads that overlap this rank's block of the
    q columns, each against its kv group; returns that block of the
    output columns, (B, S, nh·hd / model) f32."""
    b, s, nh, hd = q.shape
    rep = nh // k.shape[2]
    c0, c1 = _tp_block(mesh, nh * hd)
    h0, h1 = c0 // hd, -(-c1 // hd)
    groups = torch.arange(h0, h1, device=q.device) // rep
    o = _chunked_causal(q[:, :, h0:h1], k.index_select(2, groups),
                        v.index_select(2, groups), cfg.attn_chunk)
    return o.reshape(b, s, -1)[..., c0 - h0 * hd:c1 - h0 * hd]


def decode_attention(p: dict, x: torch.Tensor, cfg, cache: tuple,
                     cache_len, **kw):
    """Single-token decode.  x: (B, 1, D); cache k/v: (B, Smax, KV, hd).

    The new token attends over ``cache[:cache_len]`` plus itself.  Unlike
    the reference's functional update, the cache is written in place at
    position ``cache_len`` (saves a cache copy per step) and returned.
    ``cache_len`` is an int or a (B,) tensor of per-row lengths.  In the
    sharded serving layout the cache holds this rank's rows and its slice
    of the sequence (its placement says which), as the module docstring
    says.
    """
    b = x.shape[0]
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rep = nh // nkv
    ck, cv = cache
    smax = ck.shape[1]
    per_slot = isinstance(cache_len, torch.Tensor) and cache_len.dim() == 1
    if per_slot:
        lens = cache_len.to(device=x.device, dtype=torch.long)
    else:
        lens = torch.full((b,), int(cache_len), dtype=torch.long, device=x.device)
    q, k, v = _qkv(p, x, cfg, lens[:, None], **kw)
    qf = (q.to(torch.float32) / math.sqrt(hd)).reshape(b, nkv, rep, hd)
    rows = torch.arange(b, device=x.device)
    mesh = _spmd_mesh(kw)
    pl = shd.placement(ck)
    seq = pl.spec[1] if mesh is not None and pl is not None else None
    if shd.axis_size(mesh, seq) > 1:        # the sequence split over ranks
        o = _decode_seq_sharded(qf, k, v, ck, cv, lens, mesh, seq)
    else:
        ck[rows, lens] = k[:, 0].to(ck.dtype)
        cv[rows, lens] = v[:, 0].to(cv.dtype)
        sc = torch.einsum("bgrd,bsgd->bgrs", qf, ck.to(torch.float32))
        valid = torch.arange(smax, device=x.device)[None, :] <= lens[:, None]
        sc = torch.where(valid[:, None, None, :], sc, torch.full_like(sc, NEG_INF))
        w = torch.softmax(sc, dim=-1)
        o = torch.einsum("bgrs,bsgd->bgrd", w, cv.to(torch.float32))
    o = o.reshape(b, 1, nh * hd)
    if mesh is not None:                    # this rank's K block of wo
        c0, c1 = _tp_block(mesh, nh * hd)
        o = o[..., c0:c1]
    y = linear(p["wo"], o.to(x.dtype), **dict(kw, tp_pattern="row"))
    return y, (ck, cv)


def _decode_seq_sharded(qf, k, v, ck, cv, lens, mesh, entry) -> torch.Tensor:
    """Flash-decode over a cache whose sequence is split over the mesh axes
    ``entry``: the new token is written on the rank whose slice holds
    position ``lens`` (per row), each rank takes the online-softmax partial
    over its slice, and the partials of every rank are merged.  Returns the
    normalized output (B, KV, rep, hd) f32, whole on every rank."""
    b = qf.shape[0]
    s_l = ck.shape[1]
    s0 = shd.axis_index(mesh, entry) * s_l
    rows = torch.arange(b, device=qf.device)
    own = (lens >= s0) & (lens < s0 + s_l)
    idx = (lens - s0).clamp(0, s_l - 1)
    for cache, new in ((ck, k), (cv, v)):
        cache[rows, idx] = torch.where(own[:, None, None], new[:, 0].to(cache.dtype),
                                       cache[rows, idx])
    pos = s0 + torch.arange(s_l, device=qf.device)
    valid = (pos[None, :] <= lens[:, None])[:, None, None, :]
    acc, m, l = _softmax_partial(qf, ck, cv, valid)
    sizes = (acc[0].numel(), m[0].numel(), l[0].numel())
    flat = torch.cat([acc.reshape(b, -1), m.reshape(b, -1), l.reshape(b, -1)], dim=-1)
    every = shd.all_gather(flat[None], mesh, entry, 0)
    parts = [tuple(t.reshape(like.shape) for t, like in
                   zip(row.split(sizes, dim=-1), (acc, m, l))) for row in every]
    return _merge_partials(parts)


def init_cache_spec(cfg, batch: int, max_len: int):
    """Shape + logical axes of one attention layer's KV cache."""
    return ((batch, max_len, cfg.n_kv_heads, cfg.hd),
            ("batch", "cache_seq", "kv_heads", "head_dim"))


# ----------------------------------------------------------- paged caches --
#
# Paged attention splits into two partials merged by their online-softmax
# states: the sealed pages, through the engine's ``cache:attn_*`` variant
# (K4 / K5 read the packed pools; the unfused fallback gathers, decodes and
# einsums), and an fp epilogue over the hot tail page plus the fresh token
# (decode) or the chunk itself (prefill).  A sealed page is valid for every
# query row or skipped, so junk pages never reach the softmax.

def _merge_partials(parts):
    """Merge unnormalized online-softmax states [(acc, m, l), ...].

    acc (..., R, hd), m/l (..., R).  An empty partial (m = NEG_INF, l = 0)
    contributes nothing: one part is never empty (the epilogue holds the
    fresh token / the chunk diagonal), so ``m_tot`` is finite and the empty
    part's correction underflows to exactly 0.
    """
    m_tot = parts[0][1]
    for _, m, _ in parts[1:]:
        m_tot = torch.maximum(m_tot, m)
    acc_tot = torch.zeros_like(parts[0][0])
    l_tot = torch.zeros_like(parts[0][2])
    for acc, m, l in parts:
        c = torch.exp(m - m_tot)
        acc_tot = acc_tot + acc * c[..., None]
        l_tot = l_tot + l * c
    return acc_tot / torch.clamp(l_tot, min=1e-30)[..., None]


def _softmax_partial(qr, k, v, valid):
    """(acc, m, l) of ``qr`` (B, KV, R, hd) against k/v (B, T, KV, hd) where
    ``valid`` (broadcast to (B, KV, R, T)) holds; one valid key per row."""
    sc = torch.einsum("bgrd,btgd->bgrt", qr, k.to(torch.float32))
    sc = torch.where(valid, sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(dim=-1)
    pexp = torch.where(valid, torch.exp(sc - m[..., None]), torch.zeros_like(sc))
    return (torch.einsum("bgrt,btgd->bgrd", pexp, v.to(torch.float32)), m,
            pexp.sum(dim=-1))


def decode_attention_paged(p: dict, x: torch.Tensor, cfg, pool: dict,
                           tails: tuple, spec, page_table: torch.Tensor,
                           cache_len: torch.Tensor, active: torch.Tensor,
                           cache_backend=None, **kw):
    """Single-token decode over a paged (possibly packed) KV cache.

    x: (B, 1, D); ``pool`` this layer's page pools (page axis leading);
    ``tails`` the slot-hot ``(k_tail, v_tail)`` (B, page_size, KV, hd);
    ``page_table`` (B, pages_per_seq) int32 (-1 = unassigned); ``cache_len``
    (B,) and ``active`` (B,) bool, all on the device.

    The fresh token is written into the tails in place, at ``cache_len %
    page_size``, for the ``active`` rows only: parked slots keep their
    tails.  The sealed pages (indices < ``cache_len //
    page_size``) run through the spec's ``cache:attn_*`` partial; the tail
    page is the fp epilogue.  Returns ``(y, tails)``.
    """
    from repro_torch.engine.cache import attn_sealed_partial
    b = x.shape[0]
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rep = nh // nkv
    kt, vt = tails
    ps = spec.page_size
    lens = cache_len.to(torch.long)
    q, k, v = _qkv(p, x, cfg, lens[:, None], **kw)

    rows = torch.arange(b, device=x.device)
    slot_pos = lens % ps
    for tail, new in ((kt, k), (vt, v)):
        tail[rows, slot_pos] = torch.where(active[:, None, None],
                                           new[:, 0].to(tail.dtype),
                                           tail[rows, slot_pos])

    qf = (q.to(torch.float32) / math.sqrt(hd)).reshape(b, nkv, rep, hd)
    n_valid = (lens // ps).to(torch.int32)
    sealed = attn_sealed_partial(pool, qf, page_table, n_valid, spec,
                                 backend=cache_backend)
    # tail index i holds absolute position n_valid * ps + i
    t_pos = (n_valid.to(torch.long) * ps)[:, None] + torch.arange(ps, device=x.device)
    valid_t = (t_pos <= lens[:, None])[:, None, None, :]
    o = _merge_partials([sealed, _softmax_partial(qf, kt, vt, valid_t)])
    y = linear(p["wo"], o.reshape(b, 1, nh * hd).to(x.dtype), **dict(kw, tp_pattern="row"))
    return y, (kt, vt)


def prefill_attention_paged(p: dict, x: torch.Tensor, cfg, pool: dict, spec,
                            table_row: torch.Tensor, start: torch.Tensor,
                            cache_backend=None, **kw):
    """Chunked-prefill attention for ONE request.  x: (1, C, D).

    The chunk sits at absolute positions ``start + [0, C)`` (``start`` a
    device scalar); chunk starts are page-aligned, so all earlier content
    is in sealed pages, each valid for every chunk row, and the sealed
    partial takes the chunk's query rows flattened into the kernel's R axis
    (row ``i`` <-> (chunk row ``i // rep``, ``i % rep``)).  The chunk
    against itself (intra-chunk causal) is the fp epilogue.  Returns ``(y,
    (k, v))`` with k/v (1, C, KV, hd); writing them into pages or the tail
    is the caller's job.
    """
    return _chunk_attention_paged(p, x, cfg, pool, None, spec, table_row, start,
                                  cache_backend, **kw)


def verify_attention_paged(p: dict, x: torch.Tensor, cfg, pool: dict,
                           tails: tuple, spec, table_row: torch.Tensor,
                           start: torch.Tensor, cache_backend=None, **kw):
    """Speculation-verify attention for ONE slot.  x: (1, C, D).

    As :func:`prefill_attention_paged`, but ``start`` (the slot's committed
    length) need not be page-aligned: the committed prefix is ``start //
    page_size`` sealed pages plus a partly filled hot tail, so a third
    online-softmax partial joins the sealed pages and the causal chunk --
    the tail's committed rows (tail index ``i`` holds position ``(start //
    ps) * ps + i``, valid strictly below ``start``: rows at or after it may
    hold stale draft KV and never score).  ``tails`` is the slot's
    ``(k_tail, v_tail)``, (1, page_size, KV, hd).  Nothing is written;
    returns ``(y, (k, v))`` and the caller commits the accepted rows.
    """
    return _chunk_attention_paged(p, x, cfg, pool, tails, spec, table_row, start,
                                  cache_backend, **kw)


def _chunk_attention_paged(p, x, cfg, pool, tails, spec, table_row, start,
                           cache_backend, **kw):
    """One request's chunk at positions ``start + [0, C)`` against the
    sealed pages before ``start // page_size``, the ``tails`` rows below
    ``start`` (none when ``tails`` is None) and itself, causal."""
    from repro_torch.engine.cache import attn_sealed_partial
    b, c, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rep = nh // nkv
    ps = spec.page_size
    start_l = start.to(torch.long)
    positions = (start_l + torch.arange(c, device=x.device))[None, :]
    q, k, v = _qkv(p, x, cfg, positions.expand(b, c), **kw)

    qf5 = (q.to(torch.float32) / math.sqrt(hd)).reshape(b, c, nkv, rep, hd)
    qr = qf5.permute(0, 2, 1, 3, 4).reshape(b, nkv, c * rep, hd)
    n_valid = (start_l // ps).to(torch.int32).reshape(1).expand(b)
    parts = [attn_sealed_partial(pool, qr, table_row[None, :], n_valid, spec,
                                 backend=cache_backend)]
    if tails is not None:
        t_pos = (start_l // ps) * ps + torch.arange(ps, device=x.device)
        parts.append(_softmax_partial(qr, *tails, (t_pos < start_l)[None, None, None, :]))
    # query row i = (chunk row i // rep, i % rep) sees keys k <= i // rep
    qrow = torch.arange(c * rep, device=x.device) // rep
    causal = (qrow[:, None] >= torch.arange(c, device=x.device)[None, :])[None, None]
    o = _merge_partials(parts + [_softmax_partial(qr, k, v, causal)])
    o = o.reshape(b, nkv, c, rep, hd).permute(0, 2, 1, 3, 4)
    y = linear(p["wo"], o.reshape(b, c, nh * hd).to(x.dtype), **dict(kw, tp_pattern="row"))
    return y, (k, v)
