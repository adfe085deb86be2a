"""Sealed-page partial of paged attention over StruM-packed KV pools: the
Hopper kernels K4 / K5 and their plain PyTorch versions.

``strum_paged_attention`` (K4, mask + hi + lo pages) and
``strum_paged_attention_maskfree`` (K5, p = 1 pages: lo + scale only)
replace ``strum_paged_attention_pallas`` and
``strum_paged_attention_pallas_maskfree`` of
``repro/kernels/strum_attention.py``.  Both compute, per (slot, kv head),
the unnormalized online-softmax state over the slot's sealed pages:

    q4        (B, KV, R, hd) f32 query rows, pre-scaled by 1/sqrt(hd)
    pools     per-page fields (n_pages, nb, rows, F), F = KV·hd, and
              scale (n_pages, 1, F) f32 -- the pools themselves
    page_ids  (B, P) int32, -1 = unassigned
    n_valid   (B,) int32: pages strictly before it are sealed and valid
    ->  acc (B, KV, R, hd), m (B, KV, R), l (B, KV, R), all f32

A page is live when its id is >= 0 (and inside the pool) and its index is
below ``n_valid``; ``m = -1e30``, ``l = 0``, ``acc = 0`` where a slot has no
live page.  Unlike the reference, which gathers a per-(slot, page) copy of
the packed bytes before its kernel runs, the CUDA kernel reads the pools by
page id itself, so the packed bytes cross HBM once.  The CUDA source is
``csrc/strum_attention.cu``.

R is the query rows sharing one kv head: ``rep`` in decode, ``chunk·rep``
in chunked prefill, with row ``i`` <-> (chunk row ``i // rep``, ``i % rep``).

CPU tensors run the plain version, CUDA tensors launch the kernel, anything
else raises; no fallback.  ``launch_counts`` counts launches.  The plain
version walks the pages in one pass: page by page, decode K and V, scores,
running max, rescale, accumulate, with a non-live page leaving the state as
it was.

K4 and K5 split the table's page slots across blocks (flash-decoding):
``split_pages`` picks the page slots per split, each split writes its own
partial, and a second kernel (``launch_counts["paged_attention_combine"]``
after K4, ``["paged_attention_maskfree_combine"]`` after K5, one launch per
call with more than one split) merges them in split-index order.
``strum_paged_attention_split_plain`` mirrors that split and merge on the
CPU (``merge_split_partials_plain``) for either kernel; the tests hold it
to the one-pass version.  On the card both take any page size (a page is
walked in pieces of at most 64 positions), any head dim up to 256 and
fields at any alignment (staged by plain loads where 16-byte copies do not
fit); the wrapper raises on a head dim over 256 or w over 64, which the
registry does not select them for.
"""
from __future__ import annotations

import functools
import math
import types
from typing import Optional

import torch

from repro_torch.kernels import hooks
from repro_torch.kernels import strum_decode as D
from repro_torch.kernels.strum_matmul import METHOD_CODES, _route

__all__ = ["strum_paged_attention", "strum_paged_attention_maskfree",
           "strum_paged_attention_plain", "strum_paged_attention_maskfree_plain",
           "strum_paged_attention_split_plain", "merge_split_partials_plain",
           "split_pages", "launch_counts", "reset_launch_counts", "NEG_INF",
           "launch_contract"]

NEG_INF = -1e30

#: kernel name -> launches since the last reset
launch_counts = {"paged_attention": 0, "paged_attention_combine": 0,
                 "paged_attention_maskfree": 0,
                 "paged_attention_maskfree_combine": 0}

MAX_SPLIT_PAGES = 32  # page slots of one split (kMaxSplitPages in the source)
MAX_HEAD_DIM = 256    # kMaxHeadDim: 32 lanes x 8 columns
MAX_BLOCK_WIDTH = 64  # kMaxPageSize: a piece holds at least one [1, w] block
_MIN_SPLIT_PAGES = 4  # fewer and the combine's reads outweigh the split
_BLOCKS_PER_SM = 8    # K4 blocks to aim for on every SM


def split_pages(n_slots: int, n_pages: int, heads: int, sms: int) -> int:
    """Page slots per K4 (K5) split for a table of ``n_pages`` slots per slot,
    ``heads`` (slot, kv head, row tile) blocks before splitting and ``sms``
    SMs: enough splits for ``_BLOCKS_PER_SM`` blocks an SM, none shorter
    than ``_MIN_SPLIT_PAGES`` page slots, none longer than
    ``MAX_SPLIT_PAGES``.  The splits are ``ceil(n_pages / pps)``."""
    want = math.ceil(_BLOCKS_PER_SM * sms / max(n_slots * heads, 1))
    splits = max(math.ceil(n_pages / MAX_SPLIT_PAGES),
                 min(want, math.ceil(n_pages / _MIN_SPLIT_PAGES)), 1)
    return math.ceil(n_pages / splits)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# --------------------------------------------------------- plain versions --

def _online_plain(q4, page_ids, n_valid, n_pages: int, decode):
    """The kernel's page loop on whole batches: ``decode(ids)`` returns the
    (B, page_size, F) K and V values of page ``ids`` of every slot."""
    b, kv, r, hd = q4.shape
    qf = q4.to(torch.float32)
    acc = qf.new_zeros((b, kv, r, hd))
    m = qf.new_full((b, kv, r), NEG_INF)
    l = qf.new_zeros((b, kv, r))
    ids_all = page_ids.to(torch.long)
    nv = n_valid.reshape(b).to(torch.long)
    for p in range(page_ids.shape[1]):
        ids = ids_all[:, p]
        live = (ids >= 0) & (ids < n_pages) & (p < nv)
        kt, vt = decode(ids.clamp(0, n_pages - 1))
        kt = kt.reshape(b, -1, kv, hd)
        vt = vt.reshape(b, -1, kv, hd)
        sc = torch.einsum("bgrd,bsgd->bgrs", qf, kt)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        pexp = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + pexp.sum(dim=-1)
        acc_new = acc * corr[..., None] + torch.einsum("bgrs,bsgd->bgrd", pexp, vt)
        lv = live[:, None, None]
        m = torch.where(lv, m_new, m)
        l = torch.where(lv, l_new, l)
        acc = torch.where(lv[..., None], acc_new, acc)
    return acc, m, l


def strum_paged_attention_plain(q4, k_mask, k_hi, k_lo, k_scale, v_mask, v_hi,
                                v_lo, v_scale, page_ids, n_valid, *, w: int,
                                n_low: int, q: int, method: str):
    kw = dict(w=w, n_low=n_low, q=q, method=method)

    def decode(ids):
        def one(mask, hi, lo, scale):
            return D.strum_page_decode_plain(mask[ids], hi[ids], lo[ids], scale[ids],
                                             **kw)
        return one(k_mask, k_hi, k_lo, k_scale), one(v_mask, v_hi, v_lo, v_scale)
    return _online_plain(q4, page_ids, n_valid, k_mask.shape[0], decode)


def merge_split_partials_plain(parts):
    """The combine kernel's merge of per-split partials ``[(acc, m, l), ...]``
    in split-index order: M = max m_s, l = sum l_s e^(m_s - M), acc = sum
    acc_s e^(m_s - M).  All splits empty gives the identity partial."""
    m = parts[0][1]
    for _, ms, _ in parts[1:]:
        m = torch.maximum(m, ms)
    acc, l = torch.zeros_like(parts[0][0]), torch.zeros_like(m)
    for acc_s, m_s, l_s in parts:
        e = torch.exp(m_s - m)
        acc = acc + acc_s * e[..., None]
        l = l + l_s * e
    return acc, m, l


def strum_paged_attention_split_plain(q4, *args, pages_per_split: int,
                                      maskfree: bool = False, **kw):
    """K4's (``maskfree=True``: K5's) split and merge on plain tensors.
    ``args`` are the pool fields the kernel takes, then ``page_ids`` and
    ``n_valid``; ``kw`` the plain version's codec arguments.  Split ``s``
    owns the table's page slots ``[s·pps, (s+1)·pps)`` (the others read as
    -1), each split is the one-pass partial over its slots, and the splits
    merge in order."""
    plain = strum_paged_attention_maskfree_plain if maskfree else \
        strum_paged_attention_plain
    *fields, page_ids, n_valid = args
    p = page_ids.shape[1]
    col = torch.arange(p, device=page_ids.device)
    parts = []
    for s0 in range(0, p, pages_per_split):
        own = (col >= s0) & (col < s0 + pages_per_split)
        ids = torch.where(own[None, :], page_ids, torch.full_like(page_ids, -1))
        parts.append(plain(q4, *fields, ids, n_valid, **kw))
    return merge_split_partials_plain(parts)


def strum_paged_attention_maskfree_plain(q4, k_lo, k_scale, v_lo, v_scale,
                                         page_ids, n_valid, *, w: int, q: int,
                                         method: str):
    def decode(ids):
        return (D.decode_lo_pages(k_lo[ids], k_scale[ids], w=w, q=q, method=method),
                D.decode_lo_pages(v_lo[ids], v_scale[ids], w=w, q=q, method=method))
    return _online_plain(q4, page_ids, n_valid, k_lo.shape[0], decode)


# ------------------------------------------------------------ CUDA launch --

_CU = "csrc/strum_attention.cu"


def _row_tile(r: int, hd: int) -> int:
    """K4's and K5's query rows per block (the launcher's rule)."""
    return 1 if r == 1 else 8 if (r <= 8 or hd > 128) else 16


def launch_contract(name: str, b: int, kv: int, r: int, hd: int, p: int,
                    n_pages: int, nb: int, w: int, n_low: int, q: int, method: str, *,
                    fields=None, v_fields=None, sms=None) -> dict:
    """Everything K4 (``name`` "paged_attention") or K5
    ("paged_attention_maskfree") refuses, from shapes and dtypes alone:
    raises ``ValueError`` with the reason, naming the line of
    ``csrc/strum_attention.cu`` where its entry point returns
    ``cudaErrorInvalidValue`` for the same point.  The launcher calls it
    first.

    q4 is ``(B, KV, R, hd)``, the table ``(B, P)``, the pools ``n_pages``
    pages of ``nb`` blocks of width ``w`` over ``F = KV * hd`` channels;
    ``fields`` maps each K pool field the kernel reads to ``(shape, dtype)``
    (default: the packer's rows), ``v_fields`` the V pool's (default: the
    same; the kernel takes one set of rows for both); ``sms``, the card's
    SM count, adds the split.  Returns a read-only mapping (cached per argument set)
    ``{"pps", "splits", "rows"}``: page slots per split,
    splits, and the (mask, hi, lo) rows a block."""
    return _contract(name, b, kv, r, hd, p, n_pages, nb, w, n_low, q, method,
                     None if fields is None else tuple(fields.items()),
                     None if v_fields is None else tuple(v_fields.items()), sms)


@functools.lru_cache(maxsize=4096)
def _contract(name, b, kv, r, hd, p, n_pages, nb, w, n_low, q, method, fields,
              v_fields, sms):
    fields = None if fields is None else dict(fields)
    if name not in ("paged_attention", "paged_attention_maskfree"):
        raise ValueError(f"no paged-attention kernel {name!r}")
    tag = f"cuda:{name}"

    def refuse(why: str, line: Optional[int] = None):
        raise ValueError(f"{tag}: {why}" + (f" ({_CU}:{line})" if line else ""))

    maskfree = name == "paged_attention_maskfree"
    if min(b, kv, r, p, nb, n_pages) < 1 or hd < 1 or w < 1 or not 0 <= n_low <= w:
        refuse(f"B={b} KV={kv} R={r} P={p} pages={n_pages} nb={nb} hd={hd} w={w} "
               f"n_low={n_low} out of range", 868)
    if hd > MAX_HEAD_DIM:
        refuse(f"head dim {hd} > {MAX_HEAD_DIM}", 868)
    if w > MAX_BLOCK_WIDTH:
        refuse(f"block width w={w} > {MAX_BLOCK_WIDTH}", 868)
    if method != "sparsity" and not 1 <= q <= 8:
        refuse(f"q={q} outside [1, 8]", 868)
    if maskfree and (method == "sparsity" or n_low != w):
        refuse(f"needs a lo payload at n_low == w, got {method} n_low={n_low}", 873)
    if not maskfree and w % 8:
        refuse(f"needs byte-aligned mask rows (w={w})", 870)
    least = {"mask": (torch.uint8, w // 8), "hi": (torch.int8, w - n_low),
             "lo": (torch.uint8, 0 if method == "sparsity" else -(-(n_low * q) // 8))}
    reads = ("lo",) if maskfree else ("mask", "hi", "lo")
    if fields is None:
        fields = {f: ((n_pages, nb, max(least[f][1], 1), kv * hd), least[f][0])
                  for f in reads}
    rows = {"mask": 0, "hi": 0, "lo": 0}
    for f, (shape, dtype) in fields.items():
        want, low = least[f]
        if dtype != want or len(shape) != 4 or tuple(shape[:2]) != (n_pages, nb) \
                or shape[3] != kv * hd or shape[2] < max(low, 1):
            # K5's entry point refuses lo rows short of w * q / 8 itself
            refuse(f"{f} {tuple(shape)} {dtype} does not fit ({n_pages}, {nb}, "
                   f">= {max(low, 1)}, {kv * hd}) {want}",
                   873 if maskfree and f == "lo" else None)
        rows[f] = shape[2]
    if v_fields is not None and dict(v_fields) != fields:
        refuse(f"V pool fields {dict(v_fields)} are not K's {fields}")
    if not maskfree and rows["mask"] != w // 8:
        refuse(f"mask has {rows['mask']} rows a block; the kernel reads w/8 = {w // 8}",
               870)
    if kv * -(-r // _row_tile(r, hd)) > 65535 or b > 65535:
        refuse(f"grid of {b} slots x {kv * -(-r // _row_tile(r, hd))} head tiles "
               f"past 65535", 882)
    out = {"pps": None, "splits": None, "rows": (rows["mask"], rows["hi"], rows["lo"])}
    if sms is not None:
        pps = split_pages(b, p, kv * -(-r // _row_tile(r, hd)), sms)
        if not 1 <= pps <= MAX_SPLIT_PAGES:
            refuse(f"{pps} page slots a split outside [1, {MAX_SPLIT_PAGES}]", 868)
        out.update(pps=pps, splits=-(-p // pps))
    return types.MappingProxyType(out)


def _check_operands(name: str, q4, k: dict, v: dict, page_ids, n_valid, *,
                    w: int, n_low: int, q: int, method: str):
    """The launch contract, then what it cannot see: every operand on q4's
    device and contiguous, and the scales; returns the contract's route,
    the page table and ``n_valid`` as contiguous int32 there.  ``k`` /
    ``v`` map field names to pool tensors; a field the kernel does not
    read is absent."""
    dev = q4.device
    b, kv, r, hd = q4.shape
    n_pages, nb = k["lo"].shape[:2]
    if page_ids.dim() != 2 or page_ids.shape[0] != b:
        raise ValueError(f"cuda:{name}: page_ids {tuple(page_ids.shape)} is not "
                         f"(B={b}, P)")
    shapes = lambda pool: {f: (tuple(t.shape), t.dtype)  # noqa: E731
                           for f, t in pool.items() if f != "scale"}
    route = launch_contract(name, b, kv, r, hd, page_ids.shape[1], n_pages, nb, w,
                            n_low, q, method, fields=shapes(k), v_fields=shapes(v),
                            sms=_sm_count(dev))
    if q4.dtype != torch.float32 or not q4.is_contiguous():
        raise ValueError(f"cuda:{name}: q4 must be contiguous float32")
    for pool in (k, v):
        D.check_placed(f"cuda:{name}", {f: t for f, t in pool.items() if f != "scale"},
                       dev)
        D.check_scale(f"cuda:{name}", pool["scale"], n_pages, kv * hd, dev)
    ids = page_ids.to(device=dev, dtype=torch.int32).contiguous()
    nv = n_valid.to(device=dev, dtype=torch.int32).reshape(b).contiguous()
    return route, ids, nv


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_split(name: str, q4, k: dict, v: dict, page_ids, n_valid, *, w: int,
                  n_low: int, q: int, method: str):
    """K4 (``name`` "paged_attention": mask, hi, lo, scale) or K5
    ("paged_attention_maskfree": lo, scale) on q4's stream: the split
    partials, then (more than one split) the combine kernel, counted under
    ``name + "_combine"``; partials live in ``torch.empty`` scratch."""
    route, ids, nv = _check_operands(name, q4, k, v, page_ids, n_valid, w=w,
                                     n_low=n_low, q=q, method=method)
    dev = q4.device
    b, kv, r, hd = q4.shape
    n_pages, nb = k["lo"].shape[:2]
    p = ids.shape[1]
    pps, splits = route["pps"], route["splits"]
    acc = torch.empty((splits, b, kv, r, hd), dtype=torch.float32, device=dev)
    m = torch.empty((splits, b, kv, r), dtype=torch.float32, device=dev)
    l = torch.empty((splits, b, kv, r), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    so = D.lib()
    fields = tuple(k)            # the pool fields this kernel reads, in order
    head = (q4.data_ptr(), *(pool[fn].data_ptr() for pool in (k, v) for fn in fields),
            ids.data_ptr(), nv.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            b, kv, r, hd, p, n_pages, pps, nb, w)
    if name == "paged_attention":
        err = so.strum_paged_attention_split_launch(
            *head, *route["rows"], n_low, q, METHOD_CODES[method], stream)
    else:
        err = so.strum_paged_attention_maskfree_split_launch(
            *head, route["rows"][2], q, METHOD_CODES[method], stream)
    if err != 0:
        raise RuntimeError(f"cuda:{name} launch failed: CUDA error {err}")
    launch_counts[name] += 1
    if splits == 1:
        return acc[0], m[0], l[0]
    out = (torch.empty((b, kv, r, hd), dtype=torch.float32, device=dev),
           torch.empty((b, kv, r), dtype=torch.float32, device=dev),
           torch.empty((b, kv, r), dtype=torch.float32, device=dev))
    err = so.strum_attention_combine_launch(
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), *(t.data_ptr() for t in out),
        splits, b * kv * r, hd, stream)
    if err != 0:
        raise RuntimeError(f"cuda:{name}_combine launch failed: CUDA error {err}")
    launch_counts[f"{name}_combine"] += 1
    return out


def strum_paged_attention(q4, k_mask, k_hi, k_lo, k_scale, v_mask, v_hi, v_lo,
                          v_scale, page_ids, n_valid, *, w: int, n_low: int,
                          q: int, method: str):
    """K4: sealed-page partial (acc, m, l) over mask + hi + lo pools; needs
    w % 8 == 0 (on the card also w <= 64 and head dim <= 256).  Empty fields
    come floored at one row."""
    if hooks.active is not None:     # a dataflow trace: record the call, then run it
        return hooks.active.kernel(
            "cache:attn_fused", strum_paged_attention, q4, k_mask, k_hi, k_lo, k_scale,
            v_mask, v_hi, v_lo, v_scale, page_ids, n_valid, w=w, n_low=n_low, q=q,
            method=method)
    if w % 8:
        raise ValueError(f"paged attention needs byte-aligned mask rows (w={w})")
    if _route(q4) == "plain":
        return strum_paged_attention_plain(
            q4, k_mask, k_hi, k_lo, k_scale, v_mask, v_hi, v_lo, v_scale, page_ids,
            n_valid, w=w, n_low=n_low, q=q, method=method)
    return _launch_split("paged_attention", q4,
                         dict(mask=k_mask, hi=k_hi, lo=k_lo, scale=k_scale),
                         dict(mask=v_mask, hi=v_hi, lo=v_lo, scale=v_scale),
                         page_ids, n_valid, w=w, n_low=n_low, q=q, method=method)


def strum_paged_attention_maskfree(q4, k_lo, k_scale, v_lo, v_scale, page_ids,
                                   n_valid, *, w: int, q: int, method: str):
    """K5 (p = 1): the partial from lo + scale only; reads no mask or hi (on
    the card w <= 64 and head dim <= 256)."""
    if hooks.active is not None:     # a dataflow trace: record the call, then run it
        return hooks.active.kernel(
            "cache:attn_fused_maskfree", strum_paged_attention_maskfree, q4, k_lo,
            k_scale, v_lo, v_scale, page_ids, n_valid, w=w, q=q, method=method)
    if method not in ("dliq", "mip2q"):
        raise ValueError(f"maskfree attention needs a lo payload, got {method!r}")
    if _route(q4) == "plain":
        return strum_paged_attention_maskfree_plain(
            q4, k_lo, k_scale, v_lo, v_scale, page_ids, n_valid, w=w, q=q,
            method=method)
    return _launch_split("paged_attention_maskfree", q4, dict(lo=k_lo, scale=k_scale),
                         dict(lo=v_lo, scale=v_scale), page_ids, n_valid, w=w, n_low=w,
                         q=q, method=method)
