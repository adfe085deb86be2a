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
version repeats the kernel's loop: page by page, decode K and V, scores,
running max, rescale, accumulate, with a non-live page leaving the state as
it was.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import strum_decode as D
from repro_torch.kernels.strum_matmul import METHOD_CODES, _route

__all__ = ["strum_paged_attention", "strum_paged_attention_maskfree",
           "strum_paged_attention_plain", "strum_paged_attention_maskfree_plain",
           "launch_counts", "reset_launch_counts", "NEG_INF"]

NEG_INF = -1e30

#: kernel name -> launches since the last reset
launch_counts = {"paged_attention": 0, "paged_attention_maskfree": 0}


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


def strum_paged_attention_maskfree_plain(q4, k_lo, k_scale, v_lo, v_scale,
                                         page_ids, n_valid, *, w: int, q: int,
                                         method: str):
    def decode(ids):
        return (D.decode_lo_pages(k_lo[ids], k_scale[ids], w=w, q=q, method=method),
                D.decode_lo_pages(v_lo[ids], v_scale[ids], w=w, q=q, method=method))
    return _online_plain(q4, page_ids, n_valid, k_lo.shape[0], decode)


# ------------------------------------------------------------ CUDA launch --

def _launch(name: str, mode: int, q4, k: dict, v: dict, page_ids, n_valid, *,
            w: int, n_low: int, q: int, method: str):
    """Validate every operand, then launch K4 (mode 0) or K5 (mode 1) on
    q4's stream.  ``k`` / ``v`` map field names to pool tensors; a field the
    kernel does not read is absent."""
    dev = q4.device
    b, kv, r, hd = q4.shape
    f = kv * hd
    n_pages, nb = k["lo"].shape[:2]
    if q4.dtype != torch.float32 or not q4.is_contiguous():
        raise ValueError(f"cuda:{name}: q4 must be contiguous float32")
    if hd % 4:
        raise ValueError(f"cuda:{name}: head dim {hd} is not a multiple of 4 "
                         "(pages are staged in 4-byte words)")
    least = {"mask": (torch.uint8, w // 8), "hi": (torch.int8, w - n_low),
             "lo": (torch.uint8, 0 if method == "sparsity" else -(-(n_low * q) // 8))}
    for pool in (k, v):
        D.check_fields(f"cuda:{name}",
                       {fn: (t,) + least[fn] for fn, t in pool.items() if fn != "scale"},
                       n_pages, nb, f, dev)
        D.check_scale(f"cuda:{name}", pool["scale"], n_pages, f, dev)
    ids = page_ids.to(device=dev, dtype=torch.int32).contiguous()
    nv = n_valid.to(device=dev, dtype=torch.int32).reshape(b).contiguous()
    if ids.dim() != 2 or ids.shape[0] != b:
        raise ValueError(f"cuda:{name}: page_ids {tuple(ids.shape)} is not (B={b}, P)")
    acc = torch.empty((b, kv, r, hd), dtype=torch.float32, device=dev)
    m = torch.empty((b, kv, r), dtype=torch.float32, device=dev)
    l = torch.empty((b, kv, r), dtype=torch.float32, device=dev)

    def ptrs(pool):
        return [pool[fn].data_ptr() if fn in pool else None
                for fn in ("mask", "hi", "lo", "scale")]

    def rows(fn):
        return k[fn].shape[2] if fn in k else 0
    err = D.lib().strum_paged_attention_launch(
        mode, q4.data_ptr(), *ptrs(k), *ptrs(v), ids.data_ptr(), nv.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, kv, r, hd, ids.shape[1],
        n_pages, nb, w, rows("mask"), rows("hi"), rows("lo"), n_low, q,
        METHOD_CODES[method], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cuda:{name} launch failed: CUDA error {err}")
    launch_counts[name] += 1
    return acc, m, l


def strum_paged_attention(q4, k_mask, k_hi, k_lo, k_scale, v_mask, v_hi, v_lo,
                          v_scale, page_ids, n_valid, *, w: int, n_low: int,
                          q: int, method: str):
    """K4: sealed-page partial (acc, m, l) over mask + hi + lo pools; needs
    w % 8 == 0.  Empty fields come floored at one row."""
    if w % 8:
        raise ValueError(f"paged attention needs byte-aligned mask rows (w={w})")
    if _route(q4) == "plain":
        return strum_paged_attention_plain(
            q4, k_mask, k_hi, k_lo, k_scale, v_mask, v_hi, v_lo, v_scale, page_ids,
            n_valid, w=w, n_low=n_low, q=q, method=method)
    return _launch("paged_attention", 0, q4,
                   dict(mask=k_mask, hi=k_hi, lo=k_lo, scale=k_scale),
                   dict(mask=v_mask, hi=v_hi, lo=v_lo, scale=v_scale), page_ids,
                   n_valid, w=w, n_low=n_low, q=q, method=method)


def strum_paged_attention_maskfree(q4, k_lo, k_scale, v_lo, v_scale, page_ids,
                                   n_valid, *, w: int, q: int, method: str):
    """K5 (p = 1): the partial from lo + scale only; reads no mask or hi."""
    if method not in ("dliq", "mip2q"):
        raise ValueError(f"maskfree attention needs a lo payload, got {method!r}")
    if _route(q4) == "plain":
        return strum_paged_attention_maskfree_plain(
            q4, k_lo, k_scale, v_lo, v_scale, page_ids, n_valid, w=w, q=q,
            method=method)
    return _launch("paged_attention_maskfree", 1, q4, dict(lo=k_lo, scale=k_scale),
                   dict(lo=v_lo, scale=v_scale), page_ids, n_valid, w=w, n_low=w,
                   q=q, method=method)
