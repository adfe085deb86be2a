"""Paged KV-cache storage: page allocator, pooled page tensors, sealing and
codec stats (twin of ``repro.serving.pages``).

* every attention layer position owns a **page pool** of ``n_pages`` pages
  of ``page_size`` cache positions, stored packed (the Fig.-5 payload, via
  :mod:`repro_torch.engine.cache`) or as raw fp pages;
* one **page table** ``(n_slots, pages_per_seq)`` of page ids is shared by
  every layer: id ``j`` addresses the ``j``-th page of every pool;
* each slot keeps one **hot tail** page per attention layer, the page being
  written.  When it fills the scheduler *seals* it: block-quantized and
  written into the pools at the slot's next page id;
* an SSM (Mamba-2) layer position has no pages: its pool is an empty dict
  and its whole state is hot, the slot's conv window and recurrent state.

Pools and hot state live on the cache spec's device.  Sealing writes into
the pool tensors in place (the reference's jitted sealer returns new pools).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import telemetry
from repro_torch.core import packing
from repro_torch.engine.cache import (CACHE_PAYLOAD_KEYS, CacheSpec,
                                      build_cache_spec, encode_page,
                                      page_payload_bytes)

__all__ = ["PagesExhausted", "PageAllocator", "pages_per_seq", "attn_feat_dim",
           "make_cache_spec", "init_pools", "init_hot", "make_sealer",
           "cache_stats"]


class PagesExhausted(RuntimeError):
    """Raised by :meth:`PageAllocator.alloc` when the pool is empty."""


class PageAllocator:
    """Free-list page allocator (host-side): lowest ids first; ``defrag()``
    re-sorts the free list and reports its non-contiguous runs."""

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"n_pages={n_pages} must be >= 1")
        self.n_pages = n_pages
        self._free = list(range(n_pages))

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int = 1) -> list:
        if n > len(self._free):
            telemetry.inc("pages/alloc_fail")
            raise PagesExhausted(
                f"requested {n} pages, {len(self._free)}/{self.n_pages} free")
        out, self._free = self._free[:n], self._free[n:]
        if telemetry.enabled():
            telemetry.inc("pages/alloc", n)
            telemetry.event("page_alloc", cat="pages", n=n)
            telemetry.gauge("pages/in_use", self.n_pages - len(self._free))
        return out

    def free(self, ids) -> None:
        dup = set(ids) & set(self._free)
        if dup:
            raise ValueError(f"double free of pages {sorted(dup)}")
        self._free.extend(int(i) for i in ids)
        if telemetry.enabled():
            telemetry.inc("pages/freed", len(ids))
            telemetry.event("page_free", cat="pages", n=len(ids))
            telemetry.gauge("pages/in_use", self.n_pages - len(self._free))
        self.defrag()

    def defrag(self) -> dict:
        self._free.sort()
        runs = sum(1 for a, b in zip(self._free, self._free[1:])
                   if b != a + 1) + (1 if self._free else 0)
        if telemetry.enabled():
            telemetry.inc("pages/defrag")
            telemetry.gauge("pages/free_runs", runs)
        return {"free": len(self._free), "n_pages": self.n_pages,
                "free_runs": runs}


# --------------------------------------------------------------- geometry --

def pages_per_seq(max_len: int, page_size: int) -> int:
    """Pages covering ``max_len`` positions (the last may be partial)."""
    return -(-max_len // page_size)


def attn_feat_dim(cfg) -> int:
    return cfg.n_kv_heads * cfg.hd


def _attn_positions(cfg) -> list:
    """The layer positions whose mixer is attention (``layer_kind``)."""
    from repro_torch.models import transformer as tfm
    return [f"pos{i}" for i in range(tfm.period(cfg))
            if cfg.layer_kind(i) == "attn"]


def make_cache_spec(cfg, kv_cache, page_size: int, device,
                    backend: Optional[str] = None) -> CacheSpec:
    """(model cfg, codec request, device of the pools) -> :class:`CacheSpec`.

    ``kv_cache``: ``None`` / ``"fp"`` for raw pages, or a
    :class:`StruMConfig` for packed pages.
    """
    codec = None if kv_cache in (None, "fp") else kv_cache
    return build_cache_spec(codec, page_size=page_size, feat=attn_feat_dim(cfg),
                            device=device, backend=backend, head_dim=cfg.hd)


# ---------------------------------------------------------------- storage --

def init_pools(cfg, n_pages: int, spec: CacheSpec) -> dict:
    """Zeroed page pools per layer position on ``spec.device``: packed
    payload fields ``(groups, n_pages, nb, rows, F)`` + ``scale (groups,
    n_pages, 1, F)``, or raw ``pages (groups, n_pages, page_size, F)``; an
    SSM position gets an empty dict (its state is hot only)."""
    from repro_torch.models import transformer as tfm
    g, f, ps, dev = tfm.n_groups(cfg), attn_feat_dim(cfg), spec.page_size, spec.device
    out = {}
    for i in range(tfm.period(cfg)):
        if cfg.layer_kind(i) != "attn":
            out[f"pos{i}"] = {}
            continue
        if spec.packed:
            c = spec.cfg
            nb = ps // c.w
            mb, nh, lb = packing.field_dims(c.w, c.n_low, c.q, c.method)
            leaf = lambda: {  # noqa: E731
                "mask": torch.zeros((g, n_pages, nb, mb, f), dtype=torch.uint8, device=dev),
                "hi": torch.zeros((g, n_pages, nb, nh, f), dtype=torch.int8, device=dev),
                "lo": torch.zeros((g, n_pages, nb, lb, f), dtype=torch.uint8, device=dev),
                "scale": torch.zeros((g, n_pages, 1, f), dtype=torch.float32, device=dev),
            }
        else:
            leaf = lambda: {"pages": torch.zeros(  # noqa: E731
                (g, n_pages, ps, f), dtype=cfg.activation_dtype, device=dev)}
        out[f"pos{i}"] = {"k": leaf(), "v": leaf()}
    return out


def init_hot(cfg, n_slots: int, page_size: int, device) -> dict:
    """Per-slot hot state, the dtypes of ``transformer.cache_defs``: per
    attention position the tail pages ``k_tail`` / ``v_tail`` ``(groups,
    n_slots, page_size, KV, hd)`` in the activation dtype; per SSM position
    ``conv`` ``(groups, n_slots, W-1, conv_dim)`` in the activation dtype and
    ``state`` ``(groups, n_slots, nh, hp, ns)`` in f32."""
    from repro_torch.models import mamba2
    from repro_torch.models import transformer as tfm
    g, act = tfm.n_groups(cfg), cfg.activation_dtype
    out = {}
    for i in range(tfm.period(cfg)):
        if cfg.layer_kind(i) == "attn":
            shape = (g, n_slots, page_size, cfg.n_kv_heads, cfg.hd)
            out[f"pos{i}"] = {n: torch.zeros(shape, dtype=act, device=device)
                              for n in ("k_tail", "v_tail")}
        else:
            (cs, _), (ss, _) = mamba2.ssm_cache_spec(cfg, n_slots)
            out[f"pos{i}"] = {
                "conv": torch.zeros((g,) + cs, dtype=act, device=device),
                "state": torch.zeros((g,) + ss, dtype=torch.float32, device=device)}
    return out


# ---------------------------------------------------------------- sealing --

def make_sealer(spec: CacheSpec):
    """``seal(pool_pos, k_page, v_page, page_id)`` writes one full page per
    group into a layer position's pools, in place: pages are ``(groups,
    page_size, KV, hd)``, ``page_id`` a host int.  Packed pools take the
    encoded K and V pages of every group in one ``encode_page`` call."""
    ps = spec.page_size

    def flat(page):                            # (g, ps, KV, hd) -> (g, ps, F)
        return page.reshape(page.shape[0], ps, -1)

    if spec.packed:
        def seal(pool, k_page, v_page, page_id: int) -> None:
            enc = encode_page(torch.stack([flat(k_page), flat(v_page)]), spec.cfg)
            for i, name in enumerate(("k", "v")):
                for key in CACHE_PAYLOAD_KEYS:
                    pool[name][key][:, page_id] = enc[key][i]
    else:
        def seal(pool, k_page, v_page, page_id: int) -> None:
            for name, page in (("k", k_page), ("v", v_page)):
                pool[name]["pages"][:, page_id] = flat(page)
    return seal


# ------------------------------------------------------------------ stats --

def _tree_bytes(tree, keys=None) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v, keys) if isinstance(v, dict)
                   else (v.numel() * v.element_size()
                         if keys is None or k in keys else 0)
                   for k, v in tree.items())
    return tree.numel() * tree.element_size()


def cache_stats(pools: dict, hot: dict, spec: CacheSpec, cfg,
                n_slots: int, max_len: int) -> dict:
    """Measured resident cache bytes vs the codec's Eq.-1/2 expectation:
    ``resident_page_bytes / int8_page_bytes == cfg.compression_ratio``
    exactly where the payload is byte-aligned."""
    from repro_torch.models import transformer as tfm
    g, f, ps = tfm.n_groups(cfg), attn_feat_dim(cfg), spec.page_size
    n_attn = len(_attn_positions(cfg))
    n_pages = 0
    for pos in pools.values():
        if pos:
            n_pages = next(iter(pos["k"].values())).shape[1]
            break
    if spec.packed:
        packed = sum(_tree_bytes(pos, keys=("mask", "hi", "lo")) for pos in pools.values())
        scale = sum(_tree_bytes(pos, keys=("scale",)) for pos in pools.values())
        expected = 2 * g * n_attn * n_pages * page_payload_bytes(ps, f, spec.cfg)
    else:
        packed = sum(_tree_bytes(pos, keys=("pages",)) for pos in pools.values())
        scale = 0
        expected = packed
    int8_pages = 2 * g * n_attn * n_pages * ps * f          # same pages, int8
    dtype_bytes = cfg.activation_dtype.itemsize
    dense = 2 * g * n_attn * n_slots * max_len * f * dtype_bytes
    if telemetry.enabled():
        # what the pools hold packed vs what stays full width (the hot
        # tails, and fp pools)
        telemetry.gauge("cache/resident_packed_bytes",
                        int(packed) if spec.packed else 0)
        telemetry.gauge("cache/resident_fp_bytes",
                        int(_tree_bytes(hot)) + (0 if spec.packed else int(packed)))
        telemetry.gauge("cache/ratio_vs_int8", packed / max(int8_pages, 1))
    return {
        "codec": spec.variant,
        "page_size": ps,
        "n_pages": n_pages,
        "resident_page_bytes": int(packed),
        "expected_page_bytes": int(expected),
        "scale_bytes": int(scale),
        "hot_bytes": int(_tree_bytes(hot)),
        "int8_page_bytes": int(int8_pages),
        "ratio_vs_int8": packed / max(int8_pages, 1),
        "expected_ratio_vs_int8": (spec.cfg.compression_ratio
                                   if spec.packed else float(dtype_bytes)),
        "dense_cache_bytes": int(dense),
        "ratio_vs_dense": packed / max(dense, 1),
    }
