"""The ``cache:*`` kernel-variant family: KV-cache page codecs and the
consumers of the page pools as registry entries (twin of
``repro.engine.cache``).

Sealed KV pages are stored in the weights' ``method × w × q`` layout: the
block machinery that packs a ``(K, N)`` kernel packs a ``(page_size, F)``
page, blocks running along the cache positions, each of the ``F =
n_kv_heads · head_dim`` channels with its own int8 scale per page.

Which codec decodes the pages, and which consumer computes the sealed half
of paged attention, are registry selections recorded in a
:class:`CacheSpec`, with the family swapped as everywhere in the port:

``cache:cuda_decode``          K11 (``kernels.strum_decode``) -- reference
                               ``cache:pallas_decode``
``cache:torch_dequant``        plain PyTorch decode -- ``cache:xla_dequant``
``cache:fp_passthrough``       raw fp pages (no codec, or q >= 8)
``cache:attn_fused``           K4 (``kernels.strum_attention``), reads the
                               pools by page id, packed bytes only
``cache:attn_fused_maskfree``  K5, p = 1 pools: lo + scale only
``cache:attn_unfused``         gather, decode through the codec, einsum

``backend="auto"`` resolves by the device the spec is built for, which the
spec records (the reference resolves by the JAX platform): pools on the
card get the ``cuda`` family, pools on the CPU the ``torch`` family.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch import telemetry
from repro_torch.core import blocking, packing
from repro_torch.core.policy import StruMConfig
from repro_torch.core.quantizers import int8_symmetric, quantize_blocks
from repro_torch.engine.registry import (LeafInfo, get_variant, register_kernel,
                                         select_variant)
from repro_torch.kernels.ops import _min1

__all__ = ["CacheSpec", "build_cache_spec", "select_cache_variant",
           "select_attn_variant", "encode_page", "decode_pages",
           "gather_decode_pages", "attn_sealed_partial", "page_payload_bytes",
           "CACHE_PAYLOAD_KEYS"]

CACHE_PAYLOAD_KEYS = ("mask", "hi", "lo", "scale")

NEG_INF = -1e30  # matches models.attention / kernels.strum_attention


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Per-cache-tree codec metadata (the cache-side ``ExecSpec``): page
    size, codec config, the selected decode and attention variants, and the
    device the selection was made for."""

    page_size: int
    device: torch.device
    cfg: Optional[StruMConfig] = None   # None = raw fp pages
    variant: str = "cache:fp_passthrough"
    backend: Optional[str] = None       # backend the variants were selected
                                        # under (None = auto)
    attn_variant: str = "cache:attn_unfused"
    head_dim: int = 0                   # per-head width the attention variant
                                        # was selected for (0 = not known)

    @property
    def packed(self) -> bool:
        """Do pools store payload arrays (vs raw fp pages)?"""
        return self.variant != "cache:fp_passthrough"


def _is_identity(cfg: Optional[StruMConfig]) -> bool:
    """No codec, or a full-width (q >= 8) payload: the mask header alone
    makes those cost more than raw storage, so they lower to passthrough."""
    return cfg is None or (cfg.method != "sparsity" and cfg.q >= 8)


def select_cache_variant(cfg: Optional[StruMConfig], *, page_size: int,
                         feat: int, backend: Optional[str] = None, device=None):
    info = LeafInfo(k_dim=page_size, n_out=feat, cache=True)
    return select_variant(cfg, info, backend=backend, device=device)


def select_attn_variant(cfg: Optional[StruMConfig], *, page_size: int,
                        feat: int, head_dim: int = 0, backend: Optional[str] = None,
                        device=None):
    """The ``cache:attn_*`` consumer of the sealed pools: a fused kernel
    where the codec and the head dim (``head_dim``, 0 = not known) fit
    one, ``cache:attn_unfused`` everywhere else."""
    info = LeafInfo(k_dim=page_size, n_out=feat, cache=True, attn=True,
                    head_dim=head_dim)
    return select_variant(cfg, info, backend=backend, device=device)


def build_cache_spec(cfg: Optional[StruMConfig], *, page_size: int, feat: int,
                     device, backend: Optional[str] = None,
                     head_dim: int = 0) -> CacheSpec:
    """Validate the (codec, page geometry) pair and select its decoder and
    attention consumer for pools on ``device`` (``head_dim``: the query's
    per-head width, which the fused consumers' predicates check).

    ``page_size`` must be a multiple of the codec's block width ``w``: pages
    are blocked along cache positions, and a ragged last block would break
    the uniform page address the allocator relies on.
    """
    dev = torch.device(device)
    if cfg is not None and not _is_identity(cfg) and page_size % cfg.w:
        raise ValueError(f"page_size={page_size} must be a multiple of the "
                         f"cache codec's block width w={cfg.w}")
    kw = dict(page_size=page_size, feat=feat, backend=backend, device=dev)
    return CacheSpec(page_size=page_size, device=dev, cfg=cfg,
                     variant=select_cache_variant(cfg, **kw).name, backend=backend,
                     attn_variant=select_attn_variant(cfg, head_dim=head_dim, **kw).name,
                     head_dim=head_dim)


# ------------------------------------------------------------- encode side --

def encode_page(page: torch.Tensor, cfg: StruMConfig) -> dict:
    """Compress pages ``(..., page_size, F)`` to the Fig.-5 payload arrays
    ``(..., nb, rows, F)`` and ``scale (..., 1, F)``.

    Every channel of every page is calibrated and blocked on its own, so the
    pages are encoded as one ``(page_size, n·F)`` array; the bytes equal the
    reference's eager ``encode_page`` of each page.
    """
    lead = tuple(page.shape[:-2])
    ps, f = page.shape[-2:]
    n = math.prod(lead)
    cols = page.to(torch.float32).reshape(n, ps, f).permute(1, 0, 2).reshape(ps, n * f)
    codes, scale = int8_symmetric(cols, axis=0)
    qb = quantize_blocks(blocking.to_blocks(codes, cfg.w), cfg.method, cfg.n_low,
                         q=cfg.q, L=cfg.L)
    p = packing.pack(qb, method=cfg.method, scale=scale, k_dim=ps, n_low=cfg.n_low,
                     q=cfg.q, L=cfg.L)

    def split(a):                      # (nb, rows, n·F) -> (..., nb, rows, F)
        nb, rows = a.shape[:2]
        return a.reshape(nb, rows, n, f).permute(2, 0, 1, 3).reshape(
            lead + (nb, rows, f)).contiguous()
    return {"mask": split(p.mask), "hi": split(p.hi), "lo": split(p.lo),
            "scale": p.scale.reshape(lead + (1, f))}


def page_payload_bytes(page_size: int, feat: int, cfg: StruMConfig) -> int:
    """Resident packed bytes of one page (mask + hi + lo, excl. scales)."""
    nb = blocking.num_blocks(page_size, cfg.w)
    mb, nh, lb = packing.field_dims(cfg.w, cfg.n_low, cfg.q, cfg.method)
    return nb * (mb + nh + lb) * feat


# ------------------------------------------------------------- decode side --

def _pick_cache(spec: CacheSpec, backend: Optional[str]):
    """A per-call backend re-selects; without one the spec's recorded
    selection is authoritative (the rule of ``engine.dispatch._pick``)."""
    if backend is None:
        return get_variant(spec.variant)
    return select_cache_variant(spec.cfg, page_size=spec.page_size, feat=1,
                                backend=backend, device=spec.device)


def decode_pages(leaf: dict, spec: CacheSpec, *, backend: Optional[str] = None,
                 out_dtype=torch.float32) -> torch.Tensor:
    """Decode a batch of pages through the spec's ``cache:*`` codec.

    ``leaf``: packed payload arrays ``(lead..., nb, rows, F)`` + ``scale
    (lead..., 1, F)``, or ``{"pages": (lead..., page_size, F)}`` for raw
    pages.  Returns ``(lead..., page_size, F)`` in ``out_dtype``.
    """
    variant = _pick_cache(spec, backend)
    if telemetry.enabled():
        telemetry.inc(f"cache/decode/{variant.name}")
        if spec.packed:
            # packed bytes this decode streams out of the pools
            telemetry.inc("cache/decode_packed_bytes",
                          sum(leaf[k].numel() for k in ("mask", "hi", "lo")
                              if k in leaf))
    with telemetry.span(variant.name, cat="cache"):
        return variant.fn(leaf, cfg=spec.cfg, page_size=spec.page_size,
                          out_dtype=out_dtype)


def gather_decode_pages(pool: dict, page_ids: torch.Tensor, spec: CacheSpec, *,
                        backend: Optional[str] = None,
                        out_dtype=torch.float32) -> torch.Tensor:
    """Gather ``page_ids`` (any shape; entries < 0 read page 0, junk the
    caller masks) out of a pool and decode them.  Returns
    ``(*page_ids.shape, page_size, F)``."""
    ids = page_ids.clamp(min=0).to(torch.long)
    keys = CACHE_PAYLOAD_KEYS if spec.packed else ("pages",)
    gathered = {k: pool[k].index_select(0, ids.reshape(-1)).reshape(
        tuple(ids.shape) + tuple(pool[k].shape[1:])) for k in keys}
    return decode_pages(gathered, spec, backend=backend, out_dtype=out_dtype)


def _flat_pages(leaf: dict):
    """Payload fields with their lead dims folded into one page axis."""
    lead = tuple(leaf["mask"].shape[:-3])
    n = math.prod(lead)
    return lead, {k: leaf[k].reshape((n,) + tuple(leaf[k].shape[len(lead):]))
                  for k in CACHE_PAYLOAD_KEYS}


# ------------------------------------------------------ registry entries --

@register_kernel(
    "cache:fp_passthrough", family="torch", priority=30, cache=True,
    redispatch=True,  # identity under any backend is never a substitution
    supports=lambda cfg, info: _is_identity(cfg),
    description="raw fp pages, identity decode (no codec, or q >= 8 where "
                "the packed form would cost more than the raw bytes)")
def _fp_passthrough(leaf, *, cfg, page_size, out_dtype=torch.float32):
    return leaf["pages"].to(out_dtype)


@register_kernel(
    "cache:torch_dequant", family="torch", priority=0, cache=True,
    supports=lambda cfg, info: cfg is not None and not _is_identity(cfg),
    description="plain PyTorch decode of packed pages (portable fallback)")
def _torch_dequant(leaf, *, cfg, page_size, out_dtype=torch.float32):
    from repro_torch.kernels.strum_decode import strum_page_decode_plain
    lead, flat = _flat_pages(leaf)
    out = strum_page_decode_plain(flat["mask"], flat["hi"], flat["lo"], flat["scale"],
                                  w=cfg.w, n_low=cfg.n_low, q=cfg.q, method=cfg.method)
    return out.reshape(lead + tuple(out.shape[1:])).to(out_dtype)


@register_kernel(
    "cache:cuda_decode", family="cuda", priority=10, cache=True,
    supports=lambda cfg, info: (cfg is not None and not _is_identity(cfg)
                                and cfg.w % 8 == 0),
    description="K11: decode packed pages on the card, one thread per block "
                "column of 4 channels, decoded in registers")
def _cuda_decode(leaf, *, cfg, page_size, out_dtype=torch.float32):
    from repro_torch.kernels.strum_decode import strum_page_decode
    lead, flat = _flat_pages(leaf)
    out = strum_page_decode(flat["mask"].contiguous(), _min1(flat["hi"], 2).contiguous(),
                            _min1(flat["lo"], 2).contiguous(), flat["scale"].contiguous(),
                            w=cfg.w, n_low=cfg.n_low, q=cfg.q, method=cfg.method)
    return out.reshape(lead + tuple(out.shape[1:])).to(out_dtype)


# ------------------------------------------- fused-attention consumers --
#
# The ``cache:attn_*`` partition (LeafInfo.attn), as in the reference:
#
#   fn(pool, qf, page_table, n_valid, *, cfg, spec, backend) -> (acc, m, l)
#
#   pool        {"k": leaf, "v": leaf} pool tensors, page axis leading
#   qf          (B, KV, R, hd) f32 query rows, pre-scaled by 1/sqrt(hd)
#   page_table  (B, P) int32, -1 = unassigned
#   n_valid     (B,) int32 -- pages strictly before this are sealed & valid
#
# returning the unnormalized online-softmax state over the sealed pages
# (m = NEG_INF, l = 0 where a slot has none); the caller merges it with the
# fp epilogue of the hot tail (models/attention.py).

def attn_sealed_partial(pool: dict, qf: torch.Tensor, page_table: torch.Tensor,
                        n_valid: torch.Tensor, spec: CacheSpec, *,
                        backend: Optional[str] = None):
    """Sealed-page partial attention through the spec's ``cache:attn_*``
    variant (a per-call ``backend`` re-selects, the rule of decode)."""
    if backend is None:
        variant = get_variant(spec.attn_variant)
    else:
        variant = select_attn_variant(spec.cfg, page_size=spec.page_size, feat=1,
                                      head_dim=spec.head_dim, backend=backend,
                                      device=spec.device)
    if telemetry.enabled():
        telemetry.inc(f"attn/variant/{variant.name}")
    with telemetry.span(variant.name.replace("cache:attn_", "attn:"), cat="attn"):
        return variant.fn(pool, qf, page_table, n_valid, cfg=spec.cfg, spec=spec,
                          backend=backend)


@register_kernel(
    "cache:attn_unfused", family="torch", priority=0, cache=True, attn=True,
    redispatch=True,  # the page decode re-selects with the caller's backend
    supports=lambda cfg, info: True,
    description="gather-then-einsum fallback: decode sealed pages to dense "
                "fp through the codec variant, then QK^T / softmax / AV")
def _attn_unfused(pool, qf, page_table, n_valid, *, cfg, spec, backend=None):
    b, kv, r, hd = qf.shape
    pp = page_table.shape[-1]
    ps = spec.page_size
    k_seq = gather_decode_pages(pool["k"], page_table, spec,
                                backend=backend).reshape(b, pp * ps, kv, hd)
    v_seq = gather_decode_pages(pool["v"], page_table, spec,
                                backend=backend).reshape(b, pp * ps, kv, hd)
    pos = torch.arange(pp * ps, device=qf.device)
    assigned = page_table[:, pos // ps] >= 0                       # (B, S)
    valid = (pos[None, :] < (n_valid.reshape(b, 1) * ps)) & assigned
    vmask = valid[:, None, None, :]
    sc = torch.einsum("bgrd,bsgd->bgrs", qf, k_seq)
    sc = torch.where(vmask, sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(dim=-1)                                            # (B,KV,R)
    pexp = torch.where(vmask, torch.exp(sc - m[..., None]), torch.zeros_like(sc))
    l = pexp.sum(dim=-1)
    acc = torch.einsum("bgrs,bsgd->bgrd", pexp, v_seq)
    return acc, m, l


def _pool_fields(leaf: dict, keys) -> list:
    """Pool fields as the kernels take them: contiguous, empty ones floored
    at one row (the reference's ``_pad_rows``)."""
    return [(leaf[k] if k == "scale" else _min1(leaf[k], 2)).contiguous()
            for k in keys]


def _note_fused_bytes(pool: dict, page_table: torch.Tensor, keys) -> None:
    """``attn/fused/packed_bytes``: the packed fields of every (slot, page)
    entry of the table, K and V, as the reference counts its page gather."""
    if telemetry.enabled():
        telemetry.inc("attn/fused/packed_bytes", page_table.numel() * sum(
            pool[kv][k][0].numel() for kv in ("k", "v") for k in keys
            if k != "scale"))


def _attn_kernel_fits(cfg, info) -> bool:
    """K4's and K5's limits on the card: a [1, w] block fits one 64-position
    piece of a page, and a lane holds at most 8 of the head's columns.  Any
    page size, and any head dim up to that, runs."""
    from repro_torch.kernels.strum_attention import MAX_BLOCK_WIDTH, MAX_HEAD_DIM
    return cfg.w <= MAX_BLOCK_WIDTH and info.head_dim <= MAX_HEAD_DIM


@register_kernel(
    "cache:attn_fused", family="cuda", priority=10, cache=True, attn=True,
    supports=lambda cfg, info: (cfg is not None and not _is_identity(cfg)
                                and cfg.w % 8 == 0 and _attn_kernel_fits(cfg, info)),
    description="K4: pools read by page id -> decode in shared memory -> "
                "QK^T -> online softmax -> AV; sealed pages leave HBM only "
                "as mask/hi/lo bytes")
def _attn_fused(pool, qf, page_table, n_valid, *, cfg, spec, backend=None):
    from repro_torch.kernels.strum_attention import strum_paged_attention
    _note_fused_bytes(pool, page_table, CACHE_PAYLOAD_KEYS)
    return strum_paged_attention(
        qf.contiguous(), *_pool_fields(pool["k"], CACHE_PAYLOAD_KEYS),
        *_pool_fields(pool["v"], CACHE_PAYLOAD_KEYS), page_table, n_valid,
        w=cfg.w, n_low=cfg.n_low, q=cfg.q, method=cfg.method)


@register_kernel(
    "cache:attn_fused_maskfree", family="cuda", priority=20, cache=True,
    attn=True,
    supports=lambda cfg, info: (cfg is not None and not _is_identity(cfg)
                                and cfg.n_low == cfg.w
                                and cfg.method in ("dliq", "mip2q")
                                and _attn_kernel_fits(cfg, info)),
    description="K5: p = 1.0 pools, no mask/hi streams, the lo payload is "
                "the whole block in order")
def _attn_fused_maskfree(pool, qf, page_table, n_valid, *, cfg, spec,
                         backend=None):
    from repro_torch.kernels.strum_attention import strum_paged_attention_maskfree
    _note_fused_bytes(pool, page_table, ("lo",))
    return strum_paged_attention_maskfree(
        qf.contiguous(), *_pool_fields(pool["k"], ("lo", "scale")),
        *_pool_fields(pool["v"], ("lo", "scale")), page_table, n_valid,
        w=cfg.w, q=cfg.q, method=cfg.method)
