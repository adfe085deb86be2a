"""Public wrappers around the StruM matmul kernels (twin of the matmul half
of ``repro.kernels.ops``).

Callers hand in activations and a :class:`PackedStruM`; ``variant`` picks
the lowering: ``"onehot"`` (K1, general), ``"maskfree"`` (K2, p = 1) or
``"dense"`` (K3, n_low = 0); ``strum_grouped_matmul`` runs the same three
lowerings over stacked payloads (K6-K8).  The padding contract of the
reference holds:

* K is taken to ``nb·w`` with *zero activations* (the CUDA kernels read x
  past the true K as 0, the plain versions pad x): padded-K weight rows
  decode to junk, e.g. MIP2Q code 0 is ±1, so only zero activations null
  them;
* output columns are never padded (the kernels bound-check N), so no
  column needs the reference's zero padding scale;
* an empty payload axis (sparsity or n_low = 0 lo, p = 1 hi) is floored at
  one zero row (``_min1``) so every operand has a valid address.

The reference's ``_pick_block`` (8 × 128 TPU tiles) has no twin: the Hopper
kernels choose their own tiles.  The result is f32 from the kernel, cast
to ``out_dtype`` (default: ``x.dtype``).

``strum_matmul_draft`` / ``strum_gemv_draft`` are the reduced-fidelity
reads of the same payload (``DRAFT_MODES``): ``"histream"`` (K9, mask + hi)
and ``"maskfree_p"`` (K10, hi only).  Each hands its kernel only the fields
``draft_field_set(mode)`` names.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.packing import PackedStruM
from repro_torch.kernels import strum_matmul as K

__all__ = ["strum_matmul", "strum_gemv", "strum_grouped_matmul",
           "strum_matmul_draft", "strum_gemv_draft", "draft_field_set",
           "VARIANTS", "DRAFT_MODES"]

VARIANTS = ("onehot", "maskfree", "dense")

#: reduced-fidelity draft lowerings over the same payload; each streams a
#: strict subset of the packed fields (see ``draft_field_set``)
DRAFT_MODES = ("histream", "maskfree_p")


def _min1(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Floor an empty payload axis at one (inert) zero row."""
    if a.shape[axis] != 0:
        return a
    shape = list(a.shape)
    shape[axis] = 1
    return a.new_zeros(shape)


def _validate_variant(variant: str, packed: PackedStruM) -> None:
    w = packed.w
    if variant == "onehot":
        if w % 8:
            raise ValueError(f"onehot variant needs byte-aligned mask rows "
                             f"(w={w}); use the dequant fallback")
    elif variant == "maskfree":
        if packed.n_low != w or packed.method not in ("dliq", "mip2q"):
            raise ValueError(f"maskfree variant needs n_low == w and a lo "
                             f"payload, got n_low={packed.n_low} w={w} "
                             f"method={packed.method}")
    elif variant == "dense":
        if packed.n_low != 0:
            raise ValueError(f"dense variant needs n_low == 0, got {packed.n_low}")
    else:
        raise ValueError(f"unknown variant {variant!r}; want one of {VARIANTS}")


def strum_matmul(x: torch.Tensor, packed: PackedStruM, *, out_dtype=None,
                 variant: str = "onehot") -> torch.Tensor:
    """y = x @ dequant(packed), streaming compressed weights.

    x: (..., K), leading dims flattened into M.  Returns (..., N) in
    ``out_dtype`` (default x.dtype).
    """
    out_dtype = out_dtype or x.dtype
    _validate_variant(variant, packed)
    lead, k_in = tuple(x.shape[:-1]), x.shape[-1]
    if k_in != packed.k_dim:
        raise ValueError(f"x K={k_in} vs packed k_dim={packed.k_dim}")
    x2 = x.reshape(-1, k_in).contiguous()
    w = packed.w
    if variant == "onehot":
        y = K.strum_matmul_onehot(x2, packed.mask, _min1(packed.hi, 1),
                                  _min1(packed.lo, 1), packed.scale, w=w,
                                  n_low=packed.n_low, q=packed.q,
                                  method=packed.method, L=packed.L)
    elif variant == "maskfree":
        y = K.strum_matmul_maskfree(x2, packed.lo, packed.scale, w=w,
                                    q=packed.q, method=packed.method, L=packed.L)
    else:
        y = K.strum_matmul_dense(x2, packed.hi, packed.scale, w=w)
    return y.reshape(lead + (packed.n_out,)).to(out_dtype)


def strum_gemv(x: torch.Tensor, packed: PackedStruM, *, out_dtype=None,
               variant: str = "onehot") -> torch.Tensor:
    """Decode-path matvec (M = a few tokens): the same kernels, which pick
    their small-M tile and split K across blocks themselves."""
    return strum_matmul(x, packed, out_dtype=out_dtype, variant=variant)


def draft_field_set(mode: str) -> tuple:
    """The packed payload fields a draft mode streams (the others are never
    handed to its kernel)."""
    if mode == "histream":
        return ("mask", "hi")
    if mode == "maskfree_p":
        return ("hi",)
    raise ValueError(f"unknown draft mode {mode!r}; want one of {DRAFT_MODES}")


def strum_matmul_draft(x: torch.Tensor, packed: PackedStruM, *, mode: str,
                       out_dtype=None) -> torch.Tensor:
    """Reduced-fidelity y = x @ draft_dequant(packed) from the same payload
    tensors: ``"histream"`` (K9) reads mask + hi, ``"maskfree_p"`` (K10) hi
    only; lo never reaches either kernel."""
    out_dtype = out_dtype or x.dtype
    if mode not in DRAFT_MODES:
        raise ValueError(f"unknown draft mode {mode!r}; "
                         f"want one of {DRAFT_MODES}")
    if packed.n_low >= packed.w:
        raise ValueError(f"draft modes need high values to stream "
                         f"(n_low={packed.n_low} w={packed.w})")
    lead, k_in = tuple(x.shape[:-1]), x.shape[-1]
    if k_in != packed.k_dim:
        raise ValueError(f"x K={k_in} vs packed k_dim={packed.k_dim}")
    x2 = x.reshape(-1, k_in).contiguous()
    w = packed.w
    if mode == "histream":
        if w % 8:
            raise ValueError(f"histream draft needs byte-aligned mask rows "
                             f"(w={w})")
        y = K.strum_matmul_histream(x2, packed.mask, packed.hi, packed.scale,
                                    w=w, n_low=packed.n_low)
    else:
        y = K.strum_matmul_maskfree_p(x2, packed.hi, packed.scale, w=w,
                                      n_low=packed.n_low)
    return y.reshape(lead + (packed.n_out,)).to(out_dtype)


def strum_gemv_draft(x: torch.Tensor, packed: PackedStruM, *, mode: str,
                     out_dtype=None) -> torch.Tensor:
    """Decode-path draft matvec: the same kernels at a few rows, where the
    skipped fields' bytes are the time saved (the op is bound by bytes)."""
    return strum_matmul_draft(x, packed, mode=mode, out_dtype=out_dtype)


def strum_grouped_matmul(x: torch.Tensor, packed: PackedStruM, *, out_dtype=None,
                         variant: str = "onehot", rows=None) -> torch.Tensor:
    """Batched y[..., m, n] = x[..., m, :] @ dequant(W[...]) for stacked leaves.

    ``packed`` carries lead stack dims on every field -- mask ``(lead..., nb,
    w//8, N)``, hi/lo alike, scale ``(lead..., 1, N)`` -- the layout
    ``models.quantize._pack_leaf`` emits for MoE expert stacks.  ``x`` is
    ``(lead..., M, K)`` with ``K == packed.k_dim`` (the true reduction dim).
    Lead dims flatten into one group axis (K6-K8 take it as a grid axis).
    ``rows`` (lead...) int, optional, on x's device: the live rows of each
    group -- rows at or past ``rows[g]`` of x are zero, and so are those of
    the result; K6, K7 and K8 skip their work (K8 at the widths the
    streamed kernel takes; the template computes them).
    Returns ``(lead..., M, N)`` in ``out_dtype`` (default x.dtype).
    """
    out_dtype = out_dtype or x.dtype
    _validate_variant(variant, packed)
    lead_dims = packed.mask.dim() - 3
    if lead_dims < 1:
        raise ValueError("strum_grouped_matmul needs stacked payloads "
                         "(lead dims); use strum_matmul for 2-D leaves")
    lead = tuple(packed.mask.shape[:lead_dims])
    if x.dim() != lead_dims + 2 or tuple(x.shape[:lead_dims]) != lead:
        raise ValueError(f"x shape {tuple(x.shape)} does not match packed lead "
                         f"dims {lead} + (M, K)")
    k_in = x.shape[-1]
    if k_in != packed.k_dim:
        raise ValueError(f"x K={k_in} vs packed k_dim={packed.k_dim}")
    g = math.prod(lead)
    m, n, w = x.shape[-2], packed.n_out, packed.w
    x3 = x.reshape(g, m, k_in).contiguous()

    def flat(a):   # explicit g: -1 breaks on 0-row payloads (sparsity lo)
        return a.reshape((g,) + tuple(a.shape[lead_dims:])).contiguous()

    scale = flat(packed.scale)
    if rows is not None:
        if tuple(rows.shape) != lead:
            raise ValueError(f"rows {tuple(rows.shape)} does not match the lead "
                             f"dims {lead}")
        rows = rows.reshape(g)
    if variant == "onehot":
        y = K.strum_matmul_grouped_onehot(
            x3, flat(packed.mask), _min1(flat(packed.hi), 2),
            _min1(flat(packed.lo), 2), scale, w=w, n_low=packed.n_low,
            q=packed.q, method=packed.method, rows=rows)
    elif variant == "maskfree":
        y = K.strum_matmul_grouped_maskfree(x3, flat(packed.lo), scale, w=w,
                                            q=packed.q, method=packed.method,
                                            rows=rows)
    else:
        y = K.strum_matmul_grouped_dense(x3, flat(packed.hi), scale, w=w,
                                         rows=rows)
    return y.reshape(lead + (m, n)).to(out_dtype)
