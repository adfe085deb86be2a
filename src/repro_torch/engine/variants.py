"""Built-in kernel variants (imported for their registration by
``repro_torch.engine``), twins of the 2-D entries of
``repro.engine.variants`` with the same priorities and predicates:

  cuda:maskfree   p = 1.0 -- lo payload only (K2)
  cuda:dense      n_low = 0 -- hi payload only, any ``w`` (K3)
  cuda:onehot     general mask + hi + lo decode, needs ``w % 8 == 0`` (K1)
  cuda:grouped            stacked (expert) leaves, the group a grid axis (K6)
  cuda:grouped_maskfree   stacked, p = 1.0 (K7)
  cuda:grouped_dense      stacked, n_low = 0, any ``w`` (K8)
  draft:histream         draft lane: mask + hi, lo never read (K9)
  draft:maskfree_p       draft lane: hi only, no mask or lo (K10)
  draft:torch_histream   plain twins: decode only the streamed fields, then
  draft:torch_maskfree_p torch.matmul (reference ``draft:xla_*``)
  torch:dequant   dequantize + torch.matmul, the fallback for every config
                  (stacks: ``dispatch_grouped`` dequantizes at the true K and
                  runs a batched matmul)
  ref:torch       the plain oracle (``kernels.ref``)

A ``cuda:*`` variant handed CPU tensors raises: the plan or the call chose
the card, and quietly running elsewhere would hide that.  The plain routes
(``torch:dequant`` and the ``draft:torch_*`` twins) take ``accum_dtype``;
the kernels, like the reference's Pallas variants, ignore it and
accumulate in f32.
"""
from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.engine.draft import draft_dequant_packed
from repro_torch.engine.registry import register_kernel
from repro_torch.kernels import ops, ref


def _two_d(cfg, info):
    return not info.lead


def _stacked(cfg, info):
    return bool(info.lead)


def _on_card(name: str, x2: torch.Tensor) -> None:
    """CUDA tensors, or ``meta`` ones for the dry-run's shape-only step
    (``launch.dryrun``): the kernel wrapper then raises on ``meta`` unless
    the ``kernels.hooks`` slot takes the call."""
    if x2.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name} runs on CUDA tensors; got {x2.device} "
                         f"(select with backend='auto' or 'torch' off the card)")


@register_kernel(
    "cuda:onehot", family="cuda", priority=10,
    supports=lambda cfg, info: _two_d(cfg, info) and cfg.w % 8 == 0,
    description="general decode: mask bits, running rank, hi/lo placement")
def _onehot(x2, packed, *, out_dtype=None):
    _on_card("cuda:onehot", x2)
    return ops.strum_matmul(x2, packed, out_dtype=out_dtype, variant="onehot")


@register_kernel(
    "cuda:maskfree", family="cuda", priority=20,
    supports=lambda cfg, info: (_two_d(cfg, info) and cfg.n_low == cfg.w
                                and cfg.method in ("dliq", "mip2q")),
    description="p=1.0: decode lo fields in order, no mask/hi stream")
def _maskfree(x2, packed, *, out_dtype=None):
    _on_card("cuda:maskfree", x2)
    return ops.strum_matmul(x2, packed, out_dtype=out_dtype, variant="maskfree")


@register_kernel(
    "cuda:dense", family="cuda", priority=20,
    supports=lambda cfg, info: _two_d(cfg, info) and cfg.n_low == 0,
    description="n_low=0: hi payload is the block in order")
def _dense(x2, packed, *, out_dtype=None):
    _on_card("cuda:dense", x2)
    return ops.strum_matmul(x2, packed, out_dtype=out_dtype, variant="dense")


@register_kernel(
    "cuda:grouped", family="cuda", priority=10, grouped=True,
    supports=lambda cfg, info: (_stacked(cfg, info) and cfg.w % 8 == 0
                                and cfg.w <= 64),
    description="stacked expert leaves: group grid axis, general decode")
def _grouped(xg, packed, *, out_dtype=None, rows=None):
    _on_card("cuda:grouped", xg)
    return ops.strum_grouped_matmul(xg, packed, out_dtype=out_dtype,
                                    variant="onehot", rows=rows)


@register_kernel(
    "cuda:grouped_maskfree", family="cuda", priority=20, grouped=True,
    supports=lambda cfg, info: (_stacked(cfg, info) and cfg.n_low == cfg.w
                                and cfg.method in ("dliq", "mip2q") and cfg.w <= 64),
    description="stacked p=1.0: per-group lo payload only, no mask/hi stream")
def _grouped_maskfree(xg, packed, *, out_dtype=None, rows=None):
    _on_card("cuda:grouped_maskfree", xg)
    return ops.strum_grouped_matmul(xg, packed, out_dtype=out_dtype,
                                    variant="maskfree", rows=rows)


@register_kernel(
    "cuda:grouped_dense", family="cuda", priority=20, grouped=True,
    supports=lambda cfg, info: _stacked(cfg, info) and cfg.n_low == 0,
    description="stacked n_low=0: per-group hi payload in order; any w")
def _grouped_dense(xg, packed, *, out_dtype=None, rows=None):
    _on_card("cuda:grouped_dense", xg)
    return ops.strum_grouped_matmul(xg, packed, out_dtype=out_dtype,
                                    variant="dense", rows=rows)


# ------------------------------------------------------------------ draft --
#
# Reduced-fidelity lowerings over the SAME packed payload (self-speculative
# decoding's draft model).  Selection is partitioned by ``info.draft`` (a
# mode string set by ``engine.draft.build_draft_plan``) and each predicate
# pins its own mode.  The torch twins decode only the streamed fields, so
# the draft lane reads the same byte subset on every family.

def _draft_mode(mode):
    def pred(cfg, info):
        return _two_d(cfg, info) and info.draft == mode and 0 < cfg.n_low < cfg.w
    return pred


def _histream_ok(cfg, info):
    return _draft_mode("histream")(cfg, info) and cfg.w % 8 == 0


@register_kernel(
    "draft:histream", family="cuda", priority=10, draft=True,
    supports=_histream_ok,
    description="K9 draft: mask + hi streams only, lo decodes to zero")
def _draft_histream(x2, packed, *, out_dtype=None):
    _on_card("draft:histream", x2)
    return ops.strum_matmul_draft(x2, packed, mode="histream", out_dtype=out_dtype)


@register_kernel(
    "draft:maskfree_p", family="cuda", priority=10, draft=True,
    supports=_draft_mode("maskfree_p"),
    description="K10 draft: hi stream only, in the leading block positions")
def _draft_maskfree_p(x2, packed, *, out_dtype=None):
    _on_card("draft:maskfree_p", x2)
    return ops.strum_matmul_draft(x2, packed, mode="maskfree_p", out_dtype=out_dtype)


def _draft_torch(mode):
    def fn(x2, packed, *, out_dtype=None, accum_dtype=torch.float32):
        out_dtype = out_dtype or x2.dtype
        wd = draft_dequant_packed(packed, mode, x2.dtype)
        return (x2.to(torch.float32) @ wd.to(torch.float32)).to(accum_dtype).to(out_dtype)
    return fn


register_kernel(
    "draft:torch_histream", family="torch", priority=0, draft=True, accum=True,
    supports=_histream_ok,
    description="draft fallback: mask + hi decode + torch.matmul, lo never "
                "read")(_draft_torch("histream"))

register_kernel(
    "draft:torch_maskfree_p", family="torch", priority=0, draft=True, accum=True,
    supports=_draft_mode("maskfree_p"),
    description="draft fallback: hi-only decode + torch.matmul, mask and lo "
                "never read")(_draft_torch("maskfree_p"))


@register_kernel(
    "torch:dequant", family="torch", priority=0, accum=True,
    supports=lambda cfg, info: True,
    description="dequantize to dense, torch.matmul in f32 (portable fallback)")
def _dequant(x2, packed, *, out_dtype=None, accum_dtype=torch.float32):
    # weights rounded to x's dtype, as the reference dequantizes to x.dtype;
    # the f32 product rounded to accum_dtype (its preferred_element_type)
    out_dtype = out_dtype or x2.dtype
    wd = packing.dequantize(packed, x2.dtype)
    return (x2.to(torch.float32) @ wd.to(torch.float32)).to(accum_dtype).to(out_dtype)


@register_kernel(
    "ref:torch", family="reference", priority=0, supports=_two_d,
    description="plain oracle (kernels.ref.strum_matmul_ref)")
def _reference(x2, packed, *, out_dtype=None):
    return ref.strum_matmul_ref(x2, packed, out_dtype=out_dtype or x2.dtype)
