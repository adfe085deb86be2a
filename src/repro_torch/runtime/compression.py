"""StruM-MIP2Q gradient compression with error feedback (twin of
``repro.runtime.compression``).

Each ``[1, w]`` block of a flattened gradient is scaled to int8, keeps its
``(1-p)·w`` values whose nearest power of two is furthest off, and rounds
the rest to ``±2**k`` (MIP2Q on the int grid).  With p = 0.5, q = 4 an
all-reduce payload would shrink to ``(p(q-16)+17)/16`` of bf16, about 66%
(:func:`payload_ratio`).  The residual ``g - decode(encode(g))`` is added
to the next step's gradient (error feedback), so the compression bias
telescopes instead of accumulating.  As in the reference, the codec runs as
a round trip on one device; a reduce of packed payloads is the distributed
extension.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.apply import _named_leaves, map_named
from repro_torch.core.quantizers import pow2_error_low_mask, pow2_round

__all__ = ["CompressionState", "init_ef_state", "compress_grad",
           "compress_tree_with_ef", "payload_ratio"]

_F32 = torch.float32


class CompressionState(NamedTuple):
    residual: Any  # f32 tree like grads (error feedback memory)


def init_ef_state(grads_like) -> CompressionState:
    return CompressionState(map_named(
        lambda _, g: torch.zeros(g.shape, dtype=_F32, device=g.device), grads_like))


def payload_ratio(p: float = 0.5, q: int = 4, high_bits: int = 16) -> float:
    """Eq. 1 generalized to a ``high_bits`` high set (+1 mask bit)."""
    return (p * (q - high_bits) + high_bits + 1) / high_bits


def compress_grad(g: torch.Tensor, w: int = 16, p: float = 0.5,
                  L: int = 7) -> torch.Tensor:
    """MIP2Q round trip on one gradient tensor (shape kept, f32 out): per
    block int8 scaling, the exact-argmin low mask, pow2 rounding of the low
    set."""
    n_low = int(round(p * w))
    flat = g.to(_F32).reshape(-1)
    pad = (-flat.numel()) % w
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, w)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    codes = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int32)
    cb = codes[:, :, None]                     # (nb, w, 1): the block API
    low = pow2_error_low_mask(cb, n_low, L)[:, :, 0]
    dec = torch.where(low, pow2_round(cb, L)[:, :, 0], codes).to(_F32) * scale
    out = dec.reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(g.shape)


def compress_tree_with_ef(grads, state: CompressionState, *, w: int = 16,
                          p: float = 0.5, L: int = 7):
    """Error-feedback compression over a gradient tree; returns
    ``(decoded grads, new state)``.  1-D leaves (norm scales, biases) pass
    through uncompressed with a zero residual: tiny and precision-critical."""
    residual = dict(_named_leaves(state.residual))
    new_res = {}

    def one(name, g):
        r = residual[name]
        if g.dim() < 2:
            new_res[name] = torch.zeros_like(r)
            return g.to(_F32)
        corrected = g.to(_F32) + r
        dec = compress_grad(corrected, w=w, p=p, L=L)
        new_res[name] = corrected - dec
        return dec

    dec = map_named(one, grads)
    return dec, CompressionState(map_named(lambda name, _: new_res[name],
                                           state.residual))
