"""Set-quantization strategies (paper §IV-C), PyTorch twin of
``repro.core.quantizers``.

All three strategies act inside ``[1, w]`` blocks of int8 codes (symmetric,
per output channel): ``sparsity`` zeroes the ``n_low`` smallest magnitudes,
``dliq`` re-quantizes them to a signed ``q``-bit mantissa (dequant: shift
left by ``8 - q``), ``mip2q`` rounds the ``n_low`` values with the smallest
power-of-two error to ``±2**k``, ``k ∈ [0, L]``.

Bit-exact with the reference by construction:

* ``rank_in_block`` is a double *stable* argsort, so ties break by position;
* ``torch.round`` rounds half to even, as ``jnp.round`` does;
* ``pow2_round`` takes ``floor(log2 a)`` from the float exponent
  (``torch.frexp``) instead of ``log2``, so exact powers of two never land
  one below; the boundary between ``2**k`` and ``2**(k+1)`` is ``1.5·2**k``
  (strict), and 0 rounds to +1.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["QuantizedBlocks", "int8_symmetric", "dequantize_int8",
           "rank_in_block", "magnitude_low_mask", "pow2_round", "pow2_shift",
           "pow2_error_low_mask", "structured_sparsity", "dliq", "mip2q",
           "quantize_blocks", "n_low_for_p", "METHODS"]

METHODS = ("sparsity", "dliq", "mip2q")


class QuantizedBlocks(NamedTuple):
    """values int32 on the int8 grid; low_mask bool (True = low set);
    low_code int32 payload code (DLIQ mantissa, MIP2Q ``sign*(k+1)``)."""

    values: torch.Tensor
    low_mask: torch.Tensor
    low_code: torch.Tensor


def n_low_for_p(p: float, w: int) -> int:
    """Fixed per-block low count for precision ratio ``p`` (paper: p·w)."""
    n = int(round(p * w))
    if not 0 <= n <= w:
        raise ValueError(f"p={p} out of range for block width {w}")
    return n


def int8_symmetric(w: torch.Tensor, axis: int = 0):
    """Per-output-channel symmetric INT8: ``(codes int8 in [-127,127],
    scale f32)`` with ``w ≈ codes * scale``; ``axis`` is the reduction axis."""
    amax = torch.amax(w.abs(), dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones_like(amax)).to(torch.float32)
    codes = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return codes, scale


def dequantize_int8(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``codes * scale`` in f32, the inverse of :func:`int8_symmetric`."""
    return codes.to(torch.float32) * scale


def rank_in_block(key: torch.Tensor) -> torch.Tensor:
    """Dense rank (0 = smallest key) along axis 1; ties break by position."""
    order = torch.argsort(key, dim=1, stable=True)
    return torch.argsort(order, dim=1, stable=True)


def magnitude_low_mask(codes: torch.Tensor, n_low: int) -> torch.Tensor:
    """Lowest-|magnitude| ``n_low`` per block (sparsity / DLIQ split)."""
    return rank_in_block(codes.to(torch.int32).abs()) < n_low


def _pow2_parts(v: torch.Tensor, L: int):
    """(sign int32, shift k int32) of the nearest ``±2**k``, k in [0, L]."""
    a = v.abs().to(torch.float32)
    # floor(log2 a) for a >= 1 from the exponent field: exact at powers of 2
    _, e = torch.frexp(torch.clamp(a, min=1.0))
    kf = (e - 1).to(torch.int32)
    lo = torch.ldexp(torch.ones_like(a), kf)
    k = torch.where(a - lo > 2.0 * lo - a, kf + 1, kf).clamp(0, L)
    sgn = torch.where(v < 0, -1, 1).to(torch.int32)
    return sgn, k.to(torch.int32)


def pow2_round(v: torch.Tensor, L: int) -> torch.Tensor:
    """Nearest signed power of two with shift clipped to ``[0, L]``;
    v = 0 maps to +1 (no zero code in the sign+shift payload)."""
    sgn, k = _pow2_parts(v, L)
    return sgn * torch.bitwise_left_shift(torch.ones_like(k), k)


def pow2_shift(v: torch.Tensor, L: int) -> torch.Tensor:
    """Shift ``k`` such that ``pow2_round(v) = sign(v)·2**k``."""
    return _pow2_parts(v, L)[1]


def pow2_error_low_mask(codes: torch.Tensor, n_low: int, L: int) -> torch.Tensor:
    """Exact argmin of the MIP2Q objective: the n_low smallest pow2 errors,
    ties broken by |magnitude| then position."""
    c = codes.to(torch.int32)
    err = (c - pow2_round(codes, L)).abs()
    return rank_in_block(err * 256 + c.abs()) < n_low


def structured_sparsity(codes: torch.Tensor, n_low: int) -> QuantizedBlocks:
    c = codes.to(torch.int32)
    low = magnitude_low_mask(codes, n_low)
    return QuantizedBlocks(torch.where(low, 0, c), low, torch.zeros_like(c))


def dliq(codes: torch.Tensor, n_low: int, q: int = 4) -> QuantizedBlocks:
    """Dual-Level Integer Quantization (paper §IV-C.1)."""
    if not 1 <= q <= 8:
        raise ValueError(f"q={q} must be in [1, 8]")
    c = codes.to(torch.int32)
    low = magnitude_low_mask(codes, n_low)
    step = 1 << (8 - q)
    qmax = (1 << (q - 1)) - 1
    mant = torch.clamp(torch.round(c.to(torch.float32) / step),
                       -qmax, qmax).to(torch.int32)
    return QuantizedBlocks(torch.where(low, mant * step, c), low,
                           torch.where(low, mant, 0))


def mip2q(codes: torch.Tensor, n_low: int, L: int = 7) -> QuantizedBlocks:
    """Mixed Integer + Power-of-2 Quantization (paper §IV-C.2)."""
    if L < 0:
        raise ValueError("L must be >= 0")
    c = codes.to(torch.int32)
    low = pow2_error_low_mask(codes, n_low, L)
    sgn, k = _pow2_parts(codes, L)
    p2 = sgn * torch.bitwise_left_shift(torch.ones_like(k), k)
    return QuantizedBlocks(torch.where(low, p2, c), low,
                           torch.where(low, sgn * (k + 1), 0))


def quantize_blocks(codes: torch.Tensor, method: str, n_low: int, *,
                    q: int = 4, L: int = 7) -> QuantizedBlocks:
    """Dispatch on method name ('sparsity' | 'dliq' | 'mip2q')."""
    if method == "sparsity":
        return structured_sparsity(codes, n_low)
    if method == "dliq":
        return dliq(codes, n_low, q)
    if method == "mip2q":
        return mip2q(codes, n_low, L)
    raise ValueError(f"unknown StruM method {method!r}; want one of {METHODS}")
