"""Weight encoding: mask header + payload (paper §IV-D.1, Fig. 5), PyTorch
twin of ``repro.core.packing``; the arrays it makes are byte-identical to
the reference's.

Per ``[1, w]`` block and output channel: a ``w``-bit mask header (1 = high,
LSB-first), the ``n_high`` int8 high values in position order, and the
``n_low`` low codes as ``q``-bit fields, LSB-first along the block axis (a
field may straddle two bytes when ``q`` does not divide 8).  DLIQ stores the
two's-complement mantissa, MIP2Q ``[sign | k]`` (sign in the top bit),
sparsity no lo payload at all.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import blocking
from repro_torch.core.quantizers import QuantizedBlocks

__all__ = ["PackedStruM", "field_dims", "compression_ratio",
           "compression_ratio_sparsity", "pack", "decode_low_values",
           "decode_blocks", "decode_matrix", "dequantize"]


def field_dims(w: int, n_low: int, q: int, method: str) -> tuple:
    """Per-block rows of the packed payload arrays: (mask, hi, lo)."""
    mask_rows = -(-w // 8)
    hi_rows = w - n_low
    lo_rows = 0 if method == "sparsity" else -(-(n_low * q) // 8)
    return mask_rows, hi_rows, lo_rows


def compression_ratio(p: float, q: int) -> float:
    """Paper Eq. 1: compressed over int8 bytes of the mixed payload."""
    return (p * (q - 8) + 9) / 8.0


def compression_ratio_sparsity(p: float) -> float:
    """Paper Eq. 2: sparsity (or q = 1), where low values carry no payload."""
    return (9 - 8 * p) / 8.0


class PackedStruM(NamedTuple):
    """Compressed StruM weight matrix (reduction dim K × out dim N).

    scale (1, N) f32; mask (nb, ceil(w/8), N) uint8; hi (nb, n_high, N)
    int8; lo (nb, ceil(n_low*q/8), N) uint8, with nb = ceil(K/w).
    """

    method: str
    w: int
    n_low: int
    q: int
    L: int
    k_dim: int
    scale: torch.Tensor
    mask: torch.Tensor
    hi: torch.Tensor
    lo: torch.Tensor

    @property
    def n_out(self) -> int:
        return self.scale.shape[-1]

    def payload_bytes(self) -> int:
        return int(self.mask.numel() + self.hi.numel() + self.lo.numel())

    def achieved_ratio(self) -> float:
        """Realized compressed over int8 bytes of the padded matrix (scales
        excluded)."""
        return self.payload_bytes() / float(self.mask.shape[0] * self.w * self.n_out)


def _pack_bits_axis1(bits: torch.Tensor) -> torch.Tensor:
    """(nb, n, N) 0/1 -> (nb, ceil(n/8), N) uint8, LSB-first along axis 1."""
    nb, n, cols = bits.shape
    pad = (-n) % 8
    b = bits.to(torch.int32)
    if pad:
        b = torch.cat([b, b.new_zeros((nb, pad, cols))], dim=1)
    b = b.reshape(nb, (n + pad) // 8, 8, cols)
    shifts = torch.arange(8, device=bits.device, dtype=torch.int32)
    return (b << shifts[None, None, :, None]).sum(dim=2).to(torch.uint8)


def _unpack_bits_axis1(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`_pack_bits_axis1`; returns bool (nb, n, N)."""
    nb, nbytes, cols = packed.shape
    shifts = torch.arange(8, device=packed.device, dtype=torch.int32)
    bits = (packed.to(torch.int32)[:, :, None, :] >> shifts[None, None, :, None]) & 1
    return bits.reshape(nb, nbytes * 8, cols)[:, :n].to(torch.bool)


def _pack_fields(codes: torch.Tensor, q: int) -> torch.Tensor:
    """Bit-pack unsigned q-bit fields along axis 1: (nb, nl, N) -> (nb, B, N)."""
    nb, nl, n = codes.shape
    if nl == 0:
        return codes.new_zeros((nb, 0, n), dtype=torch.uint8)
    shifts = torch.arange(q, device=codes.device, dtype=torch.int32)
    bits = (codes.to(torch.int32)[:, :, None, :] >> shifts[None, None, :, None]) & 1
    return _pack_bits_axis1(bits.reshape(nb, nl * q, n))


def _unpack_fields(packed: torch.Tensor, nl: int, q: int) -> torch.Tensor:
    """Inverse of :func:`_pack_fields`; returns int32 codes (nb, nl, N)."""
    nb, _, n = packed.shape
    if nl == 0:
        return packed.new_zeros((nb, 0, n), dtype=torch.int32)
    bits = _unpack_bits_axis1(packed, nl * q).reshape(nb, nl, q, n).to(torch.int32)
    shifts = torch.arange(q, device=packed.device, dtype=torch.int32)
    return (bits << shifts[None, None, :, None]).sum(dim=2).to(torch.int32)


def _gather_compact(values: torch.Tensor, member: torch.Tensor,
                    count: int) -> torch.Tensor:
    """``values`` where ``member``, compacted to (nb, count, N) in position
    order.  Every block column holds exactly ``count`` members (StruM's
    fixed n_low), so a stable sort that puts members first finds them."""
    nb, _, n = values.shape
    if count == 0:
        return values.new_zeros((nb, 0, n))
    order = torch.argsort((~member).to(torch.int8), dim=1, stable=True)
    return torch.gather(values, 1, order[:, :count])


def _scatter_expand(payload: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_gather_compact`: payload[r] lands at the r-th
    member position (rank = exclusive prefix count); others get 0."""
    count = payload.shape[1]
    if count == 0:
        return payload.new_zeros(member.shape)
    m32 = member.to(torch.int64)
    rank = torch.cumsum(m32, dim=1) - m32
    g = torch.gather(payload, 1, rank.clamp(0, count - 1))
    return torch.where(member, g, torch.zeros_like(g))


def pack(qb: QuantizedBlocks, *, method: str, scale: torch.Tensor, k_dim: int,
         n_low: int, q: int, L: int) -> PackedStruM:
    """Encode set-quantized blocks into the compressed format (Fig. 5)."""
    values, low, low_code = qb
    nb, w, n = values.shape
    high = ~low
    mask_bytes = _pack_bits_axis1(high)
    hi = _gather_compact(values.to(torch.int8), high, w - n_low)
    if method == "sparsity":
        lo = values.new_zeros((nb, 0, n), dtype=torch.uint8)
    else:
        lc = low_code.to(torch.int32)
        code_u = lc & ((1 << q) - 1)
        if method == "mip2q":
            # low_code = sign*(k+1): re-encode as [sign | k] fields
            k = lc.abs() - 1
            sgn = (lc < 0).to(torch.int32)
            code_u = torch.where(
                low, (sgn << (q - 1)) | k.clamp(0, (1 << (q - 1)) - 1), 0)
        lo = _pack_fields(_gather_compact(code_u, low, n_low), q)
    return PackedStruM(method, w, n_low, q, L, k_dim,
                       scale.reshape(1, -1).to(torch.float32),
                       mask_bytes, hi, lo)


def decode_low_values(codes: torch.Tensor, method: str, q: int) -> torch.Tensor:
    """q-bit field -> int32 value on the int8 grid."""
    c = codes.to(torch.int32)
    if method == "sparsity":
        return torch.zeros_like(c)
    if method == "dliq":
        sign_bit = 1 << (q - 1)
        return ((c ^ sign_bit) - sign_bit) * (1 << (8 - q))
    if method == "mip2q":
        sgn = 1 - 2 * (c >> (q - 1))
        k = c & ((1 << (q - 1)) - 1)
        return sgn * torch.bitwise_left_shift(torch.ones_like(k), k)
    raise ValueError(method)


def decode_blocks(p: PackedStruM):
    """Decompress to blocked int32 values + high-mask (nb, w, N)."""
    high = _unpack_bits_axis1(p.mask, p.w)
    hi_vals = _scatter_expand(p.hi.to(torch.int32), high)
    if p.method == "sparsity" or p.n_low == 0:
        lo_vals = torch.zeros_like(hi_vals)
    else:
        lo_dec = decode_low_values(_unpack_fields(p.lo, p.n_low, p.q), p.method, p.q)
        lo_vals = _scatter_expand(lo_dec, ~high)
    return torch.where(high, hi_vals, lo_vals), high


def decode_matrix(p: PackedStruM) -> torch.Tensor:
    """Decompress to the (K, N) int32 value matrix (int8 grid)."""
    return blocking.from_blocks(decode_blocks(p)[0], p.k_dim)


def dequantize(p: PackedStruM, dtype=torch.float32) -> torch.Tensor:
    """Decompress to real-valued weights: values · per-channel scale."""
    return (decode_matrix(p).to(torch.float32) * p.scale).to(dtype)
