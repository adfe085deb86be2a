"""Packed KV-page decode: the Hopper kernel K11 and its plain PyTorch version.

``strum_page_decode`` turns P packed pages back into values:

    mask (P, nb, w/8, F) u8, hi (P, nb, n_high, F) i8, lo (P, nb, lb, F) u8,
    scale (P, 1, F) f32  ->  (P, nb·w, F) f32

It replaces ``strum_page_decode_pallas`` of ``repro/kernels/strum_decode.py``
and is the ``cache:cuda_decode`` codec (``repro_torch.engine.cache``).  The
CUDA source is ``csrc/strum_attention.cu``, beside the paged-attention
kernels K4/K5.  A thread owns 4 adjacent channels of one ``[1, w]`` block
(1 where F % 4 != 0 or a field is not aligned): every mask, hi and lo row of
that block column is one 4-byte load, all issued before the decode, which
runs in registers (popcount ranks, a byte permute for the hi byte, a shift
of the lo word, a table for the lo code); each position is one 16-byte
evict-first store.  Blocks past the registers' reach (w > 64, more than 16
hi or 8 lo rows) take a staged path: the same loads land in the thread's own
column of shared memory, and each position reads its bytes there at its
ranks.

As with the matmul kernels, the tensors' device is the choice: CPU tensors
run the plain version, CUDA tensors launch the kernel, anything else
raises, and there is no fallback from a failed build or launch.
``launch_counts["page_decode"]`` goes up by one per launch.  The decoded
integer times the page's channel scale is one f32 rounding in both, so the
kernel equals the plain version bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.packing import (_scatter_expand, _unpack_bits_axis1,
                                      _unpack_fields, decode_low_values)
from repro_torch.kernels.strum_matmul import METHOD_CODES, _route

__all__ = ["strum_page_decode", "strum_page_decode_plain", "decode_lo_pages",
           "launch_counts", "reset_launch_counts", "lib"]

#: kernel name -> launches since the last reset
launch_counts = {"page_decode": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _blocks(a: torch.Tensor) -> torch.Tensor:
    """(P, nb, rows, F) -> (P·nb, rows, F): pages' blocks are independent."""
    return a.reshape((a.shape[0] * a.shape[1],) + tuple(a.shape[2:]))


def strum_page_decode_plain(mask, hi, lo, scale, *, w: int, n_low: int, q: int,
                            method: str) -> torch.Tensor:
    """Unpack the mask bits, rank each position inside its set, place hi
    values and decoded lo codes, times the per-page channel scale."""
    p, nb, _, f = mask.shape
    high = _unpack_bits_axis1(_blocks(mask), w)                # (P·nb, w, F)
    hi_vals = _scatter_expand(_blocks(hi)[:, :w - n_low].to(torch.int32), high)
    if method == "sparsity" or n_low == 0:
        vals = hi_vals
    else:
        lo_dec = decode_low_values(_unpack_fields(_blocks(lo), n_low, q), method, q)
        vals = torch.where(high, hi_vals, _scatter_expand(lo_dec, ~high))
    return vals.reshape(p, nb * w, f).to(torch.float32) * scale.reshape(p, 1, f)


def decode_lo_pages(lo, scale, *, w: int, q: int, method: str) -> torch.Tensor:
    """p = 1 pages (lo fields in position order, no mask or hi) -> values."""
    p, nb, _, f = lo.shape
    vals = decode_low_values(_unpack_fields(_blocks(lo), w, q), method, q)
    return vals.reshape(p, nb * w, f).to(torch.float32) * scale.reshape(p, 1, f)


def lib():
    """The built ``csrc/strum_attention.cu`` library (K4, K5, K11)."""
    from repro_torch.kernels import build
    so = build.load("strum_attention")
    if so.strum_page_decode_launch.argtypes is None:
        so.strum_page_decode_launch.argtypes = [ctypes.c_void_p] * 5 + \
            [ctypes.c_int] * 10 + [ctypes.c_void_p]
        so.strum_page_decode_launch.restype = ctypes.c_int
        so.strum_paged_attention_maskfree_split_launch.argtypes = \
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        so.strum_paged_attention_maskfree_split_launch.restype = ctypes.c_int
        so.strum_paged_attention_split_launch.argtypes = \
            [ctypes.c_void_p] * 14 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
        so.strum_paged_attention_split_launch.restype = ctypes.c_int
        so.strum_attention_combine_launch.argtypes = \
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        so.strum_attention_combine_launch.restype = ctypes.c_int
    return so


def check_fields(name: str, fields: dict, lead: int, nb: int, f: int,
                 device: torch.device) -> None:
    """Raise unless every packed field is contiguous on ``device`` with shape
    (lead, nb, >= least rows, F) and its dtype; ``fields`` maps a name to
    (tensor, dtype, least rows)."""
    for fname, (t, dtype, least) in fields.items():
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: {fname} must be contiguous and on {device}")
        if t.dtype != dtype or t.dim() != 4 or tuple(t.shape[:2]) != (lead, nb) \
                or t.shape[3] != f or t.shape[2] < max(least, 1):
            raise ValueError(f"{name}: {fname} {tuple(t.shape)} {t.dtype} does not "
                             f"fit ({lead}, {nb}, >= {max(least, 1)}, {f}) {dtype}")


def check_scale(name: str, scale: torch.Tensor, lead: int, f: int,
                device: torch.device) -> None:
    if scale.device != device or not scale.is_contiguous() or \
            scale.dtype != torch.float32 or tuple(scale.shape) != (lead, 1, f):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} {scale.dtype} on "
                         f"{scale.device} is not contiguous ({lead}, 1, {f}) "
                         f"float32 on {device}")


def strum_page_decode(mask, hi, lo, scale, *, w: int, n_low: int, q: int,
                      method: str) -> torch.Tensor:
    """K11: P packed pages -> (P, nb·w, F) f32.  Empty fields (hi at p = 1,
    lo under sparsity or n_low = 0) come floored at one row."""
    if w % 8:
        raise ValueError(f"page decode needs byte-aligned mask rows (w={w})")
    if _route(mask) == "plain":
        return strum_page_decode_plain(mask, hi, lo, scale, w=w, n_low=n_low, q=q,
                                       method=method)
    p, nb, _, f = mask.shape
    lo_rows = 0 if method == "sparsity" else -(-(n_low * q) // 8)
    check_fields("cuda:page_decode",
                 {"mask": (mask, torch.uint8, w // 8), "hi": (hi, torch.int8, w - n_low),
                  "lo": (lo, torch.uint8, lo_rows)}, p, nb, f, mask.device)
    check_scale("cuda:page_decode", scale, p, f, mask.device)
    out = torch.empty((p, nb * w, f), dtype=torch.float32, device=mask.device)
    err = lib().strum_page_decode_launch(
        mask.data_ptr(), hi.data_ptr(), lo.data_ptr(), scale.data_ptr(),
        out.data_ptr(), p, nb, w, f, mask.shape[2], hi.shape[2], lo.shape[2], n_low,
        q, METHOD_CODES[method], torch.cuda.current_stream(mask.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cuda:page_decode launch failed: CUDA error {err}")
    launch_counts["page_decode"] += 1
    return out
