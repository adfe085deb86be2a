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
from typing import Optional

import torch

from repro_torch.core.packing import (_scatter_expand, _unpack_bits_axis1,
                                      _unpack_fields, decode_low_values)
from repro_torch.kernels import hooks
from repro_torch.kernels.strum_matmul import METHOD_CODES, _route

__all__ = ["strum_page_decode", "strum_page_decode_plain", "decode_lo_pages",
           "launch_counts", "reset_launch_counts", "lib", "launch_contract"]

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


def check_placed(name: str, fields: dict, device: torch.device) -> None:
    """Raise unless every packed field (name -> tensor) is contiguous on
    ``device``: what a launch contract, which sees only shapes and
    dtypes, cannot check."""
    for fname, t in fields.items():
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: {fname} must be contiguous and on {device}")


def check_scale(name: str, scale: torch.Tensor, lead: int, f: int,
                device: torch.device) -> None:
    if scale.device != device or not scale.is_contiguous() or \
            scale.dtype != torch.float32 or tuple(scale.shape) != (lead, 1, f):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} {scale.dtype} on "
                         f"{scale.device} is not contiguous ({lead}, 1, {f}) "
                         f"float32 on {device}")


_CU = "csrc/strum_attention.cu"
_STAGED_SMEM = 200 * 1024   # kStagedSmem: the staged path's shared memory


def launch_contract(p: int, nb: int, w: int, f: int, n_low: int, q: int,
                    method: str, *, fields=None) -> dict:
    """Everything K11 refuses, from shapes and dtypes alone: raises
    ``ValueError`` with the reason, naming the line of
    ``csrc/strum_attention.cu`` where ``strum_page_decode_launch`` returns
    ``cudaErrorInvalidValue`` for the same point.  The launcher calls it
    first.  ``p`` pages of ``nb`` blocks of width ``w`` over ``f``
    channels; ``fields`` maps mask / hi / lo to ``(shape, dtype)``
    (default: the packer's rows, empty ones floored at one).  Returns
    ``{"rows"}``: the (mask, hi, lo) rows a block."""
    tag = "cuda:page_decode"

    def refuse(why: str, line: Optional[int] = None):
        raise ValueError(f"{tag}: {why}" + (f" ({_CU}:{line})" if line else ""))

    lo_on = method != "sparsity" and n_low > 0
    n_high, lo_n = w - n_low, -(-(n_low * q) // 8) if lo_on else 0
    if min(p, nb, w, f) < 1 or not 0 <= n_low <= w or p * nb > 0x7FFFFFFF:
        refuse(f"P={p} nb={nb} w={w} F={f} n_low={n_low} out of range", 918)
    if w % 8:
        refuse(f"needs byte-aligned mask rows (w={w})", 918)
    if lo_on and not 1 <= q <= 8:
        refuse(f"q={q} outside [1, 8]", 918)
    least = {"mask": (torch.uint8, w // 8), "hi": (torch.int8, n_high),
             "lo": (torch.uint8, 0 if method == "sparsity" else lo_n)}
    if fields is None:
        fields = {k: ((p, nb, max(v[1], 1), f), v[0]) for k, v in least.items()}
    rows = {}
    for name, (shape, dtype) in fields.items():
        want, low = least[name]
        if dtype != want or len(shape) != 4 or tuple(shape[:2]) != (p, nb) \
                or shape[3] != f or shape[2] < max(low, 1):
            refuse(f"{name} {tuple(shape)} {dtype} does not fit ({p}, {nb}, "
                   f">= {max(low, 1)}, {f}) {want}", 918)
        rows[name] = shape[2]
    staged = w > 64 or n_high > 16 or lo_n > 8
    if staged and 32 * 4 * (w // 8 + max(n_high, 1) + max(lo_n, 1)) > _STAGED_SMEM:
        refuse(f"one warp's staged columns exceed {_STAGED_SMEM} bytes", 406)
    return {"rows": (rows["mask"], rows["hi"], rows["lo"])}


def strum_page_decode(mask, hi, lo, scale, *, w: int, n_low: int, q: int,
                      method: str) -> torch.Tensor:
    """K11: P packed pages -> (P, nb·w, F) f32.  Empty fields (hi at p = 1,
    lo under sparsity or n_low = 0) come floored at one row."""
    if hooks.active is not None:     # a dataflow trace: record the call, then run it
        return hooks.active.kernel("cache:cuda_decode", strum_page_decode, mask, hi, lo,
                                   scale, w=w, n_low=n_low, q=q, method=method)
    if w % 8:
        raise ValueError(f"page decode needs byte-aligned mask rows (w={w})")
    if _route(mask) == "plain":
        return strum_page_decode_plain(mask, hi, lo, scale, w=w, n_low=n_low, q=q,
                                       method=method)
    p, nb, _, f = mask.shape
    route = launch_contract(p, nb, w, f, n_low, q, method, fields={
        k: (tuple(t.shape), t.dtype) for k, t in (("mask", mask), ("hi", hi), ("lo", lo))})
    check_placed("cuda:page_decode", {"mask": mask, "hi": hi, "lo": lo}, mask.device)
    check_scale("cuda:page_decode", scale, p, f, mask.device)
    out = torch.empty((p, nb * w, f), dtype=torch.float32, device=mask.device)
    err = lib().strum_page_decode_launch(
        mask.data_ptr(), hi.data_ptr(), lo.data_ptr(), scale.data_ptr(),
        out.data_ptr(), p, nb, w, f, *route["rows"], n_low,
        q, METHOD_CODES[method], torch.cuda.current_stream(mask.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cuda:page_decode launch failed: CUDA error {err}")
    launch_counts["page_decode"] += 1
    return out
