"""StruM packed-weight matmul: the Hopper kernels K1-K3, their grouped
twins K6-K8, the draft kernels K9-K10, and their plain PyTorch versions.

``strum_matmul_onehot`` (K1, general mask + hi + lo decode),
``strum_matmul_maskfree`` (K2, p = 1: lo fields only, in position order) and
``strum_matmul_dense`` (K3, n_low = 0: hi is the block in order) each compute
``y(M, N) f32 = x(M, K) @ dequant(W)`` from the packed fields.  They replace
``strum_matmul_pallas``, ``strum_matmul_pallas_maskfree`` and
``strum_matmul_pallas_dense`` of ``repro/kernels/strum_matmul.py``; the CUDA
source, with its design and what bounds it, is ``csrc/strum_matmul.cu``.
Every kernel here accumulates in f32 and takes no ``accum_dtype``: as the
reference's Pallas variants ignore ``cfg.accum_dtype``, only the plain
routes of ``engine`` round their products to it.

``strum_matmul_grouped_{onehot,maskfree,dense}`` (K6, K7, K8) compute
``y(G, M, N) f32 = x(G, M, K) @ dequant(W[g])`` for every group ``g`` of a
stacked payload (every field ``(G, nb, rows, N)``, scale ``(G, 1, N)``): the
MoE expert contractions.  They replace ``strum_matmul_pallas_grouped``,
``_grouped_maskfree`` and ``_grouped_dense``; the group is a grid axis and K
is never split across blocks.  All three take optional per-group live-row
counts ``rows``: rows past ``rows[g]`` are zero in x and come out as exact
zeros, and a row tile past the count reads no weight byte.  K6 and K7 are
two modes of a kernel of their own (asynchronous 16-byte staging, register
decode, bf16 tensor cores for bf16 x); K8 is the grouped form of the
streamed kernel's dense mode (below).

K1, K2, K3, K8, K9 and K10 (``_STREAM``; w <= ``STREAM_MAX_W`` and w % 8
== 0) run one kernel of their own, five modes of it (128-column tiles, the
packed rows a mode streams brought in by 16-byte asynchronous copies
through a ring, decode in registers, bf16 x on tensor cores).  The common
codec (w = 16: K1 and K9 with 8 high and, for K1, 4-bit lo codes whose
values fit int8; K2 with such codes; K10 with 8 high; K3 and K8 at n_low =
0) decodes four positions at a time with byte permutes, driven where it
needs them by the small tables that ``byte_path_tables`` builds here and
the launcher hands to the kernel; every other codec takes the kernel's
general path.  Under n_low = 0 the hi rows of a payload are every value in
position order, so K3 and K8 hand any payload with nb * w % 16 == 0 to the
byte path as blocks of 16 (``_dense_view``).  The other widths run the
first template (``strum_matmul_kernel``).

At decode the 2-D kernels split K across the blocks of one thread-block
cluster (``_split_count``, at most ``MAX_SPLITS``) and add the partial tiles
in rank order on the card: two calls on the same inputs give the same bits.

``strum_matmul_histream`` (K9) and ``strum_matmul_maskfree_p`` (K10) are
the reduced-fidelity reads of self-speculative decoding's draft lane: K9
places the hi values at their masked positions and decodes every low
position to 0 (it never reads lo), K10 places them in the leading
``n_high`` positions of each block (it reads neither mask nor lo).  They
replace ``strum_matmul_pallas_histream`` and
``strum_matmul_pallas_maskfree_p``; the fields a kernel does not stream go
to it as null pointers.

Each wrapper takes the device of its tensors as the choice: CPU tensors go
to the plain version (the CPU tests' path), CUDA tensors launch the kernel,
and anything else raises.  There is no fallback from a failed build or
launch to the plain version.  ``launch_counts[name]`` goes up by one per
kernel launch and nowhere else, so a run can show it went through the
kernel.

The plain versions repeat the kernel's arithmetic step by step: unpack the
mask bits, rank each position inside its set, place hi values and decoded
lo codes, matmul against the zero-padded activations in f32, scale each
column in the epilogue.
"""
from __future__ import annotations

import ctypes
import functools
import math
import types
from typing import Optional

import torch

from repro_torch.core.packing import (_scatter_expand, _unpack_bits_axis1,
                                      _unpack_fields, decode_low_values)
from repro_torch.kernels import hooks

__all__ = ["strum_matmul_onehot", "strum_matmul_maskfree", "strum_matmul_dense",
           "strum_matmul_onehot_plain", "strum_matmul_maskfree_plain",
           "strum_matmul_dense_plain", "strum_matmul_grouped_onehot",
           "strum_matmul_grouped_maskfree", "strum_matmul_grouped_dense",
           "strum_matmul_grouped_onehot_plain",
           "strum_matmul_grouped_maskfree_plain",
           "strum_matmul_grouped_dense_plain", "strum_matmul_histream",
           "strum_matmul_maskfree_p", "strum_matmul_histream_plain",
           "strum_matmul_maskfree_p_plain", "launch_counts",
           "reset_launch_counts", "METHOD_CODES", "byte_path_tables",
           "launch_contract"]

METHOD_CODES = {"sparsity": 0, "dliq": 1, "mip2q": 2}
_ROWS = ("grouped_onehot", "grouped_maskfree", "grouped_dense")  # take ``rows``
_ENTRY = {"onehot": "strum_onehot_launch", "maskfree": "strum_maskfree_launch",
          "dense": "strum_dense_launch",
          "grouped_onehot": "strum_grouped_onehot_launch",
          "grouped_maskfree": "strum_grouped_maskfree_launch",
          "grouped_dense": "strum_grouped_dense_launch",
          "histream": "strum_histream_launch",
          "maskfree_p": "strum_maskfree_p_launch"}
_BN = 64  # output columns per CUDA block of the template (kBN in the source)
MAX_SPLITS = 8  # K slices of one 2-D tile: one portable cluster (kMaxSplits)
#: K1, K2, K9, K10, K3 and K8 run the streamed kernel up to this block
#: width, for w % 8 == 0 (the template otherwise; K3 and K8 first take the
#: 16-wide view of ``_dense_view``); each takes the byte path's tables
_STREAM = ("onehot", "maskfree", "histream", "maskfree_p", "dense", "grouped_dense")
STREAM_MAX_W = 64
STREAM_BN = 128  # output columns per block of the streamed kernel (kSBN)

#: kernel name -> launches since the last reset
launch_counts = {name: 0 for name in _ENTRY}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# --------------------------------------------------------- plain versions --

def _matmul_scaled(x2: torch.Tensor, vals: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """(M, K) x, (nb, w, N) decoded ints -> (M, N) f32, padded-K rows met by
    zero activations, scale applied per column after the sum."""
    nb, w, n = vals.shape
    xf = x2.to(torch.float32)
    pad = nb * w - xf.shape[1]
    if pad:
        xf = torch.cat([xf, xf.new_zeros((xf.shape[0], pad))], dim=1)
    return (xf @ vals.reshape(nb * w, n).to(torch.float32)) * scale.reshape(1, n)


def strum_matmul_onehot_plain(x2, mask, hi, lo, scale, *, w: int, n_low: int,
                              q: int, method: str, L=None) -> torch.Tensor:
    """K1's arithmetic; ``L`` is accepted as the kernel's wrapper takes it,
    and changes nothing."""
    high = _unpack_bits_axis1(mask, w)                       # (nb, w, N)
    hi_vals = _scatter_expand(hi[:, :w - n_low].to(torch.int32), high)
    if method == "sparsity" or n_low == 0:
        vals = hi_vals
    else:
        lo_dec = decode_low_values(_unpack_fields(lo, n_low, q), method, q)
        vals = torch.where(high, hi_vals, _scatter_expand(lo_dec, ~high))
    return _matmul_scaled(x2, vals, scale)


def strum_matmul_maskfree_plain(x2, lo, scale, *, w: int, q: int,
                                method: str, L=None) -> torch.Tensor:
    """K2's arithmetic; ``L`` is accepted as the kernel's wrapper takes it,
    and changes nothing."""
    vals = decode_low_values(_unpack_fields(lo, w, q), method, q)
    return _matmul_scaled(x2, vals, scale)


def strum_matmul_dense_plain(x2, hi, scale, *, w: int) -> torch.Tensor:
    return _matmul_scaled(x2, hi[:, :w].to(torch.int32), scale)


def strum_matmul_histream_plain(x2, mask, hi, scale, *, w: int,
                                n_low: int) -> torch.Tensor:
    """K9's arithmetic: hi values at their masked positions, low positions
    0; lo is never read."""
    high = _unpack_bits_axis1(mask, w)                       # (nb, w, N)
    return _matmul_scaled(x2, _scatter_expand(hi[:, :w - n_low].to(torch.int32),
                                              high), scale)


def strum_matmul_maskfree_p_plain(x2, hi, scale, *, w: int,
                                  n_low: int) -> torch.Tensor:
    """K10's arithmetic: hi values in the leading ``w - n_low`` positions of
    each block, the rest 0; neither mask nor lo is read."""
    hv = hi[:, :w - n_low].to(torch.int32)
    vals = torch.cat([hv, hv.new_zeros((hv.shape[0], n_low, hv.shape[2]))], dim=1)
    return _matmul_scaled(x2, vals, scale)


def _past_rows_zero(y: torch.Tensor, rows) -> torch.Tensor:
    """(G, M, N) y with rows at or past ``rows[g]`` of group g set to 0."""
    if rows is None:
        return y
    live = torch.arange(y.shape[1], device=y.device)[None, :] < \
        rows.to(device=y.device, dtype=torch.long).reshape(-1, 1)
    return torch.where(live[..., None], y, y.new_zeros(()))


def strum_matmul_grouped_onehot_plain(x3, mask, hi, lo, scale, rows=None,
                                      **kw) -> torch.Tensor:
    """(G, M, K) x against (G, ...) fields: the 2-D plain version per group;
    with ``rows`` (G,), rows at or past ``rows[g]`` are 0 (K6's contract:
    x is 0 there)."""
    return _past_rows_zero(torch.stack([
        strum_matmul_onehot_plain(x3[g], mask[g], hi[g], lo[g], scale[g], **kw)
        for g in range(x3.shape[0])]), rows)


def strum_matmul_grouped_maskfree_plain(x3, lo, scale, rows=None,
                                        **kw) -> torch.Tensor:
    """K7's arithmetic per group; ``rows`` as for K6."""
    return _past_rows_zero(torch.stack([
        strum_matmul_maskfree_plain(x3[g], lo[g], scale[g], **kw)
        for g in range(x3.shape[0])]), rows)


def strum_matmul_grouped_dense_plain(x3, hi, scale, rows=None, **kw) -> torch.Tensor:
    """K8's arithmetic per group; ``rows`` as for K6."""
    return _past_rows_zero(torch.stack([
        strum_matmul_dense_plain(x3[g], hi[g], scale[g], **kw)
        for g in range(x3.shape[0])]), rows)


# ------------------------------------------------ the byte path's tables --

def _nibble_selector(nib: int) -> int:
    """``prmt`` selector placing one group of 4 positions: byte i takes hi
    byte (rank of i among the nibble's set bits) from the hi window, or lo
    byte 4 + (rank of i among its clear bits) from the lo window."""
    sel = 0
    for i in range(4):
        high_below = bin(nib & ((1 << i) - 1)).count("1")
        sel |= (high_below if (nib >> i) & 1 else 4 + i - high_below) << (4 * i)
    return sel


def _lo_table(method: str, q: int, L):
    """The 16-byte table of 4-bit lo code -> int8 value (as 16 bytes), or
    None where a code the codec can emit decodes outside [-128, 127]: dliq q
    = 4 gives [-128, 112]; mip2q emits +-2^k for k <= L, so it needs L <= 6
    (L = 7 emits +128; an unknown L counts as the widest, 7).  Entries of
    codes the codec never emits are their values wrapped to a byte."""
    if q != 4:
        return None
    codes = torch.arange(16, dtype=torch.int32)
    decoded = decode_low_values(codes, method, q)
    emitted = decoded[(codes & 7) <= (7 if L is None else L)] if method == "mip2q" \
        else decoded
    if int(emitted.min()) < -128 or int(emitted.max()) > 127:
        return None
    return [int(v) & 0xFF for v in decoded]


@functools.lru_cache(maxsize=None)
def byte_path_tables(w: int, n_low: int, *, q: int = 4, method: str = "sparsity",
                     L=None, kernel: str = "onehot"):
    """The 20 words a streamed kernel (``_STREAM``) takes for the byte path,
    or None for the general path: 16 ``prmt`` selectors (one per mask
    nibble) and the 16-byte table of lo code -> int8 value (4 words, code c
    in byte c % 4 of word c // 4).

    K1 / K9 (``kernel`` "onehot" / "histream"): the codec w = 16 with 8 high
    positions; where lo is read (K1, a method that stores lo) its codes
    must be 4 bits and every code the codec can emit must decode
    into [-128, 127] (``_lo_table``).  K2 ("maskfree"): w = 16, every
    position a lo code under that same rule; its codes are in position
    order, so the selectors are 0 (not read).  K10 ("maskfree_p"): w = 16
    with 8 high; it places hi bytes in order and reads no lo, so all 20
    words are 0 (not read): their presence selects the byte path.  K3 / K8
    ("dense" / "grouped_dense"): w = 16, n_low = 0 (16 hi rows a block, as
    ``_dense_view`` hands every payload it can), all 20 words 0 likewise."""
    if w != 16:
        return None
    if kernel in ("dense", "grouped_dense"):
        return (0,) * 20 if n_low == 0 else None
    if kernel == "maskfree":
        values = _lo_table(method, q, L) if n_low == w and method != "sparsity" else None
        if values is None:
            return None
        sel = [0] * 16
    elif n_low != 8:
        return None
    elif kernel == "maskfree_p":
        return (0,) * 20
    else:
        values = [0] * 16
        if kernel == "onehot" and method != "sparsity":
            values = _lo_table(method, q, L)
            if values is None:
                return None
        sel = [_nibble_selector(nib) for nib in range(16)]
    code = [sum(values[4 * i + b] << (8 * b) for b in range(4)) for i in range(4)]
    return tuple(sel + code)


@functools.lru_cache(maxsize=None)
def _table_words(name, w, n_low, q, method, L):
    """Kernel ``name``'s ``byte_path_tables`` as the ctypes array the
    launcher takes, or None."""
    words = byte_path_tables(w, n_low, q=q, method=method, L=L, kernel=name)
    return (ctypes.c_uint32 * len(words))(*words) if words else None


# ------------------------------------------------------------ CUDA launch --

def _lib():
    from repro_torch.kernels import build
    lib = build.load("strum_matmul")
    for name, entry in _ENTRY.items():
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            # 2-D: M N K ldx nb w rows x3 n_low q method splits;
            # grouped: G M N K nb w rows x3 n_low q method; K6, K7 and K8
            # also take the live-row counts after scale; the streamed
            # kernels take the byte path's tables (host memory) before the
            # stream
            ints = 12 if name.startswith("grouped_") else 13
            ptrs = 6 if name in _ROWS else 5
            tables = [ctypes.POINTER(ctypes.c_uint32)] if name in _STREAM else []
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * ptrs
                           + [ctypes.c_int] * ints + tables + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _splits(m: int, n: int, nb: int, device=None, *, sms=None) -> int:
    """Split K across blocks when the output tiles alone cannot fill the
    card (decode: M = batch, a few dozen column tiles); the slices of one
    tile are one thread-block cluster, at most ``MAX_SPLITS`` blocks.
    ``sms`` (the card's SM count) is asked of ``device`` unless given."""
    tiles = math.ceil(n / _BN) * math.ceil(m / (8 if m <= 8 else 64))
    sms = _sm_count(device) if sms is None else sms
    if tiles >= sms:
        return 1
    return max(1, min(math.ceil(2 * sms / tiles), nb // 4, MAX_SPLITS))


def _streamed(name: str, w: int) -> bool:
    """Whether a launch of kernel ``name`` at block width ``w`` runs the
    streamed kernel (for K3 and K8, the width after ``_dense_view``)."""
    return name in _STREAM and w <= STREAM_MAX_W and w % 8 == 0


def _dense_view(w: int, nb: int, hi_rows: int):
    """K3 / K8's route for ``nb`` blocks of width ``w`` with ``hi_rows`` hi
    rows each: ``(path, nb, w, hi_rows)`` as the launcher hands them over.

    Under n_low = 0, hi ``(nb, w, N)`` is every value in position order, so
    as ``(nb * w, N)`` contiguous int8 it is also ``nb * w / 16`` blocks of
    16 whenever ``nb * w % 16 == 0`` (x's true K still nulls the padded
    rows): the streamed kernel's byte path ("bytes").  Otherwise w <= 64
    with w % 8 == 0 takes its general path ("general"), and the rest the
    template ("template")."""
    if hi_rows == w and nb * w % 16 == 0:
        return "bytes", nb * w // 16, 16, 16
    if _streamed("dense", w):
        return "general", nb, w, hi_rows
    return "template", nb, w, hi_rows


def _stream_splits(m: int, n: int, nb: int, bf16: bool, device=None, *,
                   sms=None) -> int:
    """The streamed kernel's split: a 128-column tile (16 rows; 128 rows
    past 16 rows of bf16 x) runs one block an SM (its launch bounds; K1's
    tile holds ~180 KB of shared memory), so K is split until the tiles
    cover the SMs once (no second partial wave), at most ``MAX_SPLITS``
    slices of at least 4 w-blocks.  The launcher takes fewer where the card
    cannot hold every cluster at once (it asks the card)."""
    bm = 128 if bf16 and m > 16 else 16
    tiles = math.ceil(n / STREAM_BN) * math.ceil(m / bm)
    sms = _sm_count(device) if sms is None else sms
    if tiles >= sms:
        return 1
    return max(1, min(sms // tiles, nb // 4, MAX_SPLITS))


def _split_count(name: str, m: int, n: int, nb: int, w: int, bf16: bool,
                 device=None, *, sms=None) -> int:
    """K slices a 2-D launch of kernel ``name`` takes."""
    if _streamed(name, w):
        return _stream_splits(m, n, nb, bf16, device, sms=sms)
    return _splits(m, n, nb, device, sms=sms)


_CU = "csrc/strum_matmul.cu"


def _field_rows(w: int, n_low: int, q: int, method: str) -> dict:
    """Field -> (dtype, least rows per block the kernels read); the packer
    writes exactly these (an empty field floored at one row)."""
    return {"mask": (torch.uint8, -(-w // 8)), "hi": (torch.int8, w - n_low),
            "lo": (torch.uint8, 0 if method == "sparsity" else -(-(n_low * q) // 8))}


def launch_contract(name: str, m: int, k: int, nb: int, n: int, w: int,
                    n_low: int, q: int, method: str, dtype, groups: int = 0, *,
                    fields=None, L=None, sms=None) -> dict:
    """Everything kernel ``name`` (a key of ``_ENTRY``) refuses, from shapes
    and dtypes alone: raises ``ValueError`` with the reason, naming the line
    of ``csrc/strum_matmul.cu`` where its C++ entry point returns
    ``cudaErrorInvalidValue`` for the same point.  The launcher calls it
    before anything else, so it is the one statement of what launches.

    ``x`` is ``(M, K)`` (``groups`` = 0) or ``(G, M, K)``, the payload ``nb``
    blocks of width ``w`` over ``N`` columns.  ``fields`` maps each field
    the kernel reads to its ``(shape, dtype)`` (default: the packer's
    rows); ``sms``, the card's SM count, adds the K split of a 2-D launch.
    Returns the route, a read-only mapping cached per argument set (a
    launch pays one lookup): ``nb`` / ``w`` / ``rows`` (mask, hi, lo) as
    the entry point takes them (K3 / K8 after ``_dense_view``), the byte
    path's ``tables`` (or None) and ``splits``."""
    return _contract(name, m, k, nb, n, w, n_low, q, method, dtype, groups,
                     None if fields is None else tuple(fields.items()), L, sms)


@functools.lru_cache(maxsize=4096)
def _contract(name, m, k, nb, n, w, n_low, q, method, dtype, groups, fields, L, sms):
    fields = None if fields is None else dict(fields)
    if name not in _ENTRY:
        raise ValueError(f"no StruM matmul kernel {name!r}; want one of {sorted(_ENTRY)}")
    tag = f"cuda:{name}"

    def refuse(why: str, line: Optional[int] = None):
        raise ValueError(f"{tag}: {why}" + (f" ({_CU}:{line})" if line else ""))

    grouped = name.startswith("grouped_")
    if dtype not in (torch.float32, torch.bfloat16):
        refuse(f"x must be float32/bfloat16, got {dtype}")
    # the entry point that refuses for the C++ side: K6's, K7's, the
    # streamed kernel's, or the template's (which checks only sizes)
    entry = {"grouped_onehot": 1860, "grouped_maskfree": 1886}.get(
        name, 1744 if _streamed(name, w) or name == "grouped_dense" and w <= 64
        and w % 8 == 0 else 430)
    cxx = None if entry == 430 else entry
    if grouped and not 1 <= groups <= 65535:
        refuse(f"G={groups} groups outside [1, 65535]", 1838 if name == "grouped_dense"
               and groups < 1 else entry)
    if not grouped and groups:
        refuse(f"a 2-D kernel takes no groups (G={groups})")
    if min(m, n, k, nb, w) < 1 or not 0 <= n_low <= w:
        refuse(f"M={m} N={n} K={k} nb={nb} w={w} n_low={n_low} out of range", entry)
    if k > nb * w:
        refuse(f"x K={k} exceeds the payload's nb*w={nb * w}", cxx)
    if name in ("onehot", "histream", "grouped_onehot") and w % 8:
        refuse(f"needs byte-aligned mask rows (w={w})", cxx)
    if name in ("maskfree", "grouped_maskfree") and (
            method not in ("dliq", "mip2q") or n_low != w):
        refuse(f"needs a lo payload at n_low == w, got {method} n_low={n_low} w={w}",
               cxx)
    if name in ("dense", "grouped_dense") and n_low:
        refuse(f"needs n_low == 0, got {n_low}", cxx)
    if name in ("histream", "maskfree_p") and n_low >= w:
        refuse(f"needs high values to stream (n_low={n_low} w={w})", cxx)
    if name in ("grouped_onehot", "grouped_maskfree") and w > 64:
        refuse(f"w={w} > 64", entry)
    mode = name.replace("grouped_", "")
    reads = {"onehot": ("mask", "hi", "lo"), "maskfree": ("lo",), "dense": ("hi",),
             "histream": ("mask", "hi"), "maskfree_p": ("hi",)}[mode]
    reads_lo = "lo" in reads and method != "sparsity" and n_low > 0
    if reads_lo and not 1 <= q <= 8:
        refuse(f"q={q} outside [1, 8]", cxx)
    least = _field_rows(w, n_low, q, method)
    if fields is None:
        fields = {f: ((groups,) * grouped + (nb, max(least[f][1], 1), n), least[f][0])
                  for f in reads}
    rows = {"mask": 0, "hi": 0, "lo": 0}
    for f, (shape, fdtype) in fields.items():
        want, low = least[f]
        if fdtype != want or len(shape) != 3 + grouped or shape[grouped] != nb or \
                shape[-1] != n or shape[grouped + 1] < max(low, 1) or \
                (grouped and shape[0] != groups):
            refuse(f"{f} {tuple(shape)} {fdtype} does not fit G={max(groups, 1)} "
                   f"nb={nb} N={n} ({want}, >= {low} rows)")
        rows[f] = shape[grouped + 1]
    if "mask" in fields and cxx and rows["mask"] != w // 8:
        refuse(f"mask has {rows['mask']} rows a block; the kernel reads w/8 = {w // 8}",
               cxx)
    r_nb, r_w, r_hi = nb, w, rows["hi"]
    streamed, byte_path = _streamed(name, w), _streamed(name, w)
    if mode == "dense":                  # the same bytes, maybe 16 wide
        path, r_nb, r_w, r_hi = _dense_view(w, nb, r_hi)
        streamed, byte_path = path != "template", path == "bytes"
    tables = byte_path_tables(r_w, n_low, q=q, method=method, L=L, kernel=name) \
        if byte_path else None
    if tables is not None and not (r_w == 16 and (
            q == 4 and rows["lo"] == 8 if mode == "maskfree" else
            r_hi == 16 if mode == "dense" else
            n_low == 8 and r_hi == 8 and (not reads_lo or (q == 4 and rows["lo"] == 4)))):
        # the byte path's layouts: w = 16 and (but K2, K3, K8) 8 high
        refuse(f"the byte path's tables do not fit rows {rows} at w={r_w}", 1786)
    splits = 1
    if sms is not None and not grouped:
        splits = _split_count(name, m, n, r_nb, r_w, dtype == torch.bfloat16, sms=sms)
        if not 1 <= splits <= MAX_SPLITS:
            refuse(f"{splits} K splits outside [1, {MAX_SPLITS}]",
                   1744 if streamed else 442)
    return types.MappingProxyType({
        "nb": r_nb, "w": r_w, "rows": (rows["mask"], r_hi, rows["lo"]), "tables": tables,
        "splits": splits})


def _launch(name: str, x, mask, hi, lo, scale, *, w: int, n_low: int, q: int,
            method: str, rows=None, L=None) -> torch.Tensor:
    """Check the launch contract, then every operand's device and layout,
    then launch kernel ``name`` on x's stream.  ``None`` marks a field the
    kernel does not read.  A 2-D kernel takes x (M, K), fields (nb, rows,
    N) and scale (1, N); a grouped one (name ``grouped_*``) x (G, M, K),
    fields (G, nb, rows, N) and scale (G, 1, N); K6, K7 and K8 (``_ROWS``)
    also the live rows per group, (G,) or None; the streamed kernels
    (``_STREAM``) the byte path's tables where the codec (with mip2q's
    ``L``) allows it, K3 and K8 after the 16-wide view of their hi rows
    (``_dense_view``)."""
    lead = 1 if name.startswith("grouped_") else 0
    if x.dim() != 2 + lead:
        raise ValueError(f"cuda:{name}: x must be {2 + lead}-D, got {tuple(x.shape)}")
    groups = x.shape[0] if lead else 0
    m, k = x.shape[-2:]
    n = scale.shape[-1]
    fields = {f: t for f, t in (("mask", mask), ("hi", hi), ("lo", lo)) if t is not None}
    nb = next(iter(fields.values())).shape[lead]
    route = launch_contract(
        name, m, k, nb, n, w, n_low, q, method, x.dtype, groups,
        fields={f: (tuple(t.shape), t.dtype) for f, t in fields.items()}, L=L,
        sms=None if lead else _sm_count(x.device))
    for t in [x, scale] + list(fields.values()):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"cuda:{name}: operands must be contiguous and on "
                             f"{x.device}")
    if scale.dtype != torch.float32 or scale.numel() != max(groups, 1) * n or \
            (lead and scale.shape[0] != groups):
        raise ValueError(f"cuda:{name}: scale {tuple(scale.shape)} {scale.dtype} does "
                         f"not fit {max(groups, 1)} group(s) of N={n} float32")
    ptrs = [t.data_ptr() if t is not None else None for t in (mask, hi, lo)]
    nb, w, nrows = route["nb"], route["w"], route["rows"]
    tables = []
    if name in _STREAM:
        tables = [_table_words(name, w, n_low, q, method, L)
                  if route["tables"] is not None else None]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = getattr(_lib(), _ENTRY[name])
    if lead:    # every expert stack fills the card with its own tiles: no split-K
        out = torch.empty((groups, m, n), dtype=torch.float32, device=x.device)
        live = []
        if name in _ROWS:
            if rows is not None:
                if rows.numel() != groups or rows.is_floating_point():
                    raise ValueError(f"cuda:{name}: rows {tuple(rows.shape)} "
                                     f"{rows.dtype} is not ({groups},) integer")
                rows = rows.to(device=x.device, dtype=torch.int32).reshape(
                    groups).contiguous()
            live = [rows.data_ptr() if rows is not None else None]
        err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), *ptrs, scale.data_ptr(),
                 *live, out.data_ptr(), groups, m, n, k, nb, w, *nrows, n_low, q,
                 METHOD_CODES[method], *tables, stream)
    else:
        out = torch.empty((m, n), dtype=torch.float32, device=x.device)
        err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), *ptrs, scale.data_ptr(),
                 out.data_ptr(), m, n, k, x.stride(0), nb, w, *nrows, n_low, q,
                 METHOD_CODES[method], route["splits"], *tables, stream)
    if err != 0:
        raise RuntimeError(f"cuda:{name} launch failed: CUDA error {err}")
    launch_counts[name] += 1
    return out


def _route(x2: torch.Tensor) -> str:
    if x2.device.type == "cpu":
        return "plain"
    if x2.device.type == "cuda":
        return "cuda"
    raise ValueError(f"no StruM matmul for tensors on {x2.device}")


def strum_matmul_onehot(x2, mask, hi, lo, scale, *, w: int, n_low: int, q: int,
                        method: str, L=None) -> torch.Tensor:
    """K1: y = x2 @ dequant(mask, hi, lo, scale), (M, N) f32; needs w % 8 == 0.
    ``L`` (mip2q's largest shift, optional) lets a mip2q payload take the
    byte path (``byte_path_tables``); it changes no result."""
    if hooks.active is not None:     # a dataflow trace: record the call, then run it
        return hooks.active.kernel(
            "cuda:onehot", strum_matmul_onehot, x2, mask, hi, lo, scale, w=w,
            n_low=n_low, q=q, method=method, L=L)
    if w % 8:
        raise ValueError(f"onehot kernel needs byte-aligned mask rows (w={w})")
    if _route(x2) == "plain":
        return strum_matmul_onehot_plain(x2, mask, hi, lo, scale, w=w,
                                         n_low=n_low, q=q, method=method)
    return _launch("onehot", x2, mask, hi, lo, scale, w=w, n_low=n_low, q=q,
                   method=method, L=L)


def strum_matmul_maskfree(x2, lo, scale, *, w: int, q: int, method: str,
                          L=None) -> torch.Tensor:
    """K2 (p = 1): y = x2 @ dequant(lo, scale); reads neither mask nor hi.
    ``L`` (mip2q's largest shift, optional) lets a mip2q payload take the
    byte path (``byte_path_tables``); it changes no result."""
    if hooks.active is not None:     # a dataflow trace: record the call, then run it
        return hooks.active.kernel(
            "cuda:maskfree", strum_matmul_maskfree, x2, lo, scale, w=w, q=q,
            method=method, L=L)
    if method not in ("dliq", "mip2q"):
        raise ValueError(f"maskfree kernel needs a lo payload, got {method!r}")
    if _route(x2) == "plain":
        return strum_matmul_maskfree_plain(x2, lo, scale, w=w, q=q, method=method)
    return _launch("maskfree", x2, None, None, lo, scale, w=w, n_low=w, q=q,
                   method=method, L=L)


def strum_matmul_dense(x2, hi, scale, *, w: int) -> torch.Tensor:
    """K3 (n_low = 0): y = x2 @ dequant(hi, scale), (M, N) f32, for any w.
    On the card the streamed kernel's dense mode takes it (``_dense_view``:
    the byte path wherever nb * w % 16 == 0, else its general path for w <=
    64, w % 8 == 0); only other widths take the template."""
    if hooks.active is not None:     # a dataflow trace: record the call, then run it
        return hooks.active.kernel("cuda:dense", strum_matmul_dense, x2, hi, scale, w=w)
    if _route(x2) == "plain":
        return strum_matmul_dense_plain(x2, hi, scale, w=w)
    return _launch("dense", x2, None, hi, None, scale, w=w, n_low=0, q=1,
                   method="sparsity")


def strum_matmul_grouped_onehot(x3, mask, hi, lo, scale, *, w: int, n_low: int,
                                q: int, method: str, rows=None) -> torch.Tensor:
    """K6: y[g] = x3[g] @ dequant(mask[g], hi[g], lo[g], scale[g]), (G, M, N)
    f32; needs w % 8 == 0 (w <= 64 on the card).  ``rows`` (G,) int, optional:
    rows at or past ``rows[g]`` of x3[g] are zero; the kernel reads no weight
    byte for a row tile past the count and writes those rows as exact 0."""
    if hooks.active is not None:     # a dataflow trace: record the call, then run it
        return hooks.active.kernel(
            "cuda:grouped", strum_matmul_grouped_onehot, x3, mask, hi, lo, scale, w=w,
            n_low=n_low, q=q, method=method, rows=rows)
    if w % 8:
        raise ValueError(f"grouped onehot kernel needs byte-aligned mask rows (w={w})")
    if _route(x3) == "plain":
        return strum_matmul_grouped_onehot_plain(x3, mask, hi, lo, scale, rows, w=w,
                                                 n_low=n_low, q=q, method=method)
    return _launch("grouped_onehot", x3, mask, hi, lo, scale, w=w, n_low=n_low,
                   q=q, method=method, rows=rows)


def strum_matmul_grouped_maskfree(x3, lo, scale, *, w: int, q: int,
                                  method: str, rows=None) -> torch.Tensor:
    """K7 (p = 1): y[g] = x3[g] @ dequant(lo[g], scale[g]); no mask, no hi
    (w <= 64 on the card).  ``rows`` (G,) int, optional, as for K6: a row
    tile past the count reads no weight byte, and those rows come out 0."""
    if hooks.active is not None:     # a dataflow trace: record the call, then run it
        return hooks.active.kernel(
            "cuda:grouped_maskfree", strum_matmul_grouped_maskfree, x3, lo, scale, w=w,
            q=q, method=method, rows=rows)
    if method not in ("dliq", "mip2q"):
        raise ValueError(f"grouped maskfree kernel needs a lo payload, got {method!r}")
    if _route(x3) == "plain":
        return strum_matmul_grouped_maskfree_plain(x3, lo, scale, rows, w=w, q=q,
                                                   method=method)
    return _launch("grouped_maskfree", x3, None, None, lo, scale, w=w, n_low=w,
                   q=q, method=method, rows=rows)


def strum_matmul_grouped_dense(x3, hi, scale, *, w: int, rows=None) -> torch.Tensor:
    """K8 (n_low = 0): y[g] = x3[g] @ dequant(hi[g], scale[g]), (G, M, N)
    f32, for any w; on the card the streamed kernel's dense mode, grouped,
    routed as K3's.  ``rows`` (G,) int, optional, as for K6: a row tile past
    the count reads no weight byte, and those rows come out 0 (the template,
    at the widths the streamed kernel cannot take, does not read ``rows``:
    x is 0 past them, so is y)."""
    if hooks.active is not None:     # a dataflow trace: record the call, then run it
        return hooks.active.kernel(
            "cuda:grouped_dense", strum_matmul_grouped_dense, x3, hi, scale, w=w,
            rows=rows)
    if _route(x3) == "plain":
        return strum_matmul_grouped_dense_plain(x3, hi, scale, rows, w=w)
    return _launch("grouped_dense", x3, None, hi, None, scale, w=w, n_low=0, q=1,
                   method="sparsity", rows=rows)


def _check_draft(name: str, w: int, n_low: int) -> None:
    if not 0 <= n_low < w:
        raise ValueError(f"{name} kernel needs high values to stream "
                         f"(n_low={n_low} w={w})")


def strum_matmul_histream(x2, mask, hi, scale, *, w: int, n_low: int) -> torch.Tensor:
    """K9 (draft): y = x2 @ (hi at its masked positions, low positions 0) *
    scale, (M, N) f32; needs w % 8 == 0 and never reads lo."""
    if hooks.active is not None:     # a dataflow trace: record the call, then run it
        return hooks.active.kernel(
            "draft:histream", strum_matmul_histream, x2, mask, hi, scale, w=w,
            n_low=n_low)
    _check_draft("histream", w, n_low)
    if w % 8:
        raise ValueError(f"histream kernel needs byte-aligned mask rows (w={w})")
    if _route(x2) == "plain":
        return strum_matmul_histream_plain(x2, mask, hi, scale, w=w, n_low=n_low)
    return _launch("histream", x2, mask, hi, None, scale, w=w, n_low=n_low, q=1,
                   method="sparsity")


def strum_matmul_maskfree_p(x2, hi, scale, *, w: int, n_low: int) -> torch.Tensor:
    """K10 (draft): y = x2 @ (hi in the leading w - n_low block positions,
    the rest 0) * scale, (M, N) f32; any w, reads neither mask nor lo."""
    if hooks.active is not None:     # a dataflow trace: record the call, then run it
        return hooks.active.kernel(
            "draft:maskfree_p", strum_matmul_maskfree_p, x2, hi, scale, w=w,
            n_low=n_low)
    _check_draft("maskfree_p", w, n_low)
    if _route(x2) == "plain":
        return strum_matmul_maskfree_p_plain(x2, hi, scale, w=w, n_low=n_low)
    return _launch("maskfree_p", x2, None, hi, None, scale, w=w, n_low=n_low, q=1,
                   method="sparsity")
