"""The byte path of the streamed K1 / K9 kernel, emulated on the CPU.

The CUDA kernel (``csrc/strum_matmul.cu``: ``decode_bytes``, ``lo_values``,
``bytes_to_bf16``, ``column4``) decodes a w = 16 block four positions at
a time with ``prmt`` byte permutes driven by the tables that
``strum_matmul.byte_path_tables`` builds.  These tests repeat that recipe
with torch integer ops (``prmt`` with its sign-replicate mode, the popcount
ranks, the bf16 fma of the conversion) and hold it, exactly, to the port's
own decode (``_scatter_expand`` / ``decode_low_values``) for every valid mask of 16
positions with 8 high, random hi bytes and every lo code the codec emits.
No card needed.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core.packing import (_pack_bits_axis1, _pack_fields, _scatter_expand,
                                      _unpack_bits_axis1, _unpack_fields,
                                      decode_low_values)
from repro_torch.core.policy import q_for_L
from repro_torch.kernels.strum_matmul import byte_path_tables

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

W, N_LOW, Q = 16, 8, 4


def _bytes(word):
    return [(word >> (8 * i)) & 0xFF for i in range(4)]


def prmt(a, b, s):
    """PTX ``prmt.b32`` (default mode) on int64 tensors holding uint32:
    selector nibble i picks byte (nibble & 7) of {a, b}; bit 3 set
    replicates that byte's sign bit instead."""
    a, b, s = torch.broadcast_tensors(*(torch.as_tensor(v, dtype=torch.int64)
                                        for v in (a, b, s)))
    src = torch.stack(_bytes(a) + _bytes(b), dim=-1)
    out = torch.zeros_like(a)
    for i in range(4):
        nib = (s >> (4 * i)) & 0xF
        byte = torch.gather(src, -1, (nib & 7).unsqueeze(-1)).squeeze(-1)
        sign = torch.where((byte & 0x80) != 0, 0xFF, 0)
        out |= torch.where((nib & 8) != 0, sign, byte) << (8 * i)
    return out


def popc(v):
    return sum((v >> i) & 1 for i in range(16))


def lo_values(lw, t):
    low = prmt(t[0], t[1], lw)
    high = prmt(t[2], t[3], lw ^ 0x8888)
    top = prmt(0x8000, 0, (lw & 0x8888) | ((lw >> 3) & 0x1111))
    return (low & ~top & 0xFFFFFFFF) | (high & top)


def _bf16_lanes(word):
    """The two bf16 lanes of a 32-bit word (low lane first) as float32."""
    lanes = torch.stack([(word >> 16 * i) & 0xFFFF for i in range(2)], dim=-1)
    lanes = torch.where(lanes >= 1 << 15, lanes - (1 << 16), lanes)
    return lanes.to(torch.int16).view(torch.bfloat16).to(torch.float32)


def bytes_to_bf16(v):
    """The kernel's int8 -> bf16: lanes 0x43 | low 7 bits (128 + low7) and
    0x43 | sign bit (128 or 256), one bf16x2 fma subtracts the second from
    the first (exact: both operands and the result are small integers).
    Returns the four bf16 values as float32."""
    low7, sign = v & 0x7F7F7F7F, v & 0x80808080
    out = []
    for sel in (0x5140, 0x7362):
        a = _bf16_lanes(prmt(low7, 0x43434343, sel))
        c = _bf16_lanes(prmt(sign, 0x43434343, sel))
        out.append((a - c).to(torch.bfloat16).to(torch.float32))
    return torch.cat(out, dim=-1)


def decode_block_bytes(m, h0, h1, l, tables, reads_lo=True):
    """One column's w = 16 block (mask bits m, hi bytes h0 | h1, lo word l)
    through the byte path: (..., 16) int8 values and their bf16 (float32)."""
    sel = torch.tensor(tables[:16], dtype=torch.int64)
    code = tables[16:]
    if reads_lo:  # the lo values of ranks 0-3 and 4-7, once per column
        l0, l1 = lo_values(l, code), lo_values(l >> 16, code)
    vals, bf16 = [], []
    r = torch.zeros_like(m)
    for j in range(4):
        nib = (m >> (4 * j)) & 0xF
        hw = prmt(h0, h1, 0x3210 + 0x1111 * r)
        lw = prmt(l0, l1, 0x3210 + 0x1111 * (4 * j - r)) if reads_lo else 0
        v = prmt(hw, lw, sel[nib])
        vals += [((v >> (8 * i)) & 0xFF).to(torch.int8).to(torch.int32) for i in range(4)]
        bf16.append(bytes_to_bf16(v))
        r = r + popc(nib)
    return torch.stack(vals, dim=-1), torch.cat(bf16, dim=-1)


def _all_masks():
    """(12870, 16) bool: every block of 16 positions with 8 high."""
    rows = []
    for high in itertools.combinations(range(W), W - N_LOW):
        row = np.zeros(W, dtype=bool)
        row[list(high)] = True
        rows.append(row)
    return torch.from_numpy(np.stack(rows))


def _emitted(method, L):
    codes = torch.arange(1 << Q)
    if method == "mip2q":
        return codes[(codes & 7) <= L]
    return codes


def _case(method, L, seed=0):
    """Packed fields of every valid mask (one column each, N = 1) with random
    hi bytes and random emitted lo codes, and the port's decode of them."""
    rng = np.random.default_rng(seed)
    high = _all_masks()[:, :, None]                            # (nb, 16, 1)
    nb = high.shape[0]
    hi = torch.from_numpy(rng.integers(-128, 128, (nb, W - N_LOW, 1))).to(torch.int8)
    emitted = _emitted(method, L)
    codes = emitted[torch.from_numpy(rng.integers(0, len(emitted), (nb, N_LOW, 1)))]
    mask, lo = _pack_bits_axis1(high), _pack_fields(codes, Q)
    # the port's decode of the same bytes, as the plain versions do it
    unpacked = _unpack_bits_axis1(mask, W)
    assert torch.equal(unpacked, high)
    hi_vals = _scatter_expand(hi.to(torch.int32), unpacked)
    lo_dec = decode_low_values(_unpack_fields(lo, N_LOW, Q), method, Q)
    want = torch.where(unpacked, hi_vals, _scatter_expand(lo_dec, ~unpacked))[..., 0]
    # the kernel's registers: 16 mask bits, hi bytes 0-3 and 4-7, the lo word
    def word(rows):
        return sum(rows[:, i, 0].to(torch.int64) << (8 * i) for i in range(rows.shape[1]))
    m = word(mask)
    h0, h1 = word(hi[:, :4].view(torch.uint8)), word(hi[:, 4:].view(torch.uint8))
    return codes[..., 0], m, h0, h1, word(lo), hi_vals[..., 0], want


@pytest.mark.parametrize("method,L", [("mip2q", 5), ("mip2q", 6), ("dliq", None)])
def test_byte_path_equals_port_decode_for_every_mask(method, L):
    codes, m, h0, h1, l, _, want = _case(method, L)
    # every emitted code lands at every low rank somewhere in the set
    for rank in range(N_LOW):
        assert set(codes[:, rank].tolist()) == set(_emitted(method, L).tolist())
    tables = byte_path_tables(W, N_LOW, q=Q, method=method, L=L)
    assert tables is not None
    got, got_bf16 = decode_block_bytes(m, h0, h1, l, tables)
    assert torch.equal(got, want)
    assert torch.equal(got_bf16, want.to(torch.float32))


@pytest.mark.parametrize("method", ["mip2q", "dliq", "sparsity"])
def test_histream_byte_path_places_hi_and_zeroes_low(method):
    """K9 (and a sparsity payload on K1): the same tables with no lo stream
    give the hi values at their masked positions and 0 elsewhere."""
    _, m, h0, h1, _, hi_vals, _ = _case("mip2q", 5, seed=1)
    tables = byte_path_tables(W, N_LOW, method=method, kernel="histream")
    got, got_bf16 = decode_block_bytes(m, h0, h1, None, tables, reads_lo=False)
    assert torch.equal(got, hi_vals)
    assert torch.equal(got_bf16, hi_vals.to(torch.float32))
    assert tables[16:] == (0, 0, 0, 0)
    if method == "sparsity":
        assert byte_path_tables(W, N_LOW, method="sparsity") == tables


def test_bias_conversion_is_exact_for_every_int8():
    v = torch.arange(-128, 128, dtype=torch.int64)
    packed = torch.stack([v[i::4] & 0xFF for i in range(4)], dim=-1)   # 64 words
    words = sum(packed[:, i] << (8 * i) for i in range(4))
    got = bytes_to_bf16(words)
    want = torch.stack([v[i::4] for i in range(4)], dim=-1).to(torch.float32)
    assert torch.equal(got, want)
    assert torch.equal(want.to(torch.bfloat16).to(torch.float32), want)


def test_column_gathers_match_the_kernels_byte_layout():
    """``column4`` and the mask gather: the shared-memory words hold one row
    of 4 adjacent columns each; the kernel wants one column's rows."""
    rng = np.random.default_rng(2)
    rows = torch.from_numpy(rng.integers(0, 1 << 32, (64, 4), dtype=np.int64))
    for col in range(4):
        pick = col | (col + 4) << 4
        got = prmt(prmt(rows[:, 0], rows[:, 1], pick), prmt(rows[:, 2], rows[:, 3], pick),
                   0x5410)
        want = sum(((rows[:, r] >> (8 * col)) & 0xFF) << (8 * r) for r in range(4))
        assert torch.equal(got, want)
        mask = prmt(rows[:, 0], rows[:, 1], pick) & 0xFFFF
        want = ((rows[:, 0] >> (8 * col)) & 0xFF) | (((rows[:, 1] >> (8 * col)) & 0xFF) << 8)
        assert torch.equal(mask, want)


@pytest.mark.parametrize("w,n_low,method,q,L,ok", [
    (16, 8, "mip2q", q_for_L(8), 8, False),   # q = 5 codes
    (16, 8, "mip2q", 4, 7, False),            # emits +128
    (16, 8, "mip2q", 4, None, False),         # unknown L counts as 7
    (16, 8, "mip2q", 4, 4, True),
    (16, 8, "mip2q", 4, 6, True),
    (16, 8, "dliq", 4, None, True),
    (16, 8, "dliq", 3, None, False),          # fields straddle bytes
    (8, 4, "mip2q", 4, 5, False),
    (32, 16, "mip2q", 4, 5, False),
    (16, 4, "mip2q", 4, 5, False),            # 12 high positions
    (16, 8, "sparsity", 1, None, True),
])
def test_launcher_picks_the_byte_path_only_where_values_fit(w, n_low, method, q, L, ok):
    assert q_for_L(8) == 5 and q_for_L(7) == 4
    tables = byte_path_tables(w, n_low, q=q, method=method, L=L)
    assert (tables is not None) == ok
    if ok:
        assert len(tables) == 20 and all(0 <= t < 1 << 32 for t in tables)
