"""The byte paths of the streamed kernel's K2 and K10 modes, emulated on
the CPU.

K2 (p = 1, ``kMaskfree``) stages a w = 16 block's 8 lo rows: a column's
bytes hold position j in nibble j, and each group of 4 positions is the
16-byte code table applied to one half word (``lo_values``), then int8 ->
bf16 (``bytes_to_bf16``); for dliq q = 4 a code is its value's top nibble,
so a mask, a shift and one ``prmt`` per 4 positions replace the table
(``shift4``).  K10 (``kMaskfreeP``) stages the 8 hi rows: hi byte j is
position j, converted by ``bytes_to_bf16``; positions 8-15 are 0, so the
kernel keeps only positions 0-7 of each w-block in its weight tile and
stages only those x positions (``kpos``).  Both gather a column's bytes
from the shared-memory words of 4 adjacent columns (``column4``).  These
tests repeat that recipe with torch integer ops (the ``prmt`` emulation of
``test_torch_k1_decode``) and hold it, exactly, to the port's decode and
plain versions, and check which codecs the launcher sends to the byte
path.  No card needed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.packing import PackedStruM, _pack_fields, _unpack_fields, decode_low_values
from repro_torch.core.policy import q_for_L
from repro_torch.kernels import ops
from repro_torch.kernels import strum_matmul as K
from test_torch_k1_decode import bytes_to_bf16, lo_values, prmt

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

W, Q = 16, 4
NB, N = 64, 64           # 4096 columns of one w-block each side


def _emitted(method, L):
    codes = torch.arange(1 << Q)
    return codes[(codes & 7) <= L] if method == "mip2q" else codes


def _items(rows):
    """(nb, R, N) bytes -> (nb, N / 4, R) int64 words: word r of item (b, g)
    holds row r of columns 4g .. 4g + 3, one byte each, as a slot holds them."""
    nb, r, n = rows.shape
    b = rows.to(torch.int64).reshape(nb, r, n // 4, 4)
    return sum(b[..., c] << (8 * c) for c in range(4)).transpose(1, 2)


def _column4(words, c):
    """The kernel's ``column4``: column c's rows 0-3 from four row words."""
    pick = c | (c + 4) << 4
    return prmt(prmt(words[..., 0], words[..., 1], pick),
                prmt(words[..., 2], words[..., 3], pick), 0x5410)


def _by_column(per_column):
    """[c] -> (nb, N / 4, 16) for the 4 columns of each item -> (nb, 16, N)."""
    v = torch.stack(per_column, dim=-1)                  # (nb, N/4, 16, 4)
    return v.permute(0, 2, 1, 3).reshape(v.shape[0], W, -1)


#: dliq q = 4's code table as the launcher hands it over (code c -> c << 4,
#: a byte): the kernel takes the shift path where it sees these words
SHIFT4 = (0x30201000, 0x70605040, 0xB0A09080, 0xF0E0D0C0)


def _shift4(w):
    """The kernel's dliq q = 4 recipe on one column word (8 codes): even
    positions are low nibbles shifted up, odd ones the high nibbles in
    place, interleaved by prmt: int8 values of positions 0-3 and 4-7."""
    even, odd = (w << 4) & 0xF0F0F0F0, w & 0xF0F0F0F0
    return prmt(even, odd, 0x5140), prmt(even, odd, 0x7362)


def _k2_bytes(lo, tables, shift4=False):
    """K2's byte path on staged lo rows (nb, 8, N): int8 values and their
    bf16 (as float32), each (nb, 16, N); ``shift4`` the dliq q = 4 recipe."""
    code = tables[16:]
    words = _items(lo)
    vals, bf16 = [], []
    for c in range(4):
        w0, w1 = _column4(words[..., :4], c), _column4(words[..., 4:], c)
        if shift4:
            v = [*_shift4(w0), *_shift4(w1)]
        else:
            v = [lo_values(h, code) for h in (w0, w0 >> 16, w1, w1 >> 16)]
        vals.append(torch.cat([torch.stack([((x >> (8 * i)) & 0xFF) for i in range(4)], -1)
                               for x in v], -1).to(torch.uint8).view(torch.int8))
        bf16.append(torch.cat([bytes_to_bf16(x) for x in v], -1))
    return _by_column(vals).to(torch.int32), _by_column(bf16)


def _k10_bytes(hi):
    """K10's byte path on staged hi rows (nb, 8, N): the tile's 8 positions
    of each w-block from the hi bytes, bf16 as float32, (nb, 8, N)."""
    words = _items(hi.view(torch.uint8))
    out = []
    for c in range(4):
        h = [_column4(words[..., :4], c), _column4(words[..., 4:], c)]
        out.append(torch.cat([bytes_to_bf16(x) for x in h], -1))
    v = torch.stack(out, dim=-1)                          # (nb, N/4, 8, 4)
    return v.permute(0, 2, 1, 3).reshape(v.shape[0], 8, -1)


def _kpos(c, live, w):
    """The kernel's ``kpos``: K offset within a chunk of the c-th multiplied
    position when each w-block contributes its leading ``live``."""
    return c if live == w else c + (c // live) * (w - live)


def _decoded_by_plain(plain, *fields, **kw):
    """A plain version's decoded weight (nb * 16, N): identity x, unit scale
    (each output is one integer term: exact in f32)."""
    return plain(torch.eye(NB * W), *fields, torch.ones(1, N), **kw)


@pytest.mark.parametrize("method,L", [("mip2q", 4), ("mip2q", 5), ("mip2q", 6),
                                      ("dliq", None)])
def test_k2_byte_path_equals_port_decode_for_every_code(method, L):
    rng = np.random.default_rng(0)
    emitted = _emitted(method, L)
    codes = emitted[torch.from_numpy(rng.integers(0, len(emitted), (NB, W, N)))]
    for pos in range(W):         # every emitted code lands at every position
        assert set(codes[:, pos].flatten().tolist()) == set(emitted.tolist())
    lo = _pack_fields(codes, Q)
    assert lo.shape == (NB, 8, N)
    want = decode_low_values(_unpack_fields(lo, W, Q), method, Q)
    tables = K.byte_path_tables(W, W, q=Q, method=method, L=L, kernel="maskfree")
    assert tables is not None and tables[:16] == (0,) * 16
    assert (tables[16:] == SHIFT4) == (method == "dliq")
    plain = _decoded_by_plain(K.strum_matmul_maskfree_plain, lo, w=W, q=Q, method=method)
    for shift4 in ((False, True) if method == "dliq" else (False,)):
        got, got_bf16 = _k2_bytes(lo, tables, shift4)
        assert torch.equal(got, want)
        assert torch.equal(got_bf16, want.to(torch.float32))
        assert torch.equal(got_bf16.reshape(NB * W, N), plain)


def test_k2_code_table_is_k1s():
    """K2's table is K1's lo-code table (the selectors aside)."""
    for method, L in (("mip2q", 5), ("dliq", None)):
        k1 = K.byte_path_tables(W, 8, q=Q, method=method, L=L)
        k2 = K.byte_path_tables(W, W, q=Q, method=method, L=L, kernel="maskfree")
        assert k2[16:] == k1[16:]


def test_k10_byte_path_places_hi_and_skips_the_zero_half():
    """K10's tile holds hi byte j at position j < 8 of each w-block, which
    is the plain version's decode there, and the plain version's positions
    8-15 are 0; x staged at ``kpos`` (the leading 8 of each w-block, in
    order) against that tile gives the plain version's product exactly
    (integer x: every sum is exact in f32)."""
    rng = np.random.default_rng(1)
    hi = torch.from_numpy(rng.integers(-128, 128, (NB, 8, N))).to(torch.int8)
    assert set(hi.flatten().tolist()) == set(range(-128, 128))
    assert K.byte_path_tables(W, 8, kernel="maskfree_p") == (0,) * 20
    got = _k10_bytes(hi)
    assert torch.equal(got, hi.to(torch.float32))
    plain = _decoded_by_plain(K.strum_matmul_maskfree_p_plain, hi, w=W,
                              n_low=8).reshape(NB, W, N)
    assert torch.equal(plain[:, :8], got) and not plain[:, 8:].any()
    staged = [_kpos(c, 8, W) for c in range(8 * NB)]
    assert staged == [b * W + j for b in range(NB) for j in range(8)]
    k = NB * W - 5                                          # K % w != 0
    x = torch.from_numpy(rng.integers(-4, 5, (3, k)).astype(np.float32))
    xp = torch.cat([x, x.new_zeros(3, NB * W - k)], dim=1)  # zeros past K
    y = xp[:, staged] @ got.reshape(NB * 8, N)
    want = K.strum_matmul_maskfree_p_plain(x, hi, torch.ones(1, N), w=W, n_low=8)
    assert torch.equal(y, want)


@pytest.mark.parametrize("kernel,w,n_low,method,q,L,ok", [
    ("maskfree", 16, 16, "dliq", 4, None, True),
    ("maskfree", 16, 16, "mip2q", 4, 4, True),
    ("maskfree", 16, 16, "mip2q", 4, 6, True),
    ("maskfree", 16, 16, "mip2q", 4, 7, False),            # emits +128
    ("maskfree", 16, 16, "mip2q", 4, None, False),         # unknown L counts as 7
    ("maskfree", 16, 16, "mip2q", q_for_L(8), 8, False),   # q = 5 codes
    ("maskfree", 16, 16, "dliq", 3, None, False),          # fields straddle bytes
    ("maskfree", 8, 8, "dliq", 4, None, False),
    ("maskfree", 32, 32, "mip2q", 4, 5, False),
    ("maskfree", 16, 16, "sparsity", 1, None, False),      # no lo payload
    ("maskfree_p", 16, 8, "mip2q", 4, 5, True),
    ("maskfree_p", 16, 8, "dliq", 3, None, True),          # lo is never read
    ("maskfree_p", 16, 8, "mip2q", 4, 7, True),
    ("maskfree_p", 16, 4, "mip2q", 4, 5, False),           # 12 high positions
    ("maskfree_p", 16, 12, "dliq", 4, None, False),
    ("maskfree_p", 8, 4, "mip2q", 4, 5, False),
    ("maskfree_p", 32, 16, "mip2q", 4, 5, False),
])
def test_launcher_picks_the_k2_k10_byte_path(kernel, w, n_low, method, q, L, ok):
    tables = K.byte_path_tables(w, n_low, q=q, method=method, L=L, kernel=kernel)
    assert (tables is not None) == ok
    assert (K._table_words(kernel, w, n_low, q, method, L) is not None) == ok
    if ok:
        assert len(tables) == 20 and all(0 <= t < 1 << 32 for t in tables)


@pytest.mark.parametrize("name,w,streamed", [
    ("maskfree", 16, True), ("maskfree", 8, True), ("maskfree", 64, True),
    ("maskfree", 4, False), ("maskfree", 12, False), ("maskfree", 72, False),
    ("maskfree_p", 16, True), ("maskfree_p", 32, True), ("maskfree_p", 24, True),
    ("maskfree_p", 80, False), ("onehot", 16, True), ("histream", 64, True),
    ("dense", 16, True), ("grouped_dense", 64, True), ("dense", 12, False),
    ("grouped_maskfree", 16, False),
])
def test_streamed_kernel_takes_w_up_to_64_in_steps_of_8(name, w, streamed):
    """K2 and K10 run the streamed kernel where its constraints hold (w <=
    64, w % 8 == 0) and the template elsewhere, as K1 and K9 do; so do K3
    and K8 at the width their launcher hands over (``_dense_view``)."""
    assert K._streamed(name, w) == streamed


def test_ops_hands_k2_the_payloads_L(monkeypatch):
    """``ops.strum_matmul`` threads ``packed.L`` to K2, so a mip2q p = 1
    payload can take the byte path; the result does not change."""
    from repro_torch.core.apply import pack_array
    from repro_torch.core.policy import StruMConfig
    rng = np.random.default_rng(2)
    packed = pack_array(torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32)),
                        StruMConfig(method="mip2q", p=1.0, L=5))
    assert isinstance(packed, PackedStruM) and packed.L == 5
    seen = []
    kernel = K.strum_matmul_maskfree

    def spy(*a, **kw):
        seen.append(kw.get("L"))
        return kernel(*a, **kw)
    monkeypatch.setattr(K, "strum_matmul_maskfree", spy)
    x = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    y = ops.strum_matmul(x, packed, out_dtype=torch.float32, variant="maskfree")
    assert seen == [5]
    want = K.strum_matmul_maskfree_plain(x, packed.lo, packed.scale, w=16, q=packed.q,
                                         method="mip2q")
    assert torch.equal(y, want)
