"""K11's decode recipe (``csrc/strum_attention.cu``), emulated on the CPU.

The kernel gives a thread VEC = 4 adjacent channels of one ``[1, w]``
block (VEC = 1 where F % 4 != 0 or a field is not aligned).  Each mask, hi
and lo row of that block column is one VEC-byte load; a 4x4 byte transpose
(``transpose4``: four ``prmt`` pairs) gives each channel its words.  The
register path (w <= 64, at most 16 hi and 8 lo rows) decodes every position
from them with ``reg_value``: the high rank is the popcount of the mask bits
below the position, the hi byte one byte permute of the hi words at that
rank (two and a select past 8 hi rows), the lo code one shift of the
channel's 32- or 64-bit lo word at the low rank clamped to the last field
(a q = 3 field straddling two bytes included) through a table of the 2^q
codes, both candidates formed and one selected.  The staged path
(every codec; the launcher takes it past the register path's reach) keeps
the same row words, reads the mask 64 positions at a time with the ranks
carried from chunk to chunk, and reads each position's hi byte and lo field
(one or two words) at its clamped ranks.

These tests repeat both recipes with torch integer ops (``prmt`` of
``test_torch_k1_decode``) on pages encoded from a numpy seed and hold them
exactly to ``strum_page_decode_plain`` over method x w x q x p, at VEC = 4
and VEC = 1 (and VEC = 1 alone at an F that is not a multiple of 4); on a
few cases also exactly to the reference ``strum_page_decode_pallas`` in
interpret mode, as the JAX package's tests run it.  Integer times the
channel's f32 scale is one rounding on every side, so every comparison is
exact.  No card needed.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.strum_decode import strum_page_decode_pallas
from repro_torch.core.packing import decode_low_values
from repro_torch.core.policy import StruMConfig
from repro_torch.engine.cache import encode_page
from repro_torch.kernels.ops import _min1
from repro_torch.kernels.strum_decode import strum_page_decode_plain
from test_torch_k1_decode import prmt

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

FIELDS = ("mask", "hi", "lo", "scale")
POP8 = torch.tensor([bin(i).count("1") for i in range(256)])


def _cfg(method, w, q, p):
    if method == "dliq":
        return StruMConfig(method=method, w=w, p=p, q=q)
    if method == "mip2q":                  # q = 3 at L = 3; q = 4 at L = 7 (+-128)
        return StruMConfig(method=method, w=w, p=p, L=3 if q == 3 else 7)
    return StruMConfig(method=method, w=w, p=p)


def _pages(cfg, f, n_pages=2, nb=2, seed=0):
    """Pages of nb blocks encoded by the port, empty fields floored at one
    zero row as the ``cache:cuda_decode`` codec hands them to K11."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n_pages, nb * cfg.w, f)).astype(np.float32))
    return {k: v if k == "scale" else _min1(v, 2).contiguous()
            for k, v in encode_page(x, cfg).items()}


def popc(x):
    """Popcount of int64 values in [0, 2^63): the sum of the byte counts."""
    return sum(POP8[(x >> (8 * i)) & 0xFF] for i in range(8))


def popcll(m):
    """``__popcll`` of int64 tensors holding uint64 bit patterns."""
    return popc(m & 0xFFFFFFFF) + popc((m >> 32) & 0xFFFFFFFF)


def _below(positions):
    """(1 << pos) - 1 for each position (< 64), as int64."""
    return torch.tensor([(1 << int(p)) - 1 for p in positions], dtype=torch.int64)


def _row_words(field, rows, vec):
    """``load_row``: (P, nb, R, F) -> (P nb, F / vec, rows) int64 words, byte
    c of a word the row's byte of channel vec g + c; rows past R are 0."""
    p, nb, r, f = field.shape
    t = field.reshape(p * nb, r, f // vec, vec).to(torch.int64) & 0xFF
    words = sum(t[..., c] << (8 * c) for c in range(vec)).permute(0, 2, 1)
    words = words[..., :rows]
    return torch.nn.functional.pad(words, (0, rows - words.shape[-1]))


def transpose4(r):
    """The kernel's 4x4 byte transpose of rows r[0..3] -> channel words."""
    t0, t1 = prmt(r[0], r[1], 0x5140), prmt(r[2], r[3], 0x5140)
    t2, t3 = prmt(r[0], r[1], 0x7362), prmt(r[2], r[3], 0x7362)
    return [prmt(t0, t1, 0x5410), prmt(t0, t1, 0x7632),
            prmt(t2, t3, 0x5410), prmt(t2, t3, 0x7632)]


def _channel_words(words, n, vec):
    """``load_rows``: rows [0, n) of (.., rows) words (zero past n, padded to
    a multiple of 4) -> per channel (.., groups of 4 rows) words."""
    words = words[..., :n]
    g = -(-max(n, 1) // 4)
    words = torch.nn.functional.pad(words, (0, 4 * g - words.shape[-1]))
    per = [transpose4([words[..., 4 * i + j] for j in range(4)]) for i in range(g)]
    return [torch.stack([per[i][c] for i in range(g)], -1) for c in range(vec)]


def _lut(cfg, lo_on):
    codes = torch.arange(256)
    vals = decode_low_values(codes.clamp(max=(1 << cfg.q) - 1), cfg.method, cfg.q)
    return torch.where(lo_on & (codes < (1 << cfg.q)), vals, 0).to(torch.float32)


def _shape(cfg):
    lo_on = cfg.method != "sparsity" and cfg.n_low > 0
    n_high = cfg.w - cfg.n_low
    lo_n = -(-(cfg.n_low * cfg.q) // 8) if lo_on else 0
    return lo_on, n_high, lo_n


def register_fits(cfg):
    _, n_high, lo_n = _shape(cfg)
    return cfg.w <= 64 and n_high <= 16 and lo_n <= 8


def emulate_register(pages, cfg, vec):
    """The register path: (P, nb w, F) f32 as ``page_decode_kernel`` writes it."""
    lo_on, n_high, lo_n = _shape(cfg)
    hw = 2 if n_high <= 8 else 4                      # hi words a channel
    lt = 32 if lo_n <= 4 else 64                      # lo word bits
    lmax = cfg.n_low - 1 if lo_on else 0
    qmask = (1 << cfg.q) - 1 if lo_on else 0
    m_w = _channel_words(_row_words(pages["mask"], 8, vec), cfg.w // 8, vec)
    h_w = _channel_words(_row_words(pages["hi"], 4 * hw, vec), n_high, vec)
    l_w = _channel_words(_row_words(pages["lo"], lt // 8, vec), lo_n, vec)
    lut = _lut(cfg, lo_on)
    pos = torch.arange(cfg.w)
    p, nb, _, f = pages["mask"].shape
    scale = pages["scale"].reshape(p, 1, f // vec, vec).expand(p, nb, f // vec, vec) \
        .reshape(p * nb, f // vec, vec)
    out = []
    for c in range(vec):
        m = m_w[c][..., 0] | (m_w[c][..., 1] << 32 if m_w[c].shape[-1] > 1 else 0)
        rh = popc(m[..., None] & _below(pos))          # high rank of each position
        rl = pos - rh
        h = h_w[c]
        h = torch.nn.functional.pad(h, (0, hw - h.shape[-1]))[..., None, :]
        hb = prmt(h[..., 0], h[..., 1], rh & 7)
        if hw == 4:
            hb = torch.where((rh & 8) != 0, prmt(h[..., 2], h[..., 3], rh & 7), hb)
        hv = (((hb & 0xFF) ^ 0x80) - 0x80).to(torch.float32)
        lword = l_w[c][..., 0] | (l_w[c][..., 1] << 32 if lt == 64 and l_w[c].shape[-1] > 1
                                  else 0)
        code = (lword[..., None] >> (rl.clamp(max=lmax) * cfg.q)) & qmask
        lv = lut[code]
        v = torch.where(((m[..., None] >> pos) & 1) != 0, hv, lv)
        out.append(v * scale[..., c][..., None])       # (P nb, F / vec, w)
    return torch.stack(out, -1).permute(0, 2, 1, 3).reshape(p, nb * cfg.w, f)


def emulate_staged(pages, cfg, vec):
    """The staged path: the row words in the thread's column, the mask 64
    positions at a time, the ranks carried, bytes read at the ranks."""
    lo_on, n_high, lo_n = _shape(cfg)
    hmax, lmax = max(n_high - 1, 0), cfg.n_low - 1 if lo_on else 0
    qmask = (1 << cfg.q) - 1 if lo_on else 0
    mrow = _row_words(pages["mask"], cfg.w // 8, vec)
    hrow = _row_words(pages["hi"], max(n_high, 1), vec)
    lrow = _row_words(pages["lo"], max(lo_n, 1), vec)
    if n_high == 0:
        hrow = torch.zeros_like(hrow)                 # the empty field's zero row
    if lo_n == 0:
        lrow = torch.zeros_like(lrow)
    lut = _lut(cfg, lo_on)
    p, nb, _, f = pages["mask"].shape
    scale = pages["scale"].reshape(p, 1, f // vec, vec).expand(p, nb, f // vec, vec) \
        .reshape(p * nb, f // vec, vec)
    rh0 = [0] * vec
    chunks = []
    for base in range(0, cfg.w, 64):
        n = min(64, cfg.w - base)
        raw = torch.nn.functional.pad(mrow[..., base // 8:base // 8 + n // 8],
                                      (0, 8 - n // 8))
        t0, t1 = transpose4([raw[..., j] for j in range(4)]), \
            transpose4([raw[..., 4 + j] for j in range(4)])
        pos = torch.arange(n)
        vals = []
        for c in range(vec):
            m = t0[c] | (t1[c] << 32)
            rh = rh0[c] + popc(m[..., None] & _below(pos))
            rl = base + pos - rh
            hb = torch.gather(hrow, -1, rh.clamp(max=hmax))
            hv = ((((hb >> (8 * c)) & 0xFF) ^ 0x80) - 0x80).to(torch.float32)
            bit = rl.clamp(max=lmax) * cfg.q
            byte = bit >> 3
            lb = (torch.gather(lrow, -1, byte) >> (8 * c)) & 0xFF
            nxt = (torch.gather(lrow, -1, (byte + 1).clamp(max=lrow.shape[-1] - 1))
                   >> (8 * c)) & 0xFF
            lb = lb | torch.where(byte + 1 < lo_n, nxt << 8, 0)
            lv = lut[(lb >> (bit & 7)) & qmask]
            v = torch.where(((m[..., None] >> pos) & 1) != 0, hv, lv)
            vals.append(v * scale[..., c][..., None])
            rh0[c] = rh0[c] + popcll(m)[..., None]
        chunks.append(torch.stack(vals, -1))            # (P nb, F / vec, n, vec)
    out = torch.cat(chunks, 2)
    return out.permute(0, 2, 1, 3).reshape(p, nb * cfg.w, f)


def _plain(pages, cfg):
    return strum_page_decode_plain(*(pages[k] for k in FIELDS), w=cfg.w,
                                   n_low=cfg.n_low, q=cfg.q, method=cfg.method)


GRID = [(m, w, q, p) for m, w, q, p in itertools.product(
    ("dliq", "mip2q", "sparsity"), (8, 16, 32, 64, 128), (3, 4), (0.0, 0.25, 0.5, 1.0))
    if not (m == "sparsity" and q == 3)]


@pytest.mark.parametrize("method,w,q,p", GRID,
                         ids=[f"{m}_w{w}_q{q}_p{p}" for m, w, q, p in GRID])
def test_recipes_equal_plain_decode(method, w, q, p):
    """Both paths at VEC = 4 and VEC = 1 (the register path where the
    block column fits it) equal the plain decode exactly."""
    cfg = _cfg(method, w, q, p)
    pages = _pages(cfg, f=12, seed=w + int(100 * p))
    want = _plain(pages, cfg)
    for vec in (4, 1):
        assert torch.equal(emulate_staged(pages, cfg, vec), want), ("staged", vec)
        if register_fits(cfg):
            assert torch.equal(emulate_register(pages, cfg, vec), want), ("register", vec)


ODD_F = [("mip2q", 16, 4, 0.5), ("dliq", 16, 3, 0.25), ("sparsity", 16, 4, 0.5),
         ("dliq", 32, 4, 1.0), ("mip2q", 64, 4, 0.5), ("dliq", 128, 3, 0.25)]


@pytest.mark.parametrize("method,w,q,p", ODD_F,
                         ids=[f"{m}_w{w}_q{q}_p{p}" for m, w, q, p in ODD_F])
def test_one_channel_a_thread_at_odd_feature_width(method, w, q, p):
    """F % 4 != 0: the launcher runs VEC = 1 (never a refusal); exact."""
    cfg = _cfg(method, w, q, p)
    pages = _pages(cfg, f=7, n_pages=3, nb=1, seed=w)
    want = _plain(pages, cfg)
    assert torch.equal(emulate_staged(pages, cfg, 1), want)
    if register_fits(cfg):
        assert torch.equal(emulate_register(pages, cfg, 1), want)


def test_register_path_holds_the_main_codecs():
    """The codecs the engine serves by default sit on the register path at
    w = 16, with two hi words and a 32-bit lo word at mip2q p = 0.5."""
    for cfg in (StruMConfig(method="mip2q", p=0.5, L=7), StruMConfig(method="mip2q", p=0.5),
                StruMConfig(method="dliq", p=0.5, q=4), StruMConfig(method="dliq", p=0.25, q=3),
                StruMConfig(method="dliq", p=1.0, q=4), StruMConfig(method="dliq", p=0.0)):
        assert register_fits(cfg), cfg
    lo_on, n_high, lo_n = _shape(StruMConfig(method="mip2q", p=0.5, L=7))
    assert (lo_on, n_high, lo_n) == (True, 8, 4)
    assert not register_fits(StruMConfig(method="mip2q", w=64, p=0.5, L=7))  # 32 hi rows
    assert not register_fits(StruMConfig(method="dliq", w=128, p=1.0, q=4))


PALLAS = [("mip2q", 16, 4, 0.5), ("dliq", 128, 4, 0.5), ("dliq", 16, 3, 0.25),
          ("dliq", 16, 4, 1.0), ("sparsity", 16, 4, 0.5)]


@pytest.mark.parametrize("method,w,q,p", PALLAS,
                         ids=[f"{m}_w{w}_q{q}_p{p}" for m, w, q, p in PALLAS])
def test_recipe_equals_interpret_mode_pallas(method, w, q, p):
    """The kernel's path for these pages equals the reference's
    ``strum_page_decode_pallas`` (interpret mode) exactly."""
    cfg = _cfg(method, w, q, p)
    pages = _pages(cfg, f=12, n_pages=2, nb=1 if w > 64 else 2, seed=7)
    want = np.asarray(strum_page_decode_pallas(
        *(jnp.asarray(pages[k].numpy()) for k in FIELDS), w=cfg.w, n_low=cfg.n_low,
        q=cfg.q, method=cfg.method, interpret=True))
    got = emulate_register(pages, cfg, 4) if register_fits(cfg) else \
        emulate_staged(pages, cfg, 1)
    np.testing.assert_array_equal(got.numpy(), want)
