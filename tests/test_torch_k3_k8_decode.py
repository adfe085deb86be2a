"""K3 and K8 as the streamed kernel's dense mode, emulated on the CPU.

Under n_low = 0 a block's hi rows are its values in position order, so the
dense mode (``kDense`` in ``csrc/strum_matmul.cu``) stages a w = 16
block's 16 hi rows, gathers each column's 16 bytes from the shared-memory
words of 4 adjacent columns (four ``column4``) and converts them to bf16
(four ``bytes_to_bf16``): no mask, no table, no placement.  Because hi
``(nb, w, N)`` is ``(nb * w, N)`` contiguous int8, the launcher hands any
payload with ``nb * w % 16 == 0`` to that byte path as ``nb * w / 16``
blocks of 16 (``_dense_view``); other widths take the kernel's general
path (w <= 64, w % 8 == 0) or the template.  K8 is the same mode per
group, and reads the live-row counts ``rows``.

These tests repeat the byte recipe with torch integer ops (the ``prmt``
emulation of ``test_torch_k1_decode``) and hold it exactly to the port's
decode for every int8 value in every column slot of an item; hold the
16-wide view to the block layout it replaces, exactly; check the
launcher's routing table; check that ``ops.strum_grouped_matmul`` hands
``rows`` to K8; and hold K8's plain version with ``rows`` to the
reference's ``strum_matmul_pallas_grouped_dense`` (interpret mode, as the
JAX package's tests run it) at rtol 1e-4, atol 1e-4 (the grouped tests'
tolerance: f32 sums in another order, the scale applied after the sum
instead of before it).  No card needed.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.strum_matmul import strum_matmul_pallas_grouped_dense
from repro_torch.core.packing import PackedStruM
from repro_torch.core.policy import StruMConfig
from repro_torch.kernels import ops
from repro_torch.kernels import strum_matmul as K
from repro_torch.models.quantize import _pack_leaf
from test_torch_k1_decode import bytes_to_bf16
from test_torch_k2_k10_decode import _by_column, _column4, _items

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

W = 16
TOL = dict(rtol=1e-4, atol=1e-4)


def _dense_bytes(hi):
    """The dense byte path on staged hi rows (nb, 16, N) int8: for each
    column of an item, four ``column4`` gathers of positions 4j .. 4j + 3
    and four ``bytes_to_bf16``; bf16 as float32, (nb, 16, N)."""
    words = _items(hi.view(torch.uint8))                  # (nb, N/4, 16)
    return _by_column([torch.cat([bytes_to_bf16(_column4(words[..., 4 * j:4 * j + 4], c))
                                  for j in range(4)], -1) for c in range(4)])


def test_dense_byte_path_equals_port_decode_for_every_int8():
    """Every int8 value lands at every position of every column slot of an
    item; the emulated byte path gives it back exactly, as the plain version
    decodes it."""
    rng = np.random.default_rng(0)
    nb, n = 256, 8                                         # 2 items of 4 columns
    vals = np.stack([np.stack([rng.permutation(256) for _ in range(n)], -1)
                     for _ in range(W)], 1) - 128          # (nb, 16, N)
    hi = torch.from_numpy(vals.astype(np.int8))
    for pos in range(W):
        for col in range(n):
            assert set(hi[:, pos, col].tolist()) == set(range(-128, 128))
    got = _dense_bytes(hi)
    assert torch.equal(got, hi.to(torch.float32))
    plain = K.strum_matmul_dense_plain(torch.eye(nb * W), hi, torch.ones(1, n), w=W)
    assert torch.equal(got.reshape(nb * W, n), plain)


@pytest.mark.parametrize("w,nb,k", [(8, 6, 48), (12, 4, 48), (16, 5, 80), (32, 3, 96),
                                    (48, 3, 144), (64, 2, 128), (128, 3, 384),
                                    (12, 8, 90), (128, 2, 200)])
def test_sixteen_wide_view_equals_the_block_layout(w, nb, k):
    """``strum_matmul_dense_plain`` on the launcher's view ``(nb w / 16, 16,
    N)`` equals it on ``(nb, w, N)``, exactly, K % w != 0 included (x's
    true K nulls the padded rows either way)."""
    rng = np.random.default_rng(w * 100 + nb)
    n = 24
    hi = torch.from_numpy(rng.integers(-128, 128, (nb, w, n)).astype(np.int8))
    x = torch.from_numpy(rng.normal(size=(5, k)).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 2.0, (1, n)).astype(np.float32))
    path, nb16, w16, rows16 = K._dense_view(w, nb, w)
    assert (path, nb16, w16, rows16) == ("bytes", nb * w // 16, 16, 16)
    view = hi.view(nb16, rows16, n)                        # the same bytes
    assert view.data_ptr() == hi.data_ptr()
    assert torch.equal(K.strum_matmul_dense_plain(x, view, scale, w=w16),
                       K.strum_matmul_dense_plain(x, hi, scale, w=w))


@pytest.mark.parametrize("w,nb,hi_rows,path,view", [
    (16, 5, 16, "bytes", (5, 16)),
    (16, 4, 20, "general", (4, 16)),       # hi rows past w: not one run of bytes
    (8, 6, 8, "bytes", (3, 16)),
    (8, 5, 8, "general", (5, 8)),          # odd nb: 40 positions
    (12, 4, 12, "bytes", (3, 16)),
    (12, 6, 12, "template", (6, 12)),      # w % 8 != 0, 72 positions
    (4, 8, 4, "bytes", (2, 16)),
    (4, 6, 4, "template", (6, 4)),
    (24, 2, 24, "bytes", (3, 16)),
    (24, 3, 24, "general", (3, 24)),
    (40, 1, 40, "general", (1, 40)),
    (32, 3, 32, "bytes", (6, 16)),
    (48, 3, 48, "bytes", (9, 16)),
    (64, 2, 64, "bytes", (8, 16)),
    (72, 2, 72, "bytes", (9, 16)),
    (72, 3, 72, "template", (3, 72)),      # w > 64, 216 positions
    (128, 3, 128, "bytes", (24, 16)),
])
def test_launcher_routes_k3_k8(w, nb, hi_rows, path, view):
    """Byte path, general path or template for each (w, nb), K3 and K8
    alike: the view the launcher hands over, whether the streamed kernel
    takes it, and the byte path's tables at that width."""
    got_path, nb2, w2, rows2 = K._dense_view(w, nb, hi_rows)
    assert (got_path, (nb2, w2)) == (path, view)
    assert rows2 == (16 if path == "bytes" else hi_rows)
    for name in ("dense", "grouped_dense"):
        assert K._streamed(name, w2) == (path != "template")
        tables = K.byte_path_tables(w2, 0, kernel=name)
        assert (tables == (0,) * 20) == (w2 == 16)
        assert name in K._STREAM


def test_k3_splits_follow_the_streamed_kernel(monkeypatch):
    """K3's 2-D split is the streamed kernel's (128-column tiles), K8's
    stacks are never split."""
    monkeypatch.setattr(K.torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=132))
    for m, n, nb in ((4, 2048, 128), (4, 8192, 128), (16, 2048, 512), (128, 8192, 128)):
        for bf16 in (True, False):
            want = K._stream_splits(m, n, nb, bf16, "cpu")
            assert K._split_count("dense", m, n, nb, W, bf16, "cpu") == want
    assert K._split_count("dense", 4, 8192, 128, W, True, "cpu") == 2
    assert K._splits(4, 8192, 128, "cpu") == 3             # the template's, before
    assert "grouped_dense" in K._ROWS


def _stack(g, k, n, w, seed):
    wt = torch.from_numpy(np.random.default_rng(seed).normal(size=(g, k, n))
                          .astype(np.float32))
    cfg = StruMConfig(method="mip2q", w=w, p=0.0, L=5)
    leaf = dict(_pack_leaf(wt, cfg))
    return cfg, PackedStruM(method=cfg.method, w=cfg.w, n_low=cfg.n_low, q=cfg.q,
                            L=cfg.L, k_dim=k, **{f: leaf[f] for f in
                                                 ("mask", "hi", "lo", "scale")})


ROWS = np.array([0, 2, 6, 5, 0, 1], np.int32)             # 0, partial and full


def _zero_past(x, rows):
    x = x.copy()
    for g, n in enumerate(rows):
        x[g, n:] = 0
    return x


def test_ops_hands_rows_to_k8(monkeypatch):
    """``ops.strum_grouped_matmul(variant="dense", rows=...)`` reaches K8's
    wrapper with the counts, and rows past each count come out 0 even
    where x is not 0 there."""
    g, c, k, n = len(ROWS), 6, 64, 32
    cfg, packed = _stack(g, k, n, W, seed=3)
    assert packed.n_low == 0 and packed.hi.shape == (g, k // W, W, n)
    seen = []
    kernel = K.strum_matmul_grouped_dense

    def spy(*a, rows=None, **kw):
        seen.append(rows)
        return kernel(*a, rows=rows, **kw)
    monkeypatch.setattr(K, "strum_matmul_grouped_dense", spy)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(g, c, k)).astype(np.float32))
    rows = torch.from_numpy(ROWS)
    got = ops.strum_grouped_matmul(x, packed, variant="dense", rows=rows)
    assert len(seen) == 1 and torch.equal(seen[0], rows)
    full = ops.strum_grouped_matmul(x, packed, variant="dense")
    assert seen[1] is None
    for gi, cnt in enumerate(ROWS):
        assert not got[gi, cnt:].any()
        assert torch.equal(got[gi, :cnt], full[gi, :cnt])


@pytest.mark.parametrize("w", [16, 8, 32])
def test_k8_plain_with_rows_matches_pallas_grouped_dense(w):
    """K8's plain version with ``rows`` against the reference's grouped
    dense kernel in interpret mode, on the same packed stack and x zeroed
    past each count."""
    g, c, k, n = len(ROWS), 8, 64, 32
    cfg, packed = _stack(g, k, n, w, seed=5 + w)
    x = _zero_past(np.random.default_rng(6).normal(size=(g, c, k)).astype(np.float32),
                   ROWS)
    got = K.strum_matmul_grouped_dense(torch.from_numpy(x), packed.hi, packed.scale, w=w,
                                       rows=torch.from_numpy(ROWS))
    want = np.asarray(strum_matmul_pallas_grouped_dense(
        jnp.asarray(x), jnp.asarray(packed.hi.numpy()), jnp.asarray(packed.scale.numpy()),
        w=w, block_m=c, block_n=n, block_k=32, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for gi, cnt in enumerate(ROWS):
        assert not got[gi, cnt:].any()
