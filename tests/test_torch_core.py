"""Port codec vs the JAX reference: quantizers, Fig.-5 packing, dequant.

The same numpy inputs, made from a seed, go through ``repro.core`` and
``repro_torch.core``; packed arrays must be byte-identical and decoded
values exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocking as jblocking
from repro.core import packing as jpacking
from repro.core import quantizers as jq
from repro.core.apply import fake_quantize_array as j_fake
from repro.core.apply import pack_array as j_pack
from repro.core.apply import packed_payload_bytes as j_payload_bytes
from repro.core.policy import LayerPolicy as JPolicy
from repro.core.policy import StruMConfig as JCfg
from repro_torch.core import packing as tpacking
from repro_torch.core import quantizers as tq
from repro_torch.core.apply import fake_quantize_array as t_fake
from repro_torch.core.apply import pack_array as t_pack
from repro_torch.core.apply import packed_payload_bytes as t_payload_bytes
from repro_torch.core.apply import unpack_array as t_unpack
from repro_torch.core.policy import LayerPolicy as TPolicy
from repro_torch.core.policy import StruMConfig as TCfg

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

FIELDS = ("mask", "hi", "lo", "scale")

# the method x w x p x q/L grid of tests/test_kernels.py (p = 0 is n_low = 0,
# p = 1 the maskfree case) plus test_packing.py's p = 0.5 / 0.75 points,
# q = 3 (fields straddle bytes) and w = 4 (a mask row shorter than a byte)
GRID = []
for _w in (8, 16):
    for _p in (0.0, 0.25, 1.0):
        GRID.append(("sparsity", _w, _p, {}))
        for _q in (2, 4, 8):
            GRID.append(("dliq", _w, _p, {"q": _q}))
        for _L in (3, 5):
            GRID.append(("mip2q", _w, _p, {"L": _L}))
GRID += [("mip2q", 16, 0.5, {"L": 5}), ("mip2q", 16, 0.75, {"L": 7}),
         ("dliq", 16, 0.5, {"q": 3}), ("dliq", 16, 0.75, {"q": 4}),
         ("sparsity", 16, 0.75, {}), ("mip2q", 4, 0.5, {"L": 5}),
         ("dliq", 4, 0.25, {"q": 3}), ("dliq", 4, 1.0, {"q": 3})]


def _weights(seed, k=37, n=11):
    """K % w != 0 for every w of the grid, plus an exact zero and an
    all-zero column (scale falls back to 1)."""
    x = np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32)
    x[3, 2] = 0.0
    x[:, 4] = 0.0
    return x


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_same_bytes(a, b, what):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


@pytest.fixture(scope="module")
def reference_packs():
    """Every grid point through the reference's ``pack_array`` steps, with
    the int8 calibration run eagerly (as ``build_plan`` runs it: under jit,
    XLA turns ``amax / 127`` into a multiply by the reciprocal, one ulp off)
    and the rest (block, set-quantize, pack, dequantize) in one jit for all
    points: one compile instead of one per point."""
    codes, scale = jq.int8_symmetric(jnp.asarray(_weights(0)), axis=0)
    cfgs = [JCfg(method=m, w=w, p=p, **kw) for m, w, p, kw in GRID]

    def run(codes, scale):
        out = []
        for cfg in cfgs:
            qb = jq.quantize_blocks(jblocking.to_blocks(codes, cfg.w), cfg.method,
                                    cfg.n_low, q=cfg.q, L=cfg.L)
            pk = jpacking.pack(qb, method=cfg.method, scale=scale,
                               k_dim=codes.shape[0], n_low=cfg.n_low, q=cfg.q,
                               L=cfg.L)
            out.append(tuple(getattr(pk, f) for f in FIELDS)
                       + (jpacking.dequantize(pk),))
        return out
    return jax.jit(run)(codes, scale)


@pytest.mark.parametrize("i", range(len(GRID)),
                         ids=[f"{m}-w{w}-p{p}-{kw}" for m, w, p, kw in GRID])
def test_pack_array_byte_identical(reference_packs, i):
    method, w, p, kw = GRID[i]
    cfg = TCfg(method=method, w=w, p=p, **kw)
    tp = t_pack(torch.from_numpy(_weights(0)), cfg)
    want = reference_packs[i]
    for f, ref in zip(FIELDS, want):
        _assert_same_bytes(ref, getattr(tp, f), f)
    assert (tp.n_low, tp.q, tp.k_dim) == (cfg.n_low, cfg.q, 37)
    _assert_same_bytes(want[-1], tpacking.dequantize(tp), "dequantize")


@pytest.mark.parametrize("method,w,p,kw", [("mip2q", 16, 0.5, {"L": 5}),
                                        ("dliq", 8, 1.0, {"q": 3})])
def test_pack_array_byte_identical_eager(method, w, p, kw):
    """The reference's own ``pack_array``, called as the serving path calls
    it: the default config and the p = 1, q = 3 edge."""
    x = _weights(1)
    jp = j_pack(jnp.asarray(x), JCfg(method=method, w=w, p=p, **kw))
    tp = t_pack(torch.from_numpy(x), TCfg(method=method, w=w, p=p, **kw))
    for f in FIELDS:
        _assert_same_bytes(getattr(jp, f), getattr(tp, f), f)
    _assert_same_bytes(jpacking.dequantize(jp), tpacking.dequantize(tp),
                       "dequantize")


def test_fake_quantize_and_unpack_exact():
    x = _weights(1)
    want = np.asarray(j_fake(jnp.asarray(x), JCfg()))
    np.testing.assert_array_equal(t_fake(torch.from_numpy(x), TCfg()).numpy(), want)
    pk = t_pack(torch.from_numpy(x), TCfg())
    np.testing.assert_array_equal(t_unpack(pk, x.shape).numpy(), want)
    # lead dims fold into columns, each with its own scale
    x3 = np.random.default_rng(3).normal(size=(3, 40, 6)).astype(np.float32)
    back = t_unpack(t_pack(torch.from_numpy(x3), TCfg()), x3.shape)
    np.testing.assert_array_equal(back.numpy(),
                                  t_fake(torch.from_numpy(x3), TCfg()).numpy())
    for shape in [x.shape, x3.shape, (5, 33, 7)]:
        assert t_payload_bytes(shape, TCfg()) == j_payload_bytes(shape, JCfg())


@pytest.mark.parametrize("i", [GRID.index(g) for g in GRID
                               if g[2] == 0.25 or g[1] == 4])
def test_payloads_decode_across_frameworks(reference_packs, i):
    """A reference payload decodes in the port and a port payload in the
    reference, to the same values."""
    method, w, p, kw = GRID[i]
    tp = t_pack(torch.from_numpy(_weights(0)), TCfg(method=method, w=w, p=p, **kw))
    ref_in_port = tp._replace(**{f: torch.from_numpy(np.array(a))
                                 for f, a in zip(FIELDS, reference_packs[i])})
    port_fields = [jnp.asarray(getattr(tp, f).numpy()) for f in FIELDS]
    ref_dequant = jax.jit(lambda *fields: jpacking.dequantize(
        jpacking.PackedStruM(*tp[:6], **dict(zip(FIELDS, fields)))))
    want = np.asarray(reference_packs[i][-1])
    np.testing.assert_array_equal(tpacking.dequantize(ref_in_port).numpy(), want)
    np.testing.assert_array_equal(np.asarray(ref_dequant(*port_fields)), want)


def test_quantizer_exactness_traps():
    # rank ties break by position (stable double argsort)
    key = np.array([[[3], [1], [3], [1], [0], [3], [1], [2]]], np.int32)
    np.testing.assert_array_equal(
        tq.rank_in_block(torch.from_numpy(key)).numpy(),
        np.asarray(jq.rank_in_block(jnp.asarray(key))))
    # round half to even in int8_symmetric: 127 * k/2 grid points
    w = np.array([[0.5], [1.5], [2.5], [-0.5], [-2.5], [127.0]], np.float32)
    for a, b in zip(tq.int8_symmetric(torch.from_numpy(w)),
                    jq.int8_symmetric(jnp.asarray(w))):
        _assert_same_bytes(a, b, "int8_symmetric")
    # pow2_round at the 1.5·2^k boundary, 0 -> +1, clipping at L
    v = np.arange(-127, 128, dtype=np.int32)
    for L in (0, 2, 5, 7):
        np.testing.assert_array_equal(
            tq.pow2_round(torch.from_numpy(v), L).numpy(),
            np.asarray(jq.pow2_round(jnp.asarray(v), L)))
        np.testing.assert_array_equal(
            tq.pow2_shift(torch.from_numpy(v), L).numpy(),
            np.asarray(jq.pow2_shift(jnp.asarray(v), L)))


@pytest.mark.parametrize("q", [1, 2, 3, 5, 8])
def test_bitfield_roundtrip_matches_reference(q):
    codes = np.random.default_rng(q).integers(0, 1 << q, size=(3, 7, 5))
    packed = tpacking._pack_fields(torch.from_numpy(codes.astype(np.uint8)), q)
    _assert_same_bytes(packed, jpacking._pack_fields(
        jnp.asarray(codes, jnp.uint8), q), "fields")
    np.testing.assert_array_equal(
        tpacking._unpack_fields(packed, 7, q).numpy(), codes)


def test_policy_resolution_matches_reference():
    names = ["embed/table", "blocks/pos0/attn/wq/w", "blocks/pos0/attn/wq/b",
             "blocks/pos0/norm1/scale", "lm_head/w", "blocks/pos0/mlp/wo/w",
             "blocks/pos0/moe/router/w"]
    jpol, tpol = JPolicy(), TPolicy()
    for name in names:
        for shape in [(2, 64, 128), (64,), (1, 64)]:
            j, t = jpol.resolve(name, shape), tpol.resolve(name, shape)
            assert (j is None) == (t is None), (name, shape)
            if j is not None:
                assert (t.method, t.w, t.p, t.q, t.L) == (j.method, j.w, j.p, j.q, j.L)
