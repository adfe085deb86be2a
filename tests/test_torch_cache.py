"""The port's ``cache:*`` family against the JAX reference: page encode,
page decode (K11's plain version), the sealed-page attention partial (K4's
and K5's plain versions), variant selection and the pools' byte accounting.

Pages are seeded with numpy and handed to both sides.  Payload bytes must be
identical (the port against the reference's *eager* ``encode_page``); K11
must decode exactly (an integer times a scale is one f32 rounding on both
sides).  K4 / K5 match ``strum_paged_attention_pallas{,_maskfree}``
(interpret mode) to rtol 1e-5, atol 1e-6: both run the same online softmax
page by page, and only the f32 sums of the scores and of p·V are taken in
another order.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import StruMConfig as JCfg
from repro.engine import cache as jec
from repro.engine.registry import LeafInfo as JInfo
from repro.engine.registry import select_variant as j_select
from repro.kernels.strum_decode import strum_page_decode_pallas
from repro.models.attention import _merge_partials as j_merge
from repro.serving import pages as jpages
from repro_torch.core.policy import StruMConfig as TCfg
from repro_torch.engine import cache as tec
from repro_torch.engine.registry import LeafInfo as TInfo
from repro_torch.engine.registry import register_kernel
from repro_torch.engine.registry import select_variant as t_select
from repro_torch.kernels.strum_decode import strum_page_decode_plain
from repro_torch.models.attention import _merge_partials as t_merge
from repro_torch.serving import pages as tpages

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

FIELDS = ("mask", "hi", "lo", "scale")
#: reference backend -> the port's twin; variant names swap the family word
BACKEND = {"interpret": "cuda", "pallas": "cuda", "xla": "torch"}
NAME = {"cache:pallas_decode": "cache:cuda_decode",
        "cache:xla_dequant": "cache:torch_dequant"}

# the dliq / mip2q / sparsity x p grid of tests/test_paged_cache.py, plus
# q = 3 (fields straddling bytes) and L = 3 at p = 0.5
GRID = [dict(method=m, p=p, **qq) for m, qq in
        (("dliq", dict(q=4)), ("mip2q", dict(L=7)), ("sparsity", {}))
        for p in (0.0, 0.5, 1.0)] + [dict(method="dliq", p=0.5, q=3),
                                     dict(method="mip2q", p=0.5, L=3)]
GRID_IDS = [f"{g['method']}_p{g['p']}_" + "_".join(f"{k}{v}" for k, v in g.items()
                                                    if k in ("q", "L")) for g in GRID]
PACKED = [dict(method="dliq", p=0.5, q=4), dict(method="mip2q", p=0.5, L=7),
          dict(method="sparsity", p=0.5)]
P1 = [dict(method="dliq", p=1.0, q=4), dict(method="mip2q", p=1.0, L=7)]


def _pages(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(enc):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in enc.items()}


# ------------------------------------------------------------------ encode --

@pytest.mark.parametrize("kw", GRID, ids=GRID_IDS)
def test_encode_page_byte_identical_to_eager_reference(kw):
    pages = _pages(0, (3, 32, 24))
    want = [jec.encode_page(jnp.asarray(p), JCfg(**kw)) for p in pages]
    got = tec.encode_page(torch.from_numpy(pages), TCfg(**kw))
    for k in FIELDS:
        ref = np.stack([np.asarray(w[k]) for w in want])
        assert got[k].numpy().dtype == ref.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), ref, err_msg=k)
    one = tec.encode_page(torch.from_numpy(pages[1]), TCfg(**kw))   # no lead dim
    for k in FIELDS:
        assert torch.equal(one[k], got[k][1]), k


def test_payload_bytes_match_reference():
    for kw in GRID:
        for ps, f in ((16, 8), (32, 24)):
            assert tec.page_payload_bytes(ps, f, TCfg(**kw)) == \
                jec.page_payload_bytes(ps, f, JCfg(**kw)), kw


# ------------------------------------------------------------ decode (K11) --

# the codecs of tests/test_paged_cache.py
DECODE = PACKED[:2] + [dict(method="sparsity", p=0.5), dict(method="dliq", p=1.0, q=4),
                       dict(method="dliq", p=0.0, q=4)]


@pytest.mark.parametrize("kw", DECODE, ids=lambda kw: f"{kw['method']}_p{kw['p']}")
def test_page_decode_plain_equals_pallas_and_xla_exactly(kw):
    ps, f = 32, 40
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    # pages encoded by the port (byte-identical to the reference's encode, above)
    enc = {k: jnp.asarray(v.numpy()) for k, v in
           tec.encode_page(torch.from_numpy(_pages(1, (3, ps, f))), tcfg).items()}
    pad = {k: np.asarray(v) if k == "scale" or v.shape[-2] else
           np.zeros(v.shape[:-2] + (1,) + v.shape[-1:], v.dtype) for k, v in enc.items()}
    y_pallas = strum_page_decode_pallas(*(jnp.asarray(pad[k]) for k in FIELDS),
                                        w=jcfg.w, n_low=jcfg.n_low, q=jcfg.q,
                                        method=jcfg.method, interpret=True)
    spec_x = jec.build_cache_spec(jcfg, page_size=ps, feat=f, backend="xla")
    y_xla = jec.decode_pages(enc, spec_x)
    t_enc = _t(enc)
    got = strum_page_decode_plain(*(t_enc[k] for k in FIELDS), w=tcfg.w,
                                  n_low=tcfg.n_low, q=tcfg.q, method=tcfg.method)
    np.testing.assert_array_equal(got.numpy(), np.asarray(y_pallas))
    np.testing.assert_array_equal(got.numpy(), np.asarray(y_xla))
    # the registry's codecs on CPU tensors: K11's wrapper runs the plain path
    for backend in ("cuda", "torch"):
        spec = tec.build_cache_spec(tcfg, page_size=ps, feat=f, device="cpu",
                                    backend=backend)
        np.testing.assert_array_equal(tec.decode_pages(t_enc, spec).numpy(),
                                      np.asarray(y_xla))


def test_gather_decode_clips_unassigned():
    cfg = TCfg(method="dliq", p=0.5, q=4)
    pool = tec.encode_page(torch.from_numpy(_pages(2, (4, 16, 8))), cfg)
    spec = tec.build_cache_spec(cfg, page_size=16, feat=8, device="cpu")
    out = tec.decode_pages(pool, spec)
    got = tec.gather_decode_pages(pool, torch.tensor([[2, -1, 0]]), spec)
    assert torch.equal(got[0, 0], out[2]) and torch.equal(got[0, 1], out[0])


# ---------------------------------------------------- attention (K4, K5) --

PS, HD = 16, 16


def _attn_inputs(kw, kv, r, seed=3):
    n_pages = 6
    pool = {name: {k: jnp.asarray(v.numpy()) for k, v in tec.encode_page(
        torch.from_numpy(_pages(seed + i, (n_pages, PS, kv * HD))), TCfg(**kw)).items()}
        for i, name in enumerate(("k", "v"))}
    qf = (np.random.default_rng(seed).normal(size=(4, kv, r, HD)) / 4).astype(np.float32)
    # full; nothing sealed; -1 ids inside n_valid; n_valid cutting the table
    table = np.array([[0, 2, 4], [-1, -1, -1], [5, -1, 1], [3, 1, 0]], np.int32)
    n_valid = np.array([3, 0, 3, 1], np.int32)
    return pool, qf, table, n_valid


SHAPES = {"olmo_R1": (4, 1), "gqa_R_rep": (2, 2), "gqa_R_chunk_rep": (2, 32)}
ATTN_CASES = [(kw, s) for kw in PACKED[:2] for s in SHAPES] + \
    [(PACKED[2], "olmo_R1"), (P1[0], "olmo_R1"), (P1[0], "gqa_R_chunk_rep"),
     (P1[1], "gqa_R_rep")]


@pytest.mark.parametrize("kw,shape", ATTN_CASES,
                         ids=[f"{kw['method']}_p{kw['p']}-{s}" for kw, s in ATTN_CASES])
def test_sealed_partial_plain_matches_pallas(kw, shape):
    kv, r = SHAPES[shape]
    pool, qf, table, n_valid = _attn_inputs(kw, kv, r)
    jspec = jec.build_cache_spec(JCfg(**kw), page_size=PS, feat=kv * HD,
                                 backend="interpret")
    tspec = tec.build_cache_spec(TCfg(**kw), page_size=PS, feat=kv * HD,
                                 device="cpu", backend="cuda")
    fused = "cache:attn_fused_maskfree" if kw["p"] == 1.0 else "cache:attn_fused"
    assert jspec.attn_variant == tspec.attn_variant == fused
    want = jec.attn_sealed_partial(pool, jnp.asarray(qf), jnp.asarray(table),
                                   jnp.asarray(n_valid), jspec)
    got = tec.attn_sealed_partial({k: _t(v) for k, v in pool.items()},
                                  torch.from_numpy(qf), torch.from_numpy(table),
                                  torch.from_numpy(n_valid), tspec)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    acc, m, l = got                   # the empty slot is the identity partial
    assert acc[1].abs().max() == 0 and l[1].abs().max() == 0 and (m[1] == -1e30).all()
    # the unfused torch path gives the same softmax
    unf = tec.attn_sealed_partial({k: _t(v) for k, v in pool.items()},
                                  torch.from_numpy(qf), torch.from_numpy(table),
                                  torch.from_numpy(n_valid), tspec, backend="torch")
    live = l > 0
    np.testing.assert_allclose((acc / l.clamp(min=1e-30)[..., None])[live].numpy(),
                               (unf[0] / unf[2].clamp(min=1e-30)[..., None])[live].numpy(),
                               rtol=1e-4, atol=1e-5)


def test_merge_partials_matches_reference():
    rng = np.random.default_rng(5)
    parts = []
    for empty in (False, True, False):
        acc = rng.normal(size=(2, 3, 4, 8)).astype(np.float32)
        m = rng.normal(size=(2, 3, 4)).astype(np.float32)
        l = rng.uniform(1, 5, size=(2, 3, 4)).astype(np.float32)
        if empty:
            acc, m, l = np.zeros_like(acc), np.full_like(m, -1e30), np.zeros_like(l)
        parts.append((acc, m, l))
    want = j_merge([tuple(jnp.asarray(a) for a in p) for p in parts])
    got = t_merge([tuple(torch.from_numpy(a) for a in p) for p in parts])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------- selection --

def _swap(name):
    return NAME.get(name, name)


SELECTION_POINTS = [(kw, be) for kw in PACKED + P1 + [dict(method="dliq", p=0.5, q=8),
                                                       None]
                    for be in ("interpret", "xla", None)]


@pytest.mark.parametrize("kw,backend", SELECTION_POINTS)
def test_cache_and_attn_selection_is_the_family_swapped_twin(kw, backend):
    jspec = jec.build_cache_spec(None if kw is None else JCfg(**kw), page_size=16,
                                 feat=8, backend=backend)
    tspec = tec.build_cache_spec(None if kw is None else TCfg(**kw), page_size=16,
                                 feat=8, device="cpu", backend=BACKEND.get(backend))
    assert (tspec.variant, tspec.attn_variant, tspec.packed) == \
        (_swap(jspec.variant), _swap(jspec.attn_variant), jspec.packed)


def test_selection_partitioning_twin():
    cfg_j, cfg_t = JCfg(method="dliq", p=0.5, q=4), TCfg(method="dliq", p=0.5, q=4)
    for cache, attn in ((True, False), (True, True), (False, False)):
        for jb in ("interpret", "xla"):
            jv = j_select(cfg_j, JInfo(k_dim=32, n_out=16, cache=cache, attn=attn),
                          backend=jb)
            tv = t_select(cfg_t, TInfo(k_dim=32, n_out=16, cache=cache, attn=attn),
                          backend=BACKEND[jb])
            assert (tv.cache, tv.attn) == (jv.cache, jv.attn) == (cache, attn)
            if cache:
                assert tv.name == _swap(jv.name)
    # off the card, auto stays on the portable decoder (by the spec's device)
    assert tec.build_cache_spec(cfg_t, page_size=16, feat=8,
                                device="cpu").variant == "cache:torch_dequant"
    assert tec.build_cache_spec(cfg_t, page_size=16, feat=8,
                                device="cuda").variant == "cache:cuda_decode"
    # w without byte-aligned mask rows: the cuda backend falls back visibly
    w12_j, w12_t = JCfg(method="dliq", p=0.5, q=4, w=12), TCfg(method="dliq", p=0.5,
                                                               q=4, w=12)
    with pytest.warns(UserWarning, match="falling back"):
        jspec = jec.build_cache_spec(w12_j, page_size=24, feat=8, backend="interpret")
    with pytest.warns(UserWarning, match="falling back"):
        tspec = tec.build_cache_spec(w12_t, page_size=24, feat=8, device="cpu",
                                     backend="cuda")
    assert tspec.variant == _swap(jspec.variant) == "cache:torch_dequant"
    assert tspec.attn_variant == jspec.attn_variant == "cache:attn_unfused"
    # fp pages under the cuda family: redispatch variants, no warning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fp = tec.build_cache_spec(None, page_size=16, feat=8, device="cpu",
                                  backend="cuda")
    assert (fp.variant, fp.attn_variant) == ("cache:fp_passthrough",
                                             "cache:attn_unfused")
    with pytest.raises(ValueError, match="multiple of"):
        tec.build_cache_spec(cfg_t, page_size=20, feat=8, device="cpu")
    with pytest.raises(ValueError, match="attn"):
        register_kernel("cache:attn_bogus", family="torch", attn=True, cache=False,
                        supports=lambda cfg, info: False)


# ------------------------------------------------------------------- stats --

@pytest.mark.parametrize("kw", [None, dict(method="mip2q", w=16, p=0.5, L=7),
                                dict(method="dliq", p=0.25, q=4)])
def test_cache_stats_match_reference_and_eq1(kw):
    import dataclasses

    from repro.configs import get_smoke_config as j_smoke
    from repro_torch.configs.base import get_smoke_config as t_smoke
    jcfg = dataclasses.replace(j_smoke("qwen2_7b"), dtype="float32")
    tcfg = dataclasses.replace(t_smoke("qwen2_7b"), dtype="float32")
    jspec = jpages.make_cache_spec(jcfg, None if kw is None else JCfg(**kw), 16)
    tspec = tpages.make_cache_spec(tcfg, None if kw is None else TCfg(**kw), 16, "cpu")
    want = jpages.cache_stats(jpages.init_pools(jcfg, 6, jspec),
                              jpages.init_hot(jcfg, 2, 16), jspec, jcfg, 2, 48)
    got = tpages.cache_stats(tpages.init_pools(tcfg, 6, tspec),
                             tpages.init_hot(tcfg, 2, 16, "cpu"), tspec, tcfg, 2, 48)
    assert got == dict(want, codec=_swap(want["codec"]))
    assert got["resident_page_bytes"] == got["expected_page_bytes"]
    if kw is not None:
        assert got["ratio_vs_int8"] == pytest.approx(TCfg(**kw).compression_ratio)


def test_allocator_alloc_free_defrag():
    al = tpages.PageAllocator(8)
    assert al.alloc(3) == [0, 1, 2] and al.alloc(2) == [3, 4]
    al.free([0, 1, 2])
    assert al.alloc(1) == [0] and al.defrag() == {"free": 5, "n_pages": 8,
                                                  "free_runs": 2}
    with pytest.raises(tpages.PagesExhausted):
        al.alloc(6)
    with pytest.raises(ValueError, match="double free"):
        al.free([5, 5])
