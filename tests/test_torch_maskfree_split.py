"""K5's split-KV merge, pages of 128 positions, and K7's live-row counts, on
the CPU, against the JAX reference.

(a) ``strum_paged_attention_split_plain(..., maskfree=True)`` mirrors what
the split-KV K5 computes on p = 1 pages (lo + scale only): each split the
one-pass partial over its own page slots, the splits merged in split-index
order.  At 1, 2 and 7 splits it is held to the one-pass
``strum_paged_attention_maskfree_plain`` and to the reference's
``cache:attn_fused_maskfree`` (``strum_paged_attention_pallas_maskfree``,
interpret mode, through ``repro.engine.cache.attn_sealed_partial``) on the
same numpy-seeded pools: an empty slot, -1 ids, an ``n_valid`` cut and
splits with no live page.  Tolerance rtol 1e-5, atol 1e-6 (the merge
rescales each split's f32 sums once more: a few ulps); ``m`` exactly; the
empty slot is the identity partial exactly.

(b) Pages of 128 positions (w = 16, nb = 8: two 64-position pieces on the
card): K4's and K5's plain versions against the reference's interpret-mode
kernels, same tolerances; the registry selects K4 (K5 at p = 1) for them on
the card, as the reference selects its fused kernels, and the unfused
consumer where the kernels' limits (head dim <= 256, w <= 64) are passed.

(c) ``rows=`` through K7 (``strum_matmul_grouped_maskfree``): equal to the
call without ``rows`` when x is zero past each count, rows past the count
exactly 0 whatever x holds; against the reference's
``strum_matmul_pallas_grouped_maskfree`` (interpret mode, through
``repro.engine.dispatch_grouped``) rtol 1e-4, atol 1e-4; and
``models.moe._moe_local`` of a p = 1 plan through ``cuda:grouped_maskfree``
with its device-computed rows, against the reference's ``_moe_local`` rtol
1e-4, atol 1e-5 (test_torch_grouped.py's and test_torch_moe.py's
tolerances: f32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.core.policy import StruMConfig as JCfg
from repro.engine import cache as jec
from repro.models import moe as jmoe
from repro.models.quantize import _pack_leaf as j_pack_leaf
from repro_torch import engine
from repro_torch.core.packing import PackedStruM
from repro_torch.core.policy import StruMConfig as TCfg
from repro_torch.engine import cache as tec
from repro_torch.engine import variants
from repro_torch.kernels import ops
from repro_torch.kernels import strum_attention as A
from repro_torch.kernels import strum_matmul as K
from repro_torch.models import moe
from repro_torch.models.quantize import _pack_leaf

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

FIELDS = ("mask", "hi", "lo", "scale")
ATTN_TOL = dict(rtol=1e-5, atol=1e-6)
GROUPED_TOL = dict(rtol=1e-4, atol=1e-4)
MOE_TOL = dict(rtol=1e-4, atol=1e-5)

# slot 0 full; slot 1 nothing live; slot 2 -1 ids (its splits 1-6 of 7 and
# split 1 of 2 hold no live page); slot 3 cut by n_valid at 3
TABLE = np.array([[0, 1, 2, 3, 4, 5, 6], [-1] * 7, [7, -1, 8, -1, -1, -1, -1],
                  [9, 2, 5, 1, 0, 3, 4]], np.int32)
N_VALID = np.array([7, 0, 7, 3], np.int32)
HD, KV, R = 16, 2, 3


def _pool(kw, ps, n_pages, seed=5):
    pool = {}
    for i, name in enumerate(("k", "v")):
        pages = np.random.default_rng(seed + i).normal(
            size=(n_pages, ps, KV * HD)).astype(np.float32)
        pool[name] = tec.encode_page(torch.from_numpy(pages), TCfg(**kw))
    qf = (np.random.default_rng(seed).normal(size=(4, KV, R, HD)) / 4).astype(np.float32)
    return pool, qf


def _reference(kw, pool, qf, ps, table, n_valid):
    """The reference's fused partial (interpret-mode Pallas) and its name."""
    jspec = jec.build_cache_spec(JCfg(**kw), page_size=ps, feat=KV * HD,
                                 backend="interpret")
    jpool = {n: {f: jnp.asarray(v.numpy()) for f, v in pool[n].items()} for n in pool}
    want = jec.attn_sealed_partial(jpool, jnp.asarray(qf), jnp.asarray(table),
                                   jnp.asarray(n_valid), jspec)
    return jspec.attn_variant, [np.asarray(t) for t in want]


def _fields(pool, names):
    return [tec._min1(pool[kv][f], 2) if f != "scale" else pool[kv][f]
            for kv in ("k", "v") for f in names]


def _held(got, want, one=None):
    """got against want (and the one-pass partial ``one``) at ATTN_TOL;
    ``m`` equal to the one-pass ``m``; slot 1 the identity partial."""
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ATTN_TOL)
    acc, m, l = got
    if one is not None:
        for a, b in zip(got, one):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **ATTN_TOL)
        assert torch.equal(m, one[1])
    assert (m[1] == A.NEG_INF).all() and not l[1].any() and not acc[1].any()
    assert (l[[0, 2, 3]] > 0).all()


# --------------------------------------------------- (a) K5 split-KV --

P1_CODECS = [dict(method="dliq", p=1.0, q=4), dict(method="mip2q", p=1.0, L=5),
             dict(method="dliq", p=1.0, q=3)]   # q = 3: fields straddle bytes


@pytest.fixture(scope="module", params=range(len(P1_CODECS)),
                ids=[f"{c['method']}_q{c.get('q', 'L')}" for c in P1_CODECS])
def maskfree_case(request):
    kw = P1_CODECS[request.param]
    pool, qf = _pool(kw, 16, 10)
    name, want = _reference(kw, pool, qf, 16, TABLE, N_VALID)
    assert name == "cache:attn_fused_maskfree"
    return kw, pool, qf, want


@pytest.mark.parametrize("splits", [1, 2, 7])
def test_maskfree_split_merge_matches_one_pass_and_pallas(maskfree_case, splits):
    kw, pool, qf, want = maskfree_case
    cfg = TCfg(**kw)
    kwargs = dict(w=cfg.w, q=cfg.q, method=cfg.method)
    args = [torch.from_numpy(qf)] + _fields(pool, ("lo", "scale")) + [
        torch.from_numpy(TABLE), torch.from_numpy(N_VALID)]
    p = TABLE.shape[1]
    pps = -(-p // splits)
    assert -(-p // pps) == splits
    got = A.strum_paged_attention_split_plain(*args, pages_per_split=pps,
                                              maskfree=True, **kwargs)
    one = A.strum_paged_attention_maskfree_plain(*args, **kwargs)
    _held(got, want, one)


def test_maskfree_wrapper_on_cpu_is_the_one_pass_plain_version(maskfree_case):
    """K5's wrapper on CPU tensors runs the plain version and launches
    nothing: no K5 or combine count moves."""
    kw, pool, qf, want = maskfree_case
    cfg = TCfg(**kw)
    args = [torch.from_numpy(qf)] + _fields(pool, ("lo", "scale")) + [
        torch.from_numpy(TABLE), torch.from_numpy(N_VALID)]
    before = dict(A.launch_counts)
    got = A.strum_paged_attention_maskfree(*args, w=cfg.w, q=cfg.q, method=cfg.method)
    assert A.launch_counts == before
    _held(got, want)


# ---------------------------------------------- (b) pages of 128 --

PS128 = 128
TABLE128 = np.array([[0, 1, 2], [-1, -1, -1], [3, -1, 4], [5, 2, 1]], np.int32)
N_VALID128 = np.array([3, 0, 3, 2], np.int32)


@pytest.mark.parametrize("kw", [dict(method="mip2q", p=0.5, L=7),
                                dict(method="dliq", p=0.25, q=3),
                                dict(method="dliq", p=1.0, q=4)],
                         ids=["mip2q_p0.5", "dliq_p0.25_q3", "dliq_p1"])
def test_page_128_plain_versions_match_pallas(kw):
    """K4's (K5's at p = 1) plain version and its split mirror at 2 splits
    on pages of 128 positions (nb = 8 blocks of w = 16) against the
    reference's interpret-mode kernel."""
    cfg = TCfg(**kw)
    pool, qf = _pool(kw, PS128, 6, seed=11)
    name, want = _reference(kw, pool, qf, PS128, TABLE128, N_VALID128)
    maskfree = cfg.p == 1.0
    assert pool["k"]["lo"].shape[1] == PS128 // cfg.w == 8
    assert name == ("cache:attn_fused_maskfree" if maskfree else "cache:attn_fused")
    names = ("lo", "scale") if maskfree else FIELDS
    kwargs = dict(w=cfg.w, q=cfg.q, method=cfg.method)
    if not maskfree:
        kwargs["n_low"] = cfg.n_low
    args = [torch.from_numpy(qf)] + _fields(pool, names) + [
        torch.from_numpy(TABLE128), torch.from_numpy(N_VALID128)]
    plain = A.strum_paged_attention_maskfree_plain if maskfree else \
        A.strum_paged_attention_plain
    one = plain(*args, **kwargs)
    _held(one, want)
    split = A.strum_paged_attention_split_plain(*args, pages_per_split=2,
                                                maskfree=maskfree, **kwargs)
    _held(split, want, one)


_SWAP = {"pallas": "cuda", "xla": "torch"}


@pytest.mark.parametrize("kw", [dict(method="mip2q", p=0.5, L=7),
                                dict(method="dliq", p=0.5, q=4),
                                dict(method="dliq", p=1.0, q=4)])
@pytest.mark.parametrize("ps", [16, 64, 128, 256])
def test_page_size_selects_the_fused_kernel_on_card(kw, ps):
    """``select_attn_variant(..., device="cuda")`` at any page size selects
    K4 (K5 at p = 1) for a head dim the kernels take, the twin of the
    reference's choice; ``BatchScheduler``'s spec records the head dim."""
    want = jec.build_cache_spec(JCfg(**kw), page_size=ps, feat=KV * 128,
                                backend="interpret").attn_variant
    got = tec.select_attn_variant(TCfg(**kw), page_size=ps, feat=KV * 128,
                                  head_dim=128, device="cuda").name
    assert got == want == ("cache:attn_fused_maskfree" if kw["p"] == 1.0
                           else "cache:attn_fused")
    spec = tec.build_cache_spec(TCfg(**kw), page_size=ps, feat=KV * 128, head_dim=128,
                                device="cuda")
    assert (spec.attn_variant, spec.head_dim) == (got, 128)


def test_selection_refuses_what_the_kernels_do_not_take():
    """Past the kernels' limits (head dim > 256, w > 64) the card gets the
    unfused consumer, not a kernel that would raise; a head dim of 256 and
    w = 64 still select K4."""
    cfg = TCfg(method="mip2q", p=0.5, L=7)
    sel = tec.select_attn_variant
    assert sel(cfg, page_size=128, feat=2 * 256, head_dim=256,
               device="cuda").name == "cache:attn_fused"
    assert sel(cfg, page_size=128, feat=2 * 288, head_dim=288,
               device="cuda").name == "cache:attn_unfused"
    p1 = TCfg(method="dliq", p=1.0, q=4)
    assert sel(p1, page_size=128, feat=2 * 512, head_dim=512,
               device="cuda").name == "cache:attn_unfused"
    for w, name in ((64, "cache:attn_fused"), (128, "cache:attn_unfused")):
        wcfg = TCfg(method="mip2q", w=w, p=0.5, L=7)
        assert sel(wcfg, page_size=2 * w, feat=2 * 128, head_dim=128,
                   device="cuda").name == name


def test_scheduler_spec_at_page_128_records_head_dim():
    """The paged runtime's cache spec carries the model's head dim into
    selection: at page size 128 on the card it is K4."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.serving import pages
    cfg = get_smoke_config("olmo_1b")
    spec = pages.make_cache_spec(cfg, TCfg(method="mip2q", p=0.5, L=7), 128, "cuda")
    assert (spec.attn_variant, spec.head_dim, spec.page_size) == \
        ("cache:attn_fused", cfg.hd, 128)


# ------------------------------------------- (c) K7 live-row counts --

def _stack(shape, kw, seed, std=1.0):
    wt = (np.random.default_rng(seed).normal(size=shape) * std).astype(np.float32)
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    jleaf = dict(j_pack_leaf(jnp.asarray(wt), jcfg))
    tleaf = dict(_pack_leaf(torch.from_numpy(wt), tcfg))
    jleaf["cfg"], tleaf["cfg"] = jcfg, tcfg
    return jleaf, tleaf, tcfg


def _packed(tleaf, tcfg, k):
    return PackedStruM(method=tcfg.method, w=tcfg.w, n_low=tcfg.n_low, q=tcfg.q,
                       L=tcfg.L, k_dim=k, **{f: tleaf[f] for f in FIELDS})


# rows[g]: 0, partial and full capacity (C = 6)
ROWS = np.array([0, 2, 6, 5, 0, 1], np.int32)
K7_CODECS = [dict(method="dliq", p=1.0, q=4), dict(method="mip2q", p=1.0, L=5),
             dict(method="dliq", w=8, p=1.0, q=3)]


def _zero_past(x, rows):
    x = x.copy()
    for g, n in enumerate(rows):
        x[g, n:] = 0
    return x


@pytest.mark.parametrize("kw", K7_CODECS,
                         ids=lambda kw: f"{kw['method']}_w{kw.get('w', 16)}")
def test_k7_rows_equal_no_rows_and_reference(kw):
    g, c, k, n = len(ROWS), 6, 40, 48
    jleaf, tleaf, tcfg = _stack((g, k, n), kw, seed=13)
    x = _zero_past(np.random.default_rng(3).normal(size=(g, c, k)).astype(np.float32),
                   ROWS)
    xt, rows = torch.from_numpy(x), torch.from_numpy(ROWS)
    lo = ops._min1(tleaf["lo"], 2)
    kwargs = dict(w=tcfg.w, q=tcfg.q, method=tcfg.method)
    xpad = torch.cat([xt, xt.new_zeros((g, c, lo.shape[1] * tcfg.w - k))], dim=-1)
    got = K.strum_matmul_grouped_maskfree(xpad, lo, tleaf["scale"], rows=rows, **kwargs)
    assert torch.equal(got, K.strum_matmul_grouped_maskfree(xpad, lo, tleaf["scale"],
                                                            **kwargs))
    want = np.asarray(jengine.dispatch_grouped(jleaf, jnp.asarray(x),
                                               backend="interpret"))
    np.testing.assert_allclose(got.numpy(), want, **GROUPED_TOL)
    via_ops = ops.strum_grouped_matmul(xt, _packed(tleaf, tcfg, k), variant="maskfree",
                                       rows=rows)
    np.testing.assert_allclose(via_ops.numpy(), want, **GROUPED_TOL)
    for gi, cnt in enumerate(ROWS):
        assert not got[gi, cnt:].any() and not via_ops[gi, cnt:].any()


def test_k7_plain_zeroes_rows_past_the_count():
    """K7's contract on the plain version: rows at or past rows[g] come out
    exactly 0 even where x is not 0 there; the live rows are untouched."""
    g, c, k, n = len(ROWS), 6, 32, 24
    _, tleaf, tcfg = _stack((g, k, n), dict(method="dliq", p=1.0, q=4), seed=4)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(g, c, k))
                         .astype(np.float32))
    kw = dict(w=tcfg.w, q=tcfg.q, method=tcfg.method)
    full = K.strum_matmul_grouped_maskfree(x, tleaf["lo"], tleaf["scale"], **kw)
    cut = K.strum_matmul_grouped_maskfree(x, tleaf["lo"], tleaf["scale"],
                                          rows=torch.from_numpy(ROWS), **kw)
    for gi, cnt in enumerate(ROWS):
        assert torch.equal(cut[gi, :cnt], full[gi, :cnt])
        assert (cut[gi, cnt:] == 0).all()
        assert cnt == c or full[gi, cnt:].abs().sum() > 0


class _Cfg:
    n_experts = 4
    top_k = 2
    gated_mlp = True


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5], ids=["ample", "drops"])
def test_moe_local_rows_through_k7(monkeypatch, capacity_factor):
    """``_moe_local`` of a p = 1 plan: every expert contraction goes through
    the ``cuda:grouped_maskfree`` variant (its card check lifted, so K7's
    wrapper runs its plain version on these CPU tensors) and hands K7 the
    filled-slot count of every expert; the MoE output matches the
    reference's ``_moe_local`` on the dequantized stacks."""
    cfg = type("Cfg", (_Cfg,), {"capacity_factor": capacity_factor})
    t, d, f, e = 24, 32, 48, 4
    rng = np.random.default_rng(10)
    x = rng.normal(size=(t, d)).astype(np.float32)
    router = rng.normal(size=(d, e)).astype(np.float32)
    kw = dict(method="dliq", p=1.0, q=4)
    stacks = {name: _stack(shape, kw, seed, shape[1] ** -0.5)
              for name, shape, seed in (("wi", (e, d, f), 1), ("wg", (e, d, f), 2),
                                        ("wo", (e, f, d), 3))}
    for name, (_, tleaf, tcfg) in stacks.items():
        tleaf["spec"] = engine.ExecSpec(cfg=tcfg, variant="cuda:grouped_maskfree",
                                        k_dim=tleaf["lo"].shape[1] * tcfg.w)
    seen = []
    kernel = K.strum_matmul_grouped_maskfree

    def spy(x3, *a, rows=None, **kw_):
        y = kernel(x3, *a, rows=rows, **kw_)
        seen.append((x3.clone(), rows, y))
        return y
    monkeypatch.setattr(variants, "_on_card", lambda *a: None)
    monkeypatch.setattr(K, "strum_matmul_grouped_maskfree", spy)
    cap = moe._capacity(t, cfg)
    y, _ = moe._moe_local(torch.from_numpy(x), torch.from_numpy(router),
                          stacks["wi"][1], stacks["wg"][1], stacks["wo"][1], cfg, 0,
                          cap)
    assert len(seen) == 3
    rows = seen[0][1]
    assert rows is not None and rows.dtype == torch.int32
    filled = (seen[0][0].abs().sum(-1) > 0).sum(-1).to(torch.int32)
    assert torch.equal(rows, filled)
    if capacity_factor < 1:
        assert int(rows.max()) == cap       # some expert is full: drops happened
    for xbuf, r, out in seen:
        assert torch.equal(r, rows)
        for gi, cnt in enumerate(rows.tolist()):
            assert not xbuf[gi, cnt:].any() and not out[gi, cnt:].any()
    deq = {name: np.asarray(jengine.dequant_leaf(st[0], jnp.float32))
           for name, st in stacks.items()}
    want, _ = jmoe._moe_local(jnp.asarray(x), jnp.asarray(router),
                              jnp.asarray(deq["wi"]), jnp.asarray(deq["wg"]),
                              jnp.asarray(deq["wo"]), cfg, 0, cap)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **MOE_TOL)
