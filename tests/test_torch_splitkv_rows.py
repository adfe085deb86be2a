"""K4's split-KV merge and K6's live-row counts, on the CPU, against the JAX
reference.

(a) ``strum_paged_attention_split_plain`` mirrors what the split-KV kernel
computes: each split the one-pass partial over its own page slots, the
splits merged in split-index order (``merge_split_partials_plain``, the
combine kernel's arithmetic).  At 1, 2 and 7 splits it is held to the
one-pass plain version and to ``strum_paged_attention_pallas``
(``interpret=True``, reached through ``repro.engine.cache``) on the same
numpy-seeded pools, with a slot with nothing live, -1 ids, an ``n_valid``
cut and splits with no live page.  Tolerance rtol 1e-5, atol 1e-6 (the
merge rescales each split's f32 sums once more: a few ulps); the running
max ``m`` exactly (the same scores, maxed in another grouping); the empty
slot is the identity partial exactly.

(b) ``rows=`` (live rows per group) through ``ops.strum_grouped_matmul``,
``engine.dispatch_grouped`` and ``models.moe._moe_local``: equal to the
same call without ``rows`` exactly when x is zero past each count (0 x a
finite weight is 0), and rows past the count exactly 0 whatever x holds
there; against the reference's ``strum_matmul_pallas_grouped`` (interpret
mode, through ``repro.engine.dispatch_grouped``) rtol 1e-4, atol 1e-4 and
its ``_moe_local`` rtol 1e-4, atol 1e-5 (test_torch_grouped.py's and
test_torch_moe.py's tolerances: f32 sums in another order).
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

# ------------------------------------------------------ (a) K4 split-KV --

PS, HD, P = 16, 16, 7
CODECS = [dict(method="mip2q", p=0.5, L=7), dict(method="dliq", p=0.5, q=3),
          dict(method="sparsity", p=0.5)]
# slot 0 full; slot 1 nothing live; slot 2 -1 ids (its splits 1-6 of 7 and
# split 1 of 2 hold no live page); slot 3 cut by n_valid at 3
TABLE = np.array([[0, 1, 2, 3, 4, 5, 6], [-1] * 7, [7, -1, 8, -1, -1, -1, -1],
                  [9, 2, 5, 1, 0, 3, 4]], np.int32)
N_VALID = np.array([7, 0, 7, 3], np.int32)


def _attn_inputs(kw, kv, r, seed=5):
    pool = {}
    for i, name in enumerate(("k", "v")):
        pages = np.random.default_rng(seed + i).normal(
            size=(10, PS, kv * HD)).astype(np.float32)
        pool[name] = tec.encode_page(torch.from_numpy(pages), TCfg(**kw))
    qf = (np.random.default_rng(seed).normal(size=(4, kv, r, HD)) / 4).astype(np.float32)
    return pool, qf


def _args(pool):
    fl = [tec._min1(pool[kv][f], 2) if f != "scale" else pool[kv][f]
          for kv in ("k", "v") for f in FIELDS]
    return fl


@pytest.fixture(scope="module", params=range(len(CODECS)),
                ids=[c["method"] for c in CODECS])
def attn_case(request):
    kw = CODECS[request.param]
    kv, r = 2, 3
    pool, qf = _attn_inputs(kw, kv, r)
    jspec = jec.build_cache_spec(JCfg(**kw), page_size=PS, feat=kv * HD,
                                 backend="interpret")
    assert jspec.attn_variant == "cache:attn_fused"
    jpool = {n: {f: jnp.asarray(v.numpy()) for f, v in pool[n].items()} for n in pool}
    want = jec.attn_sealed_partial(jpool, jnp.asarray(qf), jnp.asarray(TABLE),
                                   jnp.asarray(N_VALID), jspec)
    return kw, pool, qf, [np.asarray(t) for t in want]


@pytest.mark.parametrize("splits", [1, 2, 7])
def test_split_merge_matches_one_pass_and_pallas(attn_case, splits):
    kw, pool, qf, want = attn_case
    cfg = TCfg(**kw)
    kwargs = dict(w=cfg.w, n_low=cfg.n_low, q=cfg.q, method=cfg.method)
    args = [torch.from_numpy(qf)] + _args(pool) + [torch.from_numpy(TABLE),
                                                   torch.from_numpy(N_VALID)]
    pps = -(-P // splits)
    assert -(-P // pps) == splits
    got = A.strum_paged_attention_split_plain(*args, pages_per_split=pps, **kwargs)
    one = A.strum_paged_attention_plain(*args, **kwargs)
    for a, b, c in zip(got, one, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **ATTN_TOL)
        np.testing.assert_allclose(a.numpy(), c, **ATTN_TOL)
    acc, m, l = got
    assert torch.equal(m, one[1])
    # slot 1 has nothing live: the identity partial, exactly
    assert (m[1] == A.NEG_INF).all() and not l[1].any() and not acc[1].any()
    assert (l[[0, 2, 3]] > 0).all()


def test_split_of_empty_splits_is_identity():
    """Every split of a slot with no live page writes the identity partial
    and the merge keeps it: m = -1e30, l = 0, acc = 0 exactly."""
    b, kv, r = 2, 2, 1
    parts = [(torch.zeros(b, kv, r, HD), torch.full((b, kv, r), A.NEG_INF),
              torch.zeros(b, kv, r)) for _ in range(3)]
    acc, m, l = A.merge_split_partials_plain(parts)
    assert (m == A.NEG_INF).all() and not l.any() and not acc.any()


@pytest.mark.parametrize("n_slots,n_pages,heads", [(4, 128, 16), (4, 32, 16),
                                                   (1, 11, 16), (4, 11, 16),
                                                   (4, 128, 4), (2, 1000, 1),
                                                   (4, 1, 16)])
def test_split_pages_policy(n_slots, n_pages, heads):
    """Splits cover the table, none empty, none longer than the kernel's
    live-page list; OLMo-1B decode (4 slots x 16 heads x 128 pages) gets at
    least 4 blocks per SM of an H100 (132 SMs)."""
    pps = A.split_pages(n_slots, n_pages, heads, 132)
    splits = -(-n_pages // pps)
    assert 1 <= pps <= A.MAX_SPLIT_PAGES and (splits - 1) * pps < n_pages
    if (n_slots, n_pages, heads) == (4, 128, 16):
        assert 4 <= pps <= 16 and n_slots * heads * splits >= 4 * 132


# ------------------------------------------------- (b) K6 live-row counts --

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


GROUPED_CODECS = [(dict(method="mip2q", p=0.5, L=5), "onehot"),
                  (dict(method="dliq", w=8, p=0.25, q=3), "onehot"),
                  (dict(method="sparsity", p=0.5), "onehot"),
                  (dict(method="dliq", p=1.0, q=4), "maskfree"),
                  (dict(method="dliq", p=0.0, q=4), "dense")]
# rows[g]: 0, partial and full capacity (C = 6)
ROWS = np.array([0, 2, 6, 5, 0, 1], np.int32)


def _zero_past(x, rows):
    x = x.copy()
    for g, n in enumerate(rows):
        x[g, n:] = 0
    return x


@pytest.mark.parametrize("kw,variant", GROUPED_CODECS,
                         ids=[f"{kw['method']}_p{kw['p']}" for kw, _ in GROUPED_CODECS])
def test_grouped_rows_equal_no_rows_and_reference(kw, variant):
    g, c, k, n = len(ROWS), 6, 40, 48
    jleaf, tleaf, tcfg = _stack((g, k, n), kw, seed=11)
    x = _zero_past(np.random.default_rng(2).normal(size=(g, c, k)).astype(np.float32),
                   ROWS)
    packed = _packed(tleaf, tcfg, k)
    xt, rows = torch.from_numpy(x), torch.from_numpy(ROWS)
    got = ops.strum_grouped_matmul(xt, packed, variant=variant, rows=rows)
    assert torch.equal(got, ops.strum_grouped_matmul(xt, packed, variant=variant))
    want = np.asarray(jengine.dispatch_grouped(jleaf, jnp.asarray(x),
                                               backend="interpret"))
    np.testing.assert_allclose(got.numpy(), want, **GROUPED_TOL)
    for gi, cnt in enumerate(ROWS):
        assert not got[gi, cnt:].any()
    # the torch:dequant fallback takes rows and ignores it: same result
    got_t = engine.dispatch_grouped(tleaf, xt, backend="torch", rows=rows)
    np.testing.assert_allclose(got_t.numpy(), want, **GROUPED_TOL)


def test_k6_plain_zeroes_rows_past_the_count():
    """K6's contract on the plain version: rows at or past rows[g] come out
    exactly 0 even where x is not 0 there; the live rows are untouched."""
    g, c, k, n = len(ROWS), 6, 32, 24
    _, tleaf, tcfg = _stack((g, k, n), dict(method="mip2q", p=0.5, L=5), seed=3)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(g, c, k))
                         .astype(np.float32))
    fields = [tleaf["mask"], ops._min1(tleaf["hi"], 2), ops._min1(tleaf["lo"], 2),
              tleaf["scale"]]
    kw = dict(w=tcfg.w, n_low=tcfg.n_low, q=tcfg.q, method=tcfg.method)
    full = K.strum_matmul_grouped_onehot(x, *fields, **kw)
    cut = K.strum_matmul_grouped_onehot(x, *fields, rows=torch.from_numpy(ROWS), **kw)
    for gi, cnt in enumerate(ROWS):
        assert torch.equal(cut[gi, :cnt], full[gi, :cnt])
        assert (cut[gi, cnt:] == 0).all()
        assert cnt == c or full[gi, cnt:].abs().sum() > 0


def test_dispatch_grouped_hands_rows_to_the_kernel(monkeypatch):
    """``dispatch_grouped(rows=)`` reaches K6's wrapper through the
    ``cuda:grouped`` variant (its card check lifted so the wrapper runs its
    plain version on these CPU tensors)."""
    g, c, k, n = len(ROWS), 6, 32, 24
    jleaf, tleaf, tcfg = _stack((g, k, n), dict(method="mip2q", p=0.5, L=5), seed=6)
    x = _zero_past(np.random.default_rng(7).normal(size=(g, c, k)).astype(np.float32),
                   ROWS)
    seen = []
    kernel = K.strum_matmul_grouped_onehot

    def spy(*a, rows=None, **kw):
        seen.append(rows)
        return kernel(*a, rows=rows, **kw)
    monkeypatch.setattr(variants, "_on_card", lambda *a: None)
    monkeypatch.setattr(K, "strum_matmul_grouped_onehot", spy)
    tleaf["spec"] = engine.ExecSpec(cfg=tcfg, variant="cuda:grouped", k_dim=k)
    rows = torch.from_numpy(ROWS)
    got = engine.dispatch_grouped(tleaf, torch.from_numpy(x), rows=rows)
    assert len(seen) == 1 and torch.equal(seen[0], rows)
    want = np.asarray(jengine.dispatch_grouped(jleaf, jnp.asarray(x),
                                               backend="interpret"))
    np.testing.assert_allclose(got.numpy(), want, **GROUPED_TOL)


class _Cfg:
    n_experts = 4
    top_k = 2
    gated_mlp = True


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5], ids=["ample", "drops"])
def test_moe_local_rows_through_k6(monkeypatch, capacity_factor):
    """``_moe_local`` hands each expert contraction the filled-slot count of
    every expert (a device bincount of the kept assignments): it equals the
    count of nonzero dispatch rows, every row past it is zero, and K6's
    plain version with those rows gives the same stack outputs as without
    them.  The MoE output matches the reference's ``_moe_local`` on the
    dequantized stacks."""
    cfg = type("Cfg", (_Cfg,), {"capacity_factor": capacity_factor})
    t, d, f, e = 24, 32, 48, 4
    rng = np.random.default_rng(9)
    x = rng.normal(size=(t, d)).astype(np.float32)
    router = rng.normal(size=(d, e)).astype(np.float32)
    kw = dict(method="mip2q", p=0.5, L=5)
    # weights at 1/sqrt(fan-in), as test_torch_moe.py draws them
    stacks = {name: _stack(shape, kw, seed, shape[1] ** -0.5)
              for name, shape, seed in (("wi", (e, d, f), 1), ("wg", (e, d, f), 2),
                                        ("wo", (e, f, d), 3))}
    calls = []

    def contract(wstack, xbuf, scfg, rows=None, fsdp=(), mesh=None):
        packed = _packed(wstack, wstack["cfg"], xbuf.shape[-1])
        y = ops.strum_grouped_matmul(xbuf, packed, rows=rows)
        assert torch.equal(y, ops.strum_grouped_matmul(xbuf, packed))
        calls.append((xbuf.clone(), rows))
        return y
    monkeypatch.setattr(moe, "_expert_contract", contract)
    cap = moe._capacity(t, cfg)
    y, _ = moe._moe_local(torch.from_numpy(x), torch.from_numpy(router),
                          stacks["wi"][1], stacks["wg"][1], stacks["wo"][1], cfg, 0,
                          cap)
    assert len(calls) == 3
    buf, rows = calls[0]
    filled = (buf.abs().sum(-1) > 0).sum(-1).to(torch.int32)
    assert rows.dtype == torch.int32 and torch.equal(rows, filled)
    if capacity_factor < 1:
        assert int(rows.max()) == cap       # some expert is full: drops happened
    for xbuf, r in calls:
        assert r is rows
        for gi, cnt in enumerate(rows.tolist()):
            assert not xbuf[gi, cnt:].any()
    deq = {name: np.asarray(jengine.dequant_leaf(st[0], jnp.float32))
           for name, st in stacks.items()}
    want, _ = jmoe._moe_local(jnp.asarray(x), jnp.asarray(router),
                              jnp.asarray(deq["wi"]), jnp.asarray(deq["wg"]),
                              jnp.asarray(deq["wo"]), cfg, 0, cap)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **MOE_TOL)
