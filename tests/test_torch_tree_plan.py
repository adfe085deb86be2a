"""The port's tree half of ``core.apply``, tree-scope and selection-only
plans, ``core.metrics`` and the registry's listing against the JAX
reference.

Names and order: ``jax.tree_util`` walks dicts in sorted key order, lists
and tuples by index, namedtuples by ``.field``, and drops ``None``; the
port's ``_named_leaves`` must give the same names in the same order.
Payloads are held byte for byte (the reference packs eagerly, as the port
does), fake-quantized values exactly (the same integer decode times the
same f32 scale, cast to the leaf's dtype), metrics within 1e-6.
"""
import collections
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.autotune.schedule import StruMSchedule as JSched
from repro.core import apply as japply
from repro.core import metrics as jmetrics
from repro.core.policy import LayerPolicy as JPolicy
from repro.core.policy import StruMConfig as JCfg
from repro_torch import engine
from repro_torch.autotune.schedule import StruMSchedule
from repro_torch.core import apply as tapply
from repro_torch.core import metrics as tmetrics
from repro_torch.core.policy import LayerPolicy, StruMConfig as TCfg

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

FIELDS = ("mask", "hi", "lo", "scale")
METRIC_RTOL = 1e-6
NT = collections.namedtuple("NT", "b a")


def _twin(name: str) -> str:
    fam, tail = name.split(":", 1)
    return {"pallas": "cuda", "xla": "torch"}[fam] + ":" + tail


def _np_tree():
    """Nested dicts out of key order, a list, a tuple, a namedtuple, None,
    a 3-D stack, K % w != 0, excluded names and a 1-D leaf."""
    rng = np.random.default_rng(2)

    def a(*shape):
        return rng.normal(size=shape).astype(np.float32)
    return {
        "zeta": {"w": a(64, 24), "b": a(24)},
        "alpha": {"proj": {"w": a(50, 16)}, "norm": {"scale": a(16)}},
        "layers": [{"w": a(32, 32)}, None, {"w": a(3, 48, 16), "embed": a(40, 8)}],
        "pair": (a(16, 40), {"k": a(40, 16)}),
        "nt": NT(a(24, 32), None),
        "mid": None,
    }


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, NT):
        return NT(*(_to_jax(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_jax(v) for v in tree)
    return None if tree is None else jnp.asarray(tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, NT):
        return NT(*(_to_torch(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return None if tree is None else torch.from_numpy(tree.copy())


@pytest.fixture(scope="module")
def trees():
    t = _np_tree()
    return _to_jax(t), _to_torch(t)


def _sched_pair():
    cfgs = {"alpha/proj/w": dict(method="mip2q", p=0.25, L=7),
            "layers/2/w": dict(method="dliq", p=1.0, q=4),
            "pair/0": dict(method="sparsity", p=0.5),
            "zeta/w": None,
            "layers/2/embed": dict(method="mip2q", p=0.0, L=5)}   # beats exclude
    jsched = JSched(assignments={n: c and JCfg(**c) for n, c in cfgs.items()})
    return jsched, StruMSchedule.from_json(jsched.to_json())


def test_named_leaves_are_the_references_names_in_its_order(trees):
    jtree, ttree = trees
    want = [n for n, _ in japply._named_leaves(jtree)]
    got = [n for n, _ in tapply._named_leaves(ttree)]
    assert got == want
    assert "layers/2/w" in got and "nt/.b" in got and not any("mid" in n for n in got)
    for (n, a), (_, b) in zip(japply._named_leaves(jtree), tapply._named_leaves(ttree)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=n)
    assert tapply.path_name(("blocks", "pos0", 3, "w")) == "blocks/pos0/3/w"
    # map_named keeps each container's type and order, None included
    mapped = tapply.map_named(lambda n, x: n, ttree)
    assert mapped["layers"][1] is None and mapped["mid"] is None
    assert isinstance(mapped["pair"], tuple) and isinstance(mapped["nt"], NT)
    assert list(mapped) == list(ttree) and mapped["nt"].b == "nt/.b"


@pytest.mark.parametrize("how", ["policy", "schedule"])
def test_tree_manifests_byte_identical(trees, how):
    jtree, ttree = trees
    jsched, tsched = _sched_pair()
    if how == "policy":
        jkw = dict(policy=JPolicy(default=JCfg(method="dliq", p=0.75, q=4)))
        tkw = dict(policy=LayerPolicy(default=TCfg(method="dliq", p=0.75, q=4)))
    else:
        jkw, tkw = dict(schedule=jsched), dict(schedule=tsched)
    jplan = jengine.build_plan(jtree, scope="tree", **jkw)   # = pack_tree's
    jman = jplan.params
    with pytest.deprecated_call():
        tman = tapply.pack_tree(ttree, device="cpu", **tkw)
    tplan = engine.build_plan(ttree, scope="tree", device="cpu", **tkw)
    assert list(tman) == list(jman) == list(tplan.params)
    n_packed = 0
    for name, want in jman.items():
        got = tman[name]
        if isinstance(want, tuple):
            (jp, jshape), (tp, tshape) = want, got
            assert tshape == jshape and tp[:6] == jp[:6], name
            for f in FIELDS:
                a, b = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
                assert a.dtype == b.dtype and a.shape == b.shape, (name, f)
                assert a.tobytes() == b.tobytes(), (name, f)
            e, je = tplan[name], jplan[name]
            assert e.layout == je.layout == "folded"
            assert e.variant == _twin(je.variant) and e.shape == je.shape
            assert e.payload_bytes() == je.payload_bytes()
            for f in FIELDS:
                assert torch.equal(e.leaf[f], getattr(tplan.params[name][0], f))
            if n_packed == 0:
                np.testing.assert_array_equal(e.dequantized().numpy(),
                                              np.asarray(je.dequantized()))
            n_packed += 1
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    assert n_packed == len(tplan.entries) >= 4
    s, js = tplan.summary(), jplan.summary()
    assert s["scope"] == "tree" and s["packed_payload_bytes"] == js["packed_payload_bytes"]
    assert tplan.schedule is (tsched if how == "schedule" else None)


def test_selection_only_plan_twins_reference(trees):
    jtree, ttree = trees
    jsched, tsched = _sched_pair()
    for scope in ("tree", "model"):
        jplan = jengine.build_plan(jtree, schedule=jsched, scope=scope, pack=False,
                                   backend="pallas")
        tplan = engine.build_plan(ttree, schedule=tsched, scope=scope, pack=False,
                                  backend="cuda", device="cpu")
        assert {n: _twin(v) for n, v in jplan.variants().items()} == tplan.variants()
        assert all(e.leaf is None for e in tplan.entries.values())
        assert "packed_payload_bytes" not in tplan.summary()
        with pytest.raises(ValueError, match="pack=False"):
            next(iter(tplan.entries.values())).as_packed()


@pytest.mark.parametrize("baseline_int8", [True, False])
def test_fake_quantize_equals_reference(trees, baseline_int8):
    jtree, ttree = trees
    jsched, tsched = _sched_pair()
    for jkw, tkw in ((dict(schedule=jsched), dict(schedule=tsched)),
                     (dict(cfg=JCfg(method="sparsity", p=0.25)),
                      dict(cfg=TCfg(method="sparsity", p=0.25)))):
        want = jengine.fake_quantize(jtree, baseline_int8=baseline_int8, **jkw)
        got = engine.fake_quantize(ttree, baseline_int8=baseline_int8, device="cpu",
                                   **tkw)
        for (n, a), (m, b) in zip(japply._named_leaves(want),
                                  tapply._named_leaves(got)):
            assert n == m
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=n)
    with pytest.deprecated_call():
        shim = tapply.fake_quantize_tree(ttree, baseline_int8=baseline_int8,
                                         schedule=tsched, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jshim = japply.fake_quantize_tree(jtree, baseline_int8=baseline_int8,
                                          schedule=jsched)
    for (n, a), (_, b) in zip(japply._named_leaves(jshim), tapply._named_leaves(shim)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_baseline_array_equals_reference(dtype):
    x = np.random.default_rng(5).normal(size=(3, 40, 24)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(japply.int8_baseline_array(jx).astype(jnp.float32))
    got = tapply.int8_baseline_array(tx).to(torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("how", ["default", "policy", "schedule"])
def test_compression_report_equals_reference(trees, how):
    jtree, ttree = trees
    jsched, tsched = _sched_pair()
    kw = {"default": ({}, {}),
          "policy": (dict(policy=JPolicy(default=JCfg(method="mip2q", p=0.75, L=7))),
                     dict(policy=LayerPolicy(default=TCfg(method="mip2q", p=0.75, L=7)))),
          "schedule": (dict(schedule=jsched), dict(schedule=tsched))}[how]
    want = japply.tree_compression_report(jtree, **kw[0])
    got = tapply.tree_compression_report(ttree, **kw[1])
    assert got == want


def test_metrics_equal_reference():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(33, 17)).astype(np.float32)
    xq = (x + rng.normal(scale=0.05, size=x.shape)).astype(np.float32)
    for fn in ("l2_error", "rel_l2_error", "sqnr_db", "cosine_sim"):
        want = float(getattr(jmetrics, fn)(jnp.asarray(x), jnp.asarray(xq)))
        got = float(getattr(tmetrics, fn)(torch.from_numpy(x), torch.from_numpy(xq)))
        np.testing.assert_allclose(got, want, rtol=METRIC_RTOL, err_msg=fn)
    zero = torch.zeros(4, 4)
    assert float(tmetrics.sqnr_db(zero, zero)) == float(
        jmetrics.sqnr_db(jnp.zeros((4, 4)), jnp.zeros((4, 4))))
    assert float(tmetrics.cosine_sim(zero, zero)) == 0.0


def test_register_kernel_shadows_and_unregisters():
    """The reference's tests/test_engine.py case: a registered variant of
    higher priority wins selection until it is unregistered."""
    cfg = TCfg()
    info = engine.LeafInfo(k_dim=64, n_out=96)
    rng = np.random.default_rng(0)
    plan = engine.build_plan({"lin": {"w": torch.from_numpy(
        rng.normal(size=(64, 96)).astype(np.float32))}}, cfg=cfg, device="cpu")
    leaf = {k: plan["lin/w"].leaf[k] for k in FIELDS}
    x = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))

    @engine.register_kernel("test:custom", family="cuda", priority=99,
                            supports=lambda c, i: True)
    def custom(x2, packed, *, out_dtype=None):
        return torch.zeros((x2.shape[0], packed.n_out), dtype=out_dtype or x2.dtype)

    try:
        assert "test:custom" in engine.list_variants()
        assert engine.select_variant(cfg, info, backend="cuda").name == "test:custom"
        y = engine.dispatch(leaf, x, strum=cfg, backend="cuda")
        assert float(y.abs().max()) == 0.0
    finally:
        engine.unregister_kernel("test:custom")
    assert "test:custom" not in engine.list_variants()
    assert engine.select_variant(cfg, info, backend="cuda").name == "cuda:onehot"
    engine.unregister_kernel("test:never-registered")      # a no-op, as upstream
    listed = engine.list_variants()
    listed.pop("cuda:onehot")                              # a copy
    assert "cuda:onehot" in engine.list_variants()


def test_validate_and_bad_scope_raise(trees):
    _, ttree = trees
    # validate=True runs analysis.validate_plan: a clean plan comes back
    assert engine.build_plan(ttree, validate=True, device="cpu").entries
    with pytest.raises(ValueError, match="scope"):
        engine.build_plan(ttree, scope="folded", device="cpu")
